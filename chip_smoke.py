"""Smoke test of the PyTorch port (clair_tpu_torch) on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing its results and seconds:

1. the card (nvidia-smi name and power limit); no CUDA device -> exit 1
2. build every kernel in clair_tpu_torch/csrc/ (one nvcc each, all at once)
3. the forward kernel against its plain PyTorch version on the card
4. the backward kernel against its plain PyTorch version, and against
   torch.autograd of the plain forward, on the card
5. the full-width forward of examples/ont_production.ckpt on the card
   against the plain forward on the CPU, float32, batch 512
6. three full-width Adam steps of make_train_step on the card (kernels)
   against the same steps on the CPU (plain), float32, batch 512
7. the calling path: ``python -m clair_tpu_torch call_bam`` on a simulated
   ONT genome with examples/ont_synthetic.ckpt, in the default bfloat16 and
   in float32; recall and precision against the planted truth, the same
   decisions in both dtypes, and the kernels' launch counts in each run
8. the training path: ``python -m clair_tpu_torch train`` at batch 10,000 on
   a bin of 24,000 learnable rows written by the port, in the default
   bfloat16 and in float32; finite losses that fall, checkpoints that load,
   the evaluation report, and both kernels' launch counts in each run
9. times (CUDA events after warm-up) beside the card's name and power limit

Each command of phases 7 and 8 runs in a process of its own, so the launch
counts it reports start from 0 just before it and are read just after it.
Any failed phase raises, so the script exits non-zero without the last
line. The last two lines are a JSON summary of the kernels and the device
line ``{"ok": true, "device": {...}}``. Nothing here imports JAX.
"""

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNELS = {
    "bilstm_stream": {
        "name": "bilstm_stream_fwd",
        "route": "cuda",
        "source": "clair_tpu_torch/csrc/bilstm_stream_fwd.cu",
        "replaces": "clair_tpu/ops/pallas_bilstm_stream.py:56",
    },
    "bilstm_stream_backward": {
        "name": "bilstm_stream_bwd",
        "route": "cuda",
        "source": "clair_tpu_torch/csrc/bilstm_stream_bwd.cu",
        "replaces": "clair_tpu/ops/pallas_bilstm_stream.py:80",
    },
}
# forward kernel vs plain on the card: float32 sums run in another order
# over 33 steps; bf16 h is rounded to a 2**-8 step every step (h and c)
F32_TOL, BF16_TOL = 1e-4, 2e-2
# the forward at the shapes the calling path (B = 512) and the training path
# (B = 10,000, c saved for the backward) give it, a batch of 12, a ragged
# batch of 13 (no multiple of the 4-row tile) and a tiny odd geometry
FWD_GEOMETRIES = ((512, 33, 32, 128), (512, 33, 256, 128), (10000, 33, 32, 128),
                  (10000, 33, 256, 128), (12, 33, 32, 128), (13, 33, 256, 128),
                  (8, 7, 16, 8))
# backward kernel vs plain: float32 max |diff| of each gradient within this
# share of the reference's max |value| (the 3e-4 family of
# tests/test_pallas_bilstm_stream.py; sums over up to 330,000 rows in
# another order); bf16 gradients by cosine, as that file's bf16 test, and
# by max |diff| within BF16_REL_TOL of the reference's max |value| (bf16 dx
# is rounded to a 2**-8 step)
BWD_REL_TOL, BF16_COSINE, BF16_REL_TOL = 3e-4, 0.99, 1e-2
FORWARD_TOL = 1e-4          # probabilities, card vs CPU, float32
STEP_RTOL = 3e-4            # train-step losses, card vs CPU, float32
RECALL_FLOOR = PRECISION_FLOOR = 0.9
TRAIN_ROWS, TRAIN_EPOCHS = 24_000, 2
BWD_GEOMETRIES = ((512, 33, 32, 128), (512, 33, 256, 128), (10000, 33, 256, 128),
                  (13, 33, 256, 128), (8, 7, 16, 8))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase(name, started):
    print(f"[phase] {name}: {time.perf_counter() - started:.2f} s", flush=True)


def cuda_ms(fn, iters=20) -> float:
    """Mean device time of fn() over iters runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def lstm_params(rs, feat, hidden, device):
    def one():
        scale = 1.0 / np.sqrt(hidden)
        return {"w": torch.tensor(rs.randn(feat, 4 * hidden) * scale, dtype=torch.float32, device=device),
                "u": torch.tensor(rs.randn(hidden, 4 * hidden) * scale, dtype=torch.float32, device=device),
                "b": torch.tensor(rs.randn(4 * hidden) * 0.1, dtype=torch.float32, device=device)}
    return {"fw": one(), "bw": one()}


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def build_all():
    """Phase 2: one nvcc per source, all started together."""
    from clair_tpu_torch.ops import build

    names = sorted(p.stem for p in (ROOT / "clair_tpu_torch" / "csrc").glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = dict(zip(names, pool.map(build.build, names)))
    for name, lib in libs.items():
        report = build.BUILD_REPORTS.get(name)
        regs = ([line.strip() for line in report.splitlines() if "registers" in line]
                if report is not None else "built before this run")
        print(f"  {lib.relative_to(ROOT)}: {regs}")


def check_kernel(dev):
    """Phase 3: forward kernel vs plain, h and c, at FWD_GEOMETRIES."""
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream, bilstm_stream_reference

    max_err = 0.0
    before = bilstm_stream.launches
    calls = 0
    for b, t, f, h in FWD_GEOMETRIES:
        rs = np.random.RandomState(b + f + h)
        params = lstm_params(rs, f, h, dev)
        x = torch.tensor(rs.randn(b, t, f), dtype=torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            h_k, c_k = bilstm_stream(params, xd, with_cell=True)
            h_p, c_p = bilstm_stream_reference(params, xd)
            calls += 1
            torch.cuda.synchronize()
            err_h = (h_k.float() - h_p.float()).abs().max().item()
            err_c = (c_k - c_p).abs().max().item()
            assert h_k.dtype == dtype and c_k.dtype == torch.float32
            print(f"  kernel vs plain {(b, t, f, h)} {str(dtype)[6:]}: "
                  f"max|dh| {err_h:.3e} max|dc| {err_c:.3e}")
            if dtype == torch.float32:
                assert err_h <= F32_TOL and err_c <= F32_TOL, (err_h, err_c)
                max_err = max(max_err, err_h, err_c)
            else:
                assert err_h <= BF16_TOL and err_c <= BF16_TOL, (err_h, err_c)
    assert bilstm_stream.launches == before + calls, "the kernel did not launch"
    return max_err


def check_backward_kernel(dev):
    """Phase 4: backward kernel vs the plain sweep on the same saved
    forward, and vs torch.autograd.grad of the plain forward on the card
    (float32), at both layers' widths, the training batch (10,000), a
    ragged batch and a tiny odd geometry."""
    from clair_tpu_torch.models.bilstm import bilstm_with_cell
    from clair_tpu_torch.ops.bilstm_stream import (
        _stack_params, _unstacked, bilstm_stream_backward, bilstm_stream_backward_reference,
    )

    max_err = 0.0
    before = bilstm_stream_backward.launches
    calls = 0
    names = ("dx", "dw", "du", "db")
    for b, t, f, h in BWD_GEOMETRIES:
        rs = np.random.RandomState(b + f + h + 1)
        params = lstm_params(rs, f, h, dev)
        x = torch.tensor(rs.randn(b, t, f), dtype=torch.float32, device=dev)
        weight = torch.tensor(rs.randn(b, t, 2 * h), dtype=torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            w, u, bias = _stack_params(params, dtype)
            xd, dh = x.to(dtype), weight.to(dtype)
            h_out, c_out = bilstm_with_cell(_unstacked(w, u, bias), xd)
            got = bilstm_stream_backward(xd, w, u, bias, h_out, c_out, dh)
            calls += 1
            want = bilstm_stream_backward_reference(xd, w, u, bias, h_out, c_out, dh)
            torch.cuda.synchronize()
            line = []
            for name, g, r in zip(names, got, want):
                assert g.shape == r.shape and g.dtype == r.dtype, name
                g, r = g.float(), r.float()
                assert torch.isfinite(g).all(), name
                err, scale = (g - r).abs().max().item(), r.abs().max().item()
                if dtype == torch.float32:
                    assert err <= BWD_REL_TOL * scale, (name, err, scale)
                    max_err = max(max_err, err)
                    line.append(f"{name} {err:.2e}/{scale:.2e}")
                else:
                    cos = cosine(g, r)
                    assert cos > BF16_COSINE and err <= BF16_REL_TOL * scale, (
                        name, cos, err, scale)
                    line.append(f"{name} cos {cos:.6f} {err:.2e}/{scale:.2e}")
            if dtype == torch.float32:
                # the same gradients from autograd of the plain forward
                leaves = [t_.detach().requires_grad_() for t_ in (xd, w, u, bias)]
                h_ag, _ = bilstm_with_cell(_unstacked(*leaves[1:]), leaves[0])
                grads = torch.autograd.grad((h_ag * weight).sum(), leaves)
                for name, g, a in zip(names, got, grads):
                    err, scale = (g - a).abs().max().item(), a.abs().max().item()
                    assert err <= BWD_REL_TOL * scale, ("autograd", name, err, scale)
                line.append("autograd agrees")
            print(f"  backward kernel vs plain {(b, t, f, h)} {str(dtype)[6:]}: "
                  + ", ".join(line))
    assert bilstm_stream_backward.launches == before + calls, "the kernel did not launch"
    return max_err


def check_forward(dev):
    """Phase 5: full-width forward, card vs CPU, float32, batch 512."""
    from clair_tpu.params import ModelConfig
    from clair_tpu_torch.models.checkpoint import load_checkpoint
    from clair_tpu_torch.models.clair import ClairNet
    from clair_tpu_torch.pipeline.call_var import _device_input

    params, _ = load_checkpoint(str(ROOT / "examples" / "ont_production.ckpt"))
    x = torch.from_numpy(np.random.RandomState(7).randint(0, 40, (512, 33, 8, 4)).astype(np.uint8))
    with torch.inference_mode():
        card = ClairNet.from_jax(params, ModelConfig(), dev)(_device_input(x.to(dev)))
        plain = ClairNet.from_jax(params, ModelConfig(), "cpu")(_device_input(x))
    errs = [(c.cpu() - p).abs().max().item() for c, p in zip(card, plain)]
    print(f"  forward card vs CPU, max|dp| per head: {errs}")
    assert all(e <= FORWARD_TOL for e in errs), errs
    assert all(torch.isfinite(c).all() for c in card)
    return params


def pileup_batch(rs, n):
    """Learnable rows in the manner of tests/test_training.py: integer
    pileup counts (so blocks pack as int16, as real bins do), half hom-ref
    AA sites and half hom-alt GG SNPs, told apart by channel 0."""
    x = rs.randint(0, 20, (n, 33, 8, 4)).astype(np.float32)
    y = np.zeros((n, 90), np.float32)
    hom = np.arange(n) % 2 == 1
    x[~hom, :, :, 0] += 10
    x[hom, :, :, 0] -= 10
    y[~hom, 0] = 1.0        # gt21 AA
    y[hom, 6] = 1.0         # gt21 GG
    y[~hom, 21] = 1.0       # genotype hom-ref
    y[hom, 22] = 1.0        # genotype hom-alt
    y[:, 24 + 16] = 1.0     # indel lengths 0
    y[:, 57 + 16] = 1.0
    return x, y


def check_train_step(params):
    """Phase 6: three full-width Adam steps, card (kernels) vs CPU (plain),
    float32, every dropout rate 0, batch 512."""
    from clair_tpu.params import ModelConfig
    from clair_tpu_torch.models.clair import ClairNet, params_to_jax
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream, bilstm_stream_backward
    from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step

    config = dataclasses.replace(ModelConfig(), lstm2_dropout_rate=0.0, l4_dropout_rate=0.0,
                                 l5_dropout_rate=0.0)
    x, y = pileup_batch(np.random.RandomState(11), 512)
    runs = {}
    before = (bilstm_stream.launches, bilstm_stream_backward.launches)
    for device in ("cuda", "cpu"):
        model = ClairNet.from_jax(params, config, device)
        step = make_train_step(model, make_optimizer(dict(model.named_parameters()), "Adam", 1e-3))
        xd, yd = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
        generator = torch.Generator(device=device)
        losses = [step(xd, yd, generator, 0.005)[0].item() for _ in range(3)]
        runs[device] = (losses, params_to_jax(model.state_dict()))
    assert (bilstm_stream.launches, bilstm_stream_backward.launches) == (
        before[0] + 6, before[1] + 6), "a kernel did not launch"
    card, cpu = runs["cuda"][0], runs["cpu"][0]
    assert all(math.isfinite(v) for v in card)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    print(f"  train step card vs CPU, losses {card} vs {cpu}, max rel diff {rel:.2e}")
    assert rel <= STEP_RTOL, (card, cpu)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)])

    cpu_params = dict(leaves(runs["cpu"][1]))
    diff = {k: float(np.abs(v - cpu_params[k]).max()) for k, v in leaves(runs["cuda"][1])}
    worst = max(diff, key=diff.get)
    print(f"  final parameters card vs CPU: max|d| {diff[worst]:.3e} ({worst})")


def simulate_genome(workdir: Path):
    from clair_tpu.utils import simulate

    recipe = simulate.PLATFORM_RECIPES["ont"]
    rs = np.random.RandomState(424242)
    reference = simulate.random_reference(rs, 30_000)
    variants = simulate.plant_variants(rs, reference, n_variants=120, spacing=200)
    fasta, bam = str(workdir / "ref.fa"), str(workdir / "reads.bam")
    simulate.write_fasta(fasta, reference)
    simulate.simulate_bam(bam, reference, variants, rs, coverage=recipe["coverage"],
                          read_length=recipe["read_length"],
                          read_length_sigma=recipe["read_length_sigma"],
                          error_profile=getattr(simulate, recipe["profile_name"]))
    return fasta, bam, {v.position: (v.ref, v.alt) for v in variants}


def run_port(args, timeout):
    """One run of the port's CLI in a process of its own; its kernel launch
    counts start from 0 there and are reported on its last stderr line."""
    cmd = [sys.executable, "-m", "clair_tpu_torch", *args]
    started = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - started
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stderr.strip().splitlines()[-1])
    return report, wall, proc.stderr


def call_bam(fasta, bam, out, dtype_flags):
    report, wall, stderr = run_port(
        ["call_bam", "--bam_fn", bam, "--ref_fn", fasta,
         "--chkpnt_fn", str(ROOT / "examples" / "ont_synthetic.ckpt"),
         "--ctgName", "chr1", "--threshold", "0.2", "--call_fn", out, *dtype_flags], 500)
    sites = [line for line in stderr.splitlines() if "candidate sites processed" in line]
    rows = [r.split("\t") for r in open(out) if not r.startswith("#")]
    return rows, report["kernel_launches"], wall, sites[-1] if sites else ""


def score(rows, truth):
    called = {int(r[1]): (r[3], r[4]) for r in rows}
    tp = len(set(truth) & set(called))
    return tp / len(truth), tp / max(len(called), 1)


def write_training_bin(path: Path):
    """TRAIN_ROWS learnable rows in blocks of BIN_BLOCK_SIZE, written by the
    port's bins module."""
    from clair_tpu.io import lz4
    from clair_tpu.params import BIN_BLOCK_SIZE
    from clair_tpu_torch.data import bins

    x, y = pileup_batch(np.random.RandomState(12), TRAIN_ROWS)
    order = np.random.RandomState(13).permutation(TRAIN_ROWS)
    x, y = x[order], y[order]
    offs = range(0, TRAIN_ROWS, BIN_BLOCK_SIZE)
    dataset = bins.BinDataset(
        TRAIN_ROWS,
        [bins._pack(x[o:o + BIN_BLOCK_SIZE]) for o in offs],
        [bins._pack(y[o:o + BIN_BLOCK_SIZE]) for o in offs],
        [bins._pack(np.array([f"chr1:{o + j}" for j in range(BIN_BLOCK_SIZE)])) for o in offs],
        BIN_BLOCK_SIZE,
    )
    bins.write_bin(str(path), dataset)
    reread = bins.load_bin(str(path))
    assert reread.x_block(0, cast=False).dtype == np.int16
    codec = "LZ4S" if dataset.x_blocks[0][:4] == b"LZ4S" else "zstd"
    print(f"  wrote {TRAIN_ROWS} rows in {dataset.n_blocks} blocks ({codec}, int16 x), "
          f"{path.stat().st_size / 1e6:.1f} MB; system liblz4 found: {lz4.available()}")


def train(bin_fn: Path, prefix: Path, dtype_flags):
    """Phase 8, one run: the train command, then its checks."""
    from clair_tpu_torch.models.checkpoint import checkpoint_path, load_checkpoint

    report, wall, stderr = run_port(
        ["train", "--bin_fn", str(bin_fn), "--ochk_prefix", str(prefix),
         "--maxEpoch", str(TRAIN_EPOCHS), *dtype_flags], 600)
    val = [v for v, _ in report["validation_losses"]]
    trn = [v for v, _ in report["training_losses"]]
    assert len(val) == TRAIN_EPOCHS and all(math.isfinite(v) for v in val + trn), report
    assert val[-1] < val[0], f"validation loss did not fall: {val}"
    for epoch in range(1, TRAIN_EPOCHS + 1):
        params, extra = load_checkpoint(checkpoint_path(str(prefix), epoch))
        assert extra["epoch"] == epoch and params["l3"]["w"].shape == (256, 33, 30)
    assert "[INFO] Evaluation on gt21:" in stderr and "gt21 all/top1/top2" in stderr
    launches = report["kernel_launches"]
    assert all(launches[k] > 0 for k in KERNELS), launches
    top = [line for line in stderr.splitlines() if "gt21 all/top1/top2" in line][-1]
    epochs = [line for line in stderr.splitlines() if "Epoch time elapsed" in line]
    return report, wall, top, epochs


def train_step_times(params, dev, dtype):
    """ms per full-width train step at batch 10,000 (host clock around
    synchronized steps, after a warm-up step)."""
    from clair_tpu.params import TRAIN_BATCH_SIZE, ModelConfig
    from clair_tpu_torch.models.clair import ClairNet
    from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step

    model = ClairNet.from_jax(params, ModelConfig(compute_dtype=dtype), dev)
    step = make_train_step(model, make_optimizer(dict(model.named_parameters()), "Adam", 1e-3))
    x, y = pileup_batch(np.random.RandomState(14), TRAIN_BATCH_SIZE)
    xd = torch.from_numpy(x.astype(np.int16)).to(dev)
    yd = torch.from_numpy(y.astype(np.int16)).to(dev)
    generator = torch.Generator(device=dev).manual_seed(0)
    step(xd, yd, generator, 0.005)
    torch.cuda.synchronize()
    iters = 5
    started = time.perf_counter()
    for _ in range(iters):
        step(xd, yd, generator, 0.005)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - started) / iters * 1e3
    return ms, TRAIN_BATCH_SIZE / ms * 1e3


def main():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} device(s)")
    # the plain versions are the yardstick: keep their float32 products in
    # full float32 (no TF32) on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul False, cudnn False")
    phase("1 card", t0)

    t = time.perf_counter()
    build_all()
    phase("2 build", t)

    t = time.perf_counter()
    max_err = {"bilstm_stream": check_kernel(dev)}
    phase("3 forward kernel vs plain", t)

    t = time.perf_counter()
    max_err["bilstm_stream_backward"] = check_backward_kernel(dev)
    phase("4 backward kernel vs plain", t)

    t = time.perf_counter()
    params = check_forward(dev)
    phase("5 full-width forward", t)

    t = time.perf_counter()
    check_train_step(params)
    phase("6 full-width train step", t)

    t = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        fasta, bam, truth = simulate_genome(Path(tmp))
        print(f"  simulated 30 kb ONT genome, {len(truth)} planted variants: "
              f"{time.perf_counter() - t:.2f} s")
        runs = {}
        for dtype, flags in (("bfloat16", []), ("float32", ["--dtype", "float32"])):
            rows, launches, wall, sites = call_bam(fasta, bam, str(Path(tmp) / f"{dtype}.vcf"), flags)
            recall, precision = score(rows, truth)
            print(f"  call_bam {dtype}: {len(rows)} calls, recall {recall:.4f}, precision "
                  f"{precision:.4f}, kernel launches {launches}, wall {wall:.2f} s; {sites}")
            assert recall >= RECALL_FLOOR and precision >= PRECISION_FLOOR, (recall, precision)
            assert launches["bilstm_stream"] > 0, launches
            runs[dtype] = (rows, launches, wall, sites)
    decisions = {d: [(r[0], r[1], r[3], r[4], r[9].split(":")[0]) for r in runs[d][0]] for d in runs}
    assert decisions["bfloat16"] == decisions["float32"], "bf16 and f32 decisions differ"
    print("  bfloat16 and float32 decisions (CHROM, POS, REF, ALT, GT) identical")
    phase("7 calling path", t)

    t = time.perf_counter()
    trains = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        bin_fn = Path(tmp) / "train.bin"
        write_training_bin(bin_fn)
        for dtype, flags in (("bfloat16", []), ("float32", ["--train_compute_dtype", "float32"])):
            report, wall, top, epochs = train(bin_fn, Path(tmp) / f"model_{dtype}", flags)
            print(f"  train {dtype}: validation loss sums {report['validation_losses']}, "
                  f"training loss sums {report['training_losses']}, best epoch "
                  f"{report['best_epoch']}, kernel launches {report['kernel_launches']}, "
                  f"wall {wall:.2f} s (process start to exit); {top}; {epochs}")
            trains[dtype] = (report, wall)
    phase("8 training path", t)

    t = time.perf_counter()
    from clair_tpu.params import ModelConfig
    from clair_tpu_torch.models.bilstm import bilstm_with_cell
    from clair_tpu_torch.models.clair import ClairNet
    from clair_tpu_torch.ops.bilstm_stream import (
        _stack_params, _unstacked, bilstm_stream, bilstm_stream_backward,
        bilstm_stream_backward_reference, bilstm_stream_reference,
    )
    from clair_tpu_torch.pipeline.call_var import _device_input

    print(f"times on {card} (CUDA events, mean of 20 after warm-up; B=10000: mean of 5):")
    ms = {k: 0.0 for k in KERNELS}
    plain_ms = dict(ms)
    for layer, feat in (("lstm1", 32), ("lstm2", 256)):
        rs = np.random.RandomState(feat)
        p = lstm_params(rs, feat, 128, dev)
        x = torch.tensor(rs.randn(512, 33, feat), dtype=torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            k = cuda_ms(lambda: bilstm_stream(p, xd))
            pl = cuda_ms(lambda: bilstm_stream_reference(p, xd))
            print(f"  forward {layer} B=512 {str(dtype)[6:]}: kernel {k:.4f} ms, plain {pl:.4f} ms")
            if dtype == torch.bfloat16:
                ms["bilstm_stream"] += k
                plain_ms["bilstm_stream"] += pl
        for batch in (512, 10_000):
            iters = 20 if batch == 512 else 5
            xb = torch.tensor(rs.randn(batch, 33, feat), dtype=torch.float32, device=dev)
            dh32 = torch.tensor(rs.randn(batch, 33, 256), dtype=torch.float32, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                w, u, bias = _stack_params(p, dtype)
                xd, dh = xb.to(dtype), dh32.to(dtype)
                h_out, c_out = bilstm_with_cell(_unstacked(w, u, bias), xd)
                need_dx = layer == "lstm2"  # lstm1's input takes no gradient
                k = cuda_ms(lambda: bilstm_stream_backward(
                    xd, w, u, bias, h_out, c_out, dh, need_dx=need_dx), iters)
                pl = cuda_ms(lambda: bilstm_stream_backward_reference(
                    xd, w, u, bias, h_out, c_out, dh, need_dx=need_dx), iters)
                print(f"  backward {layer} B={batch} {str(dtype)[6:]}: kernel {k:.4f} ms, "
                      f"plain {pl:.4f} ms")
                if batch == 10_000 and dtype == torch.bfloat16:
                    ms["bilstm_stream_backward"] += k
                    plain_ms["bilstm_stream_backward"] += pl
    xu = torch.from_numpy(np.random.RandomState(8).randint(0, 40, (512, 33, 8, 4)).astype(np.uint8)).to(dev)
    for dtype in ("float32", "bfloat16"):
        model = ClairNet.from_jax(params, ModelConfig(compute_dtype=dtype), dev)
        with torch.inference_mode():
            fwd = cuda_ms(lambda: model(_device_input(xu)))
        print(f"  forward B=512 {dtype}: {fwd:.4f} ms, {512 / fwd * 1e3:.0f} tensors/s")
    for dtype in ("bfloat16", "float32"):
        step_ms, rate = train_step_times(params, dev, dtype)
        print(f"  train step B=10000 {dtype}: {step_ms:.2f} ms, {rate:.0f} samples/s "
              f"(host clock, mean of 5 synchronized steps)")
    for dtype, (rows, _, wall, sites) in runs.items():
        print(f"  call_bam {dtype}: wall {wall:.2f} s (process start to exit), "
              f"{len(rows)} VCF rows; {sites}")
    for dtype, (_, wall) in trains.items():
        print(f"  train {dtype}: wall {wall:.2f} s (process start to exit), "
              f"{TRAIN_EPOCHS} epochs of {TRAIN_ROWS} rows")
    phase("9 times", t)

    assert "jax" not in sys.modules
    print(f"card: {card}")
    launches = trains["bfloat16"][0]["kernel_launches"]
    print(json.dumps({"kernels": [dict(
        KERNELS[k], launches=launches[k], max_abs_err=max_err[k], ms=ms[k],
        plain_ms=plain_ms[k]) for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
