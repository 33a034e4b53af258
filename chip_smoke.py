"""Smoke test of the PyTorch port (clair_tpu_torch) on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing its results and seconds:

1. the card (nvidia-smi name and power limit); no CUDA device -> exit 1
2. build every kernel of the calling path from clair_tpu_torch/csrc/
3. each kernel against its plain PyTorch version on the card
4. the full-width forward of examples/ont_production.ckpt on the card
   against the plain forward on the CPU, float32, batch 512
5. the main path: ``python -m clair_tpu_torch call_bam`` on a simulated
   ONT genome with examples/ont_synthetic.ckpt, in the default bfloat16 and
   in float32; recall and precision against the planted truth, the same
   decisions in both dtypes, and the kernel's launch count in each run
6. times (CUDA events after warm-up) beside the card's name and power limit

Any failed phase raises, so the script exits non-zero without the last
line. The last two lines are a JSON summary of the kernels and the device
line ``{"ok": true, "device": {...}}``. Nothing here imports JAX.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL = {
    "name": "bilstm_stream_fwd",
    "route": "cuda",
    "source": "clair_tpu_torch/csrc/bilstm_stream_fwd.cu",
    "replaces": "clair_tpu/ops/pallas_bilstm_stream.py:56",
}
# kernel vs plain on the card: float32 sums run in another order over 33
# steps; bf16 h is rounded to a 2**-8 step every step
F32_TOL, BF16_TOL = 1e-4, 2e-2
FORWARD_TOL = 1e-4          # probabilities, card vs CPU, float32
RECALL_FLOOR = PRECISION_FLOOR = 0.9


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


def check_kernel(dev):
    """Phase 3: kernel vs plain at the shapes of the calling path (B = 512,
    F = 32 then 256), batches of 12 and 13 rows (13 is no multiple of the
    kernel's row tile) and a tiny odd geometry."""
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream, bilstm_stream_reference

    max_err = 0.0
    before = bilstm_stream.launches
    calls = 0
    for b, t, f, h in ((512, 33, 32, 128), (512, 33, 256, 128), (12, 33, 32, 128),
                       (13, 33, 256, 128), (8, 7, 16, 8)):
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
                assert err_h <= BF16_TOL, err_h
    assert bilstm_stream.launches == before + calls, "the kernel did not launch"
    return max_err


def check_forward(dev):
    """Phase 4: full-width forward, card vs CPU, float32, batch 512."""
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


def call_bam(fasta, bam, out, dtype_flags):
    """One run of the port's CLI; its kernel launch counts start from 0 in
    the child process and are reported on its last stderr line."""
    cmd = [sys.executable, "-m", "clair_tpu_torch", "call_bam",
           "--bam_fn", bam, "--ref_fn", fasta,
           "--chkpnt_fn", str(ROOT / "examples" / "ont_synthetic.ckpt"),
           "--ctgName", "chr1", "--threshold", "0.2", "--call_fn", out, *dtype_flags]
    started = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=500)
    wall = time.perf_counter() - started
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    launches = json.loads(proc.stderr.strip().splitlines()[-1])["kernel_launches"]
    sites = [line for line in proc.stderr.splitlines() if "candidate sites processed" in line]
    rows = [r.split("\t") for r in open(out) if not r.startswith("#")]
    return rows, launches, wall, sites[-1] if sites else ""


def score(rows, truth):
    called = {int(r[1]): (r[3], r[4]) for r in rows}
    tp = len(set(truth) & set(called))
    return tp / len(truth), tp / max(len(called), 1)


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
    from clair_tpu_torch.ops import build

    for path in (ROOT / "clair_tpu_torch" / "csrc").glob("*.cu"):
        lib = build.build(path.stem)
        report = build.BUILD_REPORTS.get(path.stem)
        regs = ([line.strip() for line in report.splitlines() if "registers" in line]
                if report is not None else "built before this run")
        print(f"  {lib.relative_to(ROOT)}: {regs}")
    phase("2 build", t)

    t = time.perf_counter()
    max_err = check_kernel(dev)
    phase("3 kernel vs plain", t)

    t = time.perf_counter()
    params = check_forward(dev)
    phase("4 full-width forward", t)

    t = time.perf_counter()
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream

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
    phase("5 main path", t)

    t = time.perf_counter()
    from clair_tpu.params import ModelConfig
    from clair_tpu_torch.models.clair import ClairNet
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream_reference
    from clair_tpu_torch.pipeline.call_var import _device_input

    print(f"times on {card} (CUDA events, mean of 20 after warm-up):")
    kernel_ms = plain_ms = 0.0
    for layer, feat in (("lstm1", 32), ("lstm2", 256)):
        rs = np.random.RandomState(feat)
        p = lstm_params(rs, feat, 128, dev)
        x = torch.tensor(rs.randn(512, 33, feat), dtype=torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            k = cuda_ms(lambda: bilstm_stream(p, xd))
            pl = cuda_ms(lambda: bilstm_stream_reference(p, xd))
            print(f"  {layer} B=512 {str(dtype)[6:]}: kernel {k:.4f} ms, plain {pl:.4f} ms")
            if dtype == torch.bfloat16:
                kernel_ms += k
                plain_ms += pl
    x = torch.from_numpy(np.random.RandomState(8).randint(0, 40, (512, 33, 8, 4)).astype(np.uint8)).to(dev)
    for dtype in ("float32", "bfloat16"):
        model = ClairNet.from_jax(params, ModelConfig(compute_dtype=dtype), dev)
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(_device_input(x)))
        print(f"  forward B=512 {dtype}: {ms:.4f} ms, {512 / ms * 1e3:.0f} tensors/s")
    for dtype, (rows, _, wall, sites) in runs.items():
        print(f"  call_bam {dtype}: wall {wall:.2f} s (process start to exit), "
              f"{len(rows)} VCF rows; {sites}")
    phase("6 times", t)

    assert "jax" not in sys.modules
    print(f"card: {card}")
    print(json.dumps({"kernels": [dict(
        KERNEL, launches=runs["bfloat16"][1]["bilstm_stream"], max_abs_err=max_err,
        ms=kernel_ms, plain_ms=plain_ms,
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
