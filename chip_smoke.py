"""Smoke test of the PyTorch port (clair_tpu_torch) on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing its results and seconds:

1. the card (nvidia-smi name and power limit); no CUDA device -> exit 1
2. build every kernel in clair_tpu_torch/csrc/ (one nvcc each, all at once)
3. the streaming forward kernel against its plain PyTorch version, and at
   every launchable (cluster size, rows per tile) at a small batch
   3b. the resident train pair (use_pallas_train_bilstm) against its plain
       versions and torch.autograd, and two backward runs bit for bit, at
       every TRAIN_GEOMETRIES geometry; its forward at every launchable
       (cluster size, rows per tile) of the sweep at a small batch; a CUDA
       width the kernels do not take raises
   3c. use_pallas_bilstm's recurrence kernel (the sweep on the caller's
       xw) against its plain version in the three dtype pairs the model
       gives it, at the launcher's geometry and at every launchable
       (cluster size, rows per tile) for U's piece count; a CUDA width the
       sweep does not take raises
   3d. the two-layer bilstm2 against the two plain layers, at every
       BILSTM2_BATCHES batch and every launchable sweep geometry
4. the streaming backward kernel against its plain PyTorch version, and
   against torch.autograd of the plain forward, on the card; two runs at
   the training shape of lstm2 bit for bit
5. the full-width forward of examples/ont_production.ckpt on the card
   against the plain forward on the CPU, float32, batch 512
6. three full-width Adam steps of make_train_step on the card (kernels)
   against the same steps on the CPU (plain), float32, batch 512
   6b. the same under use_pallas_train_bilstm (the train pair)
7. the calling path: ``python -m clair_tpu_torch call_bam`` on a simulated
   ONT genome with examples/ont_synthetic.ckpt, in the default bfloat16 and
   in float32; recall and precision against the planted truth, the same
   decisions in both dtypes, and the kernels' launch counts in each run
   7b. ``call_bam.call_bam`` with ``Predictor(params, ModelConfig(
       use_pallas_bilstm=True, compute_dtype=d))`` on the same genome, in
       bfloat16 and float32; the float32 decisions equal phase 7's
   7c. ``python -m clair_tpu_torch call_bam_parallel --run --process_pool``
       over the genome's three 10 kb windows with two worker processes (each
       builds its Predictor on the card), then with one: every joblog line
       ok, the same VCF rows from both, recall and precision at the floors
8. the training path: ``python -m clair_tpu_torch train`` at batch 10,000 on
   a bin of 24,000 learnable rows written by the port, in the default
   bfloat16 and in float32; finite losses that fall, checkpoints that load,
   the evaluation report, and both kernels' launch counts in each run
   8b. ``train_model`` under ``use_pallas_train_bilstm``, float32, on the
       same bin: the same checks, only the train pair launching
   8c. phase 7's BAM and a truth VCF of its planted variants through the
       port's CLI alone, one process a command: get_truth, extract_candidates
       --gen4Training, create_tensor (candidates, truth sites),
       pair_with_non_variants, tensor2bin over each half of the contig,
       combine_bins, train (full width, two epochs), call_bam with the new
       checkpoint; the bin holds every paired line and every planted variant
       with a non-reference genotype, finite losses, checkpoints that load,
       only the streaming pair launching in train, a well-formed VCF
9. times (CUDA events after warm-up) beside the card's name and power limit;
   the model's calling forward at B = 512 in both dtypes, streaming and
   under use_pallas_bilstm
   9a. the two backwards (rows 2 and 6) and the resident forward (row 5)
       split by kernel (torch.profiler) at B = 10,000
   9b. the other kernels' times, and the train step under each training pair
   9c. bilstm2 as a library call on the vendored checkpoint's two layers
   9d. each kernel's bound (the least time the card could take for its
       work) and the time of the one PyTorch call that computes the same
       function, where there is one (torch.nn.LSTM, cuDNN, TF32 off)

Each run of phases 7, 7b, 7c, 8, 8b and 8c runs in a process of its own,
so the launch counts it reports start from 0 just before it and are read
just after it (7c's two-worker run launches in its worker processes, which
report none); 9c sets bilstm2's count to 0 just before its call. Any failed
phase raises, so the script exits non-zero without the last line. The last
two lines are a JSON summary of the kernels and the device line
``{"ok": true, "device": {...}}``. Nothing here imports JAX or the JAX
package; phase 2 also builds the port's native host library (C++ pileup and
decode) and says whether it loaded.
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
    "bilstm_train": {
        "name": "bilstm_train_fwd",
        "route": "cuda",
        "source": "clair_tpu_torch/csrc/bilstm_train.cu",
        "replaces": "clair_tpu/ops/pallas_bilstm_train.py:56",
    },
    "bilstm_train_backward": {
        "name": "bilstm_train_bwd",
        "route": "cuda",
        "source": "clair_tpu_torch/csrc/bilstm_train.cu",
        "replaces": "clair_tpu/ops/pallas_bilstm_train.py:84",
    },
    "bilstm_precomputed": {
        "name": "bilstm_recurrence",
        "route": "cuda",
        "source": "clair_tpu_torch/csrc/bilstm.cu",
        "sources": ["clair_tpu_torch/csrc/bilstm.cu", "clair_tpu_torch/csrc/lstm_sweep.cuh"],
        "replaces": "clair_tpu/ops/pallas_bilstm.py:36",
    },
    "bilstm2": {
        "name": "bilstm2",
        "route": "cuda",
        "source": "clair_tpu_torch/csrc/lstm_sweep.cuh",
        "replaces": "clair_tpu/ops/pallas_bilstm2.py:43",
    },
}
STREAM_PAIR = ("bilstm_stream", "bilstm_stream_backward")
TRAIN_PAIR = ("bilstm_train", "bilstm_train_backward")
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
# the simulated ONT genome of phases 7 to 8c, and phase 7c's windows on it
GENOME_LENGTH, POOL_CHUNK = 30_000, 10_000
POOL_WINDOWS = GENOME_LENGTH // POOL_CHUNK
TRAIN_ROWS, TRAIN_EPOCHS = 24_000, 2
# row 2 run twice and compared bit for bit at the training shape of lstm2
BITWISE_GEOMETRY = (10000, 33, 256, 128)
# the forward at every launchable geometry: one small ragged batch
GEOMETRY_BATCH = 100
BWD_GEOMETRIES = ((512, 33, 32, 128), (512, 33, 256, 128), (10000, 33, 256, 128),
                  (13, 33, 256, 128), (8, 7, 16, 8))
# the train pair at the training batch (10,000) and at 512 for both layers,
# a ragged batch (13, no multiple of the sweeps' 8- and 16-row tiles) and a
# tiny odd geometry;
# use_pallas_bilstm's kernel at the calling batch and a ragged one (and, at
# every sweep geometry, also GEOMETRY_BATCH and the tiny odd geometry);
# bilstm2 at the calling batch, a ragged one and the training batch
TRAIN_GEOMETRIES = ((10000, 33, 32, 128), (10000, 33, 256, 128), (512, 33, 32, 128),
                    (512, 33, 256, 128), (13, 33, 256, 128), (8, 7, 16, 8))
PRECOMPUTED_GEOMETRIES = ((512, 33, 32, 128), (512, 33, 256, 128), (13, 33, 32, 128),
                          (13, 33, 256, 128))
BILSTM2_BATCHES = (512, 13, 10000)
# the card's peaks (NVIDIA's H100 SXM data sheet, dense, at 700 W): float32
# outside the tensor cores, bf16 on them, and device memory
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
T_LEN, HIDDEN, CALL_BATCH, TRAIN_BATCH = 33, 128, 512, 10_000
LAYERS = (("lstm1", 32), ("lstm2", 256))

# calling under use_pallas_bilstm, in a process of its own (phase 7b)
CALL_SCRIPT = """
import json, sys
from clair_tpu_torch.cli import _kernel_counts
from clair_tpu_torch.models.checkpoint import load_checkpoint
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline.call_bam import CallBamConfig, call_bam
from clair_tpu_torch.pipeline.call_var import Predictor
bam, fasta, ckpt, out, dtype = sys.argv[1:]
params, _ = load_checkpoint(ckpt)
# the flags of phase 7's call_bam command: --ctgName chr1 --threshold 0.2
config = CallBamConfig(bam_path=bam, fasta_path=fasta, contig="chr1", minimum_af=0.2)
predictor = Predictor(params, ModelConfig(use_pallas_bilstm=True, compute_dtype=dtype))
total = call_bam(config, predictor, output_path=out)
print(f"[INFO] {total} candidate sites processed", file=sys.stderr)
print(json.dumps({"kernel_launches": _kernel_counts()}), file=sys.stderr)
"""
# training under use_pallas_train_bilstm, in a process of its own (phase 8b)
TRAIN_SCRIPT = """
import json, logging, sys
from clair_tpu_torch.cli import _kernel_counts
from clair_tpu_torch.data.bins import load_bin
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline.train import TrainingConfig, train_model
logging.basicConfig(format="%(message)s", level=logging.INFO)
bin_fn, prefix, epochs = sys.argv[1], sys.argv[2], int(sys.argv[3])
result = train_model(load_bin(bin_fn), TrainingConfig(
    model=ModelConfig(use_pallas_train_bilstm=True), train_compute_dtype="float32",
    output_prefix=prefix, max_epochs=epochs, hard_max_epochs=epochs))
print(json.dumps({"kernel_launches": _kernel_counts(),
                  "training_losses": result.training_losses,
                  "validation_losses": result.validation_losses,
                  "best_epoch": result.best_epoch}), file=sys.stderr)
"""


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


def kernel_counts():
    from clair_tpu_torch.cli import _kernel_counts

    return _kernel_counts()


def launched_since(before):
    return {k: v - before[k] for k, v in kernel_counts().items()}


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
    """Phase 2: one nvcc per source and the native host library (g++), all
    started together."""
    from clair_tpu_torch import native
    from clair_tpu_torch.ops import build

    names = sorted(p.stem for p in (ROOT / "clair_tpu_torch" / "csrc").glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names) + 1) as pool:
        host = pool.submit(native.available)
        libs = dict(zip(names, pool.map(build.build, names)))
        loaded = host.result()
    built = ("built before this run" if native.BUILD_SECONDS is None
             else f"built in {native.BUILD_SECONDS:.2f} s")
    print(f"  native host library {Path(native._lib_path()).relative_to(ROOT)}: "
          f"loaded {loaded}, {built}")
    assert loaded, f"the port's native host library did not build or load:\n{native.BUILD_ERROR}"
    for name, lib in libs.items():
        report = build.BUILD_REPORTS.get(name)
        regs = ([line.strip() for line in report.splitlines()
                 if "registers" in line or "spill stores" in line]
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
    return max(max_err, check_forward_geometries(dev))


def check_forward_geometries(dev):
    """Phase 3, second part: the forward kernel at every (cluster size, rows
    per tile) that launches (clair_bilstm_stream_fwd_geometry), at a small
    ragged batch of each layer's width, in both dtypes, against the plain
    version within F32_TOL / BF16_TOL (idle warps at the larger clusters,
    where a race once hid)."""
    from clair_tpu_torch.ops.bilstm_stream import (
        FWD_CLUSTERS, FWD_ROWS, _stack_params, bilstm_stream_reference, forward_geometry,
    )

    max_err = 0.0
    for layer, feat in LAYERS:
        rs = np.random.RandomState(feat + 2)
        params = lstm_params(rs, feat, HIDDEN, dev)
        x = torch.tensor(rs.randn(GEOMETRY_BATCH, T_LEN, feat), dtype=torch.float32, device=dev)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            xd = x.to(dtype)
            want_h, want_c = bilstm_stream_reference(params, xd)
            launched, worst = [], 0.0
            for cluster in FWD_CLUSTERS:
                for rows in FWD_ROWS:
                    got = forward_geometry(xd, *_stack_params(params, dtype), cluster, rows)
                    if got is None:
                        continue
                    torch.cuda.synchronize()
                    err = max((got[0].float() - want_h.float()).abs().max().item(),
                              (got[1] - want_c).abs().max().item())
                    assert err <= tol, (layer, str(dtype), cluster, rows, err)
                    launched.append((cluster, rows))
                    worst = max(worst, err)
            assert launched, (layer, dtype)
            if dtype == torch.float32:
                max_err = max(max_err, worst)
            print(f"  forward {layer} B={GEOMETRY_BATCH} {str(dtype)[6:]} at every launchable "
                  f"(cluster, rows), {len(launched)} of {len(FWD_CLUSTERS) * len(FWD_ROWS)}: "
                  f"max|d| {worst:.3e}; {launched}")
    return max_err


def stacked_inputs(geometry, dev, seed):
    """The train pair's inputs on the stacked layout: xs (T, 2B, F), w, u,
    b, and a cotangent dh (T, 2B, H), from a seed."""
    from clair_tpu_torch.models.bilstm import _stack_directions
    from clair_tpu_torch.ops.bilstm_train import _stack_params

    b, t, f, h = geometry
    rs = np.random.RandomState(seed)
    params = lstm_params(rs, f, h, dev)
    xs = _stack_directions(torch.tensor(rs.randn(b, t, f), dtype=torch.float32, device=dev))
    dh = torch.tensor(rs.randn(t, 2 * b, h), dtype=torch.float32, device=dev)
    return (xs.contiguous(), *_stack_params(params), dh)


def check_train_pair(dev):
    """Phase 3b: the resident forward (h, c) and backward (dx, dW, dU, db)
    kernels vs their plain versions on the same inputs, the backward also
    vs torch.autograd.grad of the plain forward, and two backward runs bit
    for bit (fixed-order partial sums, no atomics)."""
    from clair_tpu_torch.ops.bilstm_train import (
        bilstm_train_backward, bilstm_train_backward_reference, bilstm_train_forward,
        bilstm_train_reference,
    )

    errs = {"bilstm_train": 0.0, "bilstm_train_backward": 0.0}
    before = kernel_counts()
    names = ("dx", "dw", "du", "db")
    for geometry in TRAIN_GEOMETRIES:
        xs, w, u, b, dh = stacked_inputs(geometry, dev, sum(geometry))
        h_out, c_out = bilstm_train_forward(xs, w, u, b)
        h_p, c_p = bilstm_train_reference(xs, w, u, b)
        got = bilstm_train_backward(xs, w, u, b, h_out, c_out, dh)
        again = bilstm_train_backward(xs, w, u, b, h_out, c_out, dh)
        want = bilstm_train_backward_reference(xs, w, u, b, h_out, c_out, dh)
        leaves = [t_.detach().requires_grad_() for t_ in (xs, w, u, b)]
        grads = torch.autograd.grad((bilstm_train_reference(*leaves)[0] * dh).sum(), leaves)
        torch.cuda.synchronize()
        err_h, err_c = ((h_out - h_p).abs().max().item(), (c_out - c_p).abs().max().item())
        assert err_h <= F32_TOL and err_c <= F32_TOL, (geometry, err_h, err_c)
        errs["bilstm_train"] = max(errs["bilstm_train"], err_h, err_c)
        line = [f"max|dh| {err_h:.3e} max|dc| {err_c:.3e}"]
        for name, g, g2, r, a in zip(names, got, again, want, grads):
            assert g.shape == r.shape and torch.isfinite(g).all(), name
            assert torch.equal(g, g2), f"{name}: two runs differ"
            err, scale = (g - r).abs().max().item(), r.abs().max().item()
            err_ag = (g - a).abs().max().item()
            assert err <= BWD_REL_TOL * scale and err_ag <= BWD_REL_TOL * scale, (
                geometry, name, err, err_ag, scale)
            errs["bilstm_train_backward"] = max(errs["bilstm_train_backward"], err)
            line.append(f"{name} {err:.2e}/{scale:.2e}")
        print(f"  train pair vs plain {geometry}: " + ", ".join(line)
              + "; autograd agrees; backward bit-identical over two runs")
    launched = launched_since(before)
    assert launched["bilstm_train"] == len(TRAIN_GEOMETRIES), launched
    assert launched["bilstm_train_backward"] == 2 * len(TRAIN_GEOMETRIES), launched
    errs["bilstm_train"] = max(errs["bilstm_train"], check_sweep_geometries(dev))
    # no fallback to the plain version for a CUDA tensor: a width whose
    # 16-byte chunks the products cannot stage raises, in both kernels
    xs, w, u, b, dh = stacked_inputs((4, 5, 12, 8), dev, 7)
    h_out, c_out = bilstm_train_reference(xs, w, u, b)
    for name, run in (("forward", lambda: bilstm_train_forward(xs, w, u, b)),
                      ("backward", lambda: bilstm_train_backward(xs, w, u, b, h_out, c_out, dh))):
        try:
            run()
        except ValueError as refused:
            print(f"  train {name} at F = 12 on the card raises: {refused}")
        else:
            raise AssertionError(f"the train {name} took F = 12 on the card")
    return errs


def check_sweep_geometries(dev):
    """Phase 3b, second part: row 5's forward at every (cluster size, rows
    per tile) of the sweep that launches, at a small ragged batch of each
    layer's width, against the plain version within F32_TOL (h and c). No
    count moves (the geometry runs serve no path)."""
    from clair_tpu_torch.ops.bilstm_train import (
        _forward_launch, bilstm_train_reference, sweep_geometries,
    )

    worst_all, before = 0.0, kernel_counts()
    for layer, feat in LAYERS:
        xs, w, u, b, _ = stacked_inputs((GEOMETRY_BATCH, T_LEN, feat, HIDDEN), dev, feat + 11)
        want_h, want_c = bilstm_train_reference(xs, w, u, b)
        launched, worst = [], 0.0
        candidates = sweep_geometries(HIDDEN)
        for cluster, rows in candidates:
            got = _forward_launch(xs, w, u, b, cluster=cluster, rows=rows)
            if got is None:
                continue
            torch.cuda.synchronize()
            err = max((got[0] - want_h).abs().max().item(), (got[1] - want_c).abs().max().item())
            assert err <= F32_TOL, (layer, cluster, rows, err)
            launched.append((cluster, rows))
            worst = max(worst, err)
        assert launched, layer
        worst_all = max(worst_all, worst)
        print(f"  row 5 forward {layer} B={GEOMETRY_BATCH} at every launchable (cluster, rows) "
              f"of the sweep, {len(launched)} of {len(candidates)} that fit: max|d| "
              f"{worst:.3e}; {launched}")
    assert launched_since(before) == dict.fromkeys(before, 0)
    return worst_all


def precomputed_inputs(geometry, dev, p_dtype, x_dtype, seed):
    """(xw, u) as use_pallas_bilstm's layer gives them to its kernel."""
    from clair_tpu_torch.ops.bilstm import projections

    b, t, f, h = geometry
    rs = np.random.RandomState(seed)
    params = {d: {k: v.to(p_dtype) for k, v in p.items()}
              for d, p in lstm_params(rs, f, h, dev).items()}
    x = torch.tensor(rs.randn(b, t, f), dtype=torch.float32, device=dev).to(x_dtype)
    return projections(params, x)


# (parameter dtype, input dtype) pairs the model gives use_pallas_bilstm's
# layer: float32; lstm1 under bf16 (xw bf16); lstm2 under bf16 (xw float32)
PRECOMPUTED_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                      (torch.bfloat16, torch.float32))


def check_precomputed(dev):
    """Phase 3c: the recurrence kernel vs its plain version on the same xw
    and u, in each dtype pair (U as one bf16 piece or three), float32
    output within F32_TOL (both compute in float32 from the same values):
    at the launcher's geometry (one count each) and at every (cluster size,
    rows per tile) of the sweep that launches for U's piece count (no
    count), at a small ragged batch of each layer's width, at
    PRECOMPUTED_GEOMETRIES and at a tiny odd geometry. No fallback to the
    plain version for a CUDA tensor: a width the sweep cannot take raises."""
    from clair_tpu_torch.ops.bilstm import (
        _launch, bilstm_recurrence, bilstm_recurrence_reference, u_pieces,
    )
    from clair_tpu_torch.ops.bilstm_train import sweep_geometries

    max_err, calls, before = 0.0, 0, kernel_counts()
    shapes = ([(GEOMETRY_BATCH, T_LEN, feat, HIDDEN) for _, feat in LAYERS]
              + list(PRECOMPUTED_GEOMETRIES) + [(8, 7, 16, 8)])
    for geometry in shapes:
        for p_dtype, x_dtype in PRECOMPUTED_DTYPES:
            xw, u = precomputed_inputs(geometry, dev, p_dtype, x_dtype, sum(geometry))
            want = bilstm_recurrence_reference(xw, u)
            got = bilstm_recurrence(xw, u)
            calls += 1
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            assert got.dtype == torch.float32 and err <= F32_TOL, (geometry, err)
            candidates = sweep_geometries(geometry[3], u_pieces(u))
            launched, worst = [], err
            for cluster, rows in candidates:
                got = _launch(xw, u, cluster, rows)
                if got is None:
                    continue
                torch.cuda.synchronize()
                e = (got - want).abs().max().item()
                assert e <= F32_TOL, (geometry, str(xw.dtype), str(u.dtype), cluster, rows, e)
                launched.append((cluster, rows))
                worst = max(worst, e)
            assert launched, (geometry, xw.dtype, u.dtype)
            max_err = max(max_err, worst)
            print(f"  recurrence vs plain {geometry} xw {str(xw.dtype)[6:]} u {str(u.dtype)[6:]} "
                  f"(U in {u_pieces(u)} piece(s)): launcher's max|dh| {err:.3e}; at every "
                  f"launchable (cluster, rows), {len(launched)} of {len(candidates)} that fit: "
                  f"max|dh| {worst:.3e}")
    launched = launched_since(before)
    assert launched == {**dict.fromkeys(before, 0), "bilstm_precomputed": calls}, launched
    xw, u = precomputed_inputs((4, 5, 16, 12), dev, torch.float32, torch.float32, 7)
    try:
        bilstm_recurrence(xw, u)
    except ValueError as refused:
        print(f"  recurrence at H = 12 on the card raises: {refused}")
    else:
        raise AssertionError("the recurrence took H = 12 on the card")
    return max_err


def check_bilstm2(dev):
    """Phase 3d: bilstm2 vs the two plain layers, float32, within F32_TOL,
    at every BILSTM2_BATCHES batch (one count of bilstm2 each, none of the
    train forward whose kernels it runs), and at every launchable sweep
    geometry at a small ragged batch (no count)."""
    from clair_tpu_torch.ops.bilstm2 import _layers, bilstm2, bilstm2_reference
    from clair_tpu_torch.ops.bilstm_train import sweep_geometries

    max_err = 0.0
    before = kernel_counts()
    with torch.no_grad():
        for batch in BILSTM2_BATCHES:
            rs = np.random.RandomState(batch)
            p1, p2 = lstm_params(rs, 32, 128, dev), lstm_params(rs, 256, 128, dev)
            x = torch.tensor(rs.randn(batch, 33, 32), dtype=torch.float32, device=dev)
            got, want = bilstm2(p1, p2, x), bilstm2_reference(p1, p2, x)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            assert got.shape == (batch, 33, 256) and err <= F32_TOL, (batch, err)
            max_err = max(max_err, err)
            print(f"  bilstm2 vs plain B={batch}: max|dh| {err:.3e}")
        launched = launched_since(before)
        assert launched == {**dict.fromkeys(before, 0), "bilstm2": len(BILSTM2_BATCHES)}, launched
        rs = np.random.RandomState(GEOMETRY_BATCH)
        p1, p2 = lstm_params(rs, 32, 128, dev), lstm_params(rs, 256, 128, dev)
        x = torch.tensor(rs.randn(GEOMETRY_BATCH, 33, 32), dtype=torch.float32, device=dev)
        want = bilstm2_reference(p1, p2, x)
        done, worst = [], 0.0
        for cluster, rows in sweep_geometries(HIDDEN):
            got = _layers(p1, p2, x, cluster, rows)
            if got is None:
                continue
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            assert err <= F32_TOL, (cluster, rows, err)
            done.append((cluster, rows))
            worst = max(worst, err)
    assert done and launched_since(before)["bilstm2"] == len(BILSTM2_BATCHES)
    max_err = max(max_err, worst)
    print(f"  bilstm2 B={GEOMETRY_BATCH} at every launchable (cluster, rows) of the sweep, "
          f"{len(done)}: max|dh| {worst:.3e}")
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
            line = []
            if (b, t, f, h) == BITWISE_GEOMETRY:
                # fixed-order partial sums, no atomics: the same bits every run
                again = bilstm_stream_backward(xd, w, u, bias, h_out, c_out, dh)
                calls += 1
                for name, g, g2 in zip(names, got, again):
                    assert torch.equal(g, g2), f"{name}: two runs differ"
                line.append("bit-identical over two runs")
            want = bilstm_stream_backward_reference(xd, w, u, bias, h_out, c_out, dh)
            torch.cuda.synchronize()
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
    from clair_tpu_torch.models.checkpoint import load_checkpoint
    from clair_tpu_torch.models.clair import ClairNet
    from clair_tpu_torch.params import ModelConfig
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


def check_train_step(params, pair=STREAM_PAIR, **flags):
    """Phases 6 and 6b: three full-width Adam steps, card (kernels) vs CPU
    (plain), float32, every dropout rate 0, batch 512, with the kernel pair
    the ModelConfig ``flags`` select; only that pair launches, 6 + 6
    times."""
    from clair_tpu_torch.models.clair import ClairNet, params_to_jax
    from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step
    from clair_tpu_torch.params import ModelConfig

    config = dataclasses.replace(ModelConfig(), lstm2_dropout_rate=0.0, l4_dropout_rate=0.0,
                                 l5_dropout_rate=0.0, **flags)
    x, y = pileup_batch(np.random.RandomState(11), 512)
    runs = {}
    before = kernel_counts()
    for device in ("cuda", "cpu"):
        model = ClairNet.from_jax(params, config, device)
        step = make_train_step(model, make_optimizer(dict(model.named_parameters()), "Adam", 1e-3))
        xd, yd = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
        generator = torch.Generator(device=device)
        losses = [step(xd, yd, generator, 0.005)[0].item() for _ in range(3)]
        runs[device] = (losses, params_to_jax(model.state_dict()))
    launched = launched_since(before)
    assert launched == {k: (6 if k in pair else 0) for k in launched}, launched
    card, cpu = runs["cuda"][0], runs["cpu"][0]
    assert all(math.isfinite(v) for v in card)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    print(f"  train step card vs CPU {flags or ''}, losses {card} vs {cpu}, "
          f"max rel diff {rel:.2e}; launches {launched}")
    assert rel <= STEP_RTOL, (card, cpu)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)])

    cpu_params = dict(leaves(runs["cpu"][1]))
    diff = {k: float(np.abs(v - cpu_params[k]).max()) for k, v in leaves(runs["cuda"][1])}
    worst = max(diff, key=diff.get)
    print(f"  final parameters card vs CPU: max|d| {diff[worst]:.3e} ({worst})")


def simulate_genome(workdir: Path):
    """The ONT genome of phases 7 to 8c: FASTA, BAM, {position: (ref, alt)}
    and the planted variants."""
    from clair_tpu_torch.utils import simulate

    recipe = simulate.PLATFORM_RECIPES["ont"]
    rs = np.random.RandomState(424242)
    reference = simulate.random_reference(rs, GENOME_LENGTH)
    variants = simulate.plant_variants(rs, reference, n_variants=120, spacing=200)
    fasta, bam = str(workdir / "ref.fa"), str(workdir / "reads.bam")
    simulate.write_fasta(fasta, reference)
    simulate.simulate_bam(bam, reference, variants, rs, coverage=recipe["coverage"],
                          read_length=recipe["read_length"],
                          read_length_sigma=recipe["read_length_sigma"],
                          error_profile=getattr(simulate, recipe["profile_name"]))
    return fasta, bam, {v.position: (v.ref, v.alt) for v in variants}, variants


def run_command(args, timeout):
    """``python <args>`` in a process of its own: (wall seconds, stderr)."""
    cmd = [sys.executable, *args]
    started = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - started
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:4])} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return wall, proc.stderr


def run_process(args, timeout):
    """``python <args>`` in a process of its own; its kernel launch counts
    start from 0 there and are reported on its last stderr line."""
    wall, stderr = run_command(args, timeout)
    report = json.loads(stderr.strip().splitlines()[-1])
    return report, wall, stderr


def run_port(args, timeout):
    """One run of the port's CLI in a process of its own."""
    return run_process(["-m", "clair_tpu_torch", *args], timeout)


def calls_of(out, report, wall, stderr):
    sites = [line for line in stderr.splitlines() if "candidate sites processed" in line]
    rows = [r.split("\t") for r in open(out) if not r.startswith("#")]
    return rows, report["kernel_launches"], wall, sites[-1] if sites else ""


def call_bam(fasta, bam, out, dtype_flags):
    return calls_of(out, *run_port(
        ["call_bam", "--bam_fn", bam, "--ref_fn", fasta,
         "--chkpnt_fn", str(ROOT / "examples" / "ont_synthetic.ckpt"),
         "--ctgName", "chr1", "--threshold", "0.2", "--call_fn", out, *dtype_flags], 500))


def call_bam_precomputed(fasta, bam, out, dtype):
    """Phase 7b, one run: call_bam.call_bam with use_pallas_bilstm."""
    return calls_of(out, *run_process(
        ["-c", CALL_SCRIPT, bam, fasta, str(ROOT / "examples" / "ont_synthetic.ckpt"), out,
         dtype], 500))


def score(rows, truth):
    called = {int(r[1]): (r[3], r[4]) for r in rows}
    tp = len(set(truth) & set(called))
    return tp / len(truth), tp / max(len(called), 1)


def decisions(rows):
    """(CHROM, POS, REF, ALT, GT) of each VCF row."""
    return [(r[0], r[1], r[3], r[4], r[9].split(":")[0]) for r in rows]


def process_pool(fasta, bam, truth, tmp: Path, card):
    """Phase 7c: ``call_bam_parallel --run --process_pool`` over the genome's
    POOL_WINDOWS windows with two worker processes (each builds its own
    Predictor on the card), then with one (in the command's process). Every
    joblog line ok, the same VCF rows from both, recall and precision at the
    floors."""
    rows_of = {}
    for workers in (2, 1):
        prefix = str(tmp / f"pool_{workers}")
        report, wall, _ = run_port(
            ["call_bam_parallel", "--run", "--process_pool", "--bam_fn", bam, "--ref_fn", fasta,
             "--chkpnt_fn", str(ROOT / "examples" / "ont_synthetic.ckpt"),
             "--output_prefix", prefix, "--refChunkSize", str(POOL_CHUNK), "--threshold", "0.2",
             "--workers", str(workers)], 600)
        log = [json.loads(line) for line in open(prefix + ".joblog")]
        assert [e["status"] for e in log] == ["ok"] * POOL_WINDOWS, \
            f"--workers {workers}: windows not all ok: {log}"
        rows = [r.split("\t") for r in open(prefix + ".vcf") if not r.startswith("#")]
        recall, precision = score(rows, truth)
        launches = report["kernel_launches"]
        elapsed = ", ".join(f"{e['elapsed']:.2f}" for e in log)
        print(f"  call_bam_parallel --process_pool --workers {workers}: {len(log)} windows ok "
              f"({elapsed} s each), {len(rows)} calls, "
              f"recall {recall:.4f}, precision {precision:.4f}, the command process's kernel "
              f"launches {launches}, wall {wall:.2f} s (process start to exit) on {card}")
        assert recall >= RECALL_FLOOR and precision >= PRECISION_FLOOR, (recall, precision)
        # with one worker the command's own process calls every window
        assert workers > 1 or launches["bilstm_stream"] > 0, launches
        rows_of[workers] = rows
    assert rows_of[2] == rows_of[1], "the VCF rows of --workers 2 and --workers 1 differ"
    print("  --workers 2 and --workers 1 VCF rows identical")


def training_data_path(fasta, bam, variants, tmp: Path, card):
    """Phase 8c: BAM + truth VCF -> bin -> full-width model -> VCF, each step
    a command of the port's CLI in a process of its own. No accuracy floor:
    two epochs on a few hundred rows show the path, not a caller."""
    from clair_tpu_torch import cli
    from clair_tpu_torch.data.bins import load_bin
    from clair_tpu_torch.models.checkpoint import checkpoint_path, load_checkpoint
    from clair_tpu_torch.task.labels import GENOTYPE_SPAN
    from clair_tpu_torch.utils.simulate import write_truth_vcf

    scan = cli._native_region_scan(bam, fasta, "chr1", 1, GENOME_LENGTH, 0)
    assert scan is not None, "the native counts pass does not engage on the genome's BAM"
    scan.close()
    p = {k: str(tmp / k) for k in ("truth.vcf", "var", "can", "t_can", "t_var", "paired",
                                   "half_1", "half_2", "half_1.bin", "half_2.bin", "all.bin",
                                   "model", "calls.vcf")}
    write_truth_vcf(p["truth.vcf"], variants)
    walls = {}

    def host(name, args):
        walls[name], _ = run_command(["-m", "clair_tpu_torch", *args], 300)

    host("get_truth", ["get_truth", "--vcf_fn", p["truth.vcf"], "--ctgName", "chr1",
                       "--var_fn", p["var"]])
    host("extract_candidates", ["extract_candidates", "--bam_fn", bam, "--ref_fn", fasta,
                                "--ctgName", "chr1", "--gen4Training", "--var_fn", p["var"],
                                "--can_fn", p["can"]])
    for which, sites in (("t_can", "can"), ("t_var", "var")):
        host(f"create_tensor {sites}", ["create_tensor", "--bam_fn", bam, "--ref_fn", fasta,
                                        "--ctgName", "chr1", "--can_fn", p[sites],
                                        "--tensor_fn", p[which]])
    host("pair_with_non_variants", ["pair_with_non_variants", "--tensor_can_fn", p["t_can"],
                                    "--tensor_var_fn", p["t_var"], "--output_fn", p["paired"]])
    paired = open(p["paired"]).read().splitlines()
    half = GENOME_LENGTH // 2
    for name, keep in (("half_1", lambda pos: pos <= half), ("half_2", lambda pos: pos > half)):
        with open(p[name], "w") as fh:
            fh.writelines(r + "\n" for r in paired if keep(int(r.split(maxsplit=2)[1])))
        host(f"tensor2bin {name}", ["tensor2bin", "--tensor_fn", p[name], "--var_fn", p["var"],
                                    "--bin_fn", p[f"{name}.bin"]])
    host("combine_bins", ["combine_bins", p["half_1.bin"], p["half_2.bin"],
                          "--output_fn", p["all.bin"]])

    dataset = load_bin(p["all.bin"])
    assert dataset.dataset_size == len(paired), (dataset.dataset_size, len(paired))
    keys = [str(k) for i in range(dataset.n_blocks) for k in dataset.pos_block(i)]
    labels = np.concatenate([dataset.y_block(i) for i in range(dataset.n_blocks)])
    row = {k: i for i, k in enumerate(keys)}
    missing = [v.position for v in variants if f"chr1:{v.position}" not in row]
    assert not missing, f"planted variants not in the bin: {missing}"
    homref = [v.position for v in variants if labels[row[f"chr1:{v.position}"], GENOTYPE_SPAN[0]]]
    assert not homref, f"planted variants labelled 0/0: {homref}"
    print(f"  bin: {dataset.dataset_size} rows (= paired tensor lines), "
          f"{len(open(p['t_var']).read().splitlines())} truth tensors, every planted "
          f"variant with a non-reference genotype label")

    report, walls["train"], stderr = run_port(
        ["train", "--bin_fn", p["all.bin"], "--ochk_prefix", p["model"],
         "--maxEpoch", str(TRAIN_EPOCHS)], 600)
    losses = [v for v, _ in report["training_losses"] + report["validation_losses"]]
    assert len(report["training_losses"]) == TRAIN_EPOCHS and all(map(math.isfinite, losses)), \
        report
    for epoch in range(1, TRAIN_EPOCHS + 1):
        params, extra = load_checkpoint(checkpoint_path(p["model"], epoch))
        assert extra["epoch"] == epoch and params["l3"]["w"].shape == (256, 33, 30)
    launches = report["kernel_launches"]
    assert all((launches[k] > 0) == (k in STREAM_PAIR) for k in KERNELS), launches
    epochs = [line for line in stderr.splitlines() if "Epoch time elapsed" in line]
    print(f"  train at full width, batch {TRAIN_BATCH}: loss sums {report['training_losses']} "
          f"(training), {report['validation_losses']} (validation), kernel launches "
          f"{launches}; {epochs}")

    report, walls["call_bam"], _ = run_port(
        ["call_bam", "--bam_fn", bam, "--ref_fn", fasta,
         "--chkpnt_fn", checkpoint_path(p["model"], TRAIN_EPOCHS), "--ctgName", "chr1",
         "--threshold", "0.2", "--call_fn", p["calls.vcf"]], 500)
    lines = open(p["calls.vcf"]).read().splitlines()
    header = [r for r in lines if r.startswith("#CHROM")]
    rows = [r.split("\t") for r in lines if not r.startswith("#")]
    assert lines[0].startswith("##fileformat=VCF") and len(header) == 1, lines[:3]
    assert all(len(r) == 10 and r[0] == "chr1" for r in rows), rows[:3]
    positions = [int(r[1]) for r in rows]
    assert positions == sorted(positions) and all(1 <= x <= GENOME_LENGTH for x in positions)
    assert report["kernel_launches"]["bilstm_stream"] > 0, report
    print(f"  call_bam with the epoch-{TRAIN_EPOCHS} checkpoint: {len(rows)} rows, kernel "
          f"launches {report['kernel_launches']}")
    print(f"  walls (process start to exit) on {card}: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))


def write_training_bin(path: Path):
    """TRAIN_ROWS learnable rows in blocks of BIN_BLOCK_SIZE, written by the
    port's bins module."""
    from clair_tpu_torch.data import bins
    from clair_tpu_torch.io import lz4
    from clair_tpu_torch.params import BIN_BLOCK_SIZE

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


def train(prefix: Path, run, pair=STREAM_PAIR):
    """Phases 8 and 8b, one run: ``run()`` trains into ``prefix`` in a
    process of its own; then its checks. Only the kernel ``pair`` launches."""
    from clair_tpu_torch.models.checkpoint import checkpoint_path, load_checkpoint

    report, wall, stderr = run()
    val = [v for v, _ in report["validation_losses"]]
    trn = [v for v, _ in report["training_losses"]]
    assert len(val) == TRAIN_EPOCHS and all(math.isfinite(v) for v in val + trn), report
    assert val[-1] < val[0], f"validation loss did not fall: {val}"
    for epoch in range(1, TRAIN_EPOCHS + 1):
        params, extra = load_checkpoint(checkpoint_path(str(prefix), epoch))
        assert extra["epoch"] == epoch and params["l3"]["w"].shape == (256, 33, 30)
    assert "[INFO] Evaluation on gt21:" in stderr and "gt21 all/top1/top2" in stderr
    launches = report["kernel_launches"]
    assert all((launches[k] > 0) == (k in pair) for k in KERNELS), launches
    top = [line for line in stderr.splitlines() if "gt21 all/top1/top2" in line][-1]
    epochs = [line for line in stderr.splitlines() if "Epoch time elapsed" in line]
    return report, wall, top, epochs


def train_step_times(params, dev, dtype, **flags):
    """ms per full-width train step at batch 10,000 (host clock around
    synchronized steps, after a warm-up step)."""
    from clair_tpu_torch.models.clair import ClairNet
    from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step
    from clair_tpu_torch.params import TRAIN_BATCH_SIZE, ModelConfig

    model = ClairNet.from_jax(params, ModelConfig(compute_dtype=dtype, **flags), dev)
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


# the backwards' kernels by part, from substrings of their names (the rest
# are the wrapper's torch ops: U's transpose and the sum of the weight
# partials); row 2's problems are GateProblem, ..., row 6's StackedGateProblem
BWD_PARTS = (("gate product", ("GateProblem",)), ("sweep", ("sweep",)),
             ("weight sums", ("WeightSumProblem",)), ("dx", ("DxProblem",)),
             ("float32 pieces", ("split_pieces",)))


def device_parts(run, iters, label):
    """run()'s device time by part of BWD_PARTS (torch.profiler's
    key_averages over ``iters`` calls after a warm-up), ms per call, with
    "total" the CUDA-event time of the same calls."""
    from torch.profiler import ProfilerActivity, profile

    total = cuda_ms(run, iters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    parts = {name: 0.0 for name, _ in BWD_PARTS}
    parts["other (torch ops)"] = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0:
            continue
        part = next((name for name, keys in BWD_PARTS
                     if any(k in e.key for k in keys)), "other (torch ops)")
        parts[part] += us / 1e3 / iters
        print(f"    {label} {e.key[:90]}: {us / 1e3 / iters:.4f} ms x{e.count // iters}")
    parts["total"] = total
    print(f"  {label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()), flush=True)
    return parts


def backward_split(dev, batch=TRAIN_BATCH, iters=5, dtypes=(torch.bfloat16, torch.float32),
                   pair=STREAM_PAIR):
    """A backward's device time by part (``device_parts``), per layer (lstm1
    without dx, as the train step runs it) and dtype: row 2 (``pair`` =
    STREAM_PAIR) in ``dtypes``, or row 6 (TRAIN_PAIR, float32 only) on the
    stacked layout. {(layer, dtype): {part: ms per call}}."""
    from clair_tpu_torch.ops.bilstm_stream import _forward, _stack_params, bilstm_stream_backward
    from clair_tpu_torch.ops.bilstm_train import bilstm_train_backward, bilstm_train_forward

    train = pair == TRAIN_PAIR
    split = {}
    for layer, feat in LAYERS:
        need_dx = layer == "lstm2"  # lstm1's input takes no gradient
        if not train:
            rs = np.random.RandomState(feat + 3)
            p = lstm_params(rs, feat, HIDDEN, dev)
            x = torch.tensor(rs.randn(batch, T_LEN, feat), dtype=torch.float32, device=dev)
            dh32 = torch.tensor(rs.randn(batch, T_LEN, 2 * HIDDEN), dtype=torch.float32,
                                device=dev)
        for dtype in (torch.float32,) if train else dtypes:
            if train:
                xs, w, u, bias, dh = stacked_inputs((batch, T_LEN, feat, HIDDEN), dev, feat + 5)
                h_out, c_out = bilstm_train_forward(xs, w, u, bias)

                def run():
                    return bilstm_train_backward(xs, w, u, bias, h_out, c_out, dh,
                                                 need_dx=need_dx)
            else:
                w, u, bias = _stack_params(p, dtype)
                xd, dh = x.to(dtype), dh32.to(dtype)
                h_out, c_out = _forward(xd, w, u, bias, with_cell=True)

                def run():
                    return bilstm_stream_backward(xd, w, u, bias, h_out, c_out, dh,
                                                  need_dx=need_dx)

            name = str(dtype)[6:]
            split[(layer, name)] = device_parts(
                run, iters, f"row {6 if train else 2} split {layer} B={batch} {name}")
    return split


def forward_split(dev, batch=TRAIN_BATCH, iters=5):
    """Row 5's device time by part (``device_parts``: the float32 pieces of
    xs and W, the product xw = xs.W + b under "gate product", the sweep),
    per layer at the training batch. {layer: {part: ms per call}}."""
    from clair_tpu_torch.ops.bilstm_train import bilstm_train_forward

    split = {}
    for layer, feat in LAYERS:
        xs, w, u, bias, _ = stacked_inputs((batch, T_LEN, feat, HIDDEN), dev, feat + 5)
        split[layer] = device_parts(lambda: bilstm_train_forward(xs, w, u, bias), iters,
                                    f"row 5 split {layer} B={batch} float32")
    return split


def new_kernel_times(params, dev, ms, plain_ms):
    """Phase 9b: the new kernels and their plain versions at the paths'
    shapes (CUDA events after a warm-up), and the train step at batch
    10,000 under each training pair. Fills ``ms`` and ``plain_ms`` with the
    JSON line's sums: the train pair per layer at B = 10,000, the
    recurrence per layer at B = 512 in bfloat16 (the calling default's
    dtypes), bilstm2 at B = 512."""
    from clair_tpu_torch.ops.bilstm import (
        bilstm_recurrence, bilstm_recurrence_reference,
    )
    from clair_tpu_torch.ops.bilstm2 import bilstm2, bilstm2_reference
    from clair_tpu_torch.ops.bilstm_train import (
        bilstm_train_backward, bilstm_train_backward_reference, bilstm_train_forward,
        bilstm_train_reference,
    )

    for layer, feat in (("lstm1", 32), ("lstm2", 256)):
        xs, w, u, b, dh = stacked_inputs((10000, 33, feat, 128), dev, feat + 5)
        h_out, c_out = bilstm_train_forward(xs, w, u, b)
        need_dx = layer == "lstm2"  # lstm1's input takes no gradient
        times = {
            "bilstm_train": (cuda_ms(lambda: bilstm_train_forward(xs, w, u, b), 5),
                             cuda_ms(lambda: bilstm_train_reference(xs, w, u, b), 5)),
            "bilstm_train_backward": (
                cuda_ms(lambda: bilstm_train_backward(xs, w, u, b, h_out, c_out, dh,
                                                      need_dx=need_dx), 5),
                cuda_ms(lambda: bilstm_train_backward_reference(xs, w, u, b, h_out, c_out, dh,
                                                                need_dx=need_dx), 5)),
        }
        for name, (k, pl) in times.items():
            print(f"  {name} {layer} B=10000 f32: kernel {k:.4f} ms, plain {pl:.4f} ms")
            ms[name] += k
            plain_ms[name] += pl
        xs, w, u, b, _ = stacked_inputs((CALL_BATCH, 33, feat, 128), dev, feat + 7)
        print(f"  bilstm_train {layer} B={CALL_BATCH} f32: kernel "
              f"{cuda_ms(lambda: bilstm_train_forward(xs, w, u, b)):.4f} ms")
        geometry = (512, 33, feat, 128)
        for p_dtype, x_dtype in PRECOMPUTED_DTYPES:
            if (layer == "lstm1") != (x_dtype == p_dtype):
                continue  # lstm1 takes x in the compute dtype, lstm2 float32 h
            xw, u16 = precomputed_inputs(geometry, dev, p_dtype, x_dtype, feat + 6)
            k = cuda_ms(lambda: bilstm_recurrence(xw, u16))
            pl = cuda_ms(lambda: bilstm_recurrence_reference(xw, u16))
            print(f"  recurrence {layer} B=512 xw {str(xw.dtype)[6:]} u {str(u16.dtype)[6:]}: "
                  f"kernel {k:.4f} ms, plain {pl:.4f} ms")
            if p_dtype == torch.bfloat16:
                ms["bilstm_precomputed"] += k
                plain_ms["bilstm_precomputed"] += pl
    rs = np.random.RandomState(9)
    p1, p2 = lstm_params(rs, 32, 128, dev), lstm_params(rs, 256, 128, dev)
    x = torch.tensor(rs.randn(512, 33, 32), dtype=torch.float32, device=dev)
    with torch.no_grad():
        ms["bilstm2"] = cuda_ms(lambda: bilstm2(p1, p2, x))
        plain_ms["bilstm2"] = cuda_ms(lambda: bilstm2_reference(p1, p2, x))
    print(f"  bilstm2 B=512 f32: kernel {ms['bilstm2']:.4f} ms, plain {plain_ms['bilstm2']:.4f} ms")
    for name, flags in (("streaming pair", {}),
                        ("train pair", {"use_pallas_train_bilstm": True})):
        step_ms, rate = train_step_times(params, dev, "float32", **flags)
        print(f"  train step B=10000 float32, {name}: {step_ms:.2f} ms, {rate:.0f} samples/s "
              f"(host clock, mean of 5 synchronized steps)")


def bilstm2_library_call(params, dev):
    """Phase 9c: bilstm2 as a library user calls it, on the vendored
    checkpoint's two BiLSTM layers and a calling batch, against the model's
    two streaming layers in float32; its count set to 0 just before."""
    from clair_tpu_torch.ops.bilstm2 import bilstm2
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream
    from clair_tpu_torch.pipeline.call_var import _device_input

    layers = [{d: {k: torch.from_numpy(np.array(v)).to(dev) for k, v in p.items()}
               for d, p in params[name].items()} for name in ("lstm1", "lstm2")]
    x = torch.from_numpy(np.random.RandomState(10).randint(0, 40, (512, 33, 8, 4))
                         .astype(np.uint8)).to(dev)
    x = _device_input(x).reshape(512, 33, 32)
    bilstm2.launches = 0
    with torch.inference_mode():
        out = bilstm2(*layers, x)
    launches = bilstm2.launches
    with torch.inference_mode():
        want = bilstm_stream(layers[1], bilstm_stream(layers[0], x))
    err = (out - want).abs().max().item()
    print(f"  bilstm2 on ont_production.ckpt's layers, B=512: launches {launches}, "
          f"max|d| vs the streaming layers {err:.3e}")
    assert launches == 1 and torch.isfinite(out).all() and err <= F32_TOL, (launches, err)
    return launches


def fwd_work(batch, feat, dtype, with_cell=False, stacked=False):
    """(operations, bytes) of one BiLSTM layer's forward: the two products
    of every step (2 * 2B * T * (F + H) * 4H; the gate nonlinearities are
    not counted), and x, W, U, b read once and h (and the float32 c)
    written once. ``stacked``: the train pair's input, both directions
    stacked along the batch (x twice)."""
    e = torch.tensor([], dtype=dtype).element_size()
    rows = batch * T_LEN
    flops = 2 * 2 * rows * (feat + HIDDEN) * 4 * HIDDEN
    weights = 2 * (feat + HIDDEN) * 4 * HIDDEN * e + 2 * 4 * HIDDEN * 4
    out = rows * 2 * HIDDEN * (e + (4 if with_cell else 0))
    return flops, rows * feat * e * (2 if stacked else 1) + weights + out


def bwd_work(batch, feat, dtype, need_dx, stacked=False):
    """(operations, bytes) of one layer's backward: the gates from
    [x | h], dh carried through U, dW and dU, and dx where wanted;
    x, h, c (float32), dh and the weights read once, dx and the float32
    dW, dU, db written once."""
    e = torch.tensor([], dtype=dtype).element_size()
    rows = batch * T_LEN
    depth = (feat + HIDDEN) + HIDDEN + (feat + HIDDEN) + (feat if need_dx else 0)
    flops = 2 * 2 * rows * 4 * HIDDEN * depth
    x = rows * feat * e * (2 if stacked else 1)
    weights = 2 * (feat + HIDDEN) * 4 * HIDDEN * e + 2 * 4 * HIDDEN * 4
    saved = rows * 2 * HIDDEN * (e + 4 + e)           # h, float32 c, dh
    grads = 2 * (feat + HIDDEN + 1) * 4 * HIDDEN * 4
    return flops, x + weights + saved + grads + (x if need_dx else 0)


def bound(works, dtype):
    """(ms, "operations" or "bytes"): the larger of the operations over the
    card's peak for dtype and the bytes over its memory rate, summed over
    the layers' (operations, bytes)."""
    ops_s = sum(f for f, _ in works) / PEAK_FLOPS[dtype]
    bytes_s = sum(b for _, b in works) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def library_lstm(layers, dtype, dev):
    """torch.nn.LSTM (cuDNN) carrying the layers' weights: weight_ih = w.T,
    weight_hh = u.T, bias_ih = b, bias_hh = 0 (ROADMAP Queue 3's oracle)."""
    feat = layers[0]["fw"]["w"].shape[0]
    lstm = torch.nn.LSTM(feat, HIDDEN, num_layers=len(layers), bidirectional=True,
                         batch_first=True).to(dev)
    with torch.no_grad():
        for i, p in enumerate(layers):
            for suffix, d in (("", "fw"), ("_reverse", "bw")):
                getattr(lstm, f"weight_ih_l{i}{suffix}").copy_(p[d]["w"].T)
                getattr(lstm, f"weight_hh_l{i}{suffix}").copy_(p[d]["u"].T)
                getattr(lstm, f"bias_ih_l{i}{suffix}").copy_(p[d]["b"])
                getattr(lstm, f"bias_hh_l{i}{suffix}").zero_()
    lstm = lstm.to(dtype)
    lstm.flatten_parameters()  # one weight buffer, as cuDNN takes it
    return lstm


def backward_ms(lstm, x, dh, iters):
    """Mean device time of lstm's backward alone (CUDA events around
    .backward() after each forward)."""
    total = 0.0
    for i in range(iters + 1):
        out, _ = lstm(x)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out.backward(dh)
        end.record()
        torch.cuda.synchronize()
        if i:  # the first is the warm-up
            total += start.elapsed_time(end)
    return total / iters


def precomputed_library(dev):
    """Row 3's library time: per layer and direction, torch.nn.LSTM with
    input size 4H, weight_ih = I, no bias and weight_hh = U^T, fed that
    direction's xw (T, B, 4H) as the model gives it to the kernel at the
    calling batch in bf16 (lstm1: xw and U bf16; lstm2: xw float32, U the
    bf16 weights widened). It computes the same recurrence, plus a 4H x 4H
    product of xw with the identity. Summed over the four calls."""
    total = 0.0
    for p_dtype, x_dtype in PRECOMPUTED_DTYPES[1:]:
        feat = 32 if x_dtype == torch.bfloat16 else 256
        xw, u = precomputed_inputs((CALL_BATCH, T_LEN, feat, HIDDEN), dev, p_dtype, x_dtype, 16)
        for d in range(2):
            lstm = torch.nn.LSTM(4 * HIDDEN, HIDDEN, bias=False).to(dev)
            with torch.no_grad():
                lstm.weight_ih_l0.copy_(torch.eye(4 * HIDDEN, device=dev))
                lstm.weight_hh_l0.copy_(u[d].float().T)
            lstm = lstm.to(xw.dtype)
            lstm.flatten_parameters()
            seq = xw[d].contiguous()
            with torch.no_grad():
                ms = cuda_ms(lambda: lstm(seq))
            print(f"    torch.nn.LSTM(4H, H, weight_ih = I) on xw {str(xw.dtype)[6:]} direction "
                  f"{d} B={CALL_BATCH}: {ms:.4f} ms")
            total += ms
    return total


def yardsticks(dev):
    """Phase 9d: each kernel's bound_ms at the shapes of its JSON ``ms``
    (rows 1 and 3 the calling path, B = 512, both layers, bf16; row 4 both
    layers fused, B = 512, float32; rows 2, 5 and 6 the training batch,
    B = 10,000, both layers, bf16 for the streaming pair and float32 for
    the train pair, lstm1 without dx), and library_ms, the time of
    torch.nn.LSTM computing the same function on the same shapes (row 3:
    with an identity weight_ih, fed xw; None where it refuses the dtype).
    Prints beside each bound the tensor-core term of the kernel's passes
    (passes x operations / the bf16 peak): the float32 rows run their
    products as six bf16 passes, row 3 its h.U as three (U bf16)."""
    bf16, f32 = torch.bfloat16, torch.float32
    works = {
        "bilstm_stream": ([fwd_work(CALL_BATCH, f, bf16) for _, f in LAYERS], bf16, 1),
        "bilstm_stream_backward": (
            [bwd_work(TRAIN_BATCH, f, bf16, need_dx=f != 32) for _, f in LAYERS], bf16, 1),
        "bilstm_train": ([fwd_work(TRAIN_BATCH, f, f32, with_cell=True, stacked=True)
                          for _, f in LAYERS], f32, 6),
        "bilstm_train_backward": (
            [bwd_work(TRAIN_BATCH, f, f32, need_dx=f != 32, stacked=True) for _, f in LAYERS],
            f32, 6),
        # the recurrence alone on precomputed xw: 2 * 2B * T * H * 4H per
        # layer, xw (lstm1 bf16, lstm2 float32) and U read, float32 h written
        "bilstm_precomputed": (
            [(2 * 2 * CALL_BATCH * T_LEN * HIDDEN * 4 * HIDDEN,
              2 * T_LEN * CALL_BATCH * 4 * HIDDEN * xw_e + 2 * HIDDEN * 4 * HIDDEN * 2
              + CALL_BATCH * T_LEN * 2 * HIDDEN * 4) for xw_e in (2, 4)], bf16, 3),
        # both layers, layer 1's h kept on chip
        "bilstm2": ([(fwd_work(CALL_BATCH, 32, f32)[0] + fwd_work(CALL_BATCH, 256, f32)[0],
                      CALL_BATCH * T_LEN * (32 + 2 * HIDDEN) * 4
                      + sum(2 * (f + HIDDEN) * 4 * HIDDEN * 4 for _, f in LAYERS))], f32, 6),
    }
    bounds = {name: bound(w, dtype) for name, (w, dtype, _) in works.items()}
    pass_ms = {name: passes * sum(f for f, _ in w) / PEAK_FLOPS[bf16] * 1e3
               for name, (w, _, passes) in works.items()}
    library = dict.fromkeys(KERNELS)
    rs = np.random.RandomState(15)
    params = {f: lstm_params(rs, f, HIDDEN, dev) for _, f in LAYERS}

    def each_layer(batch, dtype, run):
        total = 0.0
        for layer, feat in LAYERS:
            lstm = library_lstm([params[feat]], dtype, dev)
            x = torch.tensor(rs.randn(batch, T_LEN, feat), dtype=dtype, device=dev)
            ms = run(lstm, x, feat)
            print(f"    torch.nn.LSTM {layer} B={batch} {str(dtype)[6:]}: {ms:.4f} ms")
            total += ms
        return total

    def inference(lstm, x, feat):
        with torch.no_grad():
            return cuda_ms(lambda: lstm(x))

    def training_forward(lstm, x, feat):
        return cuda_ms(lambda: lstm(x), 5)

    def training_backward(lstm, x, feat):
        x = x.requires_grad_(feat != 32)  # lstm1's input takes no gradient
        dh = torch.tensor(rs.randn(*x.shape[:2], 2 * HIDDEN), dtype=x.dtype, device=dev)
        return backward_ms(lstm, x, dh, 5)

    for name, batch, dtype, run in (("bilstm_stream", CALL_BATCH, bf16, inference),
                                    ("bilstm_stream_backward", TRAIN_BATCH, bf16, training_backward),
                                    ("bilstm_train", TRAIN_BATCH, f32, training_forward),
                                    ("bilstm_train_backward", TRAIN_BATCH, f32, training_backward)):
        try:
            library[name] = each_layer(batch, dtype, run)
        except RuntimeError as refused:  # the yardstick, not the port: record and go on
            print(f"    torch.nn.LSTM refuses {name}'s shapes in {dtype}: {refused}")
    try:
        library["bilstm_precomputed"] = precomputed_library(dev)
    except RuntimeError as refused:  # the yardstick, not the port: record and go on
        print(f"    torch.nn.LSTM refuses bilstm_precomputed's shapes: {refused}")
    two = library_lstm([params[32], params[256]], f32, dev)
    x = torch.tensor(rs.randn(CALL_BATCH, T_LEN, 32), dtype=f32, device=dev)
    library["bilstm2"] = inference(two, x, 32)
    print(f"    torch.nn.LSTM num_layers=2 B={CALL_BATCH} float32: {library['bilstm2']:.4f} ms")
    # the streaming forward's float32 calling layers too, for the table
    each_layer(CALL_BATCH, f32, inference)
    for name in KERNELS:
        ms, by = bounds[name]
        lib = "none" if library[name] is None else f"{library[name]:.4f} ms"
        print(f"  {name}: bound {ms:.4f} ms ({by}), {works[name][2]}-pass tensor-core term "
              f"{pass_ms[name]:.4f} ms, library {lib}")
    return bounds, library


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
    max_err.update(check_train_pair(dev))
    phase("3b train pair vs plain", t)

    t = time.perf_counter()
    max_err["bilstm_precomputed"] = check_precomputed(dev)
    phase("3c precomputed forward vs plain", t)

    t = time.perf_counter()
    max_err["bilstm2"] = check_bilstm2(dev)
    phase("3d bilstm2 vs plain", t)

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
    check_train_step(params, TRAIN_PAIR, use_pallas_train_bilstm=True)
    phase("6b full-width train step, use_pallas_train_bilstm", t)

    t = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    # the genome of phases 7 to 8c
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as genome_dir:
        tmp = Path(genome_dir)
        fasta, bam, truth, variants = simulate_genome(tmp)
        print(f"  simulated {GENOME_LENGTH // 1000} kb ONT genome, {len(truth)} planted variants: "
              f"{time.perf_counter() - t:.2f} s")
        runs = {}
        for dtype, flags in (("bfloat16", []), ("float32", ["--dtype", "float32"])):
            rows, launches, wall, sites = call_bam(fasta, bam, str(tmp / f"{dtype}.vcf"), flags)
            recall, precision = score(rows, truth)
            print(f"  call_bam {dtype}: {len(rows)} calls, recall {recall:.4f}, precision "
                  f"{precision:.4f}, kernel launches {launches}, wall {wall:.2f} s; {sites}")
            assert recall >= RECALL_FLOOR and precision >= PRECISION_FLOOR, (recall, precision)
            assert launches["bilstm_stream"] > 0, launches
            runs[dtype] = (rows, launches, wall, sites)
        assert decisions(runs["bfloat16"][0]) == decisions(runs["float32"][0]), \
            "bf16 and f32 decisions differ"
        print("  bfloat16 and float32 decisions (CHROM, POS, REF, ALT, GT) identical")
        phase("7 calling path", t)

        t = time.perf_counter()
        precomputed_runs = {}
        for dtype in ("bfloat16", "float32"):
            rows, launches, wall, sites = call_bam_precomputed(
                fasta, bam, str(tmp / f"precomputed_{dtype}.vcf"), dtype)
            recall, precision = score(rows, truth)
            print(f"  call_bam use_pallas_bilstm {dtype}: {len(rows)} calls, recall "
                  f"{recall:.4f}, precision {precision:.4f}, kernel launches {launches}, "
                  f"wall {wall:.2f} s; {sites}")
            assert recall >= RECALL_FLOOR and precision >= PRECISION_FLOOR, (recall, precision)
            assert launches["bilstm_precomputed"] > 0 and launches["bilstm_stream"] == 0, launches
            precomputed_runs[dtype] = (rows, launches, wall, sites)
        streaming = decisions(runs["float32"][0])
        assert decisions(precomputed_runs["float32"][0]) == streaming, \
            "use_pallas_bilstm f32 decisions differ from the streaming f32 run"
        print("  use_pallas_bilstm float32 decisions identical to the streaming float32 run")
        differ = sorted(set(decisions(precomputed_runs["bfloat16"][0])) ^ set(streaming))
        print(f"  use_pallas_bilstm bfloat16 vs streaming float32: {len(differ)} decisions "
              f"differ {differ}")
        phase("7b calling path, use_pallas_bilstm", t)

        t = time.perf_counter()
        process_pool(fasta, bam, truth, tmp, card)
        phase("7c call_bam_parallel --process_pool", t)

        t = time.perf_counter()
        trains = {}
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as bin_dir:
            bin_fn = Path(bin_dir) / "train.bin"
            write_training_bin(bin_fn)
            for dtype, flags in (("bfloat16", []), ("float32", ["--train_compute_dtype", "float32"])):
                prefix = Path(bin_dir) / f"model_{dtype}"
                report, wall, top, epochs = train(prefix, lambda: run_port(
                    ["train", "--bin_fn", str(bin_fn), "--ochk_prefix", str(prefix),
                     "--maxEpoch", str(TRAIN_EPOCHS), *flags], 600))
                print(f"  train {dtype}: validation loss sums {report['validation_losses']}, "
                      f"training loss sums {report['training_losses']}, best epoch "
                      f"{report['best_epoch']}, kernel launches {report['kernel_launches']}, "
                      f"wall {wall:.2f} s (process start to exit); {top}; {epochs}")
                trains[dtype] = (report, wall)
            phase("8 training path", t)

            t = time.perf_counter()
            prefix = Path(bin_dir) / "model_train_pair"
            report, wall, top, epochs = train(prefix, lambda: run_process(
                ["-c", TRAIN_SCRIPT, str(bin_fn), str(prefix), str(TRAIN_EPOCHS)], 600),
                TRAIN_PAIR)
            print(f"  train_model use_pallas_train_bilstm float32: validation loss sums "
                  f"{report['validation_losses']}, training loss sums "
                  f"{report['training_losses']}, best epoch {report['best_epoch']}, kernel "
                  f"launches {report['kernel_launches']}, wall {wall:.2f} s (process start to "
                  f"exit); {top}; {epochs}")
            trains["float32, use_pallas_train_bilstm"] = (report, wall)
        phase("8b training path, use_pallas_train_bilstm", t)

        t = time.perf_counter()
        (tmp / "chain").mkdir()
        training_data_path(fasta, bam, variants, tmp / "chain", card)
        phase("8c BAM + truth VCF -> bin -> model -> VCF, the port's CLI", t)

    t = time.perf_counter()
    from clair_tpu_torch.models.bilstm import bilstm_with_cell
    from clair_tpu_torch.models.clair import ClairNet
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.ops.bilstm_stream import (
        _forward, _stack_params, _unstacked, bilstm_stream, bilstm_stream_backward,
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
            # the kernel's launch on stacked parameters (the wrapper also
            # stacks and casts them per call, by three torch ops)
            xd, stacked = x.to(dtype), _stack_params(p, dtype)
            k = cuda_ms(lambda: _forward(xd, *stacked, with_cell=False))
            pl = cuda_ms(lambda: bilstm_stream_reference(p, xd))
            wrapped = cuda_ms(lambda: bilstm_stream(p, xd))
            print(f"  forward {layer} B=512 {str(dtype)[6:]}: kernel {k:.4f} ms, plain {pl:.4f} ms, "
                  f"through the wrapper {wrapped:.4f} ms")
            if dtype == torch.bfloat16:
                ms["bilstm_stream"] += k
                plain_ms["bilstm_stream"] += pl
        # the training forward: B = 10,000, the float32 c saved for the backward
        xt = torch.tensor(rs.randn(TRAIN_BATCH, 33, feat), dtype=torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd, stacked = xt.to(dtype), _stack_params(p, dtype)
            k = cuda_ms(lambda: _forward(xd, *stacked, with_cell=True), 5)
            pl = cuda_ms(lambda: bilstm_stream_reference(p, xd), 5)
            print(f"  forward {layer} B={TRAIN_BATCH} {str(dtype)[6:]} (with c): kernel {k:.4f} ms, "
                  f"plain {pl:.4f} ms")
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
        for kernel, flags in (("streaming", {}), ("use_pallas_bilstm", {"use_pallas_bilstm": True})):
            model = ClairNet.from_jax(params, ModelConfig(compute_dtype=dtype, **flags), dev)
            with torch.inference_mode():
                fwd = cuda_ms(lambda: model(_device_input(xu)))
            print(f"  forward B=512 {dtype} {kernel}: {fwd:.4f} ms, {512 / fwd * 1e3:.0f} tensors/s")
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

    t = time.perf_counter()
    print(f"rows 2, 6 and 5 by kernel on {card} (torch.profiler, mean of 5 calls after a "
          f"warm-up):")
    backward_split(dev)
    backward_split(dev, pair=TRAIN_PAIR)
    forward_split(dev)
    phase("9a the backwards' and row 5's split", t)

    t = time.perf_counter()
    new_kernel_times(params, dev, ms, plain_ms)
    phase("9b times of the new kernels", t)

    t = time.perf_counter()
    library_launches = bilstm2_library_call(params, dev)
    phase("9c bilstm2 as a library call", t)

    t = time.perf_counter()
    print(f"bounds and library calls on {card}:")
    bounds, library = yardsticks(dev)
    phase("9d bounds and library calls", t)

    assert "jax" not in sys.modules
    print(f"card: {card}")
    # each kernel's launches in the run of the path that carries it
    launches = {**{k: trains["bfloat16"][0]["kernel_launches"][k] for k in STREAM_PAIR},
                **{k: trains["float32, use_pallas_train_bilstm"][0]["kernel_launches"][k] for k in TRAIN_PAIR},
                "bilstm_precomputed": precomputed_runs["bfloat16"][1]["bilstm_precomputed"],
                "bilstm2": library_launches}
    print(json.dumps({"kernels": [dict(
        KERNELS[k], launches=launches[k], max_abs_err=max_err[k], ms=ms[k],
        plain_ms=plain_ms[k], bound_ms=bounds[k][0], bound_by=bounds[k][1],
        library_ms=library[k]) for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
