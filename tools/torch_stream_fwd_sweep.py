"""The port's streaming BiLSTM forward (clair_tpu_torch/csrc/
bilstm_stream_fwd.cu) on the card: its compiler report, a check against the
plain PyTorch version, and its time over cluster sizes and rows per tile.

    python3 tools/torch_stream_fwd_sweep.py [--batches 512,10000] [--parent DIR]

For each layer width of ``ModelConfig()`` (lstm1: F = 32, lstm2: F = 256;
H = 128, T = 33), batch and dtype, it prints the time (CUDA events, mean
after a warm-up) of the geometry the wrapper chooses (h alone) and of every
(cluster, rows) that fits (with c), each checked against the plain version
first: bf16 over
its cluster kernel's geometries, float32 over the sweep's
(``f32_geometries``; its times include the x.W product before the sweep
and the wrapper's allocation of xw and the pieces' scratch). With
``--parent DIR`` (an unpacked checkout of another commit), the same layers
are also timed there, before and after this tree's, in one process each,
so two versions are compared on one card. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LAYERS = (("lstm1", 32), ("lstm2", 256))
F32_TOL, BF16_TOL = 1e-4, 2e-2

# run in a checkout of another commit: the same layers through its wrapper
PARENT_SCRIPT = """
import json, sys, numpy as np, torch
from clair_tpu_torch.ops.bilstm_stream import bilstm_stream
out = {}
for batch in json.loads(sys.argv[1]):
    for layer, feat in (("lstm1", 32), ("lstm2", 256)):
        rs = np.random.RandomState(feat)
        p = {d: {k: torch.tensor(rs.randn(*s) * sc, dtype=torch.float32, device="cuda")
                 for k, s, sc in (("w", (feat, 512), 128 ** -0.5), ("u", (128, 512), 128 ** -0.5),
                                  ("b", (512,), 0.1))} for d in ("fw", "bw")}
        x = torch.tensor(rs.randn(batch, 33, feat), dtype=torch.float32, device="cuda")
        for dtype in ("float32", "bfloat16"):
            xd = x.to(getattr(torch, dtype))
            fn = lambda: bilstm_stream(p, xd)
            fn(); torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            iters = 20 if batch <= 512 else 5
            s.record()
            for _ in range(iters):
                fn()
            e.record(); torch.cuda.synchronize()
            out[f"{layer} B={batch} {dtype}"] = s.elapsed_time(e) / iters
print(json.dumps(out))
"""


def cuda_ms(fn, iters) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def layer_inputs(feat, batch, dev):
    rs = np.random.RandomState(feat)
    p = {d: {k: torch.tensor(rs.randn(*s) * sc, dtype=torch.float32, device=dev)
             for k, s, sc in (("w", (feat, 512), 128 ** -0.5), ("u", (128, 512), 128 ** -0.5),
                              ("b", (512,), 0.1))} for d in ("fw", "bw")}
    x = torch.tensor(rs.randn(batch, 33, feat), dtype=torch.float32, device=dev)
    return p, x


def run_parent(parent: Path, batches):
    proc = subprocess.run([sys.executable, "-c", PARENT_SCRIPT, json.dumps(batches)],
                          cwd=parent, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-3000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", default="512,10000")
    parser.add_argument("--parent", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    batches = [int(b) for b in args.batches.split(",")]
    from clair_tpu_torch.ops import build
    from clair_tpu_torch.ops.bilstm_stream import (
        FWD_CLUSTERS, FWD_ROWS, _stack_params, bilstm_stream, bilstm_stream_reference,
        f32_geometries, forward_geometry,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.build("bilstm_stream_fwd")
    print(build.BUILD_REPORTS.get("bilstm_stream_fwd", "built before this run"))
    parent_before = run_parent(Path(args.parent), batches) if args.parent else None

    dev = torch.device("cuda")
    bf16_geometries = [(c, r) for c in FWD_CLUSTERS for r in FWD_ROWS]
    results = {}
    wrong = []
    for batch in batches:
        iters = 20 if batch <= 512 else 5
        for layer, feat in LAYERS:
            p, x = layer_inputs(feat, batch, dev)
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                w, u, b = _stack_params(p, dtype)
                h_p, c_p = bilstm_stream_reference(p, xd)
                tag = f"{layer} B={batch} {str(dtype)[6:]}"
                auto = cuda_ms(lambda: bilstm_stream(p, xd), iters)
                results[tag] = auto
                chosen = (ctypes.c_int * 4)()
                assert forward_geometry(xd, w, u, b, 0, 0, chosen) is not None
                print(f"{tag}: wrapper {auto:.4f} ms (cluster {chosen[0]}, rows {chosen[1]}; "
                      f"{chosen[2]} clusters resident, {chosen[3]} launched per direction)")
                geometries = (f32_geometries(feat, 128) if dtype == torch.float32
                              else bf16_geometries)
                for cluster, rows in geometries:
                    info = (ctypes.c_int * 4)()
                    got = forward_geometry(xd, w, u, b, cluster, rows, info)
                    torch.cuda.synchronize()
                    if got is None:
                        print(f"  cluster {cluster} rows {rows}: does not launch")
                        continue
                    eh = (got[0].float() - h_p.float()).abs().max().item()
                    ec = (got[1] - c_p).abs().max().item()
                    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                    ok = eh <= tol and ec <= tol
                    ms = (cuda_ms(lambda: forward_geometry(xd, w, u, b, cluster, rows), iters)
                          if ok else float("nan"))
                    if not ok:
                        wrong.append((tag, cluster, rows))
                    print(f"  cluster {cluster} rows {rows}: {ms:.4f} ms, max|dh| {eh:.2e} "
                          f"max|dc| {ec:.2e}{'' if ok else '  WRONG'}; {info[2]} resident, "
                          f"{info[3]} per direction")
    if args.parent:
        parent_after = run_parent(Path(args.parent), batches)
        for tag, ms in results.items():
            print(f"{tag}: parent {parent_before[tag]:.4f} / {parent_after[tag]:.4f} ms, "
                  f"this tree {ms:.4f} ms")
    print(json.dumps({"card": card, "wrapper_ms": results}))
    if wrong:
        raise SystemExit(f"WRONG at {len(wrong)} geometries: {wrong}")


if __name__ == "__main__":
    main()
