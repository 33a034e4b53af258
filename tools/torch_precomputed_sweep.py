"""The recurrence on precomputed projections (row 3: csrc/bilstm.cu, the
sweep of csrc/lstm_sweep.cuh on the caller's xw) over the sweep's
geometries.

    python3 tools/torch_precomputed_sweep.py [--batches 512,13]

For each batch, each layer's width (F = 32 and 256, H = 128) and each dtype
pair the model gives the kernel (float32; lstm1 under bf16: xw and U bf16;
lstm2 under bf16: xw float32, U bf16), the kernel at every (cluster size,
rows per tile) of the sweep that launches for U's piece count, timed (CUDA
events, mean of 20 after a warm-up) and held against the plain version
(WRONG beyond 1e-4), with the geometry the launcher picks, the clusters
the card holds at once and the clusters launched per direction. Prints the
card's name and power limit; exits non-zero on a WRONG geometry. Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from clair_tpu_torch.ops import bilstm as B  # noqa: E402
from clair_tpu_torch.ops import build  # noqa: E402
from clair_tpu_torch.ops.lstm_sweep import sweep_geometries  # noqa: E402


def launcher(fn, xw, u, cluster, rows, chosen=None):
    """A callable that launches fn (clair_bilstm_recurrence) at a geometry
    (0, 0: the launcher's), and its output."""
    _, t_len, n, gates = xw.shape
    out = torch.empty((2, t_len, n, gates // 4), device=xw.device)

    def launch():
        err = fn(xw.data_ptr(), u.data_ptr(), out.data_ptr(), n, t_len, gates // 4,
                 int(xw.dtype == torch.bfloat16), int(u.dtype == torch.bfloat16), cluster, rows,
                 chosen, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"clair_bilstm_recurrence at ({cluster}, {rows}): CUDA error {err}")
    return launch, out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", default="512,13")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    dev = torch.device("cuda")
    fn = build.entry(B._KERNEL, "clair_bilstm_recurrence", B._ARGTYPES)
    wrong = []
    for batch in (int(v) for v in args.batches.split(",")):
        for layer, feat in cs.LAYERS:
            for p_dtype, x_dtype in cs.PRECOMPUTED_DTYPES:
                xw, u = cs.precomputed_inputs((batch, cs.T_LEN, feat, cs.HIDDEN), dev, p_dtype,
                                              x_dtype, feat + batch)
                want = B.bilstm_recurrence_reference(xw, u)
                chosen = (ctypes.c_int * 4)()
                launch, _ = launcher(fn, xw, u, 0, 0, chosen)
                ms = cs.cuda_ms(launch)
                line = [f"launcher's ({chosen[0]}, {chosen[1]}) {ms:.4f} ms, clusters held "
                        f"{chosen[2]}, launched per direction {chosen[3]}"]
                for cluster, rows in sweep_geometries(cs.HIDDEN, B.u_pieces(u)):
                    launch, got = launcher(fn, xw, u, cluster, rows)
                    try:
                        launch()
                    except RuntimeError:
                        line.append(f"({cluster}, {rows}) does not launch")
                        continue
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    mark = "" if err <= 1e-4 else " WRONG"
                    if mark:
                        wrong.append((batch, feat, str(xw.dtype), str(u.dtype), cluster, rows, err))
                    line.append(f"({cluster}, {rows}) {cs.cuda_ms(launch):.4f}{mark}")
                print(f"row 3 {layer} B={batch} xw {str(xw.dtype)[6:]} u {str(u.dtype)[6:]} "
                      f"(P = {B.u_pieces(u)}) ms by (cluster, rows): " + ", ".join(line),
                      flush=True)
    if wrong:
        raise SystemExit(f"WRONG at {wrong}")


if __name__ == "__main__":
    main()
