"""The resident training forward (row 5: csrc/bilstm_train.cu, its sweep in
csrc/lstm_sweep.cuh) over the sweep's geometries, and its sweep part by
part.

    python3 tools/torch_train_fwd_sweep.py [--batches 512,10000] [--no_ablate]

First the forward of both layers' widths (F = 32 and 256, H = 128) at every
(cluster size, rows per tile) of the sweep that launches, timed (CUDA
events, mean of 5 after a warm-up) and held against the plain version
(WRONG beyond 1e-4), with the geometry the launcher picks. Then the sweep
built in variants that each cut one part of a step out, timed at the
launcher's geometry at each batch: the variants compute wrong results on
purpose, and only the time a part costs (the base minus the variant)
means anything; their sources and libraries go to build/train_fwd_ablate/.
Prints the card's name and power limit; exits non-zero on a WRONG
geometry. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from clair_tpu_torch.ops import bilstm_train as BT  # noqa: E402
from clair_tpu_torch.ops import build  # noqa: E402
from clair_tpu_torch.ops.lstm_sweep import sweep_geometries  # noqa: E402

OUT = ROOT / "build" / "train_fwd_ablate"
CELL = ("c[sl][j][e] = sigmoid_tanh(a_f) * c[sl][j][e] + sigmoid_tanh(a_i) * tanhf(a_g);\n"
        "                        const float h = sigmoid_tanh(a_o) * tanhf(c[sl][j][e]);")
VARIANTS = {
    "base": [],
    "no h.U": [("if (step == 0 || item_of(s0) >= g.items) continue;", "if (true) continue;")],
    "no h exchange": [("for (int peer = 1; peer < g.cluster; ++peer) {",
                       "for (int peer = 1; peer < 1; ++peer) {")],
    "no h_out/c_out": [("if (row < s.batch && unit < hidden) {\n                            const size_t o",
                        "if (false) {\n                            const size_t o")],
    "no xw loads": [("                load_xw(row0, step + 1);\n", "")],
    "sigmoid as 1 / (1 + expf(-v))": [(CELL, CELL.replace("sigmoid_tanh(", "sigmoid("))],
    "no nonlinearities": [(CELL, "c[sl][j][e] = a_f * c[sl][j][e] + a_i * a_g;\n"
                                 "                        const float h = a_o * c[sl][j][e];")],
}


def run_forward(fn, xs, w, u, b, cluster, rows, chosen=None):
    """fn (a build of clair_bilstm_train_fwd) on the stacked inputs at a
    geometry (0, 0: the launcher's); returns a callable that launches it,
    and (h_out, c_out)."""
    t_len, n2, feat = xs.shape
    hidden = u.shape[1]
    h = torch.empty((t_len, n2, hidden), device=xs.device)
    c = torch.empty_like(h)
    xw = torch.empty((t_len, n2, 4 * hidden), device=xs.device)
    scratch = torch.empty(BT._fwd_scratch_bytes(t_len * n2, feat, hidden), dtype=torch.uint8,
                          device=xs.device)

    def launch():
        err = fn(xs.data_ptr(), w.data_ptr(), u.data_ptr(), b.data_ptr(), h.data_ptr(),
                 c.data_ptr(), xw.data_ptr(), scratch.data_ptr(), scratch.numel(), n2 // 2, t_len,
                 feat, hidden, cluster, rows, chosen, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"clair_bilstm_train_fwd at ({cluster}, {rows}): CUDA error {err}")
    return launch, (h, c)


def variant_library(name: str) -> Path:
    """bilstm_train.cu built with lstm_sweep.cuh patched as VARIANTS[name]."""
    d = OUT / name.replace(" ", "_").replace("/", "_")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.CSRC, d)
    header = d / "lstm_sweep.cuh"
    text = header.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"variant {name!r}: the source no longer has {old[:60]!r}")
        text = text.replace(old, new)
    header.write_text(text)
    lib = d / "lib.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(d / "bilstm_train.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"variant {name!r} did not build:\n{proc.stderr[-3000:]}")
    return lib


def entry_of(lib: Path):
    fn = getattr(ctypes.CDLL(str(lib)), "clair_bilstm_train_fwd")
    fn.restype = ctypes.c_int
    fn.argtypes = [*BT._FWD_ARGTYPES, ctypes.c_void_p]
    return fn


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", default="512,10000")
    parser.add_argument("--no_ablate", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    dev = torch.device("cuda")
    batches = [int(v) for v in args.batches.split(",")]
    base = build.entry("bilstm_train", "clair_bilstm_train_fwd", BT._FWD_ARGTYPES)
    wrong, choice = [], {}
    for batch in batches:
        for layer, feat in cs.LAYERS:
            xs, w, u, b, _ = cs.stacked_inputs((batch, cs.T_LEN, feat, cs.HIDDEN), dev, feat)
            want = BT.bilstm_train_reference(xs, w, u, b)
            chosen = (ctypes.c_int * 4)()
            launch, _ = run_forward(base, xs, w, u, b, 0, 0, chosen)
            ms = cs.cuda_ms(launch, 5)
            choice[batch] = (chosen[0], chosen[1])
            line = [f"launcher's ({chosen[0]}, {chosen[1]}) {ms:.4f} ms, clusters held "
                    f"{chosen[2]}, launched per direction {chosen[3]}"]
            for cluster, rows in sweep_geometries(cs.HIDDEN):
                launch, got = run_forward(base, xs, w, u, b, cluster, rows)
                try:
                    launch()
                except RuntimeError:
                    line.append(f"({cluster}, {rows}) does not launch")
                    continue
                torch.cuda.synchronize()
                err = max((g - r).abs().max().item() for g, r in zip(got, want))
                mark = "" if err <= 1e-4 else " WRONG"
                if mark:
                    wrong.append((batch, feat, cluster, rows, err))
                line.append(f"({cluster}, {rows}) {cs.cuda_ms(launch, 5):.4f}{mark}")
            print(f"row 5 {layer} B={batch} ms by (cluster, rows): " + ", ".join(line), flush=True)
    if not args.no_ablate:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            libs = dict(zip(VARIANTS, pool.map(variant_library, VARIANTS)))
        fns = {name: entry_of(lib) for name, lib in libs.items()}
        for batch in batches:
            cluster, rows = choice[batch]
            for layer, feat in cs.LAYERS:
                xs, w, u, b, _ = cs.stacked_inputs((batch, cs.T_LEN, feat, cs.HIDDEN), dev, feat)
                times = {name: cs.cuda_ms(run_forward(fn, xs, w, u, b, cluster, rows)[0], 5)
                         for name, fn in fns.items()}
                print(f"row 5 {layer} B={batch} at ({cluster}, {rows}), ms (the forward, all three "
                      f"parts): " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    if wrong:
        raise SystemExit(f"WRONG at {wrong}")


if __name__ == "__main__":
    main()
