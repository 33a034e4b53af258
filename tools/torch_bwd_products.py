"""Row 2's bf16 products one at a time on the card: the gate recompute, the
weight sums and dx of clair_tpu_torch/csrc/bilstm_stream_bwd.cu
(TmaGateProblem, TmaWeightSumProblem and TmaDxProblem, on wgmma fed by TMA,
csrc/wgmma_product.cuh), each against torch and each timed, beside what
bounds it.

    python3 tools/torch_bwd_products.py [--rounds 2] [--iters 20]

1. each product alone (C entry points added to a copy of the source) against
   torch in float32 on the same bf16 operands, at GEOMETRIES (both layers'
   widths, the training batch, a ragged B*T, T = 1 and 2, F = H = 8, and
   H = 8 over more tiles than the card has multiprocessors, so that a
   block's gate tiles follow each other, each of one chunk): the
   gates within 1e-5 of their largest magnitude, the weight sums' chunk
   partials summed within 1e-4 (float32 sums over B*T rows in another
   order), dx within 1e-2 (rounded to bf16); exits non-zero if one is not;
2. the device time (CUDA events, mean of ``--iters`` calls after a warm-up)
   of each product at B = 10,000, T = 33, H = 128 for lstm1 (F = 32) and
   lstm2 (F = 256), beside VARIANTS of the same source (text patches of a
   copy of csrc/), all in turns (the runs, then reversed, ``--rounds``
   times), and the card's fill and copy of a float32 tensor the size of
   the gate buffer (1.35 GB): what device memory gives the gate product's
   stores.

Each variant's library builds with nvcc into build/bwd_products/<name>/,
all started together; ptxas's registers and spills of each product, and
any warning (a serialized wgmma among them), are printed. Prints the card's name and power limit, and a JSON line of the
times last. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from clair_tpu_torch.ops import build  # noqa: E402
from clair_tpu_torch.ops.bilstm_stream import (  # noqa: E402
    _per_dir, _prev, _split_rows, gate_preactivations,
)

OUT = ROOT / "build" / "bwd_products"
GEOMETRIES = ((512, 33, 32, 128), (512, 33, 256, 128), (10000, 33, 256, 128), (13, 33, 256, 128),
              (5, 1, 32, 128), (6, 2, 256, 128), (9, 33, 8, 8), (8, 7, 16, 8), (400, 33, 8, 8))
LAYERS = (("lstm1", 32), ("lstm2", 256))
BATCH, T_LEN, HIDDEN = 10_000, 33, 128
TOL = {"gates": 1e-5, "sums": 1e-4, "dx": 1e-2}

# each product's C entry point, compiled with the source
ENTRIES = """#include "bilstm_stream_bwd.cu"
extern "C" int bwd_gates(const void* x, const void* w, const void* u, const void* b,
                         const void* h_out, void* out, int rows, int t_len, int feat, int hidden,
                         void* stream) {
    return tma_gates(x, w, u, b, h_out, static_cast<float*>(out), rows, t_len, feat, hidden,
                     static_cast<cudaStream_t>(stream));
}
extern "C" int bwd_sums(const void* x, const void* h_out, const void* dg, void* partial, int rows,
                        int t_len, int feat, int hidden, int splits, int rows_per_split,
                        void* stream) {
    return tma_weight_sums(x, h_out, dg, static_cast<float*>(partial), rows, t_len, feat, hidden,
                           splits, rows_per_split, static_cast<cudaStream_t>(stream));
}
extern "C" int bwd_dx(const void* dg, const void* w, void* dx, int rows, int feat, int hidden,
                      void* stream) {
    return tma_dx(dg, w, dx, rows, feat, hidden, static_cast<cudaStream_t>(stream));
}
"""

_TMA_EPILOGUE_START = "    // The warpgroup's 64 x 256 gates plus the bias, 32 gates at a time: into\n"
_TMA_EPILOGUE_END = """                bulk_commit();
            }
        }
    }
"""
_REGISTER_EPILOGUE = """    __device__ void store(int tile, int half, const Acc& acc, unsigned char*) const {
        int dir, m0, n0;
        at(tile, dir, m0, n0);
        const int l = threadIdx.x & 31, gates = 4 * hidden;
        const int row = m0 + half * kWgRows + ((threadIdx.x >> 5) & 3) * 16 + (l >> 2);
        const float* bd = b + dir * gates;
        float* od = out + static_cast<size_t>(dir) * rows * gates;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
            const int g = n0 + 8 * j + 2 * (l & 3);
            if (g >= gates) continue;
            const float2 bias = *reinterpret_cast<const float2*>(bd + g);
#pragma unroll
            for (int h = 0; h < 2; ++h)
                if (row + 8 * h < rows)
                    *reinterpret_cast<float2*>(od + static_cast<size_t>(row + 8 * h) * gates + g) =
                        make_float2(acc.d[4 * j + 2 * h] + bias.x, acc.d[4 * j + 2 * h + 1] + bias.y);
        }
    }
"""
# (old, new) text of csrc/bilstm_stream_bwd.cu; None replaces the span from
# _TMA_EPILOGUE_START to _TMA_EPILOGUE_END
VARIANTS = {
    # the gate product's epilogue as float2 stores from registers (st.global)
    "register stores": [
        ("    const float* b;\n    int rows, t_len, hidden, m_tiles",
         "    const float* b;\n    float* out;\n    int rows, t_len, hidden, m_tiles"),
        ("    p.b = static_cast<const float*>(b);\n",
         "    p.b = static_cast<const float*>(b);\n    p.out = gates_out;\n"),
        (None, _REGISTER_EPILOGUE),
    ],
    # the gate product stores nothing: its loads and products alone
    "no stores": [
        ("    __device__ void store(int tile, int half, const Acc& acc, unsigned char* extra) const {\n",
         "    __device__ void store(int tile, int half, const Acc& acc, unsigned char* extra) const {\n"
         "        if (rows > 0) return;\n"),
    ],
    # no wgmma in the gate product and the weight sums: their loads and
    # stores alone (and the weight sums' db, summed on the CUDA cores)
    "no products": [
        ("        for (int kk = 0; kk < 4; ++kk) wgmma_bf16<kN, 0, 1>(acc.d, k_major_at(a, kk), "
         "mn_major_at(bt, kk));\n", ""),
        ("                wgmma_bf16<kN, 1, 1>(acc.d, mn_major_at(s + (piece * 2 + half) * kBoxBytes, kk),\n"
         "                                     mn_major_at(bt, kk));\n", "                ;\n"),
    ],
}
# the runs of part 2, by library: (library, product)
RUNS = (("this tree", "gates"), ("register stores", "gates"), ("no stores", "gates"),
        ("no products", "gates"), ("this tree", "sums"), ("no products", "sums"),
        ("this tree", "dx"))


def variant_csrc(name: str, patches) -> Path:
    """A copy of csrc/ under OUT/<name>/csrc with ``patches`` applied to
    bilstm_stream_bwd.cu, and the entry points beside it."""
    out = OUT / name.replace(" ", "_") / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    path = out / "bilstm_stream_bwd.cu"
    source = path.read_text()
    for old, new in patches:
        if old is None:
            start = source.index(_TMA_EPILOGUE_START)
            end = source.index(_TMA_EPILOGUE_END, start) + len(_TMA_EPILOGUE_END)
            source = source[:start] + new + source[end:]
        elif source.count(old) != 1:
            raise SystemExit(f"variant {name!r} does not apply: {old[:70]!r}")
        else:
            source = source.replace(old, new)
    path.write_text(source)
    (out / "entries.cu").write_text(ENTRIES)
    return out


def build_all(trees: dict) -> dict:
    """Every tree's library, one nvcc each, all started together;
    {name: ctypes library}. Prints each product's registers and spills."""
    jobs = []
    for name, csrc in trees.items():
        lib = csrc.parent / "libbwd_products.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
               str(csrc / "entries.cu")]
        jobs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True)))
    libs = {}
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, lib, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: did not build:\n{err[-4000:]}")
        function = None
        for line in err.splitlines():
            if "Compiling entry function" in line:
                function = line
            elif "warning" in line:
                print(f"  {name}: {line.strip()}")
            elif function and "wgmma_product" in function and ("spill" in line or "registers" in line):
                problem = function.split("Tma")[1].split("Problem")[0] if "Tma" in function else "?"
                print(f"  {name} {problem}: {line.split(':', 1)[-1].strip()}")
        dll = ctypes.CDLL(str(lib))
        for fn, args in (("bwd_gates", [vp] * 6 + [i] * 4), ("bwd_sums", [vp] * 4 + [i] * 6),
                         ("bwd_dx", [vp] * 3 + [i] * 3)):
            getattr(dll, fn).argtypes = args + [vp]
            getattr(dll, fn).restype = ctypes.c_int
        libs[name] = dll
    return libs


def operands(batch, t_len, feat, hidden, seed):
    """bf16 x, h_out, W, U, float32 b and the dgates as the sweep leaves
    them (2, B*T, 2, 4H) with their float32 value hi + lo."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).cuda()

    x = randn(batch, t_len, feat).bfloat16()
    h_out = randn(batch, t_len, 2 * hidden, scale=0.5).bfloat16()
    w = randn(2, feat, 4 * hidden, scale=feat ** -0.5).bfloat16()
    u = randn(2, hidden, 4 * hidden, scale=hidden ** -0.5).bfloat16()
    b = randn(2, 4 * hidden, scale=0.1)
    dgf = randn(2, batch * t_len, 4 * hidden)
    hi = dgf.bfloat16()
    lo = (dgf - hi.float()).bfloat16()
    return x, h_out, w, u, b, torch.stack([hi, lo], dim=2).contiguous(), hi.float() + lo.float()


class Products:
    """The three entry points of one library on one geometry's operands."""

    def __init__(self, lib, geometry, seed):
        self.lib, (self.batch, self.t_len, self.feat, self.hidden) = lib, geometry
        self.rows = self.batch * self.t_len
        self.x, self.h_out, self.w, self.u, self.b, self.dg, self.dgf = operands(*geometry, seed)
        self.splits, self.per = _split_rows(self.rows)
        gates = 4 * self.hidden
        self.gates = torch.full((2, self.rows, gates), float("nan"), device="cuda")
        self.partial = torch.full((self.splits, 2, self.feat + self.hidden + 1, gates),
                                  float("nan"), device="cuda")
        self.dx = torch.full((self.rows, self.feat), float("nan"), device="cuda",
                             dtype=torch.bfloat16)

    def run(self, product):
        stream = torch.cuda.current_stream().cuda_stream
        if product == "gates":
            err = self.lib.bwd_gates(self.x.data_ptr(), self.w.data_ptr(), self.u.data_ptr(),
                                     self.b.data_ptr(), self.h_out.data_ptr(),
                                     self.gates.data_ptr(), self.rows, self.t_len, self.feat,
                                     self.hidden, stream)
        elif product == "sums":
            err = self.lib.bwd_sums(self.x.data_ptr(), self.h_out.data_ptr(), self.dg.data_ptr(),
                                    self.partial.data_ptr(), self.rows, self.t_len, self.feat,
                                    self.hidden, self.splits, self.per, stream)
        else:
            err = self.lib.bwd_dx(self.dg.data_ptr(), self.w.data_ptr(), self.dx.data_ptr(),
                                  self.rows, self.feat, self.hidden, stream)
        if err != 0:
            raise RuntimeError(f"{product}: CUDA error {err}")

    def errors(self):
        """Each product's max |error| over the reference's max magnitude."""
        def rel(got, want):
            return ((got.double() - want.double()).abs().max() / want.abs().max()).item()

        feat, hidden, rows = self.feat, self.hidden, self.rows
        for product in ("gates", "sums", "dx"):
            self.run(product)
        torch.cuda.synchronize()
        gates = gate_preactivations(self.x, self.w, self.u, self.b, self.h_out)
        sums = self.partial.sum(0)
        xf = self.x.float().reshape(rows, feat)
        h_prev = _prev(_per_dir(self.h_out, hidden)).reshape(2, rows, hidden)
        want = {"dw": torch.einsum("mf,dmg->dfg", xf, self.dgf),
                "du": torch.einsum("dmk,dmg->dkg", h_prev, self.dgf),
                "db": self.dgf.sum(1)}
        got = {"dw": sums[:, :feat], "du": sums[:, feat:feat + hidden], "db": sums[:, feat + hidden]}
        # du at T = 1 is exactly 0 (every h_prev the zero state)
        sums_err = max(rel(got[k], v) if v.any() else float(got[k].abs().max())
                       for k, v in want.items())
        return {"gates": rel(self.gates, gates.reshape(2, rows, 4 * hidden)), "sums": sums_err,
                "dx": rel(self.dx, torch.einsum("dmg,dfg->mf", self.dgf, self.w.float()))}


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    trees = {"this tree": variant_csrc("this tree", [])}
    trees.update({name: variant_csrc(name, patches) for name, patches in VARIANTS.items()})
    libs = build_all(trees)

    failed = []
    for geometry in GEOMETRIES:
        errs = Products(libs["this tree"], geometry, sum(geometry)).errors()
        bad = [k for k, v in errs.items() if not v <= TOL[k]]
        failed += [(geometry, k) for k in bad]
        print(f"  {geometry}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + (f"  WRONG: {bad}" if bad else ""), flush=True)

    big = torch.empty(2 * BATCH * T_LEN * 4 * HIDDEN, device="cuda")
    src = torch.empty_like(big)
    times = {"fill 1.35 GB": [], "copy 1.35 GB": []}
    for _ in range(args.rounds):
        times["fill 1.35 GB"].append(cuda_ms(lambda: big.fill_(1.0), args.iters))
        times["copy 1.35 GB"].append(cuda_ms(lambda: big.copy_(src), args.iters))
    del big, src
    for layer, feat in LAYERS:
        runs = {name: Products(lib, (BATCH, T_LEN, feat, HIDDEN), 1) for name, lib in libs.items()}
        order = [r for r in RUNS if not (layer == "lstm1" and r[1] == "dx")]  # lstm1 takes no dx
        for _ in range(args.rounds):
            for name, product in order + order[::-1]:
                key = f"{layer} {product} ({name})"
                times.setdefault(key, []).append(
                    cuda_ms(lambda: runs[name].run(product), args.iters))
        del runs
    for key, ms in times.items():
        print(f"  {key}: " + ", ".join(f"{v:.4f}" for v in ms) + " ms", flush=True)
    print(f"card: {card}")
    print(json.dumps({"card": card, "ms": times, "wrong": [f"{g} {k}" for g, k in failed]}))
    if failed:
        raise SystemExit(f"{len(failed)} products outside their tolerance")


if __name__ == "__main__":
    main()
