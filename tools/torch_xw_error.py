"""The float32 x.W product that rows 1 (float32 mode) and 5 run ahead of
their sweeps, against float64, and what each tree's product costs.

    python3 tools/torch_xw_error.py --parent DIR [--variants] [--rounds 3]

For each tree (this checkout, the unpacked checkout at ``--parent``, and
with ``--variants`` the two changes of the product's accumulation in
VARIANTS applied to the parent's ``csrc/mma_product.cuh``), at lstm2's shape
(B = 10,000, T = 33, F = 256, H = 128) and lstm1's (F = 32), on the inputs
chip_smoke.py's phase 3 gives those shapes:

1. the xw buffer each forward writes (row 1 float32: (2, T, B, 4H); row 5:
   (T, 2B, 4H)) against x.W + b in float64: max |error|, its share of
   max |xw|, the mean |error| and the mean error signed along x.W (near
   -mean |error| where the sums are cut toward zero, near 0 where they
   round to nearest); torch.matmul in float32 beside it as a yardstick;
2. h and c against the plain version on the card (the criterion of
   chip_smoke.py's phases 3 and 3b), and the kernel's and the plain
   version's h and c against the recurrence in float64 on x.W + b in
   float64; beside them row 3's sweep (the same sweep as row 1's float32
   mode) on that xw rounded to float32, the sweep's own share;
3. the backwards that share the product (rows 2 and 6 in float32, row 2 in
   bf16): two runs bit for bit, and every tree's outputs against the
   parent's bit for bit;
4. the device time (CUDA events, mean of ``--iters`` calls after a warm-up)
   of rows 1 float32 (both layers, with c), 2 float32 and 6 (both layers,
   dx for lstm2) and 5 (both layers) at B = 10,000, tree by tree in turns
   (the trees, then reversed, ``--rounds`` times) on one card.

Each tree's kernels build with nvcc into build/xw_error/<tree>/, one process
a source, all started together; ptxas's registers and spills of each
product are printed. Prints the card's name and power limit. Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from clair_tpu_torch.ops.bilstm import bilstm_recurrence  # noqa: E402
from clair_tpu_torch.ops import bilstm_stream as stream  # noqa: E402
from clair_tpu_torch.ops import bilstm_train as train  # noqa: E402
from clair_tpu_torch.ops import build  # noqa: E402

OUT = ROOT / "build" / "xw_error"
KERNELS = ("bilstm_stream_fwd", "bilstm_stream_bwd", "bilstm_train", "bilstm")
LAYERS = (("lstm1", 32), ("lstm2", 256))
T_LEN, HIDDEN = 33, 128

# Two changes of mma_product's accumulation for the problems with three
# pieces an operand (float32 operands), as (old, new) text of the parent's
# mma_product.cuh; the bf16 mode's problems (at most three pieces in all)
# keep their code. Measured, not landed (PERF.md, Findings): each brings the
# kernels' h nearer float64 than the plain version's, neither within 1e-6
# of the plain version, and (b) costs rows 2 and 6 in float32 4.7-7.5% on
# an H100.
# (a) the small piece pairs (i + j >= 1) summed in a second accumulator,
#     added to the (0, 0) pair's at the end;
LOW_APART = [
    ("    float db = 0.0f;\n",
     "    float db = 0.0f;\n"
     "    constexpr bool kLowApart = P::kPA == 3 || P::kPB == 3;\n"
     "    float low[kLowApart ? kMT : 1][kLowApart ? kNT : 1][4];\n"
     "#pragma unroll\n"
     "    for (int i = 0; i < (kLowApart ? kMT : 1); ++i)\n"
     "#pragma unroll\n"
     "        for (int j = 0; j < (kLowApart ? kNT : 1); ++j)\n"
     "#pragma unroll\n"
     "            for (int e = 0; e < 4; ++e) low[i][j][e] = 0.0f;\n"),
    ("                        for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], af[mt], "
     "bfr[j][nt]);\n",
     "                        for (int nt = 0; nt < kNT; ++nt) {\n"
     "                            if constexpr (kLowApart) {\n"
     "                                if (i + j > 0) {\n"
     "                                    mma_bf16(low[mt][nt], af[mt], bfr[j][nt]);\n"
     "                                    continue;\n"
     "                                }\n"
     "                            }\n"
     "                            mma_bf16(acc[mt][nt], af[mt], bfr[j][nt]);\n"
     "                        }\n"),
    ("    cp_async_wait<0>();  // no copy outlives the block\n",
     "    if constexpr (kLowApart) {\n"
     "#pragma unroll\n"
     "        for (int mt = 0; mt < kMT; ++mt)\n"
     "#pragma unroll\n"
     "            for (int nt = 0; nt < kNT; ++nt)\n"
     "#pragma unroll\n"
     "                for (int e = 0; e < 4; ++e) acc[mt][nt][e] += low[mt][nt][e];\n"
     "    }\n"
     "    cp_async_wait<0>();  // no copy outlives the block\n"),
]
# (b) promotion: each 16-deep k-step's passes of an m16 tile into a zeroed
#     fragment, the smallest pairs first and the (0, 0) pair last, then added
#     to the float32 sums with ordinary adds.
_OLD_PASSES = """#pragma unroll
            for (int i = 0; i < P::kPA; ++i) {
                unsigned af[kMT][4];
                a_fragments<P::kAK, LA::kPitch>(a_s + i * LA::kElems, wm, kk, af);
#pragma unroll
                for (int j = 0; j < P::kPB; ++j) {
                    if (i + j >= kPasses) continue;  // the pairs below 2^-24 of the product
#pragma unroll
                    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                        for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[j][nt]);
                }
            }
"""
PROMOTED = [
    ("// The A fragments of this warp's four m16 tiles",
     """template <bool KMajor, int P>
__device__ __forceinline__ void a_fragment(const bf16* tile, int m, int kk, unsigned (&f)[4]) {
    const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
    if constexpr (KMajor)
        ldmatrix_x4(f, tile + (m + r + (q & 1) * 8) * P + kk + (q >> 1) * 8);
    else
        ldmatrix_x4_trans(f, tile + (kk + r + (q >> 1) * 8) * P + m + (q & 1) * 8);
}

// The A fragments of this warp's four m16 tiles"""),
    ("    constexpr int kPasses = P::kPA > P::kPB ? P::kPA : P::kPB;  // piece pairs i + j below this\n",
     "    constexpr int kPasses = P::kPA > P::kPB ? P::kPA : P::kPB;  // piece pairs i + j below this\n"
     "    constexpr bool kPromote = P::kPA == 3 || P::kPB == 3;\n"),
    (_OLD_PASSES,
     """            if constexpr (kPromote) {
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt) {
                    unsigned af[P::kPA][4];
#pragma unroll
                    for (int i = 0; i < P::kPA; ++i)
                        a_fragment<P::kAK, LA::kPitch>(a_s + i * LA::kElems, wm + mt * 16, kk, af[i]);
                    float part[kNT][4];
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) part[nt][e] = 0.0f;
#pragma unroll
                    for (int level = kPasses - 1; level >= 0; --level)
#pragma unroll
                        for (int i = 0; i < P::kPA; ++i) {
                            const int j = level - i;
                            if (j < 0 || j >= P::kPB) continue;
#pragma unroll
                            for (int nt = 0; nt < kNT; ++nt) mma_bf16(part[nt], af[i], bfr[j][nt]);
                        }
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[nt][e];
                }
            } else {
""" + _OLD_PASSES + "            }\n"),
]
VARIANTS = {"low pairs apart": LOW_APART, "promoted": PROMOTED}


def tree_csrc(name: str, csrc: Path, patches) -> Path:
    """A copy of ``csrc`` with ``patches`` applied to mma_product.cuh, under
    OUT/<name>/csrc."""
    out = OUT / name.replace(" ", "_") / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    source = (out / "mma_product.cuh").read_text()
    for old, new in patches:
        if source.count(old) != 1:
            raise SystemExit(f"variant {name!r} does not apply: {old[:60]!r}")
        source = source.replace(old, new)
    (out / "mma_product.cuh").write_text(source)
    return out


def use_tree(csrc: Path, name: str) -> None:
    """Point the port's loader at ``csrc``'s libraries (already built)."""
    build.CSRC, build.BUILD_DIR = csrc, OUT / name.replace(" ", "_") / "lib"
    build._LOADED.clear()
    build._ENTRIES.clear()


def build_trees(trees: dict) -> None:
    """Every tree's libraries, one nvcc a source, all started together;
    prints each product instantiation's registers and spills."""
    jobs = []
    for name, csrc in trees.items():
        use_tree(csrc, name)
        for kernel in KERNELS:
            lib = build.library_path(kernel)
            lib.parent.mkdir(parents=True, exist_ok=True)
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                   str(csrc / f"{kernel}.cu")]
            jobs.append((name, kernel, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.PIPE, text=True)))
    for name, kernel, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: {kernel} did not build:\n{err[-4000:]}")
        function = None
        for line in err.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)",
                          line)
            if m:
                function = m.group(1)
            if function and "mma_product" in function:
                problem = re.search(r"(?<=\d)[A-Z][A-Za-z]*Problem(?:ILi\dELi\dE)?", function)
                label = problem.group(0) if problem else function[:40]
                if "spill" in line or "registers" in line:
                    print(f"  {name} {kernel} {label}: {line.split(':', 1)[-1].strip()}")


def forward_inputs(batch: int, feat: int, dev):
    """chip_smoke.py phase 3's inputs at (batch, 33, feat, 128): stacked
    float32 w, u, b and x."""
    rs = np.random.RandomState(batch + feat + HIDDEN)
    params = cs.lstm_params(rs, feat, HIDDEN, dev)
    x = torch.tensor(rs.randn(batch, T_LEN, feat), dtype=torch.float32, device=dev)
    return params, x


def row1_xw(x, w, u, b):
    """Row 1's float32 forward at the kernel's geometry, keeping its xw
    buffer: (h, c, xw (2, T, B, 4H)). F and H are multiples of 8 here."""
    batch, t_len, feat = x.shape
    width = u.shape[1]
    h = torch.empty((batch, t_len, 2 * width), dtype=torch.float32, device=x.device)
    c = torch.empty_like(h)
    xw = torch.empty((2, t_len, batch, 4 * width), dtype=torch.float32, device=x.device)
    scratch = torch.empty(stream._f32_scratch_bytes(batch * t_len, feat, width),
                          dtype=torch.uint8, device=x.device)
    build.launch(stream._FWD_KERNEL, "clair_bilstm_stream_fwd", stream._FWD_ARGTYPES, x.device,
                 x.data_ptr(), w.data_ptr(), u.data_ptr(), b.data_ptr(), h.data_ptr(),
                 c.data_ptr(), xw.data_ptr(), scratch.data_ptr(), scratch.numel(), batch, t_len,
                 feat, width, 0)
    return h, c, xw


def row5_xw(xs, w, u, b):
    """Row 5's forward at the kernel's geometry, keeping its xw buffer:
    (h, c, xw (T, 2B, 4H))."""
    t_len, n2, feat = xs.shape
    hidden = u.shape[1]
    h = torch.empty((t_len, n2, hidden), dtype=torch.float32, device=xs.device)
    c = torch.empty_like(h)
    xw = torch.empty((t_len, n2, 4 * hidden), dtype=torch.float32, device=xs.device)
    scratch = torch.empty(train._fwd_scratch_bytes(t_len * n2, feat, hidden), dtype=torch.uint8,
                          device=xs.device)
    build.launch(train._KERNEL, "clair_bilstm_train_fwd", train._FWD_ARGTYPES, xs.device,
                 xs.data_ptr(), w.data_ptr(), u.data_ptr(), b.data_ptr(), h.data_ptr(),
                 c.data_ptr(), xw.data_ptr(), scratch.data_ptr(), scratch.numel(), n2 // 2, t_len,
                 feat, hidden, 0, 0, None)
    return h, c, xw


def xw_error(got, acc64, b64):
    """(max |got - (acc64 + b64)|, that over max |xw|, mean |error|, mean
    error signed along x.W: -mean |error| where every sum is cut toward
    zero, about 0 where they round to nearest)."""
    want = acc64 + b64
    err = got.double() - want
    worst = err.abs().max().item()
    return (worst, worst / want.abs().max().item(), err.abs().mean().item(),
            (err * torch.sign(acc64)).mean().item())


def h64_reference(acc64, b64, u):
    """The recurrence in float64 on x.W (float64, (2, T, B, 4H)) + b and
    u (2, H, 4H): (h, c), each (2, T, B, H) in step order."""
    xw = acc64 + b64
    u64 = u.double()
    h = torch.zeros(xw.shape[0], xw.shape[2], u.shape[1], dtype=torch.float64, device=xw.device)
    c = torch.zeros_like(h)
    hs, cs = [], []
    for t in range(xw.shape[1]):
        i, f, g, o = (xw[:, t] + torch.bmm(h, u64)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


def row1_layout(t: torch.Tensor) -> torch.Tensor:
    """(2, T, B, H) in step order -> row 1's (B, T, 2H), direction 1 at
    its original time index."""
    return torch.cat([t[0].transpose(0, 1), t[1].transpose(0, 1).flip(1)], dim=-1)


def max_diff(a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


def row1_reference(x, w, b):
    """x.W (float64) in row 1's xw layout (2, T, B, 4H), direction 1 at
    T-1-t, and b broadcast to it."""
    xt = x.double().transpose(0, 1)
    acc = torch.stack([xt @ w[0].double(), xt.flip(0) @ w[1].double()])
    return acc, b.double()[:, None, None, :]


def check_errors(trees, dev) -> dict:
    """Steps 1-3 for every tree; returns the backwards' outputs by tree."""
    outputs = {}
    for name, csrc in trees.items():
        use_tree(csrc, name)
        print(f"tree {name}:")
        outs = {}
        for layer, feat in LAYERS:
            params, x = forward_inputs(10_000, feat, dev)
            w, u, b = stream._stack_params(params, torch.float32)
            h, c, xw = row1_xw(x, w, u, b)
            acc64, b64 = row1_reference(x, w, b)
            mm = torch.stack([x.transpose(0, 1) @ w[0], x.flip(1).transpose(0, 1) @ w[1]])
            want_h, want_c = stream.bilstm_stream_reference(params, x)
            h64, c64 = h64_reference(acc64, b64, u)
            sweep_h = bilstm_recurrence((acc64 + b64).float(), u)
            torch.cuda.synchronize()
            e = xw_error(xw, acc64, b64)
            e_mm = xw_error(mm + b[:, None, None, :], acc64, b64)
            print(f"  row 1 f32 {layer} B=10000: xw max|err| {e[0]:.3e} ({e[1]:.3e} of max|xw|),"
                  f" mean|err| {e[2]:.3e}, mean signed {e[3]:+.3e}; torch.matmul f32 max|err| "
                  f"{e_mm[0]:.3e}, mean|err| {e_mm[2]:.3e}, mean signed {e_mm[3]:+.3e}")
            print(f"    h, c vs plain {max_diff(h, want_h):.3e} {max_diff(c, want_c):.3e}; vs "
                  f"float64: kernel {max_diff(h, row1_layout(h64)):.3e} "
                  f"{max_diff(c, row1_layout(c64)):.3e}, plain {max_diff(want_h, row1_layout(h64)):.3e}"
                  f" {max_diff(want_c, row1_layout(c64)):.3e}, row 3's sweep on the float64 xw "
                  f"rounded to float32 {max_diff(sweep_h, h64):.3e}")
            del h64, c64, sweep_h
            del xw, acc64, mm
            xs, w5, u5, b5, dh = cs.stacked_inputs((10_000, T_LEN, feat, HIDDEN), dev, feat + 5)
            h5, c5, xw5 = row5_xw(xs, w5, u5, b5)
            batch = xs.shape[1] // 2
            acc5 = torch.einsum("tdbf,dfg->tdbg", xs.double().reshape(T_LEN, 2, batch, feat),
                                w5.double()).reshape(T_LEN, 2 * batch, -1)
            b5_64 = b5.double().repeat_interleave(batch, 0)[None]
            want_h5, want_c5 = train.bilstm_train_reference(xs, w5, u5, b5)
            h64, c64 = (t.permute(1, 0, 2, 3).reshape(T_LEN, 2 * batch, HIDDEN) for t in
                        h64_reference(acc5.reshape(T_LEN, 2, batch, -1).permute(1, 0, 2, 3),
                                      b5.double()[:, None, None, :], u5))
            torch.cuda.synchronize()
            e5 = xw_error(xw5, acc5, b5_64)
            print(f"  row 5 {layer} B=10000: xw max|err| {e5[0]:.3e} ({e5[1]:.3e} of max|xw|), "
                  f"mean|err| {e5[2]:.3e}, mean signed {e5[3]:+.3e}")
            print(f"    h, c vs plain {max_diff(h5, want_h5):.3e} {max_diff(c5, want_c5):.3e}; vs "
                  f"float64: kernel {max_diff(h5, h64):.3e} {max_diff(c5, c64):.3e}, plain "
                  f"{max_diff(want_h5, h64):.3e} {max_diff(want_c5, c64):.3e}")
            del h64, c64
            del xw5, acc5
            need_dx = feat != 32
            runs = [train.bilstm_train_backward(xs, w5, u5, b5, h5, c5, dh, need_dx=need_dx)
                    for _ in range(2)]
            want6 = train.bilstm_train_backward_reference(xs, w5, u5, b5, h5, c5, dh,
                                                          need_dx=need_dx)
            outs[f"row 6 {layer}"] = runs[0]
            print(f"  row 6 {layer}: {summary(runs, want6)}")
            rs = np.random.RandomState(feat + 3)
            dh2 = torch.tensor(rs.randn(10_000, T_LEN, 2 * HIDDEN), dtype=torch.float32,
                               device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                w2, u2, b2 = stream._stack_params(params, dtype)
                xd, dhd = x.to(dtype), dh2.to(dtype)
                h2, c2 = stream._launch(xd, w2, u2, b2, with_cell=True)
                runs = [stream.bilstm_stream_backward(xd, w2, u2, b2, h2, c2, dhd, need_dx=need_dx)
                        for _ in range(2)]
                want2 = stream.bilstm_stream_backward_reference(xd, w2, u2, b2, h2, c2, dhd,
                                                                need_dx=need_dx)
                outs[f"row 2 {str(dtype)[6:]} {layer}"] = runs[0]
                print(f"  row 2 {str(dtype)[6:]} {layer}: {summary(runs, want2)}")
        outputs[name] = {k: [None if t is None else t.cpu() for t in v] for k, v in outs.items()}
        torch.cuda.empty_cache()
    first = next(iter(outputs))
    for name, outs in outputs.items():
        if name == first:
            continue
        same = [k for k, v in outs.items()
                if all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(v, outputs[first][k]))]
        print(f"{name} bit for bit equal to {first}: {same}")
    return outputs


def summary(runs, want) -> str:
    """Two backward runs bit for bit, and each gradient's max |error| over
    the plain version's max |value|."""
    same = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(*runs))
    parts = []
    for label, got, ref in zip(("dx", "dw", "du", "db"), runs[0], want):
        if got is None:
            continue
        parts.append(f"{label} {(got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item():.3e}")
    return f"{'bit-identical' if same else 'DIFFERENT'} over two runs; " + ", ".join(parts)


def time_trees(trees, dev, rounds: int, iters: int) -> None:
    """Step 4: each row's ms in every tree, in turns."""
    inputs = {}
    for layer, feat in LAYERS:
        params, x = forward_inputs(10_000, feat, dev)
        rs = np.random.RandomState(feat + 3)
        dh2 = torch.tensor(rs.randn(10_000, T_LEN, 2 * HIDDEN), dtype=torch.float32, device=dev)
        inputs[layer] = (x, stream._stack_params(params, torch.float32), dh2,
                         cs.stacked_inputs((10_000, T_LEN, feat, HIDDEN), dev, feat + 5), feat != 32)

    def rows_ms() -> dict:
        ms = {"row 1 f32": 0.0, "row 2 f32": 0.0, "row 5": 0.0, "row 6": 0.0}
        for x, (w, u, b), dh2, (xs, w5, u5, b5, dh), need_dx in inputs.values():
            ms["row 1 f32"] += cs.cuda_ms(lambda: stream._launch(x, w, u, b, with_cell=True), iters)
            h, c = stream._launch(x, w, u, b, with_cell=True)
            ms["row 2 f32"] += cs.cuda_ms(lambda: stream.bilstm_stream_backward(
                x, w, u, b, h, c, dh2, need_dx=need_dx), iters)
            ms["row 5"] += cs.cuda_ms(lambda: train._forward_launch(xs, w5, u5, b5), iters)
            h5, c5 = train._forward_launch(xs, w5, u5, b5)
            ms["row 6"] += cs.cuda_ms(lambda: train.bilstm_train_backward(
                xs, w5, u5, b5, h5, c5, dh, need_dx=need_dx), iters)
        return ms

    order = list(trees) + list(reversed(trees))
    times = {name: [] for name in trees}
    for _ in range(rounds):
        for name in order:
            use_tree(trees[name], name)
            times[name].append(rows_ms())
    for name, runs in times.items():
        cells = []
        for row in runs[0]:
            values = [r[row] for r in runs]
            cells.append(f"{row} median {float(np.median(values)):.4f} "
                         f"({', '.join(f'{v:.4f}' for v in values)})")
        print(f"ms {name} (B=10000, both layers): " + "; ".join(cells))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True,
                        help="an unpacked checkout whose clair_tpu_torch/csrc is the yardstick")
    parser.add_argument("--variants", action="store_true",
                        help="also the parent's csrc with each change of VARIANTS")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    this_tree, parent = build.CSRC, Path(args.parent).resolve() / "clair_tpu_torch" / "csrc"
    trees = {"parent": tree_csrc("parent", parent, [])}

    def digest(d: Path) -> str:
        return hashlib.sha256(b"".join(p.read_bytes() for p in sorted(d.iterdir()))).hexdigest()

    if digest(this_tree) != digest(trees["parent"]):
        trees["this tree"] = tree_csrc("this tree", this_tree, [])
    if args.variants:
        for name, patches in VARIANTS.items():
            trees[name] = tree_csrc(name, parent, patches)
    build_trees(trees)
    dev = torch.device("cuda")
    check_errors(trees, dev)
    time_trees(trees, dev, args.rounds, args.iters)
    print(f"card: {card}")


if __name__ == "__main__":
    sys.exit(main())
