"""The streaming BiLSTM, forward and backward: hand-written CUDA kernels for
Hopper.

Port of clair_tpu/ops/pallas_bilstm_stream.py: ``_fwd_kernel`` (through
``_fwd_pallas``, ``_stack_params`` and ``_bilstm_fwd``) is
``csrc/bilstm_stream_fwd.cu``, and ``_bwd_kernel`` (through ``_bwd_pallas``
and ``_bilstm_bwd``) is ``csrc/bilstm_stream_bwd.cu``; each source says what
bounds it and how it is laid out. ``bilstm_stream(params, x)`` is the
drop-in for ``models.bilstm.bilstm``: (B, T, F) -> (B, T, 2H) in x's dtype.

The forward has two modes behind one entry point. bfloat16 runs the
cluster kernel of ``bilstm_stream_fwd.cu`` (W and U in shared memory).
float32 runs three parts, as the resident training forward does: x and W
as three bf16 pieces, xw = x.W + b of every step for both directions at
once on the tensor cores (into a (2, T, B, 4H) buffer that ``_launch``
allocates with the pieces' scratch), and the float32 forward sweep of
``csrc/lstm_sweep.cuh``. The sweep takes F and H in multiples of 8:
``pad_f32`` zero-pads them (exact: a padded unit's gates are 0, so its c
and h stay 0) and the outputs are cut back. ``f32_geometries`` says which
sweep geometries a width takes, and ``check_f32_width`` raises ValueError
before any launch where none fits.

When a gradient is wanted, the layer runs as ``_BiLSTMStream``, a
``torch.autograd.Function`` that pairs the forward (keeping the float32 cell
states) with the backward. The parameters are stacked and cast to the
compute dtype outside it, by differentiable torch ops, so their gradient
flows back through the cast to the float32 masters, as in the JAX package.

A CUDA tensor goes to the kernels, or the wrappers raise. A CPU tensor goes
to the plain versions, ``bilstm_stream_reference`` and
``bilstm_stream_backward_reference``, which are also the kernels' yardsticks
on the card. ``bilstm_stream.launches`` and
``bilstm_stream_backward.launches`` count each call of a kernel's entry
point (the backward's runs four kernels). ``split_bf16_product`` is the
plain version of the backward kernel's split-bf16 tensor-core product, for
the tests; ``forward_geometry`` runs the forward kernel at a given cluster
size and rows per tile, and ``_backward_launch`` the backward at a given
geometry of its sweep, both counting nothing, for the checks of every
geometry. The backward's float32 mode runs the reverse sweep of
``csrc/lstm_bwd_sweep.cuh`` (U's pieces held across a thread-block cluster,
dgates.U^T on the tensor cores); ``check_bwd_sweep_width`` raises
ValueError before any launch where no geometry of it fits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from clair_tpu_torch.models.bilstm import bilstm_with_cell
from clair_tpu_torch.ops.build import entry, launch, on_cuda
from clair_tpu_torch.ops.lstm_sweep import (
    check_bwd_sweep_width, check_sweep_width, sweep_geometries,
)

_FWD_KERNEL = "bilstm_stream_fwd"
_BWD_KERNEL = "bilstm_stream_bwd"
_DTYPES = (torch.float32, torch.bfloat16)
# the largest hidden size (the bf16 backward's FMA sweep above H = 128: one
# thread per hidden unit); the forward takes, in bf16, any size whose
# weights fit a cluster's shared memory, and in float32 any the sweep fits
# (check_f32_width); the float32 backward any its reverse sweep fits
# (check_bwd_sweep_width)
_MAX_HIDDEN = 1024
# the bf16 backward holds U in shared memory up to this H, and above it
# reads U transposed from L2 (csrc/bilstm_stream_bwd.cu: launch_bf16_sweep)
_BF16_SHARED_U = 128
# the backward's weight sums: rows per chunk of the split reduction, and
# the most chunks (their float32 partials are summed by the caller)
_SPLIT_ROWS = 2048
_MAX_SPLITS = 32
_ROW_TILE = 128  # the backward's products: the grid's second axis counts 128-row tiles
_MAX_GRID_Y = 65535
# the bf16 pieces the backward kernel cuts a float32 operand of a product
# into (csrc/bilstm_stream_bwd.cu, "Numerics"), by the compute dtype: 2 for
# the dgates in bf16 mode, 3 for every float32 operand in float32 mode
KERNEL_PIECES = {torch.bfloat16: 2, torch.float32: 3}
# the bf16 forward kernel's cluster sizes and rows per tile
# (csrc/bilstm_stream_fwd.cu: kMaxCluster, kItemRows up to 64); float32's
# are the sweep's (f32_geometries)
FWD_CLUSTERS = (1, 2, 4, 8)
FWD_ROWS = (16, 32, 48, 64)
_CUDA_ERROR_INVALID_VALUE = 1  # the forward's answer to a geometry that does not fit


def bilstm_stream_reference(params: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: (h_out (B, T, 2H) in
    x.dtype, c_out (B, T, 2H) float32), the same math and layout."""
    return bilstm_with_cell(params, x)


def bf16_pieces(v: torch.Tensor, pieces: int) -> List[torch.Tensor]:
    """v as ``pieces`` bf16 values (held in float32), each the rounding of
    what the earlier ones leave: |v - sum| <= 2**(-8 * pieces) |v|."""
    out, rest = [], v.float()
    for _ in range(pieces):
        piece = rest.to(torch.bfloat16).float()
        out.append(piece)
        rest = rest - piece
    return out


def split_bf16_product(equation: str, a: torch.Tensor, b: torch.Tensor, pieces: int):
    """Plain version of the backward kernel's tensor-core product
    (csrc/bilstm_stream_bwd.cu, "Numerics"): ``torch.einsum(equation, a, b)``
    with a and b cut into ``pieces`` bf16 pieces each and the piece pairs
    (i, j) with i + j < pieces summed in float32 (the product of two bf16
    values is exact in float32), in the kernels' order: the pair (0, 0)
    apart from the smaller pairs, which sum in the order the kernels issue
    them, and the two sums added last (csrc/mma_product.cuh, "Numerics").
    A bf16 operand's later pieces are 0, so it goes as it is. For the
    tests; no kernel path calls it."""
    high, low = None, None
    for i, ai in enumerate(bf16_pieces(a, pieces)):
        for j, bj in enumerate(bf16_pieces(b, pieces)):
            if i + j < pieces:
                term = torch.einsum(equation, ai, bj)
                if i + j == 0:
                    high = term
                else:
                    low = term if low is None else low + term
    return high if low is None else high + low


def _per_dir(t: torch.Tensor, hidden: int) -> torch.Tensor:
    # (B, T, 2H) -> (2, B, T, H), direction first, original time index
    batch, t_len = t.shape[:2]
    return t.float().reshape(batch, t_len, 2, hidden).permute(2, 0, 1, 3)


def _prev(t: torch.Tensor) -> torch.Tensor:
    # direction 0's previous step is t-1, direction 1's is t+1 (it runs
    # backward in time); zero state beyond the sequence edge
    zero = torch.zeros_like(t[:, :, :1])
    return torch.stack([torch.cat([zero[0], t[0, :, :-1]], dim=1),
                        torch.cat([t[1, :, 1:], zero[1]], dim=1)])


def gate_preactivations(x, w, u, b, h_out, product=torch.einsum) -> torch.Tensor:
    """Every step's gate pre-activations at once, (2, B, T, 4H) float32:
    x_t.W + h_prev.U + b per direction, h_prev the saved h_out shifted by
    one step (direction 1 the other way), zero at the sequence edge. They
    do not depend on the backward's carry; the kernel computes them before
    its sweep."""
    h_prev = _prev(_per_dir(h_out, u.shape[1]))
    return (product("btf,dfg->dbtg", x.float(), w.float())
            + product("dbtk,dkg->dbtg", h_prev, u.float()) + b.float()[:, None, None, :])


def bilstm_stream_backward_reference(x, w, u, b, h_out, c_out, dh_out, *, need_dx=True,
                                     emulate_kernel=False):
    """Plain PyTorch version of the backward kernel: the reverse sweep of
    both directions, a loop over t with ``bmm`` for the carried product.

    Takes the stacked parameters (w (2, F, 4H), u (2, H, 4H) in x.dtype,
    b (2, 4H) float32), the forward's h_out (in x.dtype) and c_out (float32),
    and dh_out (B, T, 2H) in x.dtype. Returns (dx (B, T, F) in x.dtype or
    None, dw, du, db) with the parameter gradients float32, stacked per
    direction. Gates, dh, dc and the sums run in float32 from the
    input-type values, as in the kernel. ``emulate_kernel``: every product
    runs as the kernel's split-bf16 product (``split_bf16_product`` with
    ``KERNEL_PIECES[x.dtype]``), the carry dgates.U^T too: three-piece
    dgates against three-piece U in float32 (the cluster sweep), two-piece
    dgates against bf16 U in bf16 (H <= 128: U in shared memory)."""
    batch, t_len, _ = x.shape
    hidden = u.shape[1]
    xf, wf, uf = x.float(), w.float(), u.float()
    product = torch.einsum
    if emulate_kernel:
        product = functools.partial(split_bf16_product, pieces=KERNEL_PIECES[x.dtype])

    c, dh_out = _per_dir(c_out, hidden), _per_dir(dh_out, hidden)
    h_prev, c_prev = _prev(_per_dir(h_out, hidden)), _prev(c)
    gates = gate_preactivations(x, w, u, b, h_out, product)
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    tanh_c = torch.tanh(c)

    dgates = torch.empty_like(gates)
    dh_carry = torch.zeros((2, batch, hidden), dtype=torch.float32, device=x.device)
    dc_carry = torch.zeros_like(dh_carry)
    u_t = uf.transpose(1, 2)
    for step in range(t_len):
        # direction 0 sweeps t = T-1 .. 0, direction 1 sweeps t = 0 .. T-1
        ts = (t_len - 1 - step, step)

        def at(t: torch.Tensor) -> torch.Tensor:
            return torch.stack([t[0, :, ts[0]], t[1, :, ts[1]]])

        i_t, f_t, g_t, o_t, th = at(i), at(f), at(g), at(o), at(tanh_c)
        dh = at(dh_out) + dh_carry
        dc = dc_carry + dh * o_t * (1.0 - th * th)
        dg = torch.cat([dc * g_t * i_t * (1.0 - i_t),
                        dc * at(c_prev) * f_t * (1.0 - f_t),
                        dc * i_t * (1.0 - g_t * g_t),
                        dh * th * o_t * (1.0 - o_t)], dim=-1)
        dgates[0, :, ts[0]] = dg[0]
        dgates[1, :, ts[1]] = dg[1]
        dh_carry = product("dbg,dgj->dbj", dg, u_t) if emulate_kernel else torch.bmm(dg, u_t)
        dc_carry = dc * f_t

    dw = product("btf,dbtg->dfg", xf, dgates)
    du = product("dbtk,dbtg->dkg", h_prev, dgates)
    db = dgates.sum(dim=(1, 2))
    dx = product("dbtg,dfg->btf", dgates, wf).to(x.dtype) if need_dx else None
    return dx, dw, du, db


def _stack_params(params: Dict, dtype: torch.dtype):
    """Both directions' parameters as the kernels take them: w (2, F, 4H)
    and u (2, H, 4H) in the compute dtype, b (2, 4H) float32. Differentiable
    torch ops, so a gradient reaches the parameters through the cast."""
    w = torch.stack([params["fw"]["w"], params["bw"]["w"]]).to(dtype).contiguous()
    u = torch.stack([params["fw"]["u"], params["bw"]["u"]]).to(dtype).contiguous()
    b = torch.stack([params["fw"]["b"], params["bw"]["b"]]).to(torch.float32).contiguous()
    return w, u, b


def _unstacked(w, u, b) -> Dict:
    return {d: {"w": w[i], "u": u[i], "b": b[i]} for i, d in enumerate(("fw", "bw"))}


_FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 5
_FWD_GEOMETRY_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                          + [ctypes.c_void_p])
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 9


def _check(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor, b: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"bilstm_stream takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"x must be a non-empty (B, T, F) tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    feat, hidden = x.shape[2], u.shape[1]
    if not 1 <= hidden <= _MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} outside 1..{_MAX_HIDDEN}")
    want = {"w": (2, feat, 4 * hidden), "u": (2, hidden, 4 * hidden), "b": (2, 4 * hidden)}
    for name, t in (("w", w), ("u", u), ("b", b)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want[name]}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def f32_widths(feat: int, hidden: int) -> Tuple[int, int]:
    """(F, H) as the float32 forward runs them: each zero-padded to a
    multiple of 8 (its product and sweep move 16-byte chunks of bf16
    pieces)."""
    return -(-feat // 8) * 8, -(-hidden // 8) * 8


def f32_geometries(feat: int, hidden: int) -> List[Tuple[int, int]]:
    """Every (cluster, rows) of the sweep whose CTA fits the float32
    forward at (F, H): the sweep's geometries at the padded H, U in three
    pieces. F takes no shared memory there."""
    return sweep_geometries(f32_widths(feat, hidden)[1])


def check_f32_width(rows: int, feat: int, hidden: int) -> None:
    """Raise ValueError where the float32 forward cannot take the widths:
    no sweep geometry fits the padded H, or the B*T ``rows`` exceed the
    product's grid."""
    check_sweep_width(f32_widths(feat, hidden)[1])
    if -(-rows // _ROW_TILE) > _MAX_GRID_Y:
        raise ValueError(f"B*T = {rows} rows exceed the float32 forward product's grid")


def pad_f32(x, w, u, b):
    """The stacked operands zero-padded to ``f32_widths``: x (B, T, F'),
    w (2, F', 4H'), u (2, H', 4H'), b (2, 4H'), each gate's block padded to
    H' units (the operands themselves where no padding is needed). Exact:
    a padded unit's columns of W and U and its bias are 0, so its gates are
    0, its c stays 0 (f * 0 + i * tanh(0)) and its h 0; padded rows of W
    and U meet zero features of x and zero units of h."""
    feat, hidden = x.shape[2], u.shape[1]
    fp, hp = f32_widths(feat, hidden)
    if (fp, hp) == (feat, hidden):
        return x, w, u, b
    pad = torch.nn.functional.pad
    return (pad(x, (0, fp - feat)),
            pad(w.reshape(2, feat, 4, hidden), (0, hp - hidden, 0, 0, 0, fp - feat))
            .reshape(2, fp, 4 * hp),
            pad(u.reshape(2, hidden, 4, hidden), (0, hp - hidden, 0, 0, 0, hp - hidden))
            .reshape(2, hp, 4 * hp),
            pad(b.reshape(2, 4, hidden), (0, hp - hidden)).reshape(2, 4 * hp))


def unpad(t: torch.Tensor, hidden: int) -> torch.Tensor:
    """A (B, T, 2H') output cut back to (B, T, 2H): each direction's first
    H units."""
    batch, t_len, width = t.shape
    if width == 2 * hidden:
        return t
    return t.reshape(batch, t_len, 2, width // 2)[..., :hidden].reshape(batch, t_len, 2 * hidden)


def _f32_scratch_bytes(rows: int, feat: int, hidden: int) -> int:
    """The float32 forward's scratch: three bf16 pieces of x (B*T, F) and
    W (2F, 4H)."""
    return 2 * 3 * (rows * feat + 2 * feat * 4 * hidden)


def _launch(x, w, u, b, *, with_cell: bool, cluster: int = 0, rows: int = 0, chosen=None):
    """The forward kernel on the card, on checked stacked inputs:
    (h_out, c_out or None). With ``cluster`` and ``rows`` 0 and ``chosen``
    None, ``clair_bilstm_stream_fwd`` at the kernel's choice of geometry,
    raising on any CUDA error; else ``clair_bilstm_stream_fwd_geometry`` at
    that geometry (0: chosen; ``chosen`` a ctypes int array of 4, or None),
    giving None where the geometry does not fit. float32 pads the widths
    (``pad_f32``) and allocates xw and the pieces' scratch. Counts no
    launch."""
    batch, t_len, feat = x.shape
    hidden = u.shape[1]
    f32 = x.dtype == torch.float32
    xw = scratch = None
    if f32:
        check_f32_width(batch * t_len, feat, hidden)
        x, w, u, b = pad_f32(x, w, u, b)
        feat = x.shape[2]
    width = u.shape[1]
    h_out = torch.empty((batch, t_len, 2 * width), dtype=x.dtype, device=x.device)
    c_out = (torch.empty((batch, t_len, 2 * width), dtype=torch.float32, device=x.device)
             if with_cell else None)
    if f32:
        xw = torch.empty((2, t_len, batch, 4 * width), dtype=torch.float32, device=x.device)
        scratch = torch.empty(_f32_scratch_bytes(batch * t_len, feat, width), dtype=torch.uint8,
                              device=x.device)
    args = (x.data_ptr(), w.data_ptr(), u.data_ptr(), b.data_ptr(), h_out.data_ptr(),
            None if c_out is None else c_out.data_ptr(), None if xw is None else xw.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel(), batch, t_len, feat, width, int(not f32))
    if cluster or rows or chosen is not None:
        fn = entry(_FWD_KERNEL, "clair_bilstm_stream_fwd_geometry", _FWD_GEOMETRY_ARGTYPES)
        with torch.cuda.device(x.device):
            err = fn(*args, cluster, rows, chosen, torch.cuda.current_stream().cuda_stream)
        if err == _CUDA_ERROR_INVALID_VALUE:
            return None
        if err != 0:
            raise RuntimeError(f"{_FWD_KERNEL} at cluster {cluster}, rows {rows}: "
                               f"CUDA error {err}")
    else:
        launch(_FWD_KERNEL, "clair_bilstm_stream_fwd", _FWD_ARGTYPES, x.device, *args)
    return unpad(h_out, hidden), None if c_out is None else unpad(c_out, hidden)


def _forward(x, w, u, b, with_cell: bool):
    """The forward on stacked parameters: (h_out, c_out or None)."""
    if not on_cuda(x, "bilstm_stream"):
        h_out, c_out = bilstm_stream_reference(_unstacked(w, u, b), x)
        return h_out, (c_out if with_cell else None)
    _check(x, w, u, b)
    out = _launch(x, w, u, b, with_cell=with_cell)
    bilstm_stream.launches += 1
    return out


def forward_geometry(x, w, u, b, cluster: int, rows: int, chosen=None):
    """The forward kernel on stacked parameters at a given cluster size and
    rows per tile (``clair_bilstm_stream_fwd_geometry``; 0: the kernel's
    choice, reported through ``chosen``, a ctypes array of 4 ints, when
    given), with the cell states: (h_out, c_out), or None where that
    geometry does not fit (its CTA exceeds shared memory or its warp items
    the warps). bf16 takes ``FWD_CLUSTERS`` x ``FWD_ROWS``, float32 the
    sweep's ``f32_geometries``. Any other CUDA error raises, and a float32
    width that no geometry fits raises ValueError. Counts no launch: it
    serves the checks of every geometry, not a path."""
    _check(x, w, u, b)
    return _launch(x, w, u, b, with_cell=True, cluster=cluster, rows=rows, chosen=chosen)


def _split_rows(rows: int) -> Tuple[int, int]:
    """(chunks, rows per chunk) of the weight-sum reduction over B*T rows."""
    splits = max(1, min(_MAX_SPLITS, -(-rows // _SPLIT_ROWS)))
    per = -(-rows // splits)
    return -(-rows // per), per


def _scratch_bytes(rows: int, feat: int, hidden: int) -> int:
    """The float32 backward's scratch: three bf16 pieces of x (B*T, F),
    h_out (B*T, 2H), W (2F, 4H), U (2H, 4H) and the dgates (2*B*T, 4H)."""
    gates = 4 * hidden
    return 2 * 3 * (rows * feat + rows * 2 * hidden + 2 * feat * gates + 2 * hidden * gates
                    + 2 * rows * gates)


def _backward_launch(x, w, u, b, h_out, c_out, dh_out, *, need_dx=True, cluster=0, rows=0):
    """The backward kernel on the card, on checked inputs: (dx in x.dtype
    or None, dw, du, db float32), the weight sums' chunks summed here in a
    fixed order. The sweep's geometry (0: the kernel's choice): float32 the
    reverse sweep at ``cluster`` CTAs and ``rows`` rows a tile; bf16
    ``rows`` rows a block (16 or 32 with U in shared memory, 4 or 8 above H
    = 128). Raises ValueError before any launch where the kernel cannot take
    the widths, and RuntimeError on any CUDA error, a given geometry that
    does not fit or launch included. Counts no launch:
    ``bilstm_stream_backward`` counts its own calls, and the checks of every
    geometry count none."""
    batch, t_len, feat = x.shape
    hidden = u.shape[1]
    if feat % 8 or hidden % 8:
        # the products stage 16-byte chunks of [x | h] rows
        raise ValueError(f"the backward kernel takes F and H in multiples of 8, not "
                         f"F = {feat}, H = {hidden}")
    if x.dtype == torch.float32:
        check_bwd_sweep_width(hidden)
    n_rows = batch * t_len
    if -(-n_rows // _ROW_TILE) > _MAX_GRID_Y:
        raise ValueError(f"B*T = {n_rows} rows exceed the backward products' grid")
    # the kernels read 16-byte chunks: an unaligned view is copied
    x, w, u, h_out, c_out, dh_out = (t if t.data_ptr() % 16 == 0 else t.clone()
                                     for t in (x, w, u, h_out, c_out, dh_out))
    splits, rows_per_split = _split_rows(n_rows)
    # the bf16 FMA sweep (H > 128) reads U transposed, coalesced (a layout
    # copy of 2*H*4H values, not a product)
    u_t = (u.transpose(1, 2).contiguous()
           if x.dtype == torch.bfloat16 and hidden > _BF16_SHARED_U else None)
    # the gates; in bf16 the sweep overwrites each row in place with its
    # dgates' two bf16 pieces after reading it
    dgates = torch.empty((2, batch, t_len, 4 * hidden), dtype=torch.float32, device=x.device)
    # float32: the three bf16 pieces of x, h_out, W, U and the dgates
    scratch = (torch.empty(_scratch_bytes(n_rows, feat, hidden), dtype=torch.uint8,
                           device=x.device)
               if x.dtype == torch.float32 else None)
    partial = torch.empty((splits, 2, feat + hidden + 1, 4 * hidden),
                          dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    fn = entry(_BWD_KERNEL, "clair_bilstm_stream_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), u.data_ptr(),
                 None if u_t is None else u_t.data_ptr(), b.data_ptr(),
                 h_out.data_ptr(), c_out.data_ptr(), dh_out.data_ptr(),
                 dgates.data_ptr(), partial.data_ptr(), None if dx is None else dx.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 0 if scratch is None else scratch.numel(),
                 batch, t_len, feat, hidden, splits, rows_per_split, cluster, rows,
                 int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_BWD_KERNEL} (clair_bilstm_stream_bwd) launch failed at sweep "
                           f"(cluster, rows) = ({cluster}, {rows}): CUDA error {err}")
    # the per-direction sum of the chunks' partials, in a fixed order (the
    # JAX caller sums its per-tile partials outside the kernel the same way)
    sums = partial.sum(dim=0)
    return dx, sums[:, :feat], sums[:, feat:feat + hidden], sums[:, feat + hidden]


def bilstm_stream_backward(x, w, u, b, h_out, c_out, dh_out, *, need_dx=True):
    """The backward of one layer on stacked parameters: (dx in x.dtype or
    None, dw, du, db float32). Same inputs and outputs as
    ``bilstm_stream_backward_reference``; a CUDA tensor runs the kernel."""
    if not on_cuda(x, "bilstm_stream_backward"):
        return bilstm_stream_backward_reference(x, w, u, b, h_out, c_out, dh_out,
                                                need_dx=need_dx)
    _check(x, w, u, b)
    batch, t_len, _ = x.shape
    hidden = u.shape[1]
    out_shape = (batch, t_len, 2 * hidden)
    for name, t, dtype in (("h_out", h_out, x.dtype), ("c_out", c_out, torch.float32),
                           ("dh_out", dh_out, x.dtype)):
        if tuple(t.shape) != out_shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name} must be a {dtype} {out_shape} tensor on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = _backward_launch(x, w, u, b, h_out, c_out, dh_out, need_dx=need_dx)
    bilstm_stream_backward.launches += 1
    return out


class _BiLSTMStream(torch.autograd.Function):
    """One layer on stacked parameters, the forward and backward kernels
    paired (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, w, u, b):
        h_out, c_out = _forward(x, w, u, b, with_cell=True)
        ctx.save_for_backward(x, w, u, b, h_out, c_out)
        return h_out

    @staticmethod
    def backward(ctx, dh_out):
        x, w, u, b, h_out, c_out = ctx.saved_tensors
        # the incoming gradient in the compute dtype, as the JAX backward
        # casts it (pallas_bilstm_stream.py:317)
        dx, dw, du, db = bilstm_stream_backward(
            x, w, u, b, h_out, c_out, dh_out.to(x.dtype).contiguous(),
            need_dx=ctx.needs_input_grad[0])
        return dx, dw.to(w.dtype), du.to(u.dtype), db


def bilstm_stream(params: Dict, x: torch.Tensor, *, with_cell: bool = False):
    """Bidirectional LSTM layer over a (B, T, F) batch -> (B, T, 2H) in
    x.dtype. Differentiable in x and the parameters (through the kernel
    pair) when grad mode is on and one of them requires a gradient. With
    ``with_cell``, the forward alone, also giving the float32 cell states
    (B, T, 2H); that form has no gradient, so it raises, on either device,
    when one is wanted."""
    w, u, b = _stack_params(params, x.dtype)
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w, u, b))
    if wants_grad and with_cell:
        raise ValueError("bilstm_stream(with_cell=True) has no gradient: call it under "
                         "torch.no_grad(), or without with_cell to train")
    if wants_grad:
        return _BiLSTMStream.apply(x, w, u, b)
    h_out, c_out = _forward(x, w, u, b, with_cell)
    return (h_out, c_out) if with_cell else h_out


bilstm_stream.launches = 0
bilstm_stream_backward.launches = 0
