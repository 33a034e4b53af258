"""The streaming BiLSTM, forward and backward: hand-written CUDA kernels for
Hopper.

Port of clair_tpu/ops/pallas_bilstm_stream.py: ``_fwd_kernel`` (through
``_fwd_pallas``, ``_stack_params`` and ``_bilstm_fwd``) is
``csrc/bilstm_stream_fwd.cu``, and ``_bwd_kernel`` (through ``_bwd_pallas``
and ``_bilstm_bwd``) is ``csrc/bilstm_stream_bwd.cu``; each source says what
bounds it and how it is laid out. ``bilstm_stream(params, x)`` is the
drop-in for ``models.bilstm.bilstm``: (B, T, F) -> (B, T, 2H) in x's dtype.

When a gradient is wanted, the layer runs as ``_BiLSTMStream``, a
``torch.autograd.Function`` that pairs the forward (keeping the float32 cell
states) with the backward. The parameters are stacked and cast to the
compute dtype outside it, by differentiable torch ops, so their gradient
flows back through the cast to the float32 masters, as in the JAX package.

A CUDA tensor goes to the kernels, or the wrappers raise. A CPU tensor goes
to the plain versions, ``bilstm_stream_reference`` and
``bilstm_stream_backward_reference``, which are also the kernels' yardsticks
on the card. ``bilstm_stream.launches`` and
``bilstm_stream_backward.launches`` count each kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from clair_tpu_torch.models.bilstm import bilstm_with_cell
from clair_tpu_torch.ops.build import launch, on_cuda

_FWD_KERNEL = "bilstm_stream_fwd"
_BWD_KERNEL = "bilstm_stream_bwd"
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HIDDEN = 1024  # one thread per hidden unit, one block per row tile
# the backward's weight sums: rows per chunk of the split reduction, and
# the most chunks (their float32 partials are summed by the caller)
_SPLIT_ROWS = 2048
_MAX_SPLITS = 32
_DX_TILE = 128  # dx kernel: the grid's second axis counts 128-row tiles
_MAX_GRID_Y = 65535


def bilstm_stream_reference(params: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: (h_out (B, T, 2H) in
    x.dtype, c_out (B, T, 2H) float32), the same math and layout."""
    return bilstm_with_cell(params, x)


def bilstm_stream_backward_reference(x, w, u, b, h_out, c_out, dh_out, *, need_dx=True):
    """Plain PyTorch version of the backward kernel: the reverse sweep of
    both directions, a loop over t with ``bmm`` for the carried product.

    Takes the stacked parameters (w (2, F, 4H), u (2, H, 4H) in x.dtype,
    b (2, 4H) float32), the forward's h_out (in x.dtype) and c_out (float32),
    and dh_out (B, T, 2H) in x.dtype. Returns (dx (B, T, F) in x.dtype or
    None, dw, du, db) with the parameter gradients float32, stacked per
    direction. Gates, dh, dc and the sums run in float32 from the
    input-type values, as in the kernel."""
    batch, t_len, _ = x.shape
    hidden = u.shape[1]
    xf, wf, uf = x.float(), w.float(), u.float()

    def per_dir(t: torch.Tensor) -> torch.Tensor:
        # (B, T, 2H) -> (2, B, T, H), direction first, original time index
        return t.float().reshape(batch, t_len, 2, hidden).permute(2, 0, 1, 3)

    h, c, dh_out = per_dir(h_out), per_dir(c_out), per_dir(dh_out)

    def prev(t: torch.Tensor) -> torch.Tensor:
        # direction 0's previous step is t-1, direction 1's is t+1 (it runs
        # backward in time); zero state beyond the sequence edge
        zero = torch.zeros_like(t[:, :, :1])
        return torch.stack([torch.cat([zero[0], t[0, :, :-1]], dim=1),
                            torch.cat([t[1, :, 1:], zero[1]], dim=1)])

    h_prev, c_prev = prev(h), prev(c)
    # every step's gates at once: they do not depend on the carry
    gates = (torch.einsum("btf,dfg->dbtg", xf, wf)
             + torch.einsum("dbtk,dkg->dbtg", h_prev, uf) + b.float()[:, None, None, :])
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
        dh_carry = torch.bmm(dg, u_t)
        dc_carry = dc * f_t

    dw = torch.einsum("btf,dbtg->dfg", xf, dgates)
    du = torch.einsum("dbtk,dbtg->dkg", h_prev, dgates)
    db = dgates.sum(dim=(1, 2))
    dx = torch.einsum("dbtg,dfg->btf", dgates, wf).to(x.dtype) if need_dx else None
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


_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7


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


def _forward(x, w, u, b, with_cell: bool):
    """The forward on stacked parameters: (h_out, c_out or None)."""
    if not on_cuda(x, "bilstm_stream"):
        h_out, c_out = bilstm_stream_reference(_unstacked(w, u, b), x)
        return h_out, (c_out if with_cell else None)
    _check(x, w, u, b)
    batch, t_len, feat = x.shape
    hidden = u.shape[1]
    h_out = torch.empty((batch, t_len, 2 * hidden), dtype=x.dtype, device=x.device)
    c_out: Optional[torch.Tensor] = (
        torch.empty((batch, t_len, 2 * hidden), dtype=torch.float32, device=x.device)
        if with_cell else None
    )
    launch(_FWD_KERNEL, "clair_bilstm_stream_fwd", _FWD_ARGTYPES, x.device,
           x.data_ptr(), w.data_ptr(), u.data_ptr(), b.data_ptr(),
           h_out.data_ptr(), c_out.data_ptr() if with_cell else None,
           batch, t_len, feat, hidden, int(x.dtype == torch.bfloat16))
    bilstm_stream.launches += 1
    return h_out, c_out


def _split_rows(rows: int) -> Tuple[int, int]:
    """(chunks, rows per chunk) of the weight-sum reduction over B*T rows."""
    splits = max(1, min(_MAX_SPLITS, -(-rows // _SPLIT_ROWS)))
    per = -(-rows // splits)
    return -(-rows // per), per


def bilstm_stream_backward(x, w, u, b, h_out, c_out, dh_out, *, need_dx=True):
    """The backward of one layer on stacked parameters: (dx in x.dtype or
    None, dw, du, db float32). Same inputs and outputs as
    ``bilstm_stream_backward_reference``; a CUDA tensor runs the kernel."""
    if not on_cuda(x, "bilstm_stream_backward"):
        return bilstm_stream_backward_reference(x, w, u, b, h_out, c_out, dh_out,
                                                need_dx=need_dx)
    _check(x, w, u, b)
    batch, t_len, feat = x.shape
    hidden = u.shape[1]
    out_shape = (batch, t_len, 2 * hidden)
    for name, t, dtype in (("h_out", h_out, x.dtype), ("c_out", c_out, torch.float32),
                           ("dh_out", dh_out, x.dtype)):
        if tuple(t.shape) != out_shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name} must be a {dtype} {out_shape} tensor on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hidden % 2:
        raise ValueError(f"the backward kernel takes an even hidden size, not {hidden}")
    rows = batch * t_len
    if -(-rows // _DX_TILE) > _MAX_GRID_Y:
        raise ValueError(f"B*T = {rows} rows exceed the dx kernel's grid")
    splits, rows_per_split = _split_rows(rows)
    # U transposed, so the sweep's dh carry reads it coalesced (a layout
    # copy of 2*H*4H values, not a product)
    u_t = u.transpose(1, 2).contiguous()
    dgates = torch.empty((2, batch, t_len, 4 * hidden), dtype=torch.float32, device=x.device)
    partial = torch.empty((splits, 2, feat + hidden + 1, 4 * hidden),
                          dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    launch(_BWD_KERNEL, "clair_bilstm_stream_bwd", _BWD_ARGTYPES, x.device,
           x.data_ptr(), w.data_ptr(), u.data_ptr(), u_t.data_ptr(), b.data_ptr(),
           h_out.data_ptr(), c_out.data_ptr(), dh_out.data_ptr(),
           dgates.data_ptr(), partial.data_ptr(), dx.data_ptr() if need_dx else None,
           batch, t_len, feat, hidden, splits, rows_per_split,
           int(x.dtype == torch.bfloat16))
    bilstm_stream_backward.launches += 1
    # the per-direction sum of the chunks' partials, in a fixed order (the
    # JAX caller sums its per-tile partials outside the kernel the same way)
    sums = partial.sum(dim=0)
    return dx, sums[:, :feat], sums[:, feat:feat + hidden], sums[:, feat + hidden]


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
