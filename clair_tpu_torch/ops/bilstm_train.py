"""The resident training BiLSTM, forward and backward, float32: hand-written
CUDA kernels for Hopper (``ModelConfig.use_pallas_train_bilstm``).

Port of clair_tpu/ops/pallas_bilstm_train.py: ``_fwd_kernel`` (through
``_fwd_pallas`` and ``_bilstm_fwd``) and ``_bwd_kernel`` (through
``_bwd_pallas`` and ``_bilstm_bwd``) are the two entry points of
``csrc/bilstm_train.cu``, which says what bounds them and how they are laid
out. ``bilstm_train(params, x)`` is the drop-in for ``models.bilstm.bilstm``:
(B, T, F) -> (B, T, 2H), float32 only.

The layout is the JAX kernels': both directions stacked on the batch axis,
xs (T, 2B, F) with the time-reversed sequence in rows B.., so the backward
sweep runs t = T-1 .. 0 for both, with zero state before t = 0. The
backward is four kernels behind one entry point, built from the streaming
backward's parts (``csrc/mma_product.cuh``): every step's gates in one
tensor-core product, a float32 reverse sweep that carries dh and dc and
writes dgates as bf16 pieces, the weight sums over fixed row chunks, and dx
per direction; every product takes float32 operands as three bf16 pieces
(six passes, float32 sums). This wrapper allocates the gates, the pieces'
scratch and the chunks' partials per call, sums the partials per direction
in a fixed order (as ``_bilstm_bwd`` sums its per-tile partials), and the
autograd backward un-reverses dx and adds the two directions' halves. The
batch is not padded: the kernels mask the ragged edge, so rows past the
batch have no cotangent. On the card F and H must be multiples of 8.

When a gradient is wanted, the layer runs as ``_BiLSTMTrain``, a
``torch.autograd.Function`` that pairs the forward (keeping the cell
states) with the backward; dx is computed only when the input requires a
gradient (not for lstm1). A CUDA tensor goes to the kernels, or the
wrappers raise. A CPU tensor goes to the plain versions,
``bilstm_train_reference`` and ``bilstm_train_backward_reference``, which
are also the kernels' yardsticks on the card; the backward's
``emulate_kernel`` runs the kernel's split-bf16 products on the CPU.
``bilstm_train.launches`` and ``bilstm_train_backward.launches`` count each
call of a kernel's entry point (the backward's runs four kernels).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from clair_tpu_torch.models.bilstm import _gate_update, _stack_directions, _unstack_outputs
from clair_tpu_torch.ops.bilstm_stream import (
    _MAX_GRID_Y, _ROW_TILE, KERNEL_PIECES, _split_rows, split_bf16_product,
)
from clair_tpu_torch.ops.build import launch, on_cuda

_KERNEL = "bilstm_train"
_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 6
_MAX_HIDDEN = 1024  # forward and the backward's sweep: one thread per hidden unit


def bilstm_train_reference(xs, w, u, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel on the stacked layout:
    xs (T, 2B, F), w (2, F, 4H), u (2, H, 4H), b (2, 4H), all float32 ->
    (h_out, c_out), each (T, 2B, H) float32."""
    t_len, n2, feat = xs.shape
    batch, hidden = n2 // 2, u.shape[1]
    # hoisted input projection of both directions: (T, 2, B, 4H)
    xw = torch.einsum("tdbf,dfg->tdbg", xs.reshape(t_len, 2, batch, feat), w) + b[None, :, None]
    h = torch.zeros((2, batch, hidden), dtype=torch.float32, device=xs.device)
    c = torch.zeros_like(h)
    hs, cs = [], []
    for t in range(t_len):
        c, h = _gate_update(xw[t] + torch.bmm(h, u), c, torch.float32)
        hs.append(h)
        cs.append(c)
    return (torch.stack(hs).reshape(t_len, n2, hidden),
            torch.stack(cs).reshape(t_len, n2, hidden))


def bilstm_train_backward_reference(xs, w, u, b, h_out, c_out, dh_out, *, need_dx=True,
                                    emulate_kernel=False):
    """Plain PyTorch version of the backward kernel: the reverse sweep
    t = T-1 .. 0 of both directions on the stacked layout, a loop over t
    with ``bmm`` for the carried product. Takes the forward's inputs and
    outputs and dh_out (T, 2B, H); returns (dx (T, 2B, F) or None, dw
    (2, F, 4H), du (2, H, 4H), db (2, 4H)), all float32. ``emulate_kernel``:
    the gate, weight-sum and dx products run as the kernel's split-bf16
    product (``split_bf16_product``, three pieces an operand); the carry
    stays float32, as in the kernel."""
    t_len, n2, feat = xs.shape
    batch, hidden = n2 // 2, u.shape[1]
    product = torch.einsum
    if emulate_kernel:
        product = functools.partial(split_bf16_product, pieces=KERNEL_PIECES[torch.float32])

    def per_dir(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(t_len, 2, batch, -1)

    x, h, c, dh_out = per_dir(xs), per_dir(h_out), per_dir(c_out), per_dir(dh_out)
    h_prev = torch.cat([torch.zeros_like(h[:1]), h[:-1]])
    c_prev = torch.cat([torch.zeros_like(c[:1]), c[:-1]])
    # every step's gates at once: they do not depend on the carry
    gates = (product("tdbf,dfg->tdbg", x, w) + product("tdbk,dkg->tdbg", h_prev, u)
             + b[None, :, None])
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    tanh_c = torch.tanh(c)

    dgates = torch.empty_like(gates)
    dh_carry = torch.zeros((2, batch, hidden), dtype=torch.float32, device=xs.device)
    dc_carry = torch.zeros_like(dh_carry)
    u_t = u.transpose(1, 2)
    for t in reversed(range(t_len)):
        dh = dh_out[t] + dh_carry
        dc = dc_carry + dh * o[t] * (1.0 - tanh_c[t] * tanh_c[t])
        dgates[t] = torch.cat([dc * g[t] * i[t] * (1.0 - i[t]),
                               dc * c_prev[t] * f[t] * (1.0 - f[t]),
                               dc * i[t] * (1.0 - g[t] * g[t]),
                               dh * tanh_c[t] * o[t] * (1.0 - o[t])], dim=-1)
        dh_carry = torch.bmm(dgates[t], u_t)
        dc_carry = dc * f[t]

    dw = product("tdbf,tdbg->dfg", x, dgates)
    du = product("tdbk,tdbg->dkg", h_prev, dgates)
    db = dgates.sum(dim=(0, 2))
    dx = (product("tdbg,dfg->tdbf", dgates, w).reshape(t_len, n2, feat)
          if need_dx else None)
    return dx, dw, du, db


def _stack_params(params: Dict):
    """Both directions' parameters, float32: w (2, F, 4H), u (2, H, 4H),
    b (2, 4H). Differentiable torch ops."""
    w = torch.stack([params["fw"]["w"], params["bw"]["w"]]).float().contiguous()
    u = torch.stack([params["fw"]["u"], params["bw"]["u"]]).float().contiguous()
    b = torch.stack([params["fw"]["b"], params["bw"]["b"]]).float().contiguous()
    return w, u, b


def _check(xs, w, u, b) -> None:
    for name, t in (("xs", xs), ("w", w), ("u", u), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"bilstm_train takes float32 only; {name} is {t.dtype}")
        if t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xs.dim() != 3 or min(xs.shape) < 1 or xs.shape[1] % 2:
        raise ValueError(f"xs must be a non-empty (T, 2B, F) tensor, got {tuple(xs.shape)}")
    feat, hidden = xs.shape[2], u.shape[1]
    if not 1 <= hidden <= _MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} outside 1..{_MAX_HIDDEN}")
    want = {"w": (2, feat, 4 * hidden), "u": (2, hidden, 4 * hidden), "b": (2, 4 * hidden)}
    for name, t in (("w", w), ("u", u), ("b", b)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want[name]}")


def bilstm_train_forward(xs, w, u, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of one layer on the stacked layout: (h_out, c_out), each
    (T, 2B, H) float32. Same inputs and outputs as
    ``bilstm_train_reference``; a CUDA tensor runs the kernel."""
    if not on_cuda(xs, "bilstm_train"):
        return bilstm_train_reference(xs, w, u, b)
    _check(xs, w, u, b)
    t_len, n2, feat = xs.shape
    hidden = u.shape[1]
    h_out = torch.empty((t_len, n2, hidden), dtype=torch.float32, device=xs.device)
    c_out = torch.empty_like(h_out)
    launch(_KERNEL, "clair_bilstm_train_fwd", _FWD_ARGTYPES, xs.device,
           xs.data_ptr(), w.data_ptr(), u.data_ptr(), b.data_ptr(), h_out.data_ptr(),
           c_out.data_ptr(), n2 // 2, t_len, feat, hidden)
    bilstm_train.launches += 1
    return h_out, c_out


def _scratch_bytes(rows2: int, feat: int, hidden: int) -> int:
    """The backward's scratch: three bf16 pieces of xs (T*2B, F), h_out
    (T*2B, H), W (2F, 4H), U (2H, 4H) and the dgates (T*2B, 4H)."""
    gates = 4 * hidden
    return 2 * 3 * (rows2 * (feat + hidden + gates) + 2 * (feat + hidden) * gates)


def bilstm_train_backward(xs, w, u, b, h_out, c_out, dh_out, *, need_dx=True):
    """The backward of one layer on the stacked layout: (dx (T, 2B, F) or
    None, dw, du, db), float32. Same inputs and outputs as
    ``bilstm_train_backward_reference``; a CUDA tensor runs the kernels,
    whose per-chunk partials are summed here in a fixed order."""
    if not on_cuda(xs, "bilstm_train_backward"):
        return bilstm_train_backward_reference(xs, w, u, b, h_out, c_out, dh_out,
                                               need_dx=need_dx)
    _check(xs, w, u, b)
    t_len, n2, feat = xs.shape
    hidden = u.shape[1]
    for name, t in (("h_out", h_out), ("c_out", c_out), ("dh_out", dh_out)):
        if (tuple(t.shape) != (t_len, n2, hidden) or t.dtype != torch.float32
                or t.device != xs.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {(t_len, n2, hidden)} "
                             f"tensor on {xs.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if feat % 8 or hidden % 8:
        # the products stage 16-byte chunks of [xs | h] rows
        raise ValueError(f"the backward kernel takes F and H in multiples of 8, not "
                         f"F = {feat}, H = {hidden}")
    batch, width, gates = n2 // 2, feat + hidden, 4 * hidden
    rows = batch * t_len  # a direction's rows in the products
    if -(-rows // _ROW_TILE) > _MAX_GRID_Y:
        raise ValueError(f"T*B = {rows} rows exceed the backward products' grid")
    splits, rows_per_split = _split_rows(rows)
    # U transposed, so the sweep's dh carry reads it coalesced (a layout
    # copy of 2*H*4H values, not a product)
    u_t = u.transpose(1, 2).contiguous()
    gate_buf = torch.empty((t_len, n2, gates), dtype=torch.float32, device=xs.device)
    scratch = torch.empty(_scratch_bytes(t_len * n2, feat, hidden), dtype=torch.uint8,
                          device=xs.device)
    partial = torch.empty((splits, 2, width + 1, gates), dtype=torch.float32, device=xs.device)
    dx = torch.empty_like(xs) if need_dx else None
    launch(_KERNEL, "clair_bilstm_train_bwd", _BWD_ARGTYPES, xs.device,
           xs.data_ptr(), w.data_ptr(), u.data_ptr(), u_t.data_ptr(), b.data_ptr(),
           h_out.data_ptr(), c_out.data_ptr(), dh_out.data_ptr(), gate_buf.data_ptr(),
           partial.data_ptr(), dx.data_ptr() if need_dx else None, scratch.data_ptr(),
           scratch.numel(), batch, t_len, feat, hidden, splits, rows_per_split)
    bilstm_train_backward.launches += 1
    # the per-direction sum of the chunks' partials, in a fixed order
    sums = partial.sum(dim=0)
    return dx, sums[:, :feat], sums[:, feat:width], sums[:, width]


def stacked_cotangent(dout: torch.Tensor, hidden: int) -> torch.Tensor:
    """The layer's output cotangent (B, T, 2H) on the stacked layout
    (T, 2B, H), float32: the backward direction's half re-reversed."""
    return torch.cat([dout[..., :hidden].transpose(0, 1),
                      dout[..., hidden:].flip(1).transpose(0, 1)], dim=1).float().contiguous()


def input_grad(dx_s: torch.Tensor, batch: int) -> torch.Tensor:
    """dx (T, 2B, F) on the stacked layout -> (B, T, F): forward rows map
    straight back, backward rows un-reverse, and the halves add."""
    return dx_s[:, :batch].transpose(0, 1) + dx_s[:, batch:].transpose(0, 1).flip(1)


class _BiLSTMTrain(torch.autograd.Function):
    """One layer, (B, T, F) -> (B, T, 2H), the forward and backward kernels
    paired (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, w, u, b):
        xs = _stack_directions(x).contiguous()
        h_out, c_out = bilstm_train_forward(xs, w, u, b)
        ctx.save_for_backward(xs, w, u, b, h_out, c_out)
        return _unstack_outputs(h_out, x.shape[0])

    @staticmethod
    def backward(ctx, dout):
        xs, w, u, b, h_out, c_out = ctx.saved_tensors
        dx_s, dw, du, db = bilstm_train_backward(
            xs, w, u, b, h_out, c_out, stacked_cotangent(dout, u.shape[1]),
            need_dx=ctx.needs_input_grad[0])
        dx = None if dx_s is None else input_grad(dx_s, xs.shape[1] // 2)
        return dx, dw, du, db


def bilstm_train(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM layer over a (B, T, F) float32 batch -> (B, T, 2H)
    float32, the resident kernel pair. Any other dtype raises TypeError.
    Differentiable in x and the parameters when grad mode is on and one of
    them requires a gradient."""
    if x.dtype != torch.float32:
        raise TypeError(f"bilstm_train (use_pallas_train_bilstm) is float32 only, "
                        f"not {x.dtype}")
    w, u, b = _stack_params(params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, u, b)):
        return _BiLSTMTrain.apply(x, w, u, b)
    h_out, _ = bilstm_train_forward(_stack_directions(x).contiguous(), w, u, b)
    return _unstack_outputs(h_out, x.shape[0])


bilstm_train.launches = 0
bilstm_train_backward.launches = 0
