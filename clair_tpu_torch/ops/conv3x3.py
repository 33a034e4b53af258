"""Clair3_F's stride-1 3x3 convolutions, forward, input gradient (dgrad)
and weight gradient (wgrad): hand-written CUDA kernels for Hopper
(``csrc/conv3x3.cu``, which says what bounds them and how they are laid
out). They replace no TPU kernel (the JAX package leaves convolutions to
XLA): cuDNN ran these float32 convolutions on the CUDA cores.

``conv3x3(x, w, b)`` is ``F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=1)``
for x NCHW (B, Cin, H, W) float32 and w HWIO (3, 3, Cin, Cout) float32, the
layouts of ``models/clair3_fa.py``; SAME zero padding, stride 1. Every
product takes its float32 operands as three bf16 pieces, p0 = bf16(v),
p1 = bf16(v - p0), p2 = bf16(v - p0 - p1), and runs the six piece pairs
i + j < 3 with float32 sums, the pair (0, 0) in its own accumulator
(``csrc/mma_product.cuh``, Numerics); no TF32.

When a gradient is wanted the call runs as ``_Conv3x3``, a
``torch.autograd.Function`` that keeps x's pieces and the rotated kernel's
from the forward; the backward splits the output gradient once for both of
its products. A CUDA tensor goes to the kernels (Cin and Cout multiples of
64, W at most 128, contiguous float32), or the wrappers raise. A CPU tensor
goes to the plain versions, ``conv3x3_reference``,
``conv3x3_dgrad_reference`` and ``conv3x3_wgrad_reference``: the same piece
arithmetic as six ``F.conv2d`` products in float32 and two accumulators
(with fewer piece pairs, the controls of lower precision that the kernels'
float64 checks must tell apart). ``conv3x3.launches``,
``conv3x3_dgrad.launches`` and ``conv3x3_wgrad.launches`` count each
forward, input-gradient and weight-gradient product run on the card (with
the pieces' splits it needs and, for wgrad, the sum of its slabs; a backward
that wants no dx splits the output gradient and counts no dgrad).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from clair_tpu_torch.ops.build import launch, on_cuda

_KERNEL = "conv3x3"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SPLIT_ARGTYPES = [_P, _P, _I, _I, _I]
_WEIGHTS_ARGTYPES = [_P, _P, _P, _I, _I]
_PRODUCT_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I]
_WGRAD_ARGTYPES = [_P] * 5 + [_I] * 7
PIECES = 3
# the piece pairs each product runs: (0, 0) in its own accumulator
PIECE_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0))
_CHANNELS = 64   # the kernels' box of channels
_MAX_WIDTH = 128  # a forward tile's cells: whole image rows
_WGRAD_ROWS = 32  # cells a weight-gradient stage
_MAX_BATCH = 65535  # the split's grid


# ---- the plain versions -------------------------------------------------------

def split_pieces(v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """v (float32) as three bf16 pieces held in float32, each the rounding of
    what the earlier ones leave."""
    pieces, rest = [], v
    for _ in range(PIECES):
        piece = rest.to(torch.bfloat16).float()
        pieces.append(piece)
        rest = rest - piece
    return tuple(pieces)


def _piece_products(product: Callable, a: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
                    pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The first pair's product (the pair (0, 0)) plus the sum of the other
    pairs' (the five smaller ones)."""
    low = None
    for i, j in pairs[1:]:
        term = product(a[i], b[j])
        low = term if low is None else low + term
    return product(a[pairs[0][0]], b[pairs[0][1]]) + low


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                      pairs=PIECE_PAIRS) -> torch.Tensor:
    """The forward's plain version: (B, Cout, H, W) float32. ``pairs``, here
    and in the gradients' plain versions, are the piece pairs it runs: fewer
    make the tests' controls of lower precision."""
    out = _piece_products(lambda xi, wj: F.conv2d(xi, wj, padding=1),
                        split_pieces(x), split_pieces(_oihw(w)), pairs)
    return out if b is None else out + b.view(1, -1, 1, 1)


def conv3x3_dgrad_reference(go: torch.Tensor, w: torch.Tensor, pairs=PIECE_PAIRS) -> torch.Tensor:
    """The input gradient's plain version: go (B, Cout, H, W) -> (B, Cin, H,
    W) float32."""
    return _piece_products(lambda gi, wj: F.conv_transpose2d(gi, wj, padding=1),
                         split_pieces(go), split_pieces(_oihw(w)), pairs)


def conv3x3_wgrad_reference(x: torch.Tensor, go: torch.Tensor,
                            pairs=PIECE_PAIRS) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight gradient's plain version: (dw HWIO (3, 3, Cin, Cout), db
    (Cout,)), float32; db adds each element's pieces first."""
    shape = (go.shape[1], x.shape[1], 3, 3)
    go_pieces = split_pieces(go)
    dw = _piece_products(lambda gi, xj: torch.nn.grad.conv2d_weight(xj, shape, gi, padding=1),
                       go_pieces, split_pieces(x), pairs)
    db = (go_pieces[0] + go_pieces[1] + go_pieces[2]).sum(dim=(0, 2, 3))
    return dw.permute(2, 3, 1, 0).contiguous(), db


# ---- the kernels ----------------------------------------------------------------

def _check_tensor(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"conv3x3 takes float32 on the card; {name} is {t.dtype}")
    if tuple(t.shape) != shape or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {device}, got "
                         f"{tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ', not contiguous'}")


def _check_sizes(batch: int, cin: int, cout: int, height: int, width: int) -> None:
    if cin % _CHANNELS or cout % _CHANNELS or not cin or not cout:
        raise ValueError(f"the conv3x3 kernels take channels in multiples of {_CHANNELS}, not "
                         f"Cin = {cin}, Cout = {cout}")
    if not 0 < width <= _MAX_WIDTH or height <= 0 or not 0 < batch <= _MAX_BATCH:
        raise ValueError(f"the conv3x3 kernels take W up to {_MAX_WIDTH} and B up to "
                         f"{_MAX_BATCH}, not (B, H, W) = {(batch, height, width)}")


def _check_4d(name: str, t: torch.Tensor) -> None:
    if t.dim() != 4:
        raise ValueError(f"conv3x3 takes {name} of four dimensions, got {tuple(t.shape)}")


def _check(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> None:
    """Raise before any launch where the kernels cannot take the tensors:
    x (B, Cin, H, W), w (3, 3, Cin, Cout), b (Cout,) or None."""
    _check_4d("x", x)
    _check_4d("w", w)
    batch, cin, height, width = x.shape
    cout = w.shape[3]
    _check_tensor("x", x, tuple(x.shape), x.device)
    _check_tensor("w", w, (3, 3, cin, cout), x.device)
    if b is not None:
        _check_tensor("b", b, (cout,), x.device)
    _check_sizes(batch, cin, cout, height, width)


def _launch(symbol: str, argtypes, device: torch.device, *args) -> None:
    launch(_KERNEL, symbol, argtypes, device, *args)


def _split(t: torch.Tensor) -> torch.Tensor:
    """NCHW float32 -> (B * H * W, 3, C) bf16 pieces."""
    batch, c, height, width = t.shape
    pieces = torch.empty((batch * height * width, PIECES, c), dtype=torch.bfloat16, device=t.device)
    _launch("clair_conv3x3_split", _SPLIT_ARGTYPES, t.device, t.data_ptr(), pieces.data_ptr(),
            batch, c, height * width)
    return pieces


def _split_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO float32 -> the forward's pieces (Cout, 3, 9 Cin) and the input
    gradient's (Cin, 3, 9 Cout), taps rotated by 180 degrees."""
    cin, cout = w.shape[2], w.shape[3]
    w_fwd = torch.empty((cout, PIECES, 9 * cin), dtype=torch.bfloat16, device=w.device)
    w_bwd = torch.empty((cin, PIECES, 9 * cout), dtype=torch.bfloat16, device=w.device)
    _launch("clair_conv3x3_weights", _WEIGHTS_ARGTYPES, w.device, w.data_ptr(), w_fwd.data_ptr(),
            w_bwd.data_ptr(), cin, cout)
    return w_fwd, w_bwd


def _product(pieces: torch.Tensor, w_pieces: torch.Tensor, bias: Optional[torch.Tensor],
             shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """The implicit GEMM of an activation's pieces with a kernel's: (B, N, H,
    W) float32, shape = (B, C reduced, H, W)."""
    batch, c_red, height, width = shape
    n_total = w_pieces.shape[0]
    out = torch.empty((batch, n_total, height, width), dtype=torch.float32, device=pieces.device)
    _launch("clair_conv3x3_product", _PRODUCT_ARGTYPES, pieces.device, pieces.data_ptr(),
            w_pieces.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            batch, c_red, n_total, height, width)
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def wgrad_slabs(cells: int, cin: int, cout: int, sms: int) -> Tuple[int, int]:
    """(slabs, cells a slab) of the weight gradient's reduction: about three
    tiles a multiprocessor, each slab whole stages of 32 cells."""
    boxes_a = 2 if cout % (2 * _CHANNELS) == 0 else 1
    tiles = cout // (boxes_a * _CHANNELS) * -(-9 * cin // _CHANNELS // (4 // boxes_a))
    slabs = max(1, -(-3 * sms // tiles))
    rows = -(-(-(-cells // slabs)) // _WGRAD_ROWS) * _WGRAD_ROWS
    return -(-cells // rows), rows


def _wgrad(x_pieces: torch.Tensor, go_pieces: torch.Tensor,
           shape: Tuple[int, int, int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """dw (3, 3, Cin, Cout) and db (Cout,) from the two activations' pieces,
    shape = (B, Cin, Cout, H, W)."""
    batch, cin, cout, height, width = shape
    device = x_pieces.device
    slabs, rows = wgrad_slabs(batch * height * width, cin, cout,
                              _sm_count(device.index if device.index is not None
                                        else torch.cuda.current_device()))
    partial = torch.empty((slabs, 9 * cin * cout + cout), dtype=torch.float32, device=device)
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=device)
    db = torch.empty((cout,), dtype=torch.float32, device=device)
    _launch("clair_conv3x3_wgrad", _WGRAD_ARGTYPES, device, x_pieces.data_ptr(),
            go_pieces.data_ptr(), partial.data_ptr(), dw.data_ptr(), db.data_ptr(), batch, cin,
            cout, height, width, slabs, rows)
    return dw, db


def _forward_launch(x, w, b) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, x's pieces, the input gradient's kernel pieces) on checked
    inputs; counts the launch."""
    x_pieces = _split(x)
    w_fwd, w_bwd = _split_weights(w)
    out = _product(x_pieces, w_fwd, b, tuple(x.shape))
    conv3x3.launches += 1
    return out, x_pieces, w_bwd


def _dgrad_launch(go_pieces: torch.Tensor, w_bwd: torch.Tensor,
                  shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """dx from the output gradient's pieces, shape = go's; counts the
    launch."""
    dx = _product(go_pieces, w_bwd, None, shape)
    conv3x3_dgrad.launches += 1
    return dx


def _wgrad_launch(x_pieces, go_pieces, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    out = _wgrad(x_pieces, go_pieces, shape)
    conv3x3_wgrad.launches += 1
    return out


class _Conv3x3(torch.autograd.Function):
    """conv3x3 with its gradient: the kernels on CUDA tensors, the plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.shape = (x.shape[0], w.shape[2], w.shape[3], x.shape[2], x.shape[3])
        ctx.has_bias = b is not None
        ctx.card = on_cuda(x, "conv3x3")
        if ctx.card:
            _check(x, w, b)
            out, x_pieces, w_bwd = _forward_launch(x, w, b)
            ctx.save_for_backward(x_pieces, w_bwd)
        else:
            out = conv3x3_reference(x, w, b)
            ctx.save_for_backward(x, w)
        return out

    @staticmethod
    def backward(ctx, go):
        batch, cin, cout, height, width = ctx.shape
        go = go.contiguous()
        need_dx, need_w = ctx.needs_input_grad[0], any(ctx.needs_input_grad[1:])
        dx = dw = db = None
        if ctx.card:
            x_pieces, w_bwd = ctx.saved_tensors
            _check_tensor("the output gradient", go, (batch, cout, height, width),
                          x_pieces.device)
            go_pieces = _split(go)
            if need_dx:
                dx = _dgrad_launch(go_pieces, w_bwd, tuple(go.shape))
            if need_w:
                dw, db = _wgrad_launch(x_pieces, go_pieces, ctx.shape)
        else:
            x, w = ctx.saved_tensors
            if need_dx:
                dx = conv3x3_dgrad_reference(go, w)
            if need_w:
                dw, db = conv3x3_wgrad_reference(x, go)
        return dx, dw, db if ctx.has_bias else None


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stride-1 3x3 convolution with SAME zero padding: x (B, Cin, H, W),
    w (3, 3, Cin, Cout), b (Cout,) or None -> (B, Cout, H, W) float32.
    Differentiable in x, w and b when grad mode is on and one of them
    requires a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        return _Conv3x3.apply(x, w, b)
    if not on_cuda(x, "conv3x3"):
        return conv3x3_reference(x, w, b)
    _check(x, w, b)
    return _forward_launch(x, w, b)[0]


def conv3x3_dgrad(go: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input gradient alone: go (B, Cout, H, W), w (3, 3, Cin, Cout) ->
    (B, Cin, H, W) float32."""
    if not on_cuda(go, "conv3x3_dgrad"):
        return conv3x3_dgrad_reference(go, w)
    _check_4d("go", go)
    _check_4d("w", w)
    batch, cout, height, width = go.shape
    cin = w.shape[2]
    _check_tensor("go", go, tuple(go.shape), go.device)
    _check_tensor("w", w, (3, 3, cin, cout), go.device)
    _check_sizes(batch, cin, cout, height, width)
    return _dgrad_launch(_split(go), _split_weights(w)[1], tuple(go.shape))


def conv3x3_wgrad(x: torch.Tensor, go: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight and bias gradients alone: x (B, Cin, H, W), go (B, Cout, H,
    W) -> (dw (3, 3, Cin, Cout), db (Cout,)) float32."""
    if not on_cuda(x, "conv3x3_wgrad"):
        return conv3x3_wgrad_reference(x, go)
    _check_4d("x", x)
    _check_4d("go", go)
    batch, cin, height, width = x.shape
    cout = go.shape[1]
    _check_tensor("x", x, tuple(x.shape), x.device)
    _check_tensor("go", go, (batch, cout, height, width), x.device)
    _check_sizes(batch, cin, cout, height, width)
    return _wgrad_launch(_split(x), _split(go), (batch, cin, cout, height, width))


conv3x3.launches = 0
conv3x3_dgrad.launches = 0
conv3x3_wgrad.launches = 0
