"""The streaming BiLSTM forward: a hand-written CUDA kernel for Hopper.

Port of clair_tpu/ops/pallas_bilstm_stream.py's forward (``_fwd_kernel``
through ``_fwd_pallas``, ``_stack_params`` and ``_bilstm_fwd``). The kernel
is ``csrc/bilstm_stream_fwd.cu``; its source says what bounds it and how it
is laid out. ``bilstm_stream(params, x)`` is the drop-in for
``models.bilstm.bilstm``: (B, T, F) -> (B, T, 2H) in x's dtype.

A CUDA tensor goes to the kernel, or the wrapper raises. A CPU tensor goes
to the plain version, ``bilstm_stream_reference``, which is also the
kernel's yardstick on the card. ``bilstm_stream.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from clair_tpu_torch.models.bilstm import bilstm_with_cell

_KERNEL = "bilstm_stream_fwd"
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HIDDEN = 1024  # one thread per hidden unit, one block per row tile


def bilstm_stream_reference(params: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (h_out (B, T, 2H) in x.dtype,
    c_out (B, T, 2H) float32), the same math and layout."""
    return bilstm_with_cell(params, x)


def _stack_params(params: Dict, dtype: torch.dtype):
    """Both directions' parameters as the kernel takes them: w (2, F, 4H)
    and u (2, H, 4H) in the compute dtype, b (2, 4H) float32."""
    w = torch.stack([params["fw"]["w"], params["bw"]["w"]]).to(dtype).contiguous()
    u = torch.stack([params["fw"]["u"], params["bw"]["u"]]).to(dtype).contiguous()
    b = torch.stack([params["fw"]["b"], params["bw"]["b"]]).to(torch.float32).contiguous()
    return w, u, b


def _library():
    from clair_tpu_torch.ops import build

    fn = build.load(_KERNEL).clair_bilstm_stream_fwd
    # every pointer and the stream as c_void_p: a default int argument
    # would cut a 64-bit pointer to 32 bits
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


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


def bilstm_stream(params: Dict, x: torch.Tensor, *, with_cell: bool = False):
    """Bidirectional LSTM layer over a (B, T, F) batch -> (B, T, 2H) in
    x.dtype; with ``with_cell``, also the float32 cell states (B, T, 2H)."""
    if x.device.type == "cpu":
        h_out, c_out = bilstm_stream_reference(params, x)
        return (h_out, c_out) if with_cell else h_out
    if x.device.type != "cuda":
        raise ValueError(f"bilstm_stream runs on cuda or cpu tensors, not {x.device}")

    w, u, b = _stack_params(params, x.dtype)
    _check(x, w, u, b)
    batch, t_len, feat = x.shape
    hidden = u.shape[1]
    h_out = torch.empty((batch, t_len, 2 * hidden), dtype=x.dtype, device=x.device)
    c_out: Optional[torch.Tensor] = (
        torch.empty((batch, t_len, 2 * hidden), dtype=torch.float32, device=x.device)
        if with_cell else None
    )
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), u.data_ptr(), b.data_ptr(),
                 h_out.data_ptr(), c_out.data_ptr() if with_cell else None,
                 batch, t_len, feat, hidden, int(x.dtype == torch.bfloat16),
                 stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    bilstm_stream.launches += 1
    return (h_out, c_out) if with_cell else h_out


bilstm_stream.launches = 0
