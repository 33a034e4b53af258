"""Both BiLSTM layers in one launch, forward only, float32: a hand-written
CUDA kernel for Hopper.

Port of clair_tpu/ops/pallas_bilstm2.py: ``_bilstm2_kernel`` (through
``_bilstm2_pallas``) is ``csrc/bilstm2.cu``, which says what bounds it and
how it is laid out; ``bilstm2(params1, params2, x)`` is ``bilstm2_pallas``:
``bilstm(params2, bilstm(params1, x))`` for (B, T, F) -> (B, T, 2*H2) in
float32, with layer 1's output kept on chip. Like the JAX function it is a
library function on no path of the model, and forward only: when a
gradient is wanted it raises, on either device.

A CUDA tensor goes to the kernel, or the wrapper raises; a CPU tensor goes
to the plain version, ``bilstm2_reference`` (the composition of the plain
layers), also the kernel's yardstick on the card. ``bilstm2.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from clair_tpu_torch.models.bilstm import bilstm
from clair_tpu_torch.ops.build import launch, on_cuda

_KERNEL = "bilstm2"
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
_MAX_HIDDEN = 512  # two threads per hidden unit index, one per direction
_TILE_ROWS = 4     # rows per block (kRows in the source)
# the most shared memory a block may take on Hopper; the kernel keeps layer
# 1's h of its tile over all steps there
_SMEM_LIMIT = 227 * 1024


def bilstm2_reference(params1: Dict, params2: Dict, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the two plain layers in float32."""
    def f32(p):
        return {d: {k: v.float() for k, v in q.items()} for d, q in p.items()}

    return bilstm(f32(params2), bilstm(f32(params1), x.float()))


def _stacked(params: Dict, key: str) -> torch.Tensor:
    return torch.stack([params["fw"][key], params["bw"][key]]).float().contiguous()


def bilstm2(params1: Dict, params2: Dict, x: torch.Tensor) -> torch.Tensor:
    """Both layers over a (B, T, F) batch -> (B, T, 2*H2) float32."""
    leaves = [t for p in (params1, params2) for q in p.values() for t in q.values()]
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in leaves)):
        raise ValueError("bilstm2 is forward only, as bilstm2_pallas: call it under "
                         "torch.no_grad() or inference_mode")
    if not on_cuda(x, "bilstm2"):
        return bilstm2_reference(params1, params2, x)
    x = x.float().contiguous()
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"x must be a non-empty (B, T, F) tensor, got {tuple(x.shape)}")
    batch, t_len, feat = x.shape
    w1, u1, b1 = (_stacked(params1, k) for k in ("w", "u", "b"))
    w2, u2, b2 = (_stacked(params2, k) for k in ("w", "u", "b"))
    h1, h2 = u1.shape[1], u2.shape[1]
    want = {"w1": (2, feat, 4 * h1), "u1": (2, h1, 4 * h1), "b1": (2, 4 * h1),
            "w2": (2, 2 * h1, 4 * h2), "u2": (2, h2, 4 * h2), "b2": (2, 4 * h2)}
    for name, t in zip(want, (w1, u1, b1, w2, u2, b2)):
        if tuple(t.shape) != want[name] or t.device != x.device:
            raise ValueError(f"{name} must be {want[name]} on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if not 1 <= max(h1, h2) <= _MAX_HIDDEN:
        raise ValueError(f"hidden sizes {h1}, {h2} outside 1..{_MAX_HIDDEN}")
    smem = 4 * _TILE_ROWS * (t_len * 2 * h1 + 2 * (feat + max(h1, h2)))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"T = {t_len}, F = {feat}, H1 = {h1} need {smem} bytes of shared "
                         f"memory a block, above {_SMEM_LIMIT}")
    out = torch.empty((batch, t_len, 2 * h2), dtype=torch.float32, device=x.device)
    launch(_KERNEL, "clair_bilstm2", _ARGTYPES, x.device,
           x.data_ptr(), w1.data_ptr(), u1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
           u2.data_ptr(), b2.data_ptr(), out.data_ptr(), batch, t_len, feat, h1, h2)
    bilstm2.launches += 1
    return out


bilstm2.launches = 0
