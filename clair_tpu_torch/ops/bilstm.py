"""The forward-only BiLSTM on precomputed input projections: a hand-written
CUDA kernel for Hopper (``ModelConfig.use_pallas_bilstm``).

Port of clair_tpu/ops/pallas_bilstm.py: ``_bilstm_kernel`` (through
``_lstm_pallas``) is ``csrc/bilstm.cu``, which says what bounds it; it runs
the float32 forward sweep of ``csrc/lstm_sweep.cuh`` (rows 4 and 5 run it
too) on the caller's xw: a thread-block cluster holds U's columns of its
units in shared memory, h.U runs on the tensor cores with h as three bf16
pieces and U as one (bf16 U, three passes) or three (float32 U, six
passes), float32 sums, and h crosses the cluster through distributed
shared memory. ``bilstm_precomputed(params, x)`` is ``bilstm_pallas``:
(B, T, F) -> (B, T, 2H), **float32 whatever the input dtype**, as the JAX
kernel returns float32.

As in ``bilstm_pallas``, the input projection xw = x.W + b of both
directions (direction 1 on the time-reversed sequence) is computed outside
the kernel by a library product (``torch.matmul``), in the dtype JAX
promotes the operands to: the compute dtype for lstm1, and float32 for
lstm2 under a reduced compute dtype, whose input is the float32 output of
lstm1 and whose weights are rounded to the compute dtype. torch does not
promote mixed matmul operands, so the cast is explicit here. The kernel
runs only the recurrence: U is read in its dtype and widened, h and c stay
float32 and h is not rounded between steps. On the card H must be a
multiple of 8 and fit the sweep's shared memory (``sweep_geometries``, the
sweep's carve-up arithmetic, with U's piece count); a width that does not
raises ValueError before any launch.

Forward only, like the JAX kernel (it has no vjp): when a gradient is
wanted the wrapper raises, on either device. A CUDA tensor goes to the
kernel, or the wrapper raises; a CPU tensor goes to the plain version,
``bilstm_recurrence_reference``, also the kernel's yardstick on the card;
its ``emulate_kernel`` runs the kernel's split-bf16 product on the CPU.
``bilstm_precomputed.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from clair_tpu_torch.models.bilstm import _gate_update
from clair_tpu_torch.ops.bilstm_stream import split_bf16_product
from clair_tpu_torch.ops.bilstm_train import _CUDA_ERROR_INVALID_VALUE
from clair_tpu_torch.ops.build import entry, on_cuda
from clair_tpu_torch.ops.lstm_sweep import check_sweep_width

_KERNEL = "bilstm"
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)


def promoted(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors cast to their promoted dtype, as JAX promotes the
    operands of a product (float32 with bfloat16 gives float32)."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in tensors)


def projections(params: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xw (2, T, B, 4H) in the promoted dtype of x and W, u (2, H, 4H) in
    the parameters' dtype), as ``bilstm_pallas`` lays them out for its
    kernel (without the padding: the kernel masks the ragged edge)."""
    def one(direction: str, seq: torch.Tensor) -> torch.Tensor:
        p = params[direction]
        xs, w = promoted(seq, p["w"])
        return (xs @ w + p["b"]).transpose(0, 1)          # (T, B, 4H)

    xw = torch.stack([one("fw", x), one("bw", x.flip(1))]).contiguous()
    u = torch.stack([params["fw"]["u"], params["bw"]["u"]]).contiguous()
    return xw, u


def u_pieces(u: torch.Tensor) -> int:
    """U's bf16 pieces in the kernel: one of a bf16 U, three of a float32 one."""
    return 1 if u.dtype == torch.bfloat16 else 3


def bilstm_recurrence_reference(xw: torch.Tensor, u: torch.Tensor, *,
                                emulate_kernel: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: xw (2, T, N, 4H), u (2, H, 4H),
    either dtype -> h (2, T, N, H) float32, a loop over t with ``bmm``; h
    and c float32, U widened from its dtype. ``emulate_kernel``: each step's
    h.U runs as the kernel's product, ``split_bf16_product`` with three
    pieces an operand (a bf16 U's later pieces are 0)."""
    _, t_len, n, gates = xw.shape
    hidden = gates // 4
    uf = u.float()
    h = torch.zeros((2, n, hidden), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(t_len):
        hu = (split_bf16_product("dbk,dkg->dbg", h, uf, pieces=3) if emulate_kernel
              else torch.bmm(h, uf))
        c, h = _gate_update(xw[:, t].float() + hu, c, torch.float32)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _check(xw: torch.Tensor, u: torch.Tensor) -> None:
    """Raise before any launch where the kernel cannot take the inputs."""
    if xw.dtype not in _DTYPES or u.dtype not in _DTYPES:
        raise TypeError(f"bilstm_precomputed takes float32 or bfloat16, not {xw.dtype} "
                        f"and {u.dtype}")
    if xw.dim() != 4 or xw.shape[0] != 2 or min(xw.shape) < 1 or xw.shape[3] % 4:
        raise ValueError(f"xw must be a non-empty (2, T, N, 4H) tensor, got {tuple(xw.shape)}")
    gates = xw.shape[3]
    hidden = gates // 4
    if tuple(u.shape) != (2, hidden, gates) or u.device != xw.device:
        raise ValueError(f"u must be a (2, {hidden}, {gates}) tensor on {xw.device}, "
                         f"got {tuple(u.shape)} on {u.device}")
    if not (xw.is_contiguous() and u.is_contiguous()):
        raise ValueError("xw and u must be contiguous")
    check_sweep_width(hidden, u_pieces(u))


def _launch(xw: torch.Tensor, u: torch.Tensor, cluster: int = 0, rows: int = 0
            ) -> Optional[torch.Tensor]:
    """The kernel on checked inputs, at ``cluster`` CTAs and ``rows`` rows
    a tile (0: the kernel's choice): h (2, T, N, H) float32, or None where a
    given geometry does not fit or launch. Counts no launch: the checks of
    every geometry count none."""
    _, t_len, n, gates = xw.shape
    hidden = gates // 4
    out = torch.empty((2, t_len, n, hidden), dtype=torch.float32, device=xw.device)
    fn = entry(_KERNEL, "clair_bilstm_recurrence", _ARGTYPES)
    with torch.cuda.device(xw.device):
        err = fn(xw.data_ptr(), u.data_ptr(), out.data_ptr(), n, t_len, hidden,
                 int(xw.dtype == torch.bfloat16), int(u.dtype == torch.bfloat16), cluster, rows,
                 None, torch.cuda.current_stream().cuda_stream)
    if err == _CUDA_ERROR_INVALID_VALUE and (cluster or rows):
        return None
    if err != 0:
        raise RuntimeError(f"{_KERNEL} (clair_bilstm_recurrence) launch failed: CUDA error {err}")
    return out


def bilstm_recurrence(xw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The recurrence of both directions: (2, T, N, H) float32. Same inputs
    and output as ``bilstm_recurrence_reference``; a CUDA tensor runs the
    kernel."""
    if not on_cuda(xw, "bilstm_precomputed"):
        return bilstm_recurrence_reference(xw, u)
    _check(xw, u)
    out = _launch(xw, u)
    bilstm_precomputed.launches += 1
    return out


def bilstm_precomputed(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM layer over a (B, T, F) batch -> (B, T, 2H)
    float32: the input projection by ``torch.matmul``, the recurrence by the
    kernel. Forward only: raises when a gradient is wanted."""
    wants_grad = torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for p in params.values() for t in p.values()))
    if wants_grad:
        raise ValueError("use_pallas_bilstm's kernel (bilstm_precomputed) is forward only, "
                         "as the JAX kernel has no gradient: call it under torch.no_grad() "
                         "or inference_mode, or train with another BiLSTM kernel")
    xw, u = projections(params, x)
    out = bilstm_recurrence(xw, u)
    return torch.cat([out[0].transpose(0, 1), out[1].transpose(0, 1).flip(1)], dim=-1)


bilstm_precomputed.launches = 0
