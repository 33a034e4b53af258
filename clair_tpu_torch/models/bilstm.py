"""Plain PyTorch bidirectional LSTM (port of clair_tpu/models/bilstm.py).

This is the reference the CUDA kernel (ops/bilstm_stream.py) is held
against, and the path a CPU tensor takes. It computes what the TPU's
streaming kernel computes:

- gate order (i, f, g, o), one bias, no extra forget bias (the cudnn
  layout of published Clair checkpoints);
- the reversed direction stacked on the batch axis, each direction with its
  own W/U/b, and its outputs re-reversed before the feature concatenation;
- gates accumulate in float32 from inputs in the compute dtype, the cell
  state stays float32, and h is rounded to the compute dtype every step.

One step form: the input projection of all steps is hoisted into one
product before the loop. (The JAX package's second, fused form exists for a
TPU memory cliff above batch 512.)

Parameters keep the JAX layout: ``{"fw": {"w": (F, 4H), "u": (H, 4H),
"b": (4H,)}, "bw": {...}}``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _cell_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """The cell state is the additive accumulator over all 33 steps, where
    reduced precision compounds: keep it float32 under bf16 compute."""
    return torch.promote_types(compute_dtype, torch.float32)


def _gate_update(gates: torch.Tensor, c: torch.Tensor, h_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i, f, g, o) gate math with float32 cell accumulation; h is rounded
    to the compute dtype for the next step's product."""
    i, f, g, o = gates.to(c.dtype).chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = (torch.sigmoid(o) * torch.tanh(c_new)).to(h_dtype)
    return c_new, h_new


def _stack_directions(x: torch.Tensor) -> torch.Tensor:
    """(B, T, F) -> time-major (T, 2B, F) with the reversed sequence
    stacked along batch."""
    return torch.cat([x.transpose(0, 1), x.flip(1).transpose(0, 1)], dim=1)


def _unstack_outputs(outputs: torch.Tensor, b: int) -> torch.Tensor:
    """(T, 2B, H) -> (B, T, 2H) with the backward half re-reversed and
    concatenated on features."""
    out_fw = outputs[:, :b].transpose(0, 1)
    out_bw = outputs[:, b:].transpose(0, 1).flip(1)
    return torch.cat([out_fw, out_bw], dim=-1)


def bilstm_with_cell(params: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, F) -> (h (B, T, 2H) in x.dtype, c (B, T, 2H) float32).

    h[..., :H] and c[..., :H] are the forward direction; [..., H:] the
    backward one, at the original time index."""
    b, t_len, feat = x.shape
    hidden = params["fw"]["u"].shape[0]
    cell = _cell_dtype(x.dtype)

    def stacked(key):
        # both directions' parameters in the compute dtype, upcast so the
        # products are exact and the sums run in float32 (as on the card)
        return torch.stack([params["fw"][key], params["bw"][key]]).to(x.dtype).to(cell)

    w, u = stacked("w"), stacked("u")
    bias = torch.stack([params["fw"]["b"], params["bw"]["b"]]).to(cell)
    xs = _stack_directions(x).to(cell).reshape(t_len, 2, b, feat)
    # hoisted input projection: (T, 2, B, 4H)
    xw = torch.einsum("tdbf,dfg->tdbg", xs, w) + bias[None, :, None, :]

    h = torch.zeros((2, b, hidden), dtype=x.dtype, device=x.device)
    c = torch.zeros((2, b, hidden), dtype=cell, device=x.device)
    hs, cs = [], []
    for t in range(t_len):
        gates = xw[t] + torch.bmm(h.to(cell), u)
        c, h = _gate_update(gates, c, x.dtype)
        hs.append(h)
        cs.append(c)
    h_out = _unstack_outputs(torch.stack(hs).reshape(t_len, 2 * b, hidden), b)
    c_out = _unstack_outputs(torch.stack(cs).reshape(t_len, 2 * b, hidden), b)
    return h_out, c_out


def bilstm(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM over a (B, T, F) batch -> (B, T, 2H) in x.dtype."""
    return bilstm_with_cell(params, x)[0]
