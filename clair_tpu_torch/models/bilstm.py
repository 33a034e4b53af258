"""Plain PyTorch bidirectional LSTMs (port of clair_tpu/models/bilstm.py).

Two functions with two jobs, sharing the layout: gate order (i, f, g, o),
one bias, no extra forget bias (the cudnn layout of published Clair
checkpoints); the reversed direction stacked on the batch axis, each
direction with its own W/U/b, and its outputs re-reversed before the
feature concatenation; the cell state float32 and h in the compute dtype.

``bilstm_with_cell`` (and ``bilstm``) is the plain version of the port's
CUDA kernels (ops/): the reference they are held against, and the path a
CPU tensor takes in their wrappers. It computes what the TPU's streaming
kernel computes: gates accumulate in float32 from inputs in the compute
dtype, and the input projection of all steps is hoisted into one product.

``bilstm_scan`` is the JAX package's ``lax.scan`` BiLSTM itself (``bilstm``
and ``_bilstm_fused`` there), which runs outside any Pallas kernel: torch
products and the gate math, on whatever device x lies on. Training selects
it with ``use_stream_bilstm=False`` (``train --no_stream_bilstm``) and no
kernel flag (models/clair.py:select_bilstm). Its numerics are JAX's: each
product and sum is rounded to the compute dtype (bf16 where the model
computes in bf16), the gates are upcast to the cell dtype before the gate
math, and h is rounded to the compute dtype every step. Two step forms,
picked by the batch as in JAX: hoisted (x.W + b for all steps, then
xw_t + h.U per step) up to ``FUSED_ABOVE`` rows, fused above it
([x_t, h].[[W], [U]] + b per step, each step recomputed in the backward
under ``torch.utils.checkpoint``, as JAX's ``jax.checkpoint(step)``).

Parameters keep the JAX layout: ``{"fw": {"w": (F, 4H), "u": (H, 4H),
"b": (4H,)}, "bw": {...}}``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

# the batch above which the JAX scan takes its fused step form
# (clair_tpu/models/bilstm.py:97)
FUSED_ABOVE = 512


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


def bilstm_scan(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's scan BiLSTM over a (B, T, F) batch -> (B, T, 2H)
    in x.dtype; the parameters in x's dtype. Above ``FUSED_ABOVE`` rows
    the fused step form, else the hoisted one."""
    if x.shape[0] > FUSED_ABOVE:
        return _bilstm_scan_fused(params, x)
    b, t_len, _ = x.shape
    hidden = params["fw"]["u"].shape[0]
    fw, bw = params["fw"], params["bw"]
    # x.W + b for all steps, each direction in its own product, rounded to
    # x's dtype after the product and after the bias: (T, 2B, 4H)
    xw = torch.cat([(x @ fw["w"] + fw["b"]).transpose(0, 1),
                    (x.flip(1) @ bw["w"] + bw["b"]).transpose(0, 1)], dim=1)
    u = torch.stack([fw["u"], bw["u"]])

    h = torch.zeros((2 * b, hidden), dtype=x.dtype, device=x.device)
    c = torch.zeros((2 * b, hidden), dtype=_cell_dtype(x.dtype), device=x.device)
    hs = []
    for t in range(t_len):
        # h.U per direction, rounded to x's dtype before the sum
        rec = torch.bmm(h.view(2, b, hidden), u).view(2 * b, 4 * hidden)
        c, h = _gate_update(xw[t] + rec, c, x.dtype)
        hs.append(h)
    return _unstack_outputs(torch.stack(hs), b)


def _bilstm_scan_fused(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """The scan's large-batch step form (JAX ``_bilstm_fused``): the input
    projection inside the step, one [x_t, h].[[W], [U]] + b product per
    direction, and the step recomputed in the backward, so that the saved
    tensors are each step's h and c, not its (2B, 4H) gates."""
    b, t_len, feat = x.shape
    hidden = params["fw"]["u"].shape[0]
    fw, bw = params["fw"], params["bw"]
    xs = _stack_directions(x)  # (T, 2B, F)
    wu = torch.stack([torch.cat([fw["w"], fw["u"]]), torch.cat([bw["w"], bw["u"]])])
    bias = torch.stack([fw["b"], bw["b"]])[:, None, :]

    def step(x_t, h, c):
        inp = torch.cat([x_t, h], dim=-1).view(2, b, feat + hidden)
        gates = (torch.bmm(inp, wu) + bias).view(2 * b, 4 * hidden)
        c_new, h_new = _gate_update(gates, c, x.dtype)
        return h_new, c_new

    h = torch.zeros((2 * b, hidden), dtype=x.dtype, device=x.device)
    c = torch.zeros((2 * b, hidden), dtype=_cell_dtype(x.dtype), device=x.device)
    hs = []
    for t in range(t_len):
        # the step draws no random numbers: no RNG state to stash
        h, c = checkpoint(step, xs[t], h, c, use_reentrant=False, preserve_rng_state=False)
        hs.append(h)
    return _unstack_outputs(torch.stack(hs), b)
