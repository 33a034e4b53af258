"""Both BiLSTM layers, forward only, float32, on the resident training
forward's kernels for Hopper.

Port of clair_tpu/ops/pallas_bilstm2.py: ``_bilstm2_kernel`` (through
``_bilstm2_pallas``); ``bilstm2(params1, params2, x)`` is
``bilstm2_pallas``: ``bilstm(params2, bilstm(params1, x))`` for (B, T, F)
-> (B, T, 2*H2) in float32. Like the JAX function it is a library function
on no path of the model, and forward only: when a gradient is wanted it
raises, on either device.

Design: each layer is the resident training forward's three parts
(``ops/bilstm_train.py:_forward_launch``, ``csrc/bilstm_train.cu``): the
bf16 pieces of the layer's input and W, xw = input.W + b for every step at
once on the tensor cores, and the float32 forward sweep of
``csrc/lstm_sweep.cuh``, which holds U's three bf16 pieces across a
thread-block cluster and carries h.U on ``mma.sync``. The wrapper stacks
the two directions of x into that layout (T, 2B, F), runs layer 1 without
its cell states, forms layer 2's stacked input from layer 1's stacked h by
torch index ops, runs layer 2 and unstacks its h.

What bounds it: the serial chain of 2 x T steps (each layer's sweep), and
the products of the input projections. Unlike the TPU kernel, layer 1's
output does not stay on chip: at B = 512 it is 17 MB and layer 2's xw 69
MB, both round trips together about 50 us at 3.35 TB/s, against about 2
ms for the same two layers in torch.nn.LSTM (cuDNN); the TPU kernel's own
verdict (pallas_bilstm2.py:3-11) is that the intermediate's traffic was
not its limiter there either. Measured on an H100 80GB HBM3 at 700 W at
B = 512 (chip_smoke.py, its kernel line): 0.8456 ms against cuDNN's 1.9657
in the same run. The design before this one kept layer 1's h of a 4-row
tile in shared memory and ran float32 FMA, re-reading the weights from L2
every step: 2.1605 and 2.1174 ms against this design's 0.8351 and 0.8271,
in turns in one run (tools/torch_step_compare.py --kernels).

A CUDA tensor goes to the kernels, or the wrapper raises (F and the hidden
sizes must be multiples of 8 there, and each layer's sweep must fit a
CTA); a CPU tensor goes to the plain version, ``bilstm2_reference`` (the
composition of the plain layers; ``emulate_kernel`` runs the kernels'
split-bf16 products), also the kernels' yardstick on the card.
``bilstm2.launches`` counts this wrapper's calls that reach the kernels;
they do not move ``bilstm_train.launches``.
"""

from __future__ import annotations

from typing import Dict

import torch

from clair_tpu_torch.models.bilstm import _stack_directions, _unstack_outputs, bilstm
from clair_tpu_torch.ops.bilstm_train import (
    _forward_launch, _stack_params, bilstm_train_reference,
)
from clair_tpu_torch.ops.build import on_cuda


def _f32(params: Dict) -> Dict:
    return {d: {k: v.float() for k, v in q.items()} for d, q in params.items()}


def bilstm2_reference(params1: Dict, params2: Dict, x: torch.Tensor, *,
                      emulate_kernel: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the two plain layers in float32.
    ``emulate_kernel``: each layer as the kernels compute it, on the
    stacked layout with both products as three-piece split-bf16 products
    (``bilstm_train_reference(..., emulate_kernel=True)``)."""
    if not emulate_kernel:
        return bilstm(_f32(params2), bilstm(_f32(params1), x.float()))

    def layer(params, inputs):
        xs = _stack_directions(inputs).contiguous()
        h_out, _ = bilstm_train_reference(xs, *_stack_params(params), emulate_kernel=True)
        return _unstack_outputs(h_out, inputs.shape[0])

    return layer(params2, layer(params1, x.float()))


def _layers(params1: Dict, params2: Dict, x: torch.Tensor, cluster: int = 0, rows: int = 0):
    """Both layers on the card at a sweep geometry (0: the kernel's
    choice): (B, T, 2*H2), or None where the geometry does not launch.
    Counts no launch."""
    batch = x.shape[0]
    h_out = x
    for params in (params1, params2):
        xs = _stack_directions(h_out).contiguous()
        out = _forward_launch(xs, *_stack_params(params), with_cell=False, cluster=cluster,
                              rows=rows)
        if out is None:
            return None
        h_out = _unstack_outputs(out[0], batch)
    return h_out


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
    feat = x.shape[2]
    h1, h2 = params1["fw"]["u"].shape[0], params2["fw"]["u"].shape[0]
    want = {"1": (feat, h1), "2": (2 * h1, h2)}
    for name, params in (("1", params1), ("2", params2)):
        f, h = want[name]
        shapes = {"w": (f, 4 * h), "u": (h, 4 * h), "b": (4 * h,)}
        for d in ("fw", "bw"):
            for k, shape in shapes.items():
                t = params[d][k]
                if tuple(t.shape) != shape or t.device != x.device:
                    raise ValueError(f"params{name}[{d!r}][{k!r}] must be {shape} on "
                                     f"{x.device}, got {tuple(t.shape)} on {t.device}")
    out = _layers(params1, params2, x)
    bilstm2.launches += 1
    return out


bilstm2.launches = 0
