"""The model axis: the dense trunk split Megatron-style over the mesh's
'model' groups (port of the model half of clair_tpu/parallel/sharding.py).

The JAX package shards L4 column-parallel (its output dimension) and the
four L5 stems row-parallel (their input dimension) over the 'model' axis,
and GSPMD inserts the collectives. Here each rank of a model group holds
its shard, and the collectives are explicit, on the group:

- ``copy_to_model`` on L4's input: the identity forward; backward, the
  input's gradient, of which each rank computed the part its columns give,
  is all-reduced.
- ``reduce_from_model`` on each stem's partial product, before its bias:
  an all-reduce forward, the identity backward. The gradient after the sum
  is the same on every rank already; ``torch.distributed.nn.functional.
  all_reduce`` would sum it again in its backward, multiplying it by m.
  The L2 term and the clip's norm sum their sharded parts the same way
  (parallel/sharding.py).

Sums run in float32 (a bfloat16 part is cast up and the sum cast back).
Everything else is replicated: every rank of a model group computes it on
the same stripe with the same dropout masks (models/clair.py), so its
copies stay equal without a collective.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from clair_tpu_torch.models.clair import params_to_jax

MODEL_AXIS = "model"


def shard_dim(name: str) -> Optional[int]:
    """The dimension along which the model axis splits the parameter
    ``name`` (a state_dict key such as ``l4.w``), or None where it is
    replicated: the JAX rule (clair_tpu/parallel/sharding.py: param_specs),
    L4's weight on 1 and its bias on 0, each stem's weight on 0."""
    layer, leaf = name.split(".")[0], name.rsplit(".", 1)[-1]
    if layer == "l4":
        return 1 if leaf == "w" else 0
    if layer.startswith("l5_") and leaf == "w":
        return 0
    return None


def param_specs(params: Dict) -> Dict:
    """``shard_dim`` of every leaf of a JAX-layout parameter tree, in the
    tree's shape."""
    def walk(prefix: str, node: Dict) -> Dict:
        return {k: walk(f"{prefix}{k}.", v) if isinstance(v, dict) else shard_dim(prefix + k)
                for k, v in node.items()}

    return walk("", params)


def shard_params(full_params: Dict, model_index: int, model_parallel: int) -> Dict:
    """Model column ``model_index``'s shard of a JAX-layout parameter tree
    (arrays or tensors): block ``model_index`` of ``model_parallel`` along
    each sharded leaf's dimension, as a NamedSharding lays a 'model' axis
    out. Raises ValueError where that dimension does not divide (L4's
    units by the model axis), as jax.device_put does."""
    def cut(dim: Optional[int], leaf, name: str):
        if dim is None:
            return leaf
        size = leaf.shape[dim]
        if size % model_parallel != 0:
            raise ValueError(
                f"{name} of shape {tuple(leaf.shape)}: dimension {dim} should be divisible by "
                f"{model_parallel} (--model_parallel must divide l4_num_units)")
        width = size // model_parallel
        index = [slice(None)] * len(leaf.shape)
        index[dim] = slice(model_index * width, (model_index + 1) * width)
        return leaf[tuple(index)]

    def walk(prefix: str, node: Dict, specs: Dict) -> Dict:
        return {k: walk(f"{prefix}{k}.", v, specs[k]) if isinstance(v, dict)
                else cut(specs[k], v, prefix + k) for k, v in node.items()}

    return walk("", full_params, param_specs(full_params))


def gather_params(model, mesh) -> Dict:
    """The full parameters of ``model`` (a ClairNet holding this rank's
    shard) in the JAX layout, float32 numpy: each sharded leaf all-gathered
    over the mesh's 'model' group. A collective: every rank of the group
    calls it, and every rank gets the full arrays."""
    group = mesh.get_group(MODEL_AXIS)
    state = {}
    for name, value in model.state_dict().items():
        dim = shard_dim(name)
        if dim is not None and group.size() > 1:
            parts = [torch.empty_like(value) for _ in range(group.size())]
            dist.all_gather(parts, value.contiguous(), group=group)
            value = torch.cat(parts, dim)
        state[name] = value
    return params_to_jax(state)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group``, in float32, returned in x's dtype."""
    total = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(total, group=group)
    return total.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the model axis: the 'model' group of its data
    row, its column ``index`` and the axis' ``size`` (> 1)."""

    group: object
    index: int
    size: int

    @classmethod
    def of(cls, mesh) -> Optional["TensorParallel"]:
        """The mesh's model axis for this rank; None where it is 1 wide."""
        group = mesh.get_group(MODEL_AXIS)
        if group.size() == 1:
            return None
        return cls(group, mesh.get_local_rank(MODEL_AXIS), group.size())

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """The identity; its gradient summed over the group."""
        return _CopyToModel.apply(x, self.group)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the group; its gradient passed through."""
        return _ReduceFromModel.apply(x, self.group)
