"""The multi-task variant-calling network as a torch module (port of
clair_tpu/models/clair.py).

  (B, 33, 8, 4) pileup tensor
    -> flatten base/channel axes -> (B, 33, 32)
    -> BiLSTM(128) -> BiLSTM(128)            CUDA kernels, chosen by the config
       (training: dropout 0.5 after the second)
    -> L3 slice dense: einsum btf,ftu->buf, flattened row-major to U*F
    -> L4 dense(192) + SELU (training: alpha-dropout 0.5)
    -> four stems dense(96) + SELU (training: alpha-dropout 0.2 each)
    -> four heads, dense + SELU *then* softmax (in float32)

Parameters keep the JAX layout and names: the module's state_dict keys are
the JAX pytree's paths joined with dots (``lstm1.fw.w``, ``l3.b``,
``head_gt21.w``), so ``params_from_jax`` / ``params_to_jax`` move weights
across unchanged. They are trainable float32 masters; under a reduced
compute dtype every parameter is cast at use, as the JAX forward does, and
the gradient flows back through the cast. Softmax runs in float32.

The BiLSTM layer is chosen as the JAX forward chooses it (clair.py:117-141),
without looking at the backend: ``use_pallas_bilstm`` (ops/bilstm.py, forward
only), else ``use_pallas_stream_bilstm`` (ops/bilstm_stream.py), else
``use_pallas_train_bilstm`` (ops/bilstm_train.py, float32 only), else the
streaming pair, the port's default. ``use_pallas_bilstm``'s layer returns
float32 whatever the compute dtype, so under bfloat16 everything after
lstm1 runs in float32 on bf16-rounded weights, as JAX promotes it there;
torch does not promote mixed matmul operands, so the products cast to the
promoted dtype explicitly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from clair_tpu.params import ModelConfig
from clair_tpu_torch.models.layers import (
    alpha_dropout, dropout, glorot_uniform, he_fan_in, selu,
)
from clair_tpu_torch.ops.bilstm import bilstm_precomputed, promoted
from clair_tpu_torch.ops.bilstm_stream import bilstm_stream
from clair_tpu_torch.ops.bilstm_train import bilstm_train

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (stem, head) pairs in output order: gt21, genotype, indel length 1 and 2
_HEADS = (("l5_1", "head_gt21"), ("l5_2", "head_genotype"),
          ("l5_3", "head_len1"), ("l5_4", "head_len2"))


def param_shapes(config: ModelConfig = ModelConfig()) -> Dict:
    """The parameter tree of clair_tpu.models.clair.init_params, as shapes."""
    t, feat = config.no_of_positions, config.feature_dim
    h1, h2 = config.lstm1_num_units, config.lstm2_num_units
    l3_in = 2 * h2

    def lstm(in_dim, hidden):
        one = {"w": (in_dim, 4 * hidden), "u": (hidden, 4 * hidden), "b": (4 * hidden,)}
        return {"fw": dict(one), "bw": dict(one)}

    def dense(in_dim, out_dim):
        return {"w": (in_dim, out_dim), "b": (out_dim,)}

    l4, l5 = config.l4_num_units, config.l5_num_units
    return {
        "lstm1": lstm(feat, h1),
        "lstm2": lstm(2 * h1, h2),
        "l3": {"w": (l3_in, t, config.l3_num_units), "b": (l3_in, config.l3_num_units)},
        "l4": dense(config.l3_num_units * l3_in, l4),
        "l5_1": dense(l4, l5),
        "l5_2": dense(l4, l5),
        "l5_3": dense(l4, l5),
        "l5_4": dense(l4, l5),
        "head_gt21": dense(l5, config.output_gt21_shape),
        "head_genotype": dense(l5, config.output_genotype_shape),
        "head_len1": dense(l5, config.output_indel_length_shape_1),
        "head_len2": dense(l5, config.output_indel_length_shape_2),
    }


def init_params(generator: torch.Generator, config: ModelConfig = ModelConfig()) -> Dict:
    """A fresh parameter tree in the JAX layout (nested dicts of float32 CPU
    tensors), drawn from ``generator`` with the JAX package's initialisers:
    glorot_uniform for the LSTM ``w`` and ``u``, he_fan_in for the L3 and
    dense weights, zero biases."""
    def draw(path, node):
        if isinstance(node, dict):
            return {k: draw(path + (k,), v) for k, v in node.items()}
        if path[-1] == "b":
            return torch.zeros(node)
        if path[0].startswith("lstm"):
            return glorot_uniform(generator, node)
        return he_fan_in(generator, node)

    return draw((), param_shapes(config))


def _module_tree(shapes: Dict, device) -> nn.Module:
    if all(isinstance(v, tuple) for v in shapes.values()):
        return nn.ParameterDict({
            k: nn.Parameter(torch.zeros(s, device=device))
            for k, s in shapes.items()
        })
    return nn.ModuleDict({k: _module_tree(v, device) for k, v in shapes.items()})


def _tensor_tree(module: nn.Module) -> Dict:
    if isinstance(module, nn.ParameterDict):
        return dict(module.items())
    return {k: _tensor_tree(m) for k, m in module.named_children()}


def _map_tree(fn, tree: Dict) -> Dict:
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """A JAX parameter pytree (nested dicts of arrays) as a state_dict."""
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            else:
                flat[prefix + k] = torch.from_numpy(np.array(v, dtype=np.float32))

    walk("", tree)
    return flat


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict:
    """A state_dict as the JAX parameter pytree of float32 numpy arrays."""
    tree: Dict = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().to("cpu", torch.float32).numpy()
    return tree


class ClairNet(nn.Module):
    """The network, its parameters in the JAX layout. Calling runs it under
    ``inference_mode``; training differentiates ``forward_logits``."""

    def __init__(self, config: ModelConfig = ModelConfig(), device=None):
        super().__init__()
        if config.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {config.compute_dtype!r} not in {sorted(COMPUTE_DTYPES)}")
        self.bilstm = select_bilstm(config)
        self.config = config
        for name, shapes in param_shapes(config).items():
            self.add_module(name, _module_tree(shapes, device))

    @classmethod
    def from_jax(cls, tree: Dict, config: ModelConfig = ModelConfig(), device=None) -> "ClairNet":
        model = cls(config, device)
        model.load_state_dict(params_from_jax(tree))
        return model

    def forward_logits(self, x: torch.Tensor, *, deterministic: bool = True,
                       generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 33, 8, 4) pileup (float32, or the int16 of the training
        feed) -> the four SELU-activated head outputs (pre-softmax) in the
        compute dtype. ``deterministic=False`` is the training forward: each
        dropout of the config whose rate is above 0 draws its mask from
        ``generator`` (on x's device)."""
        config = self.config
        if not deterministic and generator is None:
            raise ValueError("the training forward needs a generator for dropout")
        train = not deterministic
        dtype = COMPUTE_DTYPES[config.compute_dtype]
        p = {k: _tensor_tree(m) for k, m in self.named_children()}
        if dtype != torch.float32:
            p = _map_tree(lambda t: t.to(dtype), p)
        b = x.shape[0]
        h = x.reshape(b, config.no_of_positions, config.feature_dim).to(dtype)
        h = self.bilstm(p["lstm1"], h)
        if train and config.lstm1_dropout_rate > 0:
            h = dropout(generator, h, config.lstm1_dropout_rate)
        h = self.bilstm(p["lstm2"], h)
        if train and config.lstm2_dropout_rate > 0:
            h = dropout(generator, h, config.lstm2_dropout_rate)

        # L3 slice dense: per feature column, time -> units; (B, U, F) is
        # flattened row-major to U*F, and the (F, U) bias is transposed
        l3 = torch.einsum("btf,ftu->buf", *promoted(h, p["l3"]["w"]))
        l3 = selu(l3 + p["l3"]["b"].T[None]).reshape(b, -1)
        l4 = selu(_dense(p["l4"], l3))
        if train and config.l4_dropout_rate > 0:
            l4 = alpha_dropout(generator, l4, config.l4_dropout_rate)

        def stem(name):
            s = selu(_dense(p[name], l4))
            if train and config.l5_dropout_rate > 0:
                s = alpha_dropout(generator, s, config.l5_dropout_rate)
            return s

        # every head applies SELU before its softmax (trained-model contract)
        return tuple(selu(_dense(p[head], stem(name))) for name, head in _HEADS)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The four softmax probability tensors, always float32."""
        return tuple(torch.softmax(l.float(), dim=-1) for l in self.forward_logits(x))


def _dense(p: Dict, x: torch.Tensor) -> torch.Tensor:
    x, w = promoted(x, p["w"])
    return x @ w + p["b"]


def select_bilstm(config: ModelConfig) -> Callable:
    """The BiLSTM layer ``config`` selects, in the JAX forward's order
    (clair.py:117-141); the streaming pair when no flag is set. Raises
    ValueError for ``use_pallas_train_bilstm`` under a compute dtype other
    than float32, on either device (the CPU path stands for the card's)."""
    if config.use_pallas_bilstm:
        return bilstm_precomputed
    if config.use_pallas_stream_bilstm:
        return bilstm_stream
    if config.use_pallas_train_bilstm:
        if config.compute_dtype != "float32":
            raise ValueError(
                "use_pallas_train_bilstm is float32-only (the kernel "
                "computes and returns f32, which would silently defeat "
                f"compute_dtype={config.compute_dtype}); unset one of them"
            )
        return bilstm_train
    return bilstm_stream

