"""Clair3's full-alignment network, Clair3_F (Zheng et al., Nature
Computational Science 2:797-803, 2022; HKU-BAL/Clair3 clair3/model.py
class Clair3_F, sized by shared/param_f.py), as a torch module.

  (B, 89, 33, 8) full-alignment matrix: read rows x positions x channels
    (int16 from the training feed, or float32)
    -> float32 / 100 (Clair3's NORMALIZE_NUM), laid out NCHW (B, 8, 89, 33)
    -> ConvBN(8 -> 64, stride 2), BasicBlock(64)        45 x 17
    -> ConvBN(64 -> 128, stride 2), BasicBlock(128)     23 x 9
    -> ConvBN(128 -> 256, stride 2), BasicBlock(256)    12 x 5
    -> spatial pyramid pooling over 3x3, 2x2, 1x1 bins: 14 x 256 = 3,584
    -> (training: dropout 0.2) -> L4 dense(256) + SELU (training: dropout 0.5)
    -> four stems dense(128) + SELU (training: dropout 0.2 each)
    -> four heads dense(21 / 3 / 33 / 33) + SELU: the logits; softmax in float32

ConvBN(x) = ReLU(BN(conv3x3(x) + b)); BasicBlock(x) = ReLU(BN2(conv3x3(
ReLU(BN1(conv3x3(x) + b1))) + b2) + x). Convolutions pad as TF's 'SAME'
does (symmetric 1 on every odd size, which all of Clair3's are). Batch
norm in the training forward normalises with the batch's mean and biased
variance over (B, H, W) and updates the running statistics as Keras' fused
layer does, r <- 0.99 r + 0.01 batch with the unbiased variance; every
other forward uses the running statistics. Pyramid pooling takes, for n
bins, windows and strides of (ceil(H / n), ceil(W / n)) under TF's 'SAME'
rule (a window past the edge takes the max of what lies inside it), each
map flattened in (h, w, c) order as Keras' Flatten does. Dropout is plain
inverted dropout (models/layers.py:dropout), its masks drawn from the
caller's generator in the order SPP features, L4, the four stems.

Parameters are float32 and named in the port's style (``conv1.w`` HWIO
(3, 3, cin, cout), ``conv1.b``, ``conv1.bn.s`` scale, ``conv1.bn.b``
shift; ``block1.conv1.w``; ``l4.w``, ``l5_1.w``, ``head_gt21.w``); the
running statistics are buffers (``conv1.bn.mean``, ``conv1.bn.var``), so
``state_dict`` and the checkpoints carry them. The model computes in
float32 only: a float32 convolution or matmul must not run in TF32, and
``float32_products`` is the scope that keeps cuDNN and cuBLAS from it.

The six stride-1 convolutions (the BasicBlocks' conv1 and conv2) run on
ops/conv3x3.py: a hand-written kernel on the card, float32 products as three
bf16 pieces on the tensor cores, and its plain version (the same piece
arithmetic) on the CPU; the three stride-2 convolutions on cuDNN.

Spans (utils/trace.py): ``fa.trunk`` around the three stages, ``fa.stage``
around each (value: the stage, 1-3), ``fa.pool`` and ``fa.heads``; the
counter ``fa.conv`` records each convolution of a forward, 1 where it takes
ops/conv3x3.py and 0 where it takes cuDNN.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clair_tpu_torch.models.clair import params_from_jax
from clair_tpu_torch.models.layers import dropout, he_fan_in, selu
from clair_tpu_torch.ops.conv3x3 import conv3x3
from clair_tpu_torch.utils import trace

# Clair3's training batch (shared/param_f.py trainBatchSize) and the L2
# lambda assumed for it (the repository holds no copy of param_f.py)
FA_TRAIN_BATCH_SIZE = 2_000
FA_L2_LAMBDA = 1e-4
KERNEL = 3
# (stem, head) pairs in output order: gt21, genotype, indel length 1 and 2
HEADS = (("l5_1", "head_gt21"), ("l5_2", "head_genotype"),
         ("l5_3", "head_len1"), ("l5_4", "head_len2"))


@dataclasses.dataclass(frozen=True)
class FullAlignmentConfig:
    """Clair3_F's sizes and training recipe (Clair3's defaults). Not a
    ``params.ModelConfig``: that one's fields are held to the JAX
    package's."""

    # read rows (ONT's matrix_depth), positions, channels
    input_shape: tuple = (89, 33, 8)
    normalize: float = 100.0
    # each stage: a stride-2 ConvBN and one BasicBlock (Clair3_F's)
    stage_channels: tuple = (64, 128, 256)
    spp_bins: tuple = (3, 2, 1)
    l3_dropout_rate: float = 0.2
    l4_num_units: int = 256
    l4_dropout_rate: float = 0.5
    l5_num_units: int = 128
    l5_dropout_rate: float = 0.2
    output_gt21_shape: int = 21
    output_genotype_shape: int = 3
    output_indel_length_shape_1: int = 33
    output_indel_length_shape_2: int = 33
    # Keras' BatchNormalization defaults
    bn_eps: float = 1e-3
    bn_momentum: float = 0.99
    # task loss weights: gt21, genotype, len1, len2, l2
    task_loss_weights: tuple = (1.0, 1.0, 1.0, 1.0, 1.0)
    optimizer_name: str = "Adam"
    loss_function: str = "FocalLoss"
    compute_dtype: str = "float32"

    @property
    def outputs(self) -> Tuple[int, int, int, int]:
        return (self.output_gt21_shape, self.output_genotype_shape,
                self.output_indel_length_shape_1, self.output_indel_length_shape_2)


def same_padding(size: int, window: int, stride: int) -> Tuple[int, int, int]:
    """TF's 'SAME' rule: (output size, padding before, padding after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return out, total // 2, total - total // 2


def conv_layers(config: FullAlignmentConfig) -> List[Tuple[str, int, int, int, Tuple[int, int]]]:
    """(name, cin, cout, stride, (height, width) of the output) of every
    convolution, in the order the trunk runs them."""
    height, width, cin = config.input_shape
    layers = []
    for stage, cout in enumerate(config.stage_channels, start=1):
        height, width = (same_padding(height, KERNEL, 2)[0], same_padding(width, KERNEL, 2)[0])
        layers += [(f"conv{stage}", cin, cout, 2, (height, width)),
                   (f"block{stage}.conv1", cout, cout, 1, (height, width)),
                   (f"block{stage}.conv2", cout, cout, 1, (height, width))]
        cin = cout
    return layers


def spp_features(config: FullAlignmentConfig) -> int:
    """The pyramid's width: the bins' cells times the last stage's channels."""
    height, width = conv_layers(config)[-1][4]
    cells = sum(same_padding(height, -(-height // n), -(-height // n))[0]
                * same_padding(width, -(-width // n), -(-width // n))[0]
                for n in config.spp_bins)
    return cells * config.stage_channels[-1]


def param_shapes(config: FullAlignmentConfig = FullAlignmentConfig()) -> Dict[str, tuple]:
    """Every parameter's shape by its state_dict name, in the module's
    order (the running statistics are buffers, not parameters)."""
    shapes = {}
    for name, cin, cout, _, _ in conv_layers(config):
        shapes.update({f"{name}.w": (KERNEL, KERNEL, cin, cout), f"{name}.b": (cout,),
                       f"{name}.bn.s": (cout,), f"{name}.bn.b": (cout,)})
    l4, l5 = config.l4_num_units, config.l5_num_units
    shapes.update({"l4.w": (spp_features(config), l4), "l4.b": (l4,)})
    for (stem, head), out in zip(HEADS, config.outputs):
        shapes.update({f"{stem}.w": (l4, l5), f"{stem}.b": (l5,),
                       f"{head}.w": (l5, out), f"{head}.b": (out,)})
    return shapes


def init_params(generator: torch.Generator,
                config: FullAlignmentConfig = FullAlignmentConfig()) -> Dict:
    """A fresh parameter tree in the JAX layout (nested dicts of float32 CPU
    tensors), running statistics included: conv and dense kernels from
    ``he_fan_in`` (HWIO, so the receptive field counts in the fan), zero
    biases, batch norm's scale 1 and shift 0, running mean 0 and variance 1.
    Clair3's Keras layers start their kernels glorot-uniform; the port's
    fan-in rule is used here, as for ClairNet's dense layers."""
    tree: Dict = {}
    for key, shape in param_shapes(config).items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if leaf == "w":
            node[leaf] = he_fan_in(generator, shape)
        else:
            node[leaf] = torch.ones(shape) if leaf == "s" else torch.zeros(shape)
        if path[-1] == "bn" and leaf == "b":
            node.update(mean=torch.zeros(shape), var=torch.ones(shape))
    return tree


@contextlib.contextmanager
def float32_products() -> Iterator[None]:
    """cuDNN's and cuBLAS's TF32 switched off for the process while inside,
    restored after. The switches are process-wide and read when a
    convolution or product is launched, and autograd launches the
    backward's (dgrad, wgrad) from its own device thread after the
    forward's scope has closed: so the scope must hold the whole step,
    backward included, and the training loop opens it around the run
    (pipeline/train.py:train_model); a scope around the forward alone would
    leave the backward in TF32 (cuDNN's default)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class _BatchNorm(nn.Module):
    def __init__(self, channels: int, device):
        super().__init__()
        self.s = nn.Parameter(torch.ones(channels, device=device))
        self.b = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))


class _ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(KERNEL, KERNEL, cin, cout, device=device))
        self.b = nn.Parameter(torch.zeros(cout, device=device))
        self.bn = _BatchNorm(cout, device)


class _Dense(nn.Module):
    def __init__(self, cin: int, cout: int, device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cin, cout, device=device))
        self.b = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class Clair3FANet(nn.Module):
    """Clair3_F with the surface the port's train and eval steps use
    (``forward_logits``, ``forward``, ``config``, ``tensor_parallel``)."""

    def __init__(self, config: FullAlignmentConfig = FullAlignmentConfig(), device=None):
        super().__init__()
        if config.compute_dtype != "float32":
            raise ValueError(f"Clair3FANet computes in float32 only, not {config.compute_dtype!r}")
        self.config = config
        self.tensor_parallel = None
        self.strides = {}
        for name, cin, cout, stride, _ in conv_layers(config):
            parent, _, leaf = name.rpartition(".")
            owner = self
            if parent:
                if not hasattr(self, parent):
                    self.add_module(parent, nn.Module())
                owner = getattr(self, parent)
            owner.add_module(leaf, _ConvBN(cin, cout, device))
            self.strides[name] = stride
        shapes = param_shapes(config)
        for name in ("l4",) + tuple(n for pair in HEADS for n in pair):
            self.add_module(name, _Dense(*shapes[f"{name}.w"], device))

    @classmethod
    def from_jax(cls, tree: Dict, config: FullAlignmentConfig = FullAlignmentConfig(),
                 device=None) -> "Clair3FANet":
        """A Clair3FANet holding ``tree`` (parameters and running statistics
        in the JAX layout, as init_params and the checkpoints give them)."""
        model = cls(config, device)
        model.load_state_dict(params_from_jax(tree))
        return model

    def _conv_bn(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        """BN(conv3x3(x) + b), TF 'SAME' zero padding: a stride-1 convolution
        on ops/conv3x3.py (the kernel on the card), the stride-2 ones on
        cuDNN. The counter ``fa.conv`` records 1 or 0 for each."""
        layer = self.get_submodule(name)
        stride = self.strides[name]
        trace.count("fa.conv", int(stride == 1))
        if stride == 1:
            y = conv3x3(x, layer.w, layer.b)
        else:
            (_, top, bottom), (_, left, right) = (same_padding(x.shape[2], KERNEL, stride),
                                                  same_padding(x.shape[3], KERNEL, stride))
            padding = (top, left)
            if (top, left) != (bottom, right):
                x, padding = F.pad(x, (left, right, top, bottom)), 0
            # HWIO -> OIHW
            y = F.conv2d(x, layer.w.permute(3, 2, 0, 1), layer.b, stride=stride, padding=padding)
        bn = layer.bn
        return F.batch_norm(y, bn.mean, bn.var, bn.s, bn.b, training=train,
                            momentum=1.0 - self.config.bn_momentum, eps=self.config.bn_eps)

    def forward_logits(self, x: torch.Tensor, *, deterministic: bool = True,
                       generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 89, 33, 8) matrices (int16 or float32) -> the four
        SELU-activated head outputs (pre-softmax), float32.
        ``deterministic=False`` is the training forward: batch norm on the
        batch's statistics (updating the running ones) and dropout from
        ``generator`` (on x's device)."""
        if not deterministic and generator is None:
            raise ValueError("the training forward needs a generator for dropout")
        config = self.config
        train = not deterministic
        if tuple(x.shape[1:]) != tuple(config.input_shape):
            raise ValueError(f"rows of shape {tuple(x.shape[1:])}; the model takes "
                             f"{tuple(config.input_shape)}")
        with trace.span("fa.trunk"):
            h = (x.float() / config.normalize).permute(0, 3, 1, 2).contiguous()
            for stage in range(1, len(config.stage_channels) + 1):
                with trace.span("fa.stage", value=stage):
                    h = torch.relu(self._conv_bn(f"conv{stage}", h, train))
                    inner = torch.relu(self._conv_bn(f"block{stage}.conv1", h, train))
                    h = torch.relu(self._conv_bn(f"block{stage}.conv2", inner, train) + h)
        with trace.span("fa.pool"):
            h = spatial_pyramid_pool(h, config.spp_bins)
        with trace.span("fa.heads"):
            if train:
                h = dropout(generator, h, config.l3_dropout_rate)
            l4 = selu(self.l4(h))
            if train:
                l4 = dropout(generator, l4, config.l4_dropout_rate)
            logits = []
            for stem, head in HEADS:
                s = selu(getattr(self, stem)(l4))
                if train:
                    s = dropout(generator, s, config.l5_dropout_rate)
                logits.append(selu(getattr(self, head)(s)))
        return tuple(logits)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The four softmax probability tensors, float32."""
        return tuple(torch.softmax(l.float(), dim=-1) for l in self.forward_logits(x))


def spatial_pyramid_pool(h: torch.Tensor, bins: Tuple[int, ...]) -> torch.Tensor:
    """(B, C, H, W) -> (B, sum of the bins' cells x C): for n bins, a max
    over windows of stride = size (ceil(H / n), ceil(W / n)), padded as TF's
    'SAME' with -inf, each map flattened in (h, w, c) order."""
    height, width = h.shape[2:]
    parts = []
    for n in bins:
        kh, kw = -(-height // n), -(-width // n)
        (_, top, bottom), (_, left, right) = (same_padding(height, kh, kh),
                                              same_padding(width, kw, kw))
        padded = F.pad(h, (left, right, top, bottom), value=-math.inf)
        pooled = F.max_pool2d(padded, (kh, kw), (kh, kw))
        parts.append(pooled.permute(0, 2, 3, 1).reshape(h.shape[0], -1))
    return torch.cat(parts, dim=1)
