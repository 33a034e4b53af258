"""Clair3's full-alignment network (Clair3_F) and its training step in plain
PyTorch.

The yardstick the port's models/clair3_fa.py is held to. It follows the
published model (Zheng et al., Nature Computational Science 2:797-803,
2022; HKU-BAL/Clair3 clair3/model.py class Clair3_F, sized by
shared/param_f.py) and imports nothing but torch: not the port, not its
kernels, not the JAX package.

- Input (B, 89, 33, 8) -> float32 / 100 -> (B, 8, 89, 33).
- A 3x3 convolution is unfold (im2col) and one float32 matmul against the
  HWIO kernel read as (cout, cin * 9), plus its bias; zero padding by TF's
  'SAME' rule (symmetric 1 on odd sizes).
- Batch norm in training: the batch's mean and biased variance over
  (B, H, W), computed explicitly, eps 1e-3, then scale and shift; the
  running statistics r <- 0.99 r + 0.01 batch, the variance's with
  n / (n - 1) (Keras' fused layer). Without masks (evaluation) the running
  statistics normalise.
- ConvBN = ReLU(BN(conv)); BasicBlock = ReLU(BN2(conv(ReLU(BN1(conv(x))))) + x);
  three stages of stride-2 ConvBN and one block, 64, 128 and 256 channels.
- Pyramid pooling: for n in (3, 2, 1), an explicit max over windows of
  stride = size (ceil(H / n), ceil(W / n)) on the map padded with -inf by
  TF's 'SAME' rule, each flattened in (h, w, c) order, concatenated; a
  window's gradient goes to its first maximum, as TF's max pool sends it.
- Head: dropout 0.2, L4 dense + SELU, dropout 0.5, four stems dense + SELU
  and dropout 0.2 each, four heads dense + SELU: the logits.
- Loss: the focal loss (gamma 2) of each head's softmax against its span of
  the 90-wide label, summed over rows and classes, plus
  lambda * sum(w^2) / 2 over the conv and dense kernels alone (Clair3's
  ``kernel_regularizer``: no bias, no batch-norm scale or shift).
- Step: the gradient clipped to a global norm of 5 (g * 5 / norm when the
  norm reaches 5), then Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected).

Departures from Clair3, the port's as well: Adam with the clip in place of
Clair3's RAdam + Lookahead; the port's focal loss without Clair3's
class-balanced weights; the L2 term as the port writes it (lambda times
half the sum of squares; Keras' l2 adds lambda times the sum); dropout is
plain inverted dropout (Keras' Dropout, as Clair3 uses). Calling is not
covered.

Dropout masks are ``torch.rand(shape) < keep``, drawn by the caller from a
generator seeded as the program's, per step in the program's order: SPP
features, L4, the four stems, each at its layer's full shape.

Everything computes in float32 with cuBLAS's and cuDNN's TF32 off.
``precision`` "tf32" puts the lower precision in place for a control: on a
CUDA device cuBLAS's own TF32 products, on the CPU each product's operands
rounded to TF32's 10-bit mantissa. "float64" computes the same steps in
float64: the first stage's gradients (through batch norm, over 1.5M
positions a channel at 89 x 33) carry float32 round-off of 1e-4 to 6e-3
of their norm, which float64 takes out. A step's batch is computed whole:
batch norm's statistics are the whole batch's.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946
# the heads' spans of the 90-wide label: gt21, genotype, two indel lengths
SPANS = ((0, 21), (21, 24), (24, 57), (57, 90))
STEMS = ("l5_1", "l5_2", "l5_3", "l5_4")
HEADS = ("head_gt21", "head_genotype", "head_len1", "head_len2")
KERNEL = 3


def _same(size: int, window: int, stride: int) -> Tuple[int, int, int]:
    """TF's 'SAME': (output size, padding before, padding after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return out, total // 2, total - total // 2


def convs(model: Dict) -> List[Tuple[str, int, int, int, Tuple[int, int]]]:
    """(name, cin, cout, stride, output (height, width)) of every
    convolution in the trunk's order."""
    height, width, cin = model["input_shape"]
    out = []
    for stage, cout in enumerate(model["stage_channels"], start=1):
        height, width = _same(height, KERNEL, 2)[0], _same(width, KERNEL, 2)[0]
        out += [(f"conv{stage}", cin, cout, 2, (height, width)),
                (f"block{stage}.conv1", cout, cout, 1, (height, width)),
                (f"block{stage}.conv2", cout, cout, 1, (height, width))]
        cin = cout
    return out


def pyramid_width(model: Dict) -> int:
    height, width = convs(model)[-1][4]
    cells = 0
    for n in model["spp_bins"]:
        kh, kw = -(-height // n), -(-width // n)
        cells += _same(height, kh, kh)[0] * _same(width, kw, kw)[0]
    return cells * model["stage_channels"][-1]


def param_shapes(model: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape, by the port's state_dict names."""
    shapes = {}
    for name, cin, cout, _, _ in convs(model):
        shapes.update({f"{name}.w": (KERNEL, KERNEL, cin, cout), f"{name}.b": (cout,),
                       f"{name}.bn.s": (cout,), f"{name}.bn.b": (cout,)})
    l4, l5 = model["l4_num_units"], model["l5_num_units"]
    shapes.update({"l4.w": (pyramid_width(model), l4), "l4.b": (l4,)})
    outs = (model["output_gt21_shape"], model["output_genotype_shape"],
            model["output_indel_length_shape_1"], model["output_indel_length_shape_2"])
    for stem, head, out in zip(STEMS, HEADS, outs):
        shapes.update({f"{stem}.w": (l4, l5), f"{stem}.b": (l5,),
                       f"{head}.w": (l5, out), f"{head}.b": (out,)})
    return shapes


def initial_stats(model: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Running statistics before any step: mean 0, variance 1."""
    stats = {}
    for name, _, cout, _, _ in convs(model):
        stats[f"{name}.bn.mean"] = torch.zeros(cout, device=device)
        stats[f"{name}.bn.var"] = torch.ones(cout, device=device)
    return stats


def draw_masks(model: Dict, batch: int, generator: torch.Generator,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """One step's keep masks, by layer, in the order the model draws them."""
    widths = (("spp", pyramid_width(model), model["l3_dropout_rate"]),
              ("l4", model["l4_num_units"], model["l4_dropout_rate"]),
              *((s, model["l5_num_units"], model["l5_dropout_rate"]) for s in STEMS))
    return {name: torch.rand((batch, width), generator=generator, device=device) < 1.0 - rate
            for name, width, rate in widths if rate > 0}


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round to nearest (ties away) at TF32's 10-bit mantissa."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return fn(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


def rounding(precision: str, device: torch.device) -> Optional[Callable]:
    """What each product's operands go through under ``precision``."""
    if precision in ("float32", "float64") or (precision == "tf32" and device.type == "cuda"):
        return None
    if precision != "tf32":
        raise ValueError(f"precision {precision!r} is not float32, float64 or tf32")
    return lambda t: _Round.apply(t, _tf32)


@contextlib.contextmanager
def products(precision: str):
    """cuBLAS and cuDNN in float32, or in TF32 for the "tf32" control."""
    tf32 = precision == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def selu(x: torch.Tensor) -> torch.Tensor:
    return SELU_SCALE * torch.where(x >= 0.0, x, SELU_ALPHA * torch.expm1(torch.clamp(x, max=0.0)))


def _conv(p: Dict, name: str, x: torch.Tensor, stride: int, r: Callable) -> torch.Tensor:
    """conv3x3(x) + b as im2col and one matmul; x (B, C, H, W)."""
    b, cin, height, width = x.shape
    oh, top, bottom = _same(height, KERNEL, stride)
    ow, left, right = _same(width, KERNEL, stride)
    cols = F.unfold(F.pad(x, (left, right, top, bottom)), KERNEL, stride=stride)
    w = p[f"{name}.w"]  # (kh, kw, cin, cout); unfold's rows run (cin, kh, kw)
    w = w.permute(3, 2, 0, 1).reshape(w.shape[3], -1)
    out = torch.matmul(r(w), r(cols)) + p[f"{name}.b"][:, None]
    return out.view(b, -1, oh, ow)


def _batch_norm(p: Dict, stats: Dict, new_stats: Optional[Dict], name: str, h: torch.Tensor,
                model: Dict) -> torch.Tensor:
    """Training (``new_stats`` given): the batch's statistics, and the
    updated running ones into ``new_stats``; else the running ones."""
    if new_stats is None:
        mean, var = stats[f"{name}.bn.mean"], stats[f"{name}.bn.var"]
    else:
        mean = h.mean(dim=(0, 2, 3))
        var = ((h - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
        n = h.numel() // h.shape[1]
        m = model["bn_momentum"]
        new_stats[f"{name}.bn.mean"] = m * stats[f"{name}.bn.mean"] + (1 - m) * mean.detach()
        new_stats[f"{name}.bn.var"] = (m * stats[f"{name}.bn.var"]
                                       + (1 - m) * var.detach() * n / (n - 1))
    scale = p[f"{name}.bn.s"] / torch.sqrt(var + model["bn_eps"])
    return ((h - mean[None, :, None, None]) * scale[None, :, None, None]
            + p[f"{name}.bn.b"][None, :, None, None])


def pyramid_pool(h: torch.Tensor, bins: Sequence[int]) -> torch.Tensor:
    """The explicit windowed max of each bin count, flattened (h, w, c)."""
    b, c, height, width = h.shape
    parts = []
    for n in bins:
        kh, kw = -(-height // n), -(-width // n)
        oh, top, bottom = _same(height, kh, kh)
        ow, left, right = _same(width, kw, kw)
        padded = F.pad(h, (left, right, top, bottom), value=-math.inf)
        windows = padded.view(b, c, oh, kh, ow, kw).permute(0, 1, 2, 4, 3, 5)
        # max over dim passes the gradient to the first maximum (row-major in
        # the window), as TF's max pool does: cells of empty read rows tie
        pooled = windows.reshape(b, c, oh, ow, kh * kw).max(dim=-1).values
        parts.append(pooled.permute(0, 2, 3, 1).reshape(b, -1))
    return torch.cat(parts, dim=1)


def forward(p: Dict, stats: Dict, x: torch.Tensor, model: Dict,
            masks: Optional[Dict] = None, r: Optional[Callable] = None,
            new_stats: Optional[Dict] = None) -> List[torch.Tensor]:
    """The four heads' logits (pre-softmax) of a (B, 89, 33, 8) float32
    batch. With ``masks`` (the training forward): batch statistics, whose
    running update goes into ``new_stats`` where given, and dropout where a
    layer has a keep mask; without: the running statistics ``stats``."""
    r = r or (lambda t: t)
    train = masks is not None
    masks = masks or {}
    if train and new_stats is None:
        new_stats = {}
    h = (x / model["normalize"]).permute(0, 3, 1, 2)
    for name, _, _, stride, _ in convs(model):
        if name.endswith(".conv1"):
            shortcut = h
        out = _batch_norm(p, stats, new_stats if train else None, name,
                          _conv(p, name, h, stride, r), model)
        h = torch.relu(out + shortcut if name.endswith(".conv2") else out)
    h = pyramid_pool(h, model["spp_bins"])

    def drop(name, t, rate):
        return torch.where(masks[name], t / (1.0 - rate), 0.0) if name in masks else t

    h = drop("spp", h, model["l3_dropout_rate"])
    l4 = drop("l4", selu(r(h) @ r(p["l4.w"]) + p["l4.b"]), model["l4_dropout_rate"])
    logits = []
    for stem, head in zip(STEMS, HEADS):
        s = drop(stem, selu(r(l4) @ r(p[f"{stem}.w"]) + p[f"{stem}.b"]), model["l5_dropout_rate"])
        logits.append(selu(r(s) @ r(p[f"{head}.w"]) + p[f"{head}.b"]))
    return logits


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float,
               row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    p = torch.softmax(logits, dim=-1)
    positive = labels > 0
    pos = torch.where(positive, labels - p, 0.0) ** gamma * torch.log(p.clamp(1e-8, 1.0))
    neg = torch.where(positive, 0.0, p) ** gamma * torch.log((1.0 - p).clamp(1e-8, 1.0))
    per_entry = -(pos + neg)
    if row_weights is not None:
        per_entry = per_entry * row_weights[:, None]
    return per_entry.sum()


def task_loss(logits: Sequence[torch.Tensor], y: torch.Tensor, gamma: float,
              weights: Sequence[float], row_weights: Optional[torch.Tensor] = None):
    return sum(w * focal_loss(lg, y[:, a:b], gamma, row_weights)
               for w, lg, (a, b) in zip(weights, logits, SPANS))


def l2_term(p: Dict) -> torch.Tensor:
    """Half the sum of squares of the conv and dense kernels."""
    return sum(0.5 * torch.sum(v * v) for k, v in p.items() if k.endswith(".w"))


class Adam:
    def __init__(self, lr: float, betas: Tuple[float, float], eps: float):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m: Dict = {}
        self.v: Dict = {}
        self.t = 0

    def update(self, p: Dict, g: Dict) -> None:
        self.t += 1
        for k in p:
            m = self.m[k] = self.b1 * self.m.get(k, 0.0) + (1 - self.b1) * g[k]
            v = self.v[k] = self.b2 * self.v.get(k, 0.0) + (1 - self.b2) * g[k] * g[k]
            m_hat = m / (1 - self.b1 ** self.t)
            v_hat = v / (1 - self.b2 ** self.t)
            p[k] = p[k] - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)


def gradient(p: Dict, stats: Dict, x: torch.Tensor, y: torch.Tensor, model: Dict,
             training: Dict, masks: Dict, r: Optional[Callable] = None,
             row_weights: Optional[torch.Tensor] = None) -> Tuple[float, Dict, Dict]:
    """(loss, {leaf: gradient}, running statistics after the step) of one
    batch, computed whole. x: (B, 89, 33, 8) float32; y: (B, 90) float32."""
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    weights = model["task_loss_weights"]
    new_stats: Dict = {}
    logits = forward(leaves, stats, x, model, masks, r, new_stats)
    loss = (task_loss(logits, y, training["focal_gamma"], weights, row_weights)
            + training["l2_lambda"] * weights[4] * l2_term(leaves))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return loss.item(), grads, new_stats


def clip(grads: Dict, max_norm: float) -> Dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    if norm < max_norm:
        return grads
    return {k: g / norm * max_norm for k, g in grads.items()}


def train(p0: Dict, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], masks: Sequence[Dict],
          model: Dict, training: Dict, precision: str = "float32",
          fault: Optional[Callable] = None, stats0: Optional[Dict] = None) -> Dict:
    """The reference's steps over ``batches`` from ``p0`` (and the running
    statistics ``stats0``, by default the initial ones): {"losses": each
    step's loss, "grad": step 1's clipped gradient by leaf (what Adam
    receives), "params": the parameters after the last step, "stats": the
    running statistics after it}. ``fault``, where given, is called as
    fault(step, grads) -> grads before the clip, or fault(step, None) ->
    row weights of the step's loss (a calibration's planted faults)."""
    device = next(iter(p0.values())).device
    r = rounding(precision, device)
    dtype = torch.float64 if precision == "float64" else torch.float32
    p = {k: v.detach().to(dtype).clone() for k, v in p0.items()}
    stats = dict(stats0) if stats0 is not None else initial_stats(model, device)
    stats = {k: v.to(dtype) for k, v in stats.items()}
    adam = Adam(training["learning_rate"], tuple(training["adam_betas"]), training["adam_eps"])
    losses, first = [], None
    with products(precision):
        for step, ((x, y), m) in enumerate(zip(batches, masks)):
            row_weights = fault(step, None) if fault is not None else None
            loss, g, stats = gradient(p, stats, x.to(dtype), y.to(dtype), model, training, m, r,
                                      row_weights)
            if fault is not None:
                g = fault(step, g)
            g = clip(g, training["clip_norm"])
            if first is None:
                first = {k: v.clone() for k, v in g.items()}
            adam.update(p, g)
            losses.append(loss)
    return {"losses": losses, "grad": first, "params": p, "stats": stats}
