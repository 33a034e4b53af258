"""Clair v2's "2BiLSTM" network and its training step in plain PyTorch.

The yardstick that decides whether a benchmark run is correct. It follows
the published model (Clair, clair/model.py:61-105), as the port's
``ModelConfig`` sizes it, and imports nothing but torch: not the port, not
its plain kernel versions, not the JAX package.

- Input (B, 33, 8, 4) -> (B, 33, 32).
- Two bidirectional LSTMs (gate order i, f, g, o, one bias, no forget-gate
  offset; the backward direction runs on the reversed sequence and its
  outputs are reversed back; outputs [forward, backward] on features).
  Inverted dropout after each whose rate is above 0.
- L3, a dense layer per feature column over time: einsum btf,ftu->buf plus
  the (F, U) bias transposed, SELU, flattened row-major to U * F.
- L4 dense + SELU, alpha-dropout; four stems dense + SELU, alpha-dropout
  each; four heads dense + SELU: the logits.
- Loss: the focal loss (gamma 2) of each head's softmax against its span
  of the 90-wide label, summed over rows and classes, plus
  lambda * sum(w^2) / 2 over every weight but the biases.
- Step: the gradient, clipped to a global norm of 5 (g * 5 / norm when the
  norm reaches 5), then Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected).

Dropout masks are ``torch.rand(shape) < keep`` from a generator seeded by
the caller, drawn per step in layer order (lstm1, lstm2, L4, the four
stems), each at its layer's full shape: the draws a ``torch.Generator``
with the same seed gives the model, so both sides drop the same units.

Everything computes in float32. ``precision`` puts a lower precision in
place for the benchmark's control: "tf32" (on a CUDA device cuBLAS's own
TF32 products; on the CPU each product's operands rounded to TF32's 10-bit
mantissa) or "fp8" (each product's operands, and in the backward the
gradient each product receives, rounded to float8 e4m3 scaled per tensor
to its largest magnitude). A step runs in blocks of rows so that it fits
beside anything else on the device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946
ALPHA_DROPOUT_VALUE = -SELU_SCALE * SELU_ALPHA
# the heads' spans of the 90-wide label: gt21, genotype, two indel lengths
SPANS = ((0, 21), (21, 24), (24, 57), (57, 90))
STEMS = ("l5_1", "l5_2", "l5_3", "l5_4")
HEADS = ("head_gt21", "head_genotype", "head_len1", "head_len2")


def param_shapes(model: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's shape, by the port's state_dict names."""
    t, rows, channels = model["input_shape"]
    feat = rows * channels
    h1, h2 = model["lstm1_num_units"], model["lstm2_num_units"]
    l3_in, l3, l4, l5 = 2 * h2, model["l3_num_units"], model["l4_num_units"], model["l5_num_units"]
    shapes = {}
    for name, in_dim, hidden in (("lstm1", feat, h1), ("lstm2", 2 * h1, h2)):
        for d in ("fw", "bw"):
            shapes.update({f"{name}.{d}.w": (in_dim, 4 * hidden),
                           f"{name}.{d}.u": (hidden, 4 * hidden),
                           f"{name}.{d}.b": (4 * hidden,)})
    shapes.update({"l3.w": (l3_in, t, l3), "l3.b": (l3_in, l3),
                   "l4.w": (l3 * l3_in, l4), "l4.b": (l4,)})
    outs = (model["output_gt21_shape"], model["output_genotype_shape"],
            model["output_indel_length_shape_1"], model["output_indel_length_shape_2"])
    for stem, head, out in zip(STEMS, HEADS, outs):
        shapes.update({f"{stem}.w": (l4, l5), f"{stem}.b": (l5,),
                       f"{head}.w": (l5, out), f"{head}.b": (out,)})
    return shapes


def draw_masks(model: Dict, batch: int, generator: torch.Generator,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """One step's keep masks, by layer, in the order the model draws them."""
    t = model["input_shape"][0]
    widths = (("lstm1", (batch, t, 2 * model["lstm1_num_units"]), model["lstm1_dropout_rate"]),
              ("lstm2", (batch, t, 2 * model["lstm2_num_units"]), model["lstm2_dropout_rate"]),
              ("l4", (batch, model["l4_num_units"]), model["l4_dropout_rate"]),
              *((s, (batch, model["l5_num_units"]), model["l5_dropout_rate"]) for s in STEMS))
    return {name: torch.rand(shape, generator=generator, device=device) < 1.0 - rate
            for name, shape, rate in widths if rate > 0}


def _scaled_fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / torch.finfo(torch.float8_e4m3fn).max
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


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
    if precision == "float32" or (precision == "tf32" and device.type == "cuda"):
        return None
    fn = {"tf32": _tf32, "fp8": _scaled_fp8}[precision]
    return lambda t: _Round.apply(t, fn)


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
    return SELU_SCALE * torch.where(x >= 0.0, x, SELU_ALPHA * torch.expm1(x))


def _alpha_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    p = 1.0 - rate
    a = (p * ((1 - p) * ALPHA_DROPOUT_VALUE ** 2 + 1.0)) ** -0.5
    b = -a * (1 - p) * ALPHA_DROPOUT_VALUE
    return a * torch.where(keep, x, ALPHA_DROPOUT_VALUE) + b


def _bilstm(p: Dict, name: str, x: torch.Tensor, r: Callable) -> torch.Tensor:
    """(B, T, F) -> (B, T, 2H); both directions stacked on a leading axis."""
    b, t, f = x.shape
    w = torch.stack([p[f"{name}.fw.w"], p[f"{name}.bw.w"]])
    u = torch.stack([p[f"{name}.fw.u"], p[f"{name}.bw.u"]])
    bias = torch.stack([p[f"{name}.fw.b"], p[f"{name}.bw.b"]])
    hidden = u.shape[1]
    xs = torch.stack([x, x.flip(1)]).reshape(2, b * t, f)
    xw = (torch.bmm(r(xs), r(w)) + bias[:, None]).view(2, b, t, 4 * hidden)
    u = r(u)
    h = x.new_zeros((2, b, hidden))
    c = x.new_zeros((2, b, hidden))
    out = []
    for step in range(t):
        gates = xw[:, :, step] + torch.bmm(r(h), u)
        i, f_, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f_) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    out = torch.stack(out, dim=2)
    return torch.cat([out[0], out[1].flip(1)], dim=-1)


def forward(p: Dict, x: torch.Tensor, model: Dict, masks: Optional[Dict] = None,
            r: Optional[Callable] = None) -> List[torch.Tensor]:
    """The four heads' logits (pre-softmax) of a (B, 33, 8, 4) float32
    batch; dropout where ``masks`` gives a layer's keep mask."""
    r = r or (lambda t: t)
    masks = masks or {}
    b = x.shape[0]
    h = x.reshape(b, x.shape[1], -1)
    for name in ("lstm1", "lstm2"):
        h = _bilstm(p, name, h, r)
        if name in masks:
            keep = 1.0 - model[f"{name}_dropout_rate"]
            h = torch.where(masks[name], h / keep, 0.0)
    l3 = torch.einsum("btf,ftu->buf", r(h), r(p["l3.w"])) + p["l3.b"].T[None]
    l4 = selu(r(selu(l3).reshape(b, -1)) @ r(p["l4.w"]) + p["l4.b"])
    if "l4" in masks:
        l4 = _alpha_dropout(l4, masks["l4"], model["l4_dropout_rate"])
    logits = []
    for stem, head in zip(STEMS, HEADS):
        s = selu(r(l4) @ r(p[f"{stem}.w"]) + p[f"{stem}.b"])
        if stem in masks:
            s = _alpha_dropout(s, masks[stem], model["l5_dropout_rate"])
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
    return sum(0.5 * torch.sum(v * v) for k, v in p.items() if not k.endswith(".b"))


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


def gradient(p: Dict, x: torch.Tensor, y: torch.Tensor, model: Dict, training: Dict,
             masks: Dict, block_rows: int, r: Optional[Callable] = None,
             row_weights: Optional[torch.Tensor] = None) -> Tuple[float, Dict]:
    """(loss, {leaf: gradient}) of one batch, summed over blocks of rows.
    x: (B, 33, 8, 4) float32 counts; y: (B, 90) float32 labels."""
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    weights = model["task_loss_weights"]
    gamma = training["focal_gamma"]
    total = 0.0
    for start in range(0, x.shape[0], block_rows):
        rows = slice(start, start + block_rows)
        logits = forward(leaves, x[rows], model, {k: m[rows] for k, m in masks.items()}, r)
        loss = task_loss(logits, y[rows], gamma, weights,
                         None if row_weights is None else row_weights[rows])
        for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                    allow_unused=True)):
            if g is not None:
                grads[k] += g
        total += loss.item()
    l2 = training["l2_lambda"] * weights[4] * l2_term(leaves)
    for k, g in zip(leaves, torch.autograd.grad(l2, list(leaves.values()), allow_unused=True)):
        if g is not None:
            grads[k] += g
    return total + l2.item(), grads


def clip(grads: Dict, max_norm: float) -> Dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    if norm < max_norm:
        return grads
    return {k: g / norm * max_norm for k, g in grads.items()}


def train(p0: Dict, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], masks: Sequence[Dict],
          model: Dict, training: Dict, precision: str = "float32", block_rows: int = 2500,
          fault: Optional[Callable] = None) -> Dict:
    """The reference's steps over ``batches`` from ``p0``: {"losses": each
    step's loss, "grad": step 1's clipped gradient by leaf (what Adam
    receives), "params": the parameters after the last step}. ``fault``,
    where given, is called as fault(step, grads) -> grads before the clip,
    or fault(step, None) -> row weights of the step's loss (the control's
    faults)."""
    device = next(iter(p0.values())).device
    r = rounding(precision, device)
    p = {k: v.detach().float().clone() for k, v in p0.items()}
    adam = Adam(training["learning_rate"], tuple(training["adam_betas"]), training["adam_eps"])
    losses, first = [], None
    with products(precision):
        for step, ((x, y), m) in enumerate(zip(batches, masks)):
            row_weights = fault(step, None) if fault is not None else None
            loss, g = gradient(p, x, y, model, training, m, block_rows, r, row_weights)
            if fault is not None:
                g = fault(step, g)
            g = clip(g, training["clip_norm"])
            if first is None:
                first = {k: v.clone() for k, v in g.items()}
            adam.update(p, g)
            losses.append(loss)
    return {"losses": losses, "grad": first, "params": p}


def l2_norms(tree: Dict) -> Dict[str, float]:
    return {k: math.sqrt(float(torch.sum(v.double() * v.double()))) for k, v in tree.items()}
