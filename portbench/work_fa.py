"""Operations and bytes of Clair3_F's training step, from its shapes
(portbench/reference/clair3_fa.py's layers), and the least time the card
could take for them.

A row's forward: each 3x3 convolution 2 * 9 * cin * cout operations an
output cell, 449.4 MFLOP over the trunk at the published widths (7.05 +
112.8 + 30.5 + 122.1 + 35.4 + 141.6), and the dense layers 2 a
multiply-add, 2.12 MFLOP: 451.5 MFLOP. A training row counts three
forwards (the forward, and the backward's two products of each: data and
weight gradients), none recomputed.

Bytes are those of the unfused graph, each operation's inputs read once
and its outputs written once, in float32: a convolution reads its input
and kernel and writes its output; batch norm, ReLU and the residual add
each read and write their maps. The backward reads what each operation's
gradient needs (its saved input, the gradient of its output, the kernel)
and writes the gradient of its input and of its parameters; the first
convolution's input takes no gradient. Elementwise operations count no
operations, as portbench/work.py counts no gate nonlinearity.

Shares are taken against the dense bf16 tensor peak and the HBM rate, as
portbench/work.py's are, so that a later tensor-core convolution cannot
read over 100%.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.reference.clair3_fa import STEMS, convs, pyramid_width
from portbench.work import HBM_BYTES_PER_S, PEAK_BF16_FLOPS

F32 = 4
INPUT_BYTES = 2  # the feed's int16


def _outputs(model: Dict) -> Tuple[int, ...]:
    return (model["output_gt21_shape"], model["output_genotype_shape"],
            model["output_indel_length_shape_1"], model["output_indel_length_shape_2"])


def _dense(model: Dict) -> List[Tuple[str, int, int]]:
    """(name, in, out) of every dense layer."""
    l4, l5 = model["l4_num_units"], model["l5_num_units"]
    return ([("l4", pyramid_width(model), l4)] + [(s, l4, l5) for s in STEMS]
            + [(f"head{k}", l5, out) for k, out in enumerate(_outputs(model))])


def forward_flops_per_row(model: Dict) -> Dict[str, int]:
    """The forward's operations for one row, by layer."""
    out = {name: 2 * h * w * 9 * cin * cout for name, cin, cout, _, (h, w) in convs(model)}
    out.update({name: 2 * cin * cout for name, cin, cout in _dense(model)})
    return out


def model_flops(model: Dict, train_rows: int, eval_rows: int) -> int:
    """Model FLOPs of a stretch: 3 forwards a training row, 1 an evaluated
    row; no recompute counted."""
    return sum(forward_flops_per_row(model).values()) * (3 * train_rows + eval_rows)


def _maps(model: Dict):
    """(name, cin, cout, input cells, output cells) of every convolution."""
    height, width, _ = model["input_shape"]
    cells = height * width
    for name, cin, cout, _, (h, w) in convs(model):
        yield name, cin, cout, cells, h * w
        cells = h * w


def trunk_forward_work(model: Dict, batch: int) -> List[Tuple[int, int]]:
    """(operations, bytes) of the trunk's forward at ``batch``: the input's
    cast, then by convolution its product, batch norm, ReLU and, closing a
    block, the residual add."""
    height, width, channels = model["input_shape"]
    cast = batch * height * width * channels
    works = [(0, cast * (INPUT_BYTES + F32))]
    for name, cin, cout, cells_in, cells in _maps(model):
        act = batch * cells * cout * F32
        works.append((batch * 2 * cells * 9 * cin * cout,
                      batch * cells_in * cin * F32 + act + (9 * cin + 1) * cout * F32))
        works.append((0, 2 * act + 4 * cout * F32))      # batch norm
        if name.endswith(".conv2"):
            works.append((0, 3 * act))                   # residual add
        works.append((0, 2 * act))                       # ReLU
    return works


def backward_work(model: Dict, batch: int) -> List[Tuple[int, int]]:
    """(operations, bytes) of the whole model's backward at ``batch``: the
    dense layers' data and weight gradients, the pyramid's gradient into the
    trunk's last map, and by convolution (last to first) ReLU's, the
    residual sum's, batch norm's, the data gradient (but the first's) and
    the weight gradient."""
    works = []
    for _, cin, cout in _dense(model):
        x, y, w = batch * cin * F32, batch * cout * F32, cin * cout * F32
        works.append((2 * batch * cin * cout, y + w + x))          # data gradient
        works.append((2 * batch * cin * cout, y + x + w + cout * F32))  # weight gradient
    maps = list(_maps(model))
    _, _, channels, _, cells = maps[-1]
    works.append((0, batch * (pyramid_width(model) + cells * channels) * F32))
    for k, (name, cin, cout, cells_in, cells) in enumerate(reversed(maps)):
        act = batch * cells * cout * F32
        x = batch * cells_in * cin * F32
        ops = batch * 2 * cells * 9 * cin * cout
        works.append((0, 3 * act))                                 # ReLU
        if name.endswith(".conv2"):
            works.append((0, 3 * act))                             # the shortcut's sum
        works.append((0, 3 * act + 4 * cout * F32))                # batch norm
        if k < len(maps) - 1:
            works.append((ops, act + 9 * cin * cout * F32 + x))    # data gradient
        works.append((ops, act + x + (9 * cin + 1) * cout * F32))  # weight gradient
    return works


def roofline_ms(works: List[Tuple[int, int]]) -> float:
    """The least milliseconds the card could take for ``works``: the larger
    of their operations over the bf16 tensor peak and their bytes over the
    HBM rate."""
    return max(sum(f for f, _ in works) / PEAK_BF16_FLOPS,
               sum(b for _, b in works) / HBM_BYTES_PER_S) * 1e3
