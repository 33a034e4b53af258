"""Operations and bytes of the work a training step needs, from its shapes,
and the card's peaks they are held against.

The BiLSTM layers' counts are a frozen copy of chip_smoke.py's phase-9d
arithmetic (``fwd_work``, ``bwd_work``, ``bound`` and their constants) at
commit 2d943a28633bbdf54bf4ad8c2fca49aa40a5ff2a, so that an edit of
chip_smoke.py does not move the benchmark's yardstick. They count each
input byte read once and each output byte written once, whatever the
kernel reads again, so they read the same work whatever implements it.

Every roofline share and every ``mfu`` here is taken against the dense
bfloat16 tensor-core peak and the HBM rate, in float32 configurations too:
the port's float32 kernels already run their products on the tensor cores
as bf16 pieces, so the CUDA cores' float32 peak (67 TFLOP/s) is no bound
for them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# ---- frozen from chip_smoke.py (phase 9d) --------------------------------
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
T_LEN, HIDDEN, CALL_BATCH, TRAIN_BATCH = 33, 128, 512, 10_000
LAYERS = (("lstm1", 32), ("lstm2", 256))


def fwd_work(batch, feat, dtype, with_cell=False, stacked=False):
    """(operations, bytes) of one BiLSTM layer's forward: the two products
    of every step (2 * 2B * T * (F + H) * 4H; the gate nonlinearities are
    not counted), and x, W, U, b read once and h (and the float32 c)
    written once. ``stacked``: the train pair's input, both directions
    stacked along the batch (x twice)."""
    e = torch.tensor([], dtype=dtype).element_size()
    rows = batch * T_LEN
    flops = 2 * 2 * rows * (feat + HIDDEN) * 4 * HIDDEN
    weights = 2 * (feat + HIDDEN) * 4 * HIDDEN * e + 2 * 4 * HIDDEN * 4
    out = rows * 2 * HIDDEN * (e + (4 if with_cell else 0))
    return flops, rows * feat * e * (2 if stacked else 1) + weights + out


def bwd_work(batch, feat, dtype, need_dx, stacked=False):
    """(operations, bytes) of one layer's backward: the gates from
    [x | h], dh carried through U, dW and dU, and dx where wanted;
    x, h, c (float32), dh and the weights read once, dx and the float32
    dW, dU, db written once."""
    e = torch.tensor([], dtype=dtype).element_size()
    rows = batch * T_LEN
    depth = (feat + HIDDEN) + HIDDEN + (feat + HIDDEN) + (feat if need_dx else 0)
    flops = 2 * 2 * rows * 4 * HIDDEN * depth
    x = rows * feat * e * (2 if stacked else 1)
    weights = 2 * (feat + HIDDEN) * 4 * HIDDEN * e + 2 * 4 * HIDDEN * 4
    saved = rows * 2 * HIDDEN * (e + 4 + e)           # h, float32 c, dh
    grads = 2 * (feat + HIDDEN + 1) * 4 * HIDDEN * 4
    return flops, x + weights + saved + grads + (x if need_dx else 0)


def bound(works, dtype):
    """(ms, "operations" or "bytes"): the larger of the operations over the
    card's peak for dtype and the bytes over its memory rate, summed over
    the layers' (operations, bytes)."""
    ops_s = sum(f for f, _ in works) / PEAK_FLOPS[dtype]
    bytes_s = sum(b for _, b in works) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"
# ---- end of the frozen copy ----------------------------------------------

# the peaks every share is taken against (NVIDIA's H100 SXM data sheet,
# dense, at the 700 W limit)
ROOFLINE_DTYPE = torch.bfloat16
PEAK_BF16_FLOPS = PEAK_FLOPS[ROOFLINE_DTYPE]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _check_widths(model: Dict) -> None:
    """The frozen counts fix T and H: refuse a model they do not describe."""
    t = model["input_shape"][0]
    widths = (model["lstm1_num_units"], model["lstm2_num_units"])
    if t != T_LEN or widths != (HIDDEN, HIDDEN):
        raise ValueError(f"the frozen counts describe T={T_LEN}, H={HIDDEN}, not T={t}, "
                         f"H={widths}")


def layer_features(model: Dict) -> List[int]:
    """Each BiLSTM layer's input width F."""
    _, rows, channels = model["input_shape"]
    return [rows * channels, 2 * model["lstm1_num_units"]]


def train_forward_work(model: Dict, batch: int, dtype: str) -> List[Tuple[int, int]]:
    """Row 1's (operations, bytes) a training step: both layers' forward,
    the float32 c kept for the backward."""
    _check_widths(model)
    return [fwd_work(batch, f, DTYPES[dtype], with_cell=True) for f in layer_features(model)]


def train_backward_work(model: Dict, batch: int, dtype: str) -> List[Tuple[int, int]]:
    """Row 2's (operations, bytes) a training step: both layers' backward,
    dx for the second only (the first layer's input needs no gradient)."""
    _check_widths(model)
    first, second = layer_features(model)
    return [bwd_work(batch, first, DTYPES[dtype], need_dx=False),
            bwd_work(batch, second, DTYPES[dtype], need_dx=True)]


def roofline_ms(works: List[Tuple[int, int]]) -> float:
    """The least milliseconds the card could take for ``works``, against
    the bf16 tensor peak and the HBM rate."""
    return bound(works, ROOFLINE_DTYPE)[0]


def forward_flops_per_row(model: Dict) -> Dict[str, int]:
    """The model's forward operations for one row, by layer (2 per
    multiply-add of each product; the nonlinearities not counted)."""
    t, rows, channels = model["input_shape"]
    feat = rows * channels
    h1, h2 = model["lstm1_num_units"], model["lstm2_num_units"]
    l3_in, l3, l4, l5 = 2 * h2, model["l3_num_units"], model["l4_num_units"], model["l5_num_units"]
    heads = (model["output_gt21_shape"] + model["output_genotype_shape"]
             + model["output_indel_length_shape_1"] + model["output_indel_length_shape_2"])
    return {
        "lstm1": 2 * 2 * t * (feat + h1) * 4 * h1,
        "lstm2": 2 * 2 * t * (2 * h1 + h2) * 4 * h2,
        "l3": 2 * t * l3_in * l3,
        "l4": 2 * l3 * l3_in * l4,
        "stems": 4 * 2 * l4 * l5,
        "heads": 2 * l5 * heads,
    }


def model_flops(model: Dict, train_rows: int, eval_rows: int) -> int:
    """Model FLOPs of a stretch of steps: 3 forwards a training row (the
    forward and a backward of twice its products), 1 an evaluated row; no
    recompute counted."""
    forward = sum(forward_flops_per_row(model).values())
    return forward * (3 * train_rows + eval_rows)
