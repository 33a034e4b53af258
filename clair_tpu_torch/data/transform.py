"""Tensor geometry transforms.

``shrink_tensor_line`` converts legacy 65-position (32-flank) tensor rows
to the 33-position geometry, optionally collapsing strand rows — the
reference's TensorTransformer stdin filter
(reference dataPrepScripts/TensorTransformer.py:4-65).
"""

from __future__ import annotations

import sys
from typing import Optional, TextIO

import numpy as np

from clair_tpu_torch.params import FLANKING_BASE_NUM, MATRIX_NUM, MATRIX_ROW


def shrink_tensor(
    tensor: np.ndarray,
    source_flanking: int = 32,
    target_flanking: int = FLANKING_BASE_NUM,
    collapse_strand: bool = False,
) -> np.ndarray:
    """Crop a (2f+1, 8, 4) tensor around its center to the target flank; with
    collapse_strand, fold reverse-strand rows onto forward rows."""
    source_positions = 2 * source_flanking + 1
    if tensor.shape[0] != source_positions:
        raise ValueError(
            f"expected {source_positions} positions, got {tensor.shape[0]}"
        )
    offset = source_flanking - target_flanking
    out = tensor[offset: offset + 2 * target_flanking + 1]
    if collapse_strand:
        folded = out[:, :4, :] + out[:, 4:, :]
        out = np.concatenate([folded, np.zeros_like(folded)], axis=1)
    return out


def transform_stream(
    input_fh: TextIO = sys.stdin,
    output_fh: TextIO = sys.stdout,
    source_flanking: int = 32,
    collapse_strand: bool = False,
) -> int:
    from clair_tpu_torch.data.tensor_stream import tensor_line_from

    source_positions = 2 * source_flanking + 1
    size = source_positions * MATRIX_ROW * MATRIX_NUM
    n = 0
    for line in input_fh:
        columns = line.split()
        ctg, pos, seq = columns[0], int(columns[1]), columns[2]
        tensor = np.array(columns[-size:], dtype=np.float32).reshape(
            source_positions, MATRIX_ROW, MATRIX_NUM
        )
        shrunk = shrink_tensor(tensor, source_flanking, collapse_strand=collapse_strand)
        offset = source_flanking - FLANKING_BASE_NUM
        seq_out = seq[offset: offset + 2 * FLANKING_BASE_NUM + 1] if len(seq) == source_positions else seq
        print(tensor_line_from(ctg, pos, seq_out, shrunk), file=output_fh)
        n += 1
    return n
