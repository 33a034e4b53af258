"""Y-vector layout (21+3+33+33 = 90) and one-hot encoders.

Layout and encoding semantics match the reference
(reference clair/task/main.py:10-81); the encoders here additionally
come in numpy-vectorized batch form for the TPU data pipeline.
"""

from __future__ import annotations

import numpy as np

from clair_tpu_torch.task.genotype import Genotype, genotype_code_from, genotype_for_task
from clair_tpu_torch.task.gt21 import gt21_code_from, gt21_code_from_label
from clair_tpu_torch.task.variant_length import VariantLength

GT21_SPAN = (0, 21)
GENOTYPE_SPAN = (21, 24)
LENGTH1_SPAN = (24, 57)
LENGTH2_SPAN = (57, 90)
OUTPUT_LABEL_COUNT = 90

_GT21_N, _GENO_N = 21, 3
_LEN_N = VariantLength.output_label_count


def split_label_vector(y: np.ndarray):
    """Split a (..., 90) label/probability array into the 4 task segments."""
    return (
        y[..., GT21_SPAN[0]:GT21_SPAN[1]],
        y[..., GENOTYPE_SPAN[0]:GENOTYPE_SPAN[1]],
        y[..., LENGTH1_SPAN[0]:LENGTH1_SPAN[1]],
        y[..., LENGTH2_SPAN[0]:LENGTH2_SPAN[1]],
    )


def _clamp_length(value: int) -> int:
    return max(min(value, VariantLength.max), VariantLength.min)


def label_vector_from_reference(reference_base: str) -> np.ndarray:
    """Y vector for a homozygous-reference (non-variant) site."""
    y = np.zeros(OUTPUT_LABEL_COUNT, dtype=np.float32)
    y[gt21_code_from_label(reference_base + reference_base)] = 1.0
    y[GENOTYPE_SPAN[0] + Genotype.homo_reference] = 1.0
    y[LENGTH1_SPAN[0] + VariantLength.index_offset] = 1.0
    y[LENGTH2_SPAN[0] + VariantLength.index_offset] = 1.0
    return y


def label_vector_from_truth(
    reference: str, alternate: str, genotype_1: int, genotype_2: int
) -> np.ndarray:
    """Y vector for a truth variant record (ref main.py:51-81 semantics).

    Single-ALT records are expanded to an allele pair (het pairs ALT with
    REF; hom duplicates ALT); indel lengths are clamped to [-16, 16] and
    sorted ascending into the two length heads.
    """
    alternate_arr = alternate.split(",")
    if len(alternate_arr) == 1:
        first = reference if genotype_1 == 0 or genotype_2 == 0 else alternate_arr[0]
        alternate_arr = [first] + alternate_arr

    y = np.zeros(OUTPUT_LABEL_COUNT, dtype=np.float32)
    y[gt21_code_from(reference, alternate, genotype_1, genotype_2, alternate_arr)] = 1.0

    genotype = genotype_for_task(genotype_code_from(genotype_1, genotype_2))
    y[GENOTYPE_SPAN[0] + genotype] = 1.0

    lengths = sorted(_clamp_length(len(alt) - len(reference)) for alt in alternate_arr)
    y[LENGTH1_SPAN[0] + lengths[0] + VariantLength.index_offset] = 1.0
    y[LENGTH2_SPAN[0] + lengths[1] + VariantLength.index_offset] = 1.0
    return y


def label_batch_from_codes(
    gt21_codes: np.ndarray,
    genotype_codes: np.ndarray,
    length1_classes: np.ndarray,
    length2_classes: np.ndarray,
) -> np.ndarray:
    """Vectorized one-hot assembly of a (B, 90) label batch from class codes.

    ``length*_classes`` are already offset class indices in [0, 33).
    """
    n = len(gt21_codes)
    y = np.zeros((n, OUTPUT_LABEL_COUNT), dtype=np.float32)
    rows = np.arange(n)
    y[rows, gt21_codes] = 1.0
    y[rows, GENOTYPE_SPAN[0] + genotype_codes] = 1.0
    y[rows, LENGTH1_SPAN[0] + length1_classes] = 1.0
    y[rows, LENGTH2_SPAN[0] + length2_classes] = 1.0
    return y
