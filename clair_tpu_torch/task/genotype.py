"""Genotype (zygosity) task labels.

Three model classes (0/0, 1/1, 0/1); the 1/2 case is folded into the
hetero class for prediction and only re-expanded at VCF output time
(ref reference clair/task/genotype.py:3-33).
"""

from __future__ import annotations

import enum

GENOTYPES = ["0/0", "1/1", "0/1", "1/2"]


class Genotype(enum.IntEnum):
    homo_reference = 0       # 0/0
    homo_variant = 1         # 1/1
    hetero_variant = 2       # 0/1 (and 1/2 for the prediction task)
    hetero_variant_multi = 3  # 1/2 (output-time only)


def genotype_string_from(code: int) -> str:
    try:
        return GENOTYPES[code]
    except (IndexError, TypeError):
        return ""


def genotype_code_from(genotype_1: int, genotype_2: int) -> Genotype:
    if genotype_1 == 0 and genotype_2 == 0:
        return Genotype.homo_reference
    if genotype_1 == genotype_2:
        return Genotype.homo_variant
    if genotype_1 != 0 and genotype_2 != 0:
        return Genotype.hetero_variant_multi
    return Genotype.hetero_variant


def genotype_for_task(genotype: Genotype) -> Genotype:
    """Fold 1/2 into the hetero class for the 3-way prediction task."""
    if genotype == Genotype.hetero_variant_multi:
        return Genotype.hetero_variant
    return genotype
