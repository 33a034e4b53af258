"""The 21-class joint-genotype alphabet.

The class set covers the 10 unordered base pairs plus per-base Ins/Del
combinations and InsDel, identical to the reference alphabet
(reference clair/task/gt21.py:3-50) — this is part of the trained
model's output contract, not a design choice.
"""

from __future__ import annotations

import enum


class GT21(enum.IntEnum):
    AA = 0
    AC = 1
    AG = 2
    AT = 3
    CC = 4
    CG = 5
    CT = 6
    GG = 7
    GT = 8
    TT = 9
    DelDel = 10
    ADel = 11
    CDel = 12
    GDel = 13
    TDel = 14
    InsIns = 15
    AIns = 16
    CIns = 17
    GIns = 18
    TIns = 19
    InsDel = 20


GT21_LABELS = [m.name for m in GT21]
_LABEL_TO_CODE = {m.name: int(m) for m in GT21}

HOMO_SNP_GT21 = (GT21.AA, GT21.CC, GT21.GG, GT21.TT)
HETERO_SNP_GT21 = (GT21.AC, GT21.AG, GT21.AT, GT21.CG, GT21.CT, GT21.GT)
HOMO_SNP_LABELS = [m.name for m in HOMO_SNP_GT21]
HETERO_SNP_LABELS = [m.name for m in HETERO_SNP_GT21]


def gt21_label_from(code: int) -> str:
    try:
        return GT21_LABELS[code]
    except (IndexError, TypeError):
        return ""


def gt21_code_from_label(label: str) -> int:
    return _LABEL_TO_CODE[label]


def _allele_kind(ref: str, alt: str) -> str:
    """Collapse one REF/ALT pair into a partial label: 'Ins', 'Del' or the
    alt's leading base for a SNP/ref allele."""
    if len(ref) > len(alt):
        return "Del"
    if len(ref) < len(alt):
        return "Ins"
    return alt[0]


def _join_kinds(kind1: str, kind2: str) -> str:
    """Combine two partial labels into a GT21 label (unordered)."""
    if len(kind1) == 1 and len(kind2) == 1:      # two bases -> sorted pair
        return kind1 + kind2 if kind1 <= kind2 else kind2 + kind1
    if len(kind1) == 1 and len(kind2) > 1:       # base + Ins/Del
        return kind1 + kind2
    if len(kind2) == 1 and len(kind1) > 1:
        return kind2 + kind1
    if kind1 == kind2:                           # InsIns / DelDel
        return kind1 + kind2
    return GT21.InsDel.name


def gt21_code_from(
    reference: str,
    alternate: str,
    genotype_1: int,
    genotype_2: int,
    alternate_arr=None,
) -> int:
    """GT21 class for a truth VCF record.

    A single-ALT record is expanded to a diploid allele pair first: a het
    call pairs the ALT with the reference allele, a hom call duplicates the
    ALT (ref gt21.py:92-108 semantics).
    """
    if alternate_arr is None:
        alternate_arr = alternate.split(",")
        if len(alternate_arr) == 1:
            first = reference if genotype_1 == 0 or genotype_2 == 0 else alternate_arr[0]
            alternate_arr = [first] + alternate_arr
    kinds = [_allele_kind(reference, alt) for alt in alternate_arr]
    return gt21_code_from_label(_join_kinds(kinds[0], kinds[1]))
