"""Probability -> variant decode lattice.

Re-implements the reference's outcome enumeration + argmax-with-retry loop
(reference clair/call_var.py:344-947) with the per-site candidate
lists held as numpy arrays (outer products) instead of Python tuple lists.
Ordering/tie semantics are preserved exactly:

- categories are tested in the fixed order homoRef, homoSNP, heteroSNP,
  homoIns, heteroACGT+Ins, heteroInsIns, homoDel, heteroACGT+Del,
  heteroDelDel, InsDel (first category attaining the global max wins);
- within a category the FIRST index attaining the max wins (np.argmax);
- a rejected candidate (zero-length allele recovery, identical InsIns
  alleles, degenerate DelDel) is masked out and the whole lattice re-argmaxed
  (the reference deletes the list element; masking with -1 is equivalent
  since probabilities are non-negative).

Indel allele sequences come from the tensor for lengths < 16 and from a
pluggable re-pileup source (the BAM reader) for the boundary class >= 16.
"""

from __future__ import annotations

import dataclasses
from math import e, log
from typing import Callable, Optional, Tuple

import numpy as np

from clair_tpu_torch.params import FLANKING_BASE_NUM
from clair_tpu_torch.task.genotype import (
    Genotype,
    genotype_code_from,
    genotype_for_task,
    genotype_string_from,
)
from clair_tpu_torch.task.gt21 import (
    GT21,
    HETERO_SNP_GT21,
    HETERO_SNP_LABELS,
    HOMO_SNP_GT21,
    HOMO_SNP_LABELS,
    gt21_code_from,
    gt21_code_from_label,
)
from clair_tpu_torch.task.variant_length import VariantLength
from clair_tpu_torch.utils.genomics import BASE2ACGT, BASE2NUM, BASIC_BASES, NUM2BASE

# channels of the (33, 8, 4) tensor
CH_REFERENCE, CH_INSERT, CH_DELETE, CH_SNP = 0, 1, 2, 3

VLEN_MAX = VariantLength.max                      # 16
VLEN_OFF = VariantLength.index_offset             # 16
MIN_LENGTH_NEEDING_INFERENCE = VariantLength.max  # ref call_var.py:29
MAX_INFERRED_LENGTH = 50                          # ref call_var.py:30
INFERRED_INDEL_MIN_AF = 0.125                     # ref call_var.py:31


@dataclasses.dataclass
class IndelSources:
    """Pluggable allele-sequence recovery for long indels.

    ``insertion_bases(contig, position, min_len, max_len, ignore)`` and
    ``deletion_bases(contig, position, min_len, max_len)`` re-pileup the BAM
    around the site; None disables BAM recovery (tensor inference is used).
    """

    insertion_bases: Optional[Callable] = None
    deletion_bases: Optional[Callable] = None
    use_bam_for_all: bool = False  # --pysam_for_all_indel_bases equivalent


@dataclasses.dataclass
class OutputConfig:
    is_show_reference: bool = False
    is_debug: bool = False
    is_haploid_precision_mode_enabled: bool = False
    is_haploid_sensitive_mode_enabled: bool = False
    is_output_for_ensemble: bool = False
    quality_score_for_pass: Optional[int] = None


# ---------------------------------------------------------------------------
# Indel allele recovery from the (normalized) tensor
# ---------------------------------------------------------------------------

def _folded_insert_profile(x: np.ndarray, position: int) -> np.ndarray:
    """Strand-folded insert counts minus SNP counts at one tensor row
    (ref call_var.py:428-447, 465-477 inner loop).

    Returns the full 8-entry profile with the reverse-strand half zeroed —
    the reference argmaxes all 8 entries, so when every folded value is
    negative the zeroed upper half wins and the base defaults to index%4
    ('A'); argmaxing only the folded 4 would pick the least-negative base
    instead.
    """
    ins = x[position, :, CH_INSERT].copy()
    snp = x[position, :, CH_SNP]
    folded = np.zeros(8, dtype=x.dtype)
    folded[:4] = ins[:4] + ins[4:] - (snp[:4] + snp[4:])
    return folded


def _folded_insert_rows(x: np.ndarray, start: int, stop: int) -> np.ndarray:
    """Folded insert profiles for rows [start, stop) at once: (n, 8) with
    the reverse-strand half zeroed (see _folded_insert_profile)."""
    rows = x[start:stop]
    folded = np.zeros((stop - start, 8), dtype=x.dtype)
    folded[:, :4] = (
        rows[:, :4, CH_INSERT] + rows[:, 4:, CH_INSERT]
        - rows[:, :4, CH_SNP] - rows[:, 4:, CH_SNP]
    )
    return folded


def insertion_bases_using_tensor(x: np.ndarray, variant_length: int) -> str:
    start = FLANKING_BASE_NUM + 1
    folded = _folded_insert_rows(x, start, start + variant_length)
    return "".join(NUM2BASE[i % 4] for i in folded.argmax(axis=1))


def inferred_insertion_bases(x: np.ndarray) -> str:
    """Extend the insertion as long as insert-channel support stays above
    12.5% of reference support (ref call_var.py:428-447)."""
    start = FLANKING_BASE_NUM + 1
    stop = 2 * FLANKING_BASE_NUM + 1
    folded = _folded_insert_rows(x, start, stop)
    reference_support = x[start:stop, :, CH_REFERENCE].sum(axis=1)
    choices = folded.argmax(axis=1) % 4
    supported = folded.sum(axis=1) >= INFERRED_INDEL_MIN_AF * reference_support
    bases = []
    for k in range(stop - start):
        if (start + k) < (FLANKING_BASE_NUM + MIN_LENGTH_NEEDING_INFERENCE) or supported[k]:
            bases.append(NUM2BASE[int(choices[k])])
        else:
            break
    return "".join(bases)


def inferred_deletion_length(x: np.ndarray) -> int:
    length = 0
    for position in range(FLANKING_BASE_NUM + 1, 2 * FLANKING_BASE_NUM + 1):
        reference_support = float(x[position, :, CH_REFERENCE].sum())
        deletion_support = float(x[position, :, CH_DELETE].sum())
        if (
            position < (FLANKING_BASE_NUM + MIN_LENGTH_NEEDING_INFERENCE)
            or deletion_support >= INFERRED_INDEL_MIN_AF * reference_support
        ):
            length += 1
        else:
            break
    return length


def _max_recovery_length(variant_length: int) -> int:
    if variant_length >= MIN_LENGTH_NEEDING_INFERENCE:
        return MAX_INFERRED_LENGTH
    return variant_length


def recover_insertion_bases(
    x: np.ndarray,
    variant_length: int,
    contig: str,
    position: int,
    sources: IndelSources,
) -> Tuple[str, int]:
    """(insertion_bases, length) — ref call_var.py:487-524 semantics."""
    if sources.use_bam_for_all and sources.insertion_bases is not None:
        bases = sources.insertion_bases(
            contig, position, variant_length, _max_recovery_length(variant_length), ""
        )
        return bases, len(bases)

    if variant_length < MIN_LENGTH_NEEDING_INFERENCE:
        bases = insertion_bases_using_tensor(x, variant_length)
        return bases, len(bases)

    if sources.insertion_bases is not None:
        bases = sources.insertion_bases(
            contig, position, MIN_LENGTH_NEEDING_INFERENCE, MAX_INFERRED_LENGTH, ""
        )
        if bases:
            return bases, len(bases)
    bases = inferred_insertion_bases(x)
    return bases, len(bases)


def recover_deletion_bases(
    x: np.ndarray,
    variant_length: int,
    contig: str,
    position: int,
    reference_sequence: str,
    sources: IndelSources,
) -> Tuple[str, int]:
    """(deletion_bases, length) — ref call_var.py:527-565 semantics."""
    if sources.use_bam_for_all and sources.deletion_bases is not None:
        bases = sources.deletion_bases(
            contig, position, variant_length, _max_recovery_length(variant_length)
        )
        return bases, len(bases)

    bases = ""
    needs_inference = variant_length >= MIN_LENGTH_NEEDING_INFERENCE
    if needs_inference and sources.deletion_bases is not None:
        bases = sources.deletion_bases(
            contig, position, MIN_LENGTH_NEEDING_INFERENCE, MAX_INFERRED_LENGTH
        )
    if not (needs_inference and len(bases) >= FLANKING_BASE_NUM):
        bases = reference_sequence[FLANKING_BASE_NUM + 1: FLANKING_BASE_NUM + variant_length + 1]
    return bases, len(bases)


# ---------------------------------------------------------------------------
# The outcome lattice
# ---------------------------------------------------------------------------

_IDX = np.arange(1, VLEN_MAX + 1)
# flattened (i, j) grids for the pair categories, row-major like the
# reference's nested loops
_II, _JJ = np.meshgrid(_IDX, _IDX, indexing="ij")
_II_FLAT, _JJ_FLAT = _II.ravel(), _JJ.ravel()
_DELDEL_KEEP = _II_FLAT != _JJ_FLAT
_HET_INS_GT21 = (GT21.AIns, GT21.CIns, GT21.GIns, GT21.TIns)
_HET_DEL_GT21 = (GT21.ADel, GT21.CDel, GT21.GDel, GT21.TDel)


class OutcomeLattice:
    """All candidate outcomes of one site with maskable probabilities."""

    def __init__(self, gt21_p, genotype_p, vl1_p, vl2_p, reference_base: str):
        gt21_p = np.asarray(gt21_p, dtype=np.float64)
        genotype_p = np.asarray(genotype_p, dtype=np.float64)
        vl1 = np.asarray(vl1_p, dtype=np.float64)
        vl2 = np.asarray(vl2_p, dtype=np.float64)

        p_homo = genotype_p[Genotype.homo_variant]
        p_het = genotype_p[Genotype.hetero_variant]
        p_ref_geno = genotype_p[Genotype.homo_reference]
        vl0 = vl1[VLEN_OFF] * vl2[VLEN_OFF]

        ref_gt21 = gt21_code_from_label(reference_base + reference_base)
        self.homo_ref = vl0 * p_ref_geno * gt21_p[ref_gt21]

        self.homo_snp = vl0 * p_homo * gt21_p[np.asarray(HOMO_SNP_GT21, dtype=int)]
        self.hetero_snp = vl0 * p_het * gt21_p[np.asarray(HETERO_SNP_GT21, dtype=int)]

        pos1, pos2 = vl1[VLEN_OFF + _IDX], vl2[VLEN_OFF + _IDX]       # +1..+16
        neg1, neg2 = vl1[VLEN_OFF - _IDX], vl2[VLEN_OFF - _IDX]       # -1..-16
        zero1, zero2 = vl1[VLEN_OFF], vl2[VLEN_OFF]

        # homo Ins: i in 1..16 (ref :344-349)
        self.homo_ins = pos1 * pos2 * (p_homo * gt21_p[GT21.InsIns])
        self.homo_ins_lengths = _IDX.copy()

        # hetero InsIns: (i, j) grid, label (min, max) (ref :364-374)
        self.het_insins = (
            np.outer(pos1, pos2).ravel() * (p_het * gt21_p[GT21.InsIns])
        )
        self.het_insins_pairs = np.stack(
            [np.minimum(_II_FLAT, _JJ_FLAT), np.maximum(_II_FLAT, _JJ_FLAT)], axis=1
        )

        # hetero ACGT+Ins: base-major? no — the reference iterates lengths
        # outer, bases inner (ref :629-637), so order is (len, base)
        het_ins_len = np.maximum(zero1 * pos2, pos1 * zero2)          # (16,)
        acgt_ins_p = gt21_p[np.asarray(_HET_INS_GT21, dtype=int)] * p_het
        self.het_acgt_ins = (het_ins_len[:, None] * acgt_ins_p[None, :]).ravel()
        self.het_acgt_ins_lengths = np.repeat(_IDX, 4)
        self.het_acgt_ins_bases = np.tile(np.array(list("ACGT")), VLEN_MAX)

        # homo Del (ref :377-382)
        self.homo_del = neg1 * neg2 * (p_homo * gt21_p[GT21.DelDel])
        self.homo_del_lengths = _IDX.copy()

        # hetero DelDel: (i, j) grid without i == j, label (min, max)
        het_deldel_full = np.outer(neg1, neg2).ravel() * (p_het * gt21_p[GT21.DelDel])
        self.het_deldel = het_deldel_full[_DELDEL_KEEP]
        self.het_deldel_pairs = np.stack(
            [np.minimum(_II_FLAT, _JJ_FLAT), np.maximum(_II_FLAT, _JJ_FLAT)], axis=1
        )[_DELDEL_KEEP]

        # hetero ACGT+Del (ref :656-664): lengths outer, bases inner
        het_del_len = np.maximum(zero1 * neg2, neg1 * zero2)
        acgt_del_p = gt21_p[np.asarray(_HET_DEL_GT21, dtype=int)] * p_het
        self.het_acgt_del = (het_del_len[:, None] * acgt_del_p[None, :]).ravel()
        self.het_acgt_del_lengths = np.repeat(_IDX, 4)
        self.het_acgt_del_bases = np.tile(np.array(list("ACGT")), VLEN_MAX)

        # InsDel (ref :411-425): for each (i, j) two interleaved entries:
        #   ((j, i), vl1[+i] * vl2[-j])  then  ((i, j), vl1[-i] * vl2[+j])
        # where the pair is (deletion_length, insertion_length)
        p_insdel = p_het * gt21_p[GT21.InsDel]
        a = (vl1[VLEN_OFF + _II_FLAT] * vl2[VLEN_OFF - _JJ_FLAT]) * p_insdel
        b = (vl1[VLEN_OFF - _II_FLAT] * vl2[VLEN_OFF + _JJ_FLAT]) * p_insdel
        self.het_insdel = np.empty(2 * len(a), dtype=np.float64)
        self.het_insdel[0::2] = a
        self.het_insdel[1::2] = b
        pairs = np.empty((2 * len(a), 2), dtype=np.int64)
        pairs[0::2, 0], pairs[0::2, 1] = _JJ_FLAT, _II_FLAT   # (del=j, ins=i)
        pairs[1::2, 0], pairs[1::2, 1] = _II_FLAT, _JJ_FLAT   # (del=i, ins=j)
        self.het_insdel_pairs = pairs

    # ordered categories: (name, probability array)
    CATEGORY_ORDER = (
        "homo_snp", "hetero_snp", "homo_ins", "het_acgt_ins", "het_insins",
        "homo_del", "het_acgt_del", "het_deldel", "het_insdel",
    )

    def global_max(self) -> float:
        candidates = [self.homo_ref]
        for name in self.CATEGORY_ORDER:
            arr = getattr(self, name)
            if len(arr):
                candidates.append(arr.max())
        return max(candidates)

    def pick(self):
        """Return (category_name or 'homo_ref', index) of the current max."""
        m = self.global_max()
        if m == self.homo_ref:
            return "homo_ref", -1
        for name in self.CATEGORY_ORDER:
            arr = getattr(self, name)
            if len(arr) and arr.max() == m:
                return name, int(np.argmax(arr))
        # numerically impossible; degrade to reference call
        return "homo_ref", -1

    def mask(self, name: str, index: int) -> None:
        getattr(self, name)[index] = -1.0


def _winning_indel_candidate(category: str, vl1: np.ndarray, vl2: np.ndarray):
    """Argmax candidate of one indel category straight from the length
    vectors, with the exact first-index tie order of the lattice lists
    (grids are row-major; InsDel interleaves its two entry kinds per cell).

    Returns the category-specific payload the decode branch needs.
    """
    pos1, pos2 = vl1[VLEN_OFF + _IDX], vl2[VLEN_OFF + _IDX]
    neg1, neg2 = vl1[VLEN_OFF - _IDX], vl2[VLEN_OFF - _IDX]
    zero1, zero2 = vl1[VLEN_OFF], vl2[VLEN_OFF]

    if category == "homo_ins":
        return int(np.argmax(pos1 * pos2)) + 1
    if category == "homo_del":
        return int(np.argmax(neg1 * neg2)) + 1
    if category == "het_acgt_ins":
        # lengths outer, bases inner — the base factor is constant per
        # length so the winning length is argmax of the length term and the
        # winning base is argmax of the 4 gt21 entries (caller supplies)
        return int(np.argmax(np.maximum(zero1 * pos2, pos1 * zero2))) + 1
    if category == "het_acgt_del":
        return int(np.argmax(np.maximum(zero1 * neg2, neg1 * zero2))) + 1
    if category == "het_insins":
        grid = np.outer(pos1, pos2)
        flat = int(np.argmax(grid))
        i, j = flat // VLEN_MAX + 1, flat % VLEN_MAX + 1
        return (min(i, j), max(i, j))
    if category == "het_deldel":
        grid = np.outer(neg1, neg2)
        np.fill_diagonal(grid, -1.0)
        flat = int(np.argmax(grid))
        i, j = flat // VLEN_MAX + 1, flat % VLEN_MAX + 1
        return (min(i, j), max(i, j))
    if category == "het_insdel":
        a = np.outer(pos1, neg2)          # entry kind 0: (del=j, ins=i)
        b = np.outer(neg1, pos2)          # entry kind 1: (del=i, ins=j)
        stacked = np.stack([a, b], axis=-1)   # row-major (i, j, kind) order
        flat = int(np.argmax(stacked))
        kind = flat % 2
        cell = flat // 2
        i, j = cell // VLEN_MAX + 1, cell % VLEN_MAX + 1
        return (j, i) if kind == 0 else (i, j)   # (del_len, ins_len)
    raise ValueError(category)


def decode_indel_fast(
    category: str,
    x: np.ndarray,
    reference_sequence: str,
    contig: str,
    position: int,
    gt21_p: np.ndarray,
    genotype_p: np.ndarray,
    vl1_p: np.ndarray,
    vl2_p: np.ndarray,
    sources: IndelSources,
):
    """Decode a known-winning indel category without building the lattice.

    Returns (category, reference_base, alternate_base) or None when the
    exact semantics need the retry loop (degenerate alleles / empty
    recovery) — the caller then falls back to decode_alleles.
    """
    center = FLANKING_BASE_NUM
    vl1 = vl1_p.astype(np.float64)
    vl2 = vl2_p.astype(np.float64)

    if category == "homo_ins":
        variant_length = _winning_indel_candidate(category, vl1, vl2)
        bases, length = recover_insertion_bases(x, variant_length, contig, position, sources)
        if length == 0:
            return None
        reference_base = reference_sequence[center]
        return category, reference_base, reference_base + bases

    if category == "het_acgt_ins":
        variant_length = _winning_indel_candidate(category, vl1, vl2)
        het_base = "ACGT"[int(np.argmax(gt21_p[np.asarray(_HET_INS_GT21, dtype=int)]))]
        bases, length = recover_insertion_bases(x, variant_length, contig, position, sources)
        if length == 0:
            return None
        reference_base = reference_sequence[center]
        alternate_base = reference_base + bases
        if het_base != reference_base:
            alternate_base = f"{het_base},{alternate_base}"
        return category, reference_base, alternate_base

    if category == "het_insins":
        vl_1, vl_2 = _winning_indel_candidate(category, vl1, vl2)
        bases, length = recover_insertion_bases(x, vl_2, contig, position, sources)
        if length == 0:
            return None
        reference_base = reference_sequence[center]
        another = ""
        if sources.insertion_bases is not None:
            another = sources.insertion_bases(
                contig, position, vl_1, _max_recovery_length(vl_1), bases
            )
        another = another or bases[0:vl_1]
        alt1, alt2 = reference_base + another, reference_base + bases
        if alt1 == alt2:
            return None  # retry semantics -> full lattice
        return category, reference_base, f"{alt1},{alt2}"

    if category == "homo_del":
        variant_length = _winning_indel_candidate(category, vl1, vl2)
        bases, length = recover_deletion_bases(
            x, variant_length, contig, position, reference_sequence, sources
        )
        if length == 0:
            return None
        reference_base = reference_sequence[center] + bases
        return category, reference_base, reference_base[0]

    if category == "het_acgt_del":
        variant_length = _winning_indel_candidate(category, vl1, vl2)
        het_base = "ACGT"[int(np.argmax(gt21_p[np.asarray(_HET_DEL_GT21, dtype=int)]))]
        bases, length = recover_deletion_bases(
            x, variant_length, contig, position, reference_sequence, sources
        )
        if length == 0:
            return None
        reference_base = reference_sequence[center] + bases
        alternate_base = reference_base[0]
        if het_base != reference_base[0]:
            alternate_base = f"{alternate_base},{het_base + reference_base[1:]}"
        return category, reference_base, alternate_base

    if category == "het_deldel":
        vl_1, vl_2 = _winning_indel_candidate(category, vl1, vl2)
        bases, length = recover_deletion_bases(
            x, vl_2, contig, position, reference_sequence, sources
        )
        if length == 0:
            return None
        reference_base = reference_sequence[center] + bases
        alt1 = reference_base[0]
        alt2 = reference_base[0] + reference_base[vl_1 + 1:]
        if not (alt1 != alt2 and reference_base != alt1 and reference_base != alt2):
            return None
        return category, reference_base, f"{alt1},{alt2}"

    if category == "het_insdel":
        vl_del, vl_ins = _winning_indel_candidate(category, vl1, vl2)
        ins_bases, ins_len = recover_insertion_bases(x, vl_ins, contig, position, sources)
        del_bases, del_len = recover_deletion_bases(
            x, vl_del, contig, position, reference_sequence, sources
        )
        if ins_len == 0 or del_len == 0:
            return None
        reference_base = reference_sequence[center] + del_bases
        alternate_base = "{},{}".format(
            reference_base[0], reference_base[0] + ins_bases + reference_base[1:]
        )
        return category, reference_base, alternate_base

    return None


# ---------------------------------------------------------------------------
# Site decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SiteCall:
    """One decoded site (pre-VCF)."""

    category: str                      # winning lattice category
    reference_base: str
    alternate_base: str
    genotype_string: str
    quality_score: int
    read_depth: int
    allele_frequency: float
    is_reference: bool
    is_multi: bool


def _homo_snp_bases(gt21_p) -> Tuple[str, str]:
    label = HOMO_SNP_LABELS[int(np.argmax([gt21_p[g] for g in HOMO_SNP_GT21]))]
    return label[0], label[1]


def _hetero_snp_bases(gt21_p) -> Tuple[str, str]:
    label = HETERO_SNP_LABELS[int(np.argmax([gt21_p[g] for g in HETERO_SNP_GT21]))]
    return label[0], label[1]


def quality_score_from(reference, alternate, genotype_string, gt21_p, genotype_p) -> int:
    """Phred-like score: int(round(t^2)) with t = max(-10*log10(e) *
    ln((1-p)/p) + 16, 0), p = gt21_prob * genotype_prob (ref :568-586)."""
    genotype_1, genotype_2 = int(genotype_string[0]), int(genotype_string[2])
    gt21 = gt21_code_from(reference, alternate, genotype_1, genotype_2)
    genotype = genotype_for_task(genotype_code_from(genotype_1, genotype_2))
    # float() promotion matters: in float32 the 1e-300 guard underflows to 0
    # and p == 1.0 would raise a math domain error
    p = float(gt21_p[gt21]) * float(genotype_p[genotype])
    tmp = max((-10 * log(e, 10)) * log(((1.0 - p) + 1e-300) / (p + 1e-300)) + 16, 0)
    return int(round(tmp * tmp))


def decode_alleles(
    x: np.ndarray,
    reference_sequence: str,
    contig: str,
    position: int,
    gt21_p: np.ndarray,
    genotype_p: np.ndarray,
    vl1_p: np.ndarray,
    vl2_p: np.ndarray,
    sources: IndelSources,
):
    """The argmax-with-retry loop (ref call_var.py:693-947).

    Returns (category, reference_base, alternate_base); category is one of
    the lattice names or 'homo_ref'; bases may be None if decode degenerates.
    """
    center = FLANKING_BASE_NUM
    reference_base_acgt = BASE2ACGT[reference_sequence[center]]
    lattice = OutcomeLattice(gt21_p, genotype_p, vl1_p, vl2_p, reference_base_acgt)

    while True:
        category, idx = lattice.pick()

        if category == "homo_ref":
            return "homo_ref", reference_base_acgt, reference_base_acgt

        if category == "homo_snp":
            base1, base2 = _homo_snp_bases(gt21_p)
            reference_base = reference_sequence[center]
            alternate_base = base1 if base1 != reference_base else base2
            return category, reference_base, alternate_base

        if category == "hetero_snp":
            base1, base2 = _hetero_snp_bases(gt21_p)
            reference_base = reference_sequence[center]
            if base1 != reference_base and base2 != reference_base:
                alternate_base = f"{base1},{base2}"
            else:
                alternate_base = base1 if base1 != reference_base else base2
            return category, reference_base, alternate_base

        if category == "homo_ins":
            variant_length = int(lattice.homo_ins_lengths[idx])
            lattice.mask(category, idx)
            bases, length = recover_insertion_bases(x, variant_length, contig, position, sources)
            if length == 0:
                continue
            reference_base = reference_sequence[center]
            return category, reference_base, reference_base + bases

        if category == "het_acgt_ins":
            variant_length = int(lattice.het_acgt_ins_lengths[idx])
            het_base = str(lattice.het_acgt_ins_bases[idx])
            lattice.mask(category, idx)
            bases, length = recover_insertion_bases(x, variant_length, contig, position, sources)
            if length == 0:
                continue
            reference_base = reference_sequence[center]
            alternate_base = reference_base + bases
            if het_base != reference_base:
                alternate_base = f"{het_base},{alternate_base}"
            return category, reference_base, alternate_base

        if category == "het_insins":
            vl_1, vl_2 = (int(v) for v in lattice.het_insins_pairs[idx])
            lattice.mask(category, idx)
            bases, length = recover_insertion_bases(x, vl_2, contig, position, sources)
            if length == 0:
                continue
            reference_base = reference_sequence[center]
            alternate_base = reference_base + bases
            another = ""
            if sources.insertion_bases is not None:
                another = sources.insertion_bases(
                    contig, position, vl_1, _max_recovery_length(vl_1), bases
                )
            another = another or bases[0:vl_1]
            alt1, alt2 = reference_base + another, alternate_base
            if alt1 != alt2:
                return category, reference_base, f"{alt1},{alt2}"
            continue  # identical alleles -> retry (ref :838-841)

        if category == "homo_del":
            variant_length = int(lattice.homo_del_lengths[idx])
            lattice.mask(category, idx)
            bases, length = recover_deletion_bases(
                x, variant_length, contig, position, reference_sequence, sources
            )
            if length == 0:
                continue
            reference_base = reference_sequence[center] + bases
            return category, reference_base, reference_base[0]

        if category == "het_acgt_del":
            variant_length = int(lattice.het_acgt_del_lengths[idx])
            het_base = str(lattice.het_acgt_del_bases[idx])
            lattice.mask(category, idx)
            bases, length = recover_deletion_bases(
                x, variant_length, contig, position, reference_sequence, sources
            )
            if length == 0:
                continue
            reference_base = reference_sequence[center] + bases
            alternate_base = reference_base[0]
            if het_base != reference_base[0]:
                alternate_base = f"{alternate_base},{het_base + reference_base[1:]}"
            return category, reference_base, alternate_base

        if category == "het_deldel":
            vl_1, vl_2 = (int(v) for v in lattice.het_deldel_pairs[idx])
            lattice.mask(category, idx)
            bases, length = recover_deletion_bases(
                x, vl_2, contig, position, reference_sequence, sources
            )
            if length == 0:
                continue
            reference_base = reference_sequence[center] + bases
            alt1 = reference_base[0]
            alt2 = reference_base[0] + reference_base[vl_1 + 1:]
            if alt1 != alt2 and reference_base != alt1 and reference_base != alt2:
                return category, reference_base, f"{alt1},{alt2}"
            continue  # degenerate -> retry (ref :905-913)

        if category == "het_insdel":
            vl_del, vl_ins = (int(v) for v in lattice.het_insdel_pairs[idx])
            lattice.mask(category, idx)
            ins_bases, ins_len = recover_insertion_bases(x, vl_ins, contig, position, sources)
            del_bases, del_len = recover_deletion_bases(
                x, vl_del, contig, position, reference_sequence, sources
            )
            if ins_len == 0 or del_len == 0:
                continue
            reference_base = reference_sequence[center] + del_bases
            alternate_base = "{},{}".format(
                reference_base[0], reference_base[0] + ins_bases + reference_base[1:]
            )
            return category, reference_base, alternate_base


_HET_CATEGORIES = {
    "hetero_snp", "het_acgt_ins", "het_insins", "het_acgt_del", "het_deldel", "het_insdel",
}
_HOMO_CATEGORIES = {"homo_snp", "homo_ins", "homo_del"}


def _supported_reads(x: np.ndarray, category: str, alternate_base: str, reference_base: str, is_multi: bool) -> float:
    """Alt-supporting read count from the tensor center columns
    (ref call_var.py:1097-1150)."""
    center = FLANKING_BASE_NUM

    def snp_support(base: str) -> float:
        b = BASE2NUM[base]
        return float(
            x[center, b, CH_SNP] + x[center, b + 4, CH_SNP]
            + x[center, b, CH_REFERENCE] + x[center, b + 4, CH_REFERENCE]
        )

    if category == "homo_ref":
        b = BASE2NUM[reference_base]
        return float(x[center, b, CH_REFERENCE] + x[center, b + 4, CH_REFERENCE])
    if category in ("homo_snp", "hetero_snp"):
        return sum(snp_support(b) for b in str(alternate_base) if b != ",")
    if category in ("homo_ins", "het_insins"):
        return float(x[center + 1, :, CH_INSERT].sum() - x[center + 1, :, CH_SNP].sum())
    if category == "het_acgt_ins":
        extra = snp_support(alternate_base.split(",")[0][0]) if is_multi else 0.0
        return float(x[center + 1, :, CH_INSERT].sum() - x[center + 1, :, CH_SNP].sum()) + extra
    if category in ("homo_del", "het_deldel"):
        return float(x[center + 1, :, CH_DELETE].sum())
    if category == "het_acgt_del":
        extra = snp_support(alternate_base.split(",")[1][0]) if is_multi else 0.0
        return float(x[center + 1, :, CH_DELETE].sum()) + extra
    if category == "het_insdel":
        return float(
            x[center + 1, :, CH_INSERT].sum()
            + x[center + 1, :, CH_DELETE].sum()
            - x[center + 1, :, CH_SNP].sum()
        )
    return 0.0


def decode_site(
    x: np.ndarray,
    chromosome: str,
    position: int,
    reference_sequence: str,
    gt21_p: np.ndarray,
    genotype_p: np.ndarray,
    vl1_p: np.ndarray,
    vl2_p: np.ndarray,
    output_config: OutputConfig,
    sources: IndelSources = IndelSources(),
) -> Optional[SiteCall]:
    """Full site decode -> SiteCall, or None when the site produces no row
    (ref call_var.py:1002-1196 output_with)."""
    center = FLANKING_BASE_NUM
    if reference_sequence[center] not in BASIC_BASES:
        return None

    read_depth = float(
        (x[center, :, CH_DELETE] + x[center, :, CH_REFERENCE]).sum()
    )
    if read_depth == 0:
        return None

    category, reference_base, alternate_base = decode_alleles(
        x, reference_sequence, chromosome, position,
        gt21_p, genotype_p, vl1_p, vl2_p, sources,
    )
    return assemble_site_call(
        category, reference_base, alternate_base,
        x, gt21_p, genotype_p, output_config,
    )


def assemble_site_call(
    category: str,
    reference_base,
    alternate_base,
    x: np.ndarray,
    gt21_p: np.ndarray,
    genotype_p: np.ndarray,
    output_config: OutputConfig,
) -> Optional[SiteCall]:
    """Genotype/AF/quality/filters for already-decoded alleles
    (the second half of the reference's output_with)."""
    center = FLANKING_BASE_NUM
    read_depth = float(
        (x[center, :, CH_DELETE] + x[center, :, CH_REFERENCE]).sum()
    )
    is_reference = category == "homo_ref"

    if not output_config.is_debug and (
        (not output_config.is_show_reference and is_reference)
        or (not is_reference and reference_base == alternate_base)
    ):
        return None
    if reference_base is None or alternate_base is None:
        return None

    is_multi = "," in str(alternate_base)

    if output_config.is_haploid_precision_mode_enabled and category in _HET_CATEGORIES:
        return None
    if output_config.is_haploid_sensitive_mode_enabled and is_multi:
        return None

    if is_reference:
        genotype_string = genotype_string_from(Genotype.homo_reference)
    elif category in _HOMO_CATEGORIES:
        genotype_string = genotype_string_from(Genotype.homo_variant)
    else:
        genotype_string = genotype_string_from(Genotype.hetero_variant)
    if is_multi:
        genotype_string = genotype_string_from(Genotype.hetero_variant_multi)

    supported = _supported_reads(x, category, str(alternate_base), reference_base, is_multi)
    allele_frequency = min(supported / read_depth, 1.0) if read_depth else 0.0

    quality_score = quality_score_from(
        reference_base, alternate_base, genotype_string, gt21_p, genotype_p
    )

    if (
        output_config.is_haploid_precision_mode_enabled
        or output_config.is_haploid_sensitive_mode_enabled
    ):
        genotype_string = "1" if "1" in genotype_string else "0"

    return SiteCall(
        category=category,
        reference_base=reference_base,
        alternate_base=alternate_base,
        genotype_string=genotype_string,
        quality_score=quality_score,
        read_depth=int(read_depth),
        allele_frequency=allele_frequency,
        is_reference=is_reference,
        is_multi=is_multi,
    )
