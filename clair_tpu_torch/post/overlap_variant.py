"""Overlapping-variant filter.

Drops the lower-quality call when a deletion's span overlaps a following
SNP or deletion, matching the reference filter's decision
(reference clair/post_processing/overlap_variant.py:29-152,
228-267; only the deletion-vs-SNP and deletion-vs-deletion checks are
active there). The decision is computed directly in genome coordinates
rather than through the reference's per-kind interval constructions: for
sorted a, b the active checks reduce to

    longest_deletion(a) > 0
    and b.position <= a.position + longest_deletion(a)
    and (b is SNP-like or longest_deletion(b) > 0)

where longest_deletion = max over present ALT alleles of
len(REF) - len(ALT) (the half-open deletion span [pos-1,
pos+longest_deletion) starts at pos-1 for every variant kind, so the
"does some interval start inside the deletion" question is just the
position bound above).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Iterable, List, Optional, TextIO


@dataclass
class Variant:
    chromosome: str
    position: int
    reference_base: str
    alternate_base: str
    alternate_base_multi: Optional[str]
    quality_score: int
    genotype: str
    depth: str
    allele_frequency: str

    @classmethod
    def from_row(cls, row: str) -> "Variant":
        columns = row.split("\t")
        alternates = columns[4].split(",")
        last = columns[-1].split(":")
        return cls(
            chromosome=columns[0],
            position=int(columns[1]),
            reference_base=columns[3],
            alternate_base=alternates[0],
            alternate_base_multi=alternates[1] if len(alternates) > 1 else None,
            quality_score=int(float(columns[5])),
            genotype=last[0],
            depth=last[2],
            allele_frequency=last[3],
        )

    def to_row(self) -> str:
        alternates = ",".join(
            [self.alternate_base]
            + ([] if self.alternate_base_multi is None else [self.alternate_base_multi])
        )
        last = ":".join(
            [self.genotype, str(self.quality_score), self.depth, self.allele_frequency]
        )
        return "\t".join(
            [self.chromosome, str(self.position), ".", self.reference_base,
             alternates, str(self.quality_score), ".", ".", "GT:GQ:DP:AF", last]
        )


def _alt_lengths(variant: Variant) -> List[int]:
    lengths = [len(variant.alternate_base)]
    if variant.alternate_base_multi is not None:
        lengths.append(len(variant.alternate_base_multi))
    return lengths


def _longest_deletion(variant: Variant) -> int:
    """Longest deletion among the present ALT alleles, in reference bases
    (<= 0 when no allele deletes anything)."""
    ref_len = len(variant.reference_base)
    return max(ref_len - alt_len for alt_len in _alt_lengths(variant))


def _is_snp_like(variant: Variant) -> bool:
    ref_len = len(variant.reference_base)
    return any(alt_len == ref_len for alt_len in _alt_lengths(variant))


def variants_overlap(variant_1: Variant, variant_2: Variant) -> bool:
    if variant_1.chromosome != variant_2.chromosome:
        return False
    if variant_1.position > variant_2.position:
        variant_1, variant_2 = variant_2, variant_1
    deletion_span = _longest_deletion(variant_1)
    if deletion_span <= 0:
        return False
    if variant_2.position > variant_1.position + deletion_span:
        return False
    return _is_snp_like(variant_2) or _longest_deletion(variant_2) > 0


def filter_overlapping_variants(variants: Iterable[Variant]) -> List[Variant]:
    filtered: List[Variant] = []
    for variant in variants:
        if filtered and variants_overlap(filtered[-1], variant):
            # strict >: on a tie the later variant wins (ref :228-234)
            if filtered[-1].quality_score > variant.quality_score:
                continue
            filtered.pop()
        filtered.append(variant)
    return filtered


def run_filter(input_fh: TextIO = sys.stdin, output_fh: TextIO = sys.stdout) -> None:
    headers, variants = [], []
    for row in input_fh:
        row = row.rstrip("\n")
        if row.startswith("#"):
            headers.append(row)
        elif row:
            variants.append(Variant.from_row(row))
    for header in headers:
        print(header, file=output_fh)
    for variant in filter_overlapping_variants(variants):
        print(variant.to_row(), file=output_fh)
