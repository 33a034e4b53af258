"""Truth-variant extraction from a VCF (GetTruth equivalent).

Parses a (optionally gzipped) truth VCF into 'ctg pos ref alt gt1 gt2'
records with the reference's semantics
(reference dataPrepScripts/GetTruth.py):

- genotype read from the last column's GT field, '.'->0, sorted ascending
- '*' (spanning deletion) alleles resolved against the reference FASTA into
  an explicit deletion record at pos-1 (:29-55)
- same-position records merged into multiallelic 1/2 records (:57-71)
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Iterator, List, Optional, TextIO

import contextlib

from clair_tpu_torch.data.tensor_stream import open_maybe_gzip
from clair_tpu_torch.io.fasta import FastaReader


@contextlib.contextmanager
def _closing_iter(it):
    try:
        yield it
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


@dataclass
class TruthVariant:
    chromosome: str
    position: str
    reference: str
    alternate: str
    genotype_1: str
    genotype_2: str

    def line(self) -> str:
        return " ".join(
            [self.chromosome, self.position, self.reference, self.alternate,
             self.genotype_1, self.genotype_2]
        )


def _expand_star_alleles(info: TruthVariant, fasta: Optional[FastaReader]) -> List[TruthVariant]:
    if "*" not in info.alternate:
        return [info]
    if fasta is None:
        raise ValueError("a reference FASTA is required when ALT contains '*'")
    alternate_list = info.alternate.split(",")
    if len(alternate_list) > 1 and alternate_list[1] == "*":
        alternate_list[0], alternate_list[1] = alternate_list[1], info.alternate[0]
    out = []
    for alt in alternate_list:
        if alt == "*":
            new_pos = int(info.position) - 1
            prev_base = fasta.fetch(info.chromosome, new_pos - 1, new_pos)
            out.append(
                TruthVariant(
                    info.chromosome, str(new_pos),
                    prev_base + info.reference[0], prev_base, "0", "1",
                )
            )
        else:
            out.append(
                TruthVariant(
                    info.chromosome, info.position, info.reference, alt, "0", "1"
                )
            )
    return out


def _merge(info_1: TruthVariant, info_2: TruthVariant) -> TruthVariant:
    """Merge two records at the same position into one 1/2 multiallelic
    (ref GetTruth.py:57-71)."""
    if "," in info_1.reference or "," in info_1.alternate:
        return info_1
    if info_1.reference == info_2.reference:
        if info_1.alternate == info_2.alternate:
            return info_1
        return TruthVariant(
            info_1.chromosome, info_1.position, info_1.reference,
            f"{info_1.alternate},{info_2.alternate}", "1", "2",
        )
    if len(info_1.alternate) > len(info_2.alternate):
        info_1, info_2 = info_2, info_1
    suffix = info_2.reference[len(info_1.reference) - len(info_2.reference):]
    return TruthVariant(
        info_1.chromosome, info_1.position, info_2.reference,
        f"{info_1.alternate + suffix},{info_2.alternate}", "1", "2",
    )


def _vcf_rows(vcf_path: str, ctg_name: str, ctg_start: Optional[int]):
    """(rows, is_indexed): a tabix-windowed line iterator when a .tbi sits
    next to a bgzipped VCF (ref GetTruth.py:88-95), else the full stream."""
    import os

    if str(vcf_path).endswith(".gz") and ctg_start is not None and os.path.isfile(
        str(vcf_path) + ".tbi"
    ):
        try:
            from clair_tpu_torch.io.tbi import indexed_vcf_lines

            rows = indexed_vcf_lines(vcf_path, ctg_name, max(ctg_start - 1, 0))
            if rows is not None:
                return rows, True
        except Exception:
            pass
    return open_maybe_gzip(vcf_path), False


def truth_variants_from_vcf(
    vcf_path: str,
    ctg_name: str,
    ctg_start: Optional[int] = None,
    ctg_end: Optional[int] = None,
    fasta: Optional[FastaReader] = None,
) -> Iterator[TruthVariant]:
    is_region = ctg_start is not None and ctg_end is not None
    buffered: Optional[TruthVariant] = None
    buffered_pos = -1

    rows, is_indexed = _vcf_rows(vcf_path, ctg_name, ctg_start if is_region else None)
    seen_contig = False
    with rows if hasattr(rows, "__exit__") else _closing_iter(rows) as fh:
        for row in fh:
            columns = row.strip().split()
            if not columns or columns[0].startswith("#"):
                continue
            chromosome, position = columns[0], columns[1]
            if chromosome != ctg_name:
                # sorted VCF + indexed seek: a later contig ends the window
                if is_indexed and seen_contig:
                    break
                continue
            seen_contig = True
            if is_region:
                if int(position) > ctg_end:
                    if is_indexed:
                        break  # coordinate-sorted: nothing further overlaps
                    continue
                if int(position) < ctg_start:
                    continue
            reference, alternate, last_column = columns[3], columns[4], columns[-1]
            genotype = (
                last_column.split(":")[0].replace("/", "|").replace(".", "0").split("|")
            )
            genotype_1, genotype_2 = genotype[0], genotype[-1]
            if int(genotype_1) > int(genotype_2):
                genotype_1, genotype_2 = genotype_2, genotype_1

            info = TruthVariant(
                chromosome, position, reference, alternate, genotype_1, genotype_2
            )
            for expanded in _expand_star_alleles(info, fasta):
                if int(expanded.position) == buffered_pos:
                    buffered = _merge(buffered, expanded)
                else:
                    if buffered is not None:
                        yield buffered
                    buffered = expanded
                    buffered_pos = int(expanded.position)
    if buffered is not None:
        yield buffered


def write_truth(
    vcf_path: str,
    ctg_name: str,
    output: TextIO = sys.stdout,
    ctg_start: Optional[int] = None,
    ctg_end: Optional[int] = None,
    fasta: Optional[FastaReader] = None,
) -> int:
    n = 0
    for variant in truth_variants_from_vcf(vcf_path, ctg_name, ctg_start, ctg_end, fasta):
        print(variant.line(), file=output)
        n += 1
    return n
