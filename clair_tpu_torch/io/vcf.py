"""VCF output writer.

Header and row format match the reference caller's output
(reference clair/call_var.py:304-331, 1184-1196) so downstream
benchmarking tools (hap.py / rtg vcfeval) and the post-processing filters
see identical records.
"""

from __future__ import annotations

import sys
from typing import IO, Iterable, Optional, Tuple


HEADER_BODY = """\
##fileformat=VCFv4.1
##FILTER=<ID=PASS,Description="All filters passed">
##FILTER=<ID=LowQual,Description="Confidence in this variant being real is below calling threshold.">
##ALT=<ID=DEL,Description="Deletion">
##ALT=<ID=INS,Description="Insertion of novel sequence">
##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">
##INFO=<ID=LENGUESS,Number=.,Type=Integer,Description="Best guess of the indel length">
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">
##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read Depth">
##FORMAT=<ID=AF,Number=1,Type=Float,Description="Estimated allele frequency in the range (0,1)">"""


def filtration_value_from(quality_score_for_pass: Optional[int], quality_score: int) -> str:
    if quality_score_for_pass is None:
        return "."
    return "PASS" if quality_score >= quality_score_for_pass else "LowQual"


class VcfWriter:
    def __init__(
        self,
        output: IO = sys.stdout,
        sample_name: str = "SAMPLE",
        contigs: Optional[Iterable[Tuple[str, int]]] = None,
        quality_score_for_pass: Optional[int] = None,
    ):
        self._fh = output
        self.sample_name = sample_name
        self.contigs = list(contigs) if contigs else None
        self.quality_score_for_pass = quality_score_for_pass
        # extra header lines appended after HEADER_BODY (gVCF mode adds
        # NON_REF/END/MIN_DP/PL declarations; see pipeline/gvcf.py)
        self.header_extra: str = ""

    def begin_window(self, work) -> None:
        """Window bracket hook (no-op here; GvcfWriter buffers rows)."""

    def end_window(self) -> None:
        """Window bracket hook (no-op here; GvcfWriter merges blocks)."""

    def abandon_window(self) -> None:
        """Discard an open window bracket WITHOUT emitting anything
        (no-op here; GvcfWriter drops its buffered rows). Used when a
        window fails mid-decode: emitting its partial rows — and, in gVCF
        mode, hom-ref blocks over the undecoded remainder — would both
        fabricate calls and double-cover the window once --resume re-runs
        it."""

    def write_header(self) -> None:
        print(HEADER_BODY, file=self._fh)
        if self.header_extra:
            print(self.header_extra, file=self._fh)
        if self.contigs:
            for name, length in self.contigs:
                print(f"##contig=<ID={name},length={length}>", file=self._fh)
        print(
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t%s" % self.sample_name,
            file=self._fh,
        )

    def format_site(self, chromosome: str, position: int, call) -> str:
        """One SiteCall as a VCF row (ref call_var.py:1184-1196)."""
        filtration = filtration_value_from(self.quality_score_for_pass, call.quality_score)
        return (
            "%s\t%d\t.\t%s\t%s\t%d\t%s\t%s\tGT:GQ:DP:AF\t%s:%d:%d:%.4f"
            % (
                chromosome,
                position,
                call.reference_base,
                call.alternate_base,
                call.quality_score,
                filtration,
                ".",
                call.genotype_string,
                call.quality_score,
                call.read_depth,
                call.allele_frequency,
            )
        )

    def write_site(self, chromosome: str, position: int, call) -> None:
        print(self.format_site(chromosome, position, call), file=self._fh)

    def write_raw(self, text: str) -> None:
        """Write pre-formatted row text (the native decoder's output)."""
        self._fh.write(text)

    def write_sites(self, rows) -> None:
        """Bulk write of (chromosome, position, call) tuples — one IO call."""
        if not rows:
            return
        self._fh.write(
            "\n".join(self.format_site(c, p, call) for c, p, call in rows) + "\n"
        )

    def close(self) -> None:
        if self._fh not in (sys.stdout, sys.stderr):
            self._fh.close()


def make_writer(config, output_fh, contigs=None) -> "VcfWriter":
    """VcfWriter, or GvcfWriter when ``config.gvcf`` is set (duck-typed:
    reads gvcf/sample_name/qual/gq_bin_size off any config object)."""
    if getattr(config, "gvcf", False):
        from clair_tpu_torch.pipeline.gvcf import GvcfWriter

        return GvcfWriter(
            output_fh,
            sample_name=config.sample_name,
            contigs=contigs,
            quality_score_for_pass=config.qual,
            gq_bin_size=getattr(config, "gq_bin_size", 5),
        )
    return VcfWriter(
        output_fh,
        sample_name=config.sample_name,
        contigs=contigs,
        quality_score_for_pass=config.qual,
    )


def contigs_from_fai(fai_path: str):
    contigs = []
    with open(fai_path) as fh:
        for row in fh:
            columns = row.strip().split("\t")
            contigs.append((columns[0], int(columns[1])))
    return contigs
