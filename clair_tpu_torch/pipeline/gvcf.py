"""gVCF output mode: reference-confidence blocks between variant rows.

The reference caller emits plain VCF only (call_var.py:1184-1196); gVCF
is the Clair3-era extension users need for joint genotyping (GLnexus /
GATK CombineGVCFs style merging), listed as this framework's remaining
feature candidate. Flag names (``--gvcf``, ``--base_err``,
``--gq_bin_size``) follow the Clair3 CLI so existing pipelines map over.

The design is columnar like the rest of this pipeline: the candidate
counts matrix the window scan already produces (data/pileup.py
select_candidates input) doubles as the per-position reference evidence,
so a window's non-variant confidence is three vectorized numpy ops plus
a ``reduceat`` over GQ-bin change points — never a per-position Python
loop, and with the fused region open (clair_region_open2) the counts
come for free.

Reference-confidence model: the phred-scaled likelihood margin between
hom-ref (per-read error ``base_err``) and het (allele balance 0.5),

    GQ = 10 * [ ref*log10(2*(1-e)) + nonref*log10(2*e) ]   clipped [0, 99]

so every clean ref read adds ~3 to GQ and every discordant read
subtracts ~25 (e = 0.001). Blocks are GQ-binned (``gq_bin_size``) and
break at variant rows, bin changes, and window edges.

Output grammar (GATK gVCF conventions):
- non-variant block rows: ``POS . REF <NON_REF> 0 . END=end
  GT:GQ:MIN_DP:PL 0/0:gq:min_dp:0,gq,2gq``
- variant rows keep the caller's columns with ``,<NON_REF>`` appended to
  ALT and a PL vector appended to FORMAT (0 for the called genotype, the
  row's QUAL — the decode lattice's phred margin — for the rest; the
  network heads don't expose full genotype likelihoods, so the margin is
  the honest PL surrogate).
- explicit reference rows (ALT ``.``; --show_ref) are dropped: their
  evidence is carried by the surrounding block.
"""

from __future__ import annotations

from typing import IO, Iterable, Optional, Tuple

import numpy as np

from clair_tpu_torch.io.vcf import VcfWriter

GVCF_HEADER_EXTRA = """\
##ALT=<ID=NON_REF,Description="Represents any possible alternative allele at this location">
##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the region described in this record">
##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="Minimum DP observed within the GVCF block">
##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods rounded to the closest integer">"""


def reference_confidence(
    counts: np.ndarray, ref_bytes: bytes, base_err: float = 0.001
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-position (depth, GQ) for a window's candidate counts matrix.

    ``counts`` is the (region_length, 7) A,C,G,T,I,D,N matrix;
    ``ref_bytes`` the reference bytes starting at the region start. Depth
    matches candidate selection (A+C+G+T+N); positions whose reference
    byte has no pileup column (gaps, '*') get GQ 0.
    """
    from clair_tpu_torch.data.pileup import (
        CANDIDATE_COL_LUT, COL_A, COL_C, COL_G, COL_T, COL_N,
    )

    counts = np.asarray(counts)
    n = len(counts)
    depth = counts[:, [COL_A, COL_C, COL_G, COL_T, COL_N]].sum(axis=1)
    ref_raw = np.frombuffer(ref_bytes, dtype=np.uint8)[:n]
    ref_col = CANDIDATE_COL_LUT[ref_raw].astype(np.int64)
    rows = np.arange(n)
    ref_count = np.where(
        ref_col >= 0, counts[rows, np.clip(ref_col, 0, 6)], 0
    )
    nonref = depth - ref_count
    per_ref = 10.0 * np.log10(2.0 * (1.0 - base_err))
    per_nonref = 10.0 * np.log10(2.0 * base_err)  # negative
    gq = np.floor(ref_count * per_ref + nonref * per_nonref)
    gq = np.where(ref_col >= 0, gq, 0)
    return (
        depth.astype(np.int64),
        np.clip(gq, 0, 99).astype(np.int64),
    )


def _pl_index(a: int, b: int) -> int:
    """VCF canonical genotype ordering: index(a/b) = b*(b+1)/2 + a, a<=b."""
    if a > b:
        a, b = b, a
    return b * (b + 1) // 2 + a


def _variant_pl(genotype: str, n_alleles: int, qual: int) -> str:
    """PL vector for a variant row: 0 at the called genotype, the row's
    phred margin elsewhere (see module docstring)."""
    penalty = min(max(int(qual), 0), 990)
    size = n_alleles * (n_alleles + 1) // 2
    values = [penalty] * size
    try:
        alleles = [int(x) for x in genotype.replace("|", "/").split("/")]
        if len(alleles) == 1:
            # haploid modes emit single-allele GTs ('1'); place the 0 at
            # the homozygous cell of the diploid-convention vector
            alleles = alleles * 2
        a, b = alleles
        values[_pl_index(a, b)] = 0
    except (ValueError, IndexError):
        pass  # './.' or malformed: leave a flat vector
    return ",".join(str(v) for v in values)


class GvcfWriter(VcfWriter):
    """VcfWriter that interleaves captured variant rows with
    reference-confidence blocks, one genome window at a time.

    ``call_window`` brackets each window with begin_window/end_window;
    rows written in between (native blob via write_raw, Python sites via
    write_sites) are buffered, then merged against the window's
    (depth, GQ) vectors. Outside a window bracket it behaves exactly like
    VcfWriter, so header and passthrough writes are unchanged.
    """

    def __init__(
        self,
        output: IO,
        sample_name: str = "SAMPLE",
        contigs: Optional[Iterable[Tuple[str, int]]] = None,
        quality_score_for_pass: Optional[int] = None,
        gq_bin_size: int = 5,
    ):
        super().__init__(output, sample_name, contigs, quality_score_for_pass)
        self.header_extra = GVCF_HEADER_EXTRA
        self.gq_bin_size = max(int(gq_bin_size), 1)
        self._rows: Optional[list] = None
        self._window = None
        # (chrom, resume_pos): a variant REF span that ran past the last
        # window's end suppresses blocks up to resume_pos in the next
        # contiguous window, keeping the covered-exactly-once invariant
        # for deletions that cross window boundaries
        self._carry: Optional[Tuple[str, int]] = None

    # -- capture ----------------------------------------------------------

    def begin_window(self, work) -> None:
        self._rows = []
        self._window = getattr(work, "gvcf_data", None)

    def abandon_window(self) -> None:
        # a failed window writes NOTHING: its buffered variant rows are
        # partial and its confidence data covers candidates that were
        # never decoded; --resume re-runs the whole window. _carry is kept
        # — it belongs to the previous (successful) window's edge deletion
        self._rows = None
        self._window = None

    def write_raw(self, text: str) -> None:
        if self._rows is None:
            super().write_raw(text)
        else:
            self._rows.extend(
                line for line in text.split("\n") if line
            )

    def write_sites(self, rows) -> None:
        if self._rows is None:
            super().write_sites(rows)
        else:
            self._rows.extend(
                self.format_site(c, p, call) for c, p, call in rows
            )

    # -- merge ------------------------------------------------------------

    def end_window(self) -> None:
        rows, window = self._rows, self._window
        self._rows = None
        self._window = None
        if rows is None:
            return
        if window is None:
            # no per-window confidence data (e.g. a fallback path that
            # could not produce counts): emit the variant rows verbatim
            if rows:
                self._fh.write("\n".join(rows) + "\n")
            return

        chrom, start1, depth, gq, ref_bytes = window
        region_end1 = start1 + len(depth) - 1
        out = []
        cursor = start1
        if self._carry is not None:
            carry_chrom, carry_pos = self._carry
            if carry_chrom == chrom and carry_pos > start1:
                cursor = carry_pos
        self._carry = None
        for line in rows:
            fields = line.split("\t")
            pos = int(fields[1])
            if fields[4] == "." or fields[4] == fields[3]:
                # explicit reference row (--show_ref emits ALT == REF,
                # batch_decode.py hom-ref rows): covered by blocks
                continue
            if pos > cursor:
                self._emit_blocks(
                    out, chrom, start1, depth, gq, ref_bytes,
                    cursor, min(pos - 1, region_end1),
                )
            out.append(self._gvcf_variant_row(fields))
            cursor = max(cursor, pos + len(fields[3]))
        if cursor <= region_end1:
            self._emit_blocks(
                out, chrom, start1, depth, gq, ref_bytes, cursor, region_end1
            )
        elif cursor > region_end1 + 1:
            # a REF span extends into the next window (deletion at the
            # window edge); remember where its coverage ends. One writer
            # sees windows in genome order (threaded runner / sequential
            # call_bam), so the next end_window resumes there. The
            # multi-host queue writes windows to separate files and
            # cannot carry this — a boundary-spanning deletion may then
            # overlap the next window's first block by its tail bases.
            self._carry = (chrom, cursor)
        if out:
            self._fh.write("\n".join(out) + "\n")

    def _gvcf_variant_row(self, fields) -> str:
        """Append <NON_REF> to ALT and a PL vector to FORMAT/sample."""
        alts = fields[4].split(",") + ["<NON_REF>"]
        fields[4] = ",".join(alts)
        try:
            qual = int(float(fields[5]))
        except ValueError:
            qual = 0
        genotype = fields[9].split(":", 1)[0] if len(fields) > 9 else "./."
        fields[8] = fields[8] + ":PL"
        fields[9] = fields[9] + ":" + _variant_pl(
            genotype, 1 + len(alts), qual
        )
        return "\t".join(fields)

    def _emit_blocks(
        self, out, chrom, start1, depth, gq, ref_bytes, a1, b1
    ) -> None:
        """Reference blocks covering [a1, b1] (1-based inclusive), broken
        at GQ-bin changes; min depth / min GQ per block via reduceat."""
        lo = a1 - start1
        hi = b1 - start1 + 1
        if lo >= hi or lo < 0 or hi > len(depth):
            return
        d = depth[lo:hi]
        q = gq[lo:hi]
        bins = q // self.gq_bin_size
        change = np.flatnonzero(np.diff(bins)) + 1
        starts = np.concatenate(([0], change))
        ends = np.concatenate((change, [len(q)]))
        min_dp = np.minimum.reduceat(d, starts)
        min_gq = np.minimum.reduceat(q, starts)
        for s, e, dp, g in zip(starts, ends, min_dp, min_gq):
            pos = a1 + int(s)
            ref_base = chr(ref_bytes[pos - start1])
            out.append(
                "%s\t%d\t.\t%s\t<NON_REF>\t0\t.\tEND=%d\t"
                "GT:GQ:MIN_DP:PL\t0/0:%d:%d:0,%d,%d"
                % (
                    chrom, pos, ref_base, a1 + int(e) - 1,
                    int(g), int(dp), int(g), min(2 * int(g), 198),
                )
            )
