"""Joint genotyping over single-sample gVCFs (GLnexus-style merge).

The reference stops at single-sample VCF output (clair/call_var.py:
1184-1196); multi-sample studies then hand the per-sample gVCFs to a
joint genotyper (GLnexus, GATK GenotypeGVCFs). This module is that
consumer, built on this framework's own gVCF grammar (pipeline/gvcf.py):
it both provides the feature and acts as the validation harness proving
the gVCFs this framework writes are merge-ready — every position of a
contig must be reconstructible as exactly one reference block or variant
REF span per sample, or the merge visibly degrades to './.'.

Semantics (the "naive GLnexus" core):

1. **Site unification** — variant rows from all samples are grouped by
   (chrom, pos); REF alleles at a site are unified to the longest one and
   each sample's ALTs are right-extended with the missing REF suffix
   (GLnexus's allele unification restricted to shared-start sites; sites
   at different starts are NOT range-joined).
2. **Genotype lifting** — each sample's GT indices are remapped into the
   joint ALT list.
3. **Reference filling** — a sample without a variant row at a unified
   site contributes ``0/0`` with GQ/DP from its reference block covering
   the site. If instead one of its OWN variant rows spans the site (a
   deletion whose REF span covers it), the fill is genotype-aware: REF
   haplotypes contribute ``0``, called deletion haplotypes contribute the
   VCF spanning-deletion allele ``*`` (GATK/GLnexus convention — never a
   fabricated ``0/0`` under a hom-alt deletion), anything else ``.``.
   With no coverage at all: ``./.`` (no data).
4. **QUAL** — max of the contributing rows' QUALs.

Output is one multi-sample VCF, rows in (contig-appearance, pos) order,
FORMAT ``GT:GQ:DP``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, IO, Iterable, List, Optional, Sequence, Tuple

from clair_tpu_torch.data.tensor_stream import open_maybe_gzip

_END_RE = re.compile(r"(?:^|;)END=(\d+)")


@dataclasses.dataclass
class GvcfVariant:
    position: int
    reference: str
    alternates: List[str]          # NON_REF stripped
    qual: float
    genotype: Tuple[Optional[int], Optional[int]]
    gq: Optional[int]
    depth: Optional[int]


@dataclasses.dataclass
class RefBlock:
    position: int
    end: int                       # inclusive
    gq: int
    min_dp: int


@dataclasses.dataclass
class GvcfSample:
    """One sample's parsed gVCF: per-contig variant rows + ref blocks,
    both in file order (gVCFs are position-sorted per contig)."""

    name: str
    variants: Dict[str, List[GvcfVariant]]
    blocks: Dict[str, List[RefBlock]]
    contig_order: List[str]

    def _keys(self, which: str, chrom: str) -> List[int]:
        cache = self.__dict__.setdefault("_key_cache", {})
        key = (which, chrom)
        if key not in cache:
            rows = getattr(self, which).get(chrom, ())
            cache[key] = [r.position for r in rows]
        return cache[key]

    def covering_at(self, chrom: str, pos: int):
        """What covers pos for this sample: a RefBlock, a GvcfVariant
        whose REF span contains pos, or None (no data)."""
        import bisect

        blocks = self.blocks.get(chrom, ())
        i = bisect.bisect_right(self._keys("blocks", chrom), pos) - 1
        if i >= 0 and blocks[i].position <= pos <= blocks[i].end:
            return blocks[i]
        # variant REF spans can nest/overlap (a long deletion followed by a
        # SNP inside its span), so the nearest-preceding row is not enough:
        # walk back while the running max span end still reaches pos (the
        # prefix-max array bounds the scan — once it drops below pos no
        # earlier row can cover it)
        variants = self.variants.get(chrom, ())
        keys = self._keys("variants", chrom)
        cache = self.__dict__.setdefault("_span_cache", {})
        if chrom not in cache:
            ends, running = [], -1
            for v in variants:
                running = max(running, v.position + len(v.reference) - 1)
                ends.append(running)
            cache[chrom] = ends
        prefix_max_end = cache[chrom]
        k = bisect.bisect_right(keys, pos) - 1
        while k >= 0 and prefix_max_end[k] >= pos:
            v = variants[k]
            if v.position <= pos < v.position + len(v.reference):
                return v
            k -= 1
        return None

    def coverage_at(self, chrom: str, pos: int) -> Optional[Tuple[int, int]]:
        """(gq, dp) of the evidence covering pos: a ref block, or the REF
        span of one of this sample's own variant rows (genotype-blind —
        the merge uses covering_at to decide WHAT that evidence means)."""
        cov = self.covering_at(chrom, pos)
        if cov is None:
            return None
        if isinstance(cov, RefBlock):
            return cov.gq, cov.min_dp
        return cov.gq or 0, cov.depth or 0


def _parse_gt(token: str) -> Tuple[Optional[int], Optional[int]]:
    parts = token.replace("|", "/").split("/")
    if len(parts) == 1:
        parts = parts * 2
    out = []
    for p in parts[:2]:
        out.append(None if p in (".", "") else int(p))
    return tuple(out)


def _sample_field(fmt: Sequence[str], sample: Sequence[str], key: str) -> Optional[str]:
    try:
        return sample[list(fmt).index(key)]
    except (ValueError, IndexError):
        return None


def parse_gvcf(path_or_fh, name: Optional[str] = None) -> GvcfSample:
    """Parse a gVCF (plain or gzip path, or an open text handle) through
    the framework's own reader into a GvcfSample."""
    if hasattr(path_or_fh, "read"):
        fh, close = path_or_fh, False
        path = getattr(path_or_fh, "name", "<stream>")
    else:
        fh, close = open_maybe_gzip(str(path_or_fh)), True
        path = str(path_or_fh)
    sample_name = name
    variants: Dict[str, List[GvcfVariant]] = {}
    blocks: Dict[str, List[RefBlock]] = {}
    contig_order: List[str] = []
    try:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                columns = line.split("\t")
                if sample_name is None:
                    sample_name = columns[9] if len(columns) > 9 else "SAMPLE"
                continue
            f = line.split("\t")
            chrom, pos = f[0], int(f[1])
            if chrom not in contig_order:
                contig_order.append(chrom)
            fmt = f[8].split(":") if len(f) > 8 else []
            sample = f[9].split(":") if len(f) > 9 else []
            alts = [a for a in f[4].split(",") if a and a != "<NON_REF>"]
            if not alts or f[4] == ".":
                m = _END_RE.search(f[7])
                end = int(m.group(1)) if m else pos + len(f[3]) - 1
                gq = _sample_field(fmt, sample, "GQ")
                dp = (_sample_field(fmt, sample, "MIN_DP")
                      or _sample_field(fmt, sample, "DP"))
                blocks.setdefault(chrom, []).append(RefBlock(
                    pos, end,
                    int(gq) if gq not in (None, ".") else 0,
                    int(dp) if dp not in (None, ".") else 0,
                ))
                continue
            gt = _sample_field(fmt, sample, "GT") or "./."
            gq = _sample_field(fmt, sample, "GQ")
            dp = _sample_field(fmt, sample, "DP")
            try:
                qual = float(f[5])
            except ValueError:
                qual = 0.0
            variants.setdefault(chrom, []).append(GvcfVariant(
                pos, f[3], alts, qual, _parse_gt(gt),
                int(gq) if gq not in (None, ".") else None,
                int(dp) if dp not in (None, ".") else None,
            ))
    finally:
        if close:
            fh.close()
    return GvcfSample(
        sample_name or path, variants, blocks, contig_order
    )


def _unify_site(rows: List[Optional[GvcfVariant]]) -> Tuple[str, List[str], List[Dict[int, int]]]:
    """Unify same-position rows: longest REF wins, sample ALTs are
    right-extended with the missing REF suffix, and each sample gets an
    allele-index remap {old -> joint}."""
    present = [v for v in rows if v is not None]
    reference = max((v.reference for v in present), key=len)
    joint_alts: List[str] = []
    remaps: List[Dict[int, int]] = []
    for v in rows:
        if v is None:
            remaps.append({})
            continue
        suffix = reference[len(v.reference):]
        remap = {0: 0}
        for i, alt in enumerate(v.alternates, start=1):
            # '*' (VCF spanning-deletion allele) is symbolic: never extend
            lifted = alt if alt == "*" else alt + suffix
            if lifted not in joint_alts:
                joint_alts.append(lifted)
            remap[i] = joint_alts.index(lifted) + 1
        remaps.append(remap)
    return reference, joint_alts, remaps


def _combine_sample_rows(rows: List[GvcfVariant]) -> GvcfVariant:
    """Collapse one sample's same-position rows (the split-multiallelic
    form GATK/`bcftools norm` emit: one ALT per row) into a single row, so
    no allele is silently dropped. Alleles are unified exactly like
    cross-sample rows; the genotype is rebuilt from the union of called
    alt alleles (two distinct alts -> het-alt a/b, one alt -> hom if any
    source row was hom else 0/x); GQ/DP/QUAL take the max."""
    if len(rows) == 1:
        return rows[0]
    reference = max((r.reference for r in rows), key=len)
    alts: List[str] = []
    called: List[int] = []
    any_hom_alt = False
    for r in rows:
        suffix = reference[len(r.reference):]
        local = {0: 0}
        for i, alt in enumerate(r.alternates, start=1):
            lifted = alt if alt == "*" else alt + suffix
            if lifted not in alts:
                alts.append(lifted)
            local[i] = alts.index(lifted) + 1
        a, b = r.genotype
        row_called = [local[x] for x in (a, b)
                      if x is not None and x in local and local[x] != 0]
        if len(row_called) == 2 and row_called[0] == row_called[1]:
            any_hom_alt = True
        for j in row_called:
            if j not in called:
                called.append(j)
    if not called:
        genotype: Tuple[Optional[int], Optional[int]] = (0, 0)
    elif len(called) == 1:
        genotype = (called[0], called[0]) if any_hom_alt else (0, called[0])
    else:
        genotype = (called[0], called[1])
    gqs = [r.gq for r in rows if r.gq is not None]
    dps = [r.depth for r in rows if r.depth is not None]
    return GvcfVariant(
        rows[0].position, reference, alts,
        max(r.qual for r in rows), genotype,
        max(gqs) if gqs else None, max(dps) if dps else None,
    )


def merge_gvcfs(
    inputs: Iterable,
    output_fh: IO,
    sample_names: Optional[Sequence[str]] = None,
) -> int:
    """Merge parsed-or-pathlike gVCF inputs into one joint VCF; returns
    the number of joint variant rows written."""
    samples: List[GvcfSample] = []
    for i, item in enumerate(inputs):
        if isinstance(item, GvcfSample):
            samples.append(item)
        else:
            name = sample_names[i] if sample_names else None
            samples.append(parse_gvcf(item, name))
    if not samples:
        raise ValueError("no gVCF inputs")

    contigs: List[str] = []
    for s in samples:
        for c in s.contig_order:
            if c not in contigs:
                contigs.append(c)

    output_fh.write("##fileformat=VCFv4.2\n")
    output_fh.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
    output_fh.write('##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">\n')
    output_fh.write('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">\n')
    output_fh.write(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(s.name for s in samples) + "\n"
    )

    written = 0
    for chrom in contigs:
        positions = sorted({
            v.position for s in samples for v in s.variants.get(chrom, ())
        })
        by_sample = []
        for s in samples:
            grouped: Dict[int, List[GvcfVariant]] = {}
            for v in s.variants.get(chrom, ()):
                grouped.setdefault(v.position, []).append(v)
            by_sample.append(
                {p: _combine_sample_rows(vs) for p, vs in grouped.items()}
            )
        for pos in positions:
            rows = [m.get(pos) for m in by_sample]
            reference, joint_alts, remaps = _unify_site(rows)

            def star_index() -> int:
                # the VCF spanning-deletion allele; appended to the joint
                # ALT list on first use at this site
                if "*" not in joint_alts:
                    joint_alts.append("*")
                return joint_alts.index("*") + 1

            calls = []
            qual = 0.0
            for s, v, remap in zip(samples, rows, remaps):
                if v is not None:
                    a, b = v.genotype
                    gt = "/".join(
                        "." if x is None or x not in remap
                        else str(remap[x])
                        for x in (a, b)
                    )
                    gq = v.gq if v.gq is not None else int(v.qual)
                    dp = v.depth if v.depth is not None else "."
                    calls.append(f"{gt}:{gq}:{dp}")
                    qual = max(qual, v.qual)
                    continue
                cov = s.covering_at(chrom, pos)
                if cov is None:
                    calls.append("./.:.:.")
                elif isinstance(cov, RefBlock):
                    calls.append(f"0/0:{cov.gq}:{cov.min_dp}")
                else:
                    # the sample's own upstream variant row spans pos; its
                    # REF span is reference evidence ONLY for haplotypes
                    # that carry the REF allele. A called deletion allele
                    # means pos is DELETED on that haplotype — the VCF
                    # spanning-deletion allele '*' (GATK/GLnexus form),
                    # never 0/0
                    hap = []
                    for x in cov.genotype:
                        if x == 0:
                            hap.append("0")
                        elif (x is not None and 1 <= x <= len(cov.alternates)
                              and cov.alternates[x - 1] != "*"
                              and pos >= cov.position
                              + len(cov.alternates[x - 1])):
                            hap.append(str(star_index()))
                        else:
                            # unknown: uncalled haplotype, a nested '*',
                            # or pos inside the alt's surviving bases
                            # (complex substitution — base identity vs the
                            # site REF is not derivable)
                            hap.append(".")
                    calls.append(
                        f"{'/'.join(hap)}:{cov.gq or 0}:{cov.depth or 0}"
                    )
            output_fh.write(
                f"{chrom}\t{pos}\t.\t{reference}\t{','.join(joint_alts)}\t"
                f"{qual:.0f}\t.\t.\tGT:GQ:DP\t" + "\t".join(calls) + "\n"
            )
            written += 1
    return written
