"""Synthetic diploid genome / read simulator.

The reference's only end-to-end check is a downloadable demo script
(SURVEY §4); this framework ships a self-contained simulator instead:
plant variants on two haplotypes, generate error-free or noisy reads, and
write reference FASTA + sorted BAM + truth VCF with this framework's own
IO stack. Used by the demo pipeline and the full-loop tests.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from clair_tpu_torch.io.bam import BamWriter
from clair_tpu_torch.io.fasta import build_fai


@dataclasses.dataclass
class PlantedVariant:
    position: int          # 1-based
    ref: str
    alt: str
    genotype: Tuple[int, int]   # (0,1) het / (1,1) hom

    @property
    def is_het(self) -> bool:
        return self.genotype == (0, 1)


@dataclasses.dataclass(frozen=True)
class ErrorProfile:
    """Per-base sequencing-error model applied to simulated reads.

    ONT_R94 approximates R9.4.1 nanopore behavior — the reference's target
    platform (README.md:57-59) — mismatches plus indel-dominated errors
    with homopolymer-biased deletions and duplication-style insertions.
    """

    mismatch: float = 0.0
    insertion: float = 0.0          # per-base prob of an insertion after it
    deletion: float = 0.0           # per-base prob of dropping it
    homopolymer_boost: float = 0.0  # extra deletion prob per repeat base (capped x4)
    max_indel: int = 3


CLEAN = ErrorProfile()
ONT_R94 = ErrorProfile(
    mismatch=0.05, insertion=0.02, deletion=0.03,
    homopolymer_boost=0.02, max_indel=3,
)
# PacBio CCS/HiFi: ~0.5% total, indel-leaning in homopolymers
PACBIO_CCS = ErrorProfile(
    mismatch=0.001, insertion=0.001, deletion=0.002,
    homopolymer_boost=0.003, max_indel=2,
)
# Illumina: low, mismatch-dominated
# per-platform simulation recipes shared by the vendored-checkpoint
# training script (examples/train_synthetic.py) and its held-out
# regression test, so the two can never drift apart
PLATFORM_RECIPES = {
    "ont": dict(profile_name="ONT_R94", coverage=50, read_length=900,
                read_length_sigma=0.4),
    "ccs": dict(profile_name="PACBIO_CCS", coverage=30, read_length=2000,
                read_length_sigma=0.2),
    "ilmn": dict(profile_name="ILLUMINA", coverage=60, read_length=150,
                 read_length_sigma=0.0),
}

ILLUMINA = ErrorProfile(mismatch=0.002, insertion=0.0001, deletion=0.0001,
                        max_indel=1)


def corrupt_read(
    rs: np.random.RandomState,
    cigar: List[Tuple[int, str]],
    seq: str,
    profile: ErrorProfile,
) -> Tuple[List[Tuple[int, str]], str]:
    """Inject profile errors into an (aligned) read, updating the CIGAR.

    Mismatches substitute; deletions drop the base (M -> D against the
    reference) with probability boosted inside homopolymer runs; insertions
    add 1..max_indel bases after the base, biased toward duplicating it
    (nanopore stay errors). First/last read bases never delete so CIGARs
    stay M-anchored.
    """
    if profile == CLEAN:
        return cigar, seq
    out_cigar: List[Tuple[int, str]] = []
    out_seq: List[str] = []

    def push(op: str, length: int):
        if length <= 0:
            return
        if out_cigar and out_cigar[-1][1] == op:
            out_cigar[-1] = (out_cigar[-1][0] + length, op)
        else:
            out_cigar.append((length, op))

    # homopolymer run length at each read position (on the query sequence)
    runs = np.ones(len(seq), dtype=np.int32)
    for i in range(1, len(seq)):
        if seq[i] == seq[i - 1]:
            runs[i] = runs[i - 1] + 1
    u = rs.rand(len(seq), 2)

    qpos = 0
    n = len(seq)
    for length, op in cigar:
        if op in "SI":
            out_seq.append(seq[qpos:qpos + length])
            push(op, length)
            qpos += length
            continue
        if op in "DN":
            push(op, length)
            continue
        for _ in range(length):  # M/=/X
            base = seq[qpos]
            boost = profile.homopolymer_boost * min(int(runs[qpos]) - 1, 4)
            p_del = (profile.deletion + boost) if 0 < qpos < n - 1 else 0.0
            draw = u[qpos, 0]
            if draw < profile.mismatch:
                out_seq.append(rs.choice([b for b in "ACGT" if b != base]))
                push("M", 1)
            elif draw < profile.mismatch + p_del:
                push("D", 1)          # base dropped: ref consumed, query not
            else:
                out_seq.append(base)
                push("M", 1)
            if u[qpos, 1] < profile.insertion and 0 < qpos < n - 1:
                k = int(rs.randint(1, profile.max_indel + 1))
                # stay errors duplicate the current base most of the time
                ins = (
                    base * k if rs.rand() < 0.7
                    else "".join(rs.choice(list("ACGT"), k))
                )
                out_seq.append(ins)
                push("I", k)
            qpos += 1
    return out_cigar, "".join(out_seq)


def random_reference(rs: np.random.RandomState, length: int) -> str:
    return "".join(rs.choice(list("ACGT"), length))


# per-platform parameter sets for the fast vectorized simulator; rates
# mirror the ErrorProfile constants above, plus the systematic-hotspot
# terms (real basecallers miscall at hard contexts; those pileup columns
# are what cross candidate AF cutoffs)
PLATFORM_FAST_RECIPES = {
    "ont": dict(mismatch=0.05, p_ins=0.02, p_del=0.03, hp_boost=0.02,
                sys_rate=0.012, sys_mis_boost=0.20, sys_del_boost=0.18,
                mean_read_length=900.0, length_sigma=0.4, coverage=35),
    "ccs": dict(mismatch=0.001, p_ins=0.001, p_del=0.002, hp_boost=0.003,
                sys_rate=0.004, sys_mis_boost=0.05, sys_del_boost=0.04,
                mean_read_length=2000.0, length_sigma=0.2, coverage=30),
    "ilmn": dict(mismatch=0.002, p_ins=0.0001, p_del=0.0001, hp_boost=0.0,
                 sys_rate=0.004, sys_mis_boost=0.05, sys_del_boost=0.0,
                 mean_read_length=150.0, length_sigma=0.0, coverage=60),
}


def platform_fast_kwargs(platform: str, coverage: Optional[int] = None) -> dict:
    """Copy of a PLATFORM_FAST_RECIPES entry with an optional coverage
    override — the one place the override semantics live."""
    recipe = dict(PLATFORM_FAST_RECIPES[platform])
    if coverage:
        recipe["coverage"] = coverage
    return recipe


def simulate_platform_fast(
    bam_path: str,
    rs: np.random.RandomState,
    length: int = 400_000,
    coverage: int = 35,
    variant_spacing: int = 1200,
    mean_read_length: float = 900.0,
    contig: str = "chr1",
    mismatch: float = 0.05,
    p_ins: float = 0.02,
    p_del: float = 0.03,
    hp_boost: float = 0.02,
    sys_rate: float = 0.012,
    sys_mis_boost: float = 0.20,
    sys_del_boost: float = 0.18,
    length_sigma: float = 0.4,
):
    """Vectorized whole-flowcell simulator: lognormal read lengths,
    mismatch + indel errors with homopolymer-boosted deletions and
    duplication insertions, systematic position-correlated error hotspots,
    and planted variants cycling SNP / insertion / deletion. Indel
    variants are homopolymer-style (insertion duplicates the anchor base,
    deletion drops the following bases) so the numpy read assembly handles
    them without per-base Python (simulate_bam's corrupt_read walks each
    base in Python — ~50x slower at whole-flowcell scale). Parameter sets
    per reference platform live in PLATFORM_FAST_RECIPES.

    Returns (reference_string, [PlantedVariant]); het variants ride
    haplotype 1 (odd read indices), hom both.
    """
    from clair_tpu_torch.io.bam import BamWriter

    bases = np.frombuffer(b"ACGT", np.uint8)
    ref_idx = rs.randint(0, 4, length).astype(np.int8)

    new_run = np.concatenate([[True], ref_idx[1:] != ref_idx[:-1]])
    run_start = np.nonzero(new_run)[0]
    runs = np.arange(length) - run_start[np.cumsum(new_run) - 1] + 1

    var_positions = np.arange(700, length - 700, variant_spacing)
    var_rs = np.random.RandomState(rs.randint(1 << 30))
    var_kind = np.arange(len(var_positions)) % 3        # 0 snp, 1 ins, 2 del
    var_len = var_rs.randint(1, 4, len(var_positions))
    var_het = var_rs.rand(len(var_positions)) < 0.5
    snp_set = np.zeros(length, bool)
    snp_set[var_positions[var_kind == 0]] = True
    ins_set = np.zeros(length, np.int8)
    ins_set[var_positions[var_kind == 1]] = var_len[var_kind == 1]
    del_set = np.zeros(length, np.int8)
    del_set[var_positions[var_kind == 2]] = var_len[var_kind == 2]
    het_set = np.zeros(length, bool)
    het_set[var_positions[var_het]] = True
    snp_alt = (ref_idx + 1) % 4

    sys_mis = np.zeros(length, np.float32)
    sys_mis[var_rs.rand(length) < sys_rate] = sys_mis_boost
    sys_del = np.zeros(length, np.float32)
    sys_del[var_rs.rand(length) < sys_rate] = sys_del_boost

    n_reads = int(coverage * length / mean_read_length)
    if length_sigma > 0:
        lens = np.clip(
            rs.lognormal(np.log(mean_read_length), length_sigma, n_reads),
            min(120, mean_read_length), 2.5 * mean_read_length,
        ).astype(np.int64)
    else:
        lens = np.full(n_reads, int(mean_read_length), np.int64)
    starts = rs.randint(0, np.maximum(length - lens, 1))
    order = np.argsort(starts, kind="stable")
    starts, lens = starts[order], lens[order]

    records = []
    for r in range(n_reads):
        s, L = int(starts[r]), int(lens[r])
        idx = ref_idx[s:s + L].copy()
        carries = het_set[s:s + L].copy()
        carries[carries] = bool(r % 2)
        carries |= ~het_set[s:s + L]
        snp_local = np.nonzero(snp_set[s:s + L] & carries)[0]
        idx[snp_local] = snp_alt[s + snp_local]
        u = rs.rand(L, 2)
        boost = hp_boost * np.minimum(runs[s:s + L] - 1, 4)
        pd = p_del + boost + sys_del[s:s + L]
        pd[0] = pd[-1] = 0.0
        del_mask = u[:, 0] < pd
        mis_mask = (~del_mask) & (u[:, 0] < pd + mismatch + sys_mis[s:s + L])
        idx[mis_mask] = (idx[mis_mask] + rs.randint(1, 4, int(mis_mask.sum()))) % 4
        ins_len = np.where(
            (u[:, 1] < p_ins) & ~del_mask, rs.randint(1, 4, L), 0
        )
        for dl in np.nonzero((del_set[s:s + L] > 0) & carries)[0].tolist():
            dlen = int(del_set[s + dl])
            if 0 < dl and dl + dlen < L - 1:
                del_mask[dl + 1: dl + 1 + dlen] = True
                mis_mask[dl + 1: dl + 1 + dlen] = False
        ins_local = np.nonzero((ins_set[s:s + L] > 0) & carries)[0]
        ins_local = ins_local[(ins_local > 0) & (ins_local < L - 1)]
        ins_len[ins_local] = ins_set[s + ins_local]
        ins_len[del_mask] = 0
        ins_len[0] = ins_len[-1] = 0
        counts = (~del_mask).astype(np.int64) + ins_len
        seq = bases[np.repeat(idx, counts)].tobytes().decode("ascii")

        cigar = []

        def push(n, op):
            if n <= 0:
                return
            if cigar and cigar[-1][1] == op:
                cigar[-1] = (cigar[-1][0] + n, op)
            else:
                cigar.append((n, op))

        prev = 0
        for sp in np.nonzero(del_mask | (ins_len > 0))[0].tolist():
            push(sp - prev, "M")
            if del_mask[sp]:
                push(1, "D")
            else:
                push(1, "M")
                push(int(ins_len[sp]), "I")
            prev = sp + 1
        push(L - prev, "M")
        flag = 16 if u[0, 0] < 0.5 else 0
        records.append((f"ont{r}", s, flag, cigar, seq))

    reference = bases[ref_idx].tobytes().decode("ascii")
    with BamWriter(bam_path, [(contig, length)]) as writer:
        for name, pos, flag, cigar, seq in records:
            writer.write(name, 0, pos, 60, flag, cigar, seq)

    variants = []
    for k, pos0 in enumerate(var_positions):
        pos0 = int(pos0)
        anchor = reference[pos0]
        gt = (0, 1) if var_het[k] else (1, 1)
        if var_kind[k] == 0:
            variants.append(PlantedVariant(
                pos0 + 1, anchor, "ACGT"[int(snp_alt[pos0])], gt))
        elif var_kind[k] == 1:
            variants.append(PlantedVariant(
                pos0 + 1, anchor, anchor * (1 + int(var_len[k])), gt))
        else:
            dlen = int(var_len[k])
            variants.append(PlantedVariant(
                pos0 + 1, reference[pos0: pos0 + dlen + 1], anchor, gt))
    return reference, variants


def simulate_ont_fast(bam_path, rs, length=400_000, coverage=35,
                      variant_spacing=1200, mean_read_length=900.0,
                      contig="chr1"):
    """ONT parameter set of simulate_platform_fast (kept as the named
    entry point the bench / production trainer / tests use)."""
    recipe = platform_fast_kwargs("ont", coverage)
    recipe["mean_read_length"] = mean_read_length
    return simulate_platform_fast(
        bam_path, rs, length=length, variant_spacing=variant_spacing,
        contig=contig, **recipe,
    )


def plant_variants(
    rs: np.random.RandomState,
    reference: str,
    n_variants: int = 60,
    spacing: int = 150,
    start: int = 300,
) -> List[PlantedVariant]:
    """Alternate SNP / insertion / deletion variants, evenly spaced, each
    randomly hom (1/1) or het (0/1)."""
    variants = []
    position = start
    kinds = ["snp", "ins", "del"]
    for i in range(n_variants):
        if position + spacing >= len(reference) - 300:
            break
        kind = kinds[i % 3]
        het = bool(rs.randint(2))
        ref_base = reference[position - 1]  # 1-based position
        if kind == "snp":
            alt = rs.choice([b for b in "ACGT" if b != ref_base])
            variants.append(PlantedVariant(position, ref_base, alt, (0, 1) if het else (1, 1)))
        elif kind == "ins":
            ins = "".join(rs.choice(list("ACGT"), rs.randint(1, 4)))
            variants.append(
                PlantedVariant(position, ref_base, ref_base + ins, (0, 1) if het else (1, 1))
            )
        else:
            dlen = int(rs.randint(1, 4))
            ref_seq = reference[position - 1: position + dlen]
            variants.append(
                PlantedVariant(position, ref_seq, ref_base, (0, 1) if het else (1, 1))
            )
        position += spacing + int(rs.randint(0, spacing // 2))
    return variants


def haplotype_sequences(
    reference: str, variants: List[PlantedVariant]
) -> Tuple[List[Tuple[int, str, str]], List[Tuple[int, str, str]]]:
    """Per-haplotype variant lists [(pos1, ref, alt)]: hap1 carries every
    variant; hap0 carries only hom variants."""
    hap1 = [(v.position, v.ref, v.alt) for v in variants]
    hap0 = [(v.position, v.ref, v.alt) for v in variants if not v.is_het]
    return hap0, hap1


def _read_from_haplotype(
    reference: str,
    hap_variants: List[Tuple[int, str, str]],
    start0: int,
    read_length: int,
):
    """Build (cigar, seq) for a read starting at 0-based start0 over the
    haplotype, expressed against the reference coordinates."""
    cigar: List[Tuple[int, str]] = []
    seq_parts: List[str] = []
    refp = start0
    consumed = 0
    by_pos = {p - 1: (r, a) for p, r, a in hap_variants}

    def push(op: str, length: int):
        if length <= 0:
            return
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + length, op)
        else:
            cigar.append((length, op))

    while consumed < read_length and refp < len(reference):
        if refp in by_pos:
            ref_allele, alt_allele = by_pos[refp]
            if len(ref_allele) == len(alt_allele) == 1:       # SNP
                seq_parts.append(alt_allele)
                push("M", 1)
                refp += 1
                consumed += 1
            elif len(alt_allele) > len(ref_allele):           # insertion
                take = min(read_length - consumed, 1)
                seq_parts.append(alt_allele[0])
                push("M", 1)
                consumed += take
                ins = alt_allele[1:]
                ins_take = min(len(ins), read_length - consumed)
                if ins_take > 0:
                    seq_parts.append(ins[:ins_take])
                    push("I", ins_take)
                    consumed += ins_take
                refp += 1
            else:                                             # deletion
                seq_parts.append(alt_allele)
                push("M", 1)
                consumed += 1
                push("D", len(ref_allele) - 1)
                refp += len(ref_allele)
        else:
            seq_parts.append(reference[refp])
            push("M", 1)
            refp += 1
            consumed += 1
    return cigar, "".join(seq_parts)


def simulate_bam(
    bam_path: str,
    reference: str,
    variants: List[PlantedVariant],
    rs: np.random.RandomState,
    coverage: int = 30,
    read_length: int = 150,
    error_rate: float = 0.0,
    contig: str = "chr1",
    error_profile: Optional[ErrorProfile] = None,
    read_length_sigma: float = 0.0,
) -> int:
    """Write a coordinate-sorted BAM of haplotype-aware reads; returns the
    number of reads.

    error_rate is the legacy uniform-mismatch knob; error_profile supersedes
    it (e.g. ONT_R94 for nanopore-like noise). read_length_sigma > 0 samples
    per-read lengths lognormally around read_length (long-read length
    spread)."""
    if error_profile is None:
        error_profile = ErrorProfile(mismatch=error_rate)
    hap0, hap1 = haplotype_sequences(reference, variants)
    n_reads = coverage * len(reference) // read_length
    reads = []
    for i in range(n_reads):
        if read_length_sigma > 0:
            length = int(np.clip(
                rs.lognormal(np.log(read_length), read_length_sigma),
                50, 2.5 * read_length,
            ))
        else:
            length = read_length
        length = min(length, len(reference) - 1)
        start0 = int(rs.randint(0, len(reference) - length))
        hap = hap1 if i % 2 else hap0
        cigar, seq = _read_from_haplotype(reference, hap, start0, length)
        cigar, seq = corrupt_read(rs, cigar, seq, error_profile)
        if not seq:
            continue
        flag = 16 if rs.rand() < 0.5 else 0
        reads.append((f"sim{i}", start0, flag, cigar, seq))

    with BamWriter(bam_path, [(contig, len(reference))]) as writer:
        for name, pos, flag, cigar, seq in sorted(reads, key=lambda r: r[1]):
            writer.write(name, 0, pos, 60, flag, cigar, seq)
    return len(reads)


def write_fasta(path: str, reference: str, contig: str = "chr1") -> None:
    with open(path, "w") as fh:
        fh.write(f">{contig}\n")
        for offset in range(0, len(reference), 60):
            fh.write(reference[offset:offset + 60] + "\n")
    build_fai(path)


def write_truth_vcf(path: str, variants: List[PlantedVariant], contig: str = "chr1") -> None:
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.1\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n")
        for v in variants:
            gt = "0/1" if v.is_het else "1/1"
            fh.write(
                f"{contig}\t{v.position}\t.\t{v.ref}\t{v.alt}\t60\tPASS\t.\tGT\t{gt}\n"
            )
