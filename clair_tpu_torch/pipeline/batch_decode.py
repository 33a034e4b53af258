"""Vectorized batch decode.

The reference decodes every site through a Python list lattice
(call_var.py:693-947, HOT LOOP #2 in SURVEY §3.2). Here the winning
category of EVERY site in a batch is computed with a handful of numpy
reductions (each category's maximum factorizes over the two length heads),
and sites that resolve to homo-reference or SNPs — the overwhelming
majority — are fully decoded vectorized. Only indel winners fall back to
the exact per-site lattice walk (pipeline.decode.decode_site), which
preserves the retry semantics those categories need.

Equivalence with the per-site path is tested against random probability
vectors (tests/test_batch_decode.py).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from clair_tpu_torch.params import FLANKING_BASE_NUM
from clair_tpu_torch.pipeline.decode import (
    CH_DELETE,
    CH_REFERENCE,
    CH_SNP,
    MIN_LENGTH_NEEDING_INFERENCE as MIN_INFER,
    IndelSources,
    OutputConfig,
    SiteCall,
    decode_site,
)

from clair_tpu_torch.task.gt21 import GT21, HETERO_SNP_GT21, HOMO_SNP_GT21
from clair_tpu_torch.utils.genomics import BASE2ACGT, BASE2NUM, BASIC_BASES

OFF = 16
_HOMO_SNP = np.asarray(HOMO_SNP_GT21, dtype=int)
_HETERO_SNP = np.asarray(HETERO_SNP_GT21, dtype=int)
_HET_INS = np.asarray([GT21.AIns, GT21.CIns, GT21.GIns, GT21.TIns], dtype=int)
_HET_DEL = np.asarray([GT21.ADel, GT21.CDel, GT21.GDel, GT21.TDel], dtype=int)

# category indices in the reference's tie-break order
CAT_REF, CAT_HOMO_SNP, CAT_HET_SNP = 0, 1, 2
_N_CATEGORIES = 10
_CATEGORY_NAMES = (
    "homo_ref", "homo_snp", "hetero_snp", "homo_ins", "het_acgt_ins",
    "het_insins", "homo_del", "het_acgt_del", "het_deldel", "het_insdel",
)

# base pair -> gt21 code for the 10 unordered pairs
_PAIR_CODE = np.zeros((4, 4), dtype=int)
for _i, _b1 in enumerate("ACGT"):
    for _j, _b2 in enumerate("ACGT"):
        pair = "".join(sorted(_b1 + _b2))
        _PAIR_CODE[_i, _j] = GT21[pair]

_BASES = "ACGT"

# SNP label base indices per winning subset class
_HOMO_SNP_BASE = np.array([BASE2NUM[GT21(int(g)).name[0]] for g in _HOMO_SNP])
_HETERO_SNP_B1 = np.array([BASE2NUM[GT21(int(g)).name[0]] for g in _HETERO_SNP])
_HETERO_SNP_B2 = np.array([BASE2NUM[GT21(int(g)).name[1]] for g in _HETERO_SNP])


def _top2(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(max, argmax, second_max) along the last axis."""
    argmax = values.argmax(axis=-1)
    vmax = np.take_along_axis(values, argmax[..., None], -1)[..., 0]
    masked = values.copy()
    np.put_along_axis(masked, argmax[..., None], -np.inf, -1)
    second = masked.max(axis=-1)
    return vmax, argmax, second


def category_maxima(
    gt21_p: np.ndarray,
    geno_p: np.ndarray,
    vl1_p: np.ndarray,
    vl2_p: np.ndarray,
    ref_codes: np.ndarray,
) -> np.ndarray:
    """(10, B) per-category maximum probabilities in tie-break order.

    Mirrors OutcomeLattice category maxima exactly; each pair category's
    maximum factorizes over the two independent length heads, with the
    DelDel i != j constraint handled via top-2.
    """
    gt21 = gt21_p.astype(np.float64)
    geno = geno_p.astype(np.float64)
    vl1 = vl1_p.astype(np.float64)
    vl2 = vl2_p.astype(np.float64)
    n = len(gt21)

    p_ref, p_homo, p_het = geno[:, 0], geno[:, 1], geno[:, 2]
    z1, z2 = vl1[:, OFF], vl2[:, OFF]
    vl0 = z1 * z2
    pos1, pos2 = vl1[:, OFF + 1:], vl2[:, OFF + 1:]
    neg1, neg2 = vl1[:, :OFF], vl2[:, :OFF]

    rows = np.arange(n)
    out = np.empty((_N_CATEGORIES, n), dtype=np.float64)
    out[CAT_REF] = vl0 * p_ref * gt21[rows, ref_codes]
    out[CAT_HOMO_SNP] = vl0 * p_homo * gt21[:, _HOMO_SNP].max(-1)
    out[CAT_HET_SNP] = vl0 * p_het * gt21[:, _HETERO_SNP].max(-1)

    ins_ins = gt21[:, GT21.InsIns]
    del_del = gt21[:, GT21.DelDel]
    out[3] = (pos1 * pos2).max(-1) * p_homo * ins_ins            # homo Ins
    het_ins_len = np.maximum(z1 * pos2.max(-1), pos1.max(-1) * z2)
    out[4] = het_ins_len * gt21[:, _HET_INS].max(-1) * p_het     # het ACGT+Ins
    out[5] = pos1.max(-1) * pos2.max(-1) * p_het * ins_ins       # het InsIns
    out[6] = (neg1 * neg2).max(-1) * p_homo * del_del            # homo Del
    het_del_len = np.maximum(z1 * neg2.max(-1), neg1.max(-1) * z2)
    out[7] = het_del_len * gt21[:, _HET_DEL].max(-1) * p_het     # het ACGT+Del

    # het DelDel needs i != j: use top-2 when the argmaxes collide
    n1max, n1arg, n1second = _top2(neg1)
    n2max, n2arg, n2second = _top2(neg2)
    same = n1arg == n2arg
    deldel_pair = np.where(
        same, np.maximum(n1max * n2second, n1second * n2max), n1max * n2max
    )
    out[8] = deldel_pair * p_het * del_del

    out[9] = (
        np.maximum(pos1.max(-1) * n2max, n1max * pos2.max(-1))
        * p_het * gt21[:, GT21.InsDel]
    )
    return out


_HOMO_INDEL = {"homo_ins", "homo_del"}


def batch_decode_indels(
    x: np.ndarray,
    sequences: Sequence[str],
    contig: str,
    positions: Sequence[int],
    gt21_p: np.ndarray,
    genotype_p: np.ndarray,
    vl1_p: np.ndarray,
    vl2_p: np.ndarray,
    winner_names: Sequence[str],
    output_config: OutputConfig,
    sources: IndelSources,
) -> List[Tuple[int, SiteCall]]:
    """Vectorized decode of indel-winning sites (ONT output sends >half of
    candidate sites here; the per-site decode_indel_fast + assembly chain
    cost ~28 us/site in many tiny numpy calls).

    The winning lengths, folded insert profiles, and support sums compute
    once per batch; per-site work reduces to string assembly + pure-Python
    math. Every case the fast path cannot reproduce EXACTLY (long indels
    needing source callbacks, use_bam_for_all, degenerate alleles that the
    reference retries) falls back to the original per-site chain, so
    semantics are unchanged (equality-tested in tests/test_batch_decode.py).

    Inputs are the fallback subset only; x must be channel-normalized.
    Returns [(local_index, SiteCall), ...] — sites producing no row are
    omitted.
    """
    from clair_tpu_torch.pipeline.decode import (
        assemble_site_call,
        decode_indel_fast,
        decode_site,
    )
    from clair_tpu_torch.task.genotype import genotype_code_from, genotype_for_task
    from math import e as _e, log as _log

    n = len(sequences)
    center = FLANKING_BASE_NUM

    def slow(i):
        fast = decode_indel_fast(
            winner_names[i], x[i], sequences[i], contig, int(positions[i]),
            gt21_p[i], genotype_p[i], vl1_p[i], vl2_p[i], sources,
        )
        if fast is not None:
            return assemble_site_call(
                fast[0], fast[1], fast[2], x[i], gt21_p[i], genotype_p[i],
                output_config,
            )
        return decode_site(
            x[i], contig, int(positions[i]), sequences[i],
            gt21_p[i], genotype_p[i], vl1_p[i], vl2_p[i],
            output_config, sources,
        )

    results: List[Tuple[int, SiteCall]] = []
    if sources.use_bam_for_all:
        for i in range(n):
            call = slow(i)
            if call is not None:
                results.append((i, call))
        return results

    vl1 = vl1_p.astype(np.float64)
    vl2 = vl2_p.astype(np.float64)
    pos1, pos2 = vl1[:, OFF + 1:], vl2[:, OFF + 1:]
    # deletion-length columns are vl[OFF - k] for length k: REVERSED slice so
    # column k corresponds to length k+1 (the _winning_indel_candidate order)
    neg1, neg2 = vl1[:, OFF - 1::-1], vl2[:, OFF - 1::-1]
    z1, z2 = vl1[:, OFF], vl2[:, OFF]

    # winning lengths per category (exact _winning_indel_candidate order)
    l_homo_ins = (pos1 * pos2).argmax(-1) + 1
    l_homo_del = (neg1 * neg2).argmax(-1) + 1
    l_het_ins = np.maximum(z1[:, None] * pos2, pos1 * z2[:, None]).argmax(-1) + 1
    l_het_del = np.maximum(z1[:, None] * neg2, neg1 * z2[:, None]).argmax(-1) + 1

    grid_ii = (pos1[:, :, None] * pos2[:, None, :]).reshape(n, -1)
    flat_ii = grid_ii.argmax(-1)
    ii_i, ii_j = flat_ii // OFF + 1, flat_ii % OFF + 1

    grid_dd = neg1[:, :, None] * neg2[:, None, :]
    grid_dd[:, np.arange(OFF), np.arange(OFF)] = -1.0
    flat_dd = grid_dd.reshape(n, -1).argmax(-1)
    dd_i, dd_j = flat_dd // OFF + 1, flat_dd % OFF + 1

    grid_id = np.stack(
        [pos1[:, :, None] * neg2[:, None, :], neg1[:, :, None] * pos2[:, None, :]],
        axis=-1,
    ).reshape(n, -1)
    flat_id = grid_id.argmax(-1)
    id_kind = flat_id % 2
    id_cell = flat_id // 2
    id_i, id_j = id_cell // OFF + 1, id_cell % OFF + 1

    # folded insert profiles for rows 17..31 (lengths < 16 read from here)
    rows_ins = x[:, center + 1: 2 * center, :, :]
    folded = np.zeros((n, center - 1, 8), dtype=x.dtype)
    folded[:, :, :4] = (
        rows_ins[:, :, :4, 1] + rows_ins[:, :, 4:, 1]
        - rows_ins[:, :, :4, 3] - rows_ins[:, :, 4:, 3]
    )
    ins_choice = folded.argmax(-1) % 4                      # (n, 15)

    het_ins_base = np.asarray(gt21_p, dtype=np.float64)[:, _HET_INS].argmax(-1)
    het_del_base = np.asarray(gt21_p, dtype=np.float64)[:, _HET_DEL].argmax(-1)

    read_depth = (x[:, center, :, CH_DELETE] + x[:, center, :, CH_REFERENCE]).sum(-1)
    ins_sup = x[:, center + 1, :, 1].sum(-1) - x[:, center + 1, :, 3].sum(-1)
    del_sup = x[:, center + 1, :, CH_DELETE].sum(-1)
    center_ref = x[:, center, :, CH_REFERENCE]
    center_snp = x[:, center, :, CH_SNP]

    haploid_p = output_config.is_haploid_precision_mode_enabled
    haploid_s = output_config.is_haploid_sensitive_mode_enabled
    is_debug = output_config.is_debug
    log10 = _log(10.0)

    def ins_str(i, length):
        return "".join(_BASES[c] for c in ins_choice[i, :length])

    def base_support(i, base):
        b = BASE2NUM[base]
        return float(
            center_snp[i, b] + center_snp[i, b + 4]
            + center_ref[i, b] + center_ref[i, b + 4]
        )

    for i in range(n):
        category = winner_names[i]
        seq = sequences[i]
        refc = seq[center]
        extra_support = 0.0

        if category == "homo_ins":
            length = int(l_homo_ins[i])
            if length >= MIN_INFER:
                call = slow(i)
                if call is not None:
                    results.append((i, call))
                continue
            reference_base = refc
            alternate_base = refc + ins_str(i, length)
            supported = float(ins_sup[i])
            g1, g2 = 1, 1
        elif category == "het_acgt_ins":
            length = int(l_het_ins[i])
            if length >= MIN_INFER:
                call = slow(i)
                if call is not None:
                    results.append((i, call))
                continue
            het_base = _BASES[int(het_ins_base[i])]
            reference_base = refc
            alternate_base = refc + ins_str(i, length)
            supported = float(ins_sup[i])
            if het_base != refc:
                extra_support = base_support(i, het_base)
                alternate_base = f"{het_base},{alternate_base}"
                g1, g2 = 1, 2
            else:
                g1, g2 = 0, 1
        elif category == "het_insins":
            vl_1, vl_2 = int(min(ii_i[i], ii_j[i])), int(max(ii_i[i], ii_j[i]))
            if vl_2 >= MIN_INFER:
                call = slow(i)
                if call is not None:
                    results.append((i, call))
                continue
            bases = ins_str(i, vl_2)
            another = ""
            if sources.insertion_bases is not None:
                max_rec = 50 if vl_1 >= MIN_INFER else vl_1
                another = sources.insertion_bases(
                    contig, int(positions[i]), vl_1, max_rec, bases
                )
            another = another or bases[0:vl_1]
            alt1, alt2 = refc + another, refc + bases
            if alt1 == alt2:
                call = decode_site(
                    x[i], contig, int(positions[i]), seq,
                    gt21_p[i], genotype_p[i], vl1_p[i], vl2_p[i],
                    output_config, sources,
                )
                if call is not None:
                    results.append((i, call))
                continue
            reference_base = refc
            alternate_base = f"{alt1},{alt2}"
            supported = float(ins_sup[i])
            g1, g2 = 1, 2
        elif category == "homo_del":
            length = int(l_homo_del[i])
            if length >= MIN_INFER:
                call = slow(i)
                if call is not None:
                    results.append((i, call))
                continue
            reference_base = refc + seq[center + 1: center + length + 1]
            alternate_base = reference_base[0]
            supported = float(del_sup[i])
            g1, g2 = 1, 1
        elif category == "het_acgt_del":
            length = int(l_het_del[i])
            if length >= MIN_INFER:
                call = slow(i)
                if call is not None:
                    results.append((i, call))
                continue
            het_base = _BASES[int(het_del_base[i])]
            reference_base = refc + seq[center + 1: center + length + 1]
            alternate_base = reference_base[0]
            supported = float(del_sup[i])
            if het_base != reference_base[0]:
                extra_support = base_support(i, het_base)
                alternate_base = f"{alternate_base},{het_base + reference_base[1:]}"
                g1, g2 = 1, 2
            else:
                g1, g2 = 0, 1
        elif category == "het_deldel":
            vl_1, vl_2 = int(min(dd_i[i], dd_j[i])), int(max(dd_i[i], dd_j[i]))
            if vl_2 >= MIN_INFER:
                call = slow(i)
                if call is not None:
                    results.append((i, call))
                continue
            reference_base = refc + seq[center + 1: center + vl_2 + 1]
            alt1 = reference_base[0]
            alt2 = reference_base[0] + reference_base[vl_1 + 1:]
            if not (alt1 != alt2 and reference_base != alt1 and reference_base != alt2):
                call = decode_site(
                    x[i], contig, int(positions[i]), seq,
                    gt21_p[i], genotype_p[i], vl1_p[i], vl2_p[i],
                    output_config, sources,
                )
                if call is not None:
                    results.append((i, call))
                continue
            alternate_base = f"{alt1},{alt2}"
            supported = float(del_sup[i])
            g1, g2 = 1, 2
        elif category == "het_insdel":
            vl_del = int(id_j[i]) if id_kind[i] == 0 else int(id_i[i])
            vl_ins = int(id_i[i]) if id_kind[i] == 0 else int(id_j[i])
            if vl_ins >= MIN_INFER or vl_del >= MIN_INFER:
                call = slow(i)
                if call is not None:
                    results.append((i, call))
                continue
            ins_bases = ins_str(i, vl_ins)
            reference_base = refc + seq[center + 1: center + vl_del + 1]
            alternate_base = "{},{}".format(
                reference_base[0], reference_base[0] + ins_bases + reference_base[1:]
            )
            supported = float(ins_sup[i]) + float(del_sup[i])
            g1, g2 = 1, 2
        else:  # unexpected category: preserve old behavior
            call = slow(i)
            if call is not None:
                results.append((i, call))
            continue

        # --- assembly (assemble_site_call semantics) ---
        if not is_debug and reference_base == alternate_base:
            continue
        is_multi = "," in alternate_base
        if haploid_p and category not in _HOMO_INDEL:
            continue
        if haploid_s and is_multi:
            continue

        if category in _HOMO_INDEL:
            genotype_string = "1/1"
        elif is_multi:
            genotype_string = "1/2"
        else:
            genotype_string = "0/1"

        depth = float(read_depth[i])
        allele_frequency = min((supported + extra_support) / depth, 1.0) if depth else 0.0

        # gt21 code straight from the category structure (equivalent to
        # gt21_code_from over the allele strings, verified by the
        # path-equality test); het_base/refc pick the base+indel classes
        if category in ("homo_ins", "het_insins"):
            code = GT21.InsIns
        elif category == "het_acgt_ins":
            code = GT21[(het_base if is_multi else refc) + "Ins"]
        elif category in ("homo_del", "het_deldel"):
            code = GT21.DelDel
        elif category == "het_acgt_del":
            code = GT21[(het_base if is_multi else refc) + "Del"]
        else:  # het_insdel
            code = GT21.InsDel
        geno = genotype_for_task(genotype_code_from(g1, g2))
        p = float(gt21_p[i][code]) * float(genotype_p[i][geno])
        tmp = max((-10 * _log(_e, 10)) * _log(((1.0 - p) + 1e-300) / (p + 1e-300)) + 16, 0)
        quality_score = int(round(tmp * tmp))

        if haploid_p or haploid_s:
            genotype_string = "1" if "1" in genotype_string else "0"

        results.append((
            i,
            SiteCall(
                category=category,
                reference_base=reference_base,
                alternate_base=alternate_base,
                genotype_string=genotype_string,
                quality_score=quality_score,
                read_depth=int(depth),
                allele_frequency=allele_frequency,
                is_reference=False,
                is_multi=is_multi,
            ),
        ))
    return results


def decode_batch(
    x: np.ndarray,
    infos: Sequence[Tuple[str, str, str]],
    gt21_p: np.ndarray,
    genotype_p: np.ndarray,
    vl1_p: np.ndarray,
    vl2_p: np.ndarray,
    output_config: OutputConfig,
    indel_sources: IndelSources = IndelSources(),
) -> List[Tuple[int, SiteCall]]:
    """Decode a batch; returns [(batch_index, SiteCall), ...] in order."""
    n = len(infos)
    center = FLANKING_BASE_NUM

    center_bases = np.array([info[2][center] for info in infos])
    valid = np.isin(center_bases, list(BASIC_BASES))
    read_depth = (x[:, center, :, CH_DELETE] + x[:, center, :, CH_REFERENCE]).sum(-1)
    valid &= read_depth > 0

    ref_acgt_idx = np.array(
        [BASE2NUM[BASE2ACGT.get(b, "A")] for b in center_bases], dtype=int
    )
    ref_codes = _PAIR_CODE[ref_acgt_idx, ref_acgt_idx]

    maxima = category_maxima(gt21_p, genotype_p, vl1_p, vl2_p, ref_codes)
    winners = maxima.argmax(axis=0)

    results: List[Tuple[int, SiteCall]] = []
    gt21_64 = gt21_p.astype(np.float64)
    geno_64 = genotype_p.astype(np.float64)
    rows = np.arange(n)

    homo_snp_arg = gt21_64[:, _HOMO_SNP].argmax(-1)
    het_snp_arg = gt21_64[:, _HETERO_SNP].argmax(-1)

    # --- vectorized fast-path fields (used for winners <= CAT_HET_SNP) ---
    # SNP label base indices from the winning gt21 class
    homo_base = _HOMO_SNP_BASE[homo_snp_arg]                 # (n,)
    het_b1 = _HETERO_SNP_B1[het_snp_arg]
    het_b2 = _HETERO_SNP_B2[het_snp_arg]

    is_homo_w = winners == CAT_HOMO_SNP
    is_het_w = winners == CAT_HET_SNP
    # ALT selection compares against the RAW center base (decode_site uses
    # the uncollapsed char); non-ACGT raw bases never equal a label base
    raw_idx = np.array([_BASES.find(b) for b in center_bases], dtype=int)
    het_multi = is_het_w & (het_b1 != raw_idx) & (het_b2 != raw_idx)
    # the single ALT base for non-multi SNP rows
    alt1 = np.where(is_homo_w, homo_base, np.where(het_b1 != raw_idx, het_b1, het_b2))

    # quality: p = gt21[quality_code] * geno[genotype_for_task]
    quality_code = np.where(
        winners == CAT_REF, ref_codes,
        np.where(
            is_homo_w, _PAIR_CODE[homo_base, homo_base],
            np.where(
                het_multi, _PAIR_CODE[het_b1, het_b2],
                _PAIR_CODE[ref_acgt_idx, alt1],
            ),
        ),
    )
    quality_geno = np.where(winners == CAT_REF, 0, np.where(is_homo_w, 1, 2))
    p = gt21_64[rows, quality_code] * geno_64[rows, quality_geno]
    tmp = np.maximum(
        (-10 * np.log(np.e) / np.log(10.0))
        * np.log(((1.0 - p) + 1e-300) / (p + 1e-300)) + 16,
        0,
    )
    quality_vec = np.rint(tmp * tmp).astype(np.int64)

    # supported reads: ref rows use the reference channel at the ref base;
    # SNP rows sum SNP+ref channels over their ALT base(s)
    center_ref = x[:, center, :, CH_REFERENCE]
    center_snp = x[:, center, :, CH_SNP]

    def base_support(base_idx):
        return (
            center_snp[rows, base_idx] + center_snp[rows, base_idx + 4]
            + center_ref[rows, base_idx] + center_ref[rows, base_idx + 4]
        )

    ref_support = center_ref[rows, ref_acgt_idx] + center_ref[rows, ref_acgt_idx + 4]
    snp_support = np.where(
        het_multi, base_support(het_b1) + base_support(het_b2), base_support(alt1)
    )
    supported_vec = np.where(winners == CAT_REF, ref_support, snp_support)
    af_vec = np.minimum(
        np.divide(supported_vec, read_depth, out=np.zeros(n), where=read_depth > 0),
        1.0,
    )

    haploid = (
        output_config.is_haploid_precision_mode_enabled
        or output_config.is_haploid_sensitive_mode_enabled
    )
    show_ref = output_config.is_show_reference or output_config.is_debug

    # indel winners decode batched (vectorized winners/recovery, exact
    # per-site fallback inside) — grouped per contig since the batch may
    # span contigs on this path
    indel_results: dict = {}
    indel_idx = np.nonzero(valid & (winners > CAT_HET_SNP))[0]
    if len(indel_idx):
        by_contig: dict = {}
        for i in indel_idx.tolist():
            by_contig.setdefault(infos[i][0], []).append(i)
        for chromosome, group in by_contig.items():
            group_arr = np.asarray(group)
            calls = batch_decode_indels(
                x[group_arr],
                [infos[i][2] for i in group],
                chromosome,
                np.asarray([int(infos[i][1]) for i in group], dtype=np.int64),
                gt21_p[group_arr], genotype_p[group_arr],
                vl1_p[group_arr], vl2_p[group_arr],
                [_CATEGORY_NAMES[winners[i]] for i in group],
                output_config, indel_sources,
            )
            for k, call in calls:
                indel_results[group[k]] = call

    for i in range(n):
        if not valid[i]:
            continue
        winner = winners[i]

        if winner > CAT_HET_SNP:
            call = indel_results.get(i)
            if call is not None:
                results.append((i, call))
            continue

        if winner == CAT_REF:
            if not show_ref:
                continue
            ref_base = _BASES[ref_acgt_idx[i]]
            reference = alternate = ref_base
            category = "homo_ref"
            genotype_string = "0/0"
            is_reference, is_multi = True, False
        elif winner == CAT_HOMO_SNP:
            reference = infos[i][2][center]
            alternate = _BASES[homo_base[i]]
            if reference == alternate and not output_config.is_debug:
                continue
            category = "homo_snp"
            genotype_string = "1/1"
            is_reference, is_multi = False, False
        else:
            reference = infos[i][2][center]
            if het_multi[i]:
                alternate = f"{_BASES[het_b1[i]]},{_BASES[het_b2[i]]}"
                genotype_string = "1/2"
                is_multi = True
            else:
                alternate = _BASES[alt1[i]]
                genotype_string = "0/1"
                is_multi = False
            if reference == alternate and not output_config.is_debug:
                continue
            category = "hetero_snp"
            is_reference = False

        # haploid modes (ref call_var.py:1077-1084)
        if output_config.is_haploid_precision_mode_enabled and category == "hetero_snp":
            continue
        if output_config.is_haploid_sensitive_mode_enabled and is_multi:
            continue
        if haploid:
            genotype_string = "1" if "1" in genotype_string else "0"

        results.append((
            i,
            SiteCall(
                category=category,
                reference_base=reference,
                alternate_base=alternate,
                genotype_string=genotype_string,
                quality_score=int(quality_vec[i]),
                read_depth=int(read_depth[i]),
                allele_frequency=float(af_vec[i]),
                is_reference=is_reference,
                is_multi=is_multi,
            ),
        ))
    return results
