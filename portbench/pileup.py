"""Synthetic pileup rows shaped like a sequencer's, made from a seed.

One row is what a Clair training bin holds for one candidate site: a
(33, 8, 4) pileup tensor and a 90-wide label vector. The tensor counts,
at each of the 33 positions around the site, the reads of each strand
(rows 0-3 forward, 4-7 reverse, one per base A, C, G, T) in four channels
that follow the port's pileup code (clair_tpu_torch/data/pileup.py):

- channel 0: reads that match at the reference base's row;
- channel 1: each read's base at that base's row, plus insertions;
- channel 2: matches and deletions at the reference base's row;
- channel 3: each read's base at that base's row;

then normalised as bins store them: channels 1-3 less channel 0.

The profile (a traffic file's ``pileup``) sets the depth, the strand
split, the error rates, the allele fractions by genotype and the mix of
labels; each site carries the label of the class its reads show. Every draw comes from one ``torch.Generator`` on the device the
rows are made on, in a fixed number of large calls, so a seed gives the
same rows on the same device whatever the host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

POSITIONS = 33
CENTER = POSITIONS // 2
ROWS = 8
CHANNELS = 4
LABELS = 90
MAX_DEPTH = 250
# the label classes a profile mixes, in this order
CLASSES = ("hom_ref", "het_snp", "hom_snp", "het_ins", "hom_ins", "het_del", "hom_del")
MAX_INDEL = 16

# gt21 codes (clair_tpu_torch/task/gt21.py): AA CC GG TT by base; the
# unordered pair of two bases; base + Del and base + Ins
_HOM = (0, 4, 7, 9)
_PAIR = ((0, 1, 2, 3), (1, 4, 5, 6), (2, 5, 7, 8), (3, 6, 8, 9))
_DEL_DEL, _BASE_DEL, _INS_INS, _BASE_INS = 10, 11, 15, 16
# label vector spans: gt21, genotype (hom ref 0, hom alt 1, het 2), the
# two indel lengths (-16..16, sorted)
_GENOTYPE_AT, _LEN1_AT, _LEN2_AT = 21, 24, 57


def make_rows(n: int, profile: Dict, generator: torch.Generator,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x (n, 33, 8, 4) int16, y (n, 90) uint8) on ``device``."""
    g = dict(generator=generator, device=device)
    share = torch.tensor([float(profile["labels"][c]) for c in CLASSES], device=device)
    cls = torch.multinomial(share / share.sum(), n, replacement=True, generator=generator)
    het = (cls == 1) | (cls == 3) | (cls == 5)
    is_snp, is_ins, is_del = (cls == 1) | (cls == 2), (cls == 3) | (cls == 4), cls >= 5

    ref = torch.randint(0, 4, (n, POSITIONS), **g)
    # a different base for SNP alleles and sequencing errors alike
    shift = torch.randint(1, 4, (3, n, POSITIONS, 2), **g)
    alt = (ref[:, CENTER] + shift[0, :, 0, 0]) % 4
    length_weights = torch.tensor([float(profile["indel_length_decay"]) ** k
                                   for k in range(MAX_INDEL)], device=device)
    length = 1 + torch.multinomial(length_weights, n, replacement=True, generator=generator)

    lo, hi = profile["het_af"]
    hom_lo, hom_hi = profile["hom_af"]
    u = torch.rand((2, n), **g)
    af = torch.where(het, lo + (hi - lo) * u[0], hom_lo + (hom_hi - hom_lo) * u[0])
    d_lo, d_hi = profile["depth_scale"]
    mean_depth = float(profile["depth"]) * (d_lo + (d_hi - d_lo) * u[1])

    depth = torch.poisson(mean_depth[:, None].expand(n, POSITIONS).contiguous(),
                          generator=generator).clamp_(max=MAX_DEPTH)
    forward = torch.binomial(depth, torch.full_like(depth, float(profile["forward_share"])),
                             generator=generator)
    by_strand = torch.stack([forward, depth - forward], dim=-1)  # (n, 33, 2)

    def draw(count: torch.Tensor, p) -> torch.Tensor:
        p = p if torch.is_tensor(p) else torch.full_like(count, float(p))
        return torch.binomial(count, p.expand_as(count).contiguous(), generator=generator)

    # the deleted bases lie after the site: positions 17 .. 16 + length
    offset = torch.arange(POSITIONS, device=device)[None, :] - CENTER
    deleted = is_del[:, None] & (offset >= 1) & (offset <= length[:, None])
    dels = draw(by_strand, profile["deletion"])
    dels = dels + draw(by_strand - dels, (af[:, None, None] * deleted[..., None]))
    matched = by_strand - dels
    alt_reads = draw(matched, af[:, None, None] * (is_snp[:, None] & (offset == 0))[..., None])
    subs = draw(matched - alt_reads, profile["substitution"])
    ins = draw(by_strand, profile["insertion"])
    ins = ins + draw(by_strand, af[:, None, None] * (is_ins[:, None] & (offset == 0))[..., None])

    x = torch.zeros((n, POSITIONS, ROWS, CHANNELS), device=device)
    strand_row = torch.tensor([0, 4], device=device)
    ref_row = ref[..., None] + strand_row
    alt_row = torch.where(offset == 0, alt[:, None], ref)[..., None] + strand_row
    sub_row = (ref[..., None] + shift[1]) % 4 + strand_row
    ins_row = (ref[..., None] + shift[2]) % 4 + strand_row

    def add(channel: int, row: torch.Tensor, count: torch.Tensor) -> None:
        x[..., channel].scatter_add_(2, row, count)

    add(0, ref_row, matched)
    add(2, ref_row, matched + dels)
    for row, count in ((ref_row, matched - alt_reads - subs), (alt_row, alt_reads),
                       (sub_row, subs)):
        add(1, row, count)
        add(3, row, count)
    add(1, ins_row, ins)
    x[..., 1:] -= x[..., :1]

    return x.to(torch.int16), _labels(cls, ref[:, CENTER], alt, length)


def _labels(cls: torch.Tensor, ref: torch.Tensor, alt: torch.Tensor,
            length: torch.Tensor) -> torch.Tensor:
    """The 90-wide one-hot label rows of each site's class."""
    device = cls.device
    hom = torch.tensor(_HOM, device=device)
    pair = torch.tensor(_PAIR, device=device)
    zero = torch.zeros_like(length)
    # per class: gt21, genotype, the two sorted indel lengths
    gt21 = torch.stack([hom[ref], pair[ref, alt], hom[alt], _BASE_INS + ref,
                        torch.full_like(ref, _INS_INS), _BASE_DEL + ref,
                        torch.full_like(ref, _DEL_DEL)], dim=1)
    genotype = torch.tensor((0, 2, 1, 2, 1, 2, 1), device=device)[cls]
    len1 = torch.stack([zero, zero, zero, zero, length, -length, -length], dim=1)
    len2 = torch.stack([zero, zero, zero, length, length, zero, -length], dim=1)
    pick = cls[:, None]
    y = torch.zeros((len(cls), LABELS), dtype=torch.uint8, device=device)
    rows = torch.arange(len(cls), device=device)
    y[rows, gt21.gather(1, pick)[:, 0]] = 1
    y[rows, _GENOTYPE_AT + genotype] = 1
    y[rows, _LEN1_AT + MAX_INDEL + len1.gather(1, pick)[:, 0]] = 1
    y[rows, _LEN2_AT + MAX_INDEL + len2.gather(1, pick)[:, 0]] = 1
    return y
