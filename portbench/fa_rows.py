"""Synthetic full-alignment rows shaped like a sequencer's, made from a seed.

One row is what a Clair3 full-alignment training bin holds for one
candidate site: a (89, 33, 8) matrix, one row per read (up to 89, ONT's
``matrix_depth``; rows past the site's depth are zero) at each of the 33
positions around the site, in eight channels on Clair3's +-100 scale, and a
90-wide label vector (portbench/pileup.py's labels). The channels, and the
codes this generator gives them (the traffic file lists them as assumed):

- 0, reference base: A 100, C 25, G 75, T 50 (Clair3's ACGT_NUM);
- 1, alternative base: the read's base by the same codes where it differs
  from the reference, -100 where the read has a deletion, else 0;
- 2, strand: forward 50, reverse 100;
- 3, mapping quality: min(MQ, 60) / 60 * 100, per read;
- 4, base quality: min(BQ, 40) / 40 * 100, 0 on a deletion;
- 5, candidate proportion: at the site's column, on each read that differs
  there from the reference, the share of the site's reads that do, * 100;
- 6, insertion base: the first inserted base's code after a position, else 0;
- 7, phasing: 0 (unphased).

The profile (a traffic file's ``reads``) sets the depth, the strand split,
the error rates, the qualities, the allele fractions by genotype and the
mix of labels; each site carries the label of the class its reads show.
Every read spans every position (long reads). Every draw comes from one
``torch.Generator`` on the device the rows are made on, in a fixed
sequence of calls over chunks of ``CHUNK`` rows, so a seed gives the same
rows on the same device whatever the host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.pileup import CLASSES, MAX_INDEL, _labels

CHANNELS = 8
CHUNK = 2_000
ACGT = (100, 25, 75, 50)
DELETED, FORWARD, REVERSE = -100, 50, 100


def make_rows(n: int, profile: Dict, rows: int, positions: int, generator: torch.Generator,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x (n, rows, positions, 8) int16 on the CPU, y (n, 90) uint8 on the
    CPU), made on ``device`` ``CHUNK`` rows at a time."""
    xs, ys = [], []
    for start in range(0, n, CHUNK):
        x, y = _chunk(min(CHUNK, n - start), profile, rows, positions, generator, device)
        xs.append(x.cpu())
        ys.append(y.cpu())
    return torch.cat(xs), torch.cat(ys)


def _chunk(b: int, profile: Dict, rows: int, positions: int, generator: torch.Generator,
           device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    g = dict(generator=generator, device=device)
    center = positions // 2
    share = torch.tensor([float(profile["labels"][c]) for c in CLASSES], device=device)
    cls = torch.multinomial(share / share.sum(), b, replacement=True, generator=generator)
    het = (cls == 1) | (cls == 3) | (cls == 5)
    is_snp, is_ins, is_del = (cls == 1) | (cls == 2), (cls == 3) | (cls == 4), cls >= 5

    ref = torch.randint(0, 4, (b, positions), **g)
    alt = (ref[:, center] + torch.randint(1, 4, (b,), **g)) % 4
    length_weights = torch.tensor([float(profile["indel_length_decay"]) ** k
                                   for k in range(MAX_INDEL)], device=device)
    length = 1 + torch.multinomial(length_weights, b, replacement=True, generator=generator)

    lo, hi = profile["het_af"]
    hom_lo, hom_hi = profile["hom_af"]
    d_lo, d_hi = profile["depth_scale"]
    u = torch.rand((2, b), **g)
    af = torch.where(het, lo + (hi - lo) * u[0], hom_lo + (hom_hi - hom_lo) * u[0])
    depth = torch.round(float(profile["depth"]) * (d_lo + (d_hi - d_lo) * u[1])).clamp(max=rows)

    # per read: present, carries the alternative allele, strand, mapping quality
    read = torch.arange(rows, device=device)[None, :]
    present = read < depth[:, None]
    per_read = torch.rand((3, b, rows), **g)
    carries = per_read[0] < af[:, None]
    forward = per_read[1] < float(profile["forward_share"])
    mq_low = torch.randint(0, 60, (b, rows), **g)
    mq = torch.where(per_read[2] < float(profile["mq60_share"]), 60, mq_low)

    # per read and position: errors, their bases, base qualities
    errors = torch.rand((3, b, rows, positions), **g)
    sub_shift = torch.randint(1, 4, (b, rows, positions), **g)
    ins_base = torch.randint(0, 4, (b, rows, positions), **g)
    q_lo, q_hi = profile["base_quality"]
    bq = torch.randint(int(q_lo), int(q_hi) + 1, (b, rows, positions), **g)

    offset = (torch.arange(positions, device=device) - center)[None, None, :]
    site = offset == 0
    # the deleted bases lie after the site: offsets 1 .. length
    in_deletion = (offset >= 1) & (offset <= length[:, None, None])
    deleted = ((errors[2] < float(profile["deletion"]))
               | (carries[..., None] & is_del[:, None, None] & in_deletion))
    inserted = ((errors[1] < float(profile["insertion"]))
                | (carries[..., None] & is_ins[:, None, None] & site))
    reference = ref[:, None, :].expand(b, rows, positions)
    base = torch.where(carries[..., None] & is_snp[:, None, None] & site,
                       alt[:, None, None], reference)
    base = torch.where(errors[0] < float(profile["substitution"]), (reference + sub_shift) % 4,
                       base)

    codes = torch.tensor(ACGT, device=device)
    differs = deleted | (base != reference)
    at_site = (differs | inserted)[..., center] & present
    proportion = torch.round(100.0 * at_site.sum(1) / depth.clamp(min=1))
    x = torch.zeros((b, rows, positions, CHANNELS), dtype=torch.int16, device=device)
    x[..., 0] = codes[reference]
    x[..., 1] = torch.where(deleted, DELETED, torch.where(base != reference, codes[base], 0))
    x[..., 2] = torch.where(forward, FORWARD, REVERSE)[..., None]
    x[..., 3] = torch.round(mq * 100.0 / 60.0).to(torch.int16)[..., None]
    x[..., 4] = torch.where(deleted, 0, torch.round(bq.clamp(max=40) * 2.5).to(torch.int16))
    x[..., center, 5] = torch.where(at_site, proportion[:, None], 0).to(torch.int16)
    x[..., 6] = torch.where(inserted, codes[ins_base], 0)
    x *= present[..., None, None]
    return x, _labels(cls, ref[:, center], alt, length)
