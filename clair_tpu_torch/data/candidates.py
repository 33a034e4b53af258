"""Candidate-site generation modes (ExtractVariantCandidates equivalent).

Wraps the vectorized pileup counting with the reference's site-selection
modes (reference dataPrepScripts/ExtractVariantCandidates.py):

- calling mode: AF/coverage thresholds + optional BED filter
- training mode (--gen4Training): AF threshold dropped to 0 and sites are
  randomly subsampled; with a truth-variant list, positions 15-16bp away
  from variants are kept with a separate (much higher) probability while
  truth positions themselves are excluded (:59-101, 197-214, 331-341).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, TextIO

import numpy as np

from clair_tpu_torch.data.pileup import (
    CandidateSites,
    ReadEvents,
    pileup_counts,
    select_candidates,
)
from clair_tpu_torch.data.tensor_stream import open_maybe_gzip
from clair_tpu_torch.utils.intervals import BedIntervals

RATIO_OF_NON_VARIANT_TO_VARIANT = 2.0
DEFAULT_OUTPUT_PROBABILITY = 7_000_000.0 * RATIO_OF_NON_VARIANT_TO_VARIANT / 3_000_000_000
# ref EVC.py:210-214
OUTPUT_PROBABILITY_NEAR_VARIANT = 3_500_000.0 * 1.0 * RATIO_OF_NON_VARIANT_TO_VARIANT / 14_000_000
OUTPUT_PROBABILITY_OUTSIDE_VARIANT = (
    3_500_000.0 * RATIO_OF_NON_VARIANT_TO_VARIANT / (3_000_000_000 - 14_000_000)
)


def variant_positions_from(var_fn: Optional[str], contig: str) -> Set[int]:
    """1-based truth positions for one contig from GetTruth-format lines."""
    positions: Set[int] = set()
    if var_fn is None:
        return positions
    with open_maybe_gzip(var_fn) as fh:
        for row in fh:
            columns = row.split(maxsplit=2)
            if columns and columns[0] == contig:
                positions.add(int(columns[1]))
    return positions


def non_variant_positions_near_variants(
    variant_positions: Set[int],
    lower_limit: int = 15,
    upper_limit: int = 16,
) -> Set[int]:
    """Positions 15-16bp from a variant, excluding anything closer than
    15bp to any variant (ref EVC.py:59-101)."""
    near: Set[int] = set()
    excluded: Set[int] = set()
    for position in variant_positions:
        for offset in range(-upper_limit, upper_limit + 1):
            p = position + offset
            if p <= 0:
                continue
            if lower_limit <= abs(offset) <= upper_limit:
                if p not in variant_positions:
                    near.add(p)
            elif abs(offset) < lower_limit:
                excluded.add(p)
    return near - excluded


@dataclass
class CandidateConfig:
    minimum_af: float = 0.125
    minimum_coverage: float = 4
    gen4training: bool = False
    output_probability: float = DEFAULT_OUTPUT_PROBABILITY
    variant_positions: Set[int] = field(default_factory=set)
    near_variant_positions: Set[int] = field(default_factory=set)
    bed: BedIntervals = field(default_factory=BedIntervals)
    contig: str = ""
    seed: Optional[int] = None


def candidate_sites_from_events(
    events: ReadEvents,
    reference_sequence: str,
    region_start: int,
    region_length: int,
    ref_seq_start: int,
    config: CandidateConfig,
) -> CandidateSites:
    counts = pileup_counts(events, region_start, region_length)
    return candidate_sites_from_counts(
        counts, reference_sequence, region_start, ref_seq_start, config
    )


def candidate_sites_from_counts(
    counts: np.ndarray,
    reference_sequence: str,
    region_start: int,
    ref_seq_start: int,
    config: CandidateConfig,
) -> CandidateSites:
    """Site selection over a precomputed (region_length, 7) pileup count
    matrix (the native window scan emits this directly)."""
    region_length = len(counts)

    minimum_af = 0.0 if config.gen4training else config.minimum_af
    mask = None
    if not config.bed.is_empty:
        positions = np.arange(region_start, region_start + region_length)
        mask = config.bed.contains_points(config.contig, positions)

    sites = select_candidates(
        counts, reference_sequence, region_start, ref_seq_start,
        minimum_af, config.minimum_coverage, position_mask=mask,
    )
    if not config.gen4training:
        return sites

    rng = np.random.RandomState(config.seed)
    positions_1based = sites.positions + 1
    if config.variant_positions:
        is_variant = np.fromiter(
            (p in config.variant_positions for p in positions_1based), bool,
            count=len(positions_1based),
        )
        is_near = np.fromiter(
            (p in config.near_variant_positions for p in positions_1based), bool,
            count=len(positions_1based),
        )
        rand = rng.uniform(size=len(positions_1based))
        keep = ~is_variant & (
            (is_near & (rand <= OUTPUT_PROBABILITY_NEAR_VARIANT))
            | (~is_near & (rand <= OUTPUT_PROBABILITY_OUTSIDE_VARIANT))
        )
    else:
        keep = rng.uniform(size=len(positions_1based)) <= config.output_probability

    idx = np.nonzero(keep)[0]
    return CandidateSites(
        positions=sites.positions[idx],
        depths=sites.depths[idx],
        counts=sites.counts[idx],
        reference_bases=[sites.reference_bases[i] for i in idx],
    )


def write_candidates_text(sites: CandidateSites, contig: str, output: TextIO = sys.stdout) -> None:
    """Reference-compatible candidate lines:
    'ctg pos1 refBase depth base count ...' sorted by descending count
    (ref EVC.py:376-378)."""
    column_names = ["A", "C", "G", "T", "I", "D", "N"]
    for i in range(len(sites.positions)):
        counts = sites.counts[i]
        order = np.argsort(-counts, kind="stable")
        pairs = " ".join(f"{column_names[j]} {int(counts[j])}" for j in order)
        print(
            f"{contig} {int(sites.positions[i]) + 1} {sites.reference_bases[i]} "
            f"{int(sites.depths[i])} {pairs}",
            file=output,
        )
