"""Pair truth-variant tensors with randomly sampled non-variant tensors
(PairWithNonVariants equivalent,
reference dataPrepScripts/PairWithNonVariants.py:14-90).

Keeps every truth tensor and samples ~amp x as many non-variant tensors,
BED-filtered and excluding positions that collide with truth sites.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from clair_tpu_torch.data.tensor_stream import open_maybe_gzip
from clair_tpu_torch.utils.intervals import BedIntervals

logger = logging.getLogger(__name__)


def pair_with_non_variants(
    tensor_can_fn: str,
    tensor_var_fn: str,
    output_fn: str,
    bed_fn: Optional[str] = None,
    amplification: float = 2.0,
    seed: Optional[int] = None,
) -> tuple:
    """Returns (n_truth, n_non_variant) written."""
    bed = BedIntervals.from_bed(bed_fn)
    rng = np.random.RandomState(seed)

    truth_keys = set()
    n_truth_sites = 0
    with open_maybe_gzip(tensor_var_fn) as fh:
        for row in fh:
            columns = row.split(maxsplit=2)
            truth_keys.add(f"{columns[0]}-{columns[1]}")
            n_truth_sites += 1

    target = n_truth_sites * amplification
    usable = 0
    with open_maybe_gzip(tensor_can_fn) as fh:
        for row in fh:
            columns = row.split(maxsplit=2)
            if bed_fn is not None and not bed.contains_point(columns[0], int(columns[1])):
                continue
            if f"{columns[0]}-{columns[1]}" in truth_keys:
                continue
            usable += 1

    rate = min(target / usable, 1.0) if usable else 0.0
    logger.info(
        "%d truth variants, %d usable non-variants, sampling %.2f",
        n_truth_sites, usable, rate,
    )

    n_truth = n_non = 0
    is_gzip_out = str(output_fn).endswith(".gz")
    out = open_maybe_gzip(output_fn, "wt") if is_gzip_out else open(output_fn, "w")
    try:
        with open_maybe_gzip(tensor_var_fn) as fh:
            for row in fh:
                out.write(row if row.endswith("\n") else row + "\n")
                n_truth += 1
        with open_maybe_gzip(tensor_can_fn) as fh:
            for row in fh:
                columns = row.split(maxsplit=2)
                if bed_fn is not None and not bed.contains_point(columns[0], int(columns[1])):
                    continue
                if f"{columns[0]}-{columns[1]}" in truth_keys:
                    continue
                if rng.random_sample() < rate:
                    out.write(row if row.endswith("\n") else row + "\n")
                    n_non += 1
    finally:
        out.close()
    logger.info("%d/%d truth/non-variant tensors written", n_truth, n_non)
    return n_truth, n_non
