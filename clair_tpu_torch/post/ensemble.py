"""Ensemble combiner: average per-site probability vectors from multiple
model x BAM ensemble-output runs.

Sites are keyed (chromosome, position); a site is emitted when at least
``minimum_count_to_output`` runs produced it, with the probability vectors
averaged (ref reference clair/post_processing/ensemble.py:10-75).
The output feeds call_var's probabilities re-decode mode.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, TextIO, Tuple

import numpy as np

from clair_tpu_torch.params import INPUT_TENSOR_SIZE


def combine_ensemble(
    rows: Iterable[str],
    output_fh: TextIO = sys.stdout,
    minimum_count_to_output: int = 0,
) -> int:
    counter: Dict[Tuple[str, str], int] = {}
    sequences: Dict[Tuple[str, str], str] = {}
    tensors: Dict[Tuple[str, str], str] = {}
    probabilities: Dict[Tuple[str, str], np.ndarray] = {}

    for row in rows:
        columns = row.rstrip("\n").split("\t")
        key = (columns[0], columns[1])
        counter[key] = counter.get(key, 0) + 1
        if key not in sequences:
            sequences[key] = columns[2]
            tensors[key] = "\t".join(columns[3:3 + INPUT_TENSOR_SIZE])
            probabilities[key] = np.array(
                columns[3 + INPUT_TENSOR_SIZE:], dtype=np.float64
            )
        else:
            probabilities[key] += np.array(
                columns[3 + INPUT_TENSOR_SIZE:], dtype=np.float64
            )

    emitted = 0
    for key, count in counter.items():
        if count < minimum_count_to_output:
            continue
        mean = probabilities[key] / count
        print(
            "\t".join(
                [key[0], key[1], sequences[key], tensors[key]]
                + ["{:.6f}".format(p) for p in mean]
            ),
            file=output_fh,
        )
        emitted += 1
    return emitted
