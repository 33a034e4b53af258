"""IUPAC base maps and sequence utilities.

The ambiguity-code collapses match the reference maps
(reference shared/utils.py:19-29); they are part of the tensor
encoding contract. Lookup tables additionally come as 256-entry numpy
arrays for vectorized sequence encoding.
"""

from __future__ import annotations

import numpy as np

# IUPAC ambiguity code -> one representative ACGT base
BASE2ACGT = dict(
    zip(
        "ACGTURYSWKMBDHVN",
        ("A", "C", "G", "T", "T", "A", "C", "C", "A", "G", "A", "C", "A", "A", "A", "A"),
    )
)

# IUPAC ambiguity code -> base index (A=0 C=1 G=2 T=3)
BASE2NUM = dict(
    zip("ACGTURYSWKMBDHVN", (0, 1, 2, 3, 3, 0, 1, 1, 0, 2, 0, 1, 0, 0, 0, 0))
)

NUM2BASE = "ACGT"
BASIC_BASES = set("ACGTU")

# 256-entry LUTs over raw byte values for vectorized encoding.
# Unknown characters map to -1 so callers can mask them out.
BASE_NUM_LUT = np.full(256, -1, dtype=np.int8)
for _b, _n in BASE2NUM.items():
    BASE_NUM_LUT[ord(_b)] = _n
    BASE_NUM_LUT[ord(_b.lower())] = _n

ACGT_LUT = np.zeros(256, dtype=np.uint8)
for _b, _a in BASE2ACGT.items():
    ACGT_LUT[ord(_b)] = ord(_a)
    ACGT_LUT[ord(_b.lower())] = ord(_a)


def encode_sequence(seq: str) -> np.ndarray:
    """Vectorized base->index encoding; unknown characters become -1."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return BASE_NUM_LUT[raw]


def normalize_to_acgt(seq: str) -> str:
    """Collapse IUPAC codes to ACGT (uppercased); unknowns become NULs."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return ACGT_LUT[raw].tobytes().decode("ascii")


def region_string(ctg_name: str, ctg_start=None, ctg_end=None) -> str:
    """1-based inclusive region string 'ctg:start-end' (or bare contig)."""
    if ctg_name is None:
        return ""
    if (ctg_start is None) != (ctg_end is None):
        return ""
    if ctg_start is None:
        return str(ctg_name)
    return f"{ctg_name}:{ctg_start}-{ctg_end}"
