"""The float32 sweeps' geometries, the same arithmetic as their sources:
which (cluster size, rows per tile) a CTA fits, for a hidden size. The
forward sweep (``csrc/lstm_sweep.cuh``: ``SweepGeometry``, also by U's piece
count) serves rows 1 (float32 mode), 3, 4 and 5; the reverse sweep
(``csrc/lstm_bwd_sweep.cuh``: ``BwdSweepGeometry``) the float32 backwards,
rows 2 (float32 mode) and 6. Their wrappers raise ValueError through
``check_sweep_width`` and ``check_bwd_sweep_width`` before a launch that no
geometry fits.
"""

from __future__ import annotations

from typing import Tuple

# cluster sizes, rows per tile, and what a CTA may take
SWEEP_CLUSTERS = (2, 4, 8)
SWEEP_ROWS = tuple(range(8, 129, 8))
_SMEM_LIMIT = 227 * 1024  # shared memory a block may take on Hopper
_SWEEP_WARPS, _SWEEP_MAX_ITEMS = 8, 2
_THREADS, _BWD_MAX_QUADS = 256, 2  # the reverse sweep: (row, 4 units) cells a thread


def sweep_layout(hidden: int, cluster: int, rows: int, u_pieces: int = 3) -> Tuple[int, int]:
    """(shared-memory bytes, warp items) of one CTA of the forward sweep:
    U's ``u_pieces`` bf16 pieces (three of a float32 U, one of a bf16 U)
    for the four gates of its uc = H / C units (rounded up to 8) over the
    depth C * uc, and two h tiles of three pieces; items of 8 units by 16
    rows, or 8 where the rows are no multiple of 16."""
    uc = -(-hidden // (8 * cluster)) * 8
    hk = cluster * uc
    item_rows = 16 if rows % 16 == 0 else 8
    smem = 2 * u_pieces * 4 * uc * hk + 2 * 2 * 3 * rows * hk
    return smem, uc // 8 * (rows // item_rows)


def sweep_geometries(hidden: int, u_pieces: int = 3):
    """Every (cluster, rows) whose CTA fits: shared memory and warp items.
    Whether it launches is the card's to say (clusters it holds at once)."""
    out = []
    for cluster in SWEEP_CLUSTERS:
        for rows in SWEEP_ROWS:
            smem, items = sweep_layout(hidden, cluster, rows, u_pieces)
            if smem <= _SMEM_LIMIT and items <= _SWEEP_WARPS * _SWEEP_MAX_ITEMS:
                out.append((cluster, rows))
    return out


def check_sweep_width(hidden: int, u_pieces: int = 3) -> None:
    """Raise ValueError where the forward sweep cannot take H: no multiple
    of 8, or no geometry whose CTA fits."""
    if hidden % 8:
        raise ValueError(f"the forward sweep takes H in multiples of 8, not H = {hidden}")
    if not sweep_geometries(hidden, u_pieces):
        least = sweep_layout(hidden, SWEEP_CLUSTERS[-1], 8, u_pieces)[0]
        raise ValueError(f"hidden size {hidden}: the forward sweep's CTA needs {least} bytes "
                         f"of shared memory even at a cluster of {SWEEP_CLUSTERS[-1]} and 8 "
                         f"rows, above the {_SMEM_LIMIT} a block may take")




def bwd_sweep_layout(hidden: int, cluster: int, rows: int) -> Tuple[int, int]:
    """(shared-memory bytes, (row, 4 units) cells a thread) of one CTA of
    the reverse sweep: U's three bf16 pieces for the four gates of its
    uc = H / C units (rounded up to 8) over the depth C * uc, the step's
    dgates as three pieces (rows x 4uc), and C float32 receive slots of
    rows x uc (each row padded to 16k + 4 floats)."""
    uc = -(-hidden // (8 * cluster)) * 8
    pitch = -(-uc // 16) * 16 + 4
    smem = 2 * 3 * 4 * uc * cluster * uc + 2 * 3 * rows * 4 * uc + 4 * cluster * rows * pitch
    return smem, -(-rows * uc // 4 // _THREADS)


def bwd_sweep_geometries(hidden: int):
    """Every (cluster, rows) whose reverse-sweep CTA fits: shared memory and
    the cells a thread carries (``BwdSweepGeometry::fits`` in
    ``csrc/lstm_bwd_sweep.cuh``). On an H100 each of them launches, and the
    checks of every geometry hold the card to that."""
    out = []
    for cluster in SWEEP_CLUSTERS:
        for rows in SWEEP_ROWS:
            smem, quads = bwd_sweep_layout(hidden, cluster, rows)
            if smem <= _SMEM_LIMIT and quads <= _BWD_MAX_QUADS:
                out.append((cluster, rows))
    return out


def check_bwd_sweep_width(hidden: int) -> None:
    """Raise ValueError where the reverse sweep cannot take H: no multiple
    of 8, or no geometry whose CTA fits."""
    if hidden % 8:
        raise ValueError(f"the reverse sweep takes H in multiples of 8, not H = {hidden}")
    if not bwd_sweep_geometries(hidden):
        least = bwd_sweep_layout(hidden, SWEEP_CLUSTERS[-1], 8)[0]
        raise ValueError(f"hidden size {hidden}: the reverse sweep's CTA needs {least} bytes "
                         f"of shared memory even at a cluster of {SWEEP_CLUSTERS[-1]} and 8 "
                         f"rows, above the {_SMEM_LIMIT} a block may take")
