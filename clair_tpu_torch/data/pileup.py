"""Vectorized pileup engine: BAM reads -> candidate sites -> pileup tensors.

This replaces the reference's two PyPy CIGAR-walking processes — the
per-read-base dict pileup of ExtractVariantCandidates.py:254-317 and the
active-window event loop of CreateTensor.py:245-365 (the system bottleneck,
README.md:322) — with columnar numpy:

1. each read batch expands its CIGAR into flat event arrays (one np.repeat
   per op class, no per-base Python),
2. candidate selection is a bincount + argsort over the (L, 7) count matrix,
3. tensor creation scatters events into all overlapping candidate windows
   with one bincount over flattened (candidate, position, row, channel)
   indices.

Count semantics preserved from the reference (they define the model input):
- match increments ch0/ch2 at the ref-base row and ch1/ch3 at the
  query-base row; insertions increment ch1 at position+queryAdv (capped at
  the last row); deletions increment ch2 at the ref-base row
  (CreateTensor.py:29-65)
- per-start-position depth cap of 250 reads (CreateTensor.py:267-274)
- candidate I/D counts attach once per op to the position before it
  (ExtractVariantCandidates.py:304-311)
- the <55%-aligned soft-clip read filter (EVC.py:155-170)
- left-edge window inclusion (CreateTensor.py:92-100): with it on (the
  default), every event inside [center-17, center+15] contributes
- 'N' query bases count in the candidate N column (EVC evc_base_from) but
  map to base row 0 in tensors (BASE2NUM['N'] == 0)

Divergences (documented): the 5M "available slots" memory throttle is not
replicated (we never drop events), and N/ref-skip CIGAR ops advance the
reference coordinate correctly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np

from clair_tpu_torch.params import (
    FLANKING_BASE_NUM,
    MATRIX_NUM,
    MATRIX_ROW,
    MAX_DEPTH_PER_POSITION,
    NO_OF_POSITIONS,
)
from clair_tpu_torch.io.bam import BamRecord, CONSUMES_QUERY, CONSUMES_REF
from clair_tpu_torch.utils.genomics import BASE2ACGT, BASE2NUM, BASE_NUM_LUT

OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)
_MATCH_OPS = (OP_M, OP_EQ, OP_X)

# candidate pileup columns (insertion order matters for tie-breaking: the
# reference sorts dict items {A,C,G,T,I,D,N} with a stable sort)
COL_A, COL_C, COL_G, COL_T, COL_I, COL_D, COL_N = range(7)
PILEUP_COLS = 7

# byte -> candidate column: IUPAC codes collapse to ACGT, N stays N
CANDIDATE_COL_LUT = np.full(256, -1, dtype=np.int8)
for _b in "ACGTURYSWKMBDHV":
    CANDIDATE_COL_LUT[ord(_b)] = BASE2NUM[BASE2ACGT[_b]]
    CANDIDATE_COL_LUT[ord(_b.lower())] = BASE2NUM[BASE2ACGT[_b]]
CANDIDATE_COL_LUT[ord("N")] = COL_N
CANDIDATE_COL_LUT[ord("n")] = COL_N


@dataclass
class ReadEvents:
    """Flat event arrays for a batch of reads (coordinates 0-based)."""

    # per aligned base
    match_pos: np.ndarray
    match_qcol: np.ndarray     # candidate column 0..3 / 6(N), -1 unknown
    match_strand: np.ndarray
    # per inserted base
    ins_pos: np.ndarray        # reference position AFTER the insertion point
    ins_adv: np.ndarray        # 0-based index within the insertion
    ins_qcol: np.ndarray
    ins_strand: np.ndarray
    # per deleted reference base
    del_pos: np.ndarray
    del_strand: np.ndarray
    # per indel OP (for candidate counting and allele recovery)
    ins_op_pos: np.ndarray     # ref position after the insertion point
    del_op_pos: np.ndarray     # first deleted position
    ins_op_len: np.ndarray
    del_op_len: np.ndarray
    # optional per-event read layout (events_from_reads track_read_layout):
    # the owning read's 0-based start position, and the event's global
    # walk ordinal (read-stream order, CIGAR order within a read). Needed
    # only by the reference-parity modes (--stop_consider_left_edge and the
    # 5M available-slots throttle, CreateTensor.py:92-100, 180).
    match_rstart: Optional[np.ndarray] = None
    ins_rstart: Optional[np.ndarray] = None
    del_rstart: Optional[np.ndarray] = None
    match_ord: Optional[np.ndarray] = None
    ins_ord: Optional[np.ndarray] = None
    del_ord: Optional[np.ndarray] = None


def _expand_spans(starts: np.ndarray, lengths: np.ndarray):
    """Flatten [start_i, start_i + len_i) spans into positions plus the
    owning span index and within-span cursor."""
    span_id = np.repeat(np.arange(len(lengths)), lengths)
    cursor = np.arange(int(lengths.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(lengths)[:-1]]), lengths
    )
    return starts[span_id] + cursor, span_id, cursor


def soft_clip_fraction_ok(record: BamRecord) -> bool:
    """Keep reads with >= 55% aligned bases (ref EVC.py:155-170)."""
    total = int(record.cigar_lens.sum())
    soft = int(record.cigar_lens[record.cigar_ops == OP_S].sum())
    return 1.0 - soft / (total + 1) >= 0.55


def apply_depth_cap(
    records: Iterable[BamRecord], dcov: int = MAX_DEPTH_PER_POSITION
) -> List[BamRecord]:
    """Cap reads per start position (ref CreateTensor.py:267-274 counts
    records sharing POS and skips beyond dcov)."""
    kept = []
    previous_pos, count = -1, 0
    for record in records:
        if record.pos != previous_pos:
            previous_pos, count = record.pos, 0
        else:
            count += 1
            if count >= dcov:
                continue
        kept.append(record)
    return kept


def events_from_reads(
    records: Iterable[BamRecord], track_read_layout: bool = False
) -> ReadEvents:
    """Expand a read batch's CIGARs into flat event arrays.

    track_read_layout additionally records, per event, the owning read's
    start position and the global walk ordinal (read-stream order, CIGAR
    order within a read) — required by the reference-parity tensor modes.
    """
    m_pos, m_qc, m_st = [], [], []
    i_pos, i_adv, i_qc, i_st = [], [], [], []
    d_pos, d_st = [], []
    iop_pos, dop_pos, iop_len, dop_len = [], [], [], []
    m_rs, i_rs, d_rs = [], [], []
    m_ord, i_ord, d_ord = [], [], []
    ordinal_base = 0

    for record in records:
        ops, lens = record.cigar_ops, record.cigar_lens
        strand = 1 if record.is_reverse else 0
        qcol = CANDIDATE_COL_LUT[record.seq]

        ref_starts = record.pos + np.concatenate(
            [[0], np.cumsum(np.where(CONSUMES_REF[ops], lens, 0))[:-1]]
        )
        q_starts = np.concatenate(
            [[0], np.cumsum(np.where(CONSUMES_QUERY[ops], lens, 0))[:-1]]
        )
        if track_read_layout:
            # walk ordinal: every M/=/X, I, D base is one walk step
            generates = np.isin(ops, _MATCH_OPS) | (ops == OP_I) | (ops == OP_D)
            ord_starts = ordinal_base + np.concatenate(
                [[0], np.cumsum(np.where(generates, lens, 0))[:-1]]
            )
            ordinal_base = int(ordinal_base + np.where(generates, lens, 0).sum())

        is_match = np.isin(ops, _MATCH_OPS)
        if is_match.any():
            pos, span_id, cursor = _expand_spans(ref_starts[is_match], lens[is_match])
            q = q_starts[is_match][span_id] + cursor
            m_pos.append(pos)
            m_qc.append(qcol[q])
            m_st.append(np.full(len(pos), strand, dtype=np.int8))
            if track_read_layout:
                m_rs.append(np.full(len(pos), record.pos, dtype=np.int64))
                m_ord.append(ord_starts[is_match][span_id] + cursor)

        is_ins = ops == OP_I
        if is_ins.any():
            # insertions do not consume reference: every inserted base keeps
            # the op's reference position; only the query cursor advances
            _, span_id, cursor = _expand_spans(ref_starts[is_ins], lens[is_ins])
            q = q_starts[is_ins][span_id] + cursor
            i_pos.append(ref_starts[is_ins][span_id])
            i_adv.append(cursor)
            i_qc.append(qcol[q])
            i_st.append(np.full(len(span_id), strand, dtype=np.int8))
            iop_pos.append(ref_starts[is_ins])
            iop_len.append(lens[is_ins].astype(np.int64))
            if track_read_layout:
                i_rs.append(np.full(len(span_id), record.pos, dtype=np.int64))
                i_ord.append(ord_starts[is_ins][span_id] + cursor)

        is_del = ops == OP_D
        if is_del.any():
            pos, span_id, cursor = _expand_spans(ref_starts[is_del], lens[is_del])
            d_pos.append(pos)
            d_st.append(np.full(len(pos), strand, dtype=np.int8))
            dop_pos.append(ref_starts[is_del])
            dop_len.append(lens[is_del].astype(np.int64))
            if track_read_layout:
                d_rs.append(np.full(len(pos), record.pos, dtype=np.int64))
                d_ord.append(ord_starts[is_del][span_id] + cursor)

    def cat(parts, dtype=np.int64):
        return np.concatenate(parts) if parts else np.empty(0, dtype=dtype)

    return ReadEvents(
        match_pos=cat(m_pos), match_qcol=cat(m_qc, np.int8), match_strand=cat(m_st, np.int8),
        ins_pos=cat(i_pos), ins_adv=cat(i_adv), ins_qcol=cat(i_qc, np.int8),
        ins_strand=cat(i_st, np.int8),
        del_pos=cat(d_pos), del_strand=cat(d_st, np.int8),
        ins_op_pos=cat(iop_pos), del_op_pos=cat(dop_pos),
        ins_op_len=cat(iop_len), del_op_len=cat(dop_len),
        match_rstart=cat(m_rs) if track_read_layout else None,
        ins_rstart=cat(i_rs) if track_read_layout else None,
        del_rstart=cat(d_rs) if track_read_layout else None,
        match_ord=cat(m_ord) if track_read_layout else None,
        ins_ord=cat(i_ord) if track_read_layout else None,
        del_ord=cat(d_ord) if track_read_layout else None,
    )


# ---------------------------------------------------------------------------
# Candidate selection (ExtractVariantCandidates equivalent)
# ---------------------------------------------------------------------------

def pileup_counts(events: ReadEvents, region_start: int, region_length: int) -> np.ndarray:
    """(region_length, 7) counts of A/C/G/T/I/D/N per reference position.

    One bincount over flattened (position, column) indices — np.add.at is
    ~5x slower on this scatter shape and this is the per-aligned-base hot
    loop of candidate selection."""
    ok = events.match_qcol >= 0
    pos = events.match_pos[ok] - region_start
    in_region = (pos >= 0) & (pos < region_length)
    # int32 index math: int64 elementwise ops run ~15x slower on this
    # scatter shape (memory-bound temporaries); any window under ~300 Mbp
    # fits int32 (10 Mbp is the WGS default)
    index_dtype = np.int32 if region_length * PILEUP_COLS < 2**31 else np.int64
    flat_index = (
        pos[in_region].astype(index_dtype) * PILEUP_COLS
        + events.match_qcol[ok][in_region].astype(index_dtype)
    )
    counts = np.bincount(
        flat_index, minlength=region_length * PILEUP_COLS
    ).reshape(region_length, PILEUP_COLS).astype(np.int32)

    for op_pos, column in ((events.ins_op_pos, COL_I), (events.del_op_pos, COL_D)):
        attach = op_pos - 1 - region_start
        in_region = (attach >= 0) & (attach < region_length)
        counts[:, column] += np.bincount(
            attach[in_region], minlength=region_length
        ).astype(np.int32)

    return counts


@dataclass
class CandidateSites:
    positions: np.ndarray       # 0-based reference positions
    depths: np.ndarray
    counts: np.ndarray          # (n, 7) A/C/G/T/I/D/N
    reference_bases: List[str]  # collapsed to ACGT/N


def select_candidates(
    counts: np.ndarray,
    reference_sequence: str,
    region_start: int,
    ref_seq_start: int,
    minimum_af: float,
    minimum_coverage: float,
    position_mask: Optional[np.ndarray] = None,
) -> CandidateSites:
    """Vectorized candidate filter (ref EVC.py:319-378).

    depth = sum(A,C,G,T,N); a site passes if the dominant pileup column is
    not the reference base, or the second column's count / depth clears the
    AF threshold. Column tie-breaking keeps A,C,G,T,I,D,N order (stable
    sort), like the reference's dict-item sort.
    """
    region_length = len(counts)
    offset = region_start - ref_seq_start

    from clair_tpu_torch import native as _native

    native_sel = _native.select_candidates_native(
        counts,
        reference_sequence[offset: offset + region_length].encode("ascii"),
        position_mask, minimum_af, minimum_coverage,
    )
    if native_sel is not None:
        idx, depths, collapsed = native_sel
        return CandidateSites(
            positions=idx + region_start,
            depths=depths.astype(np.int64),
            counts=counts[idx],
            reference_bases=list(collapsed.decode("ascii")),
        )

    depth = counts[:, [COL_A, COL_C, COL_G, COL_T, COL_N]].sum(axis=1)

    ref_raw = np.frombuffer(reference_sequence.encode("ascii"), dtype=np.uint8)[
        offset: offset + region_length
    ]
    ref_column = CANDIDATE_COL_LUT[ref_raw].astype(np.int64)

    # top-2 via two argmax passes (argmax keeps the first max, matching the
    # stable descending sort's A,C,G,T,I,D,N tie order at ~1/4 the cost of
    # a full 7-column argsort on a 250 kb window)
    rows = np.arange(len(counts))
    top_column = counts.argmax(axis=1)
    remaining = counts.copy()
    remaining[rows, top_column] = -1
    second_count = counts[rows, remaining.argmax(axis=1)]

    denominator = np.where(depth > 0, depth, 1)
    passes = (depth >= minimum_coverage) & (
        (top_column != ref_column) | (second_count / denominator >= minimum_af)
    )
    if position_mask is not None:
        passes &= position_mask
    passes &= ref_column >= 0

    idx = np.nonzero(passes)[0]
    # reference bases reported collapsed to ACGT (N stays N), EVC evc_base_from
    collapsed = bytes(
        ord(BASE2ACGT[chr(b)]) if chr(b) != "N" and chr(b) in BASE2ACGT else b
        for b in ref_raw[idx]
    ).decode("ascii")
    return CandidateSites(
        positions=idx + region_start,
        depths=depth[idx],
        counts=counts[idx],
        reference_bases=list(collapsed),
    )


# ---------------------------------------------------------------------------
# Tensor creation (CreateTensor equivalent)
# ---------------------------------------------------------------------------

def _window_spans(pos, centers, flank, rstart=None):
    """Per event: [lo, hi) index range of candidate windows it feeds.
    With rstart (left-edge inclusion OFF, CreateTensor.py:99-100), a window
    only accepts reads whose walk touched its activation key c - 17, i.e.
    reads starting at or before it: c >= rstart + flank + 1."""
    lo = np.searchsorted(centers, pos - flank + 1, side="left")
    hi = np.searchsorted(centers, pos + flank + 1, side="right")
    if rstart is not None:
        lo = np.maximum(lo, np.searchsorted(centers, rstart + flank + 1, side="left"))
    return lo, np.maximum(hi - lo, 0)


def apply_slot_throttle(
    events: ReadEvents,
    centers: np.ndarray,
    budget: int = 5_000_000,
    consider_left_edge: bool = True,
) -> ReadEvents:
    """Reference-parity memory throttle (CreateTensor.py:180, 279-304):
    'available slots' decrement once per (event, active window) pair in
    read-stream walk order; once exhausted, later events contribute nothing
    to any tensor. Events must carry read layout (events_from_reads with
    track_read_layout=True).

    Divergences from the reference's accounting, both at the margin only:
    pairs whose tensor row is out of range (the 2 activation-edge positions
    per window) are not charged here, and the single boundary event is
    dropped whole instead of being given to an unspecified subset of its
    windows (the reference iterates a Python set there).
    """
    if events.match_ord is None:
        raise ValueError("slot throttle needs events with track_read_layout=True")
    centers = np.asarray(centers, dtype=np.int64)
    flank = FLANKING_BASE_NUM

    def spans(pos, rstart):
        _, span = _window_spans(
            pos, centers, flank, None if consider_left_edge else rstart
        )
        return span

    span_m = spans(events.match_pos, events.match_rstart)
    span_i = spans(events.ins_pos, events.ins_rstart)
    span_d = spans(events.del_pos, events.del_rstart)

    all_ord = np.concatenate([events.match_ord, events.ins_ord, events.del_ord])
    all_span = np.concatenate([span_m, span_i, span_d])
    order = np.argsort(all_ord, kind="stable")
    keep = np.empty(len(all_ord), dtype=bool)
    keep[order] = np.cumsum(all_span[order]) <= budget
    n_m, n_i = len(span_m), len(span_i)
    keep_m, keep_i, keep_d = keep[:n_m], keep[n_m:n_m + n_i], keep[n_m + n_i:]

    def f(a, mask):
        return a[mask] if a is not None else None

    return ReadEvents(
        match_pos=events.match_pos[keep_m],
        match_qcol=events.match_qcol[keep_m],
        match_strand=events.match_strand[keep_m],
        ins_pos=events.ins_pos[keep_i],
        ins_adv=events.ins_adv[keep_i],
        ins_qcol=events.ins_qcol[keep_i],
        ins_strand=events.ins_strand[keep_i],
        del_pos=events.del_pos[keep_d],
        del_strand=events.del_strand[keep_d],
        # per-op arrays feed candidate counting / allele recovery, which the
        # reference throttle does not touch (it lives in CreateTensor only)
        ins_op_pos=events.ins_op_pos,
        del_op_pos=events.del_op_pos,
        ins_op_len=events.ins_op_len,
        del_op_len=events.del_op_len,
        match_rstart=f(events.match_rstart, keep_m),
        ins_rstart=f(events.ins_rstart, keep_i),
        del_rstart=f(events.del_rstart, keep_d),
        match_ord=f(events.match_ord, keep_m),
        ins_ord=f(events.ins_ord, keep_i),
        del_ord=f(events.del_ord, keep_d),
    )


def create_tensors(
    events: ReadEvents,
    centers: np.ndarray,
    reference_sequence: str,
    ref_seq_start: int,
    minimum_coverage: int = 0,
    consider_left_edge: bool = True,
    slot_budget: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Scatter events into 33x8x4 count tensors for every candidate center.

    centers: 1-based candidate positions, SORTED ascending.
    reference_sequence: chunk reference starting at 0-based ref_seq_start.

    Returns (tensors, kept_centers, sequences): raw count tensors (not yet
    channel-normalized) and the 33-mer contexts (sequence index i pairs with
    tensor row i; the candidate site sits at index 16). Candidates failing
    minimum coverage at the center row or with incomplete flank context are
    dropped (ref CreateTensor.py:57-59).
    """
    centers = np.asarray(centers, dtype=np.int64)
    n = len(centers)
    flank = FLANKING_BASE_NUM
    if n == 0:
        return (
            np.zeros((0, NO_OF_POSITIONS, MATRIX_ROW, MATRIX_NUM), np.float32),
            centers,
            [],
        )
    if not consider_left_edge or slot_budget is not None:
        if events.match_ord is None:
            raise ValueError(
                "the reference-parity tensor modes (stop_consider_left_edge / "
                "slot throttle) need events_from_reads(track_read_layout=True)"
            )
    if slot_budget is not None:
        events = apply_slot_throttle(events, centers, slot_budget, consider_left_edge)

    size = NO_OF_POSITIONS * MATRIX_ROW * MATRIX_NUM
    flat = np.zeros(n * size, dtype=np.int64)

    ref_raw = np.frombuffer(reference_sequence.encode("ascii"), dtype=np.uint8)
    ref_rows_full = BASE_NUM_LUT[ref_raw].astype(np.int64)

    # coverage bitmask over [mask_lo, mask_hi): positions inside ANY window
    # ([c-17, c+16) per center). Sparse candidates (WGS calling: ~1 per kb)
    # would otherwise pay two binary searches per aligned base of the whole
    # region — the pre-filter drops ~99% of events with one gather.
    mask_lo = int(centers[0]) - flank - 1
    mask_len = int(centers[-1]) + flank - mask_lo
    delta = np.zeros(mask_len + 1, np.int32)
    np.add.at(delta, centers - flank - 1 - mask_lo, 1)
    np.add.at(delta, centers + flank - mask_lo, -1)
    near = np.cumsum(delta[:-1]) > 0

    def near_filter(pos: np.ndarray) -> np.ndarray:
        idx = pos - mask_lo
        ok = (idx >= 0) & (idx < mask_len)
        out = np.zeros(len(pos), dtype=bool)
        out[ok] = near[idx[ok]]
        return out

    def scatter(pos, row_base, strand, channels, adv=None, rstart=None):
        """Add events to every candidate window containing them."""
        if len(pos) == 0:
            return
        # windows with center c (1-based) contain event position p (0-based)
        # when p - c + 17 falls in [0, 33) -> c in [p - 15, p + 17]
        lo, span = _window_spans(pos, centers, flank, rstart)
        keep = span > 0
        if not keep.any():
            return
        pos, row_base, strand, lo, span = (
            pos[keep], row_base[keep], strand[keep], lo[keep], span[keep]
        )
        if adv is not None:
            adv = adv[keep]
        pair_cand, pair_event, _ = _expand_spans(lo, span)
        position_index = pos[pair_event] - centers[pair_cand] + flank + 1
        if adv is not None:
            position_index = np.minimum(
                position_index + adv[pair_event], NO_OF_POSITIONS - 1
            )
        row = row_base[pair_event] + 4 * strand[pair_event]
        base_index = (
            pair_cand * size
            + position_index * (MATRIX_ROW * MATRIX_NUM)
            + row * MATRIX_NUM
        )
        for channel in channels:
            np.add.at(flat, base_index + channel, 1)

    ref_lo, ref_hi = ref_seq_start, ref_seq_start + len(ref_raw)

    # match events: ref row ch0+ch2, query row ch1+ch3
    ok = events.match_qcol >= 0
    mpos = events.match_pos[ok]
    in_ref = (mpos >= ref_lo) & (mpos < ref_hi) & near_filter(mpos)
    mpos = mpos[in_ref]
    mq = events.match_qcol[ok][in_ref].astype(np.int64)
    mst = events.match_strand[ok][in_ref].astype(np.int64)
    mq_row = np.where(mq > 3, 0, mq)          # N -> row 0 (BASE2NUM['N'])
    mref_row = ref_rows_full[mpos - ref_seq_start]
    known = mref_row >= 0
    m_rs = None
    if not consider_left_edge:
        m_rs = events.match_rstart[ok][in_ref][known]
    scatter(mpos[known], mref_row[known], mst[known], (0, 2), rstart=m_rs)
    scatter(mpos[known], mq_row[known], mst[known], (1, 3), rstart=m_rs)

    # insertion events: query row ch1 at position + queryAdv (capped)
    ok = events.ins_qcol >= 0
    ok[ok] = near_filter(events.ins_pos[ok])
    iq = events.ins_qcol[ok].astype(np.int64)
    scatter(
        events.ins_pos[ok],
        np.where(iq > 3, 0, iq),
        events.ins_strand[ok].astype(np.int64),
        (1,),
        adv=events.ins_adv[ok],
        rstart=None if consider_left_edge else events.ins_rstart[ok],
    )

    # deletion events: ref row ch2
    dpos = events.del_pos
    in_ref = (dpos >= ref_lo) & (dpos < ref_hi) & near_filter(dpos)
    dpos = dpos[in_ref]
    dref_row = ref_rows_full[dpos - ref_seq_start]
    known = dref_row >= 0
    scatter(
        dpos[known], dref_row[known],
        events.del_strand[in_ref][known].astype(np.int64), (2,),
        rstart=None if consider_left_edge
        else events.del_rstart[in_ref][known],
    )

    tensors = flat.reshape(n, NO_OF_POSITIONS, MATRIX_ROW, MATRIX_NUM).astype(np.float32)
    return finalize_window_tensors(
        tensors, centers, ref_raw, ref_seq_start, minimum_coverage
    )


def finalize_window_tensors(
    tensors: np.ndarray,
    centers: np.ndarray,
    ref_raw: np.ndarray,
    ref_seq_start: int,
    minimum_coverage: int = 0,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Post-filter filled window tensors: drop candidates failing center
    coverage or with incomplete flank context, and cut their 33-mer
    sequences (ref CreateTensor.py:57-59). ref_raw: uint8 reference bytes
    starting at ref_seq_start. Shared by the numpy and native engines."""
    flank = FLANKING_BASE_NUM
    # depth at the center row == match count == ch0 row sum there
    center_depth = tensors[:, flank, :, 0].sum(axis=1)
    has_left = (centers - (flank + 1) - ref_seq_start) >= 0
    has_right = (centers + flank - ref_seq_start) <= len(ref_raw)
    keep = (center_depth >= minimum_coverage) & has_left & has_right

    sequences = []
    kept = np.nonzero(keep)[0]
    for i in kept:
        c = centers[i] - ref_seq_start
        sequences.append(ref_raw[c - (flank + 1): c + flank].tobytes().decode("ascii"))
    return tensors[kept], centers[kept], sequences
