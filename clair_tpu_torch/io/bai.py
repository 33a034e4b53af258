"""BAI index: build and read (the linear-index part used for region seeks).

A .bai carries, per reference, R-tree-style bins plus a 16kb-window linear
index of minimum virtual offsets (SAM spec §5.2). Region queries in this
framework use the linear index: seek to the first alignment that can
overlap the window, then scan forward — exact record filtering happens in
the reader anyway. Bins are written spec-compliantly so external tools can
consume our indexes.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from clair_tpu_torch.io.bgzf import block_offsets

BAI_MAGIC = b"BAI\x01"
LINEAR_SHIFT = 14  # 16kb windows


def reg2bin(beg: int, end: int) -> int:
    """SAM spec §5.3 bin number for [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def build_bai(
    bam_path: str, bai_path: Optional[str] = None, prefer_native: bool = True
) -> str:
    """Index a coordinate-sorted BAM produced by this framework (or any
    spec-compliant BAM). Uses the native single-pass builder when the C++
    library is available (the pure-Python path walks every record)."""
    bai_path = bai_path or bam_path + ".bai"
    if prefer_native:
        try:
            from clair_tpu_torch import native

            if native.build_bai_native(bam_path, bai_path):
                return bai_path
        except Exception:
            pass
    with open(bam_path, "rb") as fh:
        raw = fh.read()

    blocks = block_offsets(raw)
    # inflate sequentially, tracking (record virtual offset)
    import zlib

    inflated_parts = []
    block_table = []  # (uncompressed_start, compressed_offset)
    position = 0
    for offset, size in blocks:
        part = zlib.decompress(raw[offset:offset + size], 15 + 16)
        block_table.append((position, offset))
        inflated_parts.append(part)
        position += len(part)
    data = b"".join(inflated_parts)

    def voffset_of(upos: int) -> int:
        lo, hi = 0, len(block_table)
        while lo < hi:
            mid = (lo + hi) // 2
            if block_table[mid][0] <= upos:
                lo = mid + 1
            else:
                hi = mid
        ustart, coffset = block_table[lo - 1]
        return (coffset << 16) | (upos - ustart)

    if data[:4] != b"BAM\x01":
        raise ValueError(f"{bam_path} is not a BAM")
    (l_text,) = struct.unpack_from("<i", data, 4)
    cursor = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, cursor)
    cursor += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, cursor)
        cursor += 4 + l_name + 4

    bins: List[Dict[int, List[Tuple[int, int]]]] = [dict() for _ in range(n_ref)]
    linear: List[Dict[int, int]] = [dict() for _ in range(n_ref)]

    while cursor + 4 <= len(data):
        (block_size,) = struct.unpack_from("<i", data, cursor)
        record_voffset = voffset_of(cursor)
        record_end_voffset = voffset_of(cursor + 4 + block_size)
        body = cursor + 4
        ref_id, pos = struct.unpack_from("<ii", data, body)
        (n_cigar,) = struct.unpack_from("<H", data, body + 12)
        l_read_name = data[body + 8]
        cursor += 4 + block_size
        if ref_id < 0:
            continue
        # reference span from the CIGAR
        span = 0
        cigar_off = body + 32 + l_read_name
        for k in range(n_cigar):
            (cv,) = struct.unpack_from("<I", data, cigar_off + 4 * k)
            op = cv & 0xF
            if op in (0, 2, 3, 7, 8):
                span += cv >> 4
        end = pos + max(span, 1)
        b = reg2bin(pos, end)
        bins[ref_id].setdefault(b, []).append((record_voffset, record_end_voffset))
        for window in range(pos >> LINEAR_SHIFT, ((end - 1) >> LINEAR_SHIFT) + 1):
            if window not in linear[ref_id] or record_voffset < linear[ref_id][window]:
                linear[ref_id][window] = record_voffset

    import os

    tmp_path = bai_path + f".tmp.{os.getpid()}"
    with open(tmp_path, "wb") as out:
        out.write(BAI_MAGIC)
        out.write(struct.pack("<i", n_ref))
        for r in range(n_ref):
            # merge adjacent chunks within each bin
            out.write(struct.pack("<i", len(bins[r])))
            for bin_id in sorted(bins[r]):
                chunks = _merge_chunks(bins[r][bin_id])
                out.write(struct.pack("<Ii", bin_id, len(chunks)))
                for beg, end_ in chunks:
                    out.write(struct.pack("<QQ", beg, end_))
            if linear[r]:
                n_intervals = max(linear[r]) + 1
                filled = []
                last = 0
                for w in range(n_intervals):
                    if w in linear[r]:
                        last = linear[r][w]
                    filled.append(last)
                out.write(struct.pack("<i", n_intervals))
                out.write(struct.pack(f"<{n_intervals}Q", *filled))
            else:
                out.write(struct.pack("<i", 0))
    os.replace(tmp_path, bai_path)  # atomic: concurrent builders never
    return bai_path                 # expose a truncated index


def _merge_chunks(chunks: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    chunks = sorted(chunks)
    merged = [list(chunks[0])]
    for beg, end in chunks[1:]:
        if beg <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([beg, end])
    return [tuple(c) for c in merged]


class BaiIndex:
    """Parsed .bai — linear-index lookups for region seeks."""

    def __init__(self, bai_path: str):
        with open(bai_path, "rb") as fh:
            raw = fh.read()
        if raw[:4] != BAI_MAGIC:
            raise ValueError(f"{bai_path} is not a BAI index")
        (n_ref,) = struct.unpack_from("<i", raw, 4)
        cursor = 8
        self.linear: List[List[int]] = []
        for _ in range(n_ref):
            (n_bins,) = struct.unpack_from("<i", raw, cursor)
            cursor += 4
            for _ in range(n_bins):
                _bin_id, n_chunks = struct.unpack_from("<Ii", raw, cursor)
                cursor += 8 + 16 * n_chunks
            (n_intervals,) = struct.unpack_from("<i", raw, cursor)
            cursor += 4
            intervals = list(struct.unpack_from(f"<{n_intervals}Q", raw, cursor))
            cursor += 8 * n_intervals
            self.linear.append(intervals)

    def min_virtual_offset(self, ref_id: int, start: int) -> Optional[int]:
        """Virtual offset of the first alignment that may overlap a region
        starting at 0-based ``start`` (None -> no reads / scan from top)."""
        intervals = self.linear[ref_id] if ref_id < len(self.linear) else []
        if not intervals:
            return None
        window = min(start >> LINEAR_SHIFT, len(intervals) - 1)
        return intervals[window] or None
