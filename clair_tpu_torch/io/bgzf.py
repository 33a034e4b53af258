"""BGZF block layer: block-aware reading with virtual offsets.

BAM random access needs BGZF's two-level addressing — a virtual offset
packs (compressed block start << 16 | offset within the inflated block).
Python's gzip module hides block boundaries, so this module parses the
BGZF container directly (gzip members with a BC extra subfield carrying
the block size), enabling:

- virtual-offset seeks for BAI-indexed region queries
- block-parallel inflation (each block is an independent deflate stream)
"""

from __future__ import annotations

import concurrent.futures
import struct
import zlib
from typing import Iterator, List, Optional, Tuple


def parse_block_header(raw: bytes, offset: int) -> int:
    """Return the total compressed size of the BGZF block at ``offset``.

    Walks the gzip extra subfields for BC (SAM spec 4.1); raises on
    non-BGZF gzip members.
    """
    if raw[offset:offset + 2] != b"\x1f\x8b":
        raise ValueError(f"not a gzip member at offset {offset}")
    flags = raw[offset + 3]
    if not flags & 4:  # FEXTRA
        raise ValueError("gzip member without extra field (not BGZF)")
    (xlen,) = struct.unpack_from("<H", raw, offset + 10)
    cursor = offset + 12
    end = cursor + xlen
    while cursor + 4 <= end:
        si1, si2, slen = raw[cursor], raw[cursor + 1], struct.unpack_from("<H", raw, cursor + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:  # 'B','C'
            (bsize_minus_1,) = struct.unpack_from("<H", raw, cursor + 4)
            return bsize_minus_1 + 1
        cursor += 4 + slen
    raise ValueError("BGZF BC subfield not found")


def block_offsets(raw: bytes, start: int = 0, end: Optional[int] = None) -> List[Tuple[int, int]]:
    """[(compressed_offset, compressed_size), ...] for blocks in [start, end)."""
    end = len(raw) if end is None else end
    out = []
    offset = start
    while offset < end:
        size = parse_block_header(raw, offset)
        out.append((offset, size))
        offset += size
    return out


def _inflate_block(raw: bytes, offset: int, size: int) -> bytes:
    # skip the fixed 18-byte BGZF header... header length varies with XLEN;
    # use zlib with gzip wrapper detection instead (wbits 31 handles it)
    return zlib.decompress(raw[offset:offset + size], 15 + 16)


def inflate_range(
    raw: bytes,
    start_block_offset: int = 0,
    end_offset: Optional[int] = None,
    threads: int = 0,
) -> Tuple[bytes, List[Tuple[int, int]]]:
    """Inflate all blocks from ``start_block_offset`` to ``end_offset``.

    Returns (data, index) where index maps each block's compressed offset to
    its start position in ``data`` (for virtual-offset resolution).
    Blocks inflate in parallel when ``threads`` > 1 (each BGZF block is an
    independent deflate stream).
    """
    blocks = block_offsets(raw, start_block_offset, end_offset)
    if threads and threads > 1 and len(blocks) > 4:
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            parts = list(pool.map(lambda b: _inflate_block(raw, *b), blocks))
    else:
        parts = [_inflate_block(raw, *b) for b in blocks]
    index = []
    position = 0
    for (offset, _), part in zip(blocks, parts):
        index.append((offset, position))
        position += len(part)
    return b"".join(parts), index


def resolve_virtual_offset(
    index: List[Tuple[int, int]], virtual_offset: int, base_compressed_offset: int = 0
) -> int:
    """Map a BAI virtual offset to a position in inflated data produced by
    inflate_range starting at base_compressed_offset."""
    coffset = (virtual_offset >> 16) - base_compressed_offset
    uoffset = virtual_offset & 0xFFFF
    # binary search the block table
    lo, hi = 0, len(index)
    while lo < hi:
        mid = (lo + hi) // 2
        if index[mid][0] <= coffset:
            lo = mid + 1
        else:
            hi = mid
    if lo == 0:
        return uoffset
    block_coffset, block_upos = index[lo - 1]
    return block_upos + uoffset
