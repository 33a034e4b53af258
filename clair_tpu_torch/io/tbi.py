"""Tabix (.tbi) index over BGZF text: build, read, and windowed line fetch.

The reference windows its truth VCF through `tabix` when an index exists
(reference dataPrepScripts/GetTruth.py:88-95). This module gives
data.truth the same capability on the framework's own BGZF layer: a WGS
truth lookup becomes a 16kb linear-index seek plus a short forward read
instead of a full-file inflate. Indexes are written spec-compliantly
(bgzip-compressed, VCF preset) so external tabix can consume them, and
externally built .tbi files parse here.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from clair_tpu_torch.io.bai import LINEAR_SHIFT, reg2bin, _merge_chunks
from clair_tpu_torch.io.bgzf import parse_block_header

TBI_MAGIC = b"TBI\x01"
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

# tabix VCF preset (tabix -p vcf)
FORMAT_VCF = 2
COL_SEQ, COL_BEG, COL_END = 1, 2, 0
META_CHAR = ord("#")


def write_bgzf(path: str, data: bytes, block_size: int = 60000) -> None:
    """Write ``data`` as a BGZF stream (blocks + EOF marker)."""
    from clair_tpu_torch.io.bam import _bgzf_block

    with open(path, "wb") as fh:
        for off in range(0, len(data), block_size):
            fh.write(_bgzf_block(data[off:off + block_size]))
        fh.write(BGZF_EOF)


class BgzfTextWriter:
    """File-like text sink writing a spec-compliant BGZF stream.

    Lets any VCF/gVCF emitter target ``out.vcf.gz`` directly (the calling
    CLIs sniff the ``.gz`` suffix): text accumulates into 60000-byte
    members via the BAM layer's deflate helper, and close() appends the
    canonical EOF marker so samtools/tabix accept the file. The reference
    writes plain text and leaves compression to the user's bgzip
    (reference clair/call_var.py output handling); here the writer
    plus build_tbi make ``--call_fn out.vcf.gz`` one step.
    """

    def __init__(self, path: str, block_size: int = 60000):
        from clair_tpu_torch.io.bam import _bgzf_block

        self._block = _bgzf_block
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._block_size = block_size
        self.closed = False

    def write(self, text) -> int:
        self._buf += text.encode("utf-8") if isinstance(text, str) else text
        while len(self._buf) >= self._block_size:
            self._fh.write(self._block(bytes(self._buf[:self._block_size])))
            del self._buf[:self._block_size]
        return len(text)

    def flush(self) -> None:
        # block boundaries are an internal detail; only push finished
        # members down (a mid-buffer flush would fragment the stream)
        self._fh.flush()

    def close(self) -> None:
        if self.closed:
            return
        if self._buf:
            self._fh.write(self._block(bytes(self._buf)))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()
        self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def bgzip_file(src_path: str, dst_path: Optional[str] = None,
               block_size: int = 60000, remove_src: bool = False) -> str:
    """Compress a text file to BGZF (streaming; WGS VCFs never fit the
    write_bgzf whole-buffer path)."""
    import os

    from clair_tpu_torch.io.bam import _bgzf_block

    dst_path = dst_path or src_path + ".gz"
    with open(src_path, "rb") as src, open(dst_path, "wb") as out:
        while True:
            chunk = src.read(block_size)
            if not chunk:
                break
            out.write(_bgzf_block(chunk))
        out.write(BGZF_EOF)
    if remove_src:
        os.remove(src_path)
    return dst_path


def _iter_bgzf_blocks(fh, read_size: int = 1 << 20):
    """Yield ``(compressed_offset, inflated_bytes)`` per BGZF member,
    reading the stream incrementally (constant memory; a block is at most
    64 KiB compressed)."""
    buf = bytearray()
    pos = 0   # parse cursor within buf
    base = 0  # file offset of buf[0]

    def ensure(n: int) -> bool:
        while len(buf) - pos < n:
            chunk = fh.read(read_size)
            if not chunk:
                return False
            buf.extend(chunk)
        return True

    while True:
        if pos >= read_size:  # compact so buf stays ~one read_size
            del buf[:pos]
            base += pos
            pos = 0
        if not ensure(12):
            if len(buf) - pos:
                raise ValueError("truncated BGZF stream (partial header)")
            return
        (xlen,) = struct.unpack_from("<H", buf, pos + 10)
        if not ensure(12 + xlen):
            raise ValueError("truncated BGZF stream (partial extra field)")
        size = parse_block_header(buf, pos)
        if not ensure(size):
            raise ValueError("truncated BGZF stream (partial block)")
        yield base + pos, zlib.decompress(bytes(buf[pos:pos + size]), 15 + 16)
        pos += size


def build_tbi(vcf_gz_path: str, tbi_path: Optional[str] = None) -> str:
    """Index a coordinate-sorted bgzipped VCF (tabix VCF preset).

    Streams block by block — one inflated block plus any carried partial
    line resident at a time — so indexing a WGS-scale .vcf.gz costs
    constant memory, not compressed+uncompressed copies of the file."""
    tbi_path = tbi_path or vcf_gz_path + ".tbi"

    names: List[str] = []
    name_index: Dict[str, int] = {}
    bins: List[Dict[int, List[Tuple[int, int]]]] = []
    linear: List[Dict[int, int]] = []

    def add_line(line: bytes, v_beg: int, v_end: int) -> None:
        if not line or line[0] == META_CHAR:
            return
        columns = line.split(b"\t", 4)
        if len(columns) < 4:
            return
        ctg = columns[0].decode("ascii")
        pos0 = int(columns[1]) - 1
        end0 = pos0 + max(len(columns[3]), 1)
        if ctg not in name_index:
            name_index[ctg] = len(names)
            names.append(ctg)
            bins.append({})
            linear.append({})
        r = name_index[ctg]
        bins[r].setdefault(reg2bin(pos0, end0), []).append((v_beg, v_end))
        for window in range(pos0 >> LINEAR_SHIFT, ((end0 - 1) >> LINEAR_SHIFT) + 1):
            if window not in linear[r] or v_beg < linear[r][window]:
                linear[r][window] = v_beg

    # carry: the partial line left by the previous block (never contains
    # a newline), and the virtual offset where it started
    carry = b""
    carry_voff = 0
    end_voff = 0
    with open(vcf_gz_path, "rb") as fh:
        for coff, part in _iter_bgzf_blocks(fh):
            end_voff = coff << 16 | len(part)
            if not part:
                continue
            buf = carry + part
            lc = len(carry)
            cursor = 0
            while True:
                nl = buf.find(b"\n", cursor)
                if nl == -1:
                    break
                line_end = nl + 1  # > lc: carry never holds a newline
                v_beg = (carry_voff if cursor == 0 and lc > 0
                         else coff << 16 | (cursor - lc))
                add_line(buf[cursor:line_end], v_beg, coff << 16 | (line_end - lc))
                cursor = line_end
            if cursor == 0:
                carry = buf
                if lc == 0:
                    carry_voff = coff << 16
            else:
                carry = buf[cursor:]
                carry_voff = coff << 16 | (cursor - lc)
    if carry:  # final line without a trailing newline
        add_line(carry, carry_voff, end_voff)

    payload = bytearray()
    payload += TBI_MAGIC
    concat_names = b"".join(name.encode("ascii") + b"\x00" for name in names)
    payload += struct.pack(
        "<8i", len(names), FORMAT_VCF, COL_SEQ, COL_BEG, COL_END,
        META_CHAR, 0, len(concat_names),
    )
    payload += concat_names
    for r in range(len(names)):
        payload += struct.pack("<i", len(bins[r]))
        for bin_id in sorted(bins[r]):
            chunks = _merge_chunks(bins[r][bin_id])
            payload += struct.pack("<Ii", bin_id, len(chunks))
            for beg, end in chunks:
                payload += struct.pack("<QQ", beg, end)
        if linear[r]:
            n_intervals = max(linear[r]) + 1
            filled, last = [], 0
            for w in range(n_intervals):
                if w in linear[r]:
                    last = linear[r][w]
                filled.append(last)
            payload += struct.pack("<i", n_intervals)
            payload += struct.pack(f"<{n_intervals}Q", *filled)
        else:
            payload += struct.pack("<i", 0)

    import os

    tmp_path = tbi_path + f".tmp.{os.getpid()}"
    write_bgzf(tmp_path, bytes(payload))
    os.replace(tmp_path, tbi_path)
    return tbi_path


class TbiIndex:
    """Parsed .tbi — linear-index lookups by contig name."""

    def __init__(self, tbi_path: str):
        with open(tbi_path, "rb") as fh:
            raw = gzip.decompress(fh.read())
        if raw[:4] != TBI_MAGIC:
            raise ValueError(f"{tbi_path} is not a tabix index")
        (n_ref, self.format, self.col_seq, self.col_beg, self.col_end,
         self.meta, self.skip, l_nm) = struct.unpack_from("<8i", raw, 4)
        cursor = 36
        names_blob = raw[cursor:cursor + l_nm]
        cursor += l_nm
        self.names = [n.decode("ascii") for n in names_blob.split(b"\x00") if n]
        self.name_index = {n: i for i, n in enumerate(self.names)}
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

    def min_virtual_offset(self, ctg_name: str, start: int) -> Optional[int]:
        """Virtual offset of the first line that may overlap a region from
        0-based ``start`` (None -> contig absent or scan from top)."""
        ref_id = self.name_index.get(ctg_name)
        if ref_id is None:
            return None
        intervals = self.linear[ref_id]
        if not intervals:
            return None
        window = min(start >> LINEAR_SHIFT, len(intervals) - 1)
        return intervals[window] or None


def lines_from_voffset(
    path: str, voffset: int, chunk_size: int = 1 << 20
) -> Iterator[str]:
    """Text lines of a BGZF file starting at a virtual offset, inflating
    lazily in raw chunks (early break never decompresses the rest).
    chunk_size is injectable so tests can force block headers to straddle
    chunk boundaries (a partial header must wait for bytes, not EOF)."""
    coffset, upos = voffset >> 16, voffset & 0xFFFF
    with open(path, "rb") as fh:
        fh.seek(coffset)
        carry = b""
        buf = bytearray()
        cursor = upos
        raw_eof = False
        while True:
            nl = buf.find(b"\n", cursor)
            while nl != -1:
                yield buf[cursor:nl].decode("ascii")
                cursor = nl + 1
                nl = buf.find(b"\n", cursor)
            if cursor > chunk_size:
                del buf[:cursor]
                cursor = 0
            if raw_eof:
                if cursor < len(buf):
                    yield buf[cursor:].decode("ascii")
                return
            new = fh.read(chunk_size)
            if len(new) < chunk_size:
                raw_eof = True
            carry += new
            offset = 0
            while offset < len(carry):
                if len(carry) - offset < 18:
                    break  # partial block header: wait for the next chunk
                try:
                    size = parse_block_header(carry, offset)
                except ValueError:
                    raw_eof = True  # genuinely not a BGZF block
                    break
                if offset + size > len(carry):
                    break
                buf += zlib.decompress(carry[offset:offset + size], 15 + 16)
                offset += size
            carry = carry[offset:]


def indexed_vcf_lines(
    vcf_gz_path: str, ctg_name: str, start0: int
) -> Optional[Iterator[str]]:
    """Lines from the first one that may overlap ctg_name:start0 onward
    (None -> no usable index entry; caller falls back to a full scan)."""
    index = TbiIndex(vcf_gz_path + ".tbi")
    voffset = index.min_virtual_offset(ctg_name, start0)
    if voffset is None:
        return None
    return lines_from_voffset(vcf_gz_path, voffset)
