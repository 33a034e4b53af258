"""BAM reading/writing from scratch.

The reference shells out to samtools and pysam for all alignment IO
(e.g. reference dataPrepScripts/CreateTensor.py:174,
clair/call_var.py:78-99). Neither exists in this environment, so the
framework carries its own BAM stack:

- BGZF: BAM files are concatenated gzip members; Python's zlib/gzip handles
  both reading (multi-member streams) and writing (we emit spec-compliant
  BGZF blocks with the BC extra field + EOF marker so external tools accept
  our output).
- Records decode into numpy-backed ``BamRecord``s: cigar as (op, len)
  arrays and seq as base-code bytes — the shape the vectorized pileup
  engine consumes directly.

Supports sequential scans with region filtering; a BAI random-access index
is not required for the chunked calling pipeline (each worker scans its
chunk's reads once, like the reference's `samtools view region` stream).
"""

from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

BAM_MAGIC = b"BAM\x01"

# 4-bit base codes -> ASCII
SEQ_CODE_TO_BASE = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
BASE_TO_SEQ_CODE = {chr(b): i for i, b in enumerate(b"=ACMGRSVTWYHKDBN")}

CIGAR_OPS = "MIDNSHP=X"
CIGAR_OP_TO_CODE = {op: i for i, op in enumerate(CIGAR_OPS)}

# ops that consume query / reference (SAM spec table)
CONSUMES_QUERY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)
CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)

FLAG_UNMAPPED = 4
FLAG_REVERSE = 16
# UNMAP | MUNMAP | SECONDARY | SUPPLEMENTARY == 2316 (ref param.py:6)
DEFAULT_EXCLUDE_FLAG = 2316

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


@dataclass
class BamRecord:
    ref_id: int
    pos: int                 # 0-based leftmost
    mapq: int
    flag: int
    read_name: str
    cigar_ops: np.ndarray    # (n,) uint8 op codes
    cigar_lens: np.ndarray   # (n,) int32
    seq: np.ndarray          # (l_seq,) uint8 ASCII bases
    # per-base qualities, raw phred (NOT +33): None when the source had
    # none ('*' quals, or a skip_quals CRAM read). The calling pipeline
    # ignores qualities (count-based pileup, like the reference); this
    # field exists so bam2cram/cram2bam round-trip losslessly.
    qual: Optional[np.ndarray] = None
    # mate pointers + template length (BAM next_refID / next_pos / tlen)
    # and the raw BAM-layout tag blob — carried for lossless conversions;
    # the calling pipeline reads none of them
    next_ref_id: int = -1
    next_pos: int = -1
    tlen: int = 0
    tags: bytes = b""

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def reference_length(self) -> int:
        return int(self.cigar_lens[CONSUMES_REF[self.cigar_ops]].sum())

    @property
    def reference_end(self) -> int:
        return self.pos + self.reference_length

    def seq_str(self) -> str:
        return self.seq.tobytes().decode("ascii")

    def cigar_str(self) -> str:
        return "".join(
            f"{int(l)}{CIGAR_OPS[int(o)]}" for o, l in zip(self.cigar_ops, self.cigar_lens)
        )


class BamReader:
    def __init__(self, path: str):
        self.path = path
        self._fh = gzip.open(path, "rb")
        magic = self._fh.read(4)
        if magic != BAM_MAGIC:
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._fh.read(4))
        self.header_text = self._fh.read(l_text).decode("ascii", "replace")
        (n_ref,) = struct.unpack("<i", self._fh.read(4))
        self.references: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._fh.read(4))
            name = self._fh.read(l_name)[:-1].decode("ascii")
            (l_ref,) = struct.unpack("<i", self._fh.read(4))
            self.references.append((name, l_ref))
        self._name_to_id = {name: i for i, (name, _) in enumerate(self.references)}

    def reference_id(self, name: str) -> Optional[int]:
        return self._name_to_id.get(name)

    def __iter__(self) -> Iterator[BamRecord]:
        read = self._fh.read
        while True:
            head = read(4)
            if len(head) < 4:
                return
            (block_size,) = struct.unpack("<i", head)
            data = read(block_size)
            if len(data) < block_size:
                return
            yield _decode_record(data)

    def fetch(
        self,
        contig: Optional[str] = None,
        start: Optional[int] = None,
        end: Optional[int] = None,
        exclude_flag: int = DEFAULT_EXCLUDE_FLAG,
        min_mapq: int = 0,
        use_index: bool = True,
    ) -> Iterator[BamRecord]:
        """Region scan with flag/MAPQ filtering.

        start/end are 0-based half-open; a record overlaps if its reference
        span intersects [start, end). With a .bai next to the BAM the scan
        seeks to the region's first candidate block; otherwise it streams
        from the top, stopping early once records start past ``end``
        (input BAMs are coordinate-sorted).
        """
        want_ref = self._name_to_id.get(contig) if contig is not None else None
        if contig is not None and want_ref is None:
            return

        source: Iterator[BamRecord] = iter(self)
        if (
            use_index
            and want_ref is not None
            and start is not None
            and __import__("os").path.isfile(self.path + ".bai")
        ):
            seeked = self._records_from_index(want_ref, start)
            if seeked is not None:
                source = seeked

        for record in source:
            if record.flag & exclude_flag:
                continue
            if record.mapq < min_mapq:
                continue
            if want_ref is not None:
                if record.ref_id != want_ref:
                    if record.ref_id > want_ref:
                        return
                    continue
                if end is not None and record.pos >= end:
                    return
                if start is not None and record.reference_end <= start:
                    continue
            yield record

    def _records_from_index(self, ref_id: int, start: int) -> Optional[Iterator[BamRecord]]:
        """Records from the BAI-resolved seek point onward (None -> stream).

        Blocks inflate lazily in ~4MB raw chunks: the caller's early break
        (records past the region end) abandons the generator, so a window
        fetch never decompresses the rest of the file.
        """
        try:
            from clair_tpu_torch.io.bai import BaiIndex

            voffset = BaiIndex(self.path + ".bai").min_virtual_offset(ref_id, start)
            if not voffset:
                return None
        except Exception:
            return None
        coffset = voffset >> 16
        upos = voffset & 0xFFFF

        def generate():
            import zlib

            from clair_tpu_torch.io.bgzf import parse_block_header

            chunk_size = 4 << 20
            with open(self.path, "rb") as fh:
                fh.seek(coffset)
                carry = b""
                data = bytearray()
                cursor = upos
                raw_eof = False
                while True:
                    # parse as many complete records as the buffer holds
                    while cursor + 4 <= len(data):
                        (block_size,) = struct.unpack_from("<i", data, cursor)
                        if cursor + 4 + block_size > len(data):
                            break
                        yield _decode_record(
                            bytes(data[cursor + 4: cursor + 4 + block_size])
                        )
                        cursor += 4 + block_size
                    if raw_eof and cursor + 4 > len(data):
                        return
                    # pull + inflate the next chunk of complete BGZF blocks
                    new = fh.read(chunk_size)
                    if len(new) < chunk_size:
                        raw_eof = True
                    carry += new
                    offset = 0
                    while offset < len(carry):
                        if len(carry) - offset < 18:
                            break  # partial header: wait for the next chunk
                        try:
                            size = parse_block_header(carry, offset)
                        except ValueError:
                            return  # genuinely not a BGZF block
                        if offset + size > len(carry):
                            break
                        data += zlib.decompress(
                            carry[offset:offset + size], 15 + 16
                        )
                        offset += size
                    carry = carry[offset:]
                    if raw_eof and offset == 0:
                        # no further blocks can materialize; a trailing
                        # truncated record (if any) is dropped
                        return

        return generate()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _decode_record(data: bytes) -> BamRecord:
    ref_id, pos, l_read_name, mapq, _bin, n_cigar_op, flag, l_seq = struct.unpack_from(
        "<iiBBHHHi", data, 0
    )
    next_ref_id, next_pos, tlen = struct.unpack_from("<iii", data, 20)
    offset = 32
    read_name = data[offset: offset + l_read_name - 1].decode("ascii")
    offset += l_read_name
    cigar = np.frombuffer(data, dtype=np.uint32, count=n_cigar_op, offset=offset)
    cigar_ops = (cigar & 0xF).astype(np.uint8)
    cigar_lens = (cigar >> 4).astype(np.int32)
    offset += 4 * n_cigar_op
    packed = np.frombuffer(data, dtype=np.uint8, count=(l_seq + 1) // 2, offset=offset)
    codes = np.empty(2 * len(packed), dtype=np.uint8)
    codes[0::2] = packed >> 4
    codes[1::2] = packed & 0xF
    seq = SEQ_CODE_TO_BASE[codes[:l_seq]]
    offset += (l_seq + 1) // 2
    qual = None
    if l_seq and offset + l_seq <= len(data):
        quals = np.frombuffer(data, dtype=np.uint8, count=l_seq, offset=offset)
        if quals.min() != 0xFF:  # an all-0xFF run is BAM's '*' (missing)
            qual = quals.copy()
    offset += l_seq
    tags = bytes(data[offset:]) if offset < len(data) else b""
    return BamRecord(
        ref_id=ref_id,
        pos=pos,
        mapq=mapq,
        flag=flag,
        read_name=read_name,
        cigar_ops=cigar_ops,
        cigar_lens=cigar_lens,
        seq=seq,
        qual=qual,
        next_ref_id=next_ref_id,
        next_pos=next_pos,
        tlen=tlen,
        tags=tags,
    )


# ---------------------------------------------------------------------------
# Writing (spec-compliant BGZF so samtools/pysam elsewhere accept the output)
# ---------------------------------------------------------------------------

def _bgzf_block(payload: bytes) -> bytes:
    compressor = zlib.compressobj(6, zlib.DEFLATED, -15)
    deflated = compressor.compress(payload) + compressor.flush()
    bsize = len(deflated) + 25 + 1  # header(18) + deflate + crc(4) + isize(4)
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)          # XLEN
        + b"BC" + struct.pack("<H", 2)  # BC subfield
        + struct.pack("<H", bsize - 1)
    )
    return header + deflated + struct.pack("<I", zlib.crc32(payload)) + struct.pack(
        "<I", len(payload) & 0xFFFFFFFF
    )


class BamWriter:
    """Minimal BAM writer (used by tests and the training-data tools)."""

    def __init__(self, path: str, references: List[Tuple[str, int]], header_text: str = ""):
        self._fh = open(path, "wb")
        self.references = references
        self._buffer = bytearray()
        header = bytearray()
        header += BAM_MAGIC
        text = header_text.encode("ascii")
        header += struct.pack("<i", len(text)) + text
        header += struct.pack("<i", len(references))
        for name, length in references:
            raw = name.encode("ascii") + b"\x00"
            header += struct.pack("<i", len(raw)) + raw + struct.pack("<i", length)
        self._buffer += header
        self._flush_threshold = 60000

    def write(
        self,
        read_name: str,
        ref_id: int,
        pos: int,
        mapq: int,
        flag: int,
        cigar: List[Tuple[int, str]],
        seq: str,
        qual=30,
        next_ref_id: int = -1,
        next_pos: int = -1,
        tlen: int = 0,
        tags: bytes = b"",
    ) -> None:
        """``qual``: an int writes that constant for every base (the
        historical default); bytes/ndarray of length l_seq writes real
        per-base raw-phred values; None writes the BAM '*' convention
        (an all-0xFF run)."""
        name_raw = read_name.encode("ascii") + b"\x00"
        cigar_raw = b"".join(
            struct.pack("<I", (length << 4) | CIGAR_OP_TO_CODE[op]) for length, op in cigar
        )
        l_seq = len(seq)
        codes = [BASE_TO_SEQ_CODE.get(b, 15) for b in seq]
        if l_seq % 2:
            codes.append(0)
        packed = bytes(
            (codes[i] << 4) | codes[i + 1] for i in range(0, len(codes), 2)
        )
        if qual is None:
            quals = b"\xff" * l_seq
        elif isinstance(qual, int):
            quals = bytes([qual] * l_seq)
        else:
            quals = bytes(bytearray(qual))
            if len(quals) != l_seq:
                raise ValueError(
                    f"per-base quals length {len(quals)} != l_seq {l_seq}"
                )
        record = (
            struct.pack(
                "<iiBBHHHiiii",
                ref_id, pos, len(name_raw), mapq,
                4680,  # bin: unused by our reader
                len(cigar), flag, l_seq,
                next_ref_id, next_pos, tlen,
            )
            + name_raw + cigar_raw + packed + quals + tags
        )
        self._buffer += struct.pack("<i", len(record)) + record
        if len(self._buffer) >= self._flush_threshold:
            self._flush()

    def _flush(self) -> None:
        if self._buffer:
            view = bytes(self._buffer)
            for off in range(0, len(view), 60000):
                self._fh.write(_bgzf_block(view[off: off + 60000]))
            self._buffer = bytearray()

    def close(self) -> None:
        self._flush()
        self._fh.write(_BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
