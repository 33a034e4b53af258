"""SAM text format: read and write, faithful to the record model.

The reference leans on ``samtools view`` for every human-in-the-loop
inspection of its inputs (README.md usage blocks pipe BAMs through
samtools throughout); this framework owns its BAM/CRAM stacks, so the
text view has to come from somewhere too. This module converts between
``BamRecord`` and SAM lines — all 11 mandatory columns plus the
optional-field tail — which gives the CLI a samtools-free ``view``
(BAM/CRAM -> SAM) and ``import_sam`` (SAM -> BAM).

Fidelity notes:

- QUAL renders raw phred +33; a record without qualities prints ``*``.
- RNEXT uses ``=`` when the mate sits on the same contig (the SAM
  convention samtools emits); ``*`` when there is no mate.
- Tags convert between the BAM binary layout (io/bam.py BamRecord.tags)
  and SAM ``TAG:TYPE:VALUE`` text. BAM's fixed-width int types
  (cCsSiI) all print as SAM ``i`` and re-import as the narrowest type
  that fits — the same normalization samtools applies — so
  BAM -> SAM -> BAM is value-faithful, not always byte-identical.
- Import rejects malformed lines loudly (column count, CIGAR/SEQ length
  disagreement) rather than skipping records.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from clair_tpu_torch.io.bam import (
    CIGAR_OPS,
    CIGAR_OP_TO_CODE,
    CONSUMES_QUERY,
    BamRecord,
)
from clair_tpu_torch.io.cram import _split_bam_tags

_B_SUB_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H",
              "i": "<i", "I": "<I", "f": "<f"}


def _tags_to_text(blob: bytes) -> List[str]:
    fields = []
    for (tag, typ, val) in _split_bam_tags(blob):
        if typ == "A":
            fields.append(f"{tag}:A:{chr(val[0])}")
        elif typ in "cCsSiI":
            (v,) = struct.unpack(_B_SUB_FMT[typ], val)
            fields.append(f"{tag}:i:{v}")
        elif typ == "f":
            (v,) = struct.unpack("<f", val)
            fields.append(f"{tag}:f:{v:g}")
        elif typ in "ZH":
            fields.append(f"{tag}:{typ}:{val[:-1].decode('ascii')}")
        elif typ == "B":
            sub = chr(val[0])
            (count,) = struct.unpack_from("<I", val, 1)
            fmt = _B_SUB_FMT[sub]
            size = struct.calcsize(fmt)
            items = [
                str(struct.unpack_from(fmt, val, 5 + k * size)[0])
                for k in range(count)
            ]
            fields.append(f"{tag}:B:{sub}" + "".join("," + s for s in items))
    return fields


def _int_tag_bytes(value: int) -> Tuple[str, bytes]:
    """Narrowest BAM int type holding ``value`` (samtools convention)."""
    if -128 <= value < 128:
        return "c", struct.pack("<b", value)
    if 0 <= value < 256:
        return "C", struct.pack("<B", value)
    if -32768 <= value < 32768:
        return "s", struct.pack("<h", value)
    if 0 <= value < 65536:
        return "S", struct.pack("<H", value)
    if -(1 << 31) <= value < (1 << 31):
        return "i", struct.pack("<i", value)
    return "I", struct.pack("<I", value)


def _tags_from_text(fields: List[str]) -> bytes:
    blob = b""
    for field in fields:
        tag, typ, value = field.split(":", 2)
        if len(tag) != 2:
            raise ValueError(f"bad SAM tag name {tag!r}")
        if typ == "A":
            blob += tag.encode() + b"A" + value.encode("ascii")
        elif typ == "i":
            t, raw = _int_tag_bytes(int(value))
            blob += tag.encode() + t.encode() + raw
        elif typ == "f":
            blob += tag.encode() + b"f" + struct.pack("<f", float(value))
        elif typ in ("Z", "H"):
            blob += tag.encode() + typ.encode() + value.encode("ascii") + b"\x00"
        elif typ == "B":
            parts = value.split(",")
            sub = parts[0]
            fmt = _B_SUB_FMT[sub]
            conv = float if sub == "f" else int
            items = [conv(p) for p in parts[1:]]
            blob += (tag.encode() + b"B" + sub.encode()
                     + struct.pack("<I", len(items))
                     + b"".join(struct.pack(fmt, v) for v in items))
        else:
            raise ValueError(f"unknown SAM tag type {typ!r}")
    return blob


def record_to_sam(rec: BamRecord, references: List[Tuple[str, int]]) -> str:
    """One SAM line (no trailing newline) for a BamRecord."""
    rname = references[rec.ref_id][0] if 0 <= rec.ref_id < len(references) \
        else "*"
    cigar = rec.cigar_str() or "*"
    if rec.next_ref_id < 0:
        rnext, pnext = "*", 0
    elif rec.next_ref_id == rec.ref_id:
        rnext, pnext = "=", rec.next_pos + 1
    else:
        rnext = references[rec.next_ref_id][0] \
            if rec.next_ref_id < len(references) else "*"
        pnext = rec.next_pos + 1
    seq = rec.seq_str() or "*"
    if rec.qual is None:
        qual = "*"
    else:
        qual = (np.minimum(rec.qual, 93) + 33).tobytes().decode("ascii")
    columns = [
        rec.read_name or "*", str(rec.flag), rname, str(rec.pos + 1),
        str(rec.mapq), cigar, rnext, str(pnext), str(rec.tlen), seq, qual,
    ]
    columns.extend(_tags_to_text(rec.tags))
    return "\t".join(columns)


def _parse_cigar(text: str) -> Tuple[np.ndarray, np.ndarray]:
    if text == "*":
        return (np.empty(0, np.uint8), np.empty(0, np.int32))
    ops, lens = [], []
    n = 0
    for ch in text:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            if ch not in CIGAR_OP_TO_CODE:
                raise ValueError(f"bad CIGAR op {ch!r}")
            ops.append(CIGAR_OP_TO_CODE[ch])
            lens.append(n)
            n = 0
    if n:
        raise ValueError(f"CIGAR {text!r} ends mid-length")
    return (np.array(ops, np.uint8), np.array(lens, np.int32))


def sam_line_to_record(line: str, name_to_id) -> BamRecord:
    columns = line.rstrip("\n").split("\t")
    if len(columns) < 11:
        raise ValueError(f"SAM line has {len(columns)} columns (need 11)")
    (qname, flag, rname, pos, mapq, cigar_text, rnext, pnext, tlen,
     seq_text, qual_text) = columns[:11]
    ref_id = -1 if rname == "*" else name_to_id(rname)
    if ref_id is None:
        raise ValueError(f"unknown reference {rname!r}")
    cigar_ops, cigar_lens = _parse_cigar(cigar_text)
    seq = (np.empty(0, np.uint8) if seq_text == "*"
           else np.frombuffer(seq_text.encode("ascii"), np.uint8).copy())
    if len(cigar_ops) and len(seq):
        qlen = int(cigar_lens[CONSUMES_QUERY[cigar_ops]].sum())
        if qlen != len(seq):
            raise ValueError(
                f"{qname}: CIGAR consumes {qlen} bases, SEQ has {len(seq)}"
            )
    qual = None
    if qual_text != "*":
        qual = (np.frombuffer(qual_text.encode("ascii"), np.uint8) - 33) \
            .astype(np.uint8)
        if len(seq) and len(qual) != len(seq):
            raise ValueError(f"{qname}: QUAL length != SEQ length")
    if rnext == "*":
        next_ref_id = -1
    elif rnext == "=":
        next_ref_id = ref_id
    else:
        next_ref_id = name_to_id(rnext)
        if next_ref_id is None:
            raise ValueError(f"unknown mate reference {rnext!r}")
    return BamRecord(
        ref_id=ref_id,
        pos=int(pos) - 1,
        mapq=int(mapq),
        flag=int(flag),
        read_name=qname,
        cigar_ops=cigar_ops,
        cigar_lens=cigar_lens,
        seq=seq,
        qual=qual,
        next_ref_id=next_ref_id,
        next_pos=int(pnext) - 1,
        tlen=int(tlen),
        tags=_tags_from_text(columns[11:]),
    )


class SamReader:
    """Iterate BamRecords from a SAM text file (plain or bgzip/gzip)."""

    def __init__(self, path: str):
        import gzip

        self.path = path
        raw = open(path, "rb")
        if raw.read(2) == b"\x1f\x8b":
            raw.seek(0)
            self._fh = gzip.open(raw, "rt")
        else:
            raw.seek(0)
            self._fh = open(path, "r")
            raw.close()
        self.header_lines: List[str] = []
        self.references: List[Tuple[str, int]] = []
        self._first_record_line: Optional[str] = None
        for line in self._fh:
            if line.startswith("@"):
                self.header_lines.append(line.rstrip("\n"))
                if line.startswith("@SQ"):
                    name, length = None, 0
                    for part in line.rstrip("\n").split("\t")[1:]:
                        if part.startswith("SN:"):
                            name = part[3:]
                        elif part.startswith("LN:"):
                            length = int(part[3:])
                    if name is not None:
                        self.references.append((name, length))
            else:
                self._first_record_line = line
                break
        self._name_to_id = {
            name: i for i, (name, _) in enumerate(self.references)
        }

    @property
    def header_text(self) -> str:
        return "".join(line + "\n" for line in self.header_lines)

    def reference_id(self, name: str) -> Optional[int]:
        return self._name_to_id.get(name)

    def __iter__(self) -> Iterator[BamRecord]:
        lookup = self._name_to_id.get
        if self._first_record_line is not None:
            yield sam_line_to_record(self._first_record_line, lookup)
            self._first_record_line = None
        for line in self._fh:
            if line.strip():
                yield sam_line_to_record(line, lookup)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_sam(records, references, out_fh, header_text: str = "") -> int:
    """Records -> SAM text. Emits @HD/@SQ headers when ``header_text``
    does not already carry them. Returns the record count."""
    if header_text:
        out_fh.write(header_text if header_text.endswith("\n")
                     else header_text + "\n")
    else:
        out_fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        for (name, length) in references:
            out_fh.write(f"@SQ\tSN:{name}\tLN:{length}\n")
    n = 0
    for rec in records:
        out_fh.write(record_to_sam(rec, references) + "\n")
        n += 1
    return n


def sam_to_bam(sam_path: str, bam_path: str) -> int:
    """Import SAM text into BAM (all fields, tags re-encoded)."""
    from clair_tpu_torch.io.bam import BamWriter

    n = 0
    with SamReader(sam_path) as sam:
        with BamWriter(bam_path, sam.references,
                       header_text=sam.header_text) as out:
            for rec in sam:
                out.write(
                    rec.read_name, rec.ref_id, rec.pos, rec.mapq, rec.flag,
                    [(int(l), CIGAR_OPS[o]) for o, l in
                     zip(rec.cigar_ops, rec.cigar_lens)],
                    rec.seq_str(),
                    qual=rec.qual,
                    next_ref_id=rec.next_ref_id,
                    next_pos=rec.next_pos,
                    tlen=rec.tlen,
                    tags=rec.tags,
                )
                n += 1
    return n
