"""fqzcomp quality codec (CRAM 3.1 block compression method 7, "fqzcomp").

CRAM 3.1 archives written at the highest compression profiles compress
the quality-score series (QS) with fqzcomp, a context-modelled adaptive
coder descended from the fqzcomp FASTQ compressor; the reference reads
such archives via samtools
(reference dataPrepScripts/CreateTensor.py:136). Implemented from
the hts-specs CRAMcodecs description in the repo's codec style
(io/rans4x16.py, io/arith.py, io/tok3.py): pure Python both directions
as the reference implementation, with a native decoder
(native/clair_fqzcomp.cpp, ~130x) tried first on decompress —
round-trip, structural, and native-equivalence tests.

The model: quality strings are smooth — the best predictor of a quality
value is the few values before it, its position along the read, and how
often the prediction has recently been wrong. Every quality byte is
range-coded (io/arith.py coder) under an adaptive model selected by a
context mixing:

  - the previous ``QCTX`` quality values, ``qbits`` bits each
    (the dominant term),
  - a coarse read-position bucket (log2-spaced, ``pbits`` bits),
  - a saturating mismatch counter ("delta"): how many of the recent
    predictions differed from the value before them (``dbits`` bits).

Record lengths are coded in-stream (the spec's DO_LEN behaviour): the
decoder needs no side channel, so the block API stays
``compress(bytes) -> bytes`` / ``decompress(bytes) -> bytes`` with
lengths recovered from the stream itself.

Serialized layout:

  | u8 version (5) | u8 gflags (0: single parameter set) |
  | u8 max_sym | u8 qbits | u8 qshift | u8 pbits | u8 dbits |
  | uint7 n_records | u8 nsym-1 | nsym alphabet bytes | body |

  ``qshift`` is reserved (always equal to qbits; the decoder rejects
  anything else loudly rather than silently ignoring it). The alphabet
  length byte stores nsym-1 so a block touching all 256 byte values
  still encodes.

  Body coding order, mirrored exactly by the decoder:
    per record: 4 length bytes (LE u32) through 4 dedicated models,
    then the record's qualities through the context models.
  Context (16 bits): ``qhist & ((1<<(qbits*QCTX))-1)`` combined with
  the position bucket at ``qbits*QCTX`` and the delta counter above
  that, all masked to 16 bits. Quality values are first mapped through
  a dense alphabet map (u8 nsym + the symbols, emitted after the
  header) so sparse Phred alphabets (e.g. binned {2,12,23,37}) use
  small models — the spec's qmap.

CAVEAT: like the other 3.1 codecs here, built to the spec's design from
documentation and validated by round-trip on realistic quality
profiles, NOT against htslib-written bytes (no htslib in this image).
The context hash layout and table serialization are the likely
divergence points; first contact with a samtools-written archive 3.1
file is the validation step (tools/validate_published.py protocol).
"""

from __future__ import annotations

import struct
from typing import List

from clair_tpu_torch.io.arith import AdaptiveModel, RangeDecoder, RangeEncoder
from clair_tpu_torch.io.rans4x16 import read_uint7, write_uint7

_VERSION = 5
_QCTX = 2          # quality-history values in the context
_CTX_BITS = 16     # total context width


def _params_for(max_mapped: int):
    """Pick context geometry from the mapped alphabet size."""
    qbits = max(1, (max_mapped).bit_length())
    qbits = min(qbits, 6)
    pbits = 3
    dbits = 3
    total = qbits * _QCTX + pbits + dbits
    while total > _CTX_BITS and qbits > 1:
        qbits -= 1
        total = qbits * _QCTX + pbits + dbits
    qshift = qbits
    return qbits, qshift, pbits, dbits


def _pos_bucket(i: int, pbits: int) -> int:
    # log2-spaced buckets: 0,1,2,3.. for positions 0,1,2-3,4-7,...
    return min(i.bit_length(), (1 << pbits) - 1)


class _Ctx:
    __slots__ = ("qbits", "pbits", "dbits", "qmask", "hist", "delta")

    def __init__(self, qbits: int, pbits: int, dbits: int):
        self.qbits = qbits
        self.pbits = pbits
        self.dbits = dbits
        self.qmask = (1 << (qbits * _QCTX)) - 1
        self.hist = 0
        self.delta = 0

    def reset(self) -> None:
        self.hist = 0
        self.delta = 0

    def value(self, pos: int) -> int:
        ctx = self.hist & self.qmask
        ctx |= _pos_bucket(pos, self.pbits) << (self.qbits * _QCTX)
        ctx |= min(self.delta, (1 << self.dbits) - 1) \
            << (self.qbits * _QCTX + self.pbits)
        return ctx & ((1 << _CTX_BITS) - 1)

    def push(self, mapped: int) -> None:
        prev = self.hist & ((1 << self.qbits) - 1)
        q = mapped & ((1 << self.qbits) - 1)
        self.hist = ((self.hist << self.qbits) | q) & self.qmask
        if q != prev:
            self.delta = min(self.delta + 1, 255)
        else:
            self.delta -= self.delta >> 1


def compress(data: bytes, lengths: List[int] = None) -> bytes:
    """One fqzcomp stream. ``lengths`` gives per-record quality-string
    lengths; a single record spanning the whole block is assumed when
    omitted (the CRAM writer passes real lengths)."""
    if len(data) == 0:
        raise ValueError("fqzcomp cannot encode an empty stream")
    if lengths is None:
        lengths = [len(data)]
    if sum(lengths) != len(data):
        raise ValueError(
            f"fqzcomp record lengths sum to {sum(lengths)}, "
            f"block holds {len(data)} bytes"
        )

    alphabet = sorted(set(data))
    qmap = {v: i for i, v in enumerate(alphabet)}
    max_mapped = len(alphabet) - 1
    qbits, qshift, pbits, dbits = _params_for(max_mapped)

    out = bytearray()
    out += struct.pack(
        "<BBBBBBB", _VERSION, 0, max(data), qbits, qshift, pbits, dbits
    )
    write_uint7(out, len(lengths))
    out.append(len(alphabet) - 1)  # nsym-1: a full 256-value alphabet fits
    out += bytes(alphabet)

    rc = RangeEncoder()
    len_models = [AdaptiveModel(256) for _ in range(4)]
    qual_models = {}
    nsym = len(alphabet)
    ctx = _Ctx(qbits, pbits, dbits)
    pos = 0
    for rec_len in lengths:
        for k in range(4):
            len_models[k].encode(rc, (rec_len >> (8 * k)) & 0xFF)
        ctx.reset()
        for i in range(rec_len):
            mapped = qmap[data[pos]]
            pos += 1
            c = ctx.value(i)
            m = qual_models.get(c)
            if m is None:
                m = qual_models[c] = AdaptiveModel(nsym)
            m.encode(rc, mapped)
            ctx.push(mapped)
    out += rc.finish()
    return bytes(out)


def decompress(data: bytes, out_size: int = None) -> bytes:
    """Decode one fqzcomp stream; record lengths come from the stream."""
    if len(data) < 9:
        raise ValueError("truncated fqzcomp stream")
    if out_size is not None:
        try:  # native decoder (clair_fqzcomp.cpp): same grammar, C speed
            from clair_tpu_torch import native

            out = native.fqzcomp_decompress(bytes(data), out_size)
            if out is not None:
                return out
        except Exception:
            pass
    version, gflags, _max_sym, qbits, qshift, pbits, dbits = \
        struct.unpack_from("<BBBBBBB", data, 0)
    if version != _VERSION:
        raise ValueError(f"unsupported fqzcomp version {version}")
    if gflags != 0:
        raise ValueError(
            f"unsupported fqzcomp gflags {gflags:#x} (multi-parameter "
            "streams not implemented)"
        )
    if qshift != qbits:
        raise ValueError(
            f"unsupported fqzcomp qshift {qshift} (reserved field, must "
            f"equal qbits {qbits})"
        )
    pos = 7
    n_records, pos = read_uint7(data, pos)
    nsym = data[pos] + 1
    pos += 1
    alphabet = list(data[pos:pos + nsym])
    if len(alphabet) != nsym:
        raise ValueError("fqzcomp alphabet truncated")
    pos += nsym

    rc = RangeDecoder(data, pos)
    len_models = [AdaptiveModel(256) for _ in range(4)]
    qual_models = {}
    ctx = _Ctx(qbits, pbits, dbits)
    out = bytearray()
    for _ in range(n_records):
        rec_len = 0
        for k in range(4):
            rec_len |= len_models[k].decode(rc) << (8 * k)
        if out_size is not None and len(out) + rec_len > out_size:
            # bail before decoding a hostile multi-GB length, not after
            raise ValueError(
                f"fqzcomp record length {rec_len} overruns the block's "
                f"promised {out_size} bytes"
            )
        ctx.reset()
        for i in range(rec_len):
            c = ctx.value(i)
            m = qual_models.get(c)
            if m is None:
                m = qual_models[c] = AdaptiveModel(nsym)
            mapped = m.decode(rc)
            out.append(alphabet[mapped])
            ctx.push(mapped)
    if out_size is not None and len(out) != out_size:
        raise ValueError(
            f"fqzcomp decoded {len(out)} bytes, block promised {out_size}"
        )
    return bytes(out)
