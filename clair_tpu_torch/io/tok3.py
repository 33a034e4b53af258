"""Name tokenizer codec (CRAM 3.1 block compression method 8, "tok3").

htslib compresses the read-name series (RN) of CRAM 3.1 files with this
codec by default, so reading modern archives requires it; the reference
reads them by delegating to samtools
(reference dataPrepScripts/CreateTensor.py:136). Implemented from
the hts-specs CRAMcodecs description in the repo's
reference-implementation style (io/rans4x16.py, io/arith.py): pure
Python, both directions, round-trip + structural tests.

The model: sequencing read names are highly structured
("m54238/123/ccs", "SRR123.456 1:N:0:ATC"...). Each name splits into
tokens — alphabetic runs, digit runs (with or without leading zeros),
single punctuation chars — and every name is described relative to a
previous name: identical names collapse to a DUP token, otherwise each
token is MATCH (same as the reference name's token at that position),
DELTA/DELTA0 (digit token, value difference 0..255), or a literal.
Token payloads land in per-(position, type) byte streams, and every
stream is entropy-coded independently (rANS Nx16 by default, the arith
coder with the use_arith flag).

Serialized layout (all little-endian):

  | u32 ulen | u32 nnames | u8 flags | streams... |

  flags: bit0 = streams are arith (else rANS Nx16)
         bit1 = names are '\\n'-separated (else '\\0')
         bit2 = the final name has no trailing separator

  Each stream: | u8 desc | body |, emitted for ascending token position,
  ascending type within a position.
    desc = type | 0x80 (first stream of a new token position)
                | 0x40 (duplicate: body is uint7 index of an identical
                       earlier stream in emission order, no data)
    non-duplicate body: uint7 compressed length, then one rANS Nx16 /
    arith stream of the raw bytes.

  Token types (spec enum): 0 TYPE (the per-name type selector stream at
  each position), 1 ALPHA ('\\0'-terminated strings), 2 CHAR (single
  byte), 3 DIGITS0 (u32 value, zero-padded), 4 DZLEN (padded length
  byte), 5 DUP (u32 distance), 6 DIFF (u32 distance), 7 DIGITS (u32
  value), 8 DELTA (u8 difference vs reference digits), 9 DELTA0 (u8
  difference, zero-padded), 10 MATCH, 11 NOP, 12 END.

  Every name encodes, at position 0, DUP (whole name identical to the
  name `dist` back) or DIFF (tokens follow, described against the name
  `dist` back; this encoder always uses dist=1, the decoder honours any
  distance). Digit runs cap at 9 chars so values fit in a u32; longer
  runs split into multiple tokens.

CAVEAT: like io/rans4x16.py and io/arith.py, built to the spec from
documentation, validated by round-trip on realistic name grammars (ONT,
SRA, Illumina styles — tests/test_tok3.py), NOT against htslib-written
bytes (no htslib in this image). The stream-descriptor bit layout and
the encoder's choice of reference name are the most likely points of
divergence; first contact with a samtools-written 3.1 file is the
validation step (see tools/validate_published.py for the protocol).
"""

from __future__ import annotations

import struct
from typing import List, Optional

from clair_tpu_torch.io import arith as _arith
from clair_tpu_torch.io import rans4x16 as _r16
from clair_tpu_torch.io.rans4x16 import read_uint7, write_uint7

T_TYPE = 0
T_ALPHA = 1
T_CHAR = 2
T_DIGITS0 = 3
T_DZLEN = 4
T_DUP = 5
T_DIFF = 6
T_DIGITS = 7
T_DELTA = 8
T_DELTA0 = 9
T_MATCH = 10
T_NOP = 11
T_END = 12
_N_TYPES = 13

F_ARITH = 0x01
F_NEWLINE = 0x02
F_NO_FINAL_SEP = 0x04

_D_NEW_POS = 0x80
_D_DUP = 0x40

_MAX_DIGITS = 9  # values stay within u32


# ---------------------------------------------------------------------------
# Tokenization
# ---------------------------------------------------------------------------

def _tokenize(name: bytes) -> List[tuple]:
    """-> [(kind, payload)]: kind in {ALPHA, CHAR, DIGITS, DIGITS0};
    DIGITS* payload is (value, ndigits)."""
    toks = []
    i = 0
    n = len(name)
    while i < n:
        b = name[i]
        if 0x30 <= b <= 0x39:  # digit run
            j = i
            while j < n and 0x30 <= name[j] <= 0x39 and j - i < _MAX_DIGITS:
                j += 1
            run = name[i:j]
            value = int(run)
            kind = T_DIGITS0 if (run[0] == 0x30 and len(run) > 1) else T_DIGITS
            toks.append((kind, (value, len(run))))
            i = j
        elif (0x41 <= b <= 0x5A) or (0x61 <= b <= 0x7A):  # alpha run
            j = i
            while j < n and ((0x41 <= name[j] <= 0x5A)
                             or (0x61 <= name[j] <= 0x7A)):
                j += 1
            toks.append((T_ALPHA, name[i:j]))
            i = j
        else:
            toks.append((T_CHAR, bytes([b])))
            i += 1
    return toks


def _render(kind: int, payload) -> bytes:
    if kind == T_ALPHA:
        return payload
    if kind == T_CHAR:
        return payload
    value, ndig = payload
    return str(value).zfill(ndig).encode("ascii")


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

class _Streams:
    def __init__(self):
        self.data = {}  # (pos, type) -> bytearray

    def put(self, pos: int, typ: int, payload: bytes) -> None:
        key = (pos, typ)
        buf = self.data.get(key)
        if buf is None:
            buf = self.data[key] = bytearray()
        buf += payload


def _entropy_compress(raw: bytes, use_arith: bool) -> bytes:
    """Smallest of a few transform combos, matching the per-stream trial
    the spec's encoders run."""
    if use_arith:
        cands = [
            _arith.compress(raw, 0),
            _arith.compress(raw, 1),
            _arith.compress(raw, 0, use_rle=True),
        ]
    else:
        cands = [
            _r16.compress(raw, 0),
            _r16.compress(raw, 1),
            _r16.compress(raw, 0, use_rle=True, use_pack=True),
        ]
    return min(cands, key=len)


def _entropy_decompress(stream: bytes, use_arith: bool) -> bytes:
    if use_arith:
        return _arith.decompress(stream)
    return _r16.decompress(stream)


def encode_names(blob: bytes, use_arith: bool = False) -> bytes:
    """Compress a separator-delimited block of read names."""
    if not blob:
        raise ValueError("tok3 cannot encode an empty block")
    sep = 0x0A if (0 not in blob and 0x0A in blob) else 0x00
    flags = F_ARITH if use_arith else 0
    if sep == 0x0A:
        flags |= F_NEWLINE
    body = blob
    if body and body[-1] == sep:
        body = body[:-1]
    else:
        flags |= F_NO_FINAL_SEP
    names = body.split(bytes([sep]))

    streams = _Streams()
    prev_toks: Optional[List[tuple]] = None
    prev_name: Optional[bytes] = None
    for name in names:
        if prev_name is not None and name == prev_name:
            streams.put(0, T_TYPE, bytes([T_DUP]))
            streams.put(0, T_DUP, struct.pack("<I", 1))
            continue
        streams.put(0, T_TYPE, bytes([T_DIFF]))
        streams.put(0, T_DIFF, struct.pack("<I", 1 if prev_name is not None else 0))
        toks = _tokenize(name)
        for t, (kind, payload) in enumerate(toks, start=1):
            ref = prev_toks[t - 1] if prev_toks and t - 1 < len(prev_toks) else None
            if ref is not None and ref[0] == kind and ref[1] == payload:
                streams.put(t, T_TYPE, bytes([T_MATCH]))
                continue
            if kind in (T_DIGITS, T_DIGITS0) and ref is not None \
                    and ref[0] == kind:
                value, ndig = payload
                rvalue, rdig = ref[1]
                delta = value - rvalue
                if 0 <= delta <= 255 and (kind == T_DIGITS or ndig == rdig):
                    typ = T_DELTA if kind == T_DIGITS else T_DELTA0
                    streams.put(t, T_TYPE, bytes([typ]))
                    streams.put(t, typ, bytes([delta]))
                    continue
            streams.put(t, T_TYPE, bytes([kind]))
            if kind == T_ALPHA:
                streams.put(t, T_ALPHA, payload + b"\x00")
            elif kind == T_CHAR:
                streams.put(t, T_CHAR, payload)
            else:
                value, ndig = payload
                streams.put(t, kind, struct.pack("<I", value))
                if kind == T_DIGITS0:
                    streams.put(t, T_DZLEN, bytes([ndig]))
        streams.put(len(toks) + 1, T_TYPE, bytes([T_END]))
        prev_toks, prev_name = toks, name

    out = bytearray()
    out += struct.pack("<II", len(blob), len(names))
    out.append(flags)
    emitted: List[bytes] = []
    last_pos = -1
    for (pos, typ) in sorted(streams.data):
        raw = bytes(streams.data[(pos, typ)])
        desc = typ | (_D_NEW_POS if pos != last_pos else 0)
        last_pos = pos
        try:
            dup_idx = emitted.index(raw)
        except ValueError:
            dup_idx = -1
        if dup_idx >= 0:
            out.append(desc | _D_DUP)
            write_uint7(out, dup_idx)
        else:
            out.append(desc)
            comp = _entropy_compress(raw, use_arith)
            write_uint7(out, len(comp))
            out += comp
        emitted.append(raw)
    return bytes(out)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class _Cursor:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def cstr(self) -> bytes:
        end = self.data.index(0, self.pos)
        s = self.data[self.pos:end]
        self.pos = end + 1
        return s


def decode_names(stream: bytes) -> bytes:
    """Decompress a tok3 stream back to the exact original name block."""
    if len(stream) < 9:
        raise ValueError("truncated tok3 stream")
    ulen, nnames = struct.unpack_from("<II", stream, 0)

    try:  # native decoder (clair_tok3.cpp): same grammar, C speed
        from clair_tpu_torch import native

        out = native.tok3_decode(bytes(stream), ulen)
        if out is not None:
            return out
    except Exception:
        pass

    flags = stream[8]
    use_arith = bool(flags & F_ARITH)
    sep = b"\n" if flags & F_NEWLINE else b"\x00"
    pos = 9

    raw_streams = {}  # (pos, type) -> _Cursor
    emitted: List[bytes] = []
    token_pos = -1
    while pos < len(stream):
        desc = stream[pos]
        pos += 1
        typ = desc & 0x3F
        if typ >= _N_TYPES:
            raise ValueError(f"tok3 stream descriptor has bad type {typ}")
        if desc & _D_NEW_POS:
            token_pos += 1
        if desc & _D_DUP:
            idx, pos = read_uint7(stream, pos)
            if idx >= len(emitted):
                raise ValueError("tok3 duplicate index out of range")
            raw = emitted[idx]
        else:
            clen, pos = read_uint7(stream, pos)
            raw = _entropy_decompress(stream[pos:pos + clen], use_arith)
            pos += clen
        raw_streams[(token_pos, typ)] = _Cursor(raw)
        emitted.append(raw)

    def cursor(p: int, t: int) -> _Cursor:
        c = raw_streams.get((p, t))
        if c is None:
            raise ValueError(f"tok3 stream missing series (pos={p}, type={t})")
        return c

    names: List[bytes] = []
    toks_of: List[List[bytes]] = []
    for i in range(nnames):
        sel = cursor(0, T_TYPE).byte()
        if sel == T_DUP:
            dist = cursor(0, T_DUP).u32()
            src = i - dist if dist else i - 1
            if not (0 <= src < i) and i > 0:
                raise ValueError("tok3 DUP distance out of range")
            names.append(names[src] if i else b"")
            toks_of.append(toks_of[src] if i else [])
            continue
        if sel != T_DIFF:
            raise ValueError(f"tok3 name selector {sel} is not DUP/DIFF")
        dist = cursor(0, T_DIFF).u32()
        ref_toks = []
        if dist:
            src = i - dist
            if not (0 <= src < i):
                raise ValueError("tok3 DIFF distance out of range")
            ref_toks = toks_of[src]
        toks: List[bytes] = []
        t = 1
        while True:
            typ = cursor(t, T_TYPE).byte()
            if typ == T_END:
                break
            if typ == T_NOP:
                toks.append(b"")
            elif typ == T_MATCH:
                toks.append(ref_toks[t - 1])
            elif typ == T_ALPHA:
                toks.append(cursor(t, T_ALPHA).cstr())
            elif typ == T_CHAR:
                toks.append(bytes([cursor(t, T_CHAR).byte()]))
            elif typ == T_DIGITS:
                toks.append(str(cursor(t, T_DIGITS).u32()).encode("ascii"))
            elif typ == T_DIGITS0:
                value = cursor(t, T_DIGITS0).u32()
                ndig = cursor(t, T_DZLEN).byte()
                toks.append(str(value).zfill(ndig).encode("ascii"))
            elif typ == T_DELTA:
                ref = int(ref_toks[t - 1])
                delta = cursor(t, T_DELTA).byte()
                toks.append(str(ref + delta).encode("ascii"))
            elif typ == T_DELTA0:
                ref_tok = ref_toks[t - 1]
                delta = cursor(t, T_DELTA0).byte()
                toks.append(
                    str(int(ref_tok) + delta).encode("ascii").zfill(len(ref_tok))
                )
            else:
                raise ValueError(f"tok3 token type {typ} unexpected mid-name")
            t += 1
        names.append(b"".join(toks))
        toks_of.append(toks)

    blob = sep.join(names)
    if not (flags & F_NO_FINAL_SEP):
        blob += sep
    if len(blob) != ulen:
        raise ValueError(
            f"tok3 decoded {len(blob)} bytes, header promised {ulen}"
        )
    return blob


# Block-layer aliases (io/cram.py dispatch)
compress = encode_names
decompress = decode_names
