"""Adaptive arithmetic codec (CRAM 3.1 block compression method 6, "arith").

CRAM 3.1 archives written at higher compression profiles (e.g. samtools
``--output-fmt-option archive``) compress many data series with
htscodecs' ``arith_dynamic`` coder; the reference reads such archives by
delegating to samtools (reference dataPrepScripts/CreateTensor.py:136
opens any input samtools can), so this framework's own CRAM stack needs
the codec to read them. Implemented from the hts-specs CRAMcodecs
description in the repo's reference-implementation style (io/rans4x16.py):
pure Python, both directions, round-trip + golden-structure tests.

Format implemented (one stream):

  | flags u8 | [raw size uint7, unless NOSZ] | transform metas | body |

  flags: 0x01 ORDER1   order-1 (context = previous byte) byte models
         0x04 EXT      body is a bzip2 stream instead of range-coded
         0x08 STRIPE   de-multiplex into N byte-interleaved sub-streams,
                       each itself a full arith stream (NOSZ)
         0x10 NOSZ     raw size omitted (stripe sub-streams)
         0x20 CAT      payload stored uncompressed
         0x40 RLE      run-length aware coding: each maximal run emits
                       its literal through the byte model and its
                       remaining length through per-symbol run models
         0x80 PACK     bit-packing transform (<=16 distinct symbols),
                       same meta layout as rANS Nx16

  Entropy stage: a carry-counting byte-wise range coder (Subbotin /
  Shelwien style, the design the CRAMcodecs spec describes): 32-bit
  range renormalised a byte at a time at 2^24, 64-bit low with a
  cache+FF-run pending-carry encoder; the decoder primes a 32-bit code
  window with 5 input bytes (the first is the encoder's initial zero
  cache byte). Symbols come from adaptive frequency models: every
  symbol starts at frequency 1, gains STEP=16 per occurrence, the table
  rescales (halving, minimum 1) when the total would exceed 2^16-16,
  and a hit symbol bubbles one slot toward the front of the scan order
  when its count passes its neighbour's (the spec's SIMPLE_MODEL).

  ORDER1 keeps one 256-symbol model per preceding byte (context 0 for
  the first byte). RLE coding: for each maximal run, the literal goes
  through the byte model (order-0 or order-1 on the previous literal),
  then the run's remaining length is coded in chunks of <=255 through a
  256-symbol run model selected by the literal byte (chunks after the
  first use a shared continuation model; a 255 chunk means "more").

CAVEAT: like io/rans4x16.py, this is built to the spec from
documentation and validated by round-trip and structural goldens
(tests/test_arith.py), NOT against htslib-written bytes — no htslib in
this environment. The adaptive-model constants (STEP, rescale bound,
bubble rule) and the RLE chunk chaining are the most likely points of
divergence from htscodecs; first contact with a samtools-written
archive-profile 3.1 file is the validation step, mirrored on
tools/validate_published.py's checkpoint protocol.
"""

from __future__ import annotations

import bz2

from clair_tpu_torch.io.rans4x16 import (
    read_uint7,
    write_uint7,
    _pack_decode,
    _pack_encode,
    _strip_size,
)

F_ORDER1 = 0x01
F_EXT = 0x04
F_STRIPE = 0x08
F_NOSZ = 0x10
F_CAT = 0x20
F_RLE = 0x40
F_PACK = 0x80

_TOP = 1 << 24
_STEP = 16
_MAX_TOTAL = (1 << 16) - _STEP


# ---------------------------------------------------------------------------
# Range coder
# ---------------------------------------------------------------------------

class RangeEncoder:
    """Carry-counting byte renormalised range encoder (32-bit range)."""

    def __init__(self) -> None:
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.ff_num = 0
        self.started = False
        self.out = bytearray()

    def _shift_low(self) -> None:
        if self.low < 0xFF000000 or self.low > 0xFFFFFFFF:
            carry = self.low >> 32
            if self.started:
                self.out.append((self.cache + carry) & 0xFF)
            else:
                # first byte: emit the (zero) initial cache so the
                # decoder can prime a fixed 5-byte window
                self.out.append(carry & 0xFF)
                self.started = True
            while self.ff_num:
                self.out.append((0xFF + carry) & 0xFF)
                self.ff_num -= 1
            self.cache = (self.low >> 24) & 0xFF
        else:
            self.ff_num += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode(self, cum: int, freq: int, tot: int) -> None:
        r = self.range // tot
        self.low += cum * r
        self.range = r * freq
        while self.range < _TOP:
            self.range <<= 8
            self._shift_low()

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class RangeDecoder:
    def __init__(self, data, pos: int = 0) -> None:
        self.data = data
        self.pos = pos
        self.range = 0xFFFFFFFF
        self.code = 0
        self._r = 0
        for _ in range(5):
            self.code = ((self.code << 8) | self._in()) & 0xFFFFFFFF

    def _in(self) -> int:
        if self.pos >= len(self.data):
            return 0  # implicit zero tail (encoder flush truncation-safe)
        b = self.data[self.pos]
        self.pos += 1
        return b

    def get_freq(self, tot: int) -> int:
        self._r = self.range // tot
        f = self.code // self._r
        return tot - 1 if f >= tot else f

    def update(self, cum: int, freq: int) -> None:
        self.code -= cum * self._r
        self.range = self._r * freq
        while self.range < _TOP:
            self.code = ((self.code << 8) | self._in()) & 0xFFFFFFFF
            self.range <<= 8


# ---------------------------------------------------------------------------
# Adaptive model
# ---------------------------------------------------------------------------

class AdaptiveModel:
    """Adaptive frequency model over ``nsym`` symbols (spec SIMPLE_MODEL):
    linear scan in a slowly self-sorting order, +STEP per hit, halving
    rescale at the 16-bit total bound."""

    __slots__ = ("syms", "freqs", "total")

    def __init__(self, nsym: int) -> None:
        self.syms = list(range(nsym))
        self.freqs = [1] * nsym
        self.total = nsym

    def _bump(self, i: int) -> None:
        freqs = self.freqs
        freqs[i] += _STEP
        self.total += _STEP
        if i > 0 and freqs[i] > freqs[i - 1]:
            syms = self.syms
            syms[i], syms[i - 1] = syms[i - 1], syms[i]
            freqs[i], freqs[i - 1] = freqs[i - 1], freqs[i]
        if self.total > _MAX_TOTAL:
            total = 0
            for j in range(len(freqs)):
                freqs[j] -= freqs[j] >> 1
                total += freqs[j]
            self.total = total

    def encode(self, rc: RangeEncoder, sym: int) -> None:
        syms = self.syms
        freqs = self.freqs
        cum = 0
        i = 0
        while syms[i] != sym:
            cum += freqs[i]
            i += 1
        rc.encode(cum, freqs[i], self.total)
        self._bump(i)

    def decode(self, rc: RangeDecoder) -> int:
        f = rc.get_freq(self.total)
        freqs = self.freqs
        cum = 0
        i = 0
        while cum + freqs[i] <= f:
            cum += freqs[i]
            i += 1
        sym = self.syms[i]
        rc.update(cum, freqs[i])
        self._bump(i)
        return sym


# ---------------------------------------------------------------------------
# Entropy stages
# ---------------------------------------------------------------------------

def _encode_o0(data: bytes) -> bytes:
    rc = RangeEncoder()
    model = AdaptiveModel(256)
    for b in data:
        model.encode(rc, b)
    return rc.finish()


def _decode_o0(data, pos: int, out_size: int) -> bytes:
    rc = RangeDecoder(data, pos)
    model = AdaptiveModel(256)
    out = bytearray(out_size)
    for i in range(out_size):
        out[i] = model.decode(rc)
    return bytes(out)


def _encode_o1(data: bytes) -> bytes:
    rc = RangeEncoder()
    models = {}
    ctx = 0
    for b in data:
        m = models.get(ctx)
        if m is None:
            m = models[ctx] = AdaptiveModel(256)
        m.encode(rc, b)
        ctx = b
    return rc.finish()


def _decode_o1(data, pos: int, out_size: int) -> bytes:
    rc = RangeDecoder(data, pos)
    models = {}
    out = bytearray(out_size)
    ctx = 0
    for i in range(out_size):
        m = models.get(ctx)
        if m is None:
            m = models[ctx] = AdaptiveModel(256)
        ctx = out[i] = m.decode(rc)
    return bytes(out)


def _runs(data):
    n = len(data)
    i = 0
    while i < n:
        b = data[i]
        j = i + 1
        while j < n and data[j] == b:
            j += 1
        yield b, j - i
        i = j


def _encode_rle(data: bytes, order: int) -> bytes:
    rc = RangeEncoder()
    lit_models = {}
    run_models = {}
    run_cont = AdaptiveModel(256)
    ctx = 0
    for b, run in _runs(data):
        key = ctx if order else 0
        m = lit_models.get(key)
        if m is None:
            m = lit_models[key] = AdaptiveModel(256)
        m.encode(rc, b)
        ctx = b
        rm = run_models.get(b)
        if rm is None:
            rm = run_models[b] = AdaptiveModel(256)
        rest = run - 1
        chunk = min(rest, 255)
        rm.encode(rc, chunk)
        rest -= chunk
        while chunk == 255:
            chunk = min(rest, 255)
            run_cont.encode(rc, chunk)
            rest -= chunk
    return rc.finish()


def _decode_rle(data, pos: int, out_size: int, order: int) -> bytes:
    rc = RangeDecoder(data, pos)
    lit_models = {}
    run_models = {}
    run_cont = AdaptiveModel(256)
    out = bytearray()
    ctx = 0
    while len(out) < out_size:
        key = ctx if order else 0
        m = lit_models.get(key)
        if m is None:
            m = lit_models[key] = AdaptiveModel(256)
        b = m.decode(rc)
        ctx = b
        rm = run_models.get(b)
        if rm is None:
            rm = run_models[b] = AdaptiveModel(256)
        chunk = rm.decode(rc)
        run = 1 + chunk
        while chunk == 255:
            chunk = run_cont.decode(rc)
            run += chunk
        out += bytes([b]) * run
    if len(out) != out_size:
        raise ValueError(
            f"arith RLE expanded to {len(out)} bytes, expected {out_size}"
        )
    return bytes(out)


# ---------------------------------------------------------------------------
# Public surface
# ---------------------------------------------------------------------------

def compress(data: bytes, order: int = 0, *, use_rle: bool = False,
             use_pack: bool = False, use_ext: bool = False,
             stripe: int = 0) -> bytes:
    """One arith stream. ``use_ext`` stores the body as bzip2 instead of
    range coding (the codec's escape hatch for already-modelled data)."""
    if len(data) == 0:
        raise ValueError("arith cannot encode an empty stream")
    if order not in (0, 1):
        raise ValueError(f"unsupported arith order {order}")
    out = bytearray()
    if stripe > 1 and len(data) < stripe:
        stripe = 0
    if stripe > 1:
        out.append(F_STRIPE)
        write_uint7(out, len(data))
        out.append(stripe)
        subs = []
        for j in range(stripe):
            s = compress(data[j::stripe], order, use_rle=use_rle,
                         use_pack=use_pack, use_ext=use_ext)
            subs.append(bytes([s[0] | F_NOSZ]) + _strip_size(s))
        for s in subs:
            write_uint7(out, len(s))
        for s in subs:
            out += s
        return bytes(out)

    flags = F_ORDER1 if (order == 1 and len(data) >= 4) else 0
    payload = data
    pack_meta = None
    if use_pack:
        pack_meta, packed, ok = _pack_encode(payload)
        if ok:
            flags |= F_PACK
            payload = packed
    if use_rle and len(payload) >= 4:
        flags |= F_RLE
    if len(payload) < 4:
        flags = (flags & ~(F_ORDER1 | F_RLE)) | F_CAT
    if use_ext and not (flags & F_CAT):
        flags = (flags & ~(F_ORDER1 | F_RLE)) | F_EXT

    out.append(flags)
    write_uint7(out, len(data))
    if flags & F_PACK:
        out += pack_meta
    if flags & F_CAT:
        out += payload
    elif flags & F_EXT:
        out += bz2.compress(bytes(payload), 9)
    elif flags & F_RLE:
        out += _encode_rle(payload, 1 if flags & F_ORDER1 else 0)
    elif flags & F_ORDER1:
        out += _encode_o1(payload)
    else:
        out += _encode_o0(payload)
    return bytes(out)


def decompress(data: bytes, out_size: int = None) -> bytes:
    """Decode one arith stream. ``out_size`` is required for NOSZ
    streams (stripe sub-streams)."""
    if not data:
        raise ValueError("empty arith stream")
    flags = data[0]
    pos = 1
    if flags & F_NOSZ:
        if out_size is None:
            raise ValueError("NOSZ arith stream needs an explicit size")
        raw_size = out_size
    else:
        raw_size, pos = read_uint7(data, pos)
    if raw_size == 0:
        return b""

    try:  # native decoder (clair_arith.cpp): same grammar, C speed
        from clair_tpu_torch import native

        out = native.arith_decompress(bytes(data), raw_size)
        if out is not None:
            return out
    except Exception:
        pass

    if flags & F_STRIPE:
        n = data[pos]
        pos += 1
        lens = []
        for _ in range(n):
            ln, pos = read_uint7(data, pos)
            lens.append(ln)
        out = bytearray(raw_size)
        for j in range(n):
            sub_size = (raw_size - j + n - 1) // n
            sub = decompress(data[pos:pos + lens[j]], sub_size)
            out[j::n] = sub
            pos += lens[j]
        return bytes(out)

    pack_meta_pos = None
    if flags & F_PACK:
        pack_meta_pos = pos
        nsym = data[pos]
        pos += 1 + nsym
        packed_len, pos = read_uint7(data, pos)
        payload_size = packed_len
    else:
        payload_size = raw_size

    if flags & F_CAT:
        body = data[pos:pos + payload_size]
        if len(body) != payload_size:
            raise ValueError(
                f"arith CAT stream truncated: {len(body)} of "
                f"{payload_size} bytes present"
            )
    elif flags & F_EXT:
        body = bz2.decompress(bytes(data[pos:]))
        if len(body) != payload_size:
            raise ValueError(
                f"arith EXT body expanded to {len(body)} bytes, "
                f"expected {payload_size}"
            )
    elif flags & F_RLE:
        body = _decode_rle(data, pos, payload_size,
                           1 if flags & F_ORDER1 else 0)
    elif flags & F_ORDER1:
        body = _decode_o1(data, pos, payload_size)
    else:
        body = _decode_o0(data, pos, payload_size)

    if flags & F_PACK:
        body, _, _ = _pack_decode(data, pack_meta_pos, body, raw_size)
    return body
