"""rANS Nx16 codec (CRAM 3.1 block compression method 5, "rans4x16").

CRAM 3.1 archives compress most data series with this codec (htslib
rANS_static4x16pr.c); the reference reads them by delegating to samtools
(reference dataPrepScripts/CreateTensor.py:136 opens any input
samtools can), so this framework's own CRAM stack needs it to read
modern archives. Implemented from the hts-specs CRAMcodecs description
in the same reference-implementation style as the 3.0 codec (io/rans.py):
pure Python, both directions, golden-stream tests.

Format implemented (one stream):

  | flags u8 | [raw size uint7, unless NOSZ] | transform metas | body |

  flags: 0x01 ORDER1   order-1 (context = previous byte) entropy stage
         0x04 X32      32-way interleave: the entropy stage runs 32
                       rANS states instead of 4 (htslib emits this for
                       SIMD-friendly big blocks; both directions here)
         0x08 STRIPE   de-multiplex into N byte-interleaved sub-streams,
                       each itself a full rANS Nx16 stream
         0x10 NOSZ     raw size omitted (stripe sub-streams)
         0x20 CAT      payload stored uncompressed
         0x40 RLE      run-length transform before entropy coding
         0x80 PACK     bit-packing transform (<=16 distinct symbols)

  Entropy stage: 32-bit rANS states, N-way interleaved (N = 4, or 32
  with the X32 flag), renormalising 16 bits at a time (little-endian
  u16), lower bound 1<<15. Frequencies normalise to 4096 (shift 12) for
  order-0 and 1024 (shift 10) for order-1. Order-0 states round-robin
  positions i%N; order-1 splits the output into N segments (one state
  each, the last absorbing the remainder, first byte of each segment
  coded with context 0). Nested streams (compressed order-1 tables,
  compressed RLE metadata) always use the 4-way stage.

  Tables: alphabet as ascending symbols with the consecutive-run scheme
  (after writing symbol j whose predecessor j-1 is present, one byte
  gives the remaining run length), zero-terminated. Order-0 follows with
  one uint7 frequency per present symbol. Order-1 writes, per present
  context, frequencies for every alphabet symbol with zero-run
  shortening (a 0 is followed by a byte counting additional consecutive
  zeros); the whole order-1 table may be stored compressed (leading
  byte 1 + uint7 raw size + uint7 compressed size + order-0 Nx16
  stream, used when it wins).

  PACK meta: u8 nsym, the nsym byte values, uint7 packed length; 1
  symbol -> zero-length body, 2 -> 1 bit each, <=4 -> 2 bits, <=16 ->
  4 bits, low bits of each byte first.
  RLE meta: uint7 (meta_len << 1 | uncompressed_flag), uint7 literal
  length; meta is [n_rle_syms (0 means all 256), the symbols, then one
  uint7 run length per flagged literal occurrence]; compressed meta is
  an order-0 Nx16 stream preceded by its uint7 compressed size.
  STRIPE meta: u8 N, N uint7 compressed sizes; sub-stream j carries
  bytes j, j+N, j+2N, ... and omits its raw size (NOSZ).

CAVEAT: built to the spec from documentation, validated by round-trip
and hand-computed golden streams (tests/test_rans4x16.py) — not yet
against htslib-written bytes (this environment has no network; the same
situation as the TF checkpoint converter, whose first-contact kit is
tools/validate_published.py, and the CRAM analogue is
tools/validate_cram31.py). The other 3.1 codecs live in io/arith.py,
io/fqzcomp.py, and io/tok3.py with the same caveat.
"""

from __future__ import annotations

import struct

RANS_L = 1 << 15
TF_SHIFT_O0 = 12
TOT_O0 = 1 << TF_SHIFT_O0
TF_SHIFT_O1 = 10
TOT_O1 = 1 << TF_SHIFT_O1

F_ORDER1 = 0x01
F_X32 = 0x04
F_STRIPE = 0x08
F_NOSZ = 0x10
F_CAT = 0x20
F_RLE = 0x40
F_PACK = 0x80


# ---------------------------------------------------------------------------
# uint7 varints
# ---------------------------------------------------------------------------

def write_uint7(out: bytearray, value: int) -> None:
    """Variable-length unsigned int, 7 bits per byte, high bit = continue,
    most-significant group first (the CRAM 3.1 itf8-successor)."""
    if value < 0:
        raise ValueError("uint7 cannot encode negatives")
    groups = []
    while True:
        groups.append(value & 0x7F)
        value >>= 7
        if not value:
            break
    for g in reversed(groups[1:]):
        out.append(0x80 | g)
    out.append(groups[0])


def read_uint7(data, pos: int):
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


# ---------------------------------------------------------------------------
# Frequency tables
# ---------------------------------------------------------------------------

def _normalize(counts, total):
    n = sum(counts)
    if n == 0:
        raise ValueError("empty frequency table")
    freqs = [0] * 256
    present = [j for j in range(256) if counts[j]]
    assigned = 0
    for j in present:
        f = counts[j] * total // n
        freqs[j] = f if f > 0 else 1
        assigned += freqs[j]
    top = max(present, key=lambda j: counts[j])
    freqs[top] += total - assigned
    if freqs[top] <= 0:
        freqs = [0] * 256
        base = total // len(present)
        for j in present:
            freqs[j] = base
        freqs[present[0]] += total - base * len(present)
    return freqs


def _write_alphabet(out: bytearray, present) -> None:
    """Ascending symbols; a symbol whose predecessor is present is
    followed by a run-length byte covering the rest of the run."""
    rle = 0
    for j in range(256):
        if not present[j]:
            continue
        if rle:
            rle -= 1
        else:
            out.append(j)
            if j and present[j - 1]:
                run = j + 1
                while run < 256 and present[run]:
                    run += 1
                rle = run - (j + 1)
                out.append(rle)
    out.append(0)


def _read_alphabet(data, pos: int):
    syms = []
    rle = 0
    j = data[pos]
    pos += 1
    while True:
        syms.append(j)
        if rle:
            rle -= 1
            j += 1
        elif pos < len(data) and data[pos] == j + 1:
            j = data[pos]
            rle = data[pos + 1]
            pos += 2
        else:
            j = data[pos]
            pos += 1
            if j == 0:
                return syms, pos


def _cumulative(freqs):
    cum = [0] * 257
    for j in range(256):
        cum[j + 1] = cum[j] + freqs[j]
    return cum


def _sym_lookup(freqs, total):
    cum = _cumulative(freqs)
    sym_of = bytearray(total)
    for j in range(256):
        if freqs[j]:
            for k in range(cum[j], cum[j + 1]):
                sym_of[k] = j
    return cum, sym_of


# ---------------------------------------------------------------------------
# Core 4x16 entropy stage
# ---------------------------------------------------------------------------

def _enc_put(x: int, rev: bytearray, freq: int, cum: int, shift: int) -> int:
    x_max = ((RANS_L >> shift) << 16) * freq
    while x >= x_max:
        # little-endian u16 in stream order; rev is reversed at the end
        rev.append((x >> 8) & 0xFF)
        rev.append(x & 0xFF)
        x >>= 16
    return ((x // freq) << shift) + (x % freq) + cum


def _enc_flush(x: int, rev: bytearray) -> None:
    rev.append((x >> 24) & 0xFF)
    rev.append((x >> 16) & 0xFF)
    rev.append((x >> 8) & 0xFF)
    rev.append(x & 0xFF)


def _rans_encode_o0(data, nx: int = 4) -> bytes:
    counts = [0] * 256
    for b in data:
        counts[b] += 1
    freqs = _normalize(counts, TOT_O0)
    cum = _cumulative(freqs)

    table = bytearray()
    _write_alphabet(table, [1 if freqs[j] else 0 for j in range(256)])
    for j in range(256):
        if freqs[j]:
            write_uint7(table, freqs[j])

    n = len(data)
    rev = bytearray()
    states = [RANS_L] * nx
    tail = n % nx
    for k in range(tail - 1, -1, -1):
        c = data[n - tail + k]
        states[k] = _enc_put(states[k], rev, freqs[c], cum[c], TF_SHIFT_O0)
    for i in range(n - tail - 1, -1, -1):
        c = data[i]
        k = i % nx
        states[k] = _enc_put(states[k], rev, freqs[c], cum[c], TF_SHIFT_O0)
    for k in range(nx - 1, -1, -1):
        _enc_flush(states[k], rev)
    rev.reverse()
    return bytes(table) + bytes(rev)


def _rans_decode_o0(data, pos: int, out_size: int, nx: int = 4) -> bytes:
    syms, pos = _read_alphabet(data, pos)
    freqs = [0] * 256
    for j in syms:
        freqs[j], pos = read_uint7(data, pos)
    cum, sym_of = _sym_lookup(freqs, TOT_O0)
    states = list(struct.unpack_from("<%dI" % nx, data, pos))
    pos += 4 * nx
    out = bytearray(out_size)
    mask = TOT_O0 - 1
    main = out_size - out_size % nx
    i = 0
    while i < main:
        for k in range(nx):
            x = states[k]
            m = x & mask
            s = sym_of[m]
            out[i + k] = s
            x = freqs[s] * (x >> TF_SHIFT_O0) + m - cum[s]
            while x < RANS_L:
                x = (x << 16) | data[pos] | (data[pos + 1] << 8)
                pos += 2
            states[k] = x
        i += nx
    for k in range(out_size % nx):
        out[main + k] = sym_of[states[k] & mask]
    return bytes(out)


def _write_o1_freqs(out: bytearray, alphabet, freqs_ctx) -> None:
    """Per context (outer alphabet order): one frequency per alphabet
    symbol, zero runs shortened (0 followed by extra-zero count)."""
    for ctx in alphabet:
        freqs = freqs_ctx[ctx]
        if freqs is None:
            # context never occurs: all-zero row, maximally shortened
            row = [0] * len(alphabet)
        else:
            row = [freqs[j] for j in alphabet]
        i = 0
        while i < len(row):
            f = row[i]
            write_uint7(out, f)
            if f == 0:
                run = 0
                while i + 1 + run < len(row) and row[i + 1 + run] == 0 and run < 255:
                    run += 1
                out.append(run)
                i += run
            i += 1


def _read_o1_freqs(data, pos: int, alphabet):
    freqs_ctx = [None] * 256
    for ctx in alphabet:
        row = [0] * 256
        i = 0
        while i < len(alphabet):
            f, pos = read_uint7(data, pos)
            row[alphabet[i]] = f
            if f == 0:
                run = data[pos]
                pos += 1
                i += run
            i += 1
        freqs_ctx[ctx] = row
    return freqs_ctx, pos


def _rans_encode_o1(data, nx: int = 4) -> bytes:
    n = len(data)
    q = n // nx
    counts = [None] * 256

    def bump(ctx, sym):
        row = counts[ctx]
        if row is None:
            row = counts[ctx] = [0] * 256
        row[sym] += 1

    starts = tuple(k * q for k in range(nx))
    ends = tuple((k + 1) * q for k in range(nx - 1)) + (n,)
    for k in range(nx):
        bump(0, data[starts[k]])
        for i in range(starts[k] + 1, ends[k]):
            bump(data[i - 1], data[i])

    freqs_ctx = [None] * 256
    cums_ctx = [None] * 256
    alpha_present = [0] * 256
    for ctx in range(256):
        if counts[ctx] is None:
            continue
        alpha_present[ctx] = 1
        for j in range(256):
            if counts[ctx][j]:
                alpha_present[j] = 1
    for ctx in range(256):
        if counts[ctx] is None:
            continue
        freqs_ctx[ctx] = _normalize(counts[ctx], TOT_O1)
        cums_ctx[ctx] = _cumulative(freqs_ctx[ctx])

    alphabet = [j for j in range(256) if alpha_present[j]]
    raw_table = bytearray()
    _write_alphabet(raw_table, alpha_present)
    _write_o1_freqs(raw_table, alphabet, freqs_ctx)

    # large order-1 tables may themselves compress well: leading byte 1
    # + uint7 raw size + uint7 COMPRESSED size + order-0 stream (the
    # htslib/spec layout stores both sizes), else leading byte 0 + raw
    packed = _rans_encode_o0(bytes(raw_table)) if len(raw_table) >= 32 else None
    table = bytearray()
    if packed is not None and len(packed) + 6 < len(raw_table):
        table.append(1)
        write_uint7(table, len(raw_table))
        write_uint7(table, len(packed))
        table += packed
    else:
        table.append(0)
        table += raw_table

    rev = bytearray()
    states = [RANS_L] * nx
    last_tail = data[n - 1]
    for i in range(n - 2, nx * q - 2, -1):
        ctx = data[i]
        states[nx - 1] = _enc_put(
            states[nx - 1], rev, freqs_ctx[ctx][last_tail],
            cums_ctx[ctx][last_tail], TF_SHIFT_O1
        )
        last_tail = ctx
    lasts = [data[(k + 1) * q - 1] for k in range(nx - 1)] + [last_tail]
    for i in range(q - 2, -1, -1):
        for k in range(nx - 1, -1, -1):
            ctx = data[starts[k] + i]
            sym = lasts[k]
            states[k] = _enc_put(
                states[k], rev, freqs_ctx[ctx][sym], cums_ctx[ctx][sym], TF_SHIFT_O1
            )
            lasts[k] = ctx
    for k in range(nx - 1, -1, -1):
        sym = lasts[k]
        states[k] = _enc_put(
            states[k], rev, freqs_ctx[0][sym], cums_ctx[0][sym], TF_SHIFT_O1
        )
    for k in range(nx - 1, -1, -1):
        _enc_flush(states[k], rev)
    rev.reverse()
    return bytes(table) + bytes(rev)


def _rans_decode_o1(data, pos: int, out_size: int, nx: int = 4) -> bytes:
    comp = data[pos]
    pos += 1
    if comp == 1:
        raw_size, pos = read_uint7(data, pos)
        comp_size, pos = read_uint7(data, pos)
        table = _rans_decode_o0(data, pos, raw_size)
        pos += comp_size
        tpos = 0
        src = table
    else:
        src = data
        tpos = pos
    alphabet, tpos = _read_alphabet(src, tpos)
    freqs_ctx, tpos = _read_o1_freqs(src, tpos, alphabet)
    if comp != 1:
        pos = tpos
    cums_ctx = [None] * 256
    syms_ctx = [None] * 256
    for ctx in range(256):
        if freqs_ctx[ctx] is not None:
            cums_ctx[ctx], syms_ctx[ctx] = _sym_lookup(freqs_ctx[ctx], TOT_O1)

    states = list(struct.unpack_from("<%dI" % nx, data, pos))
    pos += 4 * nx
    out = bytearray(out_size)
    q = out_size // nx
    offs = tuple(k * q for k in range(nx))
    ctxs = [0] * nx
    mask = TOT_O1 - 1
    for i in range(q):
        for k in range(nx):
            ctx = ctxs[k]
            x = states[k]
            m = x & mask
            s = syms_ctx[ctx][m]
            out[offs[k] + i] = s
            x = freqs_ctx[ctx][s] * (x >> TF_SHIFT_O1) + m - cums_ctx[ctx][s]
            while x < RANS_L:
                x = (x << 16) | data[pos] | (data[pos + 1] << 8)
                pos += 2
            states[k] = x
            ctxs[k] = s
    ctx = ctxs[nx - 1]
    x = states[nx - 1]
    for i in range(nx * q, out_size):
        m = x & mask
        s = syms_ctx[ctx][m]
        out[i] = s
        x = freqs_ctx[ctx][s] * (x >> TF_SHIFT_O1) + m - cums_ctx[ctx][s]
        while x < RANS_L:
            x = (x << 16) | data[pos] | (data[pos + 1] << 8)
            pos += 2
        ctx = s
    return bytes(out)


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

def _pack_encode(data):
    """-> (meta, packed, ok). <=16 distinct byte values pack to 0/1/2/4
    bits per value."""
    values = sorted(set(data))
    if len(values) > 16:
        return None, None, False
    meta = bytearray([len(values)])
    meta += bytes(values)
    index = {v: i for i, v in enumerate(values)}
    n = len(data)
    if len(values) <= 1:
        packed = b""
    elif len(values) == 2:
        packed = bytearray((n + 7) // 8)
        for i, b in enumerate(data):
            packed[i >> 3] |= index[b] << (i & 7)
    elif len(values) <= 4:
        packed = bytearray((n + 3) // 4)
        for i, b in enumerate(data):
            packed[i >> 2] |= index[b] << ((i & 3) * 2)
    else:
        packed = bytearray((n + 1) // 2)
        for i, b in enumerate(data):
            packed[i >> 1] |= index[b] << ((i & 1) * 4)
    write_uint7(meta, len(packed))
    return bytes(meta), bytes(packed), True


def _pack_decode(meta_stream, pos, packed, out_size):
    nsym = meta_stream[pos]
    pos += 1
    values = meta_stream[pos:pos + nsym]
    pos += nsym
    packed_len, pos = read_uint7(meta_stream, pos)
    out = bytearray(out_size)
    if nsym <= 1:
        if nsym == 1:
            out[:] = bytes([values[0]]) * out_size
        return bytes(out), pos, packed_len
    if nsym == 2:
        for i in range(out_size):
            out[i] = values[(packed[i >> 3] >> (i & 7)) & 1]
    elif nsym <= 4:
        for i in range(out_size):
            out[i] = values[(packed[i >> 2] >> ((i & 3) * 2)) & 3]
    else:
        for i in range(out_size):
            out[i] = values[(packed[i >> 1] >> ((i & 1) * 4)) & 15]
    return bytes(out), pos, packed_len


def _rle_encode(data):
    """-> (meta, literals). Symbols worth run-encoding carry their run
    lengths (uint7) in the meta stream, in literal order."""
    n = len(data)
    # per-symbol savings: each run of length L collapses to 1 literal +
    # ~1 meta byte, saving L-2 bytes
    savings = [0] * 256
    i = 0
    while i < n:
        j = i + 1
        while j < n and data[j] == data[i]:
            j += 1
        savings[data[i]] += (j - i) - 2
        i = j
    rle_syms = [s for s in range(256) if savings[s] > 0]
    if not rle_syms:
        return None, None
    flagged = [False] * 256
    for s in rle_syms:
        flagged[s] = True
    meta = bytearray([len(rle_syms) & 0xFF])  # 0 means 256
    meta += bytes(rle_syms)
    lits = bytearray()
    runs = bytearray()
    i = 0
    while i < n:
        b = data[i]
        j = i + 1
        while j < n and data[j] == b:
            j += 1
        if flagged[b]:
            lits.append(b)
            write_uint7(runs, j - i - 1)
        else:
            lits += data[i:j]
        i = j
    meta += runs
    return bytes(meta), bytes(lits)


def _rle_decode(meta, lits, out_size):
    pos = 0
    nsym = meta[pos]
    pos += 1
    if nsym == 0:
        nsym = 256
    flagged = [False] * 256
    for s in meta[pos:pos + nsym]:
        flagged[s] = True
    pos += nsym
    out = bytearray()
    for b in lits:
        if flagged[b]:
            run, pos = read_uint7(meta, pos)
            out += bytes([b]) * (run + 1)
        else:
            out.append(b)
    if len(out) != out_size:
        raise ValueError(
            f"rANS Nx16 RLE expanded to {len(out)} bytes, expected {out_size}"
        )
    return bytes(out)


# ---------------------------------------------------------------------------
# Public surface
# ---------------------------------------------------------------------------

def compress(data: bytes, order: int = 0, *, use_rle: bool = False,
             use_pack: bool = False, stripe: int = 0,
             x32: bool = False) -> bytes:
    """rANS Nx16 stream. ``stripe`` > 0 splits into that many
    byte-interleaved sub-streams (good for fixed-width integer series);
    ``x32`` runs the entropy stage with 32 interleaved states (htslib's
    SIMD layout — bigger state header, useful for large blocks)."""
    if len(data) == 0:
        raise ValueError("rANS Nx16 cannot encode an empty stream")
    if order not in (0, 1):
        raise ValueError(f"unsupported rANS Nx16 order {order}")
    out = bytearray()
    if stripe > 1 and len(data) < stripe:
        stripe = 0  # every sub-stream must be non-empty
    if stripe > 1:
        out.append(F_STRIPE)
        write_uint7(out, len(data))
        out.append(stripe)
        subs = [
            compress(data[j::stripe], order, use_rle=use_rle,
                     use_pack=use_pack, x32=x32)
            for j in range(stripe)
        ]
        # sub-streams drop their redundant size (NOSZ)
        subs = [bytes([s[0] | F_NOSZ]) + _strip_size(s) for s in subs]
        for s in subs:
            write_uint7(out, len(s))
        for s in subs:
            out += s
        return bytes(out)

    flags = F_ORDER1 if (order == 1 and len(data) >= 4) else 0
    payload = data
    pack_meta = rle_meta = None
    if use_pack:
        pack_meta, packed, ok = _pack_encode(payload)
        if ok:
            flags |= F_PACK
            payload = packed
    if use_rle and len(payload) >= 4:
        meta, lits = _rle_encode(payload)
        if meta is not None:
            flags |= F_RLE
            rle_meta, payload = meta, lits
    if len(payload) < 4:
        flags = (flags & ~F_ORDER1) | F_CAT

    # 32-way entropy stage: worth its 128-byte state header only on
    # payloads comfortably larger than it; nested meta streams stay 4-way
    nx = 32 if (x32 and not (flags & F_CAT) and len(payload) >= 32) else 4
    if nx == 32:
        flags |= F_X32

    out.append(flags)
    write_uint7(out, len(data))
    if flags & F_PACK:
        out += pack_meta
    if flags & F_RLE:
        comp_meta = _rans_encode_o0(rle_meta) if len(rle_meta) >= 4 else None
        if comp_meta is not None and len(comp_meta) < len(rle_meta):
            write_uint7(out, len(rle_meta) << 1)
            write_uint7(out, len(payload))
            write_uint7(out, len(comp_meta))
            out += comp_meta
        else:
            write_uint7(out, (len(rle_meta) << 1) | 1)
            write_uint7(out, len(payload))
            out += rle_meta
    if flags & F_CAT:
        out += payload
    elif flags & F_ORDER1:
        out += _rans_encode_o1(payload, nx)
    else:
        out += _rans_encode_o0(payload, nx)
    return bytes(out)


def _strip_size(stream: bytes) -> bytes:
    """Drop the uint7 raw size after the flags byte (NOSZ rewrite)."""
    pos = 1
    while stream[pos] & 0x80:
        pos += 1
    pos += 1
    return stream[pos:]


def decompress(data: bytes, out_size: int = None) -> bytes:
    """Decode one rANS Nx16 stream. ``out_size`` is required for NOSZ
    streams (stripe sub-streams)."""
    if not data:
        raise ValueError("empty rANS Nx16 stream")
    flags = data[0]
    pos = 1
    nx = 32 if flags & F_X32 else 4
    if flags & F_NOSZ:
        if out_size is None:
            raise ValueError("NOSZ rANS Nx16 stream needs an explicit size")
        raw_size = out_size
    else:
        raw_size, pos = read_uint7(data, pos)
    if raw_size == 0:
        return b""

    try:  # native decoder (clair_rans4x16.cpp): same grammar, C speed
        from clair_tpu_torch import native

        out = native.rans4x16_decompress(bytes(data), raw_size)
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

    rle_meta = None
    if flags & F_RLE:
        meta_word, pos = read_uint7(data, pos)
        meta_len = meta_word >> 1
        lit_len, pos = read_uint7(data, pos)
        if meta_word & 1:
            rle_meta = data[pos:pos + meta_len]
            pos += meta_len
        else:
            comp_len, pos = read_uint7(data, pos)
            rle_meta = _rans_decode_o0(data, pos, meta_len)
            pos += comp_len
        entropy_size = lit_len
    else:
        entropy_size = payload_size

    if flags & F_CAT:
        body = data[pos:pos + entropy_size]
        if len(body) != entropy_size:
            raise ValueError(
                f"rANS Nx16 CAT stream truncated: {len(body)} of "
                f"{entropy_size} bytes present"
            )
    elif flags & F_ORDER1:
        body = _rans_decode_o1(data, pos, entropy_size, nx)
    else:
        body = _rans_decode_o0(data, pos, entropy_size, nx)

    if flags & F_RLE:
        body = _rle_decode(rle_meta, body, payload_size)
    if flags & F_PACK:
        body, _, _ = _pack_decode(data, pack_meta_pos, body, raw_size)
    return body
