"""rANS 4x8 codec (CRAM 3.0 block compression method 4).

The reference delegates all CRAM handling to samtools/htslib (every BAM it
opens could equally be a CRAM: reference clair/callVarBam.py:122-181
passes the path straight to `samtools view`). This framework carries its
own alignment IO stack, so CRAM support needs the rANS static 4x8 entropy
codec that htslib compresses most CRAM data blocks with.

Implements the hts-specs "rANS codec" (CRAM 3.0, rans4x8 variant):

- 12-bit frequencies (TOTFREQ 4096), byte-wise renormalisation,
  lower bound 1<<23 (the ryg_rans "RansByte" construction).
- FOUR interleaved rANS states. Order-0: states round-robin over output
  positions i%4. Order-1 (context = previous byte): the output is split
  into four quarters, one state per quarter, the last quarter absorbing
  the remainder; each quarter's first byte uses context 0.
- Frequency tables: symbols ascending with the consecutive-run RLE scheme
  (a run-length byte follows a symbol whose predecessor is also present),
  frequencies in 1-2 bytes (values >= 128 get a high-bit-flagged 2-byte
  form), zero terminator. Order-1 nests the same scheme per context.
- 9-byte header: order byte, u32le compressed size (of everything after
  the header), u32le raw size.

This module is the reference implementation (pure Python, both
directions); `decompress` transparently dispatches to the native decoder
in native/clair_rans.cpp when the library builds (~67-165 MB/s vs ~2 MB/s
here), which puts CRAM read throughput within ~10% of the BAM reader.
Encoding stays Python-only: it runs once per written test/convert file,
never in the calling hot path.
"""

from __future__ import annotations

import struct

TOTFREQ = 4096
TF_SHIFT = 12
RANS_BYTE_L = 1 << 23


# ---------------------------------------------------------------------------
# Frequency tables
# ---------------------------------------------------------------------------

def _normalize_freqs(counts, total=TOTFREQ):
    """Scale a 256-entry count list so present symbols keep freq >= 1 and
    the sum is exactly `total`."""
    n = sum(counts)
    if n == 0:
        raise ValueError("cannot build a frequency table for empty input")
    freqs = [0] * 256
    present = [j for j in range(256) if counts[j]]
    assigned = 0
    for j in present:
        f = counts[j] * total // n
        freqs[j] = f if f > 0 else 1
        assigned += freqs[j]
    # push the drift onto the most frequent symbol (stays >= 1: its share
    # of `total` dominates the at-most-len(present) correction)
    top = max(present, key=lambda j: counts[j])
    freqs[top] += total - assigned
    if freqs[top] <= 0:  # degenerate many-symbol tiny inputs
        freqs = [0] * 256
        base = total // len(present)
        for j in present:
            freqs[j] = base
        freqs[present[0]] += total - base * len(present)
    return freqs


def _write_freq_syms(out: bytearray, freqs, write_entry) -> None:
    """Symbol walk shared by order-0 tables and order-1 outer contexts:
    ascending symbols, run-length byte after a symbol whose predecessor is
    also present (htslib rANS_static.c table layout)."""
    rle = 0
    for j in range(256):
        if not freqs[j]:
            continue
        if rle:
            rle -= 1
        else:
            out.append(j)
            if j and freqs[j - 1]:
                run = j + 1
                while run < 256 and freqs[run]:
                    run += 1
                rle = run - (j + 1)
                out.append(rle)
        write_entry(j)
    out.append(0)


def _write_freq_table(out: bytearray, freqs) -> None:
    def entry(j):
        f = freqs[j]
        if f >= 128:
            out.append(0x80 | (f >> 8))
            out.append(f & 0xFF)
        else:
            out.append(f)

    _write_freq_syms(out, freqs, entry)


class _FreqReader:
    def __init__(self, data, pos: int):
        self.data = data
        self.pos = pos

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def peek(self) -> int:
        return self.data[self.pos]

    def freq(self) -> int:
        f = self.byte()
        if f >= 128:
            f = ((f & 0x7F) << 8) | self.byte()
        return f

    def symbols(self):
        """Yield the symbol sequence of one table (caller reads each
        symbol's payload between yields)."""
        rle = 0
        j = self.byte()
        while True:
            yield j
            if not rle and self.pos < len(self.data) and self.peek() == j + 1:
                j = self.byte()
                rle = self.byte()
            elif rle:
                rle -= 1
                j += 1
            else:
                j = self.byte()
                if j == 0:
                    return


def _read_freq_table(reader: _FreqReader):
    """-> (freqs[256], cumulative[256], sym_of[4096])."""
    freqs = [0] * 256
    for j in reader.symbols():
        freqs[j] = reader.freq()
    cum = [0] * 256
    sym_of = bytearray(TOTFREQ)
    x = 0
    for j in range(256):
        if freqs[j]:
            cum[j] = x
            end = x + freqs[j]
            if end > TOTFREQ:
                raise ValueError("rANS frequency table overflows 4096")
            for k in range(x, end):
                sym_of[k] = j
            x = end
    return freqs, cum, sym_of


# ---------------------------------------------------------------------------
# Core state ops (ryg_rans byte-wise)
# ---------------------------------------------------------------------------

def _enc_put(x: int, rev: bytearray, freq: int, cum: int) -> int:
    x_max = freq << 19  # ((L >> 12) << 8) * freq
    while x >= x_max:
        rev.append(x & 0xFF)
        x >>= 8
    return ((x // freq) << TF_SHIFT) + (x % freq) + cum


def _enc_flush(x: int, rev: bytearray) -> None:
    # stream order is little-endian u32; we emit reversed
    rev.append((x >> 24) & 0xFF)
    rev.append((x >> 16) & 0xFF)
    rev.append((x >> 8) & 0xFF)
    rev.append(x & 0xFF)


# ---------------------------------------------------------------------------
# Order 0
# ---------------------------------------------------------------------------

def _compress_o0(data) -> bytes:
    n = len(data)
    counts = [0] * 256
    for b in data:
        counts[b] += 1
    freqs = _normalize_freqs(counts)
    cum = [0] * 256
    x = 0
    for j in range(256):
        cum[j] = x
        x += freqs[j]

    table = bytearray()
    _write_freq_table(table, freqs)

    rev = bytearray()
    states = [RANS_BYTE_L] * 4
    tail = n & 3
    # tail symbols go to states 0..tail-1, encoded first (decoded last)
    for k in range(tail - 1, -1, -1):
        c = data[n - tail + k]
        states[k] = _enc_put(states[k], rev, freqs[c], cum[c])
    for i in range(n - tail - 1, -1, -1):
        c = data[i]
        k = i & 3
        states[k] = _enc_put(states[k], rev, freqs[c], cum[c])
    for k in (3, 2, 1, 0):
        _enc_flush(states[k], rev)
    rev.reverse()
    return bytes(table) + bytes(rev)


def _decompress_o0(data, pos: int, out_size: int) -> bytes:
    reader = _FreqReader(data, pos)
    freqs, cum, sym_of = _read_freq_table(reader)
    p = reader.pos
    (x0, x1, x2, x3) = struct.unpack_from("<IIII", data, p)
    p += 16
    states = [x0, x1, x2, x3]
    out = bytearray(out_size)
    main = out_size & ~3
    L = RANS_BYTE_L
    i = 0
    while i < main:
        for k in range(4):
            x = states[k]
            m = x & 0xFFF
            s = sym_of[m]
            out[i + k] = s
            x = freqs[s] * (x >> TF_SHIFT) + m - cum[s]
            while x < L:
                x = (x << 8) | data[p]
                p += 1
            states[k] = x
        i += 4
    for k in range(out_size & 3):
        out[main + k] = sym_of[states[k] & 0xFFF]
    return bytes(out)


# ---------------------------------------------------------------------------
# Order 1
# ---------------------------------------------------------------------------

def _compress_o1(data) -> bytes:
    n = len(data)
    q = n >> 2
    # context stats: transitions within each quarter; each quarter's first
    # byte is coded with context 0
    counts = [None] * 256

    def bump(ctx, sym):
        row = counts[ctx]
        if row is None:
            row = counts[ctx] = [0] * 256
        row[sym] += 1

    starts = (0, q, 2 * q, 3 * q)
    ends = (q, 2 * q, 3 * q, n)
    for k in range(4):
        bump(0, data[starts[k]])
        for i in range(starts[k] + 1, ends[k]):
            bump(data[i - 1], data[i])

    freqs = [None] * 256
    cums = [None] * 256
    for ctx in range(256):
        if counts[ctx] is None:
            continue
        f = _normalize_freqs(counts[ctx])
        c = [0] * 256
        x = 0
        for j in range(256):
            c[j] = x
            x += f[j]
        freqs[ctx] = f
        cums[ctx] = c

    # nested tables: outer walk over contexts, inner table per context
    table = bytearray()
    present = [1 if freqs[ctx] is not None else 0 for ctx in range(256)]

    def entry(ctx):
        _write_freq_table(table, freqs[ctx])

    _write_freq_syms(table, present, entry)

    rev = bytearray()
    states = [RANS_BYTE_L] * 4
    # remainder of quarter 3 first (decoded last): positions n-1 .. 4q
    last3 = data[n - 1]
    for i in range(n - 2, 4 * q - 2, -1):
        ctx = data[i]
        states[3] = _enc_put(states[3], rev, freqs[ctx][last3], cums[ctx][last3])
        last3 = ctx
    lasts = [data[q - 1], data[2 * q - 1], data[3 * q - 1], last3]
    for i in range(q - 2, -1, -1):
        for k in (3, 2, 1, 0):
            ctx = data[starts[k] + i]
            sym = lasts[k]
            states[k] = _enc_put(states[k], rev, freqs[ctx][sym], cums[ctx][sym])
            lasts[k] = ctx
    for k in (3, 2, 1, 0):  # each quarter's first byte, context 0
        sym = lasts[k]
        states[k] = _enc_put(states[k], rev, freqs[0][sym], cums[0][sym])
    for k in (3, 2, 1, 0):
        _enc_flush(states[k], rev)
    rev.reverse()
    return bytes(table) + bytes(rev)


def _decompress_o1(data, pos: int, out_size: int) -> bytes:
    reader = _FreqReader(data, pos)
    freqs = [None] * 256
    cums = [None] * 256
    syms = [None] * 256
    for ctx in reader.symbols():
        freqs[ctx], cums[ctx], syms[ctx] = _read_freq_table(reader)
    p = reader.pos
    (x0, x1, x2, x3) = struct.unpack_from("<IIII", data, p)
    p += 16
    states = [x0, x1, x2, x3]
    out = bytearray(out_size)
    q = out_size >> 2
    offs = (0, q, 2 * q, 3 * q)
    ctxs = [0, 0, 0, 0]
    L = RANS_BYTE_L
    for i in range(q):
        for k in range(4):
            ctx = ctxs[k]
            x = states[k]
            m = x & 0xFFF
            s = syms[ctx][m]
            out[offs[k] + i] = s
            x = freqs[ctx][s] * (x >> TF_SHIFT) + m - cums[ctx][s]
            while x < L:
                x = (x << 8) | data[p]
                p += 1
            states[k] = x
            ctxs[k] = s
    ctx = ctxs[3]
    x = states[3]
    for i in range(4 * q, out_size):  # quarter 3 absorbs the remainder
        m = x & 0xFFF
        s = syms[ctx][m]
        out[i] = s
        x = freqs[ctx][s] * (x >> TF_SHIFT) + m - cums[ctx][s]
        while x < L:
            x = (x << 8) | data[p]
            p += 1
        ctx = s
    return bytes(out)


# ---------------------------------------------------------------------------
# Public surface
# ---------------------------------------------------------------------------

def compress(data: bytes, order: int = 0) -> bytes:
    """rANS 4x8 with the 9-byte CRAM header. Order 1 needs >= 4 bytes of
    input (htslib's encoder has the same floor) and falls back to order 0
    below it."""
    if len(data) == 0:
        raise ValueError("rANS cannot encode an empty stream")
    if order not in (0, 1):
        raise ValueError(f"unsupported rANS order {order}")
    if order == 1 and len(data) >= 4:
        body = _compress_o1(data)
        order_byte = 1
    else:
        body = _compress_o0(data)
        order_byte = 0
    return (
        bytes([order_byte])
        + struct.pack("<I", len(body))
        + struct.pack("<I", len(data))
        + body
    )


def decompress(data: bytes) -> bytes:
    if len(data) < 9:
        raise ValueError("rANS stream shorter than its 9-byte header")
    order = data[0]
    comp_size, raw_size = struct.unpack_from("<II", data, 1)
    if 9 + comp_size > len(data):
        raise ValueError("rANS stream truncated")
    if raw_size == 0:
        return b""
    try:  # native decoder (clair_rans.cpp): same format, C speed
        from clair_tpu_torch import native

        out = native.rans_decompress(bytes(data), raw_size)
        if out is not None:
            return out
    except Exception:
        pass
    if order == 0:
        return _decompress_o0(data, 9, raw_size)
    if order == 1:
        return _decompress_o1(data, 9, raw_size)
    raise ValueError(f"unsupported rANS order {order}")
