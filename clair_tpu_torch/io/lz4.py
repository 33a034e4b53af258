"""LZ4 block codec over the system liblz4, with a pure-Python fallback.

The reference compresses training blocks with blosc's lz4hc-9 + byte
shuffle (reference clair/utils.py:47-48); blosc is not available in
this image, but liblz4 itself ships with every mainstream distro. This
module binds the two block-format entry points the bin codec needs
(`LZ4_compress_HC`, `LZ4_decompress_safe`) via ctypes — no build step —
and keeps a pure-Python block decoder so bins stay readable on hosts
without the shared library (write-side falls back to zstd there, see
data/bins.py).

LZ4 *block* format only (no frame header/checksums): the caller stores
the raw length, which data/bins.py's block framing does.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Union

import numpy as np

_lib = None
_lib_checked = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    for name in ("liblz4.so.1", "liblz4.so", "liblz4.dylib",
                 ctypes.util.find_library("lz4")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        try:
            lib.LZ4_compress_HC.restype = ctypes.c_int
            lib.LZ4_compress_HC.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
            ]
            lib.LZ4_decompress_safe.restype = ctypes.c_int
            lib.LZ4_decompress_safe.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ]
            lib.LZ4_compressBound.restype = ctypes.c_int
            lib.LZ4_compressBound.argtypes = [ctypes.c_int]
        except AttributeError:
            continue
        _lib = lib
        return _lib
    return None


def available() -> bool:
    """True when the native liblz4 is loadable (fast compress+decompress)."""
    return _load() is not None


def compress_hc(data: Union[bytes, memoryview], level: int = 9) -> bytes:
    """LZ4-HC block compression (level 9 = the reference's lz4hc-9).

    Requires the native library; callers that may run without it should
    check available() and choose another codec for writing."""
    lib = _load()
    if lib is None:
        raise RuntimeError("liblz4 not available for compression")
    data = bytes(data)
    bound = lib.LZ4_compressBound(len(data))
    if bound <= 0:
        raise ValueError("input too large for LZ4 block")
    dst = np.empty(bound, np.uint8)
    n = lib.LZ4_compress_HC(
        data, dst.ctypes.data_as(ctypes.c_void_p), len(data), bound, level
    )
    if n <= 0:
        raise ValueError("LZ4_compress_HC failed")
    return dst[:n].tobytes()


def decompress(comp: Union[bytes, memoryview], out_n: int) -> np.ndarray:
    """Decompress one LZ4 block of known raw size into a uint8 array.

    Returns a writable np.uint8 array (no extra copy on the native path);
    falls back to the pure-Python decoder when liblz4 is missing."""
    lib = _load()
    comp = bytes(comp)
    if lib is None:
        return np.frombuffer(_py_decompress(comp, out_n), np.uint8).copy()
    out = np.empty(out_n, np.uint8)
    n = lib.LZ4_decompress_safe(
        comp, out.ctypes.data_as(ctypes.c_void_p), len(comp), out_n
    )
    if n != out_n:
        raise ValueError(
            f"LZ4 block decode failed (got {n}, expected {out_n})"
        )
    return out


def _py_decompress(src: bytes, out_n: int) -> bytearray:
    """Pure-Python LZ4 block decoder (read fallback; correctness over speed).

    Block grammar: sequences of [token][literal-len*][literals][offset u16le]
    [match-len*], the final sequence carrying literals only."""
    dst = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if lit:
            if i + lit > n:
                raise ValueError("truncated LZ4 literals")
            dst += src[i:i + lit]
            i += lit
        if i >= n:
            break  # last sequence has no match part
        if i + 2 > n:
            raise ValueError("truncated LZ4 offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(dst):
            raise ValueError("corrupt LZ4 match offset")
        mlen = (token & 15) + 4
        if (token & 15) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(dst) - offset
        if offset >= mlen:
            dst += dst[start:start + mlen]
        else:
            # overlapping match: the copy source grows as we write
            chunk = dst[start:]
            reps, rem = divmod(mlen, offset)
            dst += chunk * reps + chunk[:rem]
    if len(dst) != out_n:
        raise ValueError(
            f"LZ4 raw size mismatch (got {len(dst)}, expected {out_n})"
        )
    return dst
