"""zstd frames through the system libzstd (ctypes).

The JAX package compresses checkpoints and zstd bin blocks with the
``zstandard`` Python binding, which is not installed everywhere the port
runs. Both write one-shot frames that carry their content size in the
header, and so does ``ZSTD_compress``, so either side reads what the other
wrote. Each call builds its own context inside libzstd, which makes the
functions safe to call from several threads; ctypes releases the
interpreter lock for the call.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


@functools.lru_cache(maxsize=1)
def _libzstd() -> ctypes.CDLL:
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise OSError("libzstd not found: checkpoints and zstd bin blocks need it")
    lib = ctypes.CDLL(name)
    size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
    for fn, restype, argtypes in (
        ("ZSTD_compressBound", size_t, [size_t]),
        ("ZSTD_compress", size_t, [ptr, size_t, ptr, size_t, ctypes.c_int]),
        ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [ptr, size_t]),
        ("ZSTD_decompress", size_t, [ptr, size_t, ptr, size_t]),
        ("ZSTD_isError", ctypes.c_uint, [size_t]),
        ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
    ):
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def _checked(lib, code: int) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def compress(data: bytes, level: int) -> bytes:
    """One zstd frame of ``data``, with its content size in the header."""
    lib = _libzstd()
    dst = ctypes.create_string_buffer(lib.ZSTD_compressBound(len(data)))
    n = _checked(lib, lib.ZSTD_compress(dst, len(dst), data, len(data), level))
    return dst.raw[:n]


def decompress(frame: bytes) -> bytes:
    """The content of one zstd frame that records its size."""
    lib = _libzstd()
    size = lib.ZSTD_getFrameContentSize(frame, len(frame))
    if size in (_CONTENTSIZE_UNKNOWN, _CONTENTSIZE_ERROR):
        raise ValueError("zstd frame without a content size in its header")
    dst = ctypes.create_string_buffer(size)
    n = _checked(lib, lib.ZSTD_decompress(dst, size, frame, len(frame)))
    if n != size:
        raise ValueError(f"zstd frame decompressed to {n} bytes, header says {size}")
    return dst.raw
