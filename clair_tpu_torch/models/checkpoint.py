"""Checkpoint save/restore (port of clair_tpu/models/checkpoint.py).

The same file format: the ``CLTPUCKPT1`` magic, then one zstd frame (level
3, content size in the header) over a protocol-4 pickle of ``{"params":
<nested dict of numpy arrays>, "extra": {...}}``. Nested dicts are pickled
with sorted keys, as the JAX package's tree map writes them, so the pickled
payload is the same byte for byte and either package reads what the other
wrote. Torch tensors are saved as numpy arrays.

zstd comes from the system's libzstd through ctypes: the Python binding
the JAX package uses is not installed everywhere the port runs.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import io
import os
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

EPOCH_DIGITS = 6  # the reference's prefix-%06d checkpoint naming
_MAGIC = b"CLTPUCKPT1"


def checkpoint_path(prefix: str, epoch: int) -> str:
    return f"{prefix}-{epoch:0{EPOCH_DIGITS}d}"


def epoch_from_path(path: str) -> int:
    match = re.search(r"(\d{%d})$" % EPOCH_DIGITS, path)
    if not match:
        raise ValueError(f"checkpoint path {path!r} has no trailing epoch number")
    return int(match.group(1))


_ZSTD_LEVEL = 3
_ZSTD_CONTENTSIZE_UNKNOWN = 2**64 - 1
_ZSTD_CONTENTSIZE_ERROR = 2**64 - 2


@functools.lru_cache(maxsize=1)
def _libzstd() -> ctypes.CDLL:
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise OSError("libzstd not found: checkpoints are zstd-compressed")
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


def _zstd_checked(lib, code: int) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def _zstd_compress(data: bytes) -> bytes:
    lib = _libzstd()
    dst = ctypes.create_string_buffer(lib.ZSTD_compressBound(len(data)))
    n = _zstd_checked(lib, lib.ZSTD_compress(dst, len(dst), data, len(data), _ZSTD_LEVEL))
    return dst.raw[:n]


def _zstd_decompress(frame: bytes) -> bytes:
    lib = _libzstd()
    size = lib.ZSTD_getFrameContentSize(frame, len(frame))
    if size in (_ZSTD_CONTENTSIZE_UNKNOWN, _ZSTD_CONTENTSIZE_ERROR):
        raise ValueError("zstd frame without a content size in its header")
    dst = ctypes.create_string_buffer(size)
    n = _zstd_checked(lib, lib.ZSTD_decompress(dst, size, frame, len(frame)))
    if n != size:
        raise ValueError(f"zstd frame decompressed to {n} bytes, header says {size}")
    return dst.raw


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(tree[k]) for k in sorted(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, params: Dict, extra: Optional[Dict[str, Any]] = None) -> None:
    payload = {"params": _to_numpy(params), "extra": extra or {}}
    buf = io.BytesIO()
    pickle.dump(payload, buf, protocol=4)
    blob = _zstd_compress(buf.getvalue())
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(_MAGIC)
        fh.write(blob)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[Dict, Dict[str, Any]]:
    """(params as a nested dict of numpy arrays, extra). Unpickles: load
    only checkpoints this program or the JAX package wrote."""
    with open(path, "rb") as fh:
        if fh.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path} is not a clair_tpu checkpoint")
        payload = pickle.loads(_zstd_decompress(fh.read()))
    return payload["params"], payload.get("extra", {})
