"""Checkpoint save/restore (port of clair_tpu/models/checkpoint.py).

The same file format: the ``CLTPUCKPT1`` magic, then one zstd frame (level
3, content size in the header) over a protocol-4 pickle of ``{"params":
<nested dict of numpy arrays>, "extra": {...}}``. Nested dicts are pickled
with sorted keys, as the JAX package's tree map writes them, so the pickled
payload is the same byte for byte and either package reads what the other
wrote. Torch tensors are saved as numpy arrays.

zstd comes from the system's libzstd through ctypes (``io/zstd.py``): the
Python binding the JAX package uses is not installed everywhere the port
runs.
"""

from __future__ import annotations

import io
import os
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from clair_tpu_torch.io import zstd

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
    blob = zstd.compress(buf.getvalue(), _ZSTD_LEVEL)
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
        payload = pickle.loads(zstd.decompress(fh.read()))
    return payload["params"], payload.get("extra", {})
