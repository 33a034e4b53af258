"""Build and load the port's CUDA kernels.

Each ``clair_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, on the machine with the card, into ``build/clair_tpu_torch/``
beside the package in a checkout, or the package's own ``_build/`` where it
is installed (``build_root.py``); the library's file name carries a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads the
library already built. A failed build raises with the compiler's output.
``launch`` calls a kernel's C entry point on a tensor's current stream and
raises on the CUDA error it returns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

from clair_tpu_torch.build_root import build_root

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = build_root()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# ptxas reports each kernel's registers, shared memory and spills
_REPORT_FLAGS = ("-Xptxas", "-v")

# compiler report (stderr) of each library built by this process
BUILD_REPORTS: Dict[str, str] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}
# each C entry point with its argument types set, by (library, symbol)
_ENTRIES: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels build only where the toolkit is"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives once built."""
    digest = hashlib.sha256()
    for source in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same sources
    exists; returns the library's path."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *_REPORT_FLAGS,
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    BUILD_REPORTS[name] = proc.stderr
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib


def on_cuda(x: torch.Tensor, name: str) -> bool:
    """The wrappers' device rule: False for a CPU tensor (the plain
    version), True for a CUDA tensor (the kernel); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {x.device}")
    return True


def entry(name: str, symbol: str, argtypes: Sequence):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, returning an int,
    with ``argtypes`` and then the stream as its argument types. Every
    pointer and the stream go as ``ctypes.c_void_p`` (a default int argument
    would cut a 64-bit pointer to 32 bits)."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        _ENTRIES[(name, symbol)] = fn
    return fn


def launch(name: str, symbol: str, argtypes: Sequence, device: torch.device, *args) -> None:
    """Call ``entry(name, symbol, argtypes)`` with ``args`` and then the
    current stream of ``device``; raise if it returns a CUDA error."""
    fn = entry(name, symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} ({symbol}) launch failed: CUDA error {err}")
