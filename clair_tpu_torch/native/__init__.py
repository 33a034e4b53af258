"""ctypes binding for the native BAM->events engine (clair_native.cpp).

The library is built on first use (g++ is part of the environment) into
build/clair_tpu_torch/native/ beside the package in a checkout, or into the
package's own _build/native/ where it is installed (build_root.py), under a
name that carries
a hash of the sources and of the host (it is built with -march=native), so
an edited source or another machine rebuilds; all callers fall back to the
pure-Python/numpy path in clair_tpu_torch.data.pileup when the toolchain or
zlib headers are unavailable.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import time
from typing import Optional, Tuple

import numpy as np

from clair_tpu_torch.build_root import build_root as _build_root

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = str(_build_root() / "native")
_lib = None
_build_failed = False
# seconds this process spent building the library (None: it built none),
# and the compiler's output when a build failed
BUILD_SECONDS: Optional[float] = None
BUILD_ERROR: Optional[str] = None
# cached: os.cpu_count() syscalls showed up in the per-batch decode profile
_DEFAULT_DECODE_THREADS = min(os.cpu_count() or 1, 8)


class _EventBuffers(ctypes.Structure):
    _fields_ = [
        ("match_pos", ctypes.POINTER(ctypes.c_int64)),
        ("match_qcol", ctypes.POINTER(ctypes.c_int8)),
        ("match_strand", ctypes.POINTER(ctypes.c_int8)),
        ("n_match", ctypes.c_int64),
        ("ins_pos", ctypes.POINTER(ctypes.c_int64)),
        ("ins_adv", ctypes.POINTER(ctypes.c_int64)),
        ("ins_qcol", ctypes.POINTER(ctypes.c_int8)),
        ("ins_strand", ctypes.POINTER(ctypes.c_int8)),
        ("n_ins", ctypes.c_int64),
        ("del_pos", ctypes.POINTER(ctypes.c_int64)),
        ("del_strand", ctypes.POINTER(ctypes.c_int8)),
        ("n_del", ctypes.c_int64),
        ("ins_op_pos", ctypes.POINTER(ctypes.c_int64)),
        ("n_ins_op", ctypes.c_int64),
        ("del_op_pos", ctypes.POINTER(ctypes.c_int64)),
        ("n_del_op", ctypes.c_int64),
        ("ins_op_len", ctypes.POINTER(ctypes.c_int64)),
        ("del_op_len", ctypes.POINTER(ctypes.c_int64)),
        ("n_reads_used", ctypes.c_int64),
    ]


class _CramSliceOut(ctypes.Structure):
    _fields_ = [
        ("n_records", ctypes.c_int64),
        ("pos", ctypes.POINTER(ctypes.c_int64)),
        ("mapq", ctypes.POINTER(ctypes.c_int32)),
        ("flag", ctypes.POINTER(ctypes.c_int32)),
        ("refid", ctypes.POINTER(ctypes.c_int32)),
        ("seq", ctypes.POINTER(ctypes.c_uint8)),
        ("seq_off", ctypes.POINTER(ctypes.c_int64)),
        ("cig_ops", ctypes.POINTER(ctypes.c_uint8)),
        ("cig_lens", ctypes.POINTER(ctypes.c_int32)),
        ("cig_off", ctypes.POINTER(ctypes.c_int64)),
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("name_off", ctypes.POINTER(ctypes.c_int64)),
        ("qual", ctypes.POINTER(ctypes.c_uint8)),
        ("next_ref", ctypes.POINTER(ctypes.c_int32)),
        ("next_pos", ctypes.POINTER(ctypes.c_int64)),
        ("tlen", ctypes.POINTER(ctypes.c_int64)),
        ("need_lo", ctypes.c_int64),
        ("need_hi", ctypes.c_int64),
        ("holder", ctypes.c_void_p),
    ]


def _host() -> bytes:
    """What a -march=native library depends on: the machine and its CPU."""
    cpu = b""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            cpu = next((line for line in fh if line.startswith(b"model name")), b"")
    except OSError:
        pass
    return " ".join(platform.uname()).encode() + cpu


def _lib_path() -> str:
    """The library built from the current sources and Makefile on this host."""
    digest = hashlib.sha256(_host())
    for name in sorted(os.listdir(_DIR)):
        if name.endswith(".cpp") or name == "Makefile":
            digest.update(name.encode())
            with open(os.path.join(_DIR, name), "rb") as fh:
                digest.update(fh.read())
    return os.path.join(_BUILD_DIR, f"libclair_native-{digest.hexdigest()[:16]}.so")


def _build(path: str, unloadable: bool = False) -> bool:
    """Compile the sources into ``path`` unless another process has (or,
    with ``unloadable``, over the library there that failed to load): under
    an exclusive lock on the build directory (parallel test workers ask at
    once), into a temporary name that os.replace moves into place."""
    global BUILD_SECONDS, BUILD_ERROR
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(os.path.join(_BUILD_DIR, "build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.isfile(path) and not unloadable:
                return True
            started = time.perf_counter()
            proc = subprocess.run(["make", "-B", "-C", _DIR, f"OUT={tmp}"],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                BUILD_ERROR = proc.stdout + proc.stderr
                return False
            os.replace(tmp, path)
            BUILD_SECONDS = time.perf_counter() - started
            return True
    except (OSError, subprocess.SubprocessError) as err:
        BUILD_ERROR = str(err)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    path = _lib_path()
    if not os.path.isfile(path) and not _build(path):
        _build_failed = True
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        # a partial or foreign artifact under this name: rebuild it once
        lib = ctypes.CDLL(path) if _build(path, unloadable=True) else None
    if lib is None:
        _build_failed = True
        return None
    try:
        _bind_symbols(lib)
    except AttributeError:
        _build_failed = True
        return None
    _lib = lib
    return lib


def _bind_symbols(lib) -> None:
    lib.clair_bam_events.restype = ctypes.c_int
    lib.clair_bam_events.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(_EventBuffers),
    ]
    lib.clair_free_events.argtypes = [ctypes.POINTER(_EventBuffers)]
    lib.clair_bam_events_dual.restype = ctypes.c_int
    lib.clair_bam_events_dual.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(_EventBuffers), ctypes.POINTER(_EventBuffers),
    ]
    lib.clair_decode_fast2.restype = ctypes.c_int
    lib.clair_decode_fast2.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.clair_decode_free.argtypes = [
        ctypes.POINTER(ctypes.c_char),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.clair_build_bai.restype = ctypes.c_int
    lib.clair_build_bai.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.clair_bam_scan_window.restype = ctypes.c_int
    lib.clair_bam_scan_window.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(_EventBuffers),
    ]
    lib.clair_region_open2.restype = ctypes.c_void_p
    lib.clair_region_open2.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.clair_region_scan_window.restype = ctypes.c_int
    lib.clair_region_scan_window.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(_EventBuffers),
    ]
    lib.clair_region_events_dual.restype = ctypes.c_int
    lib.clair_region_events_dual.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(_EventBuffers), ctypes.POINTER(_EventBuffers),
    ]
    lib.clair_region_from_packed.restype = ctypes.c_void_p
    lib.clair_region_from_packed.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.clair_region_open.restype = ctypes.c_void_p
    lib.clair_region_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.clair_region_free.argtypes = [ctypes.c_void_p]
    lib.clair_region_n_records.restype = ctypes.c_int64
    lib.clair_region_n_records.argtypes = [ctypes.c_void_p]
    lib.clair_region_counts.restype = ctypes.c_int
    lib.clair_region_counts.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.clair_region_tensors.restype = ctypes.c_int
    lib.clair_region_tensors.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(_EventBuffers),
    ]
    lib.clair_select_candidates.restype = ctypes.c_int64
    lib.clair_select_candidates.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.clair_finalize_windows.restype = ctypes.c_int64
    lib.clair_finalize_windows.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.clair_finalize_windows_u8.restype = ctypes.c_int64
    lib.clair_finalize_windows_u8.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.clair_rans_decompress.restype = ctypes.c_int
    lib.clair_rans_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.clair_rans4x16_decompress.restype = ctypes.c_int
    lib.clair_rans4x16_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.clair_arith_decompress.restype = ctypes.c_int
    lib.clair_arith_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.clair_tok3_decode.restype = ctypes.c_int
    lib.clair_tok3_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.clair_fqzcomp_decompress.restype = ctypes.c_int
    lib.clair_fqzcomp_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.clair_cram_decode_slice.restype = ctypes.c_int
    lib.clair_cram_decode_slice.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(_CramSliceOut),
    ]
    lib.clair_cram_free_slice.argtypes = [ctypes.POINTER(_CramSliceOut)]


def decode_fast_native(
    x, gt21, geno, vl1, vl2, positions, center_bases, contig,
    show_ref=False, haploid_precision=False, haploid_sensitive=False,
    qual_cutoff=None, threads=None, sequences=None,
    has_insertion_source=True,
):
    """Native fast-path decode. Returns (rows_text, row_sites, fallback_sites)
    or None when the library is unavailable.

    rows_text: '\\n'-joined formatted VCF rows for decided sites;
    row_sites/fallback_sites: site indices. With `sequences` (packed n*33
    reference windows) the native decoder also assembles the callback-free
    indel categories; the fallback set shrinks to het ins+ins, lengths
    >= 16, and degenerate del+del alleles for the exact Python lattice.
    """
    lib = load_library()
    if lib is None:
        return None

    def fp(a):
        a = np.ascontiguousarray(a, dtype=np.float32)
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def fpv(a):
        """Zero-copy when the rows are float32 and last-axis contiguous
        (incl. strided views into the (n, 90) forward output — the
        production case); returns (keepalive, ptr, row_stride_in_floats)."""
        a = np.asarray(a)
        if (a.ndim != 2 or a.dtype != np.float32
                or a.strides[1] != 4 or a.strides[0] % 4 or a.strides[0] < 0):
            a = np.ascontiguousarray(a, dtype=np.float32)
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), a.strides[0] // 4

    x_c, x_p = fp(x)
    g_c, g_p, g_s = fpv(gt21)
    ge_c, ge_p, ge_s = fpv(geno)
    v1_c, v1_p, v1_s = fpv(vl1)
    v2_c, v2_p, v2_s = fpv(vl2)
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    bases = np.asarray(center_bases, dtype="S1").tobytes()
    seq_buf = None
    if sequences is not None:
        packed = getattr(sequences, "packed", None)
        if packed is not None:
            seq_buf = np.ascontiguousarray(packed).tobytes()
        else:
            seq_buf = "".join(sequences).encode("ascii")
        if len(seq_buf) != 33 * len(pos):
            seq_buf = None

    rows_ptr = ctypes.POINTER(ctypes.c_char)()
    rows_len = ctypes.c_int64()
    row_sites_ptr = ctypes.POINTER(ctypes.c_int64)()
    n_rows = ctypes.c_int64()
    fallback_ptr = ctypes.POINTER(ctypes.c_int64)()
    n_fallback = ctypes.c_int64()

    rc = lib.clair_decode_fast2(
        x_p, g_p, ge_p, v1_p, v2_p,
        g_s, ge_s, v1_s, v2_s,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        bases, seq_buf, len(pos), contig.encode(),
        int(has_insertion_source),
        int(show_ref), int(haploid_precision), int(haploid_sensitive),
        -(2 ** 31) if qual_cutoff is None else int(qual_cutoff),
        int(threads if threads is not None else _DEFAULT_DECODE_THREADS),
        ctypes.byref(rows_ptr), ctypes.byref(rows_len),
        ctypes.byref(row_sites_ptr), ctypes.byref(n_rows),
        ctypes.byref(fallback_ptr), ctypes.byref(n_fallback),
    )
    if rc != 0:
        return None
    try:
        rows_text = ctypes.string_at(rows_ptr, rows_len.value).decode("ascii")
        row_sites = (
            np.ctypeslib.as_array(row_sites_ptr, shape=(n_rows.value,)).copy()
            if n_rows.value else np.empty(0, np.int64)
        )
        fallback = (
            np.ctypeslib.as_array(fallback_ptr, shape=(n_fallback.value,)).copy()
            if n_fallback.value else np.empty(0, np.int64)
        )
    finally:
        lib.clair_decode_free(rows_ptr, row_sites_ptr, fallback_ptr)
    return rows_text, row_sites, fallback


def available() -> bool:
    return load_library() is not None


def rans_decompress(data: bytes, raw_size: int):
    """Native rANS 4x8 decode of a full stream (incl. the 9-byte header).
    Returns the raw bytes, or None when the library is unavailable or the
    stream is malformed (callers fall back to the Python decoder)."""
    lib = load_library()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(raw_size)
    rc = lib.clair_rans_decompress(
        data, len(data),
        ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), raw_size,
    )
    return out.raw if rc == 0 else None


def rans4x16_decompress(data: bytes, raw_size: int):
    """Native rANS Nx16 (CRAM 3.1) decode of a full stream. Returns the
    raw bytes, or None when the library is unavailable or the stream is
    malformed/unsupported (callers fall back to the Python codec)."""
    lib = load_library()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(raw_size)
    rc = lib.clair_rans4x16_decompress(
        data, len(data),
        ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), raw_size,
    )
    return out.raw if rc == 0 else None


def arith_decompress(data: bytes, raw_size: int):
    """Native adaptive-arithmetic (CRAM 3.1) decode of a full stream.
    Returns the raw bytes, or None when the library is unavailable or
    the stream is malformed / needs the Python path (EXT bodies)."""
    lib = load_library()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(raw_size)
    rc = lib.clair_arith_decompress(
        data, len(data),
        ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), raw_size,
    )
    return out.raw if rc == 0 else None


def fqzcomp_decompress(data: bytes, raw_size: int):
    """Native fqzcomp quality-block (CRAM 3.1) decode. Returns the raw
    quality bytes, or None when the library is unavailable or the stream
    is malformed / unsupported (callers fall back to the Python codec)."""
    lib = load_library()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(raw_size)
    rc = lib.clair_fqzcomp_decompress(
        data, len(data),
        ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), raw_size,
    )
    return out.raw if rc == 0 else None


def tok3_decode(data: bytes, raw_size: int):
    """Native tok3 name-block (CRAM 3.1) decode. Returns the rebuilt
    name blob, or None when the library is unavailable or the stream is
    malformed / unsupported (callers fall back to the Python codec)."""
    lib = load_library()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(raw_size)
    rc = lib.clair_tok3_decode(
        data, len(data),
        ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), raw_size,
    )
    return out.raw if rc == 0 else None


def cram_decode_slice(spec: bytes, core: bytes, externals, ref_buf: bytes):
    """Native CRAM slice record decode (clair_cram.cpp). ``externals`` is a
    list of (content_id, bytes). Returns:

    - ``(0, arrays)`` on success — arrays is a dict of numpy copies
      (pos/mapq/flag/refid, seq blob + offsets, cigar blobs + offsets,
      names blob + offsets);
    - ``(2, (need_lo, need_hi))`` when the decode needs reference bases
      outside the provided window (caller re-prefetches and retries);
    - ``(rc, None)`` on any other failure / unavailable library
      (callers fall back to the Python decoder in io/cram.py).
    """
    lib = load_library()
    if lib is None:
        return -1, None
    import struct as _struct

    meta = bytearray()
    blobs = []
    for cid, data in externals:
        meta += _struct.pack("<iq", cid, len(data))
        blobs.append(data)
    ext_data = b"".join(blobs)

    out = _CramSliceOut()
    rc = lib.clair_cram_decode_slice(
        spec, len(spec), core, len(core),
        bytes(meta), len(externals), ext_data, len(ext_data),
        ref_buf, len(ref_buf), ctypes.byref(out),
    )
    if rc == 2:
        return 2, (out.need_lo, out.need_hi)
    if rc != 0:
        return rc, None
    try:
        n = out.n_records

        def arr(pointer, count, dtype):
            if count == 0:
                return np.empty(0, dtype=dtype)
            return np.ctypeslib.as_array(pointer, shape=(count,)).astype(
                dtype, copy=True
            )

        seq_off = arr(out.seq_off, n + 1, np.int64)
        cig_off = arr(out.cig_off, n + 1, np.int64)
        name_off = arr(out.name_off, n + 1, np.int64)
        arrays = {
            "pos": arr(out.pos, n, np.int64),
            "mapq": arr(out.mapq, n, np.int32),
            "flag": arr(out.flag, n, np.int32),
            "refid": arr(out.refid, n, np.int32),
            "seq": arr(out.seq, int(seq_off[-1]) if n else 0, np.uint8),
            "seq_off": seq_off,
            "cig_ops": arr(out.cig_ops, int(cig_off[-1]) if n else 0, np.uint8),
            "cig_lens": arr(out.cig_lens, int(cig_off[-1]) if n else 0, np.int32),
            "cig_off": cig_off,
            "names": ctypes.string_at(out.names, int(name_off[-1]))
            if n and int(name_off[-1]) else b"",
            "name_off": name_off,
        }
        if out.qual:  # present only when the spec requested qualities
            arrays["qual"] = arr(out.qual, int(seq_off[-1]) if n else 0,
                                 np.uint8)
        arrays["next_ref"] = arr(out.next_ref, n, np.int32)
        arrays["next_pos"] = arr(out.next_pos, n, np.int64)
        arrays["tlen"] = arr(out.tlen, n, np.int64)
    finally:
        lib.clair_cram_free_slice(ctypes.byref(out))
    return 0, arrays


def build_bai_native(bam_path: str, bai_path: str) -> bool:
    """Native single-pass BAI builder; returns False when unavailable or on
    failure (callers fall back to the Python builder)."""
    lib = load_library()
    if lib is None:
        return False
    return lib.clair_build_bai(bam_path.encode(), bai_path.encode()) == 0


def events_from_bam_native(
    bam_path: str,
    ref_id: int,
    start: int = -1,
    end: int = -1,
    exclude_flag: int = 2316,
    min_mapq: int = 0,
    dcov: int = 0,
    softclip_filter: bool = False,
    use_index: bool = True,
):
    """Native replacement for events_from_reads over a whole region. Returns a
    clair_tpu.data.pileup.ReadEvents or None when the library is missing.

    With ``use_index`` and a .bai next to the BAM, the scan seeks straight
    to the region's first candidate block instead of inflating the whole
    file (the win for per-window WGS calling).
    """
    import os

    from clair_tpu_torch.data.pileup import ReadEvents

    lib = load_library()
    if lib is None:
        return None

    start_coffset, start_uoffset = -1, -1
    if use_index and start >= 0 and ref_id >= 0 and os.path.isfile(bam_path + ".bai"):
        try:
            from clair_tpu_torch.io.bai import BaiIndex

            voffset = BaiIndex(bam_path + ".bai").min_virtual_offset(ref_id, start)
            if voffset:
                start_coffset = voffset >> 16
                start_uoffset = voffset & 0xFFFF
        except Exception:
            pass

    buffers = _EventBuffers()
    rc = lib.clair_bam_events(
        bam_path.encode(), ref_id, start, end, exclude_flag, min_mapq,
        dcov, int(softclip_filter), start_coffset, start_uoffset,
        ctypes.byref(buffers),
    )
    if rc != 0:
        raise RuntimeError(f"clair_bam_events failed with code {rc} on {bam_path}")
    return _events_from_buffers(lib, buffers)


def _bai_seek(bam_path, ref_id, start, use_index):
    if not (use_index and start >= 0 and ref_id >= 0):
        return -1, -1
    if not os.path.isfile(bam_path + ".bai"):
        return -1, -1
    try:
        from clair_tpu_torch.io.bai import BaiIndex

        voffset = BaiIndex(bam_path + ".bai").min_virtual_offset(ref_id, start)
        if voffset:
            return voffset >> 16, voffset & 0xFFFF
    except Exception:
        pass
    return -1, -1


def dual_events_from_bam_native(
    bam_path: str,
    ref_id: int,
    start: int = -1,
    end: int = -1,
    exclude_flag: int = 2316,
    min_mapq: int = 0,
    dcov: int = 250,
    use_index: bool = True,
):
    """(candidate_events, tensor_events) from ONE native scan: candidate set
    soft-clip filtered (no depth cap), tensor set depth-capped (no soft-clip
    filter) — the reference's per-stage filters with the inflate + record
    parse paid once. Returns None when the library is missing."""
    lib = load_library()
    if lib is None:
        return None
    start_coffset, start_uoffset = _bai_seek(bam_path, ref_id, start, use_index)
    candidate = _EventBuffers()
    tensor = _EventBuffers()
    rc = lib.clair_bam_events_dual(
        bam_path.encode(), ref_id, start, end, exclude_flag, min_mapq, dcov,
        start_coffset, start_uoffset,
        ctypes.byref(candidate), ctypes.byref(tensor),
    )
    if rc != 0:
        raise RuntimeError(f"clair_bam_events_dual failed with code {rc} on {bam_path}")
    return (
        _events_from_buffers(lib, candidate),
        _events_from_buffers(lib, tensor),
    )


def scan_window_native(
    bam_path: str,
    ref_id: int,
    start: int,
    end: int,
    region_start: int,
    region_length: int,
    exclude_flag: int = 2316,
    min_mapq: int = 0,
    dcov: int = 250,
    use_index: bool = True,
):
    """(candidate_counts, tensor_events) from ONE native scan: the
    candidate side comes back as its (region_length, 7) pileup count
    matrix (accumulated in the walk — no candidate events materialize),
    the tensor side as depth-capped events. Returns None when the library
    is missing."""
    lib = load_library()
    if lib is None:
        return None
    start_coffset, start_uoffset = _bai_seek(bam_path, ref_id, start, use_index)
    counts = np.zeros((region_length, 7), dtype=np.int32)
    tensor = _EventBuffers()
    rc = lib.clair_bam_scan_window(
        bam_path.encode(), ref_id, start, end, exclude_flag, min_mapq, dcov,
        region_start, region_length, start_coffset, start_uoffset,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(tensor),
    )
    if rc != 0:
        raise RuntimeError(f"clair_bam_scan_window failed with code {rc} on {bam_path}")
    return counts, _events_from_buffers(lib, tensor)


def select_candidates_native(counts, ref_bytes, position_mask,
                             minimum_af, minimum_coverage):
    """One C pass of the candidate filter (clair_select_candidates — same
    depth/top-column/AF semantics as data/pileup.py select_candidates,
    ref EVC.py:319-378). Returns (idx, depth, collapsed_base_bytes), or
    None when the library is unavailable so the caller keeps the numpy
    path. ref_bytes must hold the region's reference bytes starting at
    region_start (length >= len(counts))."""
    lib = load_library()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    n = len(counts)
    if len(ref_bytes) < n:
        return None
    idx = np.empty(n, dtype=np.int64)
    depth = np.empty(n, dtype=np.int32)
    base = np.empty(n, dtype=np.uint8)
    if position_mask is not None:
        mask = np.ascontiguousarray(position_mask, dtype=np.uint8)
        mask_ptr = mask.ctypes.data_as(ctypes.c_void_p)
    else:
        mask_ptr = None
    m = int(lib.clair_select_candidates(
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        ref_bytes, mask_ptr,
        float(minimum_af), float(minimum_coverage),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        base.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    ))
    return idx[:m].copy(), depth[:m].copy(), base[:m].tobytes()


def finalize_windows_native(tensor_ints, centers, ref_bytes, ref_seq_start,
                            minimum_coverage=0):
    """Fused window finalize (clair_finalize_windows): keep filter +
    float32 conversion + channel normalization + 33-mer extraction in one
    C pass, matching finalize_window_tensors + normalize_channels.
    Returns (tensors float32, kept centers, sequences) or None when the
    library is unavailable. ref_bytes holds the reference bytes starting
    at ref_seq_start."""
    lib = load_library()
    if lib is None:
        return None
    tensor_ints = np.ascontiguousarray(tensor_ints, dtype=np.int32)
    centers = np.ascontiguousarray(centers, dtype=np.int64)
    n = len(tensor_ints)
    out = np.empty((n, 33, 8, 4), dtype=np.float32)
    kept = np.empty(n, dtype=np.int64)
    seqs = np.empty(n * 33, dtype=np.uint8)
    m = int(lib.clair_finalize_windows(
        tensor_ints.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        centers.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ref_bytes, len(ref_bytes), ref_seq_start,
        float(minimum_coverage),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        kept.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    ))
    from clair_tpu_torch.data.tensor_stream import PackedSequences

    # windows stay packed (n, 33) uint8 end to end: center bases become
    # an array column and the decode fast path ships the blob as one
    # memcpy; PackedSequences decodes strs only where a consumer indexes
    sequences = PackedSequences(seqs[:m * 33].reshape(m, 33).copy())
    # out[:m] stays a view: m is n minus a handful of dropped edge sites,
    # so slicing avoids a second full-buffer copy at negligible overhang
    return out[:m], centers[kept[:m]], sequences


def finalize_windows_raw_native(tensor_ints, centers, ref_bytes,
                                ref_seq_start, minimum_coverage=0):
    """Raw-count finalize (clair_finalize_windows_u8): keep filter +
    33-mer extraction, counts kept as raw uint8 — channel normalization
    happens on device inside the jitted forward (and lazily on host at
    decode time). Halves the host->device uplink vs the int16 normalized
    ship (the dominant e2e cost at remote-link speeds) and quarters host
    window memory vs float32. dcov caps reads per START position (ref
    CreateTensor.py:267-274), not column depth, so counts can exceed a
    byte on >255x data even at dcov=250: the C pass aborts on the first
    such cell (never saturates) and this wrapper re-finalizes through the
    exact float32 path, so callers transparently get either
    (tensors uint8 raw, ...) or (tensors float32 normalized, ...).
    Returns None when the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    tensor_ints = np.ascontiguousarray(tensor_ints, dtype=np.int32)
    centers = np.ascontiguousarray(centers, dtype=np.int64)
    n = len(tensor_ints)
    out = np.empty((n, 33, 8, 4), dtype=np.uint8)
    kept = np.empty(n, dtype=np.int64)
    seqs = np.empty(n * 33, dtype=np.uint8)
    m = int(lib.clair_finalize_windows_u8(
        tensor_ints.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        centers.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ref_bytes, len(ref_bytes), ref_seq_start,
        float(minimum_coverage),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        kept.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    ))
    if m < 0:  # a count didn't fit a byte: take the exact float32 path
        return finalize_windows_native(
            tensor_ints, centers, ref_bytes, ref_seq_start,
            minimum_coverage=minimum_coverage,
        )
    from clair_tpu_torch.data.tensor_stream import PackedSequences

    sequences = PackedSequences(seqs[:m * 33].reshape(m, 33).copy())
    return out[:m], centers[kept[:m]], sequences


class RegionScan:
    """One inflate+filter of a region's records, multiple cheap passes:
    counts for candidate selection, then window tensors for the selected
    centers — match events (~93% of event volume) never cross into Python
    on this path. Falls back to None construction when the library is
    missing; close() (or GC) releases the inflated buffer."""

    def __init__(
        self,
        bam_path: str,
        ref_id: int,
        start: int,
        end: int,
        exclude_flag: int = 2316,
        min_mapq: int = 0,
        use_index: bool = True,
        counts_region: Optional[Tuple[int, int]] = None,
    ):
        self._lib = load_library()
        self._handle = None
        self._counts_cache = None
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        start_coffset, start_uoffset = _bai_seek(bam_path, ref_id, start, use_index)
        self._filters = (ref_id, start, end, exclude_flag, min_mapq)
        if counts_region is not None:
            # fused open: candidate counts accumulate while each accepted
            # record is still cache-hot (clair_region_open2), so the later
            # counts() call is a lookup instead of a re-walk of the
            # inflated buffer
            region_start, region_length = counts_region
            cached = np.zeros((region_length, 7), dtype=np.int32)
            handle = self._lib.clair_region_open2(
                bam_path.encode(), ref_id, start, end, exclude_flag,
                min_mapq, start_coffset, start_uoffset,
                region_start, region_length,
                cached.ctypes.data_as(ctypes.c_void_p),
            )
            if handle:
                self._counts_cache = (region_start, region_length, cached)
        else:
            handle = self._lib.clair_region_open(
                bam_path.encode(), ref_id, start, end, exclude_flag, min_mapq,
                start_coffset, start_uoffset,
            )
        if not handle:
            raise RuntimeError(f"clair_region_open failed on {bam_path}")
        self._handle = handle

    @classmethod
    def from_packed(cls, arrays, ref_id, start, end, exclude_flag=2316,
                    min_mapq=0, counts_region=None):
        """RegionScan over packed record arrays (the native CRAM slice
        decoder's output: ASCII seq, BAM cigar op codes, position-sorted)
        — same counts()/tensors() surface as the file-based constructor.
        Returns None when the library is missing or a record exceeds BAM
        limits (>65535 cigar ops); callers fall back to the Python
        events engine."""
        lib = load_library()
        if lib is None:
            return None
        n = int(arrays["pos"].shape[0])

        def as_c(key, dtype, ctype):
            a = np.ascontiguousarray(arrays[key], dtype=dtype)
            if a.size == 0:
                a = np.zeros(1, dtype=dtype)
            return a, a.ctypes.data_as(ctypes.POINTER(ctype))

        pos, pos_p = as_c("pos", np.int64, ctypes.c_int64)
        mapq, mapq_p = as_c("mapq", np.int32, ctypes.c_int32)
        flag, flag_p = as_c("flag", np.int32, ctypes.c_int32)
        refid, refid_p = as_c("refid", np.int32, ctypes.c_int32)
        seq, seq_p = as_c("seq", np.uint8, ctypes.c_uint8)
        seq_off, seq_off_p = as_c("seq_off", np.int64, ctypes.c_int64)
        cig_ops, cig_ops_p = as_c("cig_ops", np.uint8, ctypes.c_uint8)
        cig_lens, cig_lens_p = as_c("cig_lens", np.int32, ctypes.c_int32)
        cig_off, cig_off_p = as_c("cig_off", np.int64, ctypes.c_int64)

        # the offset tables index the seq/cigar blobs in C with no blob
        # lengths: reject non-monotonic tables or extents past the blobs
        # (defense in depth — the CRAM slice decoder builds them
        # monotonic by construction)
        if n > 0 and (
            seq_off.shape[0] <= n or cig_off.shape[0] <= n
            or np.any(np.diff(seq_off[: n + 1]) < 0)
            or np.any(np.diff(cig_off[: n + 1]) < 0)
            or seq_off[0] < 0 or cig_off[0] < 0
            or int(seq_off[n]) > int(arrays["seq"].shape[0])
            or int(cig_off[n]) > int(arrays["cig_ops"].shape[0])
            or int(cig_off[n]) > int(arrays["cig_lens"].shape[0])
        ):
            return None

        cached = None
        region_start = region_length = 0
        counts_ptr = None
        if counts_region is not None:
            region_start, region_length = counts_region
            cached = np.zeros((region_length, 7), dtype=np.int32)
            counts_ptr = cached.ctypes.data_as(ctypes.c_void_p)
        handle = lib.clair_region_from_packed(
            n, pos_p, mapq_p, flag_p, refid_p,
            seq_p, seq_off_p, cig_ops_p, cig_lens_p, cig_off_p,
            ref_id, start, end, exclude_flag, min_mapq,
            region_start, region_length, counts_ptr,
        )
        if not handle:
            return None
        self = cls.__new__(cls)
        self._lib = lib
        self._handle = handle
        self._filters = (ref_id, start, end, exclude_flag, min_mapq)
        self._counts_cache = (
            (region_start, region_length, cached) if cached is not None else None
        )
        return self

    @property
    def n_records(self) -> int:
        return int(self._lib.clair_region_n_records(self._handle))

    def counts(self, region_start: int, region_length: int) -> np.ndarray:
        """(region_length, 7) candidate pileup counts (soft-clip filtered)."""
        if self._counts_cache is not None:
            cached_start, cached_length, cached = self._counts_cache
            if cached_start == region_start and cached_length == region_length:
                return cached
        out = np.zeros((region_length, 7), dtype=np.int32)
        rc = self._lib.clair_region_counts(
            self._handle, region_start, region_length,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:
            raise RuntimeError(f"clair_region_counts failed with code {rc}")
        return out

    def tensors(
        self,
        centers: np.ndarray,
        reference_sequence: str,
        ref_seq_start: int,
        dcov: int = 250,
    ):
        """(tensors int32 (n,33,8,4), indel_events) for sorted 1-based
        centers; depth-capped, reference-gated like create_tensors."""
        centers = np.ascontiguousarray(centers, dtype=np.int64)
        n = len(centers)
        tensors = np.zeros((n, 33, 8, 4), dtype=np.int32)
        buffers = _EventBuffers()
        ref_bytes = reference_sequence.encode("ascii")
        rc = self._lib.clair_region_tensors(
            self._handle, int(dcov),
            centers.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            ref_bytes, ref_seq_start, len(ref_bytes),
            tensors.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(buffers),
        )
        if rc != 0:
            raise RuntimeError(f"clair_region_tensors failed with code {rc}")
        return tensors, _events_from_buffers(self._lib, buffers)

    def scan_window(self, dcov: int, region_start: int, region_length: int):
        """(candidate counts, tensor ReadEvents) with data-prep semantics
        (depth cap on tensor events, soft-clip filter on counts) — the
        handle-based equivalent of scan_window_native, re-applying the
        handle's own build filters so decisions match the stream scan."""
        ref_id, start, end, exclude_flag, min_mapq = self._filters
        counts = np.zeros((region_length, 7), dtype=np.int32)
        buffers = _EventBuffers()
        rc = self._lib.clair_region_scan_window(
            self._handle, ref_id, start, end, exclude_flag, min_mapq, dcov,
            region_start, region_length,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(buffers),
        )
        if rc != 0:
            raise RuntimeError(f"clair_region_scan_window failed with {rc}")
        return counts, _events_from_buffers(self._lib, buffers)

    def events_dual(self, dcov: int):
        """(candidate ReadEvents, tensor ReadEvents) with the reference's
        per-stage filters — the handle-based equivalent of
        dual_events_from_bam_native."""
        ref_id, start, end, exclude_flag, min_mapq = self._filters
        candidate = _EventBuffers()
        tensor = _EventBuffers()
        rc = self._lib.clair_region_events_dual(
            self._handle, ref_id, start, end, exclude_flag, min_mapq, dcov,
            ctypes.byref(candidate), ctypes.byref(tensor),
        )
        if rc != 0:
            raise RuntimeError(f"clair_region_events_dual failed with {rc}")
        return (
            _events_from_buffers(self._lib, candidate),
            _events_from_buffers(self._lib, tensor),
        )

    def close(self) -> None:
        if self._handle is not None:
            self._lib.clair_region_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _events_from_buffers(lib, buffers):
    from clair_tpu_torch.data.pileup import ReadEvents

    def arr(pointer, n, dtype):
        if n == 0:
            return np.empty(0, dtype=dtype)
        return np.ctypeslib.as_array(pointer, shape=(n,)).astype(dtype, copy=True)

    try:
        events = ReadEvents(
            match_pos=arr(buffers.match_pos, buffers.n_match, np.int64),
            match_qcol=arr(buffers.match_qcol, buffers.n_match, np.int8),
            match_strand=arr(buffers.match_strand, buffers.n_match, np.int8),
            ins_pos=arr(buffers.ins_pos, buffers.n_ins, np.int64),
            ins_adv=arr(buffers.ins_adv, buffers.n_ins, np.int64),
            ins_qcol=arr(buffers.ins_qcol, buffers.n_ins, np.int8),
            ins_strand=arr(buffers.ins_strand, buffers.n_ins, np.int8),
            del_pos=arr(buffers.del_pos, buffers.n_del, np.int64),
            del_strand=arr(buffers.del_strand, buffers.n_del, np.int8),
            ins_op_pos=arr(buffers.ins_op_pos, buffers.n_ins_op, np.int64),
            del_op_pos=arr(buffers.del_op_pos, buffers.n_del_op, np.int64),
            ins_op_len=arr(buffers.ins_op_len, buffers.n_ins_op, np.int64),
            del_op_len=arr(buffers.del_op_len, buffers.n_del_op, np.int64),
        )
    finally:
        lib.clair_free_events(ctypes.byref(buffers))
    return events
