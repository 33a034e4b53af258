"""Randomized mutation fuzz of the PyTorch port's native decoders and
container readers (the port of tools/fuzz_native.py, on the port's own
copies: clair_tpu_torch.io's encoders and readers, and the library that
clair_tpu_torch/native/ builds with its own Makefile).

The native library decodes archive bytes it does not control (BAM/CRAM
files, rANS/arith/tok3 blocks inside CRAM containers), so every decoder
must fail CLEANLY on arbitrary corruption: nonzero rc / Python
exception, never a crash or out-of-bounds access. Streams are generated
VALID by the port's own encoders, then mutated (byte flips, truncation,
extension, splices) and fed to the native decoders. CPU only.

Three tiers:

  codec      rans4x8 / rans4x16 (all mode flags) / arith (all mode
             flags) / tok3 name decoder on mutated blocks
  container  whole mutated BAM files through the native RegionScan
             (BGZF inflate + record walk + counts + window tensors,
             with a stale .bai and without) and mutated CRAM files
             through CramReader (native slice decode + packed bridge)
  slice      the native CRAM slice decoder's direct inputs (spec blob,
             core bitstream, external blocks, reference window) captured
             from valid 3.0/3.1 files and mutated past the checksums

Usage (plain: crash-freedom only):

    python tools/torch_fuzz_native.py --seed 7 --iters 40 --tier all

Under ASAN/UBSan (catches silent out-of-bounds too), with the library
built from the port's sources and handed to the port's loader (``--lib``
replaces ``clair_tpu_torch.native._lib_path``):

    mkdir -p build/asan_build
    g++ -O1 -g -fsanitize=address,undefined -fno-sanitize-recover=undefined \
        -std=c++17 -fPIC -DCLAIR_HAVE_LIBDEFLATE -shared \
        -o build/asan_build/libclair_native.so clair_tpu_torch/native/*.cpp \
        -lz -ldeflate -lpthread -lubsan
    ASAN_OPTIONS=detect_leaks=0:allocator_may_return_null=1 \
    LD_PRELOAD="$(g++ -print-file-name=libasan.so) \
        $(g++ -print-file-name=libstdc++.so.6)" \
    python tools/torch_fuzz_native.py --lib build/asan_build/libclair_native.so \
        --seed 7 --iters 40 --tier all

Exit 0 = survived every call. A crash aborts the process (that IS the
failing signal); rerun with the printed seed to reproduce.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np


def _mutate(rs, stream: bytes, max_ops: int = 8) -> bytes:
    b = bytearray(stream)
    for _ in range(rs.randint(1, max_ops)):
        op = rs.randint(5)
        if not b:
            break
        if op == 0:            # flip one byte
            b[rs.randint(len(b))] = rs.randint(256)
        elif op == 1:          # clobber a small field
            i = rs.randint(len(b))
            for j in range(i, min(i + rs.randint(2, 16), len(b))):
                b[j] = rs.randint(256)
        elif op == 2:          # truncate
            b = b[: rs.randint(len(b)) + 1]
        elif op == 3:          # extend with junk
            b += bytes(rs.randint(0, 256, rs.randint(1, 64), dtype=np.uint8))
        else:                  # splice a window to elsewhere
            if len(b) > 8:
                i, j = sorted(rs.randint(0, len(b), 2))
                k = rs.randint(len(b))
                b[k:k] = b[i:j][:128]
    return bytes(b)


def _payload(rs, n: int) -> bytes:
    kind = rs.randint(4)
    if kind == 0:              # uniform random
        return bytes(rs.randint(0, 256, n, dtype=np.uint8))
    if kind == 1:              # low-cardinality (PACK-friendly)
        return bytes(rs.choice([0, 1, 3, 7], n).astype(np.uint8))
    if kind == 2:              # runs (RLE-friendly)
        out = bytearray()
        while len(out) < n:
            out += bytes([rs.randint(0, 256)]) * rs.randint(1, 40)
        return bytes(out[:n])
    out = bytearray()          # text-ish (names-friendly)
    i = 0
    while len(out) < n:
        out += b"read_%d/ch%d_%d " % (i, rs.randint(512), rs.randint(10 ** 6))
        i += 1
    return bytes(out[:n])


def _quiet(fn, *args):
    try:
        fn(*args)
    except Exception:
        pass


def fuzz_codecs(native, rs, iters: int, sizes=(1, 2, 7, 100, 4096, 65536)):
    from clair_tpu_torch.io import arith as m_arith
    from clair_tpu_torch.io import fqzcomp as m_fqz
    from clair_tpu_torch.io import rans as m_rans
    from clair_tpu_torch.io import rans4x16 as m_r16
    from clair_tpu_torch.io import tok3 as m_tok3

    def enc_rans(data):
        return m_rans.compress(data, order=int(rs.randint(2)))

    def enc_r16(data):
        return m_r16.compress(
            data, order=int(rs.randint(2)),
            use_rle=bool(rs.randint(2)), use_pack=bool(rs.randint(2)),
            stripe=int(rs.choice([0, 2, 4])), x32=bool(rs.randint(2)),
        )

    def enc_arith(data):
        return m_arith.compress(
            data, order=int(rs.randint(2)),
            use_rle=bool(rs.randint(2)), use_pack=bool(rs.randint(2)),
            use_ext=bool(rs.randint(2)), stripe=int(rs.choice([0, 2])),
        )

    def enc_tok3(data):
        names = bytes(data).replace(b"\x00", b"a").replace(b" ", b"\n")
        return m_tok3.encode_names(names + b"\n",
                                   use_arith=bool(rs.randint(2)))

    def enc_fqz(data):
        lengths = None
        if len(data) > 3 and rs.randint(2):
            lengths, rem = [], len(data)
            while rem > 0:
                ln = int(min(rem, rs.randint(1, 400)))
                lengths.append(ln)
                rem -= ln
        return m_fqz.compress(data, lengths)

    codecs = [
        ("rans4x8", enc_rans, native.rans_decompress),
        ("rans4x16", enc_r16, native.rans4x16_decompress),
        ("arith", enc_arith, native.arith_decompress),
        ("tok3", enc_tok3, native.tok3_decode),
        ("fqzcomp", enc_fqz, native.fqzcomp_decompress),
    ]
    calls = 0
    for name, enc, dec in codecs:
        for _ in range(iters):
            data = _payload(rs, int(rs.choice(sizes)))
            try:
                stream = enc(data)
            except ValueError:
                continue
            _quiet(dec, stream, len(data))           # valid must not crash
            for _ in range(6):
                _quiet(dec, _mutate(rs, stream), len(data))
                _quiet(dec, stream, int(rs.randint(0, 2 * len(data) + 2)))
                calls += 3
        print(f"[fuzz] codec {name}: survived", flush=True)
    return calls


def fuzz_containers(native, rs, iters: int):
    with tempfile.TemporaryDirectory(prefix="torch_fuzz_cont_") as tmp:
        return _fuzz_containers(rs, iters, tmp)


def _fuzz_containers(rs, iters: int, tmp: str):
    from clair_tpu_torch.io.bai import build_bai
    from clair_tpu_torch.io.cram import CramReader, bam_to_cram
    from clair_tpu_torch.io.fasta import FastaReader
    from clair_tpu_torch.pipeline.call_bam import open_region_scan_path
    from clair_tpu_torch.utils.simulate import (
        plant_variants, random_reference, simulate_bam, write_fasta,
    )

    ref = random_reference(rs, 8000)
    variants = plant_variants(rs, ref, n_variants=8, spacing=600)
    bam = os.path.join(tmp, "g.bam")
    fa = os.path.join(tmp, "g.fa")
    simulate_bam(bam, ref, variants, rs, coverage=20)
    write_fasta(fa, ref)
    build_bai(bam, bam + ".bai")
    cram = os.path.join(tmp, "g.cram")
    bam_to_cram(bam, cram, fa)
    # 3.1 archive profile: rANS Nx16 externals, tok3 names, fqzcomp quals
    # — corrupt blocks route through the native 3.1 codec decoders
    cram31 = os.path.join(tmp, "g31.cram")
    bam_to_cram(bam, cram31, fa, version=(3, 1), fqzcomp_quals=True)
    bam_bytes = open(bam, "rb").read()
    bai_bytes = open(bam + ".bai", "rb").read()
    cram_bytes = open(cram, "rb").read()
    cram31_bytes = open(cram31, "rb").read()
    with CramReader(cram, fasta=fa) as sane:
        assert sum(1 for _ in sane.fetch("chr1", 0, 8000)) > 0, \
            "valid CRAM failed to decode: fuzz would be vacuous"
    fasta = FastaReader(fa)
    centers = np.arange(100, 7900, 83, dtype=np.int64)

    def try_bam(path):
        try:
            scan = open_region_scan_path(path, fasta, "chr1", 0, 8000, 0,
                                         counts_region=(0, 8000))
            if scan is not None:
                try:
                    scan.counts(0, 8000)
                    scan.tensors(centers, ref, 0)
                finally:
                    scan.close()
        except Exception:
            pass

    def try_cram(path):
        try:
            r = CramReader(path, fasta=fa)
            _quiet(r.fetch_packed, "chr1", 0, 8000)
            try:
                for _ in r.fetch("chr1", 0, 8000):
                    pass
            except Exception:
                pass
            finally:
                r.close()
        except Exception:
            pass

    bad_bam = os.path.join(tmp, "bad.bam")
    bad_cram = os.path.join(tmp, "bad.cram")
    for it in range(iters):
        with open(bad_bam, "wb") as fh:
            fh.write(_mutate(rs, bam_bytes, max_ops=12))
        # a VALID index over corrupted bytes (torn download), then none
        with open(bad_bam + ".bai", "wb") as fh:
            fh.write(bai_bytes)
        try_bam(bad_bam)
        os.remove(bad_bam + ".bai")
        try_bam(bad_bam)
        with open(bad_cram, "wb") as fh:
            fh.write(_mutate(rs, cram_bytes, max_ops=12))
        try_cram(bad_cram)
        with open(bad_cram, "wb") as fh:
            fh.write(_mutate(rs, cram31_bytes, max_ops=12))
        try_cram(bad_cram)
    print(f"[fuzz] containers: survived ({iters} mutated files x 4 reads)",
          flush=True)
    return iters * 4


def fuzz_slices(native, rs, iters: int):
    """Mutate the native CRAM slice decoder's direct inputs (spec blob,
    core bitstream, external blocks, reference window). The container
    tier rarely reaches clair_cram.cpp — block CRCs reject most random
    container corruption first — so this tier captures real post-CRC
    (spec, core, externals, ref) tuples from valid 3.0/3.1 files and
    corrupts each component past the checksums."""
    with tempfile.TemporaryDirectory(prefix="torch_fuzz_slice_") as tmp:
        return _fuzz_slices(native, rs, iters, tmp)


def _fuzz_slices(native, rs, iters: int, tmp: str):
    from clair_tpu_torch.io.bai import build_bai
    from clair_tpu_torch.io.cram import CramReader, bam_to_cram
    from clair_tpu_torch.utils.simulate import (
        plant_variants, random_reference, simulate_bam, write_fasta,
    )

    ref = random_reference(rs, 8000)
    variants = plant_variants(rs, ref, n_variants=8, spacing=600)
    bam = os.path.join(tmp, "g.bam")
    fa = os.path.join(tmp, "g.fa")
    simulate_bam(bam, ref, variants, rs, coverage=20)
    write_fasta(fa, ref)
    build_bai(bam, bam + ".bai")

    captured = []
    orig = native.cram_decode_slice

    def capture(spec, core, externals, ref_buf):
        captured.append((bytes(spec), bytes(core),
                         [(c, bytes(d)) for c, d in externals],
                         bytes(ref_buf)))
        return orig(spec, core, externals, ref_buf)

    native.cram_decode_slice = capture
    try:
        for version, fqz in (((3, 0), False), ((3, 1), True)):
            cram = os.path.join(tmp, f"g{version[1]}.cram")
            bam_to_cram(bam, cram, fa, version=version, fqzcomp_quals=fqz)
            r = CramReader(cram, fasta=fa)
            try:
                r.fetch_packed("chr1", 0, 8000)
            finally:
                r.close()
    finally:
        native.cram_decode_slice = orig
    if not captured:
        print("[fuzz] slices: nothing captured (native path not taken?)",
              flush=True)
        return 0

    calls = 0
    for spec, core, externals, ref_buf in captured:
        for _ in range(iters):
            which = rs.randint(4)
            m_spec, m_core, m_ext, m_ref = spec, core, externals, ref_buf
            if which == 0:
                m_spec = _mutate(rs, spec)
            elif which == 1:
                m_core = _mutate(rs, core)
            elif which == 2 and externals:
                i = rs.randint(len(externals))
                m_ext = list(externals)
                m_ext[i] = (m_ext[i][0], _mutate(rs, m_ext[i][1]))
            else:
                m_ref = _mutate(rs, ref_buf) if ref_buf else ref_buf
            _quiet(orig, m_spec, m_core, m_ext, m_ref)
            calls += 1
    print(f"[fuzz] slices: survived ({len(captured)} slices x {iters})",
          flush=True)
    return calls


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--iters", type=int, default=40)
    parser.add_argument("--tier", choices=("codec", "container", "slice",
                                           "both", "all"),
                        default="both")
    parser.add_argument("--lib", default=None,
                        help="alternate libclair_native.so (ASAN build)")
    args = parser.parse_args()

    import clair_tpu_torch.native as native

    if args.lib:
        lib = os.path.abspath(args.lib)
        if not os.path.isfile(lib):
            print(f"no library at {lib}", file=sys.stderr)
            return 1
        native._lib_path = lambda: lib
        native._lib = None
    if not native.available():
        print("native library unavailable", file=sys.stderr)
        return 1

    rs = np.random.RandomState(args.seed)
    calls = 0
    if args.tier in ("codec", "both", "all"):
        calls += fuzz_codecs(native, rs, args.iters)
    if args.tier in ("container", "both", "all"):
        calls += fuzz_containers(native, rs, max(1, args.iters // 2))
    if args.tier in ("slice", "all"):
        calls += fuzz_slices(native, rs, args.iters * 6)
    print(f"[fuzz] DONE seed={args.seed} calls~{calls}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
