"""Pileup-tensor text stream IO.

Line format (compatible with the reference CreateTensor output,
reference dataPrepScripts/CreateTensor.py:60-65):

    ctg_name center_pos ref_seq_33 v0 v1 ... v1055

The 1056 ints are the (33, 8, 4) counts in row-major order; sequence index i
corresponds to tensor row i with the candidate site at index 16.

Batching applies the channel normalization the model expects — channels
1..3 (ins/del/SNP) minus channel 0 (reference) — exactly as the reference
does at load time (clair/utils.py:96-98), and parses whole batches with one
vectorized np.fromstring-style pass instead of per-row Python splits.
"""

from __future__ import annotations

import gzip
import sys
from typing import IO, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from clair_tpu_torch.params import INPUT_TENSOR_SIZE, MATRIX_NUM, MATRIX_ROW, NO_OF_POSITIONS
from clair_tpu_torch.utils.genomics import BASE2NUM

TensorInfo = Tuple[str, str, str]  # (ctg_name, position_str, sequence)


class PackedSequences:
    """Reference 33-mer windows kept as one (n, 33) uint8 array end to
    end. The native pileup engine produces the windows as packed ascii
    bytes; keeping them packed lets the decode fast path take center
    bases as an array column and ship the window blob to C++ as one
    memcpy, instead of round-tripping n Python strings per batch (the
    str-list encode was ~20% of the ONT decode stage). Indexing keeps the
    str contract consumers expect: [int] decodes one window, [slice]
    stays packed."""

    __slots__ = ("packed",)

    def __init__(self, packed: np.ndarray):
        self.packed = packed  # (n, NO_OF_POSITIONS) uint8, C-contiguous

    def __len__(self) -> int:
        return len(self.packed)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PackedSequences(self.packed[i])
        return self.packed[i].tobytes().decode("ascii")

    def __iter__(self):
        blob = self.packed.tobytes().decode("ascii")
        w = self.packed.shape[1]
        return (blob[k * w:(k + 1) * w] for k in range(len(self.packed)))

    def __eq__(self, other):
        """List semantics: equal to any sequence holding the same window
        strings, so native-vs-Python engine equivalence guards compare
        the two return types directly."""
        if isinstance(other, PackedSequences):
            return np.array_equal(self.packed, other.packed)
        if isinstance(other, (list, tuple)):
            return len(other) == len(self) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq


class TensorInfos(list):
    """Batch info list of (ctg, pos_str, seq) tuples that also carries
    vectorized metadata, so the native decode fast path needn't re-walk
    1000 Python tuples per batch (that walk alone capped decode at ~1M
    sites/s on a single host core):

    - contig: the single contig name if every site shares it, else None
    - positions: int64 array of 1-based positions
    - center_bases: |S1 array of center reference bases
    """

    __slots__ = ("contig", "positions", "center_bases")

    def __init__(self, items=(), contig=None, positions=None, center_bases=None):
        super().__init__(items)
        self.contig = contig
        self.positions = positions
        self.center_bases = center_bases


class LazyTensorInfos:
    """(ctg, pos_str, seq) tuples materialized on access only — batch
    producers that already hold a single contig, an int64 position array,
    and a sequence list (call_bam's window pipeline) skip the per-site
    tuple build entirely; the decode fast path reads the arrays directly
    and only fallback/debug sites ever materialize a tuple."""

    __slots__ = ("contig", "positions", "sequences", "_center_bases")

    def __init__(self, contig: str, positions, sequences):
        self.contig = contig
        self.positions = np.asarray(positions, np.int64)
        self.sequences = sequences
        self._center_bases = None

    @property
    def center_bases(self) -> np.ndarray:
        if self._center_bases is None:
            mid = NO_OF_POSITIONS // 2
            packed = getattr(self.sequences, "packed", None)
            if packed is not None:
                self._center_bases = packed[:, mid].copy().view("S1")
                return self._center_bases
            try:
                # one C-loop ascii encode of the whole list, then a strided
                # byte pick — the per-site genexpr+join this replaces was
                # the single largest cost of the ONT decode loop (~60%)
                arr = np.asarray(self.sequences, dtype="S")
                self._center_bases = (
                    arr.view(np.uint8)
                    .reshape(len(arr), arr.itemsize)[:, mid]
                    .copy()
                    .view("S1")
                )
            except (UnicodeEncodeError, IndexError):
                joined = "".join(s[mid] for s in self.sequences)
                self._center_bases = np.frombuffer(
                    joined.encode("ascii", "replace"), dtype="S1"
                )
        return self._center_bases

    def __len__(self) -> int:
        return len(self.positions)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return (self.contig, str(int(self.positions[i])), self.sequences[i])


def open_maybe_gzip(path: str, mode: str = "rt") -> IO:
    if path == "PIPE" or path == "-":
        return sys.stdin if "r" in mode else sys.stdout
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def parse_tensor_line(line: str) -> Tuple[TensorInfo, np.ndarray]:
    columns = line.split()
    info = (columns[0], columns[1], columns[2])
    tensor = np.array(columns[-INPUT_TENSOR_SIZE:], dtype=np.float32).reshape(
        NO_OF_POSITIONS, MATRIX_ROW, MATRIX_NUM
    )
    return info, tensor


def tensor_line_from(ctg_name: str, position: int, sequence: str, tensor: np.ndarray) -> str:
    flat = tensor.reshape(-1).astype(np.int64)
    return "%s %d %s %s" % (ctg_name, position, sequence, " ".join(map(str, flat)))


def normalize_channels(x: np.ndarray) -> np.ndarray:
    """In-place channel normalization: channels 1..3 -= channel 0."""
    x[..., 1:] -= x[..., 0:1]
    return x


def fits_byte(x: np.ndarray) -> bool:
    """True when every count fits uint8 exactly — the raw-uplink gate.

    Mirrors the native u8 store's per-cell predicate ((uint32_t)v > 255u
    refuses, clair_native.cpp) for the Python engine paths: both bounds
    are checked so an out-of-range value can never silently wrap through
    astype(np.uint8). Empty batches trivially fit."""
    return x.size == 0 or (float(x.max()) <= 255 and float(x.min()) >= 0)


def normalized_f32(x: np.ndarray) -> np.ndarray:
    """Channel-normalized float32 copy of a tensor batch.

    Identity (no copy) when x is already normalized float; converts a
    raw-uint8 counts batch (the device-normalized uplink representation)
    to the normalized form the host decode lattice and the ensemble dump
    expect. Counts are small integers, so the float arithmetic is exact
    and the result is bit-identical to normalizing before the float cast
    (ref utils.py:96-98 semantics)."""
    if x.dtype == np.uint8:
        return normalize_channels(x.astype(np.float32))
    return x


def tensor_batches_from(
    source, batch_size: int, show_progress: bool = False
) -> Iterator[Tuple[np.ndarray, List[TensorInfo]]]:
    """Yield (X, infos) batches from a tensor text stream.

    ``source`` is a file path ("PIPE"/"-" for stdin), an open file object,
    or an iterable of lines. X is channel-normalized (B, 33, 8, 4) float32;
    rows whose center reference base is not an IUPAC base are dropped
    (ref utils.py:90-91). The final batch may be smaller than batch_size.
    """
    close_after = False
    if isinstance(source, str):
        source = open_maybe_gzip(source)
        close_after = source is not sys.stdin

    processed = 0
    infos: List[TensorInfo] = []
    rows: List[str] = []
    centers: List[str] = []

    def flush():
        nonlocal infos, rows, centers, processed
        if not infos:
            return None
        # vectorized parse: one fromstring pass over the joined tensor columns
        flat = np.fromstring(" ".join(rows), dtype=np.float32, sep=" ")
        x = flat.reshape(len(infos), NO_OF_POSITIONS, MATRIX_ROW, MATRIX_NUM)
        normalize_channels(x)
        processed += len(infos)
        if show_progress:
            print("Processed %d tensors" % processed, file=sys.stderr)
        contig = infos[0][0]
        if any(info[0] != contig for info in infos):
            contig = None
        batch = (
            x,
            TensorInfos(
                infos,
                contig=contig,
                positions=np.array([info[1] for info in infos], np.int64),
                center_bases=np.array(centers, dtype="S1"),
            ),
        )
        infos, rows, centers = [], [], []
        return batch

    try:
        for line in source:
            columns = line.split(maxsplit=3)
            if len(columns) < 4:
                continue
            sequence = columns[2]
            center = sequence[NO_OF_POSITIONS // 2] if len(sequence) == NO_OF_POSITIONS else ""
            if center not in BASE2NUM:
                continue
            infos.append((columns[0], columns[1], sequence))
            rows.append(columns[3])
            centers.append(center)
            if len(infos) == batch_size:
                yield flush()
        tail = flush()
        if tail is not None:
            yield tail
    finally:
        if close_after:
            source.close()
