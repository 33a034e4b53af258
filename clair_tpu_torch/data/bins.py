"""Training bins: blocked, compressed tensor and label arrays (port of the
read and write side of clair_tpu/data/bins.py).

The same format, byte for byte: one protocol-4 pickle of ``{"magic",
"dataset_size", "block_size", "x_blocks", "y_blocks", "pos_blocks"}``, each
block an ``.npy`` payload (float32 blocks that round-trip through int16 are
stored as int16), compressed either as an LZ4S frame (byte-pair shuffle,
then LZ4-HC level 9 over the system liblz4, through ``clair_tpu.io.lz4``)
or, where liblz4 is missing, as one zstd frame at level 6. Either package
reads what the other wrote.

Three differences from the JAX module, all of dependencies: zstd goes
through the system libzstd (``clair_tpu_torch.io.zstd``), since the
``zstandard`` binding is not installed everywhere the port runs; an LZ4S
block read without liblz4 raises instead of falling back to the
pure-Python decoder; and the reference's own blosc bins are refused (the
blosc module is installed on neither machine the port runs on). Bins store
channel-normalized X blocks.
"""

from __future__ import annotations

import io as _io
import itertools
import os
import pickle
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from clair_tpu_torch.data.tensor_stream import normalize_channels, open_maybe_gzip
from clair_tpu_torch.io import lz4 as _lz4
from clair_tpu_torch.params import (
    BIN_BLOCK_SIZE,
    MATRIX_NUM,
    MATRIX_ROW,
    NO_OF_POSITIONS,
    PREDICT_BATCH_SIZE,
    TRAIN_BATCH_SIZE,
)
from clair_tpu_torch.task.labels import label_vector_from_reference, label_vector_from_truth
from clair_tpu_torch.utils import trace
from clair_tpu_torch.utils.genomics import BASE2ACGT, BASIC_BASES
from clair_tpu_torch.utils.intervals import BedIntervals
from clair_tpu_torch.io import zstd

# the JAX package's magics: v2 added int16 blocks, v3 LZ4S frames
MAGIC = "clair_tpu_bin_v3"
_KNOWN_MAGICS = {"clair_tpu_bin_v1", "clair_tpu_bin_v2", MAGIC}
_DUP_PREFIXES = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
# LZ4S block frame: magic, pad byte count (0/1), raw (shuffled) length as
# 4 little-endian bytes, then one LZ4 block
_LZ4S_MAGIC = b"LZ4S"
_ZSTD_LEVEL = 6
_NPY_MAGIC = b"\x93NUMPY"
# clair_tpu.io.lz4 marks the library as looked for before it has loaded it,
# so a thread asking while another loads it would be told it is missing
_LZ4_LOOKUP = threading.Lock()


def _lz4_available() -> bool:
    with _LZ4_LOOKUP:
        return _lz4.available()


def _pack(array: np.ndarray) -> bytes:
    """One block: int16 when a float32 block round-trips through it, LZ4S
    when liblz4 is there, else a zstd frame."""
    if array.dtype == np.float32:
        with np.errstate(invalid="ignore"):  # NaN/overflow fail the check below
            as_int = array.astype(np.int16)
        if np.array_equal(as_int.astype(np.float32), array):
            array = as_int
    buf = _io.BytesIO()
    np.save(buf, array, allow_pickle=False)
    payload = buf.getvalue()
    if _lz4_available():
        pad = len(payload) & 1
        if pad:
            payload += b"\x00"
        flat = np.frombuffer(payload, np.uint8)
        # byte-pair shuffle: all low bytes, then all high bytes
        shuffled = np.ascontiguousarray(flat.reshape(-1, 2).T).tobytes()
        return (_LZ4S_MAGIC + bytes([pad])
                + len(payload).to_bytes(4, "little")
                + _lz4.compress_hc(shuffled, level=9))
    return zstd.compress(payload, _ZSTD_LEVEL)


def _fast_npy(raw) -> np.ndarray:
    """Zero-copy reader of the C-order .npy v1.0 arrays _pack writes;
    anything else goes to np.load. Takes bytes or any buffer."""
    if not isinstance(raw, bytes):
        raw = memoryview(raw)
        head = bytes(raw[:10])
    else:
        head = raw[:10]
    if head[:6] != _NPY_MAGIC or head[6:8] != b"\x01\x00":
        return np.load(_io.BytesIO(bytes(raw)), allow_pickle=False)
    header_len = int.from_bytes(head[8:10], "little")
    header = bytes(raw[10:10 + header_len]).decode("latin1")
    try:
        descr_at = header.index("'descr':")
        q0 = header.index("'", descr_at + 8) + 1
        descr = header[q0:header.index("'", q0)]
        shape_at = header.index("'shape':")
        p0 = header.index("(", shape_at) + 1
        shape = tuple(
            int(x) for x in header[p0:header.index(")", p0)].split(",")
            if x.strip()
        )
        if "'fortran_order': False" not in header:
            raise ValueError
        return np.frombuffer(raw, dtype=np.dtype(descr), offset=10 + header_len).reshape(shape)
    except (ValueError, TypeError):
        return np.load(_io.BytesIO(bytes(raw)), allow_pickle=False)


def _unpack(blob: bytes, cast: bool = True) -> np.ndarray:
    if blob[:4] == _LZ4S_MAGIC:
        if not _lz4_available():
            raise RuntimeError(
                "this bin block is an LZ4S frame and the system liblz4 was not "
                "found; install liblz4 or rewrite the bin where liblz4 is missing "
                "(blocks are then zstd frames)"
            )
        pad = blob[4]
        raw_n = int.from_bytes(blob[5:9], "little")
        planes = _lz4.decompress(memoryview(blob)[9:], raw_n).reshape(2, raw_n // 2)
        # un-shuffle by u16 arithmetic (low | high << 8, little-endian bytes)
        interleaved = planes[1].astype("<u2")
        interleaved <<= 8
        interleaved |= planes[0]
        out = _fast_npy(interleaved.view(np.uint8)[: raw_n - pad])
    else:
        out = _fast_npy(zstd.decompress(blob))
    if cast and out.dtype == np.int16:
        return out.astype(np.float32)
    return out


@dataclass
class BinDataset:
    dataset_size: int
    x_blocks: List[bytes]
    y_blocks: List[bytes]
    pos_blocks: List[bytes]
    block_size: int = BIN_BLOCK_SIZE
    # set when train/val bins were concatenated (the split is by file)
    train_size_hint: Optional[int] = None

    @property
    def n_blocks(self) -> int:
        return len(self.x_blocks)

    def x_block(self, i: int, cast: bool = True) -> np.ndarray:
        return _unpack(self.x_blocks[i], cast=cast)

    def y_block(self, i: int, cast: bool = True) -> np.ndarray:
        return _unpack(self.y_blocks[i], cast=cast)

    def pos_block(self, i: int) -> np.ndarray:
        return _unpack(self.pos_blocks[i])


def write_bin(path: str, dataset: BinDataset) -> None:
    with open(path, "wb") as fh:
        pickle.dump(
            {
                "magic": MAGIC,
                "dataset_size": dataset.dataset_size,
                "block_size": dataset.block_size,
                "x_blocks": dataset.x_blocks,
                "y_blocks": dataset.y_blocks,
                "pos_blocks": dataset.pos_blocks,
            },
            fh,
            protocol=4,
        )


def load_bin(path: str) -> BinDataset:
    """Load a clair_tpu bin. Unpickles: load only bins this program or the
    JAX package wrote."""
    with open(path, "rb") as fh:
        head = pickle.load(fh)
    if not (isinstance(head, dict) and "magic" in head):
        raise ValueError(
            f"{path} is not a clair_tpu bin (the reference's blosc bins are read "
            "only by the JAX package, where the blosc module is installed)"
        )
    if head["magic"] not in _KNOWN_MAGICS:
        raise ValueError(
            f"{path} carries bin format {head['magic']!r}, which this "
            "version does not know; it was written by a newer clair_tpu"
        )
    return BinDataset(
        dataset_size=head["dataset_size"],
        x_blocks=head["x_blocks"],
        y_blocks=head["y_blocks"],
        pos_blocks=head["pos_blocks"],
        block_size=head["block_size"],
    )


def load_train_val_bins(train_path: str, validation_path: str) -> BinDataset:
    """Concatenate separate train and validation bins; the train size is
    recorded, so the split is by file rather than by percentage."""
    train = load_bin(train_path)
    val = load_bin(validation_path)
    return BinDataset(
        dataset_size=train.dataset_size + val.dataset_size,
        x_blocks=train.x_blocks + val.x_blocks,
        y_blocks=train.y_blocks + val.y_blocks,
        pos_blocks=train.pos_blocks + val.pos_blocks,
        block_size=train.block_size,
        train_size_hint=train.dataset_size,
    )


def combine_bins(paths: List[str], output_path: str) -> BinDataset:
    """Merge bins (the reference's CombineBins.py); a reference blosc bin is
    refused by load_bin."""
    datasets = [load_bin(p) for p in paths]
    merged = BinDataset(
        dataset_size=sum(d.dataset_size for d in datasets),
        x_blocks=[b for d in datasets for b in d.x_blocks],
        y_blocks=[b for d in datasets for b in d.y_blocks],
        pos_blocks=[b for d in datasets for b in d.pos_blocks],
        block_size=datasets[0].block_size,
    )
    write_bin(output_path, merged)
    return merged


def variant_map_from(var_fn: Optional[str], bed: BedIntervals) -> dict:
    """Truth-label map keyed 'ctg:pos' from GetTruth-format lines."""
    y = {}
    if var_fn is None:
        return y
    with open_maybe_gzip(var_fn) as fh:
        for row in fh:
            columns = row.split()
            ctg_name, position_str = columns[0], columns[1]
            if not (bed.is_empty or bed.contains_point(ctg_name, int(position_str))):
                continue
            y[ctg_name + ":" + position_str] = label_vector_from_truth(
                columns[2], columns[3], int(columns[4]), int(columns[5])
            )
    return y


def build_bin_from_tensors(
    tensor_fn: str,
    var_fn: Optional[str] = None,
    bed_fn: Optional[str] = None,
    shuffle: bool = True,
    is_allow_duplicate_chr_pos: bool = False,
    block_size: int = BIN_BLOCK_SIZE,
) -> BinDataset:
    """Join tensor lines with truth labels into a blocked bin. The shuffle
    draws from numpy's global generator, as the JAX package's does."""
    bed = BedIntervals.from_bed(bed_fn)
    y_map = variant_map_from(var_fn, bed)

    x_map = {}
    with open_maybe_gzip(tensor_fn) as fh:
        for row in fh:
            columns = row.split(maxsplit=3)
            if len(columns) < 4:
                continue
            chrom, coord, seq = columns[0], columns[1], columns[2].upper()
            if not (bed.is_empty or bed.contains_point(chrom, int(coord))):
                continue
            if seq[NO_OF_POSITIONS // 2] not in BASIC_BASES:
                continue
            x = np.fromstring(columns[3], dtype=np.float32, sep=" ").reshape(
                NO_OF_POSITIONS, MATRIX_ROW, MATRIX_NUM
            )
            normalize_channels(x)
            key = chrom + ":" + coord
            if key not in x_map:
                x_map[key] = x
            elif is_allow_duplicate_chr_pos:
                for ch in _DUP_PREFIXES:
                    if ch + key not in x_map:
                        x_map[ch + key] = x
                        break
            if key not in y_map:
                y_map[key] = label_vector_from_reference(BASE2ACGT[seq[NO_OF_POSITIONS // 2]])

    all_keys = sorted(x_map.keys())
    if shuffle:
        np.random.shuffle(all_keys)

    x_blocks, y_blocks, pos_blocks = [], [], []
    xs, ys, keys = [], [], []

    def flush():
        if not xs:
            return
        x_blocks.append(_pack(np.asarray(xs, dtype=np.float32)))
        y_blocks.append(_pack(np.asarray(ys, dtype=np.float32)))
        pos_blocks.append(_pack(np.asarray(keys)))
        xs.clear(), ys.clear(), keys.clear()

    total = 0
    for key in all_keys:
        # duplicate keys carry a one-char prefix and share the base truth label
        base_key = key if key in y_map else key[1:]
        xs.append(x_map[key])
        ys.append(y_map[base_key])
        keys.append(base_key)
        total += 1
        if len(xs) == block_size:
            flush()
    flush()

    return BinDataset(total, x_blocks, y_blocks, pos_blocks, block_size)


@dataclass
class EpochBatches:
    """One epoch: train batches first (never crossing the train/validation
    boundary), then validation batches, in ``block_order``.

    Blocks decompress on a thread pool (zstd and LZ4 release the interpreter
    lock) feeding a producer thread, so the host feed overlaps the device
    step. ``prefetch``: the batches the producer holds ready. The pool and
    the producer contend with the consumer's thread for the interpreter
    lock while they run, and they run flat out until the queue is full:
    a deep queue, filled anew at each epoch's start, slows the consumer's
    next several steps, and two batches ready already cover the time the
    producer takes to make the next. ``decompress_workers``: None = one per spare core, capped
    at 4; 0 = inline. ``cast_to_float32=False`` keeps int16-packed blocks
    in their stored dtype, for a consumer that casts on the device.

    Spans (utils/trace.py), each carrying the sequence number of the batch
    it serves: the consumer's ``feed.wait`` on the queue (value: the
    batch's index in the epoch; the first also holds the producer's start)
    with the queue's depth before the get as the counter ``feed.depth``,
    and ``feed.end`` for the epoch's end; the producer's ``feed.block_wait``
    on the decompress pool, ``feed.assemble`` of a batch from its blocks and
    ``feed.put_wait`` while the queue is full.
    """

    dataset: BinDataset
    block_order: np.ndarray
    n_train: int
    train_batch_size: int = TRAIN_BATCH_SIZE
    val_batch_size: int = PREDICT_BATCH_SIZE
    prefetch: int = 2
    decompress_workers: Optional[int] = None
    cast_to_float32: bool = True

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, bool]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        end = object()
        stop = threading.Event()

        # the sequence number of this epoch's first batch
        first = trace.batch() + 1

        def put(item) -> bool:
            try:
                q.put_nowait(item)
                return True
            except queue.Full:
                pass
            # a bounded put that notices an abandoned consumer
            with trace.span("feed.put_wait"):
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        return True
                    except queue.Full:
                        continue
            return False

        def producer():
            try:
                trace.set_batch(first)
                for item in self._generate():
                    if not put(item):
                        return
                    trace.set_batch(trace.batch() + 1)
                put(end)
            except BaseException as exc:  # raised again in the consumer
                put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        try:
            for index in itertools.count():
                with trace.span("feed.wait", index, first + index) as waited:
                    if index == 0:  # the epoch's first wait holds its restart
                        thread.start()
                    depth = q.qsize()
                    item = q.get()
                    if item is end or isinstance(item, BaseException):
                        waited.name, waited.value = "feed.end", None
                    else:
                        trace.set_batch(first + index)
                        trace.count("feed.depth", depth)
                if item is end:
                    break
                if isinstance(item, BaseException):
                    thread.join()
                    raise item
                yield item
        finally:
            stop.set()
            if thread.ident is not None:  # started
                thread.join()

    def _block_stream(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(x, y) block pairs in block_order, decompressed ahead on a pool
        and delivered in order (about two blocks per worker in flight)."""
        ds = self.dataset
        cast = self.cast_to_float32
        workers = self.decompress_workers
        if workers is None:
            workers = min(4, max((os.cpu_count() or 1) - 1, 0))
        if workers <= 0:
            for i in self.block_order:
                i = int(i)
                yield ds.x_block(i, cast=cast), ds.y_block(i, cast=cast)
            return

        def load(i: int):
            return ds.x_block(i, cast=cast), ds.y_block(i, cast=cast)

        block_iter = iter(self.block_order)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending: "deque" = deque()

            def submit() -> None:
                try:
                    i = int(next(block_iter))
                except StopIteration:
                    return
                pending.append(pool.submit(load, i))

            for _ in range(2 * workers):
                submit()
            while pending:
                with trace.span("feed.block_wait"):
                    x, y = pending.popleft().result()
                submit()
                yield x, y

    def _generate(self) -> Iterator[Tuple[np.ndarray, np.ndarray, bool]]:
        buffer_x: "deque" = deque()
        buffer_y: "deque" = deque()
        head_off = 0  # rows of the head block already emitted
        buffered = 0
        produced = 0
        blocks = self._block_stream()

        def fill(target: int) -> None:
            nonlocal buffered
            while buffered < target:
                try:
                    x, y = next(blocks)
                except StopIteration:
                    return
                buffer_x.append(x)
                buffer_y.append(y)
                buffered += len(x)

        def take(n: int):
            # block slices copied straight into a preallocated batch
            nonlocal buffered, head_off
            if head_off == 0 and len(buffer_x[0]) == n:
                buffered -= n
                return buffer_x.popleft(), buffer_y.popleft()
            x_dt = np.result_type(*(b.dtype for b in buffer_x))
            y_dt = np.result_type(*(b.dtype for b in buffer_y))
            out_x = np.empty((n,) + buffer_x[0].shape[1:], x_dt)
            out_y = np.empty((n,) + buffer_y[0].shape[1:], y_dt)
            got = 0
            while got < n:
                bx, by = buffer_x[0], buffer_y[0]
                k = min(n - got, len(bx) - head_off)
                out_x[got:got + k] = bx[head_off:head_off + k]
                out_y[got:got + k] = by[head_off:head_off + k]
                got += k
                head_off += k
                if head_off == len(bx):
                    buffer_x.popleft()
                    buffer_y.popleft()
                    head_off = 0
            buffered -= n
            return out_x, out_y

        while produced < self.n_train:
            want = min(self.train_batch_size, self.n_train - produced)
            fill(want)
            if buffered == 0:
                return
            n = min(want, buffered)
            with trace.span("feed.assemble"):
                x, y = take(n)
            produced += n
            yield x, y, True

        while True:
            fill(self.val_batch_size)
            if buffered == 0:
                return
            n = min(self.val_batch_size, buffered)
            with trace.span("feed.assemble"):
                x, y = take(n)
            yield x, y, False
