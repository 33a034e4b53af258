"""The calling Predictor on a torch device (port of the ``Predictor`` of
clair_tpu/pipeline/call_var.py), ``ShardedPredictor`` over several
devices (the JAX one shards a batch over a mesh; here each device holds
its own Predictor and takes an equal slice of the batch), and the host side of
calling around it: ``call_variants``, ``emit_batch`` and the per-batch
decode, the JAX file's own code.

The Predictor has the JAX Predictor's duck-typed surface -- ``batch_size``,
``eager_host_copy``, ``predict_async(x) -> (handle, n)``, ``gather`` and
``gather_group`` -- so the host runners (``call_bam.call_window``,
``call_bam_parallel.call_bam_windows_threaded``, ``call_variants``) take it
as they took the JAX one.

Link semantics are the JAX Predictor's: a batch is padded to
``batch_size``; raw uint8 counts ship as they are and are channel-normalized
on the device (``_device_input``); normalized float windows (over-byte
depth) ship as int16 (``_pack_uplink``). Both may arrive in one run.

On a CUDA device a batch goes host -> device from pinned memory without
blocking, runs the forward, and, with ``eager_host_copy``, starts its
(B, 90) result's copy into pinned host memory at once; ``gather`` waits on
the batch's event. With ``eager_host_copy`` off the copy happens in
``gather``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import IO, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clair_tpu_torch.data.tensor_stream import tensor_batches_from
from clair_tpu_torch.io.vcf import VcfWriter
from clair_tpu_torch.models.clair import ClairNet
from clair_tpu_torch.params import PREDICT_BATCH_SIZE, ModelConfig
from clair_tpu_torch.pipeline.decode import IndelSources, OutputConfig, decode_site
from clair_tpu_torch.task.labels import split_label_vector
from clair_tpu_torch.utils.genomics import BASIC_BASES

logging.basicConfig(format="%(message)s", level=logging.INFO)
logger = logging.getLogger(__name__)

# host decode worker threads for the native fast path (None = cpu count);
# settable via the --threads CLI flag (the reference's thread clamp,
# call_var.py:176-189)
DECODE_THREADS = None


@dataclass
class BatchSource:
    """Pre-built (x, infos) batches bypassing the text parser — the shape
    call_bam and the benchmarks feed."""

    batches: Iterator[Tuple[np.ndarray, List[Tuple[str, str, str]]]]


def _pack_uplink(x: np.ndarray, batch_size: int) -> np.ndarray:
    """Padded batch in link dtype: raw uint8 counts ship as-is (half the
    int16 cost; the device normalizes), anything else ships int16 —
    normalized pileup counts are integer-valued so the cast is exact
    within int16 range; extreme-depth columns (chrM, amplicons) are
    clipped at the limits, where the signal is saturated anyway."""
    n = x.shape[0]
    packed = x if x.dtype == np.uint8 else np.clip(x, -32767, 32767).astype(np.int16)
    if n < batch_size:
        pad = np.zeros((batch_size - n,) + x.shape[1:], dtype=packed.dtype)
        packed = np.concatenate([packed, pad], axis=0)
    return packed


def _device_input(x: torch.Tensor) -> torch.Tensor:
    """float32 model input from a link batch. Raw uint8 counts get the
    channel normalization (ch1..3 -= ch0) here; int16 batches arrive
    normalized. Counts are small integers, so this equals host
    normalization exactly."""
    xf = x.float()
    if x.dtype == torch.uint8:
        xf = torch.cat([xf[..., :1], xf[..., 1:] - xf[..., :1]], dim=-1)
    return xf


@dataclass
class Predictor:
    """Fixed-shape forward over padded batches on one torch device."""

    params: dict
    config: ModelConfig
    batch_size: int = PREDICT_BATCH_SIZE
    # start each batch's device->host copy at dispatch; the threaded WGS
    # runner turns it off and fetches in its consumer thread instead
    eager_host_copy: bool = True
    device: str = "cuda"

    def __post_init__(self):
        self._device = torch.device(self.device)
        self._cuda = self._device.type == "cuda"
        if self._cuda and not torch.cuda.is_available():
            raise RuntimeError(
                "Predictor(device='cuda') needs a CUDA device and "
                "torch.cuda.is_available() is false"
            )
        self.model = ClairNet.from_jax(self.params, self.config, self._device)

    def predict_async(self, x: np.ndarray):
        """Dispatch one (possibly short) batch; returns (handle, n)."""
        n = x.shape[0]
        link = torch.from_numpy(_pack_uplink(x, self.batch_size))
        if not self._cuda:
            with torch.inference_mode():
                return (torch.cat(self.model(_device_input(link)), dim=-1), None), n
        # everything on this Predictor's device and its current stream
        with torch.cuda.device(self._device), torch.inference_mode():
            x_dev = link.pin_memory().to(self._device, non_blocking=True)
            out = torch.cat(self.model(_device_input(x_dev)), dim=-1)
            if not self.eager_host_copy:
                return (out, None), n
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return (host, done), n

    def gather(self, handle, n: int):
        """The batch's (n, 90) output split into the four head arrays."""
        out, done = handle
        if done is not None:
            done.synchronize()
        return split_label_vector(out[:n].cpu().numpy())

    def gather_group(self, handles: Sequence, ns: Sequence[int]) -> List[Tuple]:
        """Per-batch head arrays of several batches, in order."""
        return [self.gather(h, n) for h, n in zip(handles, ns)]


class ShardedPredictor:
    """A Predictor per device (by default cuda:0 .. cuda:N-1 of the visible
    cards), with the Predictor's surface. ``batch_size`` is rounded up to a
    multiple of N; each padded batch is cut into N equal slices and
    slice i dispatched on device i, on its current stream, without waiting
    for the others; ``gather`` concatenates the slices' outputs in order.
    Inference is a pure map, so no collective is needed. The devices may
    repeat (several Predictors on one card) or be the CPU."""

    def __init__(self, params: dict, config: ModelConfig,
                 batch_size: int = PREDICT_BATCH_SIZE,
                 devices: Optional[Sequence[str]] = None):
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("ShardedPredictor needs a device and no CUDA device is visible")
        self.devices = list(devices)
        self._per = -(-batch_size // len(self.devices))
        self.batch_size = self._per * len(self.devices)
        self.config = config
        self.predictors = [Predictor(params, config, self._per, device=d) for d in self.devices]

    @property
    def eager_host_copy(self) -> bool:
        return self.predictors[0].eager_host_copy

    @eager_host_copy.setter
    def eager_host_copy(self, value: bool) -> None:
        for predictor in self.predictors:
            predictor.eager_host_copy = value

    def predict_async(self, x: np.ndarray):
        """Dispatch one (possibly short) batch, a slice on each device;
        returns (handle, n)."""
        n = x.shape[0]
        handles = [p.predict_async(x[i * self._per:(i + 1) * self._per])
                   for i, p in enumerate(self.predictors)]
        return handles, n

    def gather(self, handle, n: int):
        """The batch's (n, 90) output split into the four head arrays."""
        parts = [p.gather(h, k) for p, (h, k) in zip(self.predictors, handle)]
        return tuple(np.concatenate(head) for head in zip(*parts))

    def gather_group(self, handles: Sequence, ns: Sequence[int]) -> List[Tuple]:
        """Per-batch head arrays of several batches, in order."""
        return [self.gather(h, n) for h, n in zip(handles, ns)]


def call_variants(
    tensor_source,
    predictor: Predictor,
    output_config: OutputConfig,
    vcf_writer: VcfWriter,
    indel_sources: IndelSources = IndelSources(),
    batch_size: Optional[int] = None,
    debug_fh: Optional[IO] = None,
) -> int:
    """Stream tensors -> batched TPU inference -> per-site decode -> VCF.

    Returns the number of sites processed.
    """
    batch_size = batch_size or predictor.batch_size
    start_time = time.time()
    total = 0

    if isinstance(tensor_source, BatchSource):
        batches = tensor_source.batches
    else:
        batches = tensor_batches_from(tensor_source, batch_size)

    pending = None  # (infos, x, device_out, n)
    for x, infos in batches:
        out, n = predictor.predict_async(x)  # dispatch batch N (async)
        if pending is not None:
            _decode_batch(pending, predictor, output_config, vcf_writer, indel_sources, debug_fh)
            total += pending[3]
        pending = (infos, x, out, n)
    if pending is not None:
        _decode_batch(pending, predictor, output_config, vcf_writer, indel_sources, debug_fh)
        total += pending[3]

    logger.info("Total time elapsed: %.2f s" % (time.time() - start_time))
    return total


def emit_batch(pending, gatherer, output_config, writer, indel_sources,
               debug_fh=None) -> int:
    """Decode ONE pending (infos, x, out, n) batch to the writer: VCF rows,
    or tensor+probability dump rows when output_config is in ensemble mode.
    The shared flush used by both the per-window runner (call_bam) and the
    threaded WGS runner (call_bam_parallel) — `gatherer` is anything with
    .gather(out, n) -> 4 head arrays (a Predictor, or a pre-gathered shim)."""
    infos, x, out, n = pending
    if x is not None and x.dtype == np.uint8:
        # raw-uint8 uplink batches (WindowWork.tensors): the decode
        # lattice and the ensemble dump both expect the channel-normalized
        # form — normalize the one batch here (exact; see normalized_f32)
        from clair_tpu_torch.data.tensor_stream import normalized_f32

        pending = (infos, normalized_f32(x), out, n)
        infos, x, out, n = pending
    if output_config.is_output_for_ensemble:
        infos_list = [
            (infos.contig, int(infos.positions[i]), infos.sequences[i])
            for i in range(n)
        ]
        write_ensemble_rows(x, infos_list, gatherer.gather(out, n), n,
                            writer._fh)
    else:
        _decode_batch(pending, gatherer, output_config, writer,
                      indel_sources, debug_fh)
    return n


def _decode_batch(pending, predictor, output_config, vcf_writer, indel_sources, debug_fh):
    from clair_tpu_torch.pipeline.batch_decode import decode_batch

    infos, x, out, n = pending
    gt21_p, genotype_p, vl1_p, vl2_p = predictor.gather(out, n)

    if not output_config.is_debug and _native_decode_batch(
        infos, x, n, gt21_p, genotype_p, vl1_p, vl2_p,
        output_config, vcf_writer, indel_sources,
    ):
        return

    rows = []
    for i, call in decode_batch(
        x[:n], infos[:n], gt21_p, genotype_p, vl1_p, vl2_p,
        output_config, indel_sources,
    ):
        chromosome, position_str, _ = infos[i]
        if output_config.is_debug and debug_fh is not None:
            print(
                "{}\t{}\t{}\t{}\t{}\t{}\t{}".format(
                    chromosome, position_str,
                    ["{:0.8f}".format(v) for v in gt21_p[i]],
                    ["{:0.8f}".format(v) for v in genotype_p[i]],
                    ["{:0.8f}".format(v) for v in vl1_p[i]],
                    ["{:0.8f}".format(v) for v in vl2_p[i]],
                    "Reference" if call.is_reference else "Normal output",
                ),
                file=debug_fh,
            )
            continue
        rows.append((chromosome, int(position_str), call))
    vcf_writer.write_sites(rows)


def _native_decode_batch(
    infos, x, n, gt21_p, genotype_p, vl1_p, vl2_p,
    output_config, vcf_writer, indel_sources,
) -> bool:
    """Fast path: C++ decode of ref/SNP winners + exact Python lattice for
    the indel fallback sites, merged in site order. Returns False when the
    native library is unavailable or the batch spans contigs."""
    from clair_tpu_torch import native

    if not native.available():
        return False
    # Vectorized batch metadata (TensorInfos) skips the per-site tuple walk
    # that capped decode at ~1M sites/s; plain info lists take the slow path.
    contig = getattr(infos, "contig", None)
    positions = getattr(infos, "positions", None)
    center_bases = getattr(infos, "center_bases", None)
    if contig is None:
        contig = infos[0][0]
        if any(info[0] != contig for info in infos[:n]):
            return False

    from clair_tpu_torch.pipeline.batch_decode import _CATEGORY_NAMES, category_maxima

    if positions is None:
        positions = np.fromiter((int(info[1]) for info in infos[:n]), np.int64, count=n)
    else:
        positions = positions[:n]
    if center_bases is None:
        center_bases = [info[2][len(info[2]) // 2] for info in infos[:n]]
    else:
        center_bases = center_bases[:n]
    # packed reference windows let the native decoder assemble the
    # callback-free indel categories too (het ins+ins and >=16bp recovery
    # stay on the exact Python path); use_bam_for_all forces every indel
    # through the Python chain, so skip native indel assembly there
    sequences = None
    if not indel_sources.use_bam_for_all:
        sequences = getattr(infos, "sequences", None)
        if sequences is None:
            sequences = [info[2] for info in infos[:n]]
        else:
            sequences = sequences[:n]
    result = native.decode_fast_native(
        x[:n], gt21_p, genotype_p, vl1_p, vl2_p, positions, center_bases, contig,
        show_ref=output_config.is_show_reference,
        haploid_precision=output_config.is_haploid_precision_mode_enabled,
        haploid_sensitive=output_config.is_haploid_sensitive_mode_enabled,
        qual_cutoff=output_config.quality_score_for_pass,
        sequences=sequences,
        threads=DECODE_THREADS,
        has_insertion_source=indel_sources.insertion_bases is not None,
    )
    if result is None:
        return False
    rows_text, row_sites, fallback = result

    fallback_rows = {}
    if len(fallback):
        from clair_tpu_torch.pipeline.batch_decode import batch_decode_indels
        from clair_tpu_torch.task.gt21 import gt21_code_from_label
        from clair_tpu_torch.utils.genomics import BASE2ACGT

        idx = fallback
        ref_codes = np.array([
            gt21_code_from_label(
                BASE2ACGT.get(
                    center_bases[i].decode()
                    if isinstance(center_bases[i], bytes)
                    else center_bases[i],
                    "A",
                )
                * 2
            )
            for i in idx
        ])
        winners = category_maxima(
            gt21_p[idx], genotype_p[idx], vl1_p[idx], vl2_p[idx], ref_codes
        ).argmax(axis=0)

        batch_sequences = getattr(infos, "sequences", None)
        if batch_sequences is not None:
            seqs = [batch_sequences[i] for i in idx.tolist()]
        else:
            seqs = [infos[i][2] for i in idx.tolist()]
        fb_positions = positions[idx]
        for k, call in batch_decode_indels(
            x[idx], seqs, contig, fb_positions,
            gt21_p[idx], genotype_p[idx], vl1_p[idx], vl2_p[idx],
            [_CATEGORY_NAMES[w] for w in winners],
            output_config, indel_sources,
        ):
            i = int(idx[k])
            fallback_rows[i] = vcf_writer.format_site(
                contig, int(fb_positions[k]), call
            )

    if not fallback_rows:
        if rows_text:
            vcf_writer.write_raw(rows_text)
        return True

    merged = []
    native_rows = rows_text.splitlines()
    native_iter = iter(zip(row_sites.tolist(), native_rows))
    pending_native = next(native_iter, None)
    for i in sorted(set(fallback_rows) | set(row_sites.tolist())):
        if pending_native is not None and pending_native[0] == i:
            merged.append(pending_native[1])
            pending_native = next(native_iter, None)
        elif i in fallback_rows:
            merged.append(fallback_rows[i])
    if merged:
        vcf_writer.write_raw("\n".join(merged) + "\n")
    return True


def call_variants_for_ensemble(
    tensor_source,
    predictor: Predictor,
    output_fh: IO,
    batch_size: Optional[int] = None,
) -> int:
    """Ensemble output mode: dump tensor + the 4 probability vectors per
    site (ref call_var.py:950-1000) for the ensemble combiner."""
    batch_size = batch_size or predictor.batch_size
    total = 0
    for x, infos in tensor_batches_from(tensor_source, batch_size):
        out, n = predictor.predict_async(x)
        total += write_ensemble_rows(
            x, infos, predictor.gather(out, n), n, output_fh
        )
    return total


def write_ensemble_rows(x, infos, probs, n, output_fh) -> int:
    """Ensemble-mode rows: contig, position, 33-mer, tensor ints, and the
    90 probabilities at 6 decimals (ref call_var.py:950-1000)."""
    gt21_p, genotype_p, vl1_p, vl2_p = probs
    total = 0
    for i in range(n):
        chromosome, position_str, sequence = infos[i]
        if sequence[len(sequence) // 2] not in BASIC_BASES:
            continue
        tensor_str = "\t".join(x[i].reshape(-1).astype(int).astype(str))
        prob_cols = [
            "{:0.6f}".format(p)
            for vec in (gt21_p[i], genotype_p[i], vl1_p[i], vl2_p[i])
            for p in vec
        ]
        print(
            "\t".join([chromosome, str(position_str), sequence, tensor_str]
                       + prob_cols),
            file=output_fh,
        )
        total += 1
    return total


def call_variants_from_probabilities(
    rows: Iterator[str],
    output_config: OutputConfig,
    vcf_writer: VcfWriter,
    indel_sources: IndelSources = IndelSources(),
) -> int:
    """Re-decode mode: rows carry tensor + probabilities (the ensemble
    combiner's output), no model needed (ref call_var.py:1276-1309)."""
    from clair_tpu_torch.params import INPUT_TENSOR_SIZE, MATRIX_NUM, MATRIX_ROW, NO_OF_POSITIONS

    total = 0
    for row in rows:
        columns = row.split("\t")
        chromosome, position, sequence = columns[0], columns[1], columns[2]
        x = np.array(columns[3:3 + INPUT_TENSOR_SIZE], dtype=np.float32).reshape(
            NO_OF_POSITIONS, MATRIX_ROW, MATRIX_NUM
        )
        probabilities = np.array(columns[3 + INPUT_TENSOR_SIZE:], dtype=np.float32)
        gt21_p, genotype_p, vl1_p, vl2_p = split_label_vector(probabilities)
        call = decode_site(
            x, chromosome, int(position), sequence,
            gt21_p, genotype_p, vl1_p, vl2_p, output_config, indel_sources,
        )
        if call is not None:
            vcf_writer.write_site(chromosome, int(position), call)
        total += 1
    return total
