"""Whole-genome fan-out (callVarBamParallel equivalent).

The reference prints one shell command per 10Mb window for GNU parallel
(reference clair/callVarBamParallel.py:90-119). Here windows become
in-process work items executed either sequentially, by a local process
pool, or (compat mode) emitted as a command sheet. On a TPU slice the
model forward is batched across windows on the chip while window pileups
run on host workers — the share-nothing chunk model the reference proves
out, minus the process-pipe overhead.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import time
from typing import Dict, Iterator, List, Optional, Set, TextIO, Tuple

from clair_tpu_torch.io.fasta import FastaReader
from clair_tpu_torch.pipeline.call_bam import CallBamConfig, call_bam
from clair_tpu_torch.utils.intervals import BedIntervals

logger = logging.getLogger(__name__)

# batches kept in flight across window boundaries in the threaded WGS
# runner (the producer->consumer queue bound). The consumer fetches
# results GROUPED — one stacked device->host transfer per group (a
# transfer costs a ~250 ms round trip on the remote link regardless of
# size), and while it blocks on that round trip the producer keeps
# dispatching, so up to this many batches accumulate to ride the next
# fetch. The TPU-native answer to the reference's 3-thread software
# pipeline (reference clair/call_var.py:1331-1353).
WGS_INFLIGHT_DEPTH = 32


@dataclasses.dataclass
class PipelineStats:
    """Per-batch device-leg latency decomposition for the threaded WGS
    runner. ``dispatch_s`` is the host-side cost of padding + enqueueing a
    batch (predict_async), ``fetch_s`` each grouped blocking device->host
    transfer (~one link round trip), ``wait_s`` the same time amortized
    per batch, ``decode_s`` the host lattice decode + VCF row emission, and
    ``prepare_s`` per-window host pileup wall seconds (on pool threads, so
    they overlap the rest)."""

    dispatch_s: List[float] = dataclasses.field(default_factory=list)
    fetch_s: List[float] = dataclasses.field(default_factory=list)
    wait_s: List[float] = dataclasses.field(default_factory=list)
    decode_s: List[float] = dataclasses.field(default_factory=list)
    prepare_s: List[float] = dataclasses.field(default_factory=list)
    # bytes of the padded int16 batches dispatched and of the stacked
    # (k, B, 90) float32 probabilities fetched
    dispatch_bytes: List[int] = dataclasses.field(default_factory=list)
    fetch_bytes: List[int] = dataclasses.field(default_factory=list)

    def summary(self) -> Dict[str, float]:
        import numpy as np

        def pct(values, q):
            return round(float(np.percentile(values, q)) * 1e3, 3) if values else 0.0

        return {
            "batches": len(self.wait_s),
            "windows": len(self.prepare_s),
            "fetches": len(self.fetch_s),
            "uplink_mb": round(sum(self.dispatch_bytes) / 1e6, 2),
            "downlink_mb": round(sum(self.fetch_bytes) / 1e6, 2),
            "fetch_ms_p50": pct(self.fetch_s, 50),
            "fetch_ms_p99": pct(self.fetch_s, 99),
            "device_wait_ms_p50": pct(self.wait_s, 50),
            "device_wait_ms_p90": pct(self.wait_s, 90),
            "device_wait_ms_p99": pct(self.wait_s, 99),
            "device_wait_s_total": round(sum(self.fetch_s), 3),
            "dispatch_s_total": round(sum(self.dispatch_s), 3),
            "decode_s_total": round(sum(self.decode_s), 3),
            "prepare_s_total": round(sum(self.prepare_s), 3),
        }


@dataclasses.dataclass
class _WindowState:
    """Decode-side bookkeeping for one window's batches in the global
    in-flight queue."""

    window: Tuple[str, int, int]
    work: object  # WindowWork, or None when prepare failed
    started: float
    batches: int = 0
    sites: int = 0
    failed: Optional[str] = None
    began: bool = False


class JobLog:
    """Per-window failure audit + resume manifest.

    The in-process equivalent of the reference's GNU parallel `--joblog`
    Exitval workflow and trailing-newline completeness check
    (reference README.md:299-300, docs/TRAIN.md:58-59): one JSON line
    per finished window ({window, status, sites, output, error, elapsed}),
    flushed immediately so a killed run leaves a machine-readable record.
    Re-running with resume=True skips windows already logged ok.
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def completed(self) -> Set[Tuple[str, int, int]]:
        """Windows recorded ok in an existing log (empty when absent)."""
        done: Set[Tuple[str, int, int]] = set()
        if not os.path.isfile(self.path):
            return done
        with open(self.path) as fh:
            for line in fh:
                try:
                    entry = json.loads(line)
                except ValueError:
                    continue  # torn write from a killed run
                if entry.get("status") == "ok":
                    ctg, start, end = entry["window"]
                    done.add((ctg, int(start), int(end)))
        return done

    def record(
        self,
        window: Tuple[str, int, int],
        status: str,
        sites: int = 0,
        output: Optional[str] = None,
        error: Optional[str] = None,
        elapsed: float = 0.0,
    ) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a")
        entry = {
            "window": list(window),
            "status": status,
            "sites": sites,
            "elapsed": round(elapsed, 3),
        }
        if output is not None:
            entry["output"] = output
        if error is not None:
            entry["error"] = error
        self._fh.write(json.dumps(entry) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def vcf_is_complete(path: str) -> bool:
    """Trailing-newline completeness check (ref README.md:299-300)."""
    try:
        with open(path, "rb") as fh:
            fh.seek(0, 2)
            if fh.tell() == 0:
                return False
            fh.seek(-1, 2)
            return fh.read(1) == b"\n"
    except OSError:
        return False

# chr1-22,X,Y with and without "chr" (ref callVarBamParallel.py:15)
MAJOR_CONTIGS = (
    [f"chr{i}" for i in list(range(1, 23)) + ["X", "Y"]]
    + [str(i) for i in list(range(1, 23)) + ["X", "Y"]]
)
DEFAULT_CHUNK_SIZE = 10_000_000


def genome_windows(
    fasta: FastaReader,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    include_all_contigs: bool = False,
    bed: Optional[BedIntervals] = None,
    num_shards: int = 1,
    shard_id: int = 0,
) -> Iterator[Tuple[str, int, int]]:
    """(contig, ctg_start, ctg_end) 1-based inclusive windows, BED-filtered.

    num_shards/shard_id deterministically partition the window list for
    multi-host WGS: each host takes windows where index % num_shards ==
    shard_id (round-robin balances long contigs across hosts). Windows are
    share-nothing, so hosts need no coordination beyond merging VCFs —
    the DCN-level scale-out mirror of the reference's GNU-parallel model.
    """
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
    whitelist = set(MAJOR_CONTIGS)
    index = 0
    for contig, length in fasta.contigs:
        if not include_all_contigs and contig not in whitelist:
            continue
        chunks = -(-length // chunk_size)
        for i in range(chunks):
            start = i * chunk_size + 1
            end = min((i + 1) * chunk_size, length)
            if bed is not None and not bed.is_empty:
                if not bed.overlaps_range(contig, start - 1, end):
                    continue
            if index % num_shards == shard_id:
                yield contig, start, end
            index += 1


def _run_window(args_tuple):
    """Worker entry: build a predictor in-process, on the torch device the
    work carries, and call one window. Exceptions come back as data so one
    bad window can't sink the pool. The last field is the kernels' launches
    in this window (ops.launch_counts), which the parent sums."""
    from clair_tpu_torch.ops import launch_counts, launches_since

    base_config, checkpoint_path, window, output_prefix, device = args_tuple
    contig, start, end = window
    path = f"{output_prefix}.{contig}_{start}_{end}.vcf"
    started = time.perf_counter()
    before = launch_counts()
    try:
        from clair_tpu_torch.models.checkpoint import load_checkpoint
        from clair_tpu_torch.params import PREDICT_COMPUTE_DTYPE, ModelConfig
        from clair_tpu_torch.pipeline.call_var import Predictor

        params, _ = load_checkpoint(checkpoint_path)
        predictor = Predictor(
            params, ModelConfig(compute_dtype=PREDICT_COMPUTE_DTYPE), device=device
        )
        config = dataclasses.replace(
            base_config, contig=contig, ctg_start=start, ctg_end=end
        )
        sites = call_bam(config, predictor, output_path=path)
        return (path, window, sites, None, time.perf_counter() - started,
                launches_since(before))
    except Exception as exc:
        return (
            path, window, 0, f"{type(exc).__name__}: {exc}",
            time.perf_counter() - started, launches_since(before),
        )


def call_bam_parallel(
    base_config: CallBamConfig,
    predictor_factory,
    output_prefix: str,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    include_all_contigs: bool = False,
    max_workers: int = 1,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    joblog_path: Optional[str] = None,
    num_shards: int = 1,
    shard_id: int = 0,
    device: str = "cuda",
    worker_launches: Optional[Dict[str, int]] = None,
) -> List[str]:
    """Run call_bam over every genome window; returns the per-window VCF
    paths (merge with merge_vcfs).

    With max_workers > 1 (requires checkpoint_path), window pileups run on
    a process pool — each worker has its own predictor on ``device``,
    keeping the device saturated while host pileups proceed in parallel
    (the reference's GNU-parallel share-nothing model, in-process).

    ``worker_launches``, when given, receives the pool workers' kernel
    launches, summed over the windows (the command's JSON line adds them to
    its own process's).

    Every window's outcome lands in a JobLog next to the outputs; a failed
    window is recorded and skipped (the run continues), and resume=True
    re-runs only windows not yet logged ok.
    """
    fasta = FastaReader(base_config.fasta_path)
    bed = BedIntervals.from_bed(base_config.bed_path) if base_config.bed_path else None
    all_windows = list(genome_windows(
        fasta, chunk_size, include_all_contigs, bed, num_shards, shard_id
    ))
    fasta.close()

    joblog = JobLog(joblog_path or output_prefix + ".joblog")
    done = joblog.completed() if resume else set()
    # path per completed window, keyed so the returned list stays in genome
    # order even when a resume re-runs a middle window (merge_vcfs
    # concatenates in list order — out-of-order rows would unsort the VCF)
    finished = {
        w: f"{output_prefix}.{w[0]}_{w[1]}_{w[2]}.vcf"
        for w in all_windows if w in done
    }
    windows = [w for w in all_windows if w not in done]
    failures = []

    def finish(window, path, sites, error, elapsed):
        if error is None and not vcf_is_complete(path):
            error = "output VCF has no trailing newline (incomplete)"
        if error is None:
            joblog.record(window, "ok", sites=sites, output=path, elapsed=elapsed)
            finished[window] = path
        else:
            joblog.record(window, "failed", output=path, error=error, elapsed=elapsed)
            failures.append((window, error))
            logger.error("window %s:%d-%d FAILED: %s", *window, error)

    if max_workers > 1 and checkpoint_path is not None:
        import multiprocessing

        from clair_tpu_torch.ops import add_launches

        context = multiprocessing.get_context("spawn")
        with context.Pool(max_workers) as pool:
            work = [
                (base_config, checkpoint_path, window, output_prefix, device)
                for window in windows
            ]
            for path, window, sites, error, elapsed, launches in pool.imap(_run_window, work):
                if worker_launches is not None:
                    add_launches(worker_launches, launches)
                if error is None:
                    logger.info("window %s:%d-%d -> %d sites", *window, sites)
                finish(window, path, sites, error, elapsed)
    else:
        predictor = predictor_factory()
        for window in windows:
            contig, start, end = window
            config = dataclasses.replace(
                base_config, contig=contig, ctg_start=start, ctg_end=end
            )
            path = f"{output_prefix}.{contig}_{start}_{end}.vcf"
            started = time.perf_counter()
            try:
                sites = call_bam(config, predictor, output_path=path)
                error = None
            except Exception as exc:  # keep calling the rest of the genome
                sites, error = 0, f"{type(exc).__name__}: {exc}"
            elapsed = time.perf_counter() - started
            if error is None:
                logger.info("window %s:%d-%d -> %d sites", contig, start, end, sites)
            finish(window, path, sites, error, elapsed)

    joblog.close()
    if failures:
        logger.error(
            "%d window(s) failed; re-run with resume=True (or --resume) to "
            "retry only those — audit log: %s", len(failures), joblog.path,
        )
    return [finished[w] for w in all_windows if w in finished]


def emit_command_sheet(
    fasta_path: str,
    bam_path: str,
    checkpoint_path: str,
    output_prefix: str,
    output: TextIO = sys.stdout,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    include_all_contigs: bool = False,
    bed_path: Optional[str] = None,
    extra_flags: str = "",
) -> int:
    """Compat mode: print one `python -m clair_tpu_torch call_bam ...` command per
    window for GNU parallel / xargs, like the reference."""
    fasta = FastaReader(fasta_path)
    bed = BedIntervals.from_bed(bed_path) if bed_path else None
    n = 0
    for contig, start, end in genome_windows(fasta, chunk_size, include_all_contigs, bed):
        print(
            f"python -m clair_tpu_torch call_bam --bam_fn {bam_path} --ref_fn {fasta_path}"
            f" --chkpnt_fn {checkpoint_path} --ctgName {contig}"
            f" --ctgStart {start} --ctgEnd {end}"
            f" --call_fn {output_prefix}.{contig}_{start}_{end}.vcf"
            + ((" " + extra_flags) if extra_flags else ""),
            file=output,
        )
        n += 1
    fasta.close()
    return n


def call_bam_windows_threaded(
    base_config: CallBamConfig,
    predictor,
    output_path: str,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    include_all_contigs: bool = False,
    pileup_workers: int = 4,
    prefetch: int = 2,
    resume: bool = False,
    joblog_path: Optional[str] = None,
    num_shards: int = 1,
    shard_id: int = 0,
    inflight_depth: Optional[int] = None,
    stats: Optional[PipelineStats] = None,
) -> int:
    """Single-process WGS runner: ONE predictor owns the device while
    window pileups run on a thread pool (numpy releases the GIL in the hot
    loops). Windows are consumed in genome order into one merged VCF.

    Batches stay in flight ACROSS window boundaries (bounded queue of
    ``inflight_depth``, default WGS_INFLIGHT_DEPTH): dispatching window
    k+1's batches proceeds while window k's results are still crossing the
    link, so per-batch round trips overlap host pileup and decode instead
    of serializing at every window edge. Pass a PipelineStats to record the
    per-batch latency decomposition.

    This is the preferred topology for a host attached to one chip — the
    process-pool mode exists for multi-chip hosts where each worker can own
    a device.

    Per-window outcomes land in a JobLog (failures are recorded and the run
    continues). resume=True appends only windows not yet logged ok — rows
    then arrive out of genome order; sort or re-merge afterwards if order
    matters downstream.
    """
    import concurrent.futures
    import sys

    from clair_tpu_torch.pipeline.call_bam import prepare_window

    gz_path = None
    if output_path and output_path.endswith(".gz"):
        # stream plain text while windows run (resume needs an appendable,
        # truncatable file); compress + tabix-index once every window lands
        gz_path = output_path
        output_path = output_path[: -len(".gz")]

    fasta = FastaReader(base_config.fasta_path)
    bed = BedIntervals.from_bed(base_config.bed_path) if base_config.bed_path else None
    windows = list(genome_windows(
        fasta, chunk_size, include_all_contigs, bed, num_shards, shard_id
    ))
    contigs = fasta.contigs
    fasta.close()

    joblog = JobLog(
        joblog_path or ((output_path or "call_bam_windows") + ".joblog")
    )
    appending = False
    if resume:
        done = joblog.completed()
        windows = [w for w in windows if w not in done]
        if (gz_path and not windows and os.path.isfile(gz_path)
                and not os.path.isfile(output_path)):
            # the previous run already finished, compressed, and removed
            # the plain stream; rebuilding from zero windows would replace
            # the complete .gz with a header-only file
            logger.info("resume: %s already complete", gz_path)
            joblog.close()
            return 0
        appending = bool(output_path) and os.path.isfile(output_path) and bool(done)
        if appending and not vcf_is_complete(output_path):
            # a kill mid-flush can leave a torn final line; drop it so the
            # re-run's first row doesn't concatenate onto a partial record
            with open(output_path, "rb+") as fh:
                data = fh.read()
                cut = data.rfind(b"\n") + 1
                fh.truncate(cut)

    output_fh = (
        open(output_path, "a" if appending else "w") if output_path else sys.stdout
    )
    from clair_tpu_torch.io.vcf import make_writer

    writer = make_writer(base_config, output_fh, contigs=contigs)
    if not appending:
        writer.write_header()

    total = 0
    failures = 0
    depth = WGS_INFLIGHT_DEPTH if inflight_depth is None else max(1, inflight_depth)
    import queue as queue_mod
    import threading

    from clair_tpu_torch.data.tensor_stream import LazyTensorInfos
    from clair_tpu_torch.pipeline.call_var import emit_batch

    class _PreGathered:
        """gather() shim: the consumer fetches probabilities itself (to
        time the device wait separately from decode), so _decode_batch
        receives them pre-split."""

        @staticmethod
        def gather(out, n):
            return out

    def _timed_prepare(config):
        t0 = time.perf_counter()
        work = prepare_window(config)
        return work, time.perf_counter() - t0

    gather_group = getattr(predictor, "gather_group", None)
    if gather_group is None:
        def gather_group(outs, ns):
            return [predictor.gather(o, n) for o, n in zip(outs, ns)]
    # the WGS runner fetches results grouped (one stacked transfer per
    # group); an eager per-batch host copy would ship every result over
    # the link a second time
    had_eager = getattr(predictor, "eager_host_copy", None)
    if had_eager is not None:
        predictor.eager_host_copy = False

    # Producer (this thread): window iteration, pileup futures, device
    # dispatch. Consumer thread: grouped device->host fetch, decode, VCF,
    # joblog. The bounded queue is the in-flight batch budget: while the
    # consumer blocks ~a link round trip per grouped fetch, the producer
    # keeps dispatching, and whatever accumulates in the queue rides the
    # NEXT fetch — group sizes adapt to the link's actual latency.
    work_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    _DONE = object()
    fatal: List[BaseException] = []

    current: List[Optional[_WindowState]] = [None]  # consumer-side cursor

    def finish_window(ws: _WindowState) -> None:
        nonlocal total, failures
        elapsed = time.perf_counter() - ws.started
        fasta = getattr(ws.work, "_fasta_to_close", None)
        if fasta is not None:
            fasta.close()
        if ws.failed is not None:
            failures += 1
            joblog.record(ws.window, "failed", error=ws.failed, elapsed=elapsed)
            logger.error("window %s:%d-%d FAILED: %s", *ws.window, ws.failed)
        else:
            joblog.record(
                ws.window, "ok", sites=ws.sites, output=output_path,
                elapsed=elapsed,
            )
            logger.info("window %s:%d-%d -> %d sites", *ws.window, ws.sites)
            total += ws.sites

    def close_current() -> None:
        ws = current[0]
        if ws is None:
            return
        if ws.began:
            try:
                if ws.failed is not None:
                    # never flush a failed window: partial variant rows
                    # (and gVCF hom-ref blocks over undecoded candidates)
                    # would land in the output, then --resume would append
                    # the full window again — double coverage
                    writer.abandon_window()
                else:
                    writer.end_window()
            except Exception as exc:
                ws.failed = ws.failed or f"{type(exc).__name__}: {exc}"
        finish_window(ws)
        try:
            output_fh.flush()
        except Exception:
            pass
        current[0] = None

    def process_group(entries) -> None:
        to_fetch = [
            i for i, (ws, batch) in enumerate(entries)
            if batch is not None and ws.failed is None
        ]
        probs_by_index = {}
        fetch_elapsed = 0.0
        if to_fetch:
            t0 = time.perf_counter()
            try:
                gathered = gather_group(
                    [entries[i][1][2] for i in to_fetch],
                    [entries[i][1][3] for i in to_fetch],
                )
                probs_by_index = dict(zip(to_fetch, gathered))
            except Exception:
                # one grouped fetch can carry batches from up to `depth`
                # windows; a single transient link error must not fail
                # them all. Retry per batch so only batches that fail on
                # their own mark their window failed.
                for i in to_fetch:
                    ws, batch = entries[i]
                    try:
                        probs_by_index[i] = predictor.gather(
                            batch[2], batch[3]
                        )
                    except Exception as exc:
                        ws.failed = (
                            ws.failed or f"{type(exc).__name__}: {exc}"
                        )
            fetch_elapsed = time.perf_counter() - t0
            if stats is not None:
                stats.fetch_s.append(fetch_elapsed)
                stats.fetch_bytes.append(
                    len(to_fetch) * predictor.batch_size * 90 * 4)
        for i, (ws, batch) in enumerate(entries):
            if ws is not current[0]:
                close_current()
                current[0] = ws
                if ws.failed is None and ws.work is not None:
                    try:
                        writer.begin_window(ws.work)
                        ws.began = True
                    except Exception as exc:
                        ws.failed = f"{type(exc).__name__}: {exc}"
            if batch is None or ws.failed is not None or i not in probs_by_index:
                continue
            infos, x, out, n, dispatch_elapsed = batch
            try:
                t1 = time.perf_counter()
                emit_batch(
                    (infos, x, probs_by_index[i], n), _PreGathered,
                    ws.work.output_config, writer, ws.work.indel_sources,
                    None,
                )
                t2 = time.perf_counter()
                if stats is not None:
                    stats.dispatch_s.append(dispatch_elapsed)
                    stats.wait_s.append(fetch_elapsed / len(to_fetch))
                    stats.decode_s.append(t2 - t1)
                ws.sites += n
            except Exception as exc:
                ws.failed = f"{type(exc).__name__}: {exc}"

    done_seen = [False]  # set the moment _DONE leaves the queue, so the
    # consumer_main drain loop never blocks on a sentinel already consumed

    def consume() -> None:
        done = False
        while not done:
            item = work_q.get()
            if item is _DONE:
                done_seen[0] = True
                break
            group = [item]
            while True:
                try:
                    nxt = work_q.get_nowait()
                except queue_mod.Empty:
                    break
                if nxt is _DONE:
                    done_seen[0] = True
                    done = True
                    break
                group.append(nxt)
            process_group(group)
        close_current()

    def consumer_main() -> None:
        try:
            consume()
        except BaseException as exc:  # keep the producer from deadlocking
            fatal.append(exc)
            # drain until the sentinel — unless consume() already took it
            # (e.g. close_current raised AFTER _DONE), where a blocking
            # get() would never return and hang the producer's join()
            while not done_seen[0]:
                item = work_q.get()
                if item is _DONE:
                    break
                # drained windows never reach finish_window; release their
                # FASTA readers (close is idempotent — a window may have
                # several batches queued)
                ws = item[0]
                f = getattr(ws.work, "_fasta_to_close", None) \
                    if ws.work is not None else None
                if f is not None:
                    try:
                        f.close()
                    except Exception:
                        pass

    consumer = threading.Thread(
        target=consumer_main, name="wgs-decode", daemon=True
    )
    consumer.start()

    try:
        with concurrent.futures.ThreadPoolExecutor(max(1, pileup_workers)) as pool:
            pending = []  # (window, future)
            cursor = 0

            def submit_next():
                nonlocal cursor
                if cursor >= len(windows):
                    return
                contig, start, end = windows[cursor]
                cursor += 1
                config = dataclasses.replace(
                    base_config, contig=contig, ctg_start=start, ctg_end=end
                )
                pending.append(
                    ((contig, start, end), pool.submit(_timed_prepare, config))
                )

            for _ in range(min(pileup_workers + prefetch, len(windows))):
                submit_next()
            while pending and not fatal:
                window, future = pending.pop(0)
                started = time.perf_counter()
                try:
                    work, prepare_elapsed = future.result()
                except Exception as exc:
                    submit_next()
                    work_q.put((
                        _WindowState(
                            window, None, started,
                            failed=f"{type(exc).__name__}: {exc}",
                        ),
                        None,
                    ))
                    continue
                submit_next()
                if stats is not None:
                    stats.prepare_s.append(prepare_elapsed)
                ws = _WindowState(window, work, started)
                if len(work.tensors) == 0:
                    # zero-candidate window: still bracket it so gVCF emits
                    # its reference blocks and the joblog records the window
                    work_q.put((ws, None))
                    continue
                batch_size = predictor.batch_size
                for off in range(0, len(work.tensors), batch_size):
                    x = work.tensors[off:off + batch_size]
                    infos = LazyTensorInfos(
                        work.config.contig,
                        work.centers[off:off + len(x)],
                        work.sequences[off:off + len(x)],
                    )
                    t0 = time.perf_counter()
                    try:
                        out, n = predictor.predict_async(x)
                    except Exception as exc:
                        ws.failed = f"{type(exc).__name__}: {exc}"
                        work_q.put((ws, None))
                        break
                    ws.batches += 1
                    if stats is not None:
                        # what actually crossed the link: the padded batch
                        # in its ship dtype — raw uint8 counts (1 B/elem)
                        # on the default path, int16 (2 B/elem) for
                        # normalized float batches (call_var._pack_uplink)
                        per_row = 1
                        for d in x.shape[1:]:
                            per_row *= int(d)
                        elem_bytes = 1 if x.dtype.itemsize == 1 else 2
                        stats.dispatch_bytes.append(
                            batch_size * per_row * elem_bytes)
                    work_q.put(
                        (ws, (infos, x, out, n, time.perf_counter() - t0))
                    )
            # on a fatal abort the loop exits with prepare futures still
            # pending; the pool exit completes them, so close the FASTA
            # readers those windows opened (finish_window never sees them)
            for _, future in pending:
                try:
                    work, _ = future.result()
                except Exception:
                    continue
                f = getattr(work, "_fasta_to_close", None)
                if f is not None:
                    try:
                        f.close()
                    except Exception:
                        pass
    finally:
        work_q.put(_DONE)
        consumer.join()
        if had_eager is not None:
            predictor.eager_host_copy = had_eager
    if fatal:
        # finalize the audit trail and output stream before surfacing the
        # error: an unclosed BgzfTextWriter has no EOF block (tabix rejects
        # it) and buffered joblog records for COMPLETED windows would be
        # lost, making --resume re-run work that already succeeded
        if output_path:
            try:
                output_fh.close()
            except Exception:
                pass
        joblog.close()
        raise fatal[0]
    if output_path:
        output_fh.close()
    joblog.close()
    if failures:
        logger.error(
            "%d window(s) failed; re-run with resume=True (or --resume) to "
            "retry only those — audit log: %s", failures, joblog.path,
        )
    if gz_path and output_path:
        if failures == 0:
            from clair_tpu_torch.io.tbi import bgzip_file, build_tbi

            if appending:
                # retried windows appended AFTER later-coordinate rows;
                # build_tbi requires coordinate-sorted input, so an
                # unsorted stream would get a silently wrong index
                _sort_vcf_file(output_path)
            bgzip_file(output_path, gz_path, remove_src=True)
            build_tbi(gz_path)
        else:
            logger.error(
                "left %s uncompressed so --resume can append; a clean "
                "re-run will produce %s", output_path, gz_path,
            )
    return total


def _sort_vcf_file(path: str) -> None:
    """Re-sort a resumed plain-text VCF/gVCF into genome order in place
    (contig order from the ##contig header lines, then POS; stable, so
    same-position rows keep their emitted order). Holds the body lines in
    memory — bounded by the VCF itself (~100s of MB for a WGS VCF), and
    only the resumed-run path pays it."""
    header: List[str] = []
    body: List[str] = []
    with open(path) as fh:
        for line in fh:
            (header if line.startswith("#") else body).append(line)
    contig_rank: Dict[str, int] = {}
    for line in header:
        if line.startswith("##contig=<ID="):
            name = line[len("##contig=<ID="):].split(",", 1)[0].split(">", 1)[0]
            contig_rank.setdefault(name, len(contig_rank))

    def key(row: str):
        chrom, pos, _ = row.split("\t", 2)
        return (contig_rank.get(chrom, len(contig_rank)), chrom, int(pos))

    body.sort(key=key)
    with open(path, "w") as fh:
        fh.writelines(header)
        fh.writelines(body)


def merge_vcfs(paths: List[str], output_path: str) -> None:
    """Concatenate per-window VCFs, keeping the first header. A ``.gz``
    output is written as tabix-indexed BGZF (inputs stay plain text)."""
    if output_path.endswith(".gz"):
        from clair_tpu_torch.io.tbi import BgzfTextWriter, build_tbi

        out = BgzfTextWriter(output_path)
    else:
        build_tbi = None
        out = open(output_path, "w")
    wrote_header = False
    try:
        for path in paths:
            with open(path) as fh:
                for line in fh:
                    if line.startswith("#"):
                        if not wrote_header:
                            out.write(line)
                    else:
                        out.write(line)
            wrote_header = True
    finally:
        out.close()
    if build_tbi is not None:
        build_tbi(output_path)
