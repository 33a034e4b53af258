"""Command-line dispatcher of the port: ``python -m clair_tpu_torch <command>``.

The calling commands (``call_var``, ``call_bam``, ``call_bam_parallel``)
are the JAX package's own parsers and runners (clair_tpu/cli.py), copied
here over the port's host side, with the port's CUDA ``Predictor`` built by
``_predictor_from``. ``call_bam_parallel`` without ``--run`` prints its
command sheet of ``python -m clair_tpu_torch call_bam`` lines; with
``--process_pool`` each worker process builds its own predictor.

The training commands (``train``, ``train_clr``, ``evaluate``) take the JAX
package's flags but run the port's own loop (``pipeline/train.py``) on one
CUDA device; the flags of what is not ported yet (multi-GPU, profiling,
activation dumps) raise NotImplementedError, as does
``--no_stream_bilstm``, whose lax.scan BiLSTM the port keeps off the card.

The host commands need no model: the training-data chain
(``get_truth``, ``extract_candidates``, ``create_tensor``,
``pair_with_non_variants``, ``tensor2bin``, ``combine_bins``, with
``convert_bin`` and ``tensor_transform``), the post-processing filters
(``overlap_variant``, ``ensemble``, ``merge_gvcf``), the alignment-file
tools (``index_vcf``, ``bam2cram``, ``view``/``sam2bam``, ``cram2bam``),
``convert_tf1`` and ``plot_tensor``. They are the JAX CLI's own, over the
port's copies of its modules, and write the same bytes.

After a calling or training command, one JSON line on stderr reports how
many times each kernel of the port launched during it; after a training
command it also carries the per-epoch (loss sum, epoch) pairs and the best
epoch."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import sys

# the ROADMAP items the refusals below name, by title
_MULTI_GPU = "'Multi-GPU'"
_MODEL_COMMANDS = "'The commands that need the model in torch'"


def _predictor_from(checkpoint_path, batch_size=None, dtype=None,
                    num_devices=None):
    """The port's counterpart of clair_tpu.cli._predictor_from: one CUDA
    device; the compute dtype defaults to PREDICT_COMPUTE_DTYPE (bfloat16)
    as in the JAX CLI."""
    from clair_tpu_torch.models.checkpoint import load_checkpoint
    from clair_tpu_torch.params import (
        PREDICT_BATCH_SIZE, PREDICT_COMPUTE_DTYPE, ModelConfig,
    )
    from clair_tpu_torch.pipeline.call_var import Predictor

    if num_devices and num_devices > 1:
        raise NotImplementedError(
            "--num_devices > 1: multi-GPU calling is not ported yet "
            f"(ROADMAP Queue 1, {_MULTI_GPU})"
        )
    params, _ = load_checkpoint(checkpoint_path)
    config = ModelConfig(compute_dtype=dtype or PREDICT_COMPUTE_DTYPE)
    return Predictor(params, config, batch_size or PREDICT_BATCH_SIZE)


# ---------------------------------------------------------------------------
# calling commands
# ---------------------------------------------------------------------------

def _apply_common_runtime_flags(args):
    """--log_path: mirror the reference's file logging; --threads: cap the
    host decode worker threads (the reference clamps TF/OMP threads,
    call_var.py:176-189)."""
    import logging

    if getattr(args, "log_path", None):
        logging.basicConfig(filename=args.log_path, level=logging.INFO,
                            format="%(message)s")
    threads = getattr(args, "threads", None)
    if threads:
        # NOTE: numpy/JAX read OMP_NUM_THREADS at import time, long before
        # argparse runs, so setting the env var here would be a no-op (the
        # `clair-tpu` entry point exports it pre-import instead, see
        # __main__.py).  The only runtime-effective cap at this point is the
        # native decode worker count.
        from clair_tpu_torch.pipeline import call_var as _cv

        _cv.DECODE_THREADS = threads


def _call_var(argv):
    parser = argparse.ArgumentParser(
        prog="call_var", description="Call variants from pileup tensors"
    )
    parser.add_argument("--tensor_fn", default="PIPE")
    parser.add_argument("--chkpnt_fn", default=None)
    parser.add_argument("--call_fn", default=None,
                        help="output VCF; a .gz suffix writes tabix-indexed BGZF")
    parser.add_argument("--bam_fn", default=None)
    parser.add_argument("--ref_fn", default=None)
    parser.add_argument("--qual", type=int, default=None)
    parser.add_argument("--sampleName", default="SAMPLE")
    parser.add_argument("--showRef", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--haploid_precision", action="store_true")
    parser.add_argument("--haploid_sensitive", action="store_true")
    parser.add_argument("--input_probabilities", action="store_true")
    parser.add_argument("--output_for_ensemble", action="store_true")
    parser.add_argument("--bam_for_all_indel_bases", "--pysam_for_all_indel_bases",
                        action="store_true", dest="bam_for_all_indel_bases")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                        help="inference compute dtype (default bfloat16, whose "
                             "decode decisions are guarded f32-identical; "
                             "float32 is the exact-probability escape hatch)")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="shard the inference batch over this many "
                             "devices of the attached slice (data-parallel "
                             "mesh; default: single device)")
    parser.add_argument("--activation_only", action="store_true",
                        help="dump layer activations instead of calling")
    parser.add_argument("--log_path", default=None)
    parser.add_argument("--threads", type=int, default=None,
                        help="host decode threads (reference: TF threads)")
    parser.add_argument("--fast_plotting", action="store_true",
                        help=argparse.SUPPRESS)  # compat: plotting concurrency
    parser.add_argument("--max_plot", type=int, default=10)
    args = parser.parse_args(argv)

    _apply_common_runtime_flags(args)
    if args.activation_only:
        raise NotImplementedError("--activation_only (forward_activations) is not ported "
                                  f"yet (ROADMAP Queue 1, {_MODEL_COMMANDS})")

    from clair_tpu_torch.io.vcf import VcfWriter, contigs_from_fai
    from clair_tpu_torch.pipeline.call_var import (
        call_variants,
        call_variants_for_ensemble,
        call_variants_from_probabilities,
    )
    from clair_tpu_torch.pipeline.decode import IndelSources, OutputConfig

    bgzip_out = bool(args.call_fn) and args.call_fn.endswith(".gz")
    if bgzip_out:
        from clair_tpu_torch.io.tbi import BgzfTextWriter

        output_fh = BgzfTextWriter(args.call_fn)
    else:
        output_fh = open(args.call_fn, "w") if args.call_fn else sys.stdout
    output_config = OutputConfig(
        is_show_reference=args.showRef,
        is_debug=args.debug,
        is_haploid_precision_mode_enabled=args.haploid_precision,
        is_haploid_sensitive_mode_enabled=args.haploid_sensitive,
        is_output_for_ensemble=args.output_for_ensemble,
        quality_score_for_pass=args.qual,
    )
    contigs = contigs_from_fai(args.ref_fn + ".fai") if args.ref_fn else None
    writer = VcfWriter(output_fh, args.sampleName, contigs, args.qual)

    indel_sources = IndelSources()
    if args.bam_fn and args.ref_fn:
        from clair_tpu_torch.io.fasta import FastaReader
        from clair_tpu_torch.pipeline.call_bam import RegionIndelSources

        indel_sources = RegionIndelSources(
            args.bam_fn, FastaReader(args.ref_fn),
            use_bam_for_all=args.bam_for_all_indel_bases,
        )

    if args.input_probabilities:
        writer.write_header()
        call_variants_from_probabilities(sys.stdin, output_config, writer, indel_sources)
    elif args.output_for_ensemble:
        predictor = _predictor_from(args.chkpnt_fn, dtype=args.dtype,
                                    num_devices=args.num_devices)
        call_variants_for_ensemble(args.tensor_fn, predictor, output_fh)
    else:
        writer.write_header()
        predictor = _predictor_from(args.chkpnt_fn, dtype=args.dtype,
                                    num_devices=args.num_devices)
        call_variants(
            args.tensor_fn, predictor, output_config, writer, indel_sources,
            debug_fh=output_fh if args.debug else None,
        )
    if args.call_fn:
        output_fh.close()
        if bgzip_out and not (args.output_for_ensemble or args.debug):
            from clair_tpu_torch.io.tbi import build_tbi

            build_tbi(args.call_fn)


def _call_bam(argv):
    parser = argparse.ArgumentParser(
        prog="call_bam", description="Call variants from a BAM for one region"
    )
    parser.add_argument("--bam_fn", required=True)
    parser.add_argument("--ref_fn", required=True)
    parser.add_argument("--chkpnt_fn", required=True)
    parser.add_argument("--call_fn", default=None,
                        help="output VCF; a .gz suffix writes tabix-indexed BGZF")
    parser.add_argument("--ctgName", required=True)
    parser.add_argument("--ctgStart", type=int, default=None)
    parser.add_argument("--ctgEnd", type=int, default=None)
    parser.add_argument("--bed_fn", default=None)
    parser.add_argument("--vcf_fn", default=None, help="candidate sites from a truth VCF")
    parser.add_argument("--threshold", type=float, default=0.125)
    parser.add_argument("--minCoverage", type=float, default=4)
    parser.add_argument("--minMQ", type=int, default=0)
    parser.add_argument("--dcov", type=int, default=250)
    parser.add_argument("--qual", type=int, default=None)
    parser.add_argument("--sampleName", default="SAMPLE")
    parser.add_argument("--showRef", action="store_true")
    parser.add_argument("--haploid_precision", action="store_true")
    parser.add_argument("--haploid_sensitive", action="store_true")
    parser.add_argument("--bam_for_all_indel_bases", "--pysam_for_all_indel_bases",
                        action="store_true", dest="bam_for_all_indel_bases")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                        help="inference compute dtype (default bfloat16; "
                             "float32 = exact-probability escape hatch)")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="shard the inference batch over this many "
                             "devices of the attached slice (data-parallel "
                             "mesh; default: single device)")
    parser.add_argument("--debug", action="store_true",
                        help="print per-site probability vectors instead of rows")
    parser.add_argument("--output_for_ensemble", action="store_true",
                        help="emit tensor+probability rows for the ensemble combiner")
    parser.add_argument("--stop_consider_left_edge", action="store_true",
                        help="reference-parity tensor mode (CreateTensor.py:187)")
    parser.add_argument("--gvcf", action="store_true",
                        help="emit gVCF: reference-confidence blocks "
                             "between variant rows (pipeline/gvcf.py)")
    parser.add_argument("--base_err", type=float, default=0.001,
                        help="per-read base error for gVCF reference GQ")
    parser.add_argument("--gq_bin_size", type=int, default=5,
                        help="GQ bin width for merging gVCF reference blocks")
    parser.add_argument("--log_path", default=None)
    parser.add_argument("--threads", type=int, default=None,
                        help="host decode threads (reference: TF threads)")
    # accepted for command-sheet compatibility; meaningless in the
    # single-process design (no pypy/samtools subprocesses, no start delay)
    parser.add_argument("--pypy", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--samtools", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--delay", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    _apply_common_runtime_flags(args)

    from clair_tpu_torch.pipeline.call_bam import CallBamConfig, call_bam

    config = CallBamConfig(
        bam_path=args.bam_fn,
        fasta_path=args.ref_fn,
        contig=args.ctgName,
        ctg_start=args.ctgStart,
        ctg_end=args.ctgEnd,
        bed_path=args.bed_fn,
        minimum_af=args.threshold,
        minimum_coverage=args.minCoverage,
        minimum_mapq=args.minMQ,
        dcov=args.dcov,
        sample_name=args.sampleName,
        qual=args.qual,
        show_reference=args.showRef,
        haploid_precision=args.haploid_precision,
        haploid_sensitive=args.haploid_sensitive,
        use_bam_for_all_indels=args.bam_for_all_indel_bases,
        truth_vcf_path=args.vcf_fn,
        stop_consider_left_edge=args.stop_consider_left_edge,
        debug=args.debug,
        output_for_ensemble=args.output_for_ensemble,
        gvcf=args.gvcf,
        base_err=args.base_err,
        gq_bin_size=args.gq_bin_size,
    )
    total = call_bam(
        config, _predictor_from(args.chkpnt_fn, dtype=args.dtype,
                                num_devices=args.num_devices),
        output_path=args.call_fn,
    )
    print(f"[INFO] {total} candidate sites processed", file=sys.stderr)


def _call_bam_parallel(argv, pool_device="cuda"):
    parser = argparse.ArgumentParser(
        prog="call_bam_parallel",
        description="Emit per-window call_bam commands (or run them inline)",
    )
    parser.add_argument("--bam_fn", required=True)
    parser.add_argument("--ref_fn", required=True)
    parser.add_argument("--chkpnt_fn", required=True)
    parser.add_argument("--output_prefix", required=True)
    parser.add_argument("--bed_fn", default=None)
    parser.add_argument("--vcf_fn", default=None,
                        help="candidate sites from a truth VCF (GetTruth mode)")
    parser.add_argument("--refChunkSize", type=int, default=10_000_000)
    parser.add_argument("--includingAllContigs", action="store_true")
    parser.add_argument("--threshold", type=float, default=0.125)
    parser.add_argument("--minCoverage", type=float, default=4)
    parser.add_argument("--minMQ", type=int, default=0)
    parser.add_argument("--dcov", type=int, default=250)
    parser.add_argument("--qual", type=int, default=None)
    parser.add_argument("--sampleName", default="SAMPLE")
    parser.add_argument("--showRef", action="store_true")
    parser.add_argument("--haploid_precision", action="store_true")
    parser.add_argument("--haploid_sensitive", action="store_true")
    parser.add_argument("--bam_for_all_indel_bases", "--pysam_for_all_indel_bases",
                        action="store_true", dest="bam_for_all_indel_bases")
    parser.add_argument("--stop_consider_left_edge", action="store_true")
    parser.add_argument("--gvcf", action="store_true",
                        help="emit gVCF: reference-confidence blocks "
                             "between variant rows (pipeline/gvcf.py)")
    parser.add_argument("--base_err", type=float, default=0.001,
                        help="per-read base error for gVCF reference GQ")
    parser.add_argument("--gq_bin_size", type=int, default=5,
                        help="GQ bin width for merging gVCF reference blocks")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                        help="inference compute dtype (default bfloat16; "
                             "float32 = exact-probability escape hatch)")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="shard the inference batch over this many "
                             "devices of the attached slice (single-process "
                             "runners only; data-parallel mesh)")
    parser.add_argument("--log_path", default=None)
    # compat no-ops (reference per-job process plumbing)
    parser.add_argument("--tensorflowThreads", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--pypy", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--samtools", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--delay", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--run", action="store_true", help="execute inline instead of printing commands")
    parser.add_argument("--workers", type=int, default=4,
                        help="pileup worker threads (or process-pool size with --process_pool)")
    parser.add_argument("--process_pool", action="store_true",
                        help="one process per window (for multi-device hosts) instead of the threaded single-device runner")
    parser.add_argument("--resume", action="store_true",
                        help="re-run only windows not logged ok in the joblog "
                             "(the GNU parallel --joblog Exitval workflow, in-process)")
    parser.add_argument("--joblog", default=None,
                        help="per-window audit log path (default: <output>.joblog)")
    parser.add_argument("--num_shards", type=int, default=1,
                        help="multi-host WGS: total hosts splitting the window list")
    parser.add_argument("--shard_id", type=int, default=0,
                        help="this host's shard index in [0, num_shards)")
    parser.add_argument("--work_dir", default=None,
                        help="multi-host dynamic mode: shared queue directory; "
                             "every host runs the same command and claims "
                             "windows atomically (replaces static sharding)")
    parser.add_argument("--reclaim_stale", type=float, default=None,
                        help="with --work_dir: seconds after which another "
                             "host's claim with no result is taken over")
    parser.add_argument("--wait", action="store_true",
                        help="with --work_dir: idle until every window has a "
                             "result before exiting (last host standing "
                             "picks up crashed peers' windows)")
    parser.add_argument("--finalize_only", action="store_true",
                        help="with --work_dir: skip calling; merge finished "
                             "windows into <output_prefix>.vcf and report")
    args = parser.parse_args(argv)
    _apply_common_runtime_flags(args)
    if args.work_dir or args.finalize_only:
        args.run = True  # queue modes are always inline execution

    from clair_tpu_torch.pipeline.call_bam_parallel import emit_command_sheet

    if not args.run:
        extra = (
            f"--threshold {args.threshold} --minCoverage {args.minCoverage}"
            f" --minMQ {args.minMQ} --dcov {args.dcov}"
            f" --sampleName {args.sampleName}"
        )
        if args.qual is not None:
            extra += f" --qual {args.qual}"
        if args.bed_fn:
            extra += f" --bed_fn {args.bed_fn}"
        if args.vcf_fn:
            extra += f" --vcf_fn {args.vcf_fn}"
        for flag in ("showRef", "haploid_precision", "haploid_sensitive",
                     "stop_consider_left_edge", "bam_for_all_indel_bases"):
            if getattr(args, flag):
                extra += f" --{flag}"
        emit_command_sheet(
            args.ref_fn, args.bam_fn, args.chkpnt_fn, args.output_prefix,
            chunk_size=args.refChunkSize,
            include_all_contigs=args.includingAllContigs,
            bed_path=args.bed_fn,
            extra_flags=extra.strip(),
        )
        return

    from clair_tpu_torch.pipeline.call_bam import CallBamConfig
    from clair_tpu_torch.pipeline.call_bam_parallel import call_bam_windows_threaded

    base = CallBamConfig(
        bam_path=args.bam_fn, fasta_path=args.ref_fn,
        bed_path=args.bed_fn, qual=args.qual,
        minimum_af=args.threshold, minimum_coverage=args.minCoverage,
        minimum_mapq=args.minMQ, dcov=args.dcov,
        sample_name=args.sampleName, show_reference=args.showRef,
        haploid_precision=args.haploid_precision,
        haploid_sensitive=args.haploid_sensitive,
        use_bam_for_all_indels=args.bam_for_all_indel_bases,
        truth_vcf_path=args.vcf_fn,
        stop_consider_left_edge=args.stop_consider_left_edge,
        gvcf=args.gvcf,
        base_err=args.base_err,
        gq_bin_size=args.gq_bin_size,
    )
    if args.work_dir:
        from clair_tpu_torch.io.fasta import FastaReader
        from clair_tpu_torch.pipeline.call_bam_parallel import genome_windows
        from clair_tpu_torch.pipeline.work_queue import WorkQueue, finalize, run_worker
        from clair_tpu_torch.utils.intervals import BedIntervals

        queue = WorkQueue(args.work_dir)
        fasta = FastaReader(args.ref_fn)
        contigs = fasta.contigs
        if not args.finalize_only:
            bed = BedIntervals.from_bed(args.bed_fn) if args.bed_fn else None
            windows = list(genome_windows(
                fasta, args.refChunkSize, args.includingAllContigs, bed
            ))
            queue.initialize(windows, meta={"bam": args.bam_fn})
        fasta.close()
        if args.finalize_only:
            state = finalize(queue, args.output_prefix + ".vcf",
                             sample_name=args.sampleName,
                             contigs=contigs, qual=args.qual, gvcf=args.gvcf)
            print(json.dumps(state), file=sys.stderr)
            return
        total = run_worker(
            queue, base, _predictor_from(args.chkpnt_fn, dtype=args.dtype,
                                         num_devices=args.num_devices),
            reclaim_stale_s=args.reclaim_stale,
            wait_for_stragglers=args.wait,
        )
        state = queue.status()
        print(f"[INFO] this worker called {total} sites; queue: {state}",
              file=sys.stderr)
        if state["ok"] + state["failed"] == state["total"]:
            finalize(queue, args.output_prefix + ".vcf",
                     sample_name=args.sampleName,
                     contigs=contigs, qual=args.qual, gvcf=args.gvcf)
        return
    if args.process_pool:
        if args.num_devices and args.num_devices > 1:
            parser.error("--num_devices shards one predictor's batch over "
                         "the slice; with --process_pool each worker process "
                         "owns its own device instead — drop one of the two")
        from clair_tpu_torch.pipeline.call_bam_parallel import call_bam_parallel, merge_vcfs

        paths = call_bam_parallel(
            base, lambda: _predictor_from(args.chkpnt_fn, dtype=args.dtype),
            args.output_prefix,
            chunk_size=args.refChunkSize,
            include_all_contigs=args.includingAllContigs,
            max_workers=args.workers,
            checkpoint_path=args.chkpnt_fn,
            resume=args.resume,
            joblog_path=args.joblog,
            num_shards=args.num_shards,
            shard_id=args.shard_id,
            device=pool_device,
        )
        merge_vcfs(paths, args.output_prefix + ".vcf")
    else:
        call_bam_windows_threaded(
            base, _predictor_from(args.chkpnt_fn, dtype=args.dtype,
                                  num_devices=args.num_devices),
            args.output_prefix + ".vcf",
            chunk_size=args.refChunkSize,
            include_all_contigs=args.includingAllContigs,
            pileup_workers=args.workers,
            resume=args.resume,
            joblog_path=args.joblog,
            num_shards=args.num_shards,
            shard_id=args.shard_id,
        )


def cmd_call_var(argv):
    with _reporting_launches({}):
        _call_var(argv)


def cmd_call_bam(argv):
    with _reporting_launches({}):
        _call_bam(argv)


def cmd_call_bam_parallel(argv, pool_device="cuda"):
    """``pool_device``: where each --process_pool worker process builds its
    Predictor (the command line's: CUDA); an in-process caller may ask for
    the CPU."""
    with _reporting_launches({}):
        _call_bam_parallel(argv, pool_device)


# ---------------------------------------------------------------------------
# training commands
# ---------------------------------------------------------------------------

def _add_dataset_args(parser):
    parser.add_argument("--bin_fn", default=None)
    parser.add_argument("--train_bin_fn", default=None)
    parser.add_argument("--validation_bin_fn", default=None)
    parser.add_argument("--tensor_fn", default="vartensors")
    parser.add_argument("--var_fn", default="truthvars")
    parser.add_argument("--bed_fn", default=None)


def _kernel_counts():
    """Each kernel wrapper of the port and its launches so far."""
    from clair_tpu_torch.ops.bilstm import bilstm_precomputed
    from clair_tpu_torch.ops.bilstm2 import bilstm2
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream, bilstm_stream_backward
    from clair_tpu_torch.ops.bilstm_train import bilstm_train, bilstm_train_backward

    wrappers = (bilstm_stream, bilstm_stream_backward, bilstm_train, bilstm_train_backward,
                bilstm_precomputed, bilstm2)
    return {fn.__name__: fn.launches for fn in wrappers}


@contextlib.contextmanager
def _reporting_launches(report):
    """Print one JSON line on stderr after the command: each kernel's
    launches during it, and what the command put in ``report``."""
    before = _kernel_counts()
    yield
    after = _kernel_counts()
    launches = {k: after[k] - before[k] for k in after}
    print(json.dumps({"kernel_launches": launches, **report}), file=sys.stderr)


def _load_dataset(args):
    from clair_tpu_torch.data.bins import build_bin_from_tensors, load_bin, load_train_val_bins

    if args.train_bin_fn and args.validation_bin_fn:
        return load_train_val_bins(args.train_bin_fn, args.validation_bin_fn)
    if args.bin_fn:
        return load_bin(args.bin_fn)
    return build_bin_from_tensors(args.tensor_fn, args.var_fn, args.bed_fn)


def _refuse_unported_training_flags(args):
    refused = (
        (args.num_devices is not None and args.num_devices > 1,
         "--num_devices > 1: multi-GPU training", _MULTI_GPU),
        (args.coordinator_address is not None,
         "--coordinator_address: multi-host training", _MULTI_GPU),
        (args.model_parallel > 1, "--model_parallel > 1: the sharded dense trunk",
         _MULTI_GPU),
        (args.profile_dir is not None, "--profile_dir: a profiler trace of training",
         _MODEL_COMMANDS),
    )
    for given, what, item in refused:
        if given:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, {item})")
    if args.no_stream_bilstm:
        # the command line builds a bare ModelConfig, so the JAX flag falls
        # back to the lax.scan BiLSTM there
        raise NotImplementedError(
            "--no_stream_bilstm selects the JAX package's lax.scan BiLSTM, which in the "
            "port is the plain PyTorch version: it serves CPU tensors and is kept off "
            "the card (ROADMAP, the kernel rule). The other kernels are selected from "
            "Python by ModelConfig flags (use_pallas_train_bilstm, use_pallas_bilstm)")


def cmd_train(argv, schedule="adaptive", device="cuda"):
    """The JAX package's ``train`` (and, with schedule "clr",
    ``train_clr``) on one device (the command line's is CUDA), with the same
    flags."""
    parser = argparse.ArgumentParser(prog="train", description="Train the model")
    _add_dataset_args(parser)
    parser.add_argument("--chkpnt_fn", default=None)
    parser.add_argument("--ochk_prefix", default=None)
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--lambd", type=float, default=None)
    parser.add_argument("--SGDM", action="store_true")
    parser.add_argument("--Adam", action="store_true")
    parser.add_argument("--cross_entropy", action="store_true")
    parser.add_argument("--focal_loss", action="store_true")
    parser.add_argument("--clr_mode", default="tri", choices=["tri", "tri2", "exp"])
    parser.add_argument("--maxEpoch", type=int, default=None)
    parser.add_argument("--num_devices", type=int, default=None)
    parser.add_argument("--model_parallel", type=int, default=1)
    parser.add_argument("--coordinator_address", default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--decompress_workers", type=int, default=None,
                        help="bin-block decompression threads for the epoch "
                             "feed (default: one per spare core, up to 4)")
    parser.add_argument("--profile_dir", default=None)
    parser.add_argument("--train_compute_dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="matmul/activation dtype for the train step "
                             "(master weights, loss and cell state stay "
                             "float32; default: TrainingConfig default)")
    parser.add_argument("--no_stream_bilstm", action="store_true")
    args = parser.parse_args(argv)
    _refuse_unported_training_flags(args)
    logging.basicConfig(format="%(message)s", level=logging.INFO)
    if args.num_processes is not None or args.process_id is not None:
        parser.error("--num_processes/--process_id require --coordinator_address")

    from clair_tpu_torch.params import (
        CLR_MAX_LR, INITIAL_LEARNING_RATE, L2_REGULARIZATION_LAMBDA, MAX_EPOCH,
        ModelConfig,
    )
    from clair_tpu_torch.pipeline.train import TrainingConfig, train_model

    optimizer = "SGDM" if args.SGDM else ("Adam" if args.Adam else None)
    loss = "CrossEntropy" if args.cross_entropy else ("FocalLoss" if args.focal_loss else None)
    model = ModelConfig(
        **{k: v for k, v in dict(optimizer_name=optimizer, loss_function=loss).items() if v}
    )
    config = TrainingConfig(
        model=model,
        learning_rate=args.learning_rate or INITIAL_LEARNING_RATE,
        l2_lambda=args.lambd if args.lambd is not None else L2_REGULARIZATION_LAMBDA,
        output_prefix=args.ochk_prefix,
        init_checkpoint=args.chkpnt_fn,
        schedule=schedule if schedule == "adaptive" else args.clr_mode,
        clr_max_lr=CLR_MAX_LR,
        max_epochs=args.maxEpoch or MAX_EPOCH,
        # for the adaptive schedule --maxEpoch acts as a hard safety cap
        hard_max_epochs=args.maxEpoch if schedule == "adaptive" else None,
        decompress_workers=args.decompress_workers,
        device=device,
        **({"train_compute_dtype": args.train_compute_dtype}
           if args.train_compute_dtype else {}),
    )
    dataset = _load_dataset(args)
    report = {}
    with _reporting_launches(report):
        result = train_model(dataset, config)
        report.update(training_losses=result.training_losses,
                      validation_losses=result.validation_losses,
                      best_epoch=result.best_epoch)


def cmd_train_clr(argv):
    cmd_train(argv, schedule="clr")


def cmd_evaluate(argv, device="cuda"):
    parser = argparse.ArgumentParser(prog="evaluate", description="Evaluate a model")
    _add_dataset_args(parser)
    parser.add_argument("--chkpnt_fn", required=True)
    args = parser.parse_args(argv)
    logging.basicConfig(format="%(message)s", level=logging.INFO)

    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.models.checkpoint import load_checkpoint
    from clair_tpu_torch.pipeline.evaluate import evaluate_model

    params, _ = load_checkpoint(args.chkpnt_fn)
    with _reporting_launches({}):
        evaluate_model(params, ModelConfig(), _load_dataset(args), device=device)


# ---------------------------------------------------------------------------
# data-prep commands
# ---------------------------------------------------------------------------

def cmd_extract_candidates(argv):
    parser = argparse.ArgumentParser(
        prog="extract_candidates",
        description="Generate 1-based variant candidates from a BAM",
    )
    parser.add_argument("--bam_fn", required=True)
    parser.add_argument("--ref_fn", required=True)
    parser.add_argument("--can_fn", default="PIPE")
    parser.add_argument("--bed_fn", default=None)
    parser.add_argument("--var_fn", default=None)
    parser.add_argument("--threshold", type=float, default=0.125)
    parser.add_argument("--minCoverage", type=float, default=4)
    parser.add_argument("--minMQ", type=int, default=0)
    parser.add_argument("--gen4Training", action="store_true")
    parser.add_argument("--outputProb", type=float, default=None)
    parser.add_argument("--ctgName", required=True)
    parser.add_argument("--ctgStart", type=int, default=None)
    parser.add_argument("--ctgEnd", type=int, default=None)
    args = parser.parse_args(argv)

    from clair_tpu_torch.data.candidates import (
        CandidateConfig,
        DEFAULT_OUTPUT_PROBABILITY,
        candidate_sites_from_events,
        non_variant_positions_near_variants,
        variant_positions_from,
        write_candidates_text,
    )
    from clair_tpu_torch.data.pileup import events_from_reads, soft_clip_fraction_ok
    from clair_tpu_torch.io.cram import open_alignment
    from clair_tpu_torch.io.fasta import FastaReader
    from clair_tpu_torch.params import EXPAND_REFERENCE_REGION
    from clair_tpu_torch.utils.intervals import BedIntervals

    fasta = FastaReader(args.ref_fn)
    length = fasta.contig_length(args.ctgName)
    ctg_start = args.ctgStart or 1
    ctg_end = args.ctgEnd or length
    ref_start = max(ctg_start - 1 - EXPAND_REFERENCE_REGION, 0)
    ref_end = min(ctg_end + EXPAND_REFERENCE_REGION, length)
    reference = fasta.fetch(args.ctgName, ref_start, ref_end)

    variant_positions = variant_positions_from(args.var_fn, args.ctgName)
    config = CandidateConfig(
        minimum_af=args.threshold,
        minimum_coverage=args.minCoverage,
        gen4training=args.gen4Training,
        output_probability=args.outputProb or DEFAULT_OUTPUT_PROBABILITY,
        variant_positions=variant_positions,
        near_variant_positions=non_variant_positions_near_variants(variant_positions),
        bed=BedIntervals.from_bed(args.bed_fn),
        contig=args.ctgName,
    )

    # native counts pass (BAM stream scan or the CRAM packed-array
    # bridge) — same soft-clip filter and column semantics as the event
    # path, without materializing per-base events for a counts-only CLI
    sites = _native_candidate_sites(
        args, fasta, reference, ctg_start, ctg_end, ref_start, config
    )
    if sites is None:
        with open_alignment(args.bam_fn, fasta=fasta) as bam:
            records = [
                r for r in bam.fetch(args.ctgName, ctg_start - 1, ctg_end,
                                     min_mapq=args.minMQ)
                if r.cigar_ops.size and soft_clip_fraction_ok(r)
            ]
        events = events_from_reads(records)
        sites = candidate_sites_from_events(
            events, reference, ctg_start - 1, ctg_end - (ctg_start - 1),
            ref_start, config,
        )
    out = sys.stdout if args.can_fn == "PIPE" else open(args.can_fn, "w")
    write_candidates_text(sites, args.ctgName, out)
    if args.can_fn != "PIPE":
        out.close()


def _native_region_scan(bam_fn, fasta, contig, ctg_start, ctg_end, min_mapq,
                        counts_region=None):
    """RegionScan for a BAM or CRAM region (None -> Python fallback).
    Thin alias kept as the CLI's monkeypatch point for the parity tests."""
    from clair_tpu_torch.pipeline.call_bam import open_region_scan_path

    return open_region_scan_path(
        bam_fn, fasta, contig, ctg_start, ctg_end, min_mapq,
        counts_region=counts_region,
    )


def _native_candidate_sites(args, fasta, reference, ctg_start, ctg_end,
                            ref_start, config):
    """Candidate sites via the native counts pass, or None to fall back."""
    from clair_tpu_torch.data.candidates import candidate_sites_from_counts

    region_length = ctg_end - (ctg_start - 1)
    scan = _native_region_scan(
        args.bam_fn, fasta, args.ctgName, ctg_start, ctg_end, args.minMQ,
        counts_region=(ctg_start - 1, region_length),
    )
    if scan is None:
        return None
    with scan:
        counts = scan.counts(ctg_start - 1, region_length)
    return candidate_sites_from_counts(
        counts, reference, ctg_start - 1, ref_start, config
    )


def cmd_create_tensor(argv):
    parser = argparse.ArgumentParser(
        prog="create_tensor",
        description="Generate pileup tensors for candidate positions",
    )
    parser.add_argument("--bam_fn", required=True)
    parser.add_argument("--ref_fn", required=True)
    parser.add_argument("--can_fn", default="PIPE")
    parser.add_argument("--tensor_fn", default="PIPE")
    parser.add_argument("--minMQ", type=int, default=0)
    parser.add_argument("--dcov", type=int, default=250)
    parser.add_argument("--minCoverage", type=int, default=0)
    parser.add_argument("--ctgName", required=True)
    parser.add_argument("--ctgStart", type=int, default=None)
    parser.add_argument("--ctgEnd", type=int, default=None)
    parser.add_argument(
        "--stop_consider_left_edge", action="store_true",
        help="only reads covering a window's left edge contribute to its "
             "tensor (ref CreateTensor.py:187, 99-100; default includes "
             "all overlapping reads)",
    )
    parser.add_argument(
        "--compat_slot_throttle", type=int, default=None, metavar="SLOTS",
        help="reference-parity memory throttle: cap (event x window) pairs "
             "at SLOTS in read-stream order (the reference hard-codes "
             "5000000, CreateTensor.py:180); default: no throttle",
    )
    args = parser.parse_args(argv)

    import numpy as np

    from clair_tpu_torch.data.pileup import (
        apply_depth_cap, create_tensors, events_from_reads,
    )
    from clair_tpu_torch.data.tensor_stream import open_maybe_gzip, tensor_line_from
    from clair_tpu_torch.io.cram import open_alignment
    from clair_tpu_torch.io.fasta import FastaReader
    from clair_tpu_torch.params import EXPAND_REFERENCE_REGION

    centers = []
    with open_maybe_gzip(args.can_fn) as fh:
        for row in fh:
            columns = row.split(maxsplit=2)
            position = int(columns[1])
            if args.ctgStart is not None and args.ctgEnd is not None:
                if not (args.ctgStart <= position <= args.ctgEnd):
                    continue
            centers.append(position)
    centers = np.array(sorted(centers), dtype=np.int64)

    fasta = FastaReader(args.ref_fn)
    length = fasta.contig_length(args.ctgName)
    ctg_start = args.ctgStart or 1
    ctg_end = args.ctgEnd or length
    ref_start = max(ctg_start - 1 - EXPAND_REFERENCE_REGION, 0)
    reference = fasta.fetch(
        args.ctgName, ref_start, min(ctg_end + EXPAND_REFERENCE_REGION, length)
    )

    parity_mode = args.stop_consider_left_edge or args.compat_slot_throttle is not None
    tensors = None
    if not parity_mode and len(centers):
        # native window-tensor pass (BAM stream scan or CRAM packed
        # bridge) — byte-identical to the Python engine (tests/
        # test_native.py); parity modes need per-read layout tracking and
        # stay on the Python path
        scan = _native_region_scan(
            args.bam_fn, fasta, args.ctgName, ctg_start, ctg_end, args.minMQ
        )
        if scan is not None:
            from clair_tpu_torch.data.pileup import finalize_window_tensors

            with scan:
                tensor_ints, _events = scan.tensors(
                    centers, reference, ref_start, dcov=args.dcov
                )
            ref_raw = np.frombuffer(reference.encode("ascii"), dtype=np.uint8)
            tensors, kept, sequences = finalize_window_tensors(
                tensor_ints, centers, ref_raw, ref_start,
                minimum_coverage=args.minCoverage,
            )
    if tensors is None:
        with open_alignment(args.bam_fn, fasta=fasta) as bam:
            records = list(
                bam.fetch(args.ctgName, ctg_start - 1, ctg_end,
                          min_mapq=args.minMQ)
            )
        records = apply_depth_cap(records, args.dcov)
        tensors, kept, sequences = create_tensors(
            events_from_reads(records, track_read_layout=parity_mode),
            centers, reference, ref_start, args.minCoverage,
            consider_left_edge=not args.stop_consider_left_edge,
            slot_budget=args.compat_slot_throttle,
        )

    out = sys.stdout if args.tensor_fn == "PIPE" else open_maybe_gzip(args.tensor_fn, "wt")
    for i in range(len(kept)):
        print(tensor_line_from(args.ctgName, int(kept[i]), sequences[i], tensors[i]), file=out)
    if args.tensor_fn != "PIPE":
        out.close()


def cmd_get_truth(argv):
    parser = argparse.ArgumentParser(prog="get_truth", description="Extract truth variants from VCF")
    parser.add_argument("--vcf_fn", required=True)
    parser.add_argument("--var_fn", default="PIPE")
    parser.add_argument("--ref_fn", default=None)
    parser.add_argument("--ctgName", required=True)
    parser.add_argument("--ctgStart", type=int, default=None)
    parser.add_argument("--ctgEnd", type=int, default=None)
    args = parser.parse_args(argv)

    from clair_tpu_torch.data.tensor_stream import open_maybe_gzip
    from clair_tpu_torch.data.truth import write_truth
    from clair_tpu_torch.io.fasta import FastaReader

    fasta = FastaReader(args.ref_fn) if args.ref_fn else None
    out = sys.stdout if args.var_fn == "PIPE" else open_maybe_gzip(args.var_fn, "wt")
    write_truth(args.vcf_fn, args.ctgName, out, args.ctgStart, args.ctgEnd, fasta)
    if args.var_fn != "PIPE":
        out.close()


def cmd_pair_with_non_variants(argv):
    parser = argparse.ArgumentParser(prog="pair_with_non_variants")
    parser.add_argument("--tensor_can_fn", required=True)
    parser.add_argument("--tensor_var_fn", required=True)
    parser.add_argument("--output_fn", required=True)
    parser.add_argument("--bed_fn", default=None)
    parser.add_argument("--amp", type=float, default=2)
    args = parser.parse_args(argv)

    from clair_tpu_torch.data.pairing import pair_with_non_variants

    pair_with_non_variants(
        args.tensor_can_fn, args.tensor_var_fn, args.output_fn, args.bed_fn, args.amp
    )


def cmd_tensor2bin(argv):
    parser = argparse.ArgumentParser(prog="tensor2bin", description="Pack tensors into a training bin")
    parser.add_argument("--tensor_fn", required=True)
    parser.add_argument("--var_fn", default=None)
    parser.add_argument("--bed_fn", default=None)
    parser.add_argument("--bin_fn", required=True)
    parser.add_argument("--allow_duplicate_chr_pos", action="store_true")
    parser.add_argument("--no_shuffle", action="store_true")
    args = parser.parse_args(argv)

    from clair_tpu_torch.data.bins import build_bin_from_tensors, write_bin

    dataset = build_bin_from_tensors(
        args.tensor_fn, args.var_fn, args.bed_fn,
        shuffle=not args.no_shuffle,
        is_allow_duplicate_chr_pos=args.allow_duplicate_chr_pos,
    )
    write_bin(args.bin_fn, dataset)
    print(f"[INFO] wrote {dataset.dataset_size} examples", file=sys.stderr)


def cmd_combine_bins(argv):
    parser = argparse.ArgumentParser(prog="combine_bins")
    parser.add_argument("inputs", nargs="+")
    parser.add_argument("--output_fn", required=True)
    args = parser.parse_args(argv)

    from clair_tpu_torch.data.bins import combine_bins

    merged = combine_bins(args.inputs, args.output_fn)
    print(f"[INFO] merged {merged.dataset_size} examples", file=sys.stderr)


def cmd_convert_bin(argv):
    parser = argparse.ArgumentParser(
        prog="convert_bin",
        description="Re-pack a bin's blocks in this version's block codec; "
                    "the reference's blosc bins are refused here (no blosc "
                    "module where the port runs), the JAX package converts them",
    )
    parser.add_argument("--input_fn", required=True)
    parser.add_argument("--output_fn", required=True)
    args = parser.parse_args(argv)

    from clair_tpu_torch.data.bins import BinDataset, _pack, load_bin, write_bin

    source = load_bin(args.input_fn)
    converted = BinDataset(
        dataset_size=source.dataset_size,
        x_blocks=[_pack(source.x_block(i)) for i in range(source.n_blocks)],
        y_blocks=[_pack(source.y_block(i)) for i in range(source.n_blocks)],
        pos_blocks=[_pack(source.pos_block(i)) for i in range(source.n_blocks)],
        block_size=source.block_size,
    )
    write_bin(args.output_fn, converted)


def cmd_tensor_transform(argv):
    parser = argparse.ArgumentParser(prog="tensor_transform")
    parser.add_argument("--source_flanking", type=int, default=32)
    parser.add_argument("--collapse_strand", action="store_true")
    args = parser.parse_args(argv)

    from clair_tpu_torch.data.transform import transform_stream

    transform_stream(
        sys.stdin, sys.stdout, args.source_flanking, args.collapse_strand
    )


# ---------------------------------------------------------------------------
# post-processing commands
# ---------------------------------------------------------------------------

def cmd_overlap_variant(argv):
    from clair_tpu_torch.post.overlap_variant import run_filter

    run_filter(sys.stdin, sys.stdout)


def cmd_ensemble(argv):
    parser = argparse.ArgumentParser(prog="ensemble")
    parser.add_argument("--minimum_count_to_output", type=int, default=0)
    args = parser.parse_args(argv)

    from clair_tpu_torch.post.ensemble import combine_ensemble

    combine_ensemble(sys.stdin, sys.stdout, args.minimum_count_to_output)


def cmd_merge_gvcf(argv):
    parser = argparse.ArgumentParser(
        prog="merge_gvcf",
        description="GLnexus-style joint genotyping over single-sample "
                    "gVCFs (post/gvcf_merge.py): site unification, "
                    "genotype lifting, reference filling from blocks",
    )
    parser.add_argument("inputs", nargs="+", help="gVCF paths (.vcf/.gz)")
    parser.add_argument("--output_fn", help="joint VCF path (default stdout)")
    parser.add_argument("--sample_names",
                        help="comma-separated names overriding the headers")
    args = parser.parse_args(argv)

    from clair_tpu_torch.post.gvcf_merge import merge_gvcfs

    names = args.sample_names.split(",") if args.sample_names else None
    if names and len(names) != len(args.inputs):
        parser.error("--sample_names count must match inputs")
    if args.output_fn:
        with open(args.output_fn, "w") as fh:
            merge_gvcfs(args.inputs, fh, sample_names=names)
    else:
        merge_gvcfs(args.inputs, sys.stdout, sample_names=names)


def cmd_plot_tensor(argv):
    from clair_tpu_torch.plot_tensor import main as plot_main

    plot_main(argv)


def cmd_convert_tf1(argv):
    parser = argparse.ArgumentParser(
        prog="convert_tf1",
        description="Convert a reference TF1 checkpoint (Saver triplet "
                    "prefix) to a clair_tpu checkpoint — reads the bundle "
                    "directly, no tensorflow needed; handles both the "
                    "CudnnCompatibleLSTMCell and CudnnLSTM-blob layouts",
    )
    parser.add_argument("--chkpnt_fn", required=True,
                        help="TF checkpoint prefix (the path before .index)")
    parser.add_argument("--output_fn",
                        help="output checkpoint path (required unless "
                             "--audit_only)")
    parser.add_argument("--no_strict", action="store_true",
                        help="convert even if the structural audit fails "
                             "(missing/unexpected variables, shape drift)")
    parser.add_argument("--audit_only", action="store_true",
                        help="print the audit report and exit (nonzero on "
                             "failure) without writing a checkpoint")
    parser.add_argument("--lstm1_num_units", type=int, default=None,
                        help="override the expected LSTM1 width (convert "
                             "a resized model; default: reference size)")
    parser.add_argument("--lstm2_num_units", type=int, default=None,
                        help="override the expected LSTM2 width")
    args = parser.parse_args(argv)

    from clair_tpu_torch.models.audit import audit_tf1_vars
    from clair_tpu_torch.models.convert_tf1 import (
        convert_tf1_checkpoint, load_tf1_variables,
    )
    from clair_tpu_torch.params import ModelConfig

    config = ModelConfig()
    if args.lstm1_num_units:
        config = dataclasses.replace(config, lstm1_num_units=args.lstm1_num_units)
    if args.lstm2_num_units:
        config = dataclasses.replace(config, lstm2_num_units=args.lstm2_num_units)

    if args.audit_only:
        report = audit_tf1_vars(load_tf1_variables(args.chkpnt_fn), config)
        print(report.render())
        return 0 if report.ok else 1
    if not args.output_fn:
        parser.error("--output_fn is required unless --audit_only")
    report = convert_tf1_checkpoint(
        args.chkpnt_fn, args.output_fn, config, strict=not args.no_strict
    )
    print(report.render(), file=sys.stderr)
    print(f"wrote {args.output_fn}", file=sys.stderr)


def cmd_index_vcf(argv):
    parser = argparse.ArgumentParser(
        prog="index_vcf",
        description="Build a tabix (.tbi) index for a bgzipped VCF so "
                    "truth extraction can seek to windows (the reference "
                    "uses external `tabix`, GetTruth.py:88-95)",
    )
    parser.add_argument("--vcf_fn", required=True, help="bgzipped VCF")
    parser.add_argument("--tbi_fn", default=None, help="default: <vcf_fn>.tbi")
    args = parser.parse_args(argv)

    from clair_tpu_torch.io.tbi import build_tbi

    path = build_tbi(args.vcf_fn, args.tbi_fn)
    print(f"wrote {path}", file=sys.stderr)


def cmd_bam2cram(argv):
    parser = argparse.ArgumentParser(
        prog="bam2cram",
        description="Convert BAM to CRAM 3.0/3.1 (the reference relies on "
                    "samtools for this; clair_tpu carries its own stack)",
    )
    parser.add_argument("--bam_fn", required=True)
    parser.add_argument("--cram_fn", required=True)
    parser.add_argument("--ref_fn", required=True, help="reference FASTA")
    parser.add_argument("--embed_ref", action="store_true",
                        help="store each slice's reference span in the "
                             "CRAM (decodes without the FASTA)")
    parser.add_argument("--cram_version", default="3.0",
                        choices=["3.0", "3.1"],
                        help="3.1 compresses external blocks with rANS "
                             "Nx16 instead of rANS 4x8")
    parser.add_argument("--rans_x32", action="store_true",
                        help="3.1 only: write rANS Nx16 blocks with the "
                             "32-way interleaved entropy stage (htslib's "
                             "SIMD layout; reading X32 always works)")
    parser.add_argument("--codec", default=None,
                        choices=["rans4x16", "arith"],
                        help="3.1 only: external-block codec (default "
                             "rans4x16; arith is the adaptive-arithmetic "
                             "archive-profile coder)")
    parser.add_argument("--fqzcomp_quals", action="store_true",
                        help="3.1 only: compress the quality series with "
                             "the fqzcomp context model (archive profile)")
    args = parser.parse_args(argv)

    from clair_tpu_torch.io import cram as cram_mod
    from clair_tpu_torch.io.cram import bam_to_cram

    if args.rans_x32:
        cram_mod.RANS4X16_X32 = True
    version = tuple(int(v) for v in args.cram_version.split("."))
    writer_kwargs = {}
    if args.codec is not None:
        if version != (3, 1):
            parser.error("--codec requires --cram_version 3.1")
        writer_kwargs["method"] = (
            cram_mod.METHOD_ARITH if args.codec == "arith"
            else cram_mod.METHOD_RANS4X16
        )
    if args.fqzcomp_quals:
        if version != (3, 1):
            parser.error("--fqzcomp_quals requires --cram_version 3.1")
        writer_kwargs["fqzcomp_quals"] = True
    n = bam_to_cram(args.bam_fn, args.cram_fn, args.ref_fn,
                    embed_reference=args.embed_ref, version=version,
                    **writer_kwargs)
    print(f"wrote {args.cram_fn} ({n} records)", file=sys.stderr)


def cmd_view(argv):
    """samtools-view stand-in over the framework's own stacks: BAM / CRAM
    / SAM in, SAM text (default) or BAM out, optional region filter."""
    parser = argparse.ArgumentParser(
        prog="view",
        description="View/convert alignments (BAM/CRAM/SAM -> SAM or BAM) "
                    "without samtools",
    )
    parser.add_argument("--input_fn", required=True,
                        help="input .bam / .cram / .sam(.gz)")
    parser.add_argument("--output_fn", default=None,
                        help="output path; .bam writes BAM, anything else "
                             "(or stdout) writes SAM text")
    parser.add_argument("--ref_fn", default=None,
                        help="reference FASTA (required for most CRAMs)")
    parser.add_argument("--region", default=None,
                        help="ctg[:start-end], 1-based inclusive (BAM/CRAM)")
    args = parser.parse_args(argv)

    from clair_tpu_torch.io.bam import BamReader
    from clair_tpu_torch.io.cram import CramReader, is_cram
    from clair_tpu_torch.io.sam import SamReader, sam_to_bam, write_sam

    def parse_region(text):
        if ":" not in text:
            return text, None, None
        ctg, span = text.rsplit(":", 1)
        lo, _, hi = span.partition("-")
        return ctg, max(int(lo) - 1, 0), int(hi) if hi else None

    path = args.input_fn
    if path.endswith(".sam") or path.endswith(".sam.gz"):
        if args.region:
            parser.error("--region needs indexed input (BAM/CRAM)")
        if args.output_fn and args.output_fn.endswith(".bam"):
            n = sam_to_bam(path, args.output_fn)
        else:
            with SamReader(path) as reader:
                out = open(args.output_fn, "w") if args.output_fn else sys.stdout
                n = write_sam(iter(reader), reader.references, out,
                              header_text=reader.header_text)
                if args.output_fn:
                    out.close()
        print(f"{n} records", file=sys.stderr)
        return

    if is_cram(path):
        reader = CramReader(path, fasta=args.ref_fn, skip_quals=False,
                            collect_tags=True)
    else:
        reader = BamReader(path)
    try:
        if args.region:
            ctg, lo, hi = parse_region(args.region)
            records = reader.fetch(ctg, lo, hi, exclude_flag=0)
        else:
            records = iter(reader)
        if args.output_fn and args.output_fn.endswith(".bam"):
            from clair_tpu_torch.io.bam import BamWriter
            from clair_tpu_torch.io.bam import CIGAR_OPS as _OPS

            with BamWriter(args.output_fn, reader.references,
                           header_text=reader.header_text) as out:
                n = 0
                for rec in records:
                    out.write(
                        rec.read_name, rec.ref_id, rec.pos, rec.mapq,
                        rec.flag,
                        [(int(l), _OPS[o]) for o, l in
                         zip(rec.cigar_ops, rec.cigar_lens)],
                        rec.seq_str(), qual=rec.qual,
                        next_ref_id=rec.next_ref_id, next_pos=rec.next_pos,
                        tlen=rec.tlen, tags=rec.tags,
                    )
                    n += 1
        else:
            out = open(args.output_fn, "w") if args.output_fn else sys.stdout
            n = write_sam(records, reader.references, out,
                          header_text=reader.header_text)
            if args.output_fn:
                out.close()
    finally:
        close = getattr(reader, "close", None)
        if close:
            close()
    print(f"{n} records", file=sys.stderr)


def cmd_cram2bam(argv):
    parser = argparse.ArgumentParser(prog="cram2bam")
    parser.add_argument("--cram_fn", required=True)
    parser.add_argument("--bam_fn", required=True)
    parser.add_argument("--ref_fn", required=True, help="reference FASTA")
    args = parser.parse_args(argv)

    from clair_tpu_torch.io.cram import cram_to_bam

    n = cram_to_bam(args.cram_fn, args.bam_fn, args.ref_fn)
    print(f"wrote {args.bam_fn} ({n} records)", file=sys.stderr)


COMMANDS = {
    "call_var": cmd_call_var,
    "call_bam": cmd_call_bam,
    "callVarBam": cmd_call_bam,
    "call_bam_parallel": cmd_call_bam_parallel,
    "callVarBamParallel": cmd_call_bam_parallel,
    "train": cmd_train,
    "train_clr": cmd_train_clr,
    "evaluate": cmd_evaluate,
    "extract_candidates": cmd_extract_candidates,
    "ExtractVariantCandidates": cmd_extract_candidates,
    "create_tensor": cmd_create_tensor,
    "CreateTensor": cmd_create_tensor,
    "get_truth": cmd_get_truth,
    "GetTruth": cmd_get_truth,
    "pair_with_non_variants": cmd_pair_with_non_variants,
    "PairWithNonVariants": cmd_pair_with_non_variants,
    "tensor2bin": cmd_tensor2bin,
    "Tensor2Bin": cmd_tensor2bin,
    "combine_bins": cmd_combine_bins,
    "CombineBins": cmd_combine_bins,
    "convert_bin": cmd_convert_bin,
    "tensor_transform": cmd_tensor_transform,
    "TensorTransformer": cmd_tensor_transform,
    "overlap_variant": cmd_overlap_variant,
    "ensemble": cmd_ensemble,
    "merge_gvcf": cmd_merge_gvcf,
    "plot_tensor": cmd_plot_tensor,
    "index_vcf": cmd_index_vcf,
    "bam2cram": cmd_bam2cram,
    "view": cmd_view,
    "sam2bam": cmd_view,
    "cram2bam": cmd_cram2bam,
    "convert_tf1": cmd_convert_tf1,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m clair_tpu_torch <command> [options]\n\ncommands:")
        for name in COMMANDS:
            print(f"  {name}")
        return 0
    command = argv[0]
    if command not in COMMANDS:
        print(f"unknown command {command!r}; run with --help for the list",
              file=sys.stderr)
        return 1
    rc = COMMANDS[command](argv[1:])
    return rc if isinstance(rc, int) else 0
