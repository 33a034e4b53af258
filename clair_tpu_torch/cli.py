"""Command-line dispatcher of the port: ``python -m clair_tpu_torch <command>``.

The calling commands (``call_var``, ``call_bam``, ``call_bam_parallel``)
are the JAX package's own parsers and runners (clair_tpu/cli.py), copied
here over the port's host side, with the port's CUDA ``Predictor`` built by
``_predictor_from``. ``call_bam_parallel`` without ``--run`` prints its
command sheet of ``python -m clair_tpu_torch call_bam`` lines.

The training commands (``train``, ``train_clr``, ``evaluate``) take the JAX
package's flags but run the port's own loop (``pipeline/train.py``) on one
CUDA device; the flags of what is not ported yet (multi-GPU, profiling,
the process pool, activation dumps) raise NotImplementedError, as does
``--no_stream_bilstm``, whose lax.scan BiLSTM the port keeps off the card.

After a command, one JSON line on stderr reports how many times each kernel
of the port launched during it; after a training command it also carries
the per-epoch (loss sum, epoch) pairs and the best epoch.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import sys


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
            "--num_devices > 1: multi-GPU calling is not ported yet"
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
                                  "yet (ROADMAP Queue 1 item 5)")

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


def _call_bam_parallel(argv):
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
        # call_bam_parallel's pool builds a predictor per worker process
        raise NotImplementedError(
            "--process_pool is not ported yet (ROADMAP Queue 1 item 3); drop it for the "
            "threaded single-device runner")
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


def cmd_call_bam_parallel(argv):
    with _reporting_launches({}):
        _call_bam_parallel(argv)


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
         "--num_devices > 1: multi-GPU training", "Queue 1 item 6"),
        (args.coordinator_address is not None,
         "--coordinator_address: multi-host training", "Queue 1 item 6"),
        (args.model_parallel > 1, "--model_parallel > 1: the sharded dense trunk",
         "Queue 1 item 6"),
        (args.profile_dir is not None, "--profile_dir: a profiler trace of training",
         "Queue 1 item 5"),
    )
    for given, what, item in refused:
        if given:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")
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


COMMANDS = {
    "call_var": cmd_call_var,
    "call_bam": cmd_call_bam,
    "callVarBam": cmd_call_bam,
    "call_bam_parallel": cmd_call_bam_parallel,
    "callVarBamParallel": cmd_call_bam_parallel,
    "train": cmd_train,
    "train_clr": cmd_train_clr,
    "evaluate": cmd_evaluate,
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
