"""Command-line dispatcher of the port: ``python -m clair_tpu_torch <command>``.

The calling commands take the same flags as the JAX package's and run its
own argument parsing and host runner (``clair_tpu.cli``, which imports no
JAX at module level). Only the predictor differs: ``clair_tpu.cli`` builds
every predictor through its module-level ``_predictor_from``, and
``_port_predictor`` swaps in this module's factory for the length of the
command, so the runner drives the port's CUDA ``Predictor``.

The training commands (``train``, ``train_clr``, ``evaluate``) take the JAX
package's flags but run the port's own loop (``pipeline/train.py``) on one
CUDA device; the flags of what is not ported yet (multi-GPU, profiling)
raise NotImplementedError, as does ``--no_stream_bilstm``, whose lax.scan
BiLSTM the port keeps off the card.

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

from clair_tpu import cli as jax_cli


def _predictor_from(checkpoint_path, batch_size=None, dtype=None,
                    num_devices=None):
    """The port's counterpart of clair_tpu.cli._predictor_from: one CUDA
    device; the compute dtype defaults to PREDICT_COMPUTE_DTYPE (bfloat16)
    as in the JAX CLI."""
    from clair_tpu.params import (
        PREDICT_BATCH_SIZE, PREDICT_COMPUTE_DTYPE, ModelConfig,
    )
    from clair_tpu_torch.models.checkpoint import load_checkpoint
    from clair_tpu_torch.pipeline.call_var import Predictor

    if num_devices and num_devices > 1:
        raise NotImplementedError(
            "--num_devices > 1: multi-GPU calling is not ported yet"
        )
    params, _ = load_checkpoint(checkpoint_path)
    config = ModelConfig(compute_dtype=dtype or PREDICT_COMPUTE_DTYPE)
    return Predictor(params, config, batch_size or PREDICT_BATCH_SIZE)


@contextlib.contextmanager
def _port_predictor():
    saved = jax_cli._predictor_from
    jax_cli._predictor_from = _predictor_from
    try:
        yield
    finally:
        jax_cli._predictor_from = saved


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


def _run_with_port_predictor(command, argv):
    with _reporting_launches({}), _port_predictor():
        command(argv)


def _given(argv, flag):
    return any(a == flag or a.startswith(flag + "=") for a in argv)


def cmd_call_var(argv):
    if _given(argv, "--activation_only"):
        raise NotImplementedError("--activation_only (forward_activations) is "
                                  "not ported yet")
    _run_with_port_predictor(jax_cli.cmd_call_var, argv)


def cmd_call_bam(argv):
    _run_with_port_predictor(jax_cli.cmd_call_bam, argv)


def cmd_call_bam_parallel(argv):
    """The in-process runners only (--run, --work_dir, --finalize_only):
    the process pool builds its predictors in the JAX package's own worker
    (call_bam_parallel._run_window), and the command sheet names the JAX
    CLI."""
    if _given(argv, "--process_pool"):
        raise NotImplementedError("--process_pool is not ported yet; drop it for "
                                  "the threaded single-device runner")
    if not any(_given(argv, f) for f in ("--run", "--work_dir", "--finalize_only")):
        raise NotImplementedError("the command sheet (no --run) is not ported yet: "
                                  "it prints JAX-package commands; pass --run")
    _run_with_port_predictor(jax_cli.cmd_call_bam_parallel, argv)


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
    jax_cli._add_dataset_args(parser)
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

    from clair_tpu.params import (
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
    jax_cli._add_dataset_args(parser)
    parser.add_argument("--chkpnt_fn", required=True)
    args = parser.parse_args(argv)
    logging.basicConfig(format="%(message)s", level=logging.INFO)

    from clair_tpu.params import ModelConfig
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
