"""Command-line dispatcher of the port: ``python -m clair_tpu_torch <command>``.

The calling commands take the same flags as the JAX package's and run its
own argument parsing and host runner (``clair_tpu.cli``, which imports no
JAX at module level). Only the predictor differs: ``clair_tpu.cli`` builds
every predictor through its module-level ``_predictor_from``, and
``_port_predictor`` swaps in this module's factory for the length of the
command, so the runner drives the port's CUDA ``Predictor``.

After a calling command, one JSON line on stderr reports how many times
each kernel of the port launched during it.
"""

from __future__ import annotations

import contextlib
import json
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
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream

    return {"bilstm_stream": bilstm_stream.launches}


def _run_with_port_predictor(command, argv):
    before = _kernel_counts()
    with _port_predictor():
        command(argv)
    after = _kernel_counts()
    launches = {k: after[k] - before[k] for k in after}
    print(json.dumps({"kernel_launches": launches}), file=sys.stderr)


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


COMMANDS = {
    "call_var": cmd_call_var,
    "call_bam": cmd_call_bam,
    "callVarBam": cmd_call_bam,
    "call_bam_parallel": cmd_call_bam_parallel,
    "callVarBamParallel": cmd_call_bam_parallel,
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
