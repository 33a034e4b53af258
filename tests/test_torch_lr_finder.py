"""The port's learning-rate finder against the JAX package's, the
``learning_rate_finder`` command, ``train --profile_dir`` and the trace
split of tools/torch_trace_split.py, on the CPU (their card twin is in
tests/test_torch_distributed.py, which imports nothing of the JAX
package)."""

import functools
import glob
import json
import math

import numpy as np
import pytest
import torch

import clair_tpu.data.bins as jax_bins
import clair_tpu.pipeline.lr_finder as jax_lr_finder
from clair_tpu_torch import cli
from clair_tpu_torch.data import bins
from clair_tpu_torch.models.clair import init_params
from clair_tpu_torch.ops import launch_counts
from clair_tpu_torch.pipeline.lr_finder import find_learning_rate
from tests.test_torch_train import SHORT, _bin, _numpy, jax_config

# the losses of a few Adam steps: optax rounds its bias correction in
# float32 (ROADMAP Queue 3), as tests/test_torch_train.py states for three
# train steps
LOSS_RTOL = 3e-4


def test_find_learning_rate_matches_the_jax_finder(tmp_path, monkeypatch):
    """One epoch of three steps from the same initial parameters, dropout
    off, 11 positions: the same learning rates, losses within LOSS_RTOL,
    the same accuracies and suggestions, and the same file but for the
    losses' last digits."""
    path = _bin(tmp_path, n=50, seed=3, positions=11)
    params = init_params(torch.Generator().manual_seed(1), SHORT)
    monkeypatch.setattr(jax_lr_finder, "init_params", lambda rng, config: _numpy(params))
    common = dict(min_lr=1e-4, max_lr=1e-2, train_batch_size=15, seed=0)
    want = jax_lr_finder.find_learning_rate(
        jax_bins.load_bin(path), jax_config(SHORT), output_path=str(tmp_path / "jax.txt"),
        **common)
    got = find_learning_rate(bins.load_bin(path), SHORT, output_path=str(tmp_path / "port.txt"),
                             device="cpu", **common)
    assert len(got.learning_rates) == 3
    assert got.learning_rates == want.learning_rates
    assert got.learning_rates == sorted(got.learning_rates)
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)
    assert got.accuracies == want.accuracies
    assert (got.suggested_min_lr, got.suggested_max_lr) == (want.suggested_min_lr,
                                                            want.suggested_max_lr)
    got_lines = open(tmp_path / "port.txt").read().splitlines()
    want_lines = open(tmp_path / "jax.txt").read().splitlines()
    assert got_lines[0] == want_lines[0] == "lr,accuracy,loss"
    assert got_lines[-2:] == want_lines[-2:]
    assert got_lines[-2].startswith("# suggested min_lr ")
    for g, w in zip(got_lines[1:-2], want_lines[1:-2]):
        assert g.split(",")[:2] == w.split(",")[:2]


def test_learning_rate_finder_command(tmp_path, capsys):
    """The command at full width on a small bin: the file with rising
    learning rates, finite losses and its two suggested lines, the printed
    suggestion, and the JSON line of kernel launches (none on the CPU)."""
    path = _bin(tmp_path, n=40, seed=4)
    out = str(tmp_path / "lr.txt")
    cli.cmd_learning_rate_finder(["--bin_fn", path, "--olog_fn", out], device="cpu")
    err, printed = capsys.readouterr()[::-1]
    assert printed.startswith("suggested min_lr ")
    assert json.loads(err.strip().splitlines()[-1])["kernel_launches"] == \
        dict.fromkeys(launch_counts(), 0)
    lines = open(out).read().splitlines()
    rows = [list(map(float, line.split(","))) for line in lines[1:-2]]
    assert lines[0] == "lr,accuracy,loss" and len(rows) == 1
    assert all(math.isfinite(loss) and 0.0 <= acc <= 1.0 for _, acc, loss in rows)
    assert [line.split()[:3] for line in lines[-2:]] == [["#", "suggested", "min_lr"],
                                                        ["#", "suggested", "max_lr"]]


def test_train_profile_dir_writes_a_trace(tmp_path, capsys):
    """``train --profile_dir`` on the CPU: one *.pt.trace.json that the
    chrome trace viewer reads, holding the train step's CPU ops."""
    path = _bin(tmp_path, n=40, seed=8)
    trace_dir = tmp_path / "trace"
    cli.cmd_train(["--bin_fn", path, "--maxEpoch", "1", "--train_compute_dtype", "float32",
                   "--decompress_workers", "0", "--profile_dir", str(trace_dir)], device="cpu")
    report = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert [e for _, e in report["training_losses"]] == [1]
    traces = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(traces) == 1
    events = json.load(open(traces[0]))["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("Optimizer.step") for n in names)
    assert any(n.startswith("autograd::engine::evaluate_function") for n in names)
    assert {"train_step.forward", "train_step.loss", "train_step.backward",
            "train_step.optimizer"} <= names
    from tools.torch_trace_split import split_train_steps

    split = split_train_steps(traces[0])
    assert split["steps"] == 1 and split["total_ms_per_step"] == 0.0  # no kernels on the CPU


def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def test_trace_split_ties_each_kernel_to_its_part(tmp_path):
    """tools/torch_trace_split.py on a made trace of two train steps: the
    rows by kernel name, the rest by the range that launched it; a kernel
    launched outside the train step (validation, the feed) is left out."""
    from tools.torch_trace_split import split_train_steps

    launch = functools.partial(_x, "cuda_runtime", "cudaLaunchKernel", dur=1)
    events = [
        _x("user_annotation", "train_step.forward", 0, 100, 1),
        launch(ts=10, tid=1, correlation=1), _x("kernel", "void bilstm_stream_fwd_kernel<1>(P)",
                                                1000, 50, 7, correlation=1),
        launch(ts=20, tid=1, correlation=2), _x("kernel", "elementwise", 1100, 10, 7,
                                                correlation=2),
        _x("user_annotation", "train_step.loss", 100, 100, 1),
        launch(ts=150, tid=1, correlation=3), _x("kernel", "softmax", 1200, 6, 7, correlation=3),
        _x("cpu_op", "autograd::engine::evaluate_function: FooBackward0", 200, 100, 2),
        launch(ts=210, tid=2, correlation=4), _x("kernel", "void mma_product<GateProblem>(P)",
                                                 1300, 30, 7, correlation=4),
        launch(ts=220, tid=2, correlation=5), _x("kernel", "gemm", 1400, 20, 7, correlation=5),
        _x("user_annotation", "train_step.optimizer", 300, 100, 1),
        launch(ts=310, tid=1, correlation=6), _x("kernel", "multi_tensor_apply_kernel", 1500, 8,
                                                 7, correlation=6),
        launch(ts=500, tid=1, correlation=7), _x("kernel", "eval_gemm", 1600, 100, 7,
                                                 correlation=7),
        _x("user_annotation", "train_step.forward", 600, 100, 1),
    ]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    split = split_train_steps(str(path))
    assert split["steps"] == 2
    assert split["per_step"] == [{"row 1": 0.05, "row 2": 0.03, "forward": 0.01,
                                  "loss": 0.006, "backward": 0.02, "optimizer": 0.008},
                                 dict.fromkeys(split["ms_per_step"], 0.0)]
    assert split["ms_per_step"] == {"row 1": 0.025, "row 2": 0.015, "forward": 0.005,
                                    "loss": 0.003, "backward": 0.01, "optimizer": 0.004}
    assert "eval_gemm" not in split["kernels_ms_per_step"]
    assert split["total_ms_per_step"] == pytest.approx(0.062)


@pytest.mark.parametrize("kernel", [
    "void (anonymous namespace)::lstm_bwd_sweep<(anonymous namespace)::SweepArgs, 2>(S)",
    "void (anonymous namespace)::bilstm_bwd_sweep_mma<32>(SweepArgs)",
    "void (anonymous namespace)::bilstm_bwd_sweep_fma<8>(SweepArgs)",
])
def test_trace_split_counts_every_backward_sweep_as_row_2(tmp_path, kernel):
    """Row 2's sweeps by name: the float32 cluster sweep (lstm_bwd_sweep)
    and the two bf16 sweeps count toward row 2 wherever autograd launches
    them, so the step's split stays whole."""
    from tools.torch_trace_split import split_train_steps

    events = [
        _x("user_annotation", "train_step.forward", 0, 100, 1),
        _x("cpu_op", "autograd::engine::evaluate_function: BiLSTMStreamBackward", 200, 100, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 1, 2, correlation=1),
        _x("kernel", kernel, 1300, 40, 7, correlation=1),
    ]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    split = split_train_steps(str(path))
    assert split["per_step"] == [{"row 1": 0.0, "row 2": 0.04, "forward": 0.0, "loss": 0.0,
                                  "backward": 0.0, "optimizer": 0.0}]


@pytest.mark.parametrize("kernel", [
    "void (anonymous namespace)::wgmma_product<(anonymous namespace)::TmaGateProblem>(P)",
    "void (anonymous namespace)::wgmma_product<(anonymous namespace)::TmaWeightSumProblem>(P)",
    "void (anonymous namespace)::wgmma_product<(anonymous namespace)::TmaDxProblem>(P)",
])
def test_trace_split_counts_the_bf16_products_as_row_2(tmp_path, kernel):
    """Row 2's bf16 products (wgmma fed by TMA) count toward row 2 by their
    own kernel name, so the bf16 step's split gives row 2 its whole time."""
    from tools.torch_trace_split import KERNEL_ROWS, split_train_steps

    assert "wgmma_product" in dict(KERNEL_ROWS)["row 2"]
    events = [
        _x("user_annotation", "train_step.forward", 0, 100, 1),
        _x("cpu_op", "autograd::engine::evaluate_function: BiLSTMStreamBackward", 200, 100, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 1, 2, correlation=1),
        _x("kernel", kernel, 1300, 40, 7, correlation=1),
    ]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    split = split_train_steps(str(path))
    assert split["per_step"] == [{"row 1": 0.0, "row 2": 0.04, "forward": 0.0, "loss": 0.0,
                                  "backward": 0.0, "optimizer": 0.0}]
