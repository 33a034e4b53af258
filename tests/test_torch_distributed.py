"""Multi-process training of the port on torch.distributed, on the CPU:
two rank processes (gloo) training under make_mesh against one process at
the same global batch, resume through a broadcast from rank 0, a load
failure raised on every rank, the padded-batch loss, the mesh's and the
command's refusals, and ``train --num_devices 2``. Every spawn has a
wall-clock limit and every process group a 60 s timeout, so a hang fails
its test. The card twins (``cuda``) run DDP on one card (world size 1 on
NCCL against the unwrapped step, and two ranks on cuda:0 with gloo), and
check what the learning-rate finder and ``train --profile_dir`` launch."""

import dataclasses
import functools
import glob
import json
import math
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from clair_tpu_torch import cli
from clair_tpu_torch.data import bins
from clair_tpu_torch.models.checkpoint import checkpoint_path
from clair_tpu_torch.models.clair import ClairNet, init_params
from clair_tpu_torch.ops import launch_counts, launches_since
from clair_tpu_torch.parallel.distributed import (
    broadcast_checkpoint, check_multihost_mesh, free_port, init_distributed, local_stripe,
    process_info, spawn,
)
from clair_tpu_torch.parallel.mesh import make_mesh
from clair_tpu_torch.parallel.sharding import make_eval_step
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline import train as train_module
from clair_tpu_torch.pipeline.train import TrainingConfig, train_model, train_on_devices

NARROW = ModelConfig(lstm1_num_units=8, lstm2_num_units=8, l3_num_units=4,
                     l4_num_units=16, l5_num_units=8, lstm2_dropout_rate=0.0,
                     l4_dropout_rate=0.0, l5_dropout_rate=0.0)
# the JAX test's tolerance (tests/test_distributed.py): the ranks' gradient
# sums run in another order than one process's
LOSS_RTOL = 1e-3
SPAWN_TIMEOUT_S, GROUP_TIMEOUT_S = 600, 60
# batches of 15 rows: every global train batch pads to 16 for two ranks,
# with one weight-0 row
CONFIG = TrainingConfig(model=NARROW, schedule="fixed", max_epochs=3, train_batch_size=15,
                        val_batch_size=5, seed=7, evaluate_at_end=False,
                        decompress_workers=0, device="cpu", train_compute_dtype="float32")


def write_bin(path, n=64, block=8, seed=5, positions=33):
    """A learnable bin (the genotype shows in x's SNP channel)."""
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 20, (n, positions, 8, 4)).astype(np.float32)
    y = np.zeros((n, 90), np.float32)
    hom = np.arange(n) % 2 == 1
    x[hom, :, :, 3] += 20
    y[~hom, 0] = y[hom, 6] = 1.0
    y[~hom, 21] = y[hom, 22] = 1.0
    y[:, 24 + 16] = y[:, 57 + 16] = 1.0
    offs = range(0, n, block)
    bins.write_bin(path, bins.BinDataset(
        n, [bins._pack(x[o:o + block]) for o in offs], [bins._pack(y[o:o + block]) for o in offs],
        [bins._pack(np.array([f"chr1:{o + j}" for j in range(block)])) for o in offs], block))
    return path


def _losses(result):
    return ([v for v, _ in result.training_losses], [v for v, _ in result.validation_losses])


def _train_resume_and_fail(rank, world, address, bin_path, prefix):
    """One rank: train three epochs under make_mesh (rank 0 writes the
    checkpoints), resume a fourth epoch from rank 0's epoch-3 checkpoint
    (the other ranks are given a path that does not exist), then a failed
    load on rank 0, which must raise on every rank."""
    torch.set_num_threads(1)
    init_distributed(address, world, rank, "cpu", timeout_s=GROUP_TIMEOUT_S)
    try:
        assert process_info() == (rank, world)
        config = dataclasses.replace(CONFIG, mesh=make_mesh(world, device_type="cpu"),
                                     output_prefix=prefix)
        first = train_model(bins.load_bin(bin_path), config)
        resume_from = (checkpoint_path(prefix, 3) if rank == 0
                       else prefix + "-missing-000001")
        second = train_model(bins.load_bin(bin_path), dataclasses.replace(
            config, max_epochs=4, init_checkpoint=resume_from, output_prefix=None,
            restore_best=False))
        try:
            broadcast_checkpoint(prefix + "-absent-000009")
            failure = None
        except RuntimeError as exc:
            failure = str(exc)
        return {"first": _losses(first), "best_epoch": first.best_epoch,
                "l4": first.params["l4"]["w"], "resumed": second.training_losses,
                "resumed_val": second.validation_losses, "failure": failure}
    finally:
        dist.destroy_process_group()


def test_two_process_training_matches_single_process(tmp_path):
    """Two gloo ranks against one process, three epochs at the same global
    batch: both ranks report the same losses, best epoch and parameters,
    within LOSS_RTOL of the single process's; rank 0 alone wrote the
    checkpoints; the resumed epoch is epoch 4 on both ranks although rank 1
    was given no checkpoint; rank 0's failed load raises on both."""
    bin_path = write_bin(str(tmp_path / "train.bin"))
    single = train_model(bins.load_bin(bin_path), CONFIG)
    ranks = spawn(_train_resume_and_fail, 2,
                  (2, f"localhost:{free_port()}", bin_path, str(tmp_path / "ddp")),
                  timeout_s=SPAWN_TIMEOUT_S)
    r0, r1 = ranks
    assert r0["first"] == r1["first"] and r0["best_epoch"] == r1["best_epoch"]
    np.testing.assert_array_equal(r0["l4"], r1["l4"])
    for got, want in zip(r0["first"], _losses(single)):
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert r0["best_epoch"] == single.best_epoch
    assert r0["first"][0][-1] < r0["first"][0][0]
    assert sorted(p.name for p in tmp_path.glob("ddp-*")) == [
        "ddp-000001", "ddp-000002", "ddp-000003"]
    assert r0["resumed"] == r1["resumed"] and [e for _, e in r0["resumed"]] == [4]
    assert r0["resumed_val"] == r1["resumed_val"]
    for rank in ranks:
        assert "process 0 failed to load" in rank["failure"]
        assert "absent-000009" in rank["failure"]


def test_padded_rows_do_not_change_the_loss():
    """As tests/test_sharded_training.py: rows with sample weight 0 (the
    padding to the data axis) leave the eval loss as it was."""
    model = ClairNet.from_jax(init_params(torch.Generator().manual_seed(0), NARROW), NARROW)
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.rand(5, 33, 8, 4).astype(np.float32))
    y = torch.zeros(5, 90)
    y[:, 0] = y[:, 21] = y[:, 40] = y[:, 73] = 1.0
    step = make_eval_step(model)
    plain, _ = step(x, y, 0.005)
    pad_x = torch.cat([x, torch.zeros(3, 33, 8, 4)])
    pad_y = torch.cat([y, torch.zeros(3, 90)])
    weights = torch.tensor([1.0] * 5 + [0.0] * 3)
    padded, _ = step(pad_x, pad_y, 0.005, weights)
    np.testing.assert_allclose(padded.item(), plain.item(), rtol=1e-5)


def test_train_command_on_two_processes(tmp_path, capsys, monkeypatch):
    """``train --num_devices 2`` spawns two ranks (here on the CPU, gloo)
    at full width: rank 0's losses and the ranks' launches (none on the
    CPU) in the JSON line, one checkpoint per epoch."""
    monkeypatch.setattr(train_module, "train_on_devices",
                        functools.partial(train_on_devices, timeout_s=SPAWN_TIMEOUT_S))
    bin_path = write_bin(str(tmp_path / "train.bin"), n=40, block=10, seed=8)
    prefix = str(tmp_path / "model")
    cli.cmd_train(["--bin_fn", bin_path, "--ochk_prefix", prefix, "--maxEpoch", "1",
                   "--train_compute_dtype", "float32", "--decompress_workers", "0",
                   "--num_devices", "2"], device="cpu")
    report = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert report["kernel_launches"] == dict.fromkeys(launch_counts(), 0)
    assert [e for _, e in report["training_losses"]] == [1]
    assert all(math.isfinite(v) for v, _ in report["validation_losses"])
    assert sorted(p.name for p in tmp_path.glob("model-*")) == ["model-000001"]


def test_multi_host_flags_are_checked_before_anything_runs():
    base = ["train", "--bin_fn", "unused.bin"]
    for flags in (["--coordinator_address", "localhost:1"],
                  ["--coordinator_address", "localhost:1", "--num_processes", "2",
                   "--process_id", "0", "--num_devices", "4"],
                  ["--process_id", "0"]):
        with pytest.raises(SystemExit) as exit_info:
            cli.main(base + flags)
        assert exit_info.value.code == 2


def test_make_mesh_refusals():
    """No mesh without a process group; a mesh must hold every rank, no
    fewer and no more, with or without a model axis."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised torch.distributed process group"):
        make_mesh(1, device_type="cpu")
    init_distributed(f"localhost:{free_port()}", 1, 0, "cpu", timeout_s=GROUP_TIMEOUT_S)
    try:
        assert process_info() == (0, 1)
        with pytest.raises(ValueError, match="needs 2 devices but only 1 are visible"):
            make_mesh(2, device_type="cpu")
        with pytest.raises(ValueError, match="needs 2 devices but only 1 are visible"):
            make_mesh(2, model_parallel=2, device_type="cpu")
        mesh = make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        check_multihost_mesh(mesh, 1)
    finally:
        dist.destroy_process_group()
    assert process_info() == (0, 1)


def test_check_multihost_mesh_and_local_stripe():
    def stub(grid, names=("data", "model")):
        return types.SimpleNamespace(mesh=torch.tensor(grid), mesh_dim_names=names)

    check_multihost_mesh(stub([[0], [1], [2], [3]]), 4)
    check_multihost_mesh(stub([[0, 1, 2, 3]], ("model", "data")), 4)
    with pytest.raises(ValueError, match="ascend"):
        check_multihost_mesh(stub([[1], [0]]), 2)
    with pytest.raises(ValueError, match="once"):
        check_multihost_mesh(stub([[0], [0]]), 2)
    with pytest.raises(ValueError, match="once"):
        check_multihost_mesh(stub([[0], [1]]), 3)
    assert [local_stripe(12, p, 3) for p in range(3)] == [slice(0, 4), slice(4, 8),
                                                         slice(8, 12)]


def _sleep(rank, seconds):
    time.sleep(seconds)


def _raise(rank):
    raise ValueError(f"rank {rank} stops here")


def test_spawn_bounds_and_reports_its_processes():
    assert spawn(divmod, 2, (1,), timeout_s=SPAWN_TIMEOUT_S) == [(0, 0), (1, 0)]
    started = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 1"):
        spawn(_sleep, 2, (120,), timeout_s=1)
    assert time.monotonic() - started < 60
    with pytest.raises(Exception, match="rank 1 stops here|rank 0 stops here"):
        spawn(_raise, 2, timeout_s=SPAWN_TIMEOUT_S)


def test_init_distributed_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        init_distributed("localhost:1", 2, 0, "cuda")


@pytest.mark.cuda
def test_cuda_world_size_one_equals_the_unwrapped_run(tmp_path):
    """On the card: DDP at world size 1 on NCCL (train_on_devices) and the
    unwrapped train_model, the same bin, dropout off: the same losses, and
    the streaming pair launched in the rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    bin_path = write_bin(str(tmp_path / "train.bin"))
    config = dataclasses.replace(CONFIG, device="cuda")
    single = train_model(bins.load_bin(bin_path), config)
    result, launches = train_on_devices(functools.partial(bins.load_bin, bin_path), config, 1,
                                        timeout_s=SPAWN_TIMEOUT_S)
    assert _losses(result) == _losses(single)
    assert launches["bilstm_stream"] > 0 and launches["bilstm_stream_backward"] > 0


@pytest.mark.cuda
def test_cuda_two_ranks_on_one_card_with_gloo(tmp_path):
    """On the card: two ranks on cuda:0 with gloo (NCCL refuses two ranks
    on one device) against one process at the same global batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    bin_path = write_bin(str(tmp_path / "train.bin"))
    config = dataclasses.replace(CONFIG, device="cuda")
    single = train_model(bins.load_bin(bin_path), config)
    result, launches = train_on_devices(functools.partial(bins.load_bin, bin_path), config, 2,
                                        backend="gloo", devices=["cuda:0", "cuda:0"],
                                        timeout_s=SPAWN_TIMEOUT_S)
    for got, want in zip(_losses(result), _losses(single)):
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert launches["bilstm_stream"] > 0 and launches["bilstm_stream_backward"] > 0


@pytest.mark.cuda
def test_cuda_lr_finder_and_profile_dir_launch_rows_1_and_2(tmp_path, capsys):
    """On the card: the finder (float32 by default) and a profiled train
    epoch launch only the streaming pair, and the trace holds its kernels
    by name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    path = write_bin(str(tmp_path / "train.bin"), n=40, block=10, seed=4)
    before = launch_counts()
    cli.cmd_learning_rate_finder(["--bin_fn", path, "--olog_fn", str(tmp_path / "lr.txt")])
    launched = launches_since(before)
    assert {k for k, v in launched.items() if v} == {"bilstm_stream", "bilstm_stream_backward"}
    cli.cmd_train(["--bin_fn", path, "--maxEpoch", "1", "--profile_dir",
                   str(tmp_path / "trace")])
    (trace,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    kernels = {e["name"] for e in json.load(open(trace))["traceEvents"]
               if e.get("cat") == "kernel"}
    assert any("bilstm_stream_fwd" in k for k in kernels), sorted(kernels)[:20]
    assert any("bilstm_bwd_sweep" in k for k in kernels), sorted(kernels)[:20]
