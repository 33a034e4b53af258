"""The port's model axis (parallel/tensor_parallel.py): the dense trunk split
Megatron-style over a ('data', 'model') DeviceMesh, on the CPU with gloo
ranks. A (2, 2) mesh against the JAX package's meshed train step on the
virtual CPU mesh, with its clip, checkpoint and resume; a (1, 2) mesh with
dropout on against one process; ``train --num_devices 2 --model_parallel
2``; and the refusals. Every spawn has a wall-clock limit and every process
group a 60 s timeout, so a hang fails its test. The card twin (``cuda``)
runs the (1, 2) case on two gloo ranks on cuda:0.

Spawned ranks import this module by name, so it imports no JAX at its top:
the JAX side is imported inside the tests."""

import dataclasses
import functools
import json
import math
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from clair_tpu_torch import cli
from clair_tpu_torch.data import bins
from clair_tpu_torch.models.checkpoint import checkpoint_path, load_checkpoint
from clair_tpu_torch.models.clair import ClairNet, init_params, param_shapes
from clair_tpu_torch.models.layers import alpha_dropout
from clair_tpu_torch.ops import launch_counts
from clair_tpu_torch.parallel.distributed import (
    free_port, init_distributed, local_stripe, spawn,
)
from clair_tpu_torch.parallel.mesh import make_mesh
from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step
from clair_tpu_torch.parallel.tensor_parallel import (
    TensorParallel, gather_params, param_specs, shard_dim, shard_params,
)
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline import train as train_module
from clair_tpu_torch.pipeline.train import TrainingConfig, train_model, train_on_devices
from test_torch_distributed import GROUP_TIMEOUT_S, write_bin

# the widths of tests/test_sharded_training.py; the JAX comparison runs 11
# positions, as tests/test_torch_train.py's does, for XLA's compile time
NARROW = ModelConfig(lstm1_num_units=8, lstm2_num_units=8, l3_num_units=4,
                     l4_num_units=16, l5_num_units=8)
SHORT = dataclasses.replace(NARROW, lstm2_dropout_rate=0.0, l4_dropout_rate=0.0,
                            l5_dropout_rate=0.0, input_shape=(11, 8, 4))
SPAWN_TIMEOUT_S = 300
# the (2, 2) run's epochs: 36 train rows (one step of 36), 4 validation rows
EPOCHS = TrainingConfig(model=SHORT, schedule="fixed", max_epochs=2, train_batch_size=36,
                        val_batch_size=4, seed=7, evaluate_at_end=False, decompress_workers=0,
                        device="cpu", train_compute_dtype="float32")
BATCH, STEPS, L2_LAMBDA = 16, 3, 0.005


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.array(v, np.float32)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(v)


def _batches(rs):
    """STEPS global batches of BATCH rows, large integer counts as in the
    feed: the focal loss's gradient is large enough for the clip."""
    out = []
    for _ in range(STEPS):
        x = rs.randint(0, 50, (BATCH, 11, 8, 4)).astype(np.float32)
        y = np.zeros((BATCH, 90), np.float32)
        for off, width in ((0, 21), (21, 3), (24, 33), (57, 33)):
            y[np.arange(BATCH), off + rs.randint(0, width, BATCH)] = 1.0
        out.append((x, y))
    return out


def _steps(model, optimizer, mesh, batches, rows):
    """The losses and clip norms of make_train_step over ``batches``
    (their ``rows``)."""
    norms = []
    clip_and_update = optimizer.step
    optimizer.step = lambda *tp: norms.append(clip_and_update(*tp).item())
    step = make_train_step(model, optimizer, mesh)
    losses = []
    for x, y in batches:
        loss, _ = step(torch.from_numpy(x[rows]), torch.from_numpy(y[rows]),
                       torch.Generator(), L2_LAMBDA)
        losses.append(loss.item())
    return losses, norms


def _two_by_two(rank, world, address, params, batches, bin_path, prefix):
    """One rank of the (2, 2) mesh: STEPS Adam steps of make_train_step on
    its data row's stripe, the gathered parameters; then train_model for
    two epochs writing checkpoints, and a resume of epoch 2 from epoch 1's
    (loaded on rank 0 alone)."""
    torch.set_num_threads(1)
    init_distributed(address, world, rank, "cpu", timeout_s=GROUP_TIMEOUT_S)
    try:
        mesh = make_mesh(world, model_parallel=2, device_type="cpu")
        tp = TensorParallel.of(mesh)
        model = ClairNet.from_jax(shard_params(params, tp.index, tp.size), SHORT, "cpu", tp)
        optimizer = make_optimizer(dict(model.named_parameters()), "Adam", 1e-3)
        rows = local_stripe(BATCH, mesh.get_local_rank("data"), 2)
        losses, norms = _steps(model, optimizer, mesh, batches, rows)
        state = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
        config = dataclasses.replace(EPOCHS, mesh=mesh, output_prefix=prefix)
        first = train_model(bins.load_bin(bin_path), config)
        resumed = train_model(bins.load_bin(bin_path), dataclasses.replace(
            config, output_prefix=None, restore_best=False,
            init_checkpoint=checkpoint_path(prefix, 1) if rank == 0 else prefix + "-000009"))
        return {"position": (mesh.get_local_rank("data"), tp.index), "losses": losses,
                "norms": norms, "state": state, "gathered": gather_params(model, mesh),
                "first": first.training_losses, "first_params": first.params,
                "resumed": resumed.training_losses}
    finally:
        dist.destroy_process_group()


def _jax_meshed_steps(params, batches):
    """The JAX package's make_train_step on its (2, 2) mesh of the virtual
    CPU devices (inputs put as tests/test_parallel.py puts them)."""
    import jax

    from clair_tpu.parallel import sharding as jax_sharding
    from clair_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from clair_tpu.params import ModelConfig as JaxModelConfig

    config = JaxModelConfig(**dataclasses.asdict(SHORT))
    optimizer = jax_sharding.make_optimizer("Adam", 1e-3)
    mesh = jax_make_mesh(4, model_parallel=2)
    p = jax.device_put(params, jax_sharding.param_shardings(params, mesh))
    state = jax.device_put(optimizer.init(params), jax.tree.map(
        lambda _: jax_sharding.replicate(mesh), optimizer.init(params)))
    step = jax_sharding.make_train_step(config, optimizer, mesh)
    losses = []
    with mesh:
        for x, y in batches:
            p, state, loss, _ = step(p, state, jax.device_put(x, jax_sharding.batch_sharding(mesh, 4)),
                                     jax.device_put(y, jax_sharding.batch_sharding(mesh, 2)),
                                     jax.random.PRNGKey(3), np.float32(L2_LAMBDA))
            losses.append(float(loss))
    return losses, _numpy(jax.device_get(p))


def test_two_by_two_mesh_matches_the_jax_meshed_step(tmp_path):
    """Four gloo ranks on a (2, 2) mesh, f32, dropout off, three Adam steps,
    against the JAX package's meshed step from the same parameters and
    batches: losses within rtol 1e-4 at each step, the gathered parameters
    within rtol 1e-3, atol 1e-5 (tests/test_parallel.py's); replicated
    leaves bit for bit the same on every rank, each shard on its column's
    two ranks; the clip's norm (engaged: above 5) the unsharded port
    step's within rtol 1e-5. Then train_model on the mesh: rank 0 wrote
    full-shape checkpoints, and a resume from epoch 1's gives epoch 2's
    training loss (its one step's, before the update) of the run that went
    on."""
    params = _numpy(init_params(torch.Generator().manual_seed(0), SHORT))
    batches = _batches(np.random.RandomState(5))
    bin_path = write_bin(str(tmp_path / "train.bin"), n=40, block=8, positions=11)
    prefix = str(tmp_path / "mp")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, _two_by_two, 4, (4, f"localhost:{free_port()}", params,
                                                     batches, bin_path, prefix),
                            timeout_s=SPAWN_TIMEOUT_S)
        jax_losses, jax_params = _jax_meshed_steps(params, batches)
        ranks = ranks.result()
    assert [r["position"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]

    model = ClairNet.from_jax(params, SHORT, "cpu")
    _, unsharded_norms = _steps(model, make_optimizer(dict(model.named_parameters()), "Adam",
                                                      1e-3), None, batches, slice(None))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jax_losses, rtol=1e-4)
        assert r["norms"][0] > 5.0, r["norms"]
        np.testing.assert_allclose(r["norms"][0], unsharded_norms[0], rtol=1e-5)
        for name, value in _leaves(r["gathered"]):
            np.testing.assert_allclose(value, dict(_leaves(jax_params))[name], rtol=1e-3,
                                       atol=1e-5, err_msg=name)
    for name in ranks[0]["state"]:
        groups = [[0, 1, 2, 3]] if shard_dim(name) is None else [[0, 2], [1, 3]]
        for lead, *others in groups:
            for other in others:
                np.testing.assert_array_equal(ranks[other]["state"][name],
                                              ranks[lead]["state"][name], err_msg=name)

    full = param_shapes(SHORT)
    for epoch in (1, 2):
        saved, extra = load_checkpoint(checkpoint_path(prefix, epoch))
        assert extra["epoch"] == epoch
        assert {k: v.shape for k, v in _leaves(saved)} == {k: tuple(v) for k, v in _leaves(full)}
    for r in ranks:
        assert r["first"] == ranks[0]["first"] and [e for _, e in r["resumed"]] == [2]
        np.testing.assert_allclose(r["resumed"][0][0], r["first"][1][0], rtol=1e-5)
        for name, value in _leaves(r["first_params"]):
            np.testing.assert_array_equal(value, dict(_leaves(ranks[0]["first_params"]))[name])


def test_one_by_two_mesh_with_dropout_matches_one_process(tmp_path):
    """Two gloo ranks on a (1, 2) mesh, dropout on, one epoch of
    train_model against the port's single process at the same seed: the
    ranks draw the full-width L4 mask and keep their columns, so the run
    is the single process's within rtol 1e-4."""
    bin_path = write_bin(str(tmp_path / "train.bin"), n=40, block=8)
    config = dataclasses.replace(EPOCHS, model=NARROW, max_epochs=1, train_batch_size=12,
                                 val_batch_size=4)
    assert config.model.l4_dropout_rate > 0 and config.model.l5_dropout_rate > 0
    single = train_model(bins.load_bin(bin_path), config)
    result, _ = train_on_devices(functools.partial(bins.load_bin, bin_path), config, 2,
                                 timeout_s=SPAWN_TIMEOUT_S, model_parallel=2)
    for key in ("training_losses", "validation_losses"):
        got, want = getattr(result, key), getattr(single, key)
        assert [e for _, e in got] == [e for _, e in want] == [1]
        np.testing.assert_allclose([v for v, _ in got], [v for v, _ in want], rtol=1e-4)
    for name, value in _leaves(result.params):
        np.testing.assert_allclose(value, dict(_leaves(single.params))[name], rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_train_command_with_a_model_axis(tmp_path, capsys, monkeypatch):
    """``train --num_devices 2 --model_parallel 2`` (here two gloo ranks on
    the CPU) at full width: one checkpoint, at the full shapes."""
    monkeypatch.setattr(train_module, "train_on_devices",
                        functools.partial(train_on_devices, timeout_s=SPAWN_TIMEOUT_S))
    bin_path = write_bin(str(tmp_path / "train.bin"), n=40, block=10, seed=8)
    prefix = str(tmp_path / "model")
    cli.cmd_train(["--bin_fn", bin_path, "--ochk_prefix", prefix, "--maxEpoch", "1",
                   "--train_compute_dtype", "float32", "--decompress_workers", "0",
                   "--num_devices", "2", "--model_parallel", "2"], device="cpu")
    report = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert report["kernel_launches"] == dict.fromkeys(launch_counts(), 0)
    assert all(math.isfinite(v) for v, _ in report["validation_losses"])
    assert sorted(p.name for p in tmp_path.glob("model-*")) == ["model-000001"]
    saved, _ = load_checkpoint(checkpoint_path(prefix, 1))
    assert {k: v.shape for k, v in _leaves(saved)} == {
        k: tuple(v) for k, v in _leaves(param_shapes(ModelConfig()))}
    assert saved["l4"]["w"].shape == (7680, 192) and saved["l5_1"]["w"].shape == (192, 96)


def test_param_specs_follow_the_jax_rule():
    """Every leaf shards where the JAX package's param_specs puts 'model',
    and param_shapes(config, m) are shard_params' shapes."""
    import jax
    from jax.sharding import PartitionSpec

    from clair_tpu.parallel.sharding import param_specs as jax_param_specs

    params = _numpy(init_params(torch.Generator().manual_seed(1), NARROW))
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jax_param_specs(params), is_leaf=lambda x: isinstance(x, PartitionSpec))[0]:
        dims = [d for d, axis in enumerate(spec) if axis == "model"]
        want[".".join(k.key for k in path)] = dims[0] if dims else None
    assert dict(_leaves(param_specs(params))) == {k: np.asarray(v) for k, v in want.items()}
    assert sum(v is not None for v in want.values()) == 6
    for m in (2, 4):
        shards = [shard_params(params, i, m) for i in range(m)]
        for name, value in _leaves(shards[0]):
            assert value.shape == tuple(dict(_leaves(param_shapes(NARROW, m)))[name]), name
        for name, value in _leaves(params):
            dim = shard_dim(name)
            parts = [dict(_leaves(s))[name] for s in shards]
            joined = parts[0] if dim is None else np.concatenate(parts, dim)
            np.testing.assert_array_equal(joined, value, err_msg=name)


def test_sharded_alpha_dropout_cuts_the_full_width_mask():
    """The blocks' masks, side by side, are the full-width draw's."""
    x = torch.randn(6, 12)
    full = alpha_dropout(torch.Generator().manual_seed(3), x, 0.5)
    parts = [alpha_dropout(torch.Generator().manual_seed(3), x[:, i * 4:(i + 1) * 4], 0.5,
                           shard=(i, 3)) for i in range(3)]
    assert torch.equal(torch.cat(parts, 1), full)


def test_model_axis_refusals():
    """As the JAX package: L4's units must divide by the model axis
    (jax.device_put's "should be divisible by 3"), and the model axis must
    divide the devices (make_mesh, in a group of one)."""
    params = init_params(torch.Generator().manual_seed(0), NARROW)
    with pytest.raises(ValueError, match="should be divisible by 3"):
        shard_params(params, 0, 3)
    init_distributed(f"localhost:{free_port()}", 1, 0, "cpu", timeout_s=GROUP_TIMEOUT_S)
    try:
        with pytest.raises(ValueError, match="model_parallel=3 must divide n_devices=2"):
            make_mesh(2, model_parallel=3, device_type="cpu")
        with pytest.raises(ValueError, match="at least 1"):
            make_mesh(1, model_parallel=0, device_type="cpu")
        mesh = make_mesh(1, model_parallel=1, device_type="cpu")
        assert TensorParallel.of(mesh) is None
    finally:
        dist.destroy_process_group()


def test_a_model_axis_may_not_cross_hosts(monkeypatch):
    """check_multihost_mesh refuses a model row whose ranks are on two
    hosts (the host names as every process's all-gather would give them),
    as the JAX package's does; rows on one host each pass."""
    from clair_tpu_torch.parallel import distributed

    def stub(grid):
        return types.SimpleNamespace(mesh=torch.tensor(grid), mesh_dim_names=("data", "model"))

    def hosts(names):
        def all_gather_object(out, _):
            out[:] = names
        monkeypatch.setattr(distributed.dist, "all_gather_object", all_gather_object)

    hosts(["a", "a", "b", "b"])
    distributed.check_multihost_mesh(stub([[0, 1], [2, 3]]), 4)
    hosts(["a", "b", "a", "b"])
    with pytest.raises(ValueError, match="must not cross hosts.*'a', 'b'"):
        distributed.check_multihost_mesh(stub([[0, 1], [2, 3]]), 4)


@pytest.mark.cuda
def test_cuda_one_by_two_mesh_on_one_card(tmp_path):
    """On the card: the (1, 2) case on two gloo ranks on cuda:0 (NCCL
    refuses two ranks on one device), dropout on, against one process;
    each rank launches the streaming pair the single process launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from clair_tpu_torch.ops import launches_since

    bin_path = write_bin(str(tmp_path / "train.bin"), n=40, block=8)
    config = dataclasses.replace(EPOCHS, model=NARROW, max_epochs=1, train_batch_size=12,
                                 val_batch_size=4, device="cuda")
    before = launch_counts()
    single = train_model(bins.load_bin(bin_path), config)
    single_launches = launches_since(before)
    result, launches = train_on_devices(functools.partial(bins.load_bin, bin_path), config, 2,
                                        backend="gloo", devices=["cuda:0", "cuda:0"],
                                        timeout_s=SPAWN_TIMEOUT_S, model_parallel=2)
    for key in ("training_losses", "validation_losses"):
        np.testing.assert_allclose([v for v, _ in getattr(result, key)],
                                   [v for v, _ in getattr(single, key)], rtol=1e-4)
    assert launches == {k: 2 * v for k, v in single_launches.items()}
    assert launches["bilstm_stream"] > 0 and launches["bilstm_stream_backward"] > 0
