"""The port's training stack against the JAX package's, on the CPU at a
narrow width: dropout and alpha-dropout moments, init_params'
distributions, clip + Adam / SGDM against optax, three train steps against
the JAX make_train_step, evaluate_model's confusion matrices, a two-epoch
train_model against the JAX train_model from one init checkpoint, and the
``train`` command on a bin the JAX package wrote."""

import dataclasses
import json
import math

import jax
import numpy as np
import optax
import pytest
import torch

import clair_tpu.data.bins as jax_bins
from clair_tpu.models import checkpoint as jax_ckpt
from clair_tpu.models.clair import init_params as jax_init_params
from clair_tpu.models.layers import alpha_dropout as jax_alpha_dropout
from clair_tpu.params import ModelConfig
from clair_tpu.parallel import sharding as jax_sharding
from clair_tpu_torch import cli
from clair_tpu_torch.data import bins
from clair_tpu_torch.models.checkpoint import checkpoint_path, load_checkpoint, save_checkpoint
from clair_tpu_torch.models.clair import ClairNet, init_params, params_from_jax
from clair_tpu_torch.models.layers import ALPHA_DROPOUT_VALUE, alpha_dropout, dropout
from clair_tpu_torch.parallel import sharding
from clair_tpu_torch.pipeline.evaluate import evaluate_model
from clair_tpu_torch.pipeline.train import TrainingConfig, train_model

NARROW = ModelConfig(lstm1_num_units=8, lstm2_num_units=8, l3_num_units=4,
                     l4_num_units=16, l5_num_units=8)
NO_DROPOUT = dataclasses.replace(NARROW, lstm2_dropout_rate=0.0, l4_dropout_rate=0.0,
                                 l5_dropout_rate=0.0)
# the comparisons that compile a JAX train step run 11 positions, not 33:
# XLA compiles the fully unrolled scan's gradient in ~4 s instead of ~12
# (the 33-step recurrence is held against JAX in test_torch_bilstm_backward)
SHORT = dataclasses.replace(NO_DROPOUT, input_shape=(11, 8, 4))


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(v)


def _batch(rs, n, positions=33):
    x = rs.randint(0, 50, (n, positions, 8, 4)).astype(np.float32)
    x[..., 1:] -= x[..., :1]
    y = np.zeros((n, 90), np.float32)
    for off, width in ((0, 21), (21, 3), (24, 33), (57, 33)):
        y[np.arange(n), off + rs.randint(0, width, n)] = 1.0
    return x, y


def _bin(tmp_path, n=60, block=10, seed=0, positions=33):
    """A learnable JAX-written bin (the genotype shows in x's SNP channel)."""
    rs = np.random.RandomState(seed)
    x, y = _batch(rs, n, positions)
    hom = np.arange(n) % 2 == 1
    y[:, :24] = 0.0
    y[~hom, 0] = y[hom, 6] = 1.0        # gt21 AA / GG
    y[~hom, 21] = y[hom, 22] = 1.0      # genotype
    x[hom, :, :, 3] += 20
    offs = range(0, n, block)
    ds = jax_bins.BinDataset(
        n, [jax_bins._pack(x[o:o + block]) for o in offs],
        [jax_bins._pack(y[o:o + block]) for o in offs],
        [jax_bins._pack(np.array([f"chr1:{o + j}" for j in range(block)])) for o in offs],
        block)
    path = str(tmp_path / "train.bin")
    jax_bins.write_bin(path, ds)
    return path


def test_dropout_moments():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(400_000)
    y = dropout(g, x, 0.5)
    assert abs((y == 0).float().mean().item() - 0.5) < 0.005
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(y.mean().item() - 1.0) < 0.01
    assert dropout(g, x[:8].to(torch.bfloat16), 0.5).dtype == torch.bfloat16
    assert dropout(g, x, 0.0) is x


@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_alpha_dropout_keeps_the_selu_fixed_point(rate):
    """On unit-normal input the output keeps mean 0 and variance 1 (within
    sampling error at 400k draws), as the JAX function's does on the same
    input; dropped units all take one value."""
    x = np.random.RandomState(1).randn(400_000).astype(np.float32)
    y = alpha_dropout(torch.Generator().manual_seed(2), torch.from_numpy(x), rate).numpy()
    y_jax = np.asarray(jax_alpha_dropout(jax.random.PRNGKey(3), x, rate))
    for out in (y, y_jax):
        assert abs(out.mean()) < 0.01 and abs(out.var() - 1.0) < 0.02
    # a dropped unit becomes a * alpha' + b, with b = -a * rate * alpha'
    keep = 1.0 - rate
    a = (keep * ((1 - keep) * ALPHA_DROPOUT_VALUE ** 2 + 1)) ** -0.5
    dropped_value = np.float32(a * ALPHA_DROPOUT_VALUE * keep)
    for out in (y, y_jax):
        assert abs(np.isclose(out, dropped_value, rtol=0, atol=1e-6).mean() - rate) < 0.005


def test_init_params_match_jax_distributions():
    """Every leaf of the full-width tree: zero biases; weight std within 5%
    of the JAX init's where a leaf has 4096 values or more, else within four
    standard errors of the intended std; he_fan_in truncated at 2 sigma.
    L3's fan_in is 33 * 256 = 8448 (JAX's fan rule), not 33."""
    port = dict(_leaves(init_params(torch.Generator().manual_seed(0), ModelConfig())))
    ref = dict(_leaves(jax_init_params(jax.random.PRNGKey(0), ModelConfig())))
    assert sorted(port) == sorted(ref)
    for name, w in port.items():
        assert w.shape == ref[name].shape and w.dtype == np.float32, name
        if name.endswith(".b"):
            assert not w.any() and not ref[name].any(), name
            continue
        fan_in = w.shape[-2] * math.prod(w.shape[:-2])
        fan_out = w.shape[-1] * math.prod(w.shape[:-2])
        if name.startswith("lstm"):
            intended = math.sqrt(2.0 / (fan_in + fan_out))   # glorot uniform
        else:
            intended = math.sqrt(1.0 / fan_in)
            assert np.abs(w).max() <= 2 * intended / 0.87962566103423978 + 1e-7, name
        if w.size >= 4096:
            assert abs(w.std() / ref[name].std() - 1) < 0.05, name
        else:
            assert abs(w.std() / intended - 1) < 4 / math.sqrt(2 * w.size), name
    assert abs(port["l3.w"].std() * math.sqrt(8448) - 1) < 0.05
    assert abs(ref["l3.w"].std() * math.sqrt(8448) - 1) < 0.05


@pytest.mark.parametrize("optimizer_name", ["Adam", "SGDM"])
@pytest.mark.parametrize("grad_scale", [1e-2, 1e2])   # below and above the clip norm
def test_clip_and_update_match_optax(optimizer_name, grad_scale):
    """Three updates with a learning-rate change before the last, on
    parameters drawn around 0.1 in size: the parameters match optax's
    within rtol 1e-6, atol 1e-8 (1e-5 of the learning rate, for entries
    near 0). The updates themselves match within rtol 2e-5: optax
    computes Adam's bias correction 1 - b2**t in float32, where 0.999
    rounds to 0.99900001, which moves its update by up to 6.4e-6 relative
    to torch.optim.Adam's (computed in float64); and an update read back as
    the difference of two float32 parameters is exact only to their ulp, so
    atol is a few ulps of a parameter below 0.5 (6e-8)."""
    rs = np.random.RandomState(4)
    tree = jax.tree.map(lambda a: (rs.randn(*a.shape) * 0.1).astype(np.float32),
                        _numpy(jax_init_params(jax.random.PRNGKey(1), NARROW)))
    grads = [jax.tree.map(lambda a: (rs.randn(*a.shape) * grad_scale).astype(np.float32), tree)
             for _ in range(3)]

    opt = jax_sharding.make_optimizer(optimizer_name, 1e-3)

    @jax.jit
    def update(g, state, p):
        updates, state = opt.update(g, state, p)
        return updates, state, optax.apply_updates(p, updates)

    state, p = opt.init(tree), tree
    named = {k: v.clone().requires_grad_() for k, v in params_from_jax(tree).items()}
    port_opt = sharding.make_optimizer(named, optimizer_name, 1e-3)
    for step, g in enumerate(grads):
        if step == 2:
            state = jax_sharding.set_learning_rate(state, 3e-3)
            sharding.set_learning_rate(port_opt, 3e-3)
        before = {k: v.detach().clone() for k, v in named.items()}
        updates, state, p = update(g, state, p)
        for k, v in params_from_jax(g).items():
            named[k].grad = v.clone()
        port_opt.step()
        for k, v in params_from_jax(_numpy(updates)).items():
            np.testing.assert_allclose((named[k].detach() - before[k]).numpy(), v.numpy(),
                                       rtol=2e-5, atol=6e-8, err_msg=k)
    for k, v in params_from_jax(_numpy(p)).items():
        np.testing.assert_allclose(named[k].detach().numpy(), v.numpy(), rtol=1e-6, atol=1e-8,
                                   err_msg=k)


def test_clip_divides_by_the_norm_exactly():
    g = [torch.full((4,), 3.0), torch.full((3,), -4.0)]   # norm sqrt(36 + 48)
    norm = sharding.clip_by_global_norm_(g, 5.0)
    assert norm.item() == pytest.approx(math.sqrt(84))
    assert torch.equal(g[0], torch.full((4,), 3.0) / norm * 5.0)
    small = [torch.full((2,), 1.0)]
    sharding.clip_by_global_norm_(small, 5.0)
    assert torch.equal(small[0], torch.ones(2))


def test_three_adam_steps_match_jax_train_step():
    """f32, dropout off, 11 positions: the losses of three steps of the port's
    make_train_step (fed int16, cast on the device) match the JAX step's
    within rtol 3e-4."""
    rs = np.random.RandomState(5)
    x, y = _batch(rs, 16, positions=11)
    params = _numpy(jax_init_params(jax.random.PRNGKey(2), SHORT))

    opt = jax_sharding.make_optimizer("Adam", 1e-3)
    step = jax_sharding.make_train_step(SHORT, opt)
    p, state, want = params, opt.init(params), []
    for _ in range(3):
        p, state, loss, _ = step(p, state, x, y, jax.random.PRNGKey(3), 0.005)
        want.append(float(loss))

    model = ClairNet.from_jax(params, SHORT, "cpu")
    port_opt = sharding.make_optimizer(dict(model.named_parameters()), "Adam", 1e-3)
    port_step = sharding.make_train_step(model, port_opt)
    xi, yi = torch.from_numpy(x.astype(np.int16)), torch.from_numpy(y.astype(np.int16))
    got = []
    for _ in range(3):
        loss, components = port_step(xi, yi, torch.Generator(), 0.005)
        got.append(loss.item())
        assert sorted(components) == ["genotype", "gt21", "indel_length_1",
                                      "indel_length_2", "l2", "l2_without_lambda"]
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=3e-4)

    eval_step = sharding.make_eval_step(model)
    loss, _ = eval_step(xi, yi, 0.005)
    assert loss.grad_fn is None and torch.isfinite(loss)
    with pytest.raises(NotImplementedError, match="mesh"):
        sharding.make_train_step(model, port_opt, mesh=object())


def test_training_forward_draws_dropout_from_the_generator():
    model = ClairNet.from_jax(_numpy(jax_init_params(jax.random.PRNGKey(4), NARROW)),
                              NARROW, "cpu")
    x = torch.from_numpy(_batch(np.random.RandomState(6), 8)[0])
    with pytest.raises(ValueError, match="generator"):
        model.forward_logits(x, deterministic=False)
    runs = [model.forward_logits(x, deterministic=False,
                                 generator=torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    det = model.forward_logits(x)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not all(torch.equal(a, b) for a, b in zip(runs[0], runs[2]))
    assert not all(torch.equal(a, b) for a, b in zip(runs[0], det))
    assert all(t.grad_fn is not None for t in runs[0])


def test_evaluate_model_confusion_matrices_match(tmp_path):
    from clair_tpu.pipeline.evaluate import evaluate_model as jax_evaluate

    path = _bin(tmp_path, n=40, block=10, seed=7)
    params = _numpy(jax_init_params(jax.random.PRNGKey(5), NARROW))
    want = jax_evaluate(params, NARROW, jax_bins.load_bin(path), batch_size=16,
                        print_report=False)
    got = evaluate_model(params, NARROW, bins.load_bin(path), batch_size=16,
                         print_report=False, device="cpu")
    for field in ("confusion_gt21", "confusion_genotype", "confusion_length_1",
                  "confusion_length_2"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert (got.gt21_top1, got.gt21_top2) == (want.gt21_top1, want.gt21_top2)
    assert got.confusion_gt21.sum() == 40


def test_train_model_matches_jax_train_model(tmp_path, monkeypatch):
    """Two epochs from one init checkpoint, f32, dropout off, 11 positions,
    the same block order: per-epoch loss sums within rtol 1e-3 of the JAX loop's,
    and each package's checkpoints load in the other."""
    from clair_tpu.pipeline.train import TrainingConfig as JaxTrainingConfig
    from clair_tpu.pipeline.train import train_model as jax_train_model

    monkeypatch.setenv("CLAIR_TPU_JAX_CACHE", str(tmp_path / "jax_cache"))
    path = _bin(tmp_path, positions=11)
    init = checkpoint_path(str(tmp_path / "init"), 0)
    save_checkpoint(init, init_params(torch.Generator().manual_seed(9), SHORT))
    common = dict(model=SHORT, init_checkpoint=init, train_batch_size=18,
                  val_batch_size=6, schedule="fixed", max_epochs=2,
                  evaluate_at_end=False, train_compute_dtype="float32",
                  decompress_workers=0)
    want = jax_train_model(jax_bins.load_bin(path), JaxTrainingConfig(
        output_prefix=str(tmp_path / "jax"), **common))
    got = train_model(bins.load_bin(path), TrainingConfig(
        output_prefix=str(tmp_path / "port"), device="cpu", **common))

    assert [e for _, e in got.training_losses] == [1, 2]
    for g, w in ((got.training_losses, want.training_losses),
                 (got.validation_losses, want.validation_losses)):
        np.testing.assert_allclose([v for v, _ in g], [v for v, _ in w], rtol=1e-3)
    assert got.validation_losses[-1][0] < got.validation_losses[0][0]
    assert got.best_epoch == want.best_epoch
    for epoch in (1, 2):
        port_written = jax_ckpt.load_checkpoint(checkpoint_path(str(tmp_path / "port"), epoch))
        jax_written = load_checkpoint(checkpoint_path(str(tmp_path / "jax"), epoch))
        assert port_written[1] == {"epoch": epoch, "learning_rate": 1e-3}
        for (name, a), (_, b) in zip(_leaves(port_written[0]), _leaves(jax_written[0])):
            assert a.shape == b.shape, name
        ClairNet.from_jax(jax_written[0], SHORT)


def test_train_command_on_a_jax_written_bin(tmp_path, capsys):
    """The ``train`` command at full width (here on the CPU): per-epoch
    checkpoints the JAX package reads, the evaluation report, and the stderr
    JSON line with both kernels' launches (0 on the CPU) and the losses."""
    path = _bin(tmp_path, n=40, seed=8)
    prefix = str(tmp_path / "model")
    cli.cmd_train(["--bin_fn", path, "--ochk_prefix", prefix, "--maxEpoch", "1",
                   "--train_compute_dtype", "float32", "--decompress_workers", "0"],
                  device="cpu")
    report = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert report["kernel_launches"] == dict.fromkeys(
        ["bilstm_stream", "bilstm_stream_backward", "bilstm_train", "bilstm_train_backward",
         "bilstm_precomputed", "bilstm2"], 0)
    assert [e for _, e in report["validation_losses"]] == [1]
    assert all(math.isfinite(v) for v, _ in report["training_losses"])
    params, extra = jax_ckpt.load_checkpoint(checkpoint_path(prefix, 1))
    assert extra["epoch"] == 1 and params["l3"]["w"].shape == (256, 33, 30)


@pytest.mark.parametrize("flags", [
    ["--num_devices", "2"], ["--coordinator_address", "localhost:1"],
    ["--model_parallel", "2"], ["--profile_dir", "trace"], ["--no_stream_bilstm"],
])
def test_train_command_refuses_what_is_not_ported(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["train", "--bin_fn", "unused.bin", *flags])


def test_train_model_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="mesh"):
        train_model(None, TrainingConfig(mesh=object(), device="cpu"))
