"""Clair3's full-alignment network (models/clair3_fa.py) against its plain
float32 reference (reference/clair3_fa.py) on the CPU at narrow widths:
the forward's probabilities in training and evaluation, the loss, every
leaf's gradient, three clipped Adam steps and the running statistics; TF
'SAME' pyramid pooling against maxima worked out by hand; the published
sizes; L2 over kernels only (ClairNet's unchanged bit for bit); the
``train`` command with ``--architecture clair3_fa`` for two epochs with a
checkpoint that keeps the running statistics; what it refuses; and the
``dispatch.x_bytes`` counter."""

import ast
import dataclasses
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from clair_tpu_torch import cli
from clair_tpu_torch.data import bins
from clair_tpu_torch.models import build, clair3_fa
from clair_tpu_torch.models.checkpoint import checkpoint_path, load_checkpoint
from clair_tpu_torch.models.clair import ClairNet, init_params as clair_init_params
from clair_tpu_torch.models.clair3_fa import Clair3FANet, FullAlignmentConfig
from clair_tpu_torch.models.losses import l2_regularization
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.parallel.sharding import make_eval_step, make_optimizer, make_train_step
from clair_tpu_torch.pipeline.train import TrainingConfig, _to_device, train_model
from clair_tpu_torch.reference import clair3_fa as ref
from clair_tpu_torch.utils import trace

ROOT = pathlib.Path(__file__).resolve().parent.parent
# every mechanism of the published network at narrow widths: three stride-2
# stages and their blocks (17 -> 9 -> 5 -> 3 rows, 9 -> 5 -> 3 -> 2
# positions), the pyramid over a 3 x 2 map, dropout everywhere
NARROW = FullAlignmentConfig(input_shape=(17, 9, 8), stage_channels=(8, 16, 32),
                             l4_num_units=32, l5_num_units=16)
BATCH = 16
TRAINING = {"learning_rate": 1e-3, "adam_betas": [0.9, 0.999], "adam_eps": 1e-8,
            "l2_lambda": 1e-4, "clip_norm": 5.0, "focal_gamma": 2.0}


def _model_dict(config):
    return dataclasses.asdict(config)


def _rows(n, shape, seed):
    """(x int16 counts in Clair3's +-100 scale, y one-hot 90-wide labels)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-100, 101, (n, *shape), generator=g).to(torch.int16)
    y = torch.zeros(n, 90)
    for a, b in ref.SPANS:
        y[torch.arange(n), a + torch.randint(0, b - a, (n,), generator=g)] = 1
    return x, y


def _model(config=NARROW, seed=0):
    """A model of seeded weights whose batch-norm scales, shifts and running
    statistics are moved off their starting values, so that each enters."""
    model = Clair3FANet.from_jax(clair3_fa.init_params(torch.Generator().manual_seed(seed),
                                                       config), config)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, value in model.state_dict().items():
            if ".bn." in name:
                value.add_(0.2 * torch.rand(value.shape, generator=g))
    return model


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith((".mean", ".var"))}


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def test_published_sizes():
    """2,986,522 parameters; a 12 x 5 x 256 trunk output; 3,584 pyramid
    features; the heads 21 / 3 / 33 / 33."""
    config = FullAlignmentConfig()
    shapes = clair3_fa.param_shapes(config)
    assert sum(math.prod(s) for s in shapes.values()) == 2_986_522
    assert clair3_fa.conv_layers(config)[-1][4] == (12, 5)
    assert [h for *_, h in clair3_fa.conv_layers(config)[::3]] == [(45, 17), (23, 9), (12, 5)]
    assert clair3_fa.spp_features(config) == 3_584 == ref.pyramid_width(_model_dict(config))
    assert shapes == ref.param_shapes(_model_dict(config))
    model = Clair3FANet(config)
    assert sum(p.numel() for p in model.parameters()) == 2_986_522
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == shapes
    probs = model(torch.zeros(2, 89, 33, 8, dtype=torch.int16))
    assert [tuple(p.shape) for p in probs] == [(2, 21), (2, 3), (2, 33), (2, 33)]


def test_pyramid_pool_takes_tf_same_windows():
    """A 12 x 5 map: 3 bins pool 4 x 2 windows, the third column's window
    holding position 4 alone; 2 bins 6 x 3 windows, the second holding
    positions 3-4; 1 bin the whole map. Values 5 * row + column, so each
    window's maximum is its last row's last column inside the map."""
    h = (torch.arange(12)[:, None] * 5 + torch.arange(5)[None, :]).float()
    h = torch.stack([h, -h])[None]  # (1, 2, 12, 5): the second channel's max is its first cell
    got = clair3_fa.spatial_pyramid_pool(h, (3, 2, 1))[0]
    cells = {3: [(r, c) for r in ((0, 3), (4, 7), (8, 11)) for c in ((0, 1), (2, 3), (4, 4))],
             2: [(r, c) for r in ((0, 5), (6, 11)) for c in ((0, 2), (3, 4))],
             1: [((0, 11), (0, 4))]}
    want = []
    for n in (3, 2, 1):
        for (r0, r1), (c0, c1) in cells[n]:
            want += [5 * r1 + c1, -(5 * r0 + c0)]  # (h, w, c) order
    assert got.tolist() == want
    assert ref.pyramid_pool(h, (3, 2, 1))[0].tolist() == want


# the published sizes are odd at every stride-2 convolution, where TF's
# 'SAME' pads 1 on each side; Clair3's 55-row platforms meet an even size
# (55 -> 28), padded 0 before and 1 after: 12 rows here
@pytest.mark.parametrize("config", [NARROW, dataclasses.replace(NARROW, input_shape=(12, 10, 8))],
                         ids=["odd", "even"])
def test_forward_loss_and_gradients_match_the_reference(config):
    """One training step's loss and every leaf's gradient, the training
    forward's probabilities (batch statistics, dropout from the same
    generator) and the evaluation forward's (running statistics). The
    model's convolutions (torch's conv2d) and the reference's (im2col and
    one matmul) sum in another order, both in float32: 1e-5 relative on
    the probabilities and the loss is some fifty times their float32
    round-off at these depths. Each gradient is held at 1e-4 of its leaf's
    largest element: the conv biases feed batch norm, which removes them,
    so their gradient is zero but for round-off, at 1e-6 of the largest
    gradient here, and is held at 1e-4 of the largest gradient instead."""
    model = _model(config)
    stats, params = _stats(model), _params(model)
    x, y = _rows(BATCH, config.input_shape, seed=3)
    md = _model_dict(config)
    masks = ref.draw_masks(md, BATCH, torch.Generator().manual_seed(7), torch.device("cpu"))

    logits = model.forward_logits(x, deterministic=False,
                                  generator=torch.Generator().manual_seed(7))
    want = ref.forward(params, stats, x.float(), md, masks)
    for got, expected in zip(logits, want):
        torch.testing.assert_close(torch.softmax(got, -1), torch.softmax(expected, -1),
                                   rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        model.load_state_dict({**model.state_dict(), **stats})
        for got, expected in zip(model(x), ref.forward(params, stats, x.float(), md)):
            torch.testing.assert_close(got, torch.softmax(expected, -1), rtol=1e-5, atol=1e-6)

    loss, _ = make_eval_step(model)(x, y, TRAINING["l2_lambda"])
    ref_eval_logits = ref.forward(params, stats, x.float(), md)
    ref_eval = (ref.task_loss(ref_eval_logits, y, 2.0, config.task_loss_weights)
                + TRAINING["l2_lambda"] * ref.l2_term(params))
    torch.testing.assert_close(loss, ref_eval.detach(), rtol=1e-5, atol=0)

    optimizer = make_optimizer(dict(model.named_parameters()), "Adam", 1e-3)
    step = make_train_step(model, optimizer)
    loss, _ = step(x, y, torch.Generator().manual_seed(7), TRAINING["l2_lambda"])
    ref_loss, ref_grads, _ = ref.gradient(params, stats, x.float(), y, md, TRAINING, masks)
    assert loss.item() == pytest.approx(ref_loss, rel=1e-5)
    # Adam's first step saw the gradient clipped to a global norm of 5
    ref_grads = ref.clip(ref_grads, TRAINING["clip_norm"])
    largest = max(g.abs().max() for g in ref_grads.values())
    for name, p in model.named_parameters():
        got = optimizer.inner.state[p]["exp_avg"] / 0.1
        conv_bias = name.endswith(".b") and ".bn." not in name and name.startswith(("conv", "block"))
        atol = 1e-4 * largest if conv_bias else 1e-4 * ref_grads[name].abs().max()
        torch.testing.assert_close(got, ref_grads[name], rtol=0, atol=float(atol), msg=name)


def test_three_clipped_adam_steps_and_the_running_statistics():
    """Three train steps through make_optimizer and make_train_step against
    the reference's. The losses at 1e-5 relative (float32 round-off). Each
    parameter's change over the three steps, by its norm, at 1e-4 relative
    (the measure of the benchmark's ``change_gap``; readings up to 3e-5
    here), and 99% of its elements (all but one of a small leaf) within
    1e-6 of the reference's: Adam
    divides an element's gradient by the root of its own second moment, so
    the few elements whose gradient is near round-off move by up to the
    learning rate in either direction. The conv biases are held apart: their
    gradient is round-off alone (batch norm removes them), and Adam's first
    three steps move an element by at most 1.004 times the learning rate
    each (Cauchy-Schwarz on its moments), so the two sides' biases lie
    within 2 x 3 x 1.004e-3 of each other. Through them, the
    running means differ by at most 0.01 of that a step: held at 1e-4
    absolute; the running variances at 1e-5 relative."""
    model = _model(seed=4)
    stats, params = _stats(model), _params(model)
    md = _model_dict(NARROW)
    batches = [_rows(BATCH, NARROW.input_shape, seed=10 + k) for k in range(3)]
    generator = torch.Generator().manual_seed(11)
    masks = [ref.draw_masks(md, BATCH, generator, torch.device("cpu")) for _ in batches]
    want = ref.train(params, [(x.float(), y) for x, y in batches], masks, md, TRAINING,
                     stats0=stats)

    optimizer = make_optimizer(dict(model.named_parameters()), "Adam", 1e-3)
    step = make_train_step(model, optimizer)
    generator = torch.Generator().manual_seed(11)
    losses = [step(x, y, generator, TRAINING["l2_lambda"])[0].item() for x, y in batches]
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    state = model.state_dict()
    for name, value in want["params"].items():
        conv_bias = name.endswith(".b") and ".bn." not in name and name.startswith(("conv", "block"))
        if conv_bias:
            assert (state[name] - value).abs().max() <= 2 * 3 * 1.004e-3, name
            continue
        change, want_change = state[name] - params[name], value - params[name]
        assert abs(change.norm() - want_change.norm()) <= 1e-4 * want_change.norm(), name
        assert ((change - want_change).abs() > 1e-6).sum() <= max(1, 0.01 * change.numel()), name
    for name, value in want["stats"].items():
        tol = dict(rtol=0, atol=1e-4) if name.endswith(".mean") else dict(rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(state[name], value, **tol, msg=name)
    assert not torch.equal(state["conv1.bn.var"], stats["conv1.bn.var"])


def test_l2_covers_kernels_only_and_clairnet_keeps_its_own():
    """Clair3_F's L2 is over the conv and dense kernels (no bias, no batch
    norm scale or shift), as the reference's; ClairNet's L2 is the old sum
    over every parameter but the biases, bit for bit."""
    model = _model()
    got = l2_regularization(dict(model.named_parameters()))
    torch.testing.assert_close(got, ref.l2_term(_params(model)), rtol=1e-6, atol=0)
    config = ModelConfig(lstm1_num_units=8, lstm2_num_units=8, l3_num_units=4,
                         l4_num_units=16, l5_num_units=8)
    net = ClairNet.from_jax(clair_init_params(torch.Generator().manual_seed(2), config), config)
    params = dict(net.named_parameters())
    old = sum(0.5 * torch.sum(torch.square(v)) for k, v in params.items()
              if k.rsplit(".", 1)[-1] != "b")
    assert torch.equal(l2_regularization(params), old)


def test_build_picks_the_network_by_its_config():
    """models/build.py: a FullAlignmentConfig gives Clair3_F with its
    running statistics, a ModelConfig ClairNet, each holding the tree that
    init_params drew for it."""
    for config, net, leaf in ((NARROW, Clair3FANet, "conv1.bn.var"),
                              (ModelConfig(lstm1_num_units=8, lstm2_num_units=8, l3_num_units=4,
                                           l4_num_units=16, l5_num_units=8), ClairNet, "l4.w")):
        tree = build.init_params(torch.Generator().manual_seed(3), config)
        model = build.build_model(tree, config)
        assert type(model) is net and model.config == config
        node = tree
        for part in leaf.split("."):
            node = node[part]
        assert torch.equal(model.state_dict()[leaf], torch.as_tensor(node))


def test_reference_in_float64_agrees_with_float32():
    """The reference's float64 steps, the yardstick that tells float32's
    round-off from a fault: float64 throughout, and the float32 steps' losses
    within 1e-5 relative of them (float32 round-off, as above)."""
    model = _model(seed=6)
    stats, params = _stats(model), _params(model)
    md = _model_dict(NARROW)
    batches = [(x.float(), y) for x, y in (_rows(BATCH, NARROW.input_shape, seed=20 + k)
                                           for k in range(2))]
    masks = [ref.draw_masks(md, BATCH, torch.Generator().manual_seed(k), torch.device("cpu"))
             for k in range(2)]
    exact = ref.train(params, batches, masks, md, TRAINING, precision="float64", stats0=stats)
    plain = ref.train(params, batches, masks, md, TRAINING, stats0=stats)
    assert {v.dtype for v in (*exact["params"].values(), *exact["stats"].values())} == {
        torch.float64}
    assert plain["losses"] == pytest.approx(exact["losses"], rel=1e-5)


def _fa_bin(tmp_path, n, seed=5):
    x, y = _rows(n, FullAlignmentConfig().input_shape, seed)
    x, y = x.numpy().astype(np.float32), y.numpy()
    block = 10
    offs = range(0, n, block)
    ds = bins.BinDataset(n, [bins._pack(x[o:o + block]) for o in offs],
                         [bins._pack(y[o:o + block]) for o in offs],
                         [bins._pack(np.array([f"chr1:{o + j}" for j in range(block)]))
                          for o in offs], block)
    path = str(tmp_path / "fa.bin")
    bins.write_bin(path, ds)
    return path, ds


def test_train_command_trains_clair3_fa(tmp_path, capsys):
    """``train --architecture clair3_fa`` at the published widths (here on
    the CPU): two epochs, per-epoch checkpoints whose running statistics
    are the trained model's (not the initial 0 and 1) and load back into a
    model that scores alike, the x bytes counted per batch, the spans of
    the forward."""
    path, ds = _fa_bin(tmp_path, n=30)
    prefix = str(tmp_path / "fa")
    trace.reset()
    cli.cmd_train(["--bin_fn", path, "--ochk_prefix", prefix, "--maxEpoch", "2",
                   "--decompress_workers", "0", "--architecture", "clair3_fa"], device="cpu")
    report = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert [e for _, e in report["training_losses"]] == [1, 2]
    assert all(math.isfinite(v) for v, _ in report["training_losses"])
    params, extra = load_checkpoint(checkpoint_path(prefix, 2))
    assert extra["epoch"] == 2 and params["block3"]["conv2"]["w"].shape == (3, 3, 256, 256)
    var = params["conv1"]["bn"]["var"]
    assert var.shape == (64,) and not np.allclose(var, 1.0)
    model = Clair3FANet.from_jax(params, FullAlignmentConfig())
    assert torch.equal(model.state_dict()["conv1.bn.var"], torch.from_numpy(var))
    records = trace.records()
    # 27 training rows (90%) in one batch and 3 validation rows, each epoch
    sent = [r.value for r in records if r.name == "dispatch.x_bytes"]
    assert sent == [27 * 89 * 33 * 8 * 2, 3 * 89 * 33 * 8 * 2] * 2
    stages = [r.value for r in records if r.name == "fa.stage"]
    assert stages[:3] == [1, 2, 3]
    assert {"fa.trunk", "fa.pool", "fa.heads"} <= {r.name for r in records}


@pytest.mark.parametrize("flags", [["--model_parallel", "2", "--num_devices", "2"],
                                   ["--num_devices", "2"], ["--no_stream_bilstm"],
                                   ["--coordinator_address", "localhost:1"],
                                   ["--train_compute_dtype", "bfloat16"]])
def test_train_command_refuses_clair3_fa_with(flags):
    with pytest.raises(ValueError, match="clair3_fa"):
        cli.main(["train", "--bin_fn", "unused.bin", "--architecture", "clair3_fa", *flags])


def test_train_model_refuses_for_clair3_fa(tmp_path):
    """A mesh, the BiLSTM flag, and rows that are not the model's."""
    _, ds = _fa_bin(tmp_path, n=10)
    config = TrainingConfig(model=FullAlignmentConfig(), device="cpu")
    with pytest.raises(ValueError, match="one device"):
        train_model(ds, dataclasses.replace(config, mesh=object()))
    with pytest.raises(ValueError, match="BiLSTM"):
        train_model(ds, dataclasses.replace(config, use_stream_bilstm=False))
    with pytest.raises(ValueError, match=r"\(17, 9, 8\)"):
        train_model(ds, dataclasses.replace(config, model=NARROW))


def test_to_device_counts_the_bytes_it_sends():
    trace.reset()
    x = np.zeros((4, 89, 33, 8), np.int16)
    _to_device(x, torch.device("cpu"), "dispatch.x_bytes")
    _to_device(x[:1], torch.device("cpu"))
    counted = [r for r in trace.records() if r.name == "dispatch.x_bytes"]
    assert [r.value for r in counted] == [x.nbytes]
    assert counted[0].parent == "dispatch.to_device"


@pytest.mark.parametrize("path", ["clair_tpu_torch/reference/clair3_fa.py",
                                  "portbench/reference/clair3_fa.py"])
def test_references_import_torch_alone(path):
    """The plain references import torch and the standard library, nothing
    of the port, of the benchmark or of JAX; the benchmark's is the same
    text as the port's."""
    source = (ROOT / path).read_text()
    modules = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            modules |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            modules.add((node.module or "").split(".")[0])
    assert modules - set(sys.stdlib_module_names) == {"torch"}
    assert source == (ROOT / "clair_tpu_torch/reference/clair3_fa.py").read_text()
