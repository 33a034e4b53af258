"""The plain reference against the port's own model and train step on the
CPU, at the published widths and a small batch (the port's CPU path is its
kernels' plain versions). The test imports both; the reference imports
neither the port nor anything of it."""

import pytest
import torch

from clair_tpu_torch.models.clair import ClairNet
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step
from portbench import harness
from portbench.kinds.train import seeds
from portbench.pileup import make_rows
from portbench.reference import clair2
from portbench.weights import make_weights

CONFIG = harness.load_config(harness.load_spec(), "clair2-f32")
MODEL, TRAINING = CONFIG["model"], CONFIG["training"]
PROFILE = harness.load_traffic("train-b10k")["pileup"]
CPU = torch.device("cpu")
BATCH = 48


def inputs(seed, steps=3):
    streams = seeds(seed)
    x, y = make_rows(steps * BATCH, PROFILE, torch.Generator().manual_seed(streams["rows"]), CPU)
    weights = make_weights(clair2.param_shapes(MODEL),
                           torch.Generator().manual_seed(streams["weights"]), CPU)
    batches = [(x[i:i + BATCH], y[i:i + BATCH]) for i in range(0, len(x), BATCH)]
    return batches, weights, streams["dropout"]


def port_model(weights):
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in MODEL.items()}
    model = ClairNet(ModelConfig(**fields, compute_dtype="float32"), CPU)
    model.load_state_dict(weights)
    return model


def test_forward_matches_the_port():
    batches, weights, _ = inputs(1)
    x = batches[0][0]
    want = port_model(weights).forward_logits(x)
    got = clair2.forward(weights, x.float(), MODEL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.float(), rtol=1e-5, atol=1e-5)


def test_masks_are_the_ports_draws():
    """The reference's masks from a generator seeded alike drop the units
    the port's training forward drops: both forwards agree with dropout."""
    batches, weights, dropout_seed = inputs(2)
    x = batches[0][0]
    model = port_model(weights)
    want = model.forward_logits(x, deterministic=False,
                                generator=torch.Generator().manual_seed(dropout_seed))
    masks = clair2.draw_masks(MODEL, BATCH, torch.Generator().manual_seed(dropout_seed), CPU)
    assert set(masks) == {"lstm2", "l4", "l5_1", "l5_2", "l5_3", "l5_4"}
    got = clair2.forward(weights, x.float(), MODEL, masks)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.float(), rtol=1e-5, atol=1e-5)


def test_three_steps_match_the_ports_train_step():
    batches, weights, dropout_seed = inputs(3)
    model = port_model(weights)
    optimizer = make_optimizer(dict(model.named_parameters()), "Adam", TRAINING["learning_rate"])
    step = make_train_step(model, optimizer)
    generator = torch.Generator().manual_seed(dropout_seed)
    losses, first = [], None
    for x, y in batches:
        losses.append(step(x, y, generator, TRAINING["l2_lambda"])[0].item())
        if first is None:  # the clipped gradient Adam received: its first moment / (1 - b1)
            first = {name: optimizer.inner.state[p]["exp_avg"] / 0.1
                     for name, p in zip(optimizer.names, optimizer.params)}

    masks_from = torch.Generator().manual_seed(dropout_seed)
    masks = [clair2.draw_masks(MODEL, BATCH, masks_from, CPU) for _ in batches]
    ref = clair2.train(weights, [(x.float(), y.float()) for x, y in batches], masks, MODEL,
                       TRAINING, block_rows=20)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for name, p in model.named_parameters():
        want = ref["grad"][name]
        torch.testing.assert_close(first[name], want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))
        # Adam moves an element whose gradient sums to about 0 by its sign,
        # so the change is held by its norm and by the learning rate a step
        got, moved = p.detach(), ref["params"][name]
        assert (got - weights[name]).norm() == pytest.approx(
            (moved - weights[name]).norm(), rel=1e-3), name
        assert (got - moved).abs().max() <= 2 * 3 * TRAINING["learning_rate"], name


def test_blocks_of_rows_do_not_change_the_step():
    batches, weights, dropout_seed = inputs(4, steps=1)
    data = [(x.float(), y.float()) for x, y in batches]
    masks = [clair2.draw_masks(MODEL, BATCH, torch.Generator().manual_seed(dropout_seed), CPU)]
    whole = clair2.train(weights, data, masks, MODEL, TRAINING, block_rows=BATCH)
    split = clair2.train(weights, data, masks, MODEL, TRAINING, block_rows=7)
    assert whole["losses"] == pytest.approx(split["losses"], rel=1e-6)
    for name in whole["grad"]:
        torch.testing.assert_close(whole["grad"][name], split["grad"][name], rtol=1e-4,
                                   atol=1e-7)
