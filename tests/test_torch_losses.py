"""The port's losses against clair_tpu.models.losses on the same numpy
inputs: focal loss and weighted cross entropy (with and without
sample_weights), L2 over the non-bias leaves, and the weighted total with
bf16 logits and int16 labels, in both loss functions. Float32 sums over a
few hundred terms in another order: rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clair_tpu.models import losses as jax_losses
from clair_tpu.params import ModelConfig
from clair_tpu_torch.models import losses
from clair_tpu_torch.models.clair import param_shapes, params_from_jax

RTOL = 1e-5
NARROW = ModelConfig(lstm1_num_units=8, lstm2_num_units=8, l3_num_units=4,
                     l4_num_units=16, l5_num_units=8)
HEADS = (21, 3, 33, 33)


def _labels(rs, n):
    """(n, 90) one-hot per head, as the bins store them."""
    y = np.zeros((n, sum(HEADS)), np.float32)
    off = 0
    for width in HEADS:
        y[np.arange(n), off + rs.randint(0, width, n)] = 1.0
        off += width
    return y


def _logits(rs, n):
    return [(rs.randn(n, w) * 3).astype(np.float32) for w in HEADS]


def _tree(shapes, rs):
    return {k: _tree(v, rs) if isinstance(v, dict) else rs.randn(*v).astype(np.float32)
            for k, v in shapes.items()}


@pytest.mark.parametrize("weighted", [False, True])
def test_focal_loss_matches(weighted):
    rs = np.random.RandomState(0)
    logits = (rs.randn(16, 21) * 3).astype(np.float32)
    labels = _labels(rs, 16)[:, :21]
    sw = rs.rand(16).astype(np.float32) if weighted else None
    want = jax_losses.focal_loss(logits, labels, sample_weights=sw)
    got = losses.focal_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                            sample_weights=None if sw is None else torch.from_numpy(sw))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_cross_entropy_matches(weighted):
    rs = np.random.RandomState(1)
    probs = rs.dirichlet(np.ones(33), 16).astype(np.float32)
    labels = _labels(rs, 16)[:, 24:57]
    cw = rs.rand(33).astype(np.float32) + 0.5
    sw = rs.rand(16).astype(np.float32) if weighted else None
    want = jax_losses.weighted_cross_entropy(probs, labels, cw, sample_weights=sw)
    got = losses.weighted_cross_entropy(
        torch.from_numpy(probs), torch.from_numpy(labels), torch.from_numpy(cw),
        sample_weights=None if sw is None else torch.from_numpy(sw))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_l2_skips_every_bias():
    tree = _tree(param_shapes(NARROW), np.random.RandomState(2))
    want = float(jax_losses.l2_regularization(tree))
    state = params_from_jax(tree)
    np.testing.assert_allclose(losses.l2_regularization(state).item(), want, rtol=RTOL)
    no_bias = sum(0.5 * float((v.double() ** 2).sum()) for k, v in state.items()
                  if not k.endswith(".b"))
    np.testing.assert_allclose(want, no_bias, rtol=RTOL)


@pytest.mark.parametrize("loss_function", ["FocalLoss", "CrossEntropy"])
@pytest.mark.parametrize("weighted", [False, True])
def test_total_loss_matches_with_bf16_logits_and_int16_labels(loss_function, weighted):
    """bf16 logits and int16 labels are upcast to float32 inside; the JAX
    loss gets the same values as float32."""
    rs = np.random.RandomState(3)
    n = 24
    logits16 = [torch.from_numpy(lg).to(torch.bfloat16) for lg in _logits(rs, n)]
    y = _labels(rs, n)
    tree = _tree(param_shapes(NARROW), rs)
    sw = rs.rand(n).astype(np.float32) if weighted else None
    kwargs = dict(loss_function=loss_function, l2_lambda=0.005,
                  task_weights=(1.0, 0.5, 2.0, 1.0, 1.0))

    want, want_parts = jax_losses.total_loss(
        [jnp.asarray(lg.float().numpy()) for lg in logits16], y, tree,
        sample_weights=sw, **kwargs)
    got, got_parts = losses.total_loss(
        logits16, torch.from_numpy(y.astype(np.int16)), params_from_jax(tree),
        sample_weights=None if sw is None else torch.from_numpy(sw), **kwargs)

    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    assert sorted(got_parts) == sorted(want_parts)
    for k in want_parts:
        np.testing.assert_allclose(got_parts[k].item(), float(want_parts[k]), rtol=RTOL,
                                   err_msg=k)


def test_losses_are_sums_not_means():
    rs = np.random.RandomState(4)
    logits = torch.from_numpy((rs.randn(8, 21)).astype(np.float32))
    labels = torch.from_numpy(_labels(rs, 8)[:, :21])
    whole = losses.focal_loss(logits, labels)
    halves = losses.focal_loss(logits[:4], labels[:4]) + losses.focal_loss(logits[4:], labels[4:])
    np.testing.assert_allclose(whole.item(), halves.item(), rtol=RTOL)
