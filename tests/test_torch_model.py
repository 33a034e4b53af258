"""ClairNet against clair_tpu.models.clair.forward in float32: a narrow
configuration with numpy-seeded parameters, and the vendored full-size ONT
checkpoint. The equality also pins the L3 flatten order, the transposed L3
bias and SELU before every head's softmax. bf16 is held against the JAX
forward that runs the streaming Pallas kernel (interpret mode), which is the
JAX package's reduced-precision path."""

import dataclasses

import numpy as np
import pytest
import torch

import clair_tpu.ops.pallas_bilstm_stream as PS
from clair_tpu.models.checkpoint import load_checkpoint
from clair_tpu.models.clair import forward as jax_forward
from clair_tpu.models.clair import init_params
from clair_tpu_torch.models.clair import (
    ClairNet, param_shapes, params_from_jax, params_to_jax,
)
from clair_tpu_torch.models.layers import SELU_ALPHA, SELU_SCALE, selu
from clair_tpu_torch.params import ModelConfig
from test_torch_train import jax_config

NARROW = ModelConfig(lstm1_num_units=8, lstm2_num_units=8, l3_num_units=4,
                     l4_num_units=16, l5_num_units=8)
# probabilities: XLA and torch sum in different orders
PROB_TOL = 2e-5


def _numpy_params(shapes, rs):
    return {k: _numpy_params(v, rs) if isinstance(v, dict)
            else (rs.randn(*v) / np.sqrt(v[0])).astype(np.float32)
            for k, v in shapes.items()}


def _pileup(rs, n):
    x = rs.randint(0, 40, (n, 33, 8, 4)).astype(np.float32)
    x[..., 1:] -= x[..., :1]
    return x


def _both(params, x, config):
    want = [np.asarray(p) for p in jax_forward(params, x, jax_config(config))]
    with torch.inference_mode():  # the parameters are trainable
        got = [p.numpy() for p in ClairNet.from_jax(params, config)(torch.from_numpy(x))]
    return want, got


def test_param_shapes_match_jax_init_params():
    import jax

    tree = init_params(jax.random.PRNGKey(0), jax_config(NARROW))
    shapes = param_shapes(NARROW)
    assert jax.tree.map(lambda a: tuple(a.shape), tree) == shapes


def test_narrow_config_matches_jax_forward():
    rs = np.random.RandomState(0)
    params = _numpy_params(param_shapes(NARROW), rs)
    want, got = _both(params, _pileup(rs, 16), NARROW)
    for w, g in zip(want, got):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=PROB_TOL)


def test_vendored_checkpoint_matches_jax_forward():
    params, _ = load_checkpoint("examples/ont_synthetic.ckpt")
    want, got = _both(params, _pileup(np.random.RandomState(1), 4), ModelConfig())
    assert [g.shape for g in got] == [(4, 21), (4, 3), (4, 33), (4, 33)]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=PROB_TOL)


def test_bf16_forward_tracks_the_jax_kernel_path():
    """compute_dtype=bfloat16: parameters cast at use, gates and cell in
    float32, softmax in float32. Against the JAX forward through the
    streaming kernel: the same argmax on every head, and probabilities
    within 0.08 (both round to bf16 at the same places, but the sums run in
    another order, and one bf16 step of a head logit near 10 is 0.04);
    against the port's own float32 forward: simplices, and argmax agreement
    as in tests/test_bf16.py."""
    config16 = ModelConfig(compute_dtype="bfloat16", use_pallas_stream_bilstm=True)
    params, _ = load_checkpoint("examples/ont_synthetic.ckpt")
    x = _pileup(np.random.RandomState(2), 8)
    PS._INTERPRET = True
    try:
        want, got = _both(params, x, config16)
    finally:
        PS._INTERPRET = False
    for w, g in zip(want, got):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g.sum(-1), 1.0, rtol=1e-3)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
        np.testing.assert_allclose(g, w, rtol=0, atol=0.08)
    with torch.inference_mode():
        got32 = ClairNet.from_jax(params, ModelConfig())(torch.from_numpy(x))
    agree = np.mean([(a.numpy().argmax(-1) == b.argmax(-1)).mean() for a, b in zip(got32, got)])
    assert agree >= 0.75


def test_params_round_trip_through_the_module():
    params, _ = load_checkpoint("examples/ont_production.ckpt")
    model = ClairNet.from_jax(params, ModelConfig())
    back = params_to_jax(model.state_dict())
    assert set(params_from_jax(back)) == set(model.state_dict())

    def check(a, b):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], dict):
                check(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k])

    check(back, params)


def test_rejects_unported_kernel_flags_and_dtypes():
    # the train kernel is float32 only, as in the JAX forward
    with pytest.raises(ValueError, match="use_pallas_train_bilstm is float32-only"):
        ClairNet(dataclasses.replace(NARROW, use_pallas_train_bilstm=True,
                                     compute_dtype="bfloat16"))
    with pytest.raises(ValueError, match="compute_dtype"):
        ClairNet(dataclasses.replace(NARROW, compute_dtype="float16"))


def _former_selu(x):
    """SELU with expm1 on the whole input, the JAX package's form."""
    return SELU_SCALE * torch.where(x >= 0.0, x, SELU_ALPHA * torch.expm1(x))


def test_selu_is_the_former_forward_with_a_finite_gradient_past_expm1s_range():
    """Across [-120, 120]: the forward bit for bit the former, the gradient
    the former's wherever that is finite, and finite above 88.72, where the
    former's expm1 overflowed in the branch not taken and made it NaN."""
    points = torch.tensor([0.0, -0.0, 88.72, 88.8, 90.45, 120.0, -88.8, -120.0])
    x = torch.cat([torch.linspace(-120.0, 120.0, 24001), points])
    grads = []
    for fn in (_former_selu, selu):
        leaf = x.clone().requires_grad_(True)
        out = fn(leaf)
        out.backward(torch.ones_like(out))
        grads.append((out.detach(), leaf.grad))
    (want, want_grad), (got, got_grad) = grads
    assert torch.equal(got, want)
    finite = torch.isfinite(want_grad)
    assert torch.equal(got_grad[finite], want_grad[finite])
    assert torch.isfinite(got_grad).all()
    for value in (88.8, 90.45, 120.0):
        at = x == value
        assert torch.isnan(want_grad[at]).all()
        assert (got_grad[at] == SELU_SCALE).all()
