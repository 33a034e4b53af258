"""The port's resident training BiLSTM (ops/bilstm_train.py, the plain
versions on the CPU) against the JAX package's Pallas pair
(clair_tpu/ops/pallas_bilstm_train.py) in interpret mode: values, and
torch.autograd gradients of x and every parameter against jax.grad. Also
the plain reverse sweep against torch.autograd of the plain forward, the
wiring (float32 only, dx only when asked, no launch on the CPU), the
backward's numerics as the kernel computes them (three-piece split-bf16
products) against jax.grad, and, where there is a card, the kernels against
their plain versions (the `cuda` test, also run by chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clair_tpu.ops.pallas_bilstm_train as PT
import clair_tpu_torch.ops.bilstm_train as BT
from clair_tpu_torch.models.bilstm import _stack_directions, _unstack_outputs
from clair_tpu_torch.ops.bilstm_train import (
    SWEEP_CLUSTERS, _stack_params, bilstm_train, bilstm_train_backward,
    bilstm_train_backward_reference, bilstm_train_forward, bilstm_train_reference, input_grad,
    stacked_cotangent, sweep_geometries, sweep_layout,
)

# the geometries of tests/test_pallas_bilstm_train.py
GEOMETRIES = [
    (8, 33, 32, 128),      # lstm1 geometry
    (8, 33, 256, 128),     # lstm2 geometry
    (12, 33, 32, 128),     # batch the JAX wrapper pads to its tile
    (8, 7, 16, 8),         # tiny odd geometry
]
# on the card also: ragged rows (no multiple of 8) with a hidden size that
# no cluster divides into units a multiple of 8 (40 / C = 20, 10, 5)
CUDA_GEOMETRIES = GEOMETRIES + [(13, 33, 32, 40), (21, 9, 24, 40)]
# the shared memory a block may take on Hopper (csrc/mma_product.cuh)
SMEM_LIMIT = 227 * 1024
# that file's tolerances: values 2e-5, gradients 3e-4 (sums over 33 steps in
# another order)
VALUE_TOL, GRAD_TOL = 2e-5, 3e-4
# plain sweep vs autograd of the plain forward: the same float32 products on
# the CPU, summed in another order
PLAIN_RTOL, PLAIN_ATOL = 1e-4, 1e-5


@pytest.fixture
def interpret_mode():
    PT._INTERPRET = True
    yield
    PT._INTERPRET = False


def _numpy_inputs(geometry, seed):
    b, t, f, h = geometry
    rs = np.random.RandomState(seed)

    def one():
        scale = 1.0 / np.sqrt(h)
        return {"w": (rs.randn(f, 4 * h) * scale).astype(np.float32),
                "u": (rs.randn(h, 4 * h) * scale).astype(np.float32),
                "b": (rs.randn(4 * h) * 0.1).astype(np.float32)}

    params = {"fw": one(), "bw": one()}
    x = rs.randn(b, t, f).astype(np.float32)
    weight = rs.randn(b, t, 2 * h).astype(np.float32)
    return params, x, weight


def _leaves(params, requires_grad=True):
    return {d: {k: torch.tensor(v, requires_grad=requires_grad) for k, v in p.items()}
            for d, p in params.items()}


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_values_and_grads_match_the_pallas_pair(geometry, interpret_mode):
    params, x, weight = _numpy_inputs(geometry, seed=0)

    def jax_loss(p, xx):
        return jnp.sum(PT.bilstm_train_pallas(p, xx) * weight)

    want_out = np.asarray(PT.bilstm_train_pallas(params, jnp.asarray(x)))
    want_params, want_x = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(x))

    leaves = _leaves(params)
    xt = torch.tensor(x, requires_grad=True)
    out = bilstm_train(leaves, xt)
    assert out.dtype == torch.float32 and "BiLSTMTrain" in type(out.grad_fn).__name__
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=VALUE_TOL, atol=VALUE_TOL)
    (out * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), rtol=GRAD_TOL, atol=GRAD_TOL)
    for d in ("fw", "bw"):
        for k in ("w", "u", "b"):
            np.testing.assert_allclose(leaves[d][k].grad.numpy(), np.asarray(want_params[d][k]),
                                       rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"{d}.{k}")


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_kernel_numerics_match_jax_grad_of_pallas_pair(geometry, interpret_mode):
    """The backward as the kernel computes it on the stacked layout (gates,
    weight sums and dx as split-bf16 products, three pieces an operand, six
    passes, float32 sums; the carry in float32) against jax.grad of the
    Pallas pair, within GRAD_TOL: the numeric design meets the file's bound
    before any card run."""
    params, x, weight = _numpy_inputs(geometry, seed=5)
    want_params, want_x = jax.grad(
        lambda p, xx: jnp.sum(PT.bilstm_train_pallas(p, xx) * weight), argnums=(0, 1))(
        params, jnp.asarray(x))
    w, u, b = _stack_params(_leaves(params, False))
    xs = _stack_directions(torch.from_numpy(x)).contiguous()
    h_out, c_out = bilstm_train_reference(xs, w, u, b)
    dx, dw, du, db = bilstm_train_backward_reference(
        xs, w, u, b, h_out, c_out, stacked_cotangent(torch.from_numpy(weight), geometry[3]),
        emulate_kernel=True)
    np.testing.assert_allclose(input_grad(dx, geometry[0]).numpy(), np.asarray(want_x),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    for i, d in enumerate(("fw", "bw")):
        for k, got in (("w", dw[i]), ("u", du[i]), ("b", db[i])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want_params[d][k]),
                                       rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"{d}.{k}")


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_forward_kernel_numerics_match_the_pallas_forward(geometry, interpret_mode):
    """The forward as the kernels compute it on the stacked layout (xs.W
    and every step's h.U as split-bf16 products, three pieces an operand,
    float32 sums and cell) against the Pallas forward within VALUE_TOL:
    the numeric design meets the file's bound before any card run."""
    params, x, _ = _numpy_inputs(geometry, seed=6)
    want = np.asarray(PT.bilstm_train_pallas(params, jnp.asarray(x)))
    w, u, b = _stack_params(_leaves(params, False))
    xs = _stack_directions(torch.from_numpy(x)).contiguous()
    h_out, c_out = bilstm_train_reference(xs, w, u, b, emulate_kernel=True)
    plain_h, plain_c = bilstm_train_reference(xs, w, u, b)
    assert h_out.dtype == c_out.dtype == torch.float32 and c_out.shape == h_out.shape
    np.testing.assert_allclose(_unstack_outputs(h_out, geometry[0]).numpy(), want,
                               rtol=VALUE_TOL, atol=VALUE_TOL)
    np.testing.assert_allclose(c_out.numpy(), plain_c.numpy(), rtol=VALUE_TOL, atol=VALUE_TOL)


@pytest.mark.parametrize("feat", [32, 256])
def test_sweep_geometry_fits_the_model_widths(feat):
    """ModelConfig's widths (F = 32 and 256, H = 128) have launchable sweep
    geometries at every cluster size, and the Python carve-up agrees with
    the source's arithmetic: U's three pieces take 384 KB / C at H = 128,
    and two h tiles 2 * 3 * rows * H * 2 bytes."""
    geometries = sweep_geometries(128)
    assert {c for c, _ in geometries} == set(SWEEP_CLUSTERS)
    assert (2, 16) in geometries and (4, 64) in geometries and (8, 112) in geometries
    assert (2, 24) not in geometries  # 192 KB of U and 36 KB of h tiles
    assert (4, 72) not in geometries  # 36 warp items of 8 rows: more than 8 warps take
    for cluster, rows in geometries:
        smem, items = sweep_layout(128, cluster, rows)
        uc = 128 // cluster
        assert smem == 2 * 3 * 4 * uc * 128 + 2 * 2 * 3 * rows * 128 <= SMEM_LIMIT
        assert 3 * 4 * uc * 128 * 2 == 384 * 1024 // cluster
        assert items <= 16
    BT._check_sweep(feat, 128, 10000 * 33)  # the training batch raises nothing


def test_sweep_refuses_what_no_geometry_fits_before_any_launch(monkeypatch):
    """A hidden size whose U pieces fit no cluster (H = 512: 768 KB at a
    cluster of 8), and widths that are no multiple of 8, raise ValueError
    on the card path before the kernel's entry point is reached; H = 256
    still fits a cluster of 8."""
    assert sweep_geometries(256) and not sweep_geometries(264)
    assert sweep_layout(512, 8, 8)[0] > SMEM_LIMIT
    entries = []
    monkeypatch.setattr(BT, "on_cuda", lambda x, name: True)
    monkeypatch.setattr(BT, "entry", lambda *a: entries.append(a))
    before = bilstm_train.launches
    for feat, hidden, match in ((16, 512, "shared memory"), (12, 8, "multiples of 8"),
                                (16, 12, "multiples of 8")):
        params, x, _ = _numpy_inputs((2, 3, feat, hidden), seed=7)
        w, u, b = _stack_params(_leaves(params, False))
        xs = _stack_directions(torch.from_numpy(x)).contiguous()
        with pytest.raises(ValueError, match=match):
            bilstm_train_forward(xs, w, u, b)
    assert entries == [] and bilstm_train.launches == before


@pytest.mark.parametrize("geometry", [GEOMETRIES[2], GEOMETRIES[3]])
def test_plain_sweep_matches_autograd_of_plain_forward(geometry):
    """On the stacked layout: dx, dW, dU and db of the plain reverse sweep
    against torch.autograd through ``bilstm_train_reference``."""
    params, x, weight = _numpy_inputs(geometry, seed=1)
    w, u, b = (t.detach().requires_grad_() for t in _stack_params(_leaves(params, False)))
    xs = _stack_directions(torch.from_numpy(x)).contiguous().requires_grad_()
    h_out, c_out = bilstm_train_reference(xs, w, u, b)
    dh = _stack_directions(torch.from_numpy(weight)[..., :geometry[3]]).contiguous()
    (h_out * dh).sum().backward()
    got = bilstm_train_backward_reference(xs.detach(), w.detach(), u.detach(), b.detach(),
                                          h_out.detach(), c_out.detach(), dh)
    for name, g, want in zip(("dx", "dw", "du", "db"), got, (xs.grad, w.grad, u.grad, b.grad)):
        assert g.dtype == torch.float32 and g.shape == want.shape, name
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=PLAIN_RTOL, atol=PLAIN_ATOL,
                                   err_msg=name)


def test_float32_only():
    params, x, _ = _numpy_inputs(GEOMETRIES[3], seed=2)
    with pytest.raises(TypeError, match="float32"):
        bilstm_train(_leaves(params, False), torch.from_numpy(x).to(torch.bfloat16))


def test_no_input_gradient_unless_asked_and_no_launch_on_the_cpu():
    """lstm1's input takes no gradient: the backward then computes no dx;
    the CPU wrappers take the plain versions and launch nothing."""
    params, x, weight = _numpy_inputs(GEOMETRIES[3], seed=3)
    before = (bilstm_train.launches, bilstm_train_backward.launches)
    w, u, b = _stack_params(_leaves(params, False))
    xs = _stack_directions(torch.from_numpy(x)).contiguous()
    h_out, c_out = bilstm_train_forward(xs, w, u, b)
    dx, *_ = bilstm_train_backward(xs, w, u, b, h_out, c_out, torch.ones_like(h_out),
                                   need_dx=False)
    assert dx is None
    leaves = _leaves(params)
    out = bilstm_train(leaves, torch.from_numpy(x))
    (out * torch.from_numpy(weight)).sum().backward()
    assert all(leaves[d][k].grad is not None for d in leaves for k in leaves[d])
    with torch.no_grad():
        assert bilstm_train(leaves, torch.from_numpy(x)).grad_fn is None
    assert (bilstm_train.launches, bilstm_train_backward.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", CUDA_GEOMETRIES)
def test_cuda_kernels_match_plain_on_the_card(geometry):
    """Both kernels vs their plain versions on the card, on the same inputs:
    h and c within 1e-4, dx, dW, dU and db within 3e-4 of the reference's
    max magnitude (float32 sums in another order); two backward runs give
    the same bits (fixed-order partial sums, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    params, x, weight = _numpy_inputs(geometry, seed=4)
    w, u, b = (t.cuda() for t in _stack_params(_leaves(params, False)))
    xs = _stack_directions(torch.from_numpy(x).cuda()).contiguous()
    dh = _stack_directions(torch.from_numpy(weight).cuda()[..., :geometry[3]]).contiguous()
    before = (bilstm_train.launches, bilstm_train_backward.launches)
    h_out, c_out = bilstm_train_forward(xs, w, u, b)
    for got, want in zip((h_out, c_out), bilstm_train_reference(xs, w, u, b)):
        assert (got - want).abs().max().item() <= 1e-4
    got = bilstm_train_backward(xs, w, u, b, h_out, c_out, dh)
    again = bilstm_train_backward(xs, w, u, b, h_out, c_out, dh)
    want = bilstm_train_backward_reference(xs, w, u, b, h_out, c_out, dh)
    torch.cuda.synchronize()
    for name, g, g2, r in zip(("dx", "dw", "du", "db"), got, again, want):
        assert torch.equal(g, g2), name
        assert (g - r).abs().max() <= 3e-4 * r.abs().max(), name
    assert (bilstm_train.launches, bilstm_train_backward.launches) == (
        before[0] + 1, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [(100, 33, 32, 128), (100, 33, 256, 128), (13, 9, 24, 40)])
def test_cuda_forward_at_every_sweep_geometry(geometry):
    """The forward kernels at every (cluster, rows) of the sweep that
    launches, against the plain forward within 1e-4 (h and c); each counts
    no launch, and at least one geometry launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    params, x, _ = _numpy_inputs(geometry, seed=8)
    w, u, b = (t.cuda() for t in _stack_params(_leaves(params, False)))
    xs = _stack_directions(torch.from_numpy(x).cuda()).contiguous()
    want = bilstm_train_reference(xs, w, u, b)
    before, launched = bilstm_train.launches, []
    for cluster, rows in sweep_geometries(geometry[3]):
        got = BT._forward_launch(xs, w, u, b, cluster=cluster, rows=rows)
        if got is None:
            continue
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            assert (g - r).abs().max().item() <= 1e-4, (cluster, rows)
        launched.append((cluster, rows))
    assert launched and bilstm_train.launches == before
