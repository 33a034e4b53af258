"""The backward of the port's streaming BiLSTM: the plain reverse sweep
(``bilstm_stream_backward_reference``) against torch.autograd of the plain
forward, the autograd.Function on CPU tensors against ``jax.grad`` of the
streaming Pallas kernel in interpret mode, bf16 gradients against float32
ones, and the wiring (stacking, direction indexing, gradient dtypes, dx only
when asked). The CUDA kernel is compared with the plain sweep by the `cuda`
test at the end, which runs only where there is a card (and by
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clair_tpu.ops.pallas_bilstm_stream as PS
from clair_tpu_torch.models.bilstm import bilstm_with_cell
from clair_tpu_torch.ops.bilstm_stream import (
    _stack_params, _unstacked, bilstm_stream, bilstm_stream_backward,
    bilstm_stream_backward_reference,
)

# the geometries of tests/test_pallas_bilstm_stream.py
GEOMETRIES = [
    (8, 33, 32, 128),      # lstm1 geometry
    (8, 33, 256, 128),     # lstm2 geometry
    (12, 33, 32, 128),     # batch that is no tile multiple
    (8, 7, 16, 8),         # tiny odd geometry
]
# port vs the Pallas kernel's gradients: the tolerance of
# tests/test_pallas_bilstm_stream.py:50-52 (sums over 33 steps in another
# order)
RTOL, ATOL = 3e-4, 3e-5
# plain sweep vs autograd of the plain forward: both float32 on the CPU, the
# same products, summed in another order
PLAIN_RTOL, PLAIN_ATOL = 1e-4, 1e-5


@pytest.fixture
def interpret_mode():
    PS._INTERPRET = True
    yield
    PS._INTERPRET = False


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


def _cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_plain_backward_matches_autograd_of_plain_forward(geometry):
    params, x, weight = _numpy_inputs(geometry, seed=0)
    w, u, b = (t.detach().requires_grad_() for t in _stack_params(_leaves(params, False),
                                                                   torch.float32))
    xt = torch.tensor(x, requires_grad=True)
    h_out, c_out = bilstm_with_cell(_unstacked(w, u, b), xt)
    (h_out * torch.from_numpy(weight)).sum().backward()

    dx, dw, du, db = bilstm_stream_backward_reference(
        xt.detach(), w.detach(), u.detach(), b.detach(), h_out.detach(), c_out.detach(),
        torch.from_numpy(weight))
    for got, want in ((dx, xt.grad), (dw, w.grad), (du, u.grad), (db, b.grad)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=PLAIN_RTOL, atol=PLAIN_ATOL)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_function_grads_match_jax_grad_of_pallas_kernel(geometry, interpret_mode):
    params, x, weight = _numpy_inputs(geometry, seed=1)

    def jax_loss(p, xx):
        return jnp.sum(PS.bilstm_train_stream(p, xx) * weight)

    want_params, want_x = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(x))

    leaves = _leaves(params)
    xt = torch.tensor(x, requires_grad=True)
    out = bilstm_stream(leaves, xt)
    assert out.grad_fn is not None and "BiLSTMStream" in type(out.grad_fn).__name__
    (out * torch.from_numpy(weight)).sum().backward()

    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), rtol=RTOL, atol=ATOL)
    for d in ("fw", "bw"):
        for k in ("w", "u", "b"):
            got = leaves[d][k].grad
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want_params[d][k]),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{d}.{k}")


@pytest.mark.parametrize("geometry", GEOMETRIES[:2])
def test_bf16_gradients_track_float32(geometry):
    """bf16 x, W, U and h, float32 gates and cell: every gradient stays
    finite, its cosine with the float32 gradient is above 0.99 (the bound
    of tests/test_pallas_bilstm_stream.py's bf16 test), and the parameter
    gradients come back through the bf16 cast, as in the JAX package."""
    params, x, weight = _numpy_inputs(geometry, seed=2)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        leaves = _leaves(params)
        xt = torch.tensor(x, requires_grad=True)
        out = bilstm_stream(leaves, xt.to(dtype))
        assert out.dtype == dtype
        (out.float() * torch.from_numpy(weight)).sum().backward()
        grads[dtype] = {f"{d}.{k}": leaves[d][k].grad for d in leaves for k in leaves[d]}
        grads[dtype]["x"] = xt.grad
    for name, g16 in grads[torch.bfloat16].items():
        assert g16.dtype == torch.float32 and torch.isfinite(g16).all(), name
        assert _cosine(g16, grads[torch.float32][name]) > 0.99, name
        if name.endswith((".w", ".u")):
            # dW and dU were rounded to bf16 (the stacked parameters' dtype)
            assert torch.equal(g16, g16.to(torch.bfloat16).float()), name


def test_no_input_gradient_unless_asked():
    """lstm1's input takes no gradient: the backward then computes no dx,
    and asks for it when the input requires one."""
    params, x, weight = _numpy_inputs(GEOMETRIES[3], seed=3)
    w, u, b = _stack_params(_leaves(params, False), torch.float32)
    h_out, c_out = bilstm_with_cell(_unstacked(w, u, b), torch.from_numpy(x))
    dx, *_ = bilstm_stream_backward(torch.from_numpy(x), w, u, b, h_out, c_out,
                                    torch.from_numpy(weight), need_dx=False)
    assert dx is None
    leaves = _leaves(params)
    out = bilstm_stream(leaves, torch.from_numpy(x))
    (out * torch.from_numpy(weight)).sum().backward()
    assert all(leaves[d][k].grad is not None for d in leaves for k in leaves[d])


def test_no_gradient_path_when_none_is_wanted():
    """Under no_grad, or with frozen parameters, the layer is the plain
    forward with no graph (the calling path)."""
    params, x, _ = _numpy_inputs(GEOMETRIES[3], seed=4)
    leaves = _leaves(params)
    with torch.no_grad():
        assert bilstm_stream(leaves, torch.from_numpy(x)).grad_fn is None
    assert bilstm_stream(_leaves(params, False), torch.from_numpy(x)).grad_fn is None


def test_cell_states_form_refuses_a_gradient():
    """``with_cell`` gives the forward alone: when a gradient is wanted it
    raises, here on the CPU as on the card, rather than return outputs that
    carry no gradient on the card; under no_grad it runs."""
    params, x, _ = _numpy_inputs(GEOMETRIES[3], seed=7)
    with pytest.raises(ValueError, match="no gradient"):
        bilstm_stream(_leaves(params), torch.from_numpy(x), with_cell=True)
    with pytest.raises(ValueError, match="no gradient"):
        bilstm_stream(_leaves(params, False), torch.tensor(x, requires_grad=True),
                      with_cell=True)
    with torch.no_grad():
        h, c = bilstm_stream(_leaves(params), torch.from_numpy(x), with_cell=True)
    assert h.grad_fn is None and c.dtype == torch.float32


def test_wrappers_on_cpu_launch_no_kernel():
    params, x, weight = _numpy_inputs(GEOMETRIES[3], seed=5)
    before = (bilstm_stream.launches, bilstm_stream_backward.launches)
    leaves = _leaves(params)
    (bilstm_stream(leaves, torch.tensor(x, requires_grad=True))
     * torch.from_numpy(weight)).sum().backward()
    assert (bilstm_stream.launches, bilstm_stream_backward.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_cuda_backward_kernel_matches_plain_on_the_card(geometry):
    """Backward kernel vs the plain sweep on the card, on the same saved
    forward: float32 max |diff| of dx, dW, dU and db within 3e-4 of the
    reference's max magnitude (sums over B*T rows in another order), bf16
    gradient cosine above 0.99 and max |diff| within 1e-2 of the reference's
    max magnitude (bf16 dx is rounded to a 2**-8 step); one launch per
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    params, x, weight = _numpy_inputs(geometry, seed=6)
    before = bilstm_stream_backward.launches
    for dtype in (torch.float32, torch.bfloat16):
        w, u, b = _stack_params(_leaves(params, False), dtype)
        w, u, b = w.cuda(), u.cuda(), b.cuda()
        xd = torch.from_numpy(x).cuda().to(dtype)
        h_out, c_out = bilstm_with_cell(_unstacked(w, u, b), xd)
        dh = torch.from_numpy(weight).cuda().to(dtype)
        got = bilstm_stream_backward(xd, w, u, b, h_out, c_out, dh)
        want = bilstm_stream_backward_reference(xd, w, u, b, h_out, c_out, dh)
        torch.cuda.synchronize()
        for name, g, r in zip(("dx", "dw", "du", "db"), got, want):
            assert g.shape == r.shape and g.dtype == r.dtype, name
            g, r = g.float().cpu(), r.float().cpu()
            if dtype == torch.float32:
                assert (g - r).abs().max() <= 3e-4 * r.abs().max(), name
            else:
                assert _cosine(g, r) > 0.99, name
                assert (g - r).abs().max() <= 1e-2 * r.abs().max(), name
    assert bilstm_stream_backward.launches == before + 2
