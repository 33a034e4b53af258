"""The streaming BiLSTM of the port (plain version; the wrapper on a CPU
tensor) against the JAX lax.scan BiLSTM, against the streaming Pallas
kernel in interpret mode, and against torch.nn.LSTM. The CUDA kernel itself
is compared with the plain version by the `cuda` test at the end, which
runs only where there is a card (and by chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clair_tpu.ops.pallas_bilstm_stream as PS
from clair_tpu.models.bilstm import bilstm as jax_bilstm
from clair_tpu_torch.models.bilstm import bilstm, bilstm_with_cell
from clair_tpu_torch.ops.bilstm_stream import (
    FWD_CLUSTERS, FWD_ROWS, _stack_params, bilstm_stream, bilstm_stream_reference,
    f32_geometries, forward_geometry,
)

GEOMETRIES = [
    (8, 33, 32, 128),      # lstm1 geometry
    (8, 33, 256, 128),     # lstm2 geometry
    (12, 33, 32, 128),     # batch that is no tile multiple
    (8, 7, 16, 8),         # tiny odd geometry
]
# float32: the family of tests/test_pallas_bilstm_stream.py (sum order
# differs between XLA and torch over 33 steps)
F32_TOL = 2e-5


@pytest.fixture
def interpret_mode():
    PS._INTERPRET = True
    yield
    PS._INTERPRET = False


def _numpy_params(rs, feat, hidden):
    def one():
        scale = 1.0 / np.sqrt(hidden)
        return {"w": (rs.randn(feat, 4 * hidden) * scale).astype(np.float32),
                "u": (rs.randn(hidden, 4 * hidden) * scale).astype(np.float32),
                "b": (rs.randn(4 * hidden) * 0.1).astype(np.float32)}
    return {"fw": one(), "bw": one()}


def _torch_params(params):
    return {d: {k: torch.from_numpy(v) for k, v in p.items()} for d, p in params.items()}


def _inputs(geometry, seed=0):
    b, t, f, h = geometry
    rs = np.random.RandomState(seed)
    return _numpy_params(rs, f, h), rs.randn(b, t, f).astype(np.float32)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_plain_matches_jax_scan(geometry):
    params, x = _inputs(geometry)
    want = np.asarray(jax_bilstm(params, jnp.asarray(x)))
    got = bilstm(_torch_params(params), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == geometry[:2] + (2 * geometry[3],)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_plain_matches_pallas_stream_kernel(geometry, interpret_mode):
    """h against the TPU kernel's forward (interpret mode), and c against
    its f32 cell-state output, re-laid out as (B, T, 2H)."""
    params, x = _inputs(geometry, seed=1)
    b = x.shape[0]
    want_h = np.asarray(PS.bilstm_train_stream(params, jnp.asarray(x)))
    _, (_, _, _, c_out, _) = PS._bilstm_fwd(params, jnp.asarray(x))
    c_out = np.asarray(c_out)                   # (T, 2Bp, H), stacked directions
    bp = c_out.shape[1] // 2
    want_c = np.concatenate([c_out[:, :b].transpose(1, 0, 2),
                             c_out[:, bp:bp + b].transpose(1, 0, 2)[:, ::-1]], axis=-1)
    got_h, got_c = bilstm_stream_reference(_torch_params(params), torch.from_numpy(x))
    assert got_c.dtype == torch.float32
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_plain_matches_torch_nn_lstm(geometry):
    """torch.nn.LSTM as an independent oracle: weight_ih = w.T,
    weight_hh = u.T, bias_ih = b, bias_hh = 0, gate order (i, f, g, o)."""
    params, x = _inputs(geometry, seed=2)
    b, t, f, h = geometry
    lstm = torch.nn.LSTM(f, h, batch_first=True, bidirectional=True)
    with torch.no_grad():
        for suffix, d in (("", "fw"), ("_reverse", "bw")):
            getattr(lstm, f"weight_ih_l0{suffix}").copy_(torch.from_numpy(params[d]["w"].T))
            getattr(lstm, f"weight_hh_l0{suffix}").copy_(torch.from_numpy(params[d]["u"].T))
            getattr(lstm, f"bias_ih_l0{suffix}").copy_(torch.from_numpy(params[d]["b"]))
            getattr(lstm, f"bias_hh_l0{suffix}").zero_()
        want = lstm(torch.from_numpy(x))[0].numpy()
    got = bilstm(_torch_params(params), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("geometry", GEOMETRIES[:2])
def test_bf16_close_to_f32_with_f32_cell(geometry, interpret_mode):
    """bf16 x, W, U and h with float32 gates and cell: h stays bfloat16 and
    tracks the float32 output to bf16 resolution (the bounds of
    tests/test_pallas_bilstm_stream.py's bf16 test), c stays float32, and
    the output is within a few bf16 steps of the Pallas kernel's bf16 run."""
    params, x = _inputs(geometry, seed=3)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    h16, c16 = bilstm_with_cell(_torch_params(params), x16)
    h32 = bilstm(_torch_params(params), torch.from_numpy(x))
    assert h16.dtype == torch.bfloat16 and c16.dtype == torch.float32
    np.testing.assert_allclose(h16.float().numpy(), h32.numpy(), rtol=0.1, atol=0.05)
    kernel16 = np.asarray(
        PS.bilstm_train_stream(params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    # h lies in (-1, 1), where a bf16 step is at most 2**-8
    np.testing.assert_allclose(h16.float().numpy(), kernel16, rtol=0, atol=2 * 2.0 ** -8)


def test_wrapper_on_cpu_takes_the_plain_path():
    params, x = _inputs(GEOMETRIES[3], seed=4)
    before = bilstm_stream.launches
    tp = _torch_params(params)
    h, c = bilstm_stream(tp, torch.from_numpy(x), with_cell=True)
    want_h, want_c = bilstm_stream_reference(tp, torch.from_numpy(x))
    assert torch.equal(h, want_h) and torch.equal(c, want_c)
    assert torch.equal(bilstm_stream(tp, torch.from_numpy(x)), want_h)
    assert bilstm_stream.launches == before


def test_wrapper_refuses_other_devices():
    params, x = _inputs(GEOMETRIES[3], seed=5)
    meta = {d: {k: v.to("meta") for k, v in p.items()} for d, p in _torch_params(params).items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        bilstm_stream(meta, torch.from_numpy(x).to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_cuda_kernel_matches_plain_on_the_card(geometry):
    """Kernel vs plain version on the card: float32 within 1e-4 on h and c
    (sum order differs over 33 steps), bf16 within 2e-2 on h."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    params, x = _inputs(geometry, seed=6)
    tp = {d: {k: v.cuda() for k, v in p.items()} for d, p in _torch_params(params).items()}
    before = bilstm_stream.launches
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        xd = torch.from_numpy(x).cuda().to(dtype)
        h, c = bilstm_stream(tp, xd, with_cell=True)
        want_h, want_c = bilstm_stream_reference(tp, xd)
        torch.cuda.synchronize()
        assert (h.float() - want_h.float()).abs().max().item() <= tol
        if dtype == torch.float32:
            assert (c - want_c).abs().max().item() <= tol
    assert bilstm_stream.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [32, 256])
def test_cuda_kernel_right_at_every_launchable_geometry(feat):
    """The forward at every (cluster size, rows per tile) that launches,
    against the plain version, at a small ragged batch of either layer's
    width (idle warps at the larger clusters, where a race once hid): h and
    c within the tolerances above; bf16 over its kernel's geometries,
    float32 over the sweep's (f32_geometries)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    params, x = _inputs((100, 33, feat, 128), seed=7)
    tp = {d: {k: v.cuda() for k, v in p.items()} for d, p in _torch_params(params).items()}
    bf16_geometries = [(c, r) for c in FWD_CLUSTERS for r in FWD_ROWS]
    for dtype, tol, geometries in ((torch.float32, 1e-4, f32_geometries(feat, 128)),
                                   (torch.bfloat16, 2e-2, bf16_geometries)):
        xd = torch.from_numpy(x).cuda().to(dtype)
        want_h, want_c = bilstm_stream_reference(tp, xd)
        launched = 0
        for cluster, rows in geometries:
            got = forward_geometry(xd, *_stack_params(tp, dtype), cluster, rows)
            if got is None:
                continue
            torch.cuda.synchronize()
            launched += 1
            assert (got[0].float() - want_h.float()).abs().max().item() <= tol, (cluster, rows)
            assert (got[1] - want_c).abs().max().item() <= tol, (cluster, rows)
        assert launched > 0, dtype
