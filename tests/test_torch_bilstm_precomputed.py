"""The port's forward-only BiLSTM on precomputed projections
(ops/bilstm.py, the plain version on the CPU) against the JAX package's
``bilstm_pallas`` (clair_tpu/ops/pallas_bilstm.py): float32 within 2e-5,
and bfloat16 (output float32 in both) within two bf16 steps. The JAX
function's ``_lstm_pallas`` takes no interpret flag and refuses the CPU
backend, so the tests run it through a freshly jitted copy whose
``pallas_call`` adds ``interpret=True``; the JAX package is not edited.
Where there is a card, the `cuda` test holds the kernel against its plain
version (also run by chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clair_tpu.ops.pallas_bilstm as PB
from clair_tpu_torch.ops.bilstm import (
    bilstm_precomputed, bilstm_recurrence, bilstm_recurrence_reference, projections,
)

GEOMETRIES = [
    (8, 33, 32, 128),      # lstm1 geometry
    (8, 33, 256, 128),     # lstm2 geometry
    (12, 7, 16, 8),        # a batch that is no multiple of the JAX block
]
F32_TOL = 2e-5  # float32 sums in another order over the steps
BLOCK = 8       # the JAX kernel's batch block (padding only; no effect on values)


class _InterpretPallas:
    """``pallas`` as the module sees it, with ``interpret=True`` added to
    every ``pallas_call``."""

    def __init__(self, pl):
        self._pl = pl

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        return self._pl.pallas_call(*args, interpret=True, **kwargs)


def interpret_pallas(monkeypatch):
    """Make ``bilstm_pallas`` run its kernel in interpret mode on the CPU:
    the module's ``pl`` swapped for the shim, and ``_lstm_pallas`` jitted
    afresh so no trace made with the real one is reused."""
    monkeypatch.setattr(PB, "pl", _InterpretPallas(PB.pl))
    monkeypatch.setattr(PB, "_lstm_pallas", jax.jit(PB._lstm_pallas.__wrapped__,
                                                    static_argnames=("block_b",)))


@pytest.fixture
def interpret_mode(monkeypatch):
    interpret_pallas(monkeypatch)


def _numpy_inputs(geometry, seed):
    b, t, f, h = geometry
    rs = np.random.RandomState(seed)

    def one():
        scale = 1.0 / np.sqrt(h)
        return {"w": (rs.randn(f, 4 * h) * scale).astype(np.float32),
                "u": (rs.randn(h, 4 * h) * scale).astype(np.float32),
                "b": (rs.randn(4 * h) * 0.1).astype(np.float32)}

    return {"fw": one(), "bw": one()}, rs.randn(b, t, f).astype(np.float32)


def _torch(params, dtype=torch.float32):
    return {d: {k: torch.from_numpy(v).to(dtype) for k, v in p.items()} for d, p in params.items()}


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_float32_matches_bilstm_pallas(geometry, interpret_mode):
    params, x = _numpy_inputs(geometry, seed=0)
    want = np.asarray(PB.bilstm_pallas(params, jnp.asarray(x), block_b=BLOCK))
    with torch.no_grad():
        got = bilstm_precomputed(_torch(params), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("geometry", GEOMETRIES[:2])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_bfloat16_weights_match_bilstm_pallas(geometry, x_dtype, interpret_mode):
    """bf16 weights with a bf16 input (lstm1 under bf16 compute: xw in
    bf16) or a float32 one (lstm2, fed lstm1's float32 output: xw promoted
    to float32). The output is float32, as the JAX kernel's; h in (-1, 1)
    is within two bf16 steps (2**-8 each) of the JAX result, which rounds
    xw where the port does but sums in another order."""
    params, x = _numpy_inputs(geometry, seed=1)
    jax_params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = PB.bilstm_pallas(jax_params, jnp.asarray(x, x_dtype), block_b=BLOCK)
    assert want.dtype == jnp.float32
    with torch.no_grad():
        got = bilstm_precomputed(_torch(params, torch.bfloat16),
                                 torch.from_numpy(x).to(getattr(torch, x_dtype)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2 * 2.0 ** -8)


def test_projections_promote_as_jax_does():
    params, x = _numpy_inputs(GEOMETRIES[2], seed=2)
    p16 = _torch(params, torch.bfloat16)
    xw, u = projections(p16, torch.from_numpy(x).to(torch.bfloat16))
    assert xw.dtype == torch.bfloat16 and u.dtype == torch.bfloat16
    assert xw.shape == (2, 7, 12, 32)
    xw, _ = projections(p16, torch.from_numpy(x))
    assert xw.dtype == torch.float32
    # direction 1 runs on the time-reversed sequence
    full, _ = projections(_torch(params), torch.from_numpy(x))
    want = torch.from_numpy(x[:, ::-1].copy()) @ torch.from_numpy(params["bw"]["w"])
    np.testing.assert_allclose(full[1].numpy(), (want + torch.from_numpy(params["bw"]["b"]))
                               .transpose(0, 1).numpy(), rtol=1e-6, atol=1e-6)


def test_forward_only():
    """The JAX kernel has no gradient: the port raises, naming the flag,
    when one is wanted; under no_grad the CPU path launches no kernel."""
    params, x = _numpy_inputs(GEOMETRIES[2], seed=3)
    leaves = {d: {k: v.requires_grad_() for k, v in p.items()} for d, p in _torch(params).items()}
    with pytest.raises(ValueError, match="use_pallas_bilstm"):
        bilstm_precomputed(leaves, torch.from_numpy(x))
    with pytest.raises(ValueError, match="forward only"):
        bilstm_precomputed(_torch(params), torch.tensor(x, requires_grad=True))
    before = bilstm_precomputed.launches
    with torch.no_grad():
        bilstm_precomputed(leaves, torch.from_numpy(x))
    assert bilstm_precomputed.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_cuda_kernel_matches_plain_on_the_card(geometry):
    """The recurrence kernel vs its plain version on the card, on the same
    xw and u, in each dtype pair the model gives it: within 1e-4 (float32
    sums in another order; both read the same bf16 values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    params, x = _numpy_inputs(geometry, seed=4)
    before = bilstm_precomputed.launches
    for p_dtype, x_dtype in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                             (torch.bfloat16, torch.float32)):
        p = {d: {k: v.cuda() for k, v in q.items()} for d, q in _torch(params, p_dtype).items()}
        xw, u = projections(p, torch.from_numpy(x).cuda().to(x_dtype))
        got, want = bilstm_recurrence(xw, u), bilstm_recurrence_reference(xw, u)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        assert (got - want).abs().max().item() <= 1e-4
    assert bilstm_precomputed.launches == before + 3
