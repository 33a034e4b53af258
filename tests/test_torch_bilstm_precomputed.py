"""The port's forward-only BiLSTM on precomputed projections
(ops/bilstm.py, the plain version on the CPU) against the JAX package's
``bilstm_pallas`` (clair_tpu/ops/pallas_bilstm.py): float32 within 2e-5,
and bfloat16 (output float32 in both) within two bf16 steps. The JAX
function's ``_lstm_pallas`` takes no interpret flag and refuses the CPU
backend, so the tests run it through a freshly jitted copy whose
``pallas_call`` adds ``interpret=True``; the JAX package is not edited.
The kernel's arithmetic on the CPU (``emulate_kernel``: h.U as the
tensor-core product of three bf16 pieces, a bf16 U one exact piece) is held
against both, in the three dtype pairs the model gives the kernel. Where
there is a card, the `cuda` tests hold the kernel against its plain version
at the launcher's geometry and at every sweep geometry (also run by
chip_smoke.py, phase 3c)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clair_tpu.ops.pallas_bilstm as PB
import clair_tpu_torch.ops.bilstm as B
from clair_tpu_torch.ops.bilstm import (
    bilstm_precomputed, bilstm_recurrence, bilstm_recurrence_reference, projections, u_pieces,
)
from clair_tpu_torch.ops.lstm_sweep import SWEEP_CLUSTERS, sweep_geometries, sweep_layout

GEOMETRIES = [
    (8, 33, 32, 128),      # lstm1 geometry
    (8, 33, 256, 128),     # lstm2 geometry
    (12, 7, 16, 8),        # a batch that is no multiple of the JAX block
]
F32_TOL = 2e-5  # float32 sums in another order over the steps
BF16_TOL = 2 * 2.0 ** -8  # bf16 weights: two bf16 steps of h in (-1, 1)
BLOCK = 8       # the JAX kernel's batch block (padding only; no effect on values)
# (weight dtype, input dtype) pairs the model gives the kernel: float32;
# lstm1 under bf16 (xw and U bf16); lstm2 under bf16 (xw float32, U bf16)
PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32")]
SMEM_LIMIT = 227 * 1024


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


def _pallas_and_torch_inputs(geometry, pair, seed):
    """The same numpy inputs for ``bilstm_pallas`` (jnp, in the pair's
    dtypes) and the port (torch, the same dtypes)."""
    params, x = _numpy_inputs(geometry, seed)
    w_dtype, x_dtype = pair
    jax_params = jax.tree.map(lambda a: jnp.asarray(a, w_dtype), params)
    return ((jax_params, jnp.asarray(x, x_dtype)),
            (_torch(params, getattr(torch, w_dtype)), torch.from_numpy(x).to(getattr(torch, x_dtype))))


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("pair", PAIRS)
def test_kernel_numerics_match_bilstm_pallas(geometry, pair, interpret_mode, monkeypatch):
    """The layer with its recurrence as the kernel computes it
    (``emulate_kernel``: each step's h.U as the split-bf16 product, h in
    three pieces and U in three, a bf16 U's later pieces 0) against
    ``bilstm_pallas`` in interpret mode, in each dtype pair: float32 within
    2e-5, bf16 weights within two bf16 steps (the JAX side sums in another
    order)."""
    (jax_params, jax_x), (params, x) = _pallas_and_torch_inputs(geometry, pair, seed=5)
    want = np.asarray(PB.bilstm_pallas(jax_params, jax_x, block_b=BLOCK))
    monkeypatch.setattr(B, "bilstm_recurrence", lambda xw, u: bilstm_recurrence_reference(
        xw, u, emulate_kernel=True))
    with torch.no_grad():
        got = bilstm_precomputed(params, x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    rtol, atol = (F32_TOL, F32_TOL) if pair[0] == "float32" else (0, BF16_TOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("pair", PAIRS)
def test_kernel_numerics_match_the_plain_recurrence(geometry, pair):
    """On the same xw and u, the kernel's arithmetic (three bf16 pieces of
    h, one or three of U) against the plain float32 recurrence, within
    2e-5: the pieces keep float32-level products."""
    _, (params, x) = _pallas_and_torch_inputs(geometry, pair, seed=6)
    xw, u = projections(params, x)
    got = bilstm_recurrence_reference(xw, u, emulate_kernel=True)
    want = bilstm_recurrence_reference(xw, u)
    assert got.dtype == torch.float32 and got.shape == (2, geometry[1], geometry[0], geometry[3])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_sweep_carve_up_of_a_bf16_u():
    """A bf16 U is one piece in the sweep's shared memory (128 KB / C at
    H = 128, a third of a float32 U's), which frees geometries: every one a
    float32 U fits, and more, at every cluster size; H = 264 fits only as
    one piece."""
    one, three = sweep_geometries(128, 1), sweep_geometries(128, 3)
    assert set(three) < set(one) and {c for c, _ in one} == set(SWEEP_CLUSTERS)
    assert (2, 32) in one and (2, 32) not in three and (8, 128) in one
    for cluster, rows in one:
        smem, items = sweep_layout(128, cluster, rows, 1)
        uc = 128 // cluster
        assert smem == 2 * 4 * uc * 128 + 2 * 2 * 3 * rows * 128 <= SMEM_LIMIT and items <= 16
        assert smem == sweep_layout(128, cluster, rows, 3)[0] - 2 * 2 * 4 * uc * 128
    assert sweep_geometries(264, 1) and not sweep_geometries(264, 3)
    assert u_pieces(torch.zeros(1, dtype=torch.bfloat16)) == 1
    assert u_pieces(torch.zeros(1)) == 3


def test_card_path_raises_before_a_launch_where_the_sweep_cannot_take_h(monkeypatch):
    """On the card path (entry point stubbed here): H no multiple of 8, or a
    float32 U too large for the sweep's shared memory, raise ValueError
    before the entry point is reached; the same H as a bf16 U (one piece)
    fits and launches once, at the launcher's geometry, counted once."""
    calls = []

    def fake_entry(*names):
        def fn(xw, u, out, n, t_len, hidden, xw_bf16, u_bf16, cluster, rows, chosen, stream):
            calls.append((n, t_len, hidden, xw_bf16, u_bf16, cluster, rows))
            return 0
        return fn

    monkeypatch.setattr(B, "on_cuda", lambda x, name: True)
    monkeypatch.setattr(B, "entry", fake_entry)
    monkeypatch.setattr(torch.cuda, "device", lambda device: torch.no_grad())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("S", (), {"cuda_stream": 0}))
    before = bilstm_precomputed.launches
    for hidden, dtype, match in ((12, torch.float32, "multiples of 8"),
                                 (12, torch.bfloat16, "multiples of 8"),
                                 (264, torch.float32, "shared memory")):
        xw, u = torch.zeros(2, 3, 5, 4 * hidden), torch.zeros(2, hidden, 4 * hidden, dtype=dtype)
        with pytest.raises(ValueError, match=match):
            bilstm_recurrence(xw, u)
    assert calls == [] and bilstm_precomputed.launches == before
    xw, u = (torch.zeros(2, 3, 5, 4 * 264, dtype=torch.bfloat16),
             torch.zeros(2, 264, 4 * 264, dtype=torch.bfloat16))
    assert bilstm_recurrence(xw, u).shape == (2, 3, 5, 264)
    assert calls == [(5, 3, 264, 1, 1, 0, 0)] and bilstm_precomputed.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [(100, 33, 32, 128), (13, 33, 256, 128), (12, 7, 16, 8)])
def test_cuda_kernel_at_every_sweep_geometry(geometry):
    """The kernel at every (cluster, rows) of the sweep that launches for
    U's piece count, in each dtype pair, against the plain version within
    1e-4; each counts no launch, and at least one geometry launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    before = bilstm_precomputed.launches
    for pair in PAIRS:
        _, (params, x) = _pallas_and_torch_inputs(geometry, pair, seed=9)
        params = {d: {k: v.cuda() for k, v in q.items()} for d, q in params.items()}
        xw, u = projections(params, x.cuda())
        want = bilstm_recurrence_reference(xw, u)
        launched = []
        for cluster, rows in sweep_geometries(geometry[3], u_pieces(u)):
            got = B._launch(xw, u, cluster, rows)
            if got is None:
                continue
            torch.cuda.synchronize()
            assert (got - want).abs().max().item() <= 1e-4, (pair, cluster, rows)
            launched.append((cluster, rows))
        assert launched, pair
    assert bilstm_precomputed.launches == before
