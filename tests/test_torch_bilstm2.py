"""The port's two-layer BiLSTM (ops/bilstm2.py, the plain version on the
CPU) against the JAX package's ``bilstm2_pallas`` in interpret mode, at
the geometry and tolerance of tests/test_pallas_bilstm2.py, both as the
plain layers and as the kernels compute it (three-piece split-bf16
products); it is forward only, and counts only its own launches. Where
there is a card, the `cuda` tests hold the kernels against the plain
version (also run by chip_smoke.py)."""

import jax
import numpy as np
import pytest
import torch

import clair_tpu_torch.ops.bilstm2 as B2
import clair_tpu_torch.ops.bilstm_train as BT
from clair_tpu.models.bilstm import init_bilstm_params
from clair_tpu.ops.pallas_bilstm2 import bilstm2_pallas
from clair_tpu_torch.ops.bilstm2 import bilstm2, bilstm2_reference
from clair_tpu_torch.ops.bilstm_train import bilstm_train, sweep_geometries

TOL = 2e-5  # tests/test_pallas_bilstm2.py


def _inputs(batch, hidden=16, feat=32, seed=0):
    k1, k2, kx = jax.random.split(jax.random.PRNGKey(seed), 3)
    p1 = init_bilstm_params(k1, feat, hidden)
    p2 = init_bilstm_params(k2, 2 * hidden, hidden)
    x = np.array(jax.random.normal(kx, (batch, 33, feat)))
    return p1, p2, x


def _torch(params):
    return {d: {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
            for d, p in params.items()}


@pytest.mark.parametrize("batch", [16, 70])
def test_matches_bilstm2_pallas(batch):
    p1, p2, x = _inputs(batch)
    want = np.asarray(bilstm2_pallas(p1, p2, x, block_b=16, interpret=True))
    before = bilstm2.launches
    with torch.no_grad():
        got = bilstm2(_torch(p1), _torch(p2), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (batch, 33, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert bilstm2.launches == before


@pytest.mark.parametrize("batch", [16, 70])
def test_kernel_numerics_match_bilstm2_pallas(batch):
    """Both layers as the kernels compute them (the stacked layout, xs.W
    and h.U as three-piece split-bf16 products) against the Pallas kernel
    within TOL, before any card run."""
    p1, p2, x = _inputs(batch, seed=2)
    want = np.asarray(bilstm2_pallas(p1, p2, x, block_b=16, interpret=True))
    got = bilstm2_reference(_torch(p1), _torch(p2), torch.from_numpy(x), emulate_kernel=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_counts_only_its_own_launches(monkeypatch):
    """On the card path (the entry point stubbed here) one bilstm2 call is
    one count of bilstm2.launches and none of bilstm_train.launches, and it
    reaches the forward's entry point once per layer, each on the stacked
    layout of its layer's input."""
    calls = []

    def fake_entry(*names):
        def fn(xs, w, u, b, h_out, c_out, xw, scratch, nbytes, batch, t_len, feat, hidden,
               cluster, rows, chosen, stream):
            calls.append((batch, t_len, feat, hidden, c_out))
            return 0
        return fn

    monkeypatch.setattr(B2, "on_cuda", lambda x, name: True)
    monkeypatch.setattr(BT, "entry", fake_entry)
    monkeypatch.setattr(torch.cuda, "device", lambda device: torch.no_grad())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("S", (), {"cuda_stream": 0}))
    p1, p2, x = _inputs(5)
    before = (bilstm2.launches, bilstm_train.launches)
    with torch.no_grad():
        out = bilstm2(_torch(p1), _torch(p2), torch.from_numpy(x))
    assert out.shape == (5, 33, 32)
    assert (bilstm2.launches, bilstm_train.launches) == (before[0] + 1, before[1])
    assert calls == [(5, 33, 32, 16, None), (5, 33, 32, 16, None)]


def test_forward_only():
    p1, p2, x = _inputs(4)
    with pytest.raises(ValueError, match="forward only"):
        bilstm2(_torch(p1), _torch(p2), torch.tensor(x, requires_grad=True))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden,feat", [(16, 16, 32), (13, 128, 32), (70, 8, 16),
                                               (13, 40, 16), (100, 24, 32)])
def test_cuda_kernel_matches_plain_on_the_card(batch, hidden, feat):
    """The kernel vs the two plain layers on the card: within 1e-4 (float32
    sums in another order over two layers of 33 steps); one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    p1, p2, x = _inputs(batch, hidden, feat, seed=1)
    t1 = {d: {k: v.cuda() for k, v in p.items()} for d, p in _torch(p1).items()}
    t2 = {d: {k: v.cuda() for k, v in p.items()} for d, p in _torch(p2).items()}
    xd = torch.from_numpy(x).cuda()
    before = bilstm2.launches
    with torch.no_grad():
        got, want = bilstm2(t1, t2, xd), bilstm2_reference(t1, t2, xd)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    assert bilstm2.launches == before + 1


@pytest.mark.cuda
def test_cuda_kernels_at_every_sweep_geometry():
    """Both layers at every (cluster, rows) of the sweep that launches, at a
    batch of 100 and ModelConfig's widths, against the plain layers within
    1e-4; no count moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    p1, p2, x = _inputs(100, 128, 32, seed=3)
    t1 = {d: {k: v.cuda() for k, v in p.items()} for d, p in _torch(p1).items()}
    t2 = {d: {k: v.cuda() for k, v in p.items()} for d, p in _torch(p2).items()}
    xd = torch.from_numpy(x).cuda()
    before, launched = (bilstm2.launches, bilstm_train.launches), []
    with torch.no_grad():
        want = bilstm2_reference(t1, t2, xd)
        for cluster, rows in sweep_geometries(128):
            got = B2._layers(t1, t2, xd, cluster, rows)
            if got is None:
                continue
            torch.cuda.synchronize()
            assert (got - want).abs().max().item() <= 1e-4, (cluster, rows)
            launched.append((cluster, rows))
    assert launched and (bilstm2.launches, bilstm_train.launches) == before
