"""The port's two-layer BiLSTM (ops/bilstm2.py, the plain version on the
CPU) against the JAX package's ``bilstm2_pallas`` in interpret mode, at
the geometry and tolerance of tests/test_pallas_bilstm2.py; it is forward
only. Where there is a card, the `cuda` test holds the kernel against its
plain version (also run by chip_smoke.py)."""

import jax
import numpy as np
import pytest
import torch

from clair_tpu.models.bilstm import init_bilstm_params
from clair_tpu.ops.pallas_bilstm2 import bilstm2_pallas
from clair_tpu_torch.ops.bilstm2 import bilstm2, bilstm2_reference

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


def test_forward_only():
    p1, p2, x = _inputs(4)
    with pytest.raises(ValueError, match="forward only"):
        bilstm2(_torch(p1), _torch(p2), torch.tensor(x, requires_grad=True))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden,feat", [(16, 16, 32), (13, 128, 32), (70, 8, 16)])
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
