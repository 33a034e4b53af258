"""The streaming forward's float32 mode (csrc/bilstm_stream_fwd.cu), which
runs x.W on the tensor cores and then the float32 sweep of
csrc/lstm_sweep.cuh: its arithmetic emulated on the CPU against the JAX
streaming kernel in interpret mode and against the plain version, the
widths it takes, and the zero-padding of F and H. The kernel itself is held
against the plain version by the `cuda` tests at the end, which run only
where there is a card (and by chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clair_tpu.ops.pallas_bilstm_stream as PS
from clair_tpu_torch.models.bilstm import _stack_directions, _unstack_outputs
from clair_tpu_torch.ops.bilstm_stream import (
    _stack_params, _unstacked, bilstm_stream, bilstm_stream_reference, check_f32_width,
    f32_geometries, f32_widths, forward_geometry, pad_f32, unpad,
)
from clair_tpu_torch.ops.bilstm_train import bilstm_train_reference
from clair_tpu_torch.ops.lstm_sweep import sweep_geometries
from clair_tpu_torch.params import ModelConfig

GEOMETRIES = [
    (8, 33, 32, 128),      # lstm1 geometry
    (8, 33, 256, 128),     # lstm2 geometry
    (13, 33, 32, 128),     # a ragged batch: no multiple of the sweep's 8- and 16-row tiles
    (6, 7, 12, 20),        # F and H no multiples of 8: padded to 16 and 24
]
# float32: the family of tests/test_pallas_bilstm_stream.py (sum order
# differs between XLA and torch over 33 steps; the three-piece products are
# float32-level, |v - pieces| <= 2**-24 |v|)
F32_TOL = 2e-5
# on the card, as tests/test_torch_bilstm_stream.py and chip_smoke.py hold
# the float32 forward
CUDA_F32_TOL = 1e-4
SMEM_LIMIT = 227 * 1024


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


def _inputs(geometry, seed):
    b, t, f, h = geometry
    rs = np.random.RandomState(seed)
    return _numpy_params(rs, f, h), rs.randn(b, t, f).astype(np.float32)


def emulated_f32(params, x):
    """The float32 mode's arithmetic on the CPU: the operands padded as the
    wrapper pads them, x.W + b and every step's h.U as the split-bf16
    product with three pieces an operand (the resident training forward's
    emulation: rows 1 and 5 run the same product and sweep), the cell in
    float32 with h not rounded, and the outputs cut back to H."""
    w, u, b = _stack_params(params, torch.float32)
    xp, wp, up, bp = pad_f32(x, w, u, b)
    h, c = bilstm_train_reference(_stack_directions(xp).contiguous(), wp, up, bp,
                                  emulate_kernel=True)
    batch, hidden = x.shape[0], u.shape[1]
    return (unpad(_unstack_outputs(h, batch), hidden), unpad(_unstack_outputs(c, batch), hidden))


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_emulated_f32_matches_pallas_kernel_and_plain(geometry, interpret_mode):
    """h and c of the emulated float32 mode against the TPU kernel's forward
    (interpret mode; its c re-laid out as (B, T, 2H)) and against the plain
    version, within F32_TOL."""
    params, x = _inputs(geometry, seed=11)
    b = x.shape[0]
    want_h = np.asarray(PS.bilstm_train_stream(params, jnp.asarray(x)))
    _, (_, _, _, c_out, _) = PS._bilstm_fwd(params, jnp.asarray(x))
    c_out = np.asarray(c_out)                   # (T, 2Bp, H), stacked directions
    bp = c_out.shape[1] // 2
    want_c = np.concatenate([c_out[:, :b].transpose(1, 0, 2),
                             c_out[:, bp:bp + b].transpose(1, 0, 2)[:, ::-1]], axis=-1)
    tp, xt = _torch_params(params), torch.from_numpy(x)
    got_h, got_c = emulated_f32(tp, xt)
    assert got_h.shape == got_c.shape == geometry[:2] + (2 * geometry[3],)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=F32_TOL, atol=F32_TOL)
    plain_h, plain_c = bilstm_stream_reference(tp, xt)
    np.testing.assert_allclose(got_h.numpy(), plain_h.numpy(), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_c.numpy(), plain_c.numpy(), rtol=F32_TOL, atol=F32_TOL)


def _fma_fits(feat, hidden):
    """Whether the float32 FMA kernel that the sweep replaced fitted (F, H):
    some cluster of 1-8 CTAs and 16-64 rows a tile whose CTA held this
    carve-up (float32 W and U of its units, bias, an x tile, two h tiles and
    a c tile) within shared memory, with at most 16 warp items. The card
    also needed two clusters resident, so this is the widest it could take."""
    if not 1 <= hidden <= 1024:
        return False
    fk = -(-feat // 16) * 16
    for cluster in (1, 2, 4, 8):
        uc = -(-(-(-hidden // cluster)) // 8) * 8
        hk = -(-(cluster * uc) // 16) * 16
        for rows in (16, 32, 48, 64):
            smem = ((fk + hk) * uc * 16 + 4 * uc * 4 + rows * (fk + 4) * 4
                    + 2 * rows * (hk + 4) * 4 + rows * (uc + 4) * 4)
            if smem <= SMEM_LIMIT and uc // 8 * (rows // 16) <= 16:
                return True
    return False


@pytest.mark.parametrize("feat", [1, 12, 32, 100, 256, 1000])
def test_f32_width_rule(feat):
    """The float32 mode takes the sweep's geometries at the padded H: every
    width the float32 FMA kernel fitted maps to one, a width with none
    raises ValueError, and the B*T rows are bounded by the product's grid."""
    for hidden in range(1, 300):
        geometries = f32_geometries(feat, hidden)
        padded = f32_widths(feat, hidden)
        assert padded[0] % 8 == padded[1] % 8 == 0 and padded[0] - feat < 8
        assert geometries == sweep_geometries(padded[1])
        if _fma_fits(feat, hidden):
            assert geometries, (feat, hidden)
        if geometries:
            check_f32_width(512 * 33, feat, hidden)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                check_f32_width(512 * 33, feat, hidden)
    assert f32_geometries(feat, 256) and not f32_geometries(feat, 257)
    with pytest.raises(ValueError, match="grid"):
        check_f32_width(128 * 65536, feat, 128)


def test_f32_widths_of_the_model_take_the_sweep():
    """ModelConfig's layers, (F, H) = (32, 128) and (256, 128), run unpadded
    at every geometry of the sweep's float32 U."""
    config = ModelConfig()
    layers = ((int(np.prod(config.input_shape[1:])), config.lstm1_num_units),
              (2 * config.lstm1_num_units, config.lstm2_num_units))
    assert layers == ((32, 128), (256, 128))
    for feat, hidden in layers:
        assert f32_widths(feat, hidden) == (feat, hidden)
        assert f32_geometries(feat, hidden) == sweep_geometries(hidden) != []


@pytest.mark.parametrize("geometry", [(5, 9, 12, 20), (4, 6, 3, 13), (7, 5, 16, 8)])
def test_zero_padding_is_exact_on_plain(geometry):
    """The plain version on the padded operands: the padded units' h and c
    are exactly 0, and the real units', cut back, are the unpadded run's."""
    params, x = _inputs(geometry, seed=12)
    w, u, b = _stack_params(_torch_params(params), torch.float32)
    xt = torch.from_numpy(x)
    xp, wp, up, bp = pad_f32(xt, w, u, b)
    batch, t_len, feat, hidden = geometry
    fp, hp = f32_widths(feat, hidden)
    assert xp.shape == (batch, t_len, fp) and up.shape == (2, hp, 4 * hp)
    if (fp, hp) == (feat, hidden):
        assert xp is xt and wp is w and up is u and bp is b
    h_p, c_p = bilstm_stream_reference(_unstacked(wp, up, bp), xp)
    assert h_p.shape == (batch, t_len, 2 * hp)
    for out in (h_p, c_p):
        assert not out.reshape(batch, t_len, 2, hp)[..., hidden:].any()
    want_h, want_c = bilstm_stream_reference(_unstacked(w, u, b), xt)
    torch.testing.assert_close(unpad(h_p, hidden), want_h, rtol=0, atol=0)
    torch.testing.assert_close(unpad(c_p, hidden), want_c, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_cuda_f32_mode_matches_plain_and_emulation(geometry):
    """On the card: the float32 mode through the wrapper (one launch
    counted) against the plain version and the CPU emulation, h and c
    within CUDA_F32_TOL; a width no sweep geometry fits raises ValueError
    before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    params, x = _inputs(geometry, seed=13)
    tp = {d: {k: v.cuda() for k, v in p.items()} for d, p in _torch_params(params).items()}
    xd = torch.from_numpy(x).cuda()
    before = bilstm_stream.launches
    h, c = bilstm_stream(tp, xd, with_cell=True)
    assert bilstm_stream.launches == before + 1
    want_h, want_c = bilstm_stream_reference(tp, xd)
    emu_h, emu_c = emulated_f32(_torch_params(params), torch.from_numpy(x))
    torch.cuda.synchronize()
    assert h.shape == want_h.shape and h.dtype == torch.float32
    for got, want in ((h, want_h), (c, want_c), (h, emu_h.cuda()), (c, emu_c.cuda())):
        assert (got - want).abs().max().item() <= CUDA_F32_TOL
    wide = _torch_params(_numpy_params(np.random.RandomState(14), 8, 264))
    wide = {d: {k: v.cuda() for k, v in p.items()} for d, p in wide.items()}
    with pytest.raises(ValueError, match="shared memory"):
        bilstm_stream(wide, torch.zeros((2, 3, 8), device="cuda"))
    assert bilstm_stream.launches == before + 1


@pytest.mark.cuda
def test_cuda_f32_mode_at_every_sweep_geometry_of_a_padded_width():
    """On the card: the float32 mode at every sweep geometry of a width it
    pads (F = 12, H = 20 -> 16, 24), ragged rows, against the plain
    version; the launcher's own choice is one of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    import ctypes

    torch.backends.cuda.matmul.allow_tf32 = False
    params, x = _inputs((37, 9, 12, 20), seed=15)
    tp = {d: {k: v.cuda() for k, v in p.items()} for d, p in _torch_params(params).items()}
    xd = torch.from_numpy(x).cuda()
    want_h, want_c = bilstm_stream_reference(tp, xd)
    stacked = _stack_params(tp, torch.float32)
    launched = []
    for cluster, rows in f32_geometries(12, 20):
        got = forward_geometry(xd, *stacked, cluster, rows)
        if got is None:
            continue
        torch.cuda.synchronize()
        launched.append((cluster, rows))
        assert (got[0] - want_h).abs().max().item() <= CUDA_F32_TOL, (cluster, rows)
        assert (got[1] - want_c).abs().max().item() <= CUDA_F32_TOL, (cluster, rows)
    chosen = (ctypes.c_int * 4)()
    assert forward_geometry(xd, *stacked, 0, 0, chosen) is not None
    assert (chosen[0], chosen[1]) in launched
