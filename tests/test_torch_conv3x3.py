"""The stride-1 3x3 convolution of Clair3_F's BasicBlocks (ops/conv3x3.py):
its plain versions (three bf16 pieces, six float32 products, two
accumulators) against float64 on the CPU, at each stage's channel count on
small odd maps under SAME padding; the autograd Function against
``torch.autograd.grad`` of ``F.conv2d`` in float64; the ``fa.conv`` counter
of Clair3_F's forward. On the card (marked ``cuda``, skipped without one):
the kernels against float64 at the three stage shapes, where three piece
pairs miss, two launches bit for bit, one ``train_step`` of Clair3_F
launching each kernel six times, a backward that wants no dx counting no
dgrad, and the wrapper's refusals."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clair_tpu_torch.models import clair3_fa
from clair_tpu_torch.models.clair3_fa import Clair3FANet, FullAlignmentConfig
from clair_tpu_torch.ops import launch_counts, launches_since
from clair_tpu_torch.reference import clair3_fa as ref
from clair_tpu_torch.ops.conv3x3 import (
    PIECE_PAIRS, conv3x3, conv3x3_dgrad, conv3x3_dgrad_reference, conv3x3_reference,
    conv3x3_wgrad, conv3x3_wgrad_reference, split_pieces, wgrad_slabs,
)
from clair_tpu_torch.utils import trace

STAGE_CHANNELS = (64, 128, 256)
MAPS = ((9, 5), (5, 3))
# Clair3_F's blocks at batch 2,000: (channels, height, width)
STAGE_SHAPES = ((64, 45, 17), (128, 23, 9), (256, 12, 5))
# The six pairs leave out terms below 2^-24 of each product, so the gap
# from float64 is the float32 sums' round-off: at most 1.8e-7 of the
# largest element over these cases. Three pairs ((0, 0), (0, 1), (1, 0)),
# a lower precision than float32, drop the pairs (1, 1), (0, 2) and (2, 0)
# of about 2^-16 and 2^-18 of each product and read 2.8e-6 to 7.7e-6 (the
# bias's gradient adds whole pieces, so there it makes no difference). The
# limit lies between, with room of 2.7 below and 5.7 above.
F32_LEVEL = 5e-7
# the planted control: the pairs of three products
THREE_PAIRS = tuple((i, j) for i, j in PIECE_PAIRS if i + j < 2)
PRODUCTS = ("forward", "dgrad", "wgrad")


def _inputs(channels, height, width, seed, batch=2):
    rs = np.random.RandomState(seed)
    x = torch.tensor(rs.randn(batch, channels, height, width), dtype=torch.float32)
    w = torch.tensor(rs.randn(3, 3, channels, channels) / np.sqrt(9 * channels),
                     dtype=torch.float32)
    b = torch.tensor(rs.randn(channels), dtype=torch.float32)
    go = torch.tensor(rs.randn(batch, channels, height, width), dtype=torch.float32)
    return x, w, b, go


def _oihw(w):
    return w.permute(3, 2, 0, 1)


def _want64(product, x, w, b, go):
    """One product in float64 by F.conv2d and its gradients."""
    x64, w64, b64, go64 = (t.double() for t in (x, w, b, go))
    if product == "forward":
        return F.conv2d(x64, _oihw(w64), b64, padding=1)
    if product == "dgrad":
        return torch.nn.grad.conv2d_input(x.shape, _oihw(w64), go64, padding=1)
    if product == "wgrad":
        return torch.nn.grad.conv2d_weight(x64, _oihw(w64).shape, go64,
                                           padding=1).permute(2, 3, 1, 0)
    return go64.sum(dim=(0, 2, 3))


def _plain(product, x, w, b, go, pairs=PIECE_PAIRS):
    """One product by the plain versions, running ``pairs``."""
    if product == "forward":
        return conv3x3_reference(x, w, b, pairs)
    if product == "dgrad":
        return conv3x3_dgrad_reference(go, w, pairs)
    return conv3x3_wgrad_reference(x, go, pairs)[product == "bias_grad"]


def _float64(product, x, w, b, go):
    """(want, got) of one product: float64 F.conv2d's and the plain
    version's."""
    return _want64(product, x, w, b, go), _plain(product, x, w, b, go)


def _gap(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("hw", MAPS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("channels", STAGE_CHANNELS)
@pytest.mark.parametrize("product", ["forward", "dgrad", "wgrad", "bias_grad"])
def test_plain_pieces_match_float64(product, channels, hw):
    """Each plain product against float64 F.conv2d (and its gradients) within
    F32_LEVEL of the largest element (its reason above)."""
    x, w, b, go = _inputs(channels, *hw, seed=channels + hw[0])
    want, got = _float64(product, x, w, b, go)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _gap(got, want) <= F32_LEVEL


@pytest.mark.parametrize("hw", MAPS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("channels", STAGE_CHANNELS)
@pytest.mark.parametrize("product", PRODUCTS)
def test_three_products_miss_the_float32_level(product, channels, hw):
    """The tolerance ties the products to six pairs: the plain versions
    with three ((0, 0), (0, 1), (1, 0)) miss float64 by more than
    F32_LEVEL, on the same inputs the six pairs meet it."""
    x, w, b, go = _inputs(channels, *hw, seed=channels + hw[0])
    want = _want64(product, x, w, b, go)
    assert _gap(_plain(product, x, w, b, go, THREE_PAIRS), want) > F32_LEVEL


@pytest.mark.parametrize("channels", STAGE_CHANNELS)
def test_one_bf16_pass_misses_the_float32_level(channels):
    """The tolerance has teeth: the forward from p0 alone (one bf16 pass)
    misses float64 by more than ten times F32_LEVEL."""
    x, w, b, _ = _inputs(channels, 9, 5, seed=1)
    want = F.conv2d(x.double(), _oihw(w).double(), b.double(), padding=1)
    one = F.conv2d(split_pieces(x)[0], _oihw(split_pieces(w)[0]), b, padding=1)
    assert _gap(one, want) > 10 * F32_LEVEL


@pytest.mark.parametrize("channels", STAGE_CHANNELS + (8,))
def test_function_matches_autograd_in_float64(channels):
    """conv3x3 through its autograd Function on the CPU (the plain versions)
    against torch.autograd.grad of F.conv2d in float64: the output, dx, dw and
    db within F32_LEVEL of each one's largest element."""
    x, w, b, go = _inputs(channels, 5, 3, seed=7 + channels, batch=3)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    out = conv3x3(*leaves)
    got = (out, *torch.autograd.grad(out, leaves, go))
    leaves64 = [t.double().requires_grad_() for t in (x, w, b)]
    out64 = F.conv2d(leaves64[0], _oihw(leaves64[1]), leaves64[2], padding=1)
    want = (out64, *torch.autograd.grad(out64, leaves64, go.double()))
    for name, g, wv in zip(("out", "dx", "dw", "db"), got, want):
        assert g.shape == wv.shape, name
        assert _gap(g, wv) <= F32_LEVEL, name


def test_function_skips_what_no_input_wants():
    """A gradient for w and b alone leaves dx out, and the forward of an
    input that wants none builds no graph."""
    x, w, b, go = _inputs(64, 5, 3, seed=3)
    wl, bl = w.clone().requires_grad_(), b.clone().requires_grad_()
    out = conv3x3(x, wl, bl)
    dw, db = torch.autograd.grad(out, (wl, bl), go)
    want_dw, want_db = conv3x3_wgrad_reference(x, go)
    assert torch.equal(dw, want_dw) and torch.equal(db, want_db)
    assert conv3x3(x, w, b).grad_fn is None


def test_wgrad_slabs_cover_the_cells_in_whole_stages():
    """Every slab but the last holds whole stages of 32 cells, the slabs
    cover the cells, and the stages make about three tiles a multiprocessor."""
    for cells, channels in ((2000 * 765, 64), (2000 * 207, 128), (2000 * 60, 256), (45, 64)):
        slabs, rows = wgrad_slabs(cells, channels, channels, 132)
        assert rows % 32 == 0 and (slabs - 1) * rows < cells <= slabs * rows
    assert wgrad_slabs(2000 * 765, 64, 64, 132) == (132, 11616)


def test_fa_forward_counts_its_convolutions():
    """Each forward of Clair3_F records ``fa.conv`` once a convolution: 1 for
    the six stride-1 convolutions (ops/conv3x3.py), 0 for the three stride-2
    ones (cuDNN), in the trunk's order."""
    config = FullAlignmentConfig(input_shape=(17, 9, 8), stage_channels=(8, 16, 32),
                                 l4_num_units=32, l5_num_units=16)
    model = Clair3FANet.from_jax(clair3_fa.init_params(torch.Generator().manual_seed(0), config),
                                 config)
    x = torch.randint(-100, 101, (2, 17, 9, 8)).to(torch.int16)
    since = trace._clock()
    model.forward_logits(x)
    counts = [r.value for r in trace.records(since) if r.name == "fa.conv"]
    assert counts == [0, 1, 1] * 3


# ---- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# the kernels against float64 on the card. The tensor cores truncate as
# they add; the kernels fold the pair (0, 0)'s sums every 256 of the
# reduction into a float32 sum that rounds to nearest, and add long
# reductions in stages and slabs. On an H100 they read 2.8e-7 to 5.2e-7 at
# batch 2,000 (chip_smoke.py, phase 9e), against 3.5e-6 and more for three
# piece pairs computed on the card: room of 1.9 above and 3.5 below.
CARD_TOL = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 3])
@pytest.mark.parametrize("shape", STAGE_SHAPES, ids=lambda s: f"C{s[0]}")
def test_cuda_kernels_match_float64(shape, batch):
    """The forward, dgrad and wgrad kernels (and the bias's gradient) against
    float64 F.conv2d on the same card tensors at each stage's shape (an odd
    batch leaves part of the last tile of whole images empty): within
    CARD_TOL of the largest element, where the plain versions with three
    piece pairs miss it."""
    dev = _card()
    x, w, b, go = (t.to(dev) for t in _inputs(*shape, seed=shape[0], batch=batch))
    before = launch_counts()
    got = dict(zip(("forward", "dgrad", "wgrad", "bias_grad"),
                   (conv3x3(x, w, b), conv3x3_dgrad(go, w), *conv3x3_wgrad(x, go))))
    torch.cuda.synchronize()
    for name, g in got.items():
        want = _want64(name, x, w, b, go)
        assert g.shape == want.shape and torch.isfinite(g).all(), name
        assert _gap(g, want) <= CARD_TOL, name
        if name != "bias_grad":
            assert _gap(_plain(name, x, w, b, go, THREE_PAIRS), want) > CARD_TOL, name
    since = launches_since(before)
    assert (since["conv3x3"], since["conv3x3_dgrad"], since["conv3x3_wgrad"]) == (1, 1, 1)


@pytest.mark.cuda
def test_cuda_two_launches_give_the_same_bits():
    """The products' sums run in a fixed order (the weight gradient's slabs
    summed in order, no atomics): two runs of each give identical bits."""
    dev = _card()
    x, w, b, go = (t.to(dev) for t in _inputs(64, 45, 17, seed=5, batch=64))
    first = [conv3x3(x, w, b), conv3x3_dgrad(go, w), *conv3x3_wgrad(x, go)]
    second = [conv3x3(x, w, b), conv3x3_dgrad(go, w), *conv3x3_wgrad(x, go)]
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_train_step_launches_each_kernel_six_times():
    """One train step of the published Clair3_F on the card: each kernel six
    times (the six stride-1 convolutions, forward, dgrad and wgrad), and the
    forward's ``fa.conv`` counter six 1s and three 0s."""
    from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step

    dev = _card()
    config = FullAlignmentConfig()
    model = Clair3FANet.from_jax(clair3_fa.init_params(torch.Generator().manual_seed(0), config),
                                 config, dev)
    step = make_train_step(model, make_optimizer(dict(model.named_parameters()), "Adam", 1e-3))
    g = torch.Generator().manual_seed(1)
    x = torch.randint(-100, 101, (8, *config.input_shape), generator=g).to(torch.int16).to(dev)
    y = torch.zeros(8, 90, device=dev)
    for first, _ in ref.SPANS:
        y[:, first] = 1
    before, since = launch_counts(), trace._clock()
    with clair3_fa.float32_products():
        loss = step(x, y, torch.Generator(device=dev).manual_seed(2), 1e-4)[0]
    assert torch.isfinite(loss).all()
    launched = launches_since(before)
    assert (launched["conv3x3"], launched["conv3x3_dgrad"], launched["conv3x3_wgrad"]) == (6, 6, 6)
    counts = [r.value for r in trace.records(since) if r.name == "fa.conv"]
    assert sorted(counts) == [0, 0, 0, 1, 1, 1, 1, 1, 1]


@pytest.mark.cuda
def test_cuda_backward_without_dx_counts_no_dgrad():
    """A gradient for w and b alone runs the weight gradient and no input
    gradient, and the counts say so."""
    dev = _card()
    x, w, b, go = (t.to(dev) for t in _inputs(64, 9, 5, seed=4))
    wl, bl = w.clone().requires_grad_(), b.clone().requires_grad_()
    before = launch_counts()
    dw, db = torch.autograd.grad(conv3x3(x, wl, bl), (wl, bl), go)
    since = launches_since(before)
    assert (since["conv3x3"], since["conv3x3_dgrad"], since["conv3x3_wgrad"]) == (1, 0, 1)
    assert torch.equal(dw, conv3x3_wgrad(x, go)[0])


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernels_cannot_take():
    """A non-contiguous, non-float32 or wrong-shape CUDA input raises before
    any launch."""
    dev = _card()
    x, w, b, go = (t.to(dev) for t in _inputs(64, 9, 5, seed=2))
    before = launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3(x.transpose(2, 3).contiguous().transpose(2, 3), w, b)
    with pytest.raises(TypeError):
        conv3x3(x.double(), w, b)
    with pytest.raises(ValueError):
        conv3x3(x[:, :48].contiguous(), w[:, :, :48].contiguous(), b)
    with pytest.raises(ValueError):
        conv3x3(x, w[:2].contiguous(), b)
    with pytest.raises(ValueError):
        conv3x3_dgrad(go.transpose(2, 3), w)
    with pytest.raises(TypeError):
        conv3x3_wgrad(x, go.double())
    assert launches_since(before) == dict.fromkeys(before, 0)
