"""The hunt for the float32 recipe's rare non-finite loss
(tools/torch_recipe_nan.py), on the CPU at small sizes: the recipe's bin is
a function of numpy's global seed; train_model under poisoned memory
(chip_smoke.poisoned) gives finite losses, the same bits in two runs; the
tool's watch names the step, the kind and the tensor of an injected NaN,
forward and backward; SELU's gradient is NaN above 88.72 in the JAX package
and finite in the port;
and the product's emulation (ops/bilstm_stream.py:split_bf16_product) sums
the (0, 0) piece pair apart from the smaller pairs, as
csrc/mma_product.cuh does, within float32 of float64."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import clair_tpu_torch.models.clair as clair
from clair_tpu_torch.data.bins import BinDataset, _pack
from clair_tpu_torch.examples import train_synthetic
from clair_tpu_torch.models.bilstm import _stack_directions
from clair_tpu_torch.ops.bilstm_stream import bf16_pieces, split_bf16_product
from clair_tpu_torch.ops.bilstm_train import _stack_params, bilstm_train_reference
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline.train import TrainingConfig, train_model
from clair_tpu_torch.utils.simulate import PLATFORM_RECIPES

ROOT = Path(__file__).resolve().parent.parent
NARROW = ModelConfig(lstm1_num_units=8, lstm2_num_units=8, l3_num_units=4, l4_num_units=16,
                     l5_num_units=8)


def _tool():
    spec = importlib.util.spec_from_file_location("torch_recipe_nan",
                                                  ROOT / "tools" / "torch_recipe_nan.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dataset(n, block=8, seed=0):
    """A small learnable bin (the genotype shows in x's SNP channel)."""
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 40, (n, 33, 8, 4)).astype(np.int16)
    hom = np.arange(n) % 2 == 1
    x[hom, :, :, 3] += 20
    y = np.zeros((n, 90), np.float32)
    y[~hom, 0] = y[hom, 6] = 1.0
    y[~hom, 21] = y[hom, 22] = 1.0
    y[np.arange(n), 24 + rs.randint(0, 33, n)] = 1.0
    y[np.arange(n), 57 + rs.randint(0, 33, n)] = 1.0
    offs = range(0, n, block)
    return BinDataset(n, [_pack(x[o:o + block]) for o in offs],
                      [_pack(y[o:o + block]) for o in offs],
                      [_pack(np.array([f"chr1:{o + j}" for j in range(block)])) for o in offs],
                      block)


def _config(epochs=2):
    return TrainingConfig(model=NARROW, train_compute_dtype="float32", learning_rate=1e-2,
                          train_batch_size=16, val_batch_size=8, schedule="fixed",
                          max_epochs=epochs, evaluate_at_end=False, restore_best=False,
                          device="cpu", seed=3)


def test_recipe_bin_is_a_function_of_the_global_seed(tmp_path):
    """The recipe's data chain at 4 kb twice with numpy's global generator
    seeded alike: the same bin, block for block; another global seed gives
    the same rows in another order (the bin's shuffle is the only draw the
    recipe does not seed)."""
    args = (11, 4_000, 16)
    bins = []
    for run, seed in enumerate((5, 5, 6)):
        work = tmp_path / str(run)
        work.mkdir()
        np.random.seed(seed)
        bins.append(train_synthetic.build_dataset(str(work), *args,
                                                  **PLATFORM_RECIPES["ont"])[0])
    first, again, other = bins
    assert first.dataset_size == again.dataset_size == other.dataset_size > 0
    assert first.x_blocks == again.x_blocks and first.y_blocks == again.y_blocks
    assert first.pos_blocks == again.pos_blocks

    def positions(ds):
        return np.concatenate([ds.pos_block(i) for i in range(ds.n_blocks)])

    assert sorted(positions(first)) == sorted(positions(other))
    assert list(positions(first)) != list(positions(other))


def test_poisoned_train_model_repeats_bit_for_bit():
    """train_model of a narrow float32 model on the CPU, two epochs, under
    poisoned memory and the watch: every step's loss finite, and the same
    bits in a second run (each step's loss and each epoch's sums)."""
    tool = _tool()
    runs = []
    for _ in range(2):
        watch = tool.Watch()
        with chip_smoke.poisoned(), watch.install():
            assert torch.empty(2).isnan().all()
            result = train_model(_dataset(n=32), _config())
        assert not torch.are_deterministic_algorithms_enabled()
        runs.append((watch, result))
    (first, result), (again, result2) = runs
    assert first.first is None and len(first.steps) == 2 * (2 + 1)
    assert all(np.isfinite(float.fromhex(loss)) for _, _, loss in first.steps)
    assert tool.first_difference(first.steps, again.steps) is None
    assert result.training_losses == result2.training_losses
    assert result.validation_losses == result2.validation_losses


class _NanGradient(torch.autograd.Function):
    """The identity forward; a NaN gradient backward."""

    @staticmethod
    def forward(ctx, h):
        return h.clone()

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


@pytest.mark.parametrize("where, kind, tensor", [
    ("forward", "activation", "lstm2"),
    ("backward", "activation gradient", "lstm1"),
])
def test_watch_names_the_first_nonfinite_tensor(monkeypatch, where, kind, tensor):
    """A hook on the model's BiLSTM makes lstm2's output NaN (forward), or
    the gradient it passes back (backward), in the third train step
    (epoch 2): the watch stops the run there and names the step, the kind
    and the tensor."""
    tool = _tool()
    select = clair.select_bilstm
    train_calls = []

    def injecting(config, scan=False):
        bilstm = select(config, scan)

        def layer(params, x):
            h = bilstm(params, x)
            if torch.is_grad_enabled():
                train_calls.append(1)
                if len(train_calls) == 2 * 2 + 2:  # lstm2 of the third train step
                    if where == "forward":
                        return h + float("nan")
                    return _NanGradient.apply(h)
            return h

        return layer

    monkeypatch.setattr(clair, "select_bilstm", injecting)
    watch = tool.Watch()
    with pytest.raises(tool.NonFinite), watch.install():
        train_model(_dataset(n=32), _config(epochs=3))
    # epoch 1: train steps 0, 1 and validation step 2; epoch 2 starts at 3
    assert watch.first["step"] == 3 and watch.first["epoch"] == 2
    assert (watch.first["phase"], watch.first["kind"], watch.first["tensor"]) == (
        "train", kind, tensor)
    assert len(watch.steps) == 4


def test_split_product_sums_the_high_pair_apart():
    """split_bf16_product with three pieces: the (0, 0) pair's product plus
    the five smaller pairs' sum (in the order the kernels issue them: (0, 1),
    (0, 2), (1, 0), (1, 1), (2, 0)), bit for bit; within 2^-21 of each
    element's sum of |products| of float64."""
    rs = np.random.RandomState(19)
    a = torch.tensor(rs.randn(48, 256), dtype=torch.float32)
    b = torch.tensor(rs.randn(256, 64), dtype=torch.float32)
    pa, pb = bf16_pieces(a, 3), bf16_pieces(b, 3)
    low = None
    for i, j in ((0, 1), (0, 2), (1, 0), (1, 1), (2, 0)):
        term = pa[i] @ pb[j]
        low = term if low is None else low + term
    got = split_bf16_product("mk,kn->mn", a, b, 3)
    assert torch.equal(got, pa[0] @ pb[0] + low)
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    assert ((got.double() - exact).abs() <= 2.0 ** -21 * scale).all()


def test_emulated_forward_within_tolerance_of_plain():
    """The float32 forward as the kernels compute it (x.W and h.U as
    three-piece products in that order) against the plain version: h and c
    within chip_smoke.F32_TOL at the recipe's widths, a narrow batch."""
    rs = np.random.RandomState(20)
    for feat in (32, 256):
        params = chip_smoke.lstm_params(rs, feat, 128, "cpu")
        x = torch.tensor(rs.randn(3, 33, feat), dtype=torch.float32)
        xs = _stack_directions(x).contiguous()
        w, u, b = _stack_params(params)
        want = bilstm_train_reference(xs, w, u, b)
        got = bilstm_train_reference(xs, w, u, b, emulate_kernel=True)
        for g, r in zip(got, want):
            assert (g - r).abs().max().item() <= chip_smoke.F32_TOL


def test_watch_leaves_no_patch_behind():
    """The watch's patches of train_model's step factories end with it."""
    import clair_tpu_torch.pipeline.train as train

    tool = _tool()
    before = (train.make_train_step, train.make_eval_step)
    with tool.Watch().install():
        assert (train.make_train_step, train.make_eval_step) != before
    assert (train.make_train_step, train.make_eval_step) == before


def test_selu_gradient_is_nan_above_float32_exp_overflow_in_both_packages():
    """The JAX package's SELU gradient is NaN for an input above
    log(FLT_MAX) = 88.72 (expm1's derivative overflows in the branch
    jnp.where did not take, and 0 * inf is NaN), and finite just below it;
    the port's takes expm1 of min(x, 0), so its gradient is finite above
    the threshold too (the linear branch's scale) and the JAX package's
    below it."""
    import jax
    import jax.numpy as jnp

    from clair_tpu.models.layers import selu as jax_selu
    from clair_tpu_torch.models.layers import SELU_SCALE, selu

    threshold = _tool().SELU_NAN_ABOVE
    values = np.array([-1.0, threshold - 0.01, threshold + 0.01, 100.0], np.float32)
    x = torch.tensor(values, requires_grad=True)
    selu(x).sum().backward()
    want = np.asarray(jax.grad(lambda v: jax_selu(v).sum())(jnp.asarray(values)))
    got = x.grad.numpy()
    assert np.isfinite(want[:2]).all() and np.isnan(want[2:]).all()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-6)
    np.testing.assert_array_equal(got[2:], np.float32(SELU_SCALE))
