"""The BiLSTM kernel flags through the whole port, on the CPU: a narrow
ClairNet against the JAX ``forward_logits`` under ``use_pallas_train_bilstm``
and ``use_pallas_bilstm`` (float32, and the latter in bfloat16, where the
JAX kernel's float32 output makes every head float32), the narrow net's
gradients under ``use_pallas_train_bilstm`` against ``jax.grad``, the
choice order and the bf16 refusal, ``train_model`` and its
``use_stream_bilstm`` switch, and the ``Predictor`` under each flag against
the JAX ``Predictor``.

The JAX forward engages these kernels only on a TPU backend
(clair_tpu/models/clair.py:118,132), so the JAX side runs with
``jax.default_backend`` patched to report "tpu" and both Pallas kernels in
interpret mode; the JAX package is not edited."""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import clair_tpu.ops.pallas_bilstm_train as PT
from clair_tpu.models.clair import forward_logits as jax_forward_logits
from clair_tpu.models.clair import init_params as jax_init_params
from clair_tpu.params import ModelConfig
from clair_tpu.pipeline.call_var import Predictor as JaxPredictor
from clair_tpu_torch.data import bins
from clair_tpu_torch.models import clair as port_clair
from clair_tpu_torch.models.clair import ClairNet, select_bilstm
from clair_tpu_torch.ops.bilstm import bilstm_precomputed
from clair_tpu_torch.ops.bilstm_stream import bilstm_stream
from clair_tpu_torch.ops.bilstm_train import bilstm_train
from clair_tpu_torch.pipeline.call_var import Predictor
from clair_tpu_torch.pipeline.train import TrainingConfig, _check_supported, train_model
from test_torch_bilstm_precomputed import interpret_pallas
from test_torch_train import _batch, _bin, _leaves, _numpy

NARROW = ModelConfig(lstm1_num_units=8, lstm2_num_units=8, l3_num_units=4,
                     l4_num_units=16, l5_num_units=8)
# 11 positions: the JAX compiles of the Predictor and of jax.grad stay short
SHORT = dataclasses.replace(NARROW, input_shape=(11, 8, 4))
FLAG_CONFIGS = {
    "train_f32": dataclasses.replace(NARROW, use_pallas_train_bilstm=True),
    "pallas_f32": dataclasses.replace(NARROW, use_pallas_bilstm=True),
    "pallas_bf16": dataclasses.replace(NARROW, use_pallas_bilstm=True,
                                       compute_dtype="bfloat16"),
}
# float32 head outputs: XLA and torch sum in another order
F32_TOL = 2e-5
# bf16: lstm1's projection xw is rounded to bf16 in both packages (2.4e-7
# apart at most on these inputs), but its sums run in another order, so an
# entry may land one bf16 step (2**-8 relative) apart; everything after is
# float32 on the same bf16 weights, which damps such a step below 2e-3 at
# the heads
BF16_TOL = 2e-3


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX forward on its Pallas BiLSTM kernels, in interpret mode."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(PT, "_INTERPRET", True)
    interpret_pallas(monkeypatch)


def _pileup(rs, n, positions=33):
    return _batch(rs, n, positions)[0]


@pytest.mark.parametrize("name", sorted(FLAG_CONFIGS))
def test_narrow_net_matches_jax_forward_logits(name, jax_kernels):
    config = FLAG_CONFIGS[name]
    rs = np.random.RandomState(0)
    params = _numpy(jax_init_params(jax.random.PRNGKey(0), config))
    x = _pileup(rs, 12)
    want = [np.asarray(h) for h in jax.jit(lambda p, xx: jax_forward_logits(p, xx, config))(
        params, x)]
    model = ClairNet.from_jax(params, config)
    with torch.inference_mode():
        got = model.forward_logits(torch.from_numpy(x))
    tol = BF16_TOL if config.compute_dtype == "bfloat16" else F32_TOL
    for w, g in zip(want, got):
        # use_pallas_bilstm's float32 output makes every head float32
        assert w.dtype == np.float32 and g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)


def test_narrow_net_gradients_match_jax_grad_under_the_train_kernel(jax_kernels):
    """Every parameter's gradient of a weighted sum of the four heads,
    within 3e-4 (tests/test_pallas_bilstm_train.py's gradient bound)."""
    config = dataclasses.replace(SHORT, use_pallas_train_bilstm=True)
    rs = np.random.RandomState(1)
    params = _numpy(jax_init_params(jax.random.PRNGKey(1), config))
    x = _pileup(rs, 8, positions=11)
    weights = [rs.randn(8, n).astype(np.float32) for n in (21, 3, 33, 33)]

    def jax_loss(p):
        heads = jax_forward_logits(p, x, config)
        return sum((h * w).sum() for h, w in zip(heads, weights))

    want = dict(_leaves(jax.jit(jax.grad(jax_loss))(params)))
    model = ClairNet.from_jax(params, config)
    heads = model.forward_logits(torch.from_numpy(x))
    sum((h * torch.from_numpy(w)).sum() for h, w in zip(heads, weights)).backward()
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=3e-4, atol=3e-4, err_msg=k)


def test_select_bilstm_follows_the_jax_order():
    f32 = dataclasses.replace(NARROW, compute_dtype="float32")
    every = dataclasses.replace(f32, use_pallas_bilstm=True, use_pallas_stream_bilstm=True,
                                use_pallas_train_bilstm=True)
    assert select_bilstm(f32) is bilstm_stream                 # the port's default
    assert select_bilstm(every) is bilstm_precomputed
    assert select_bilstm(dataclasses.replace(every, use_pallas_bilstm=False)) is bilstm_stream
    train = dataclasses.replace(f32, use_pallas_train_bilstm=True)
    assert select_bilstm(train) is bilstm_train
    assert select_bilstm(FLAG_CONFIGS["pallas_bf16"]) is bilstm_precomputed
    # the train kernel is float32 only, refused as the JAX forward refuses it
    bf16_train = dataclasses.replace(train, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="float32-only"):
        ClairNet(bf16_train)
    # ... unless a kernel earlier in the order is selected
    assert select_bilstm(dataclasses.replace(bf16_train, use_pallas_stream_bilstm=True)) \
        is bilstm_stream


def test_use_stream_bilstm_false_runs_the_model_flags_kernel():
    """False alone means the lax.scan, kept off the card: refused for a
    CUDA device. With a kernel flag set, that kernel runs, as in the JAX
    loop: the check passes it (and then asks for a card, where there is
    none)."""
    cuda = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="lax.scan"):
        _check_supported(TrainingConfig(use_stream_bilstm=False, device="cuda"), cuda)
    for flag in ("use_pallas_train_bilstm", "use_pallas_bilstm", "use_pallas_stream_bilstm"):
        config = TrainingConfig(model=ModelConfig(**{flag: True}), use_stream_bilstm=False,
                                device="cuda")
        if torch.cuda.is_available():
            _check_supported(config, cuda)
        else:
            with pytest.raises(RuntimeError, match="is_available"):
                _check_supported(config, cuda)


@pytest.mark.parametrize("use_stream,kernel", [
    (None, "bilstm_train"), (False, "bilstm_train"), (True, "bilstm_stream"),
])
def test_train_model_epoch_under_the_train_kernel(use_stream, kernel, tmp_path, monkeypatch):
    """One train_model epoch under use_pallas_train_bilstm, float32, on the
    CPU: finite losses; the model's layer is the train kernel's unless
    use_stream_bilstm=True picks the streaming pair, as in JAX."""
    calls = {"bilstm_train": 0, "bilstm_stream": 0}

    def counting(fn):
        def wrapped(params, x):
            calls[fn.__name__] += 1
            return fn(params, x)
        return wrapped

    for fn in (bilstm_train, bilstm_stream):
        monkeypatch.setattr(port_clair, fn.__name__, counting(fn))
    path = _bin(tmp_path, n=40, positions=11)
    result = train_model(bins.load_bin(path), TrainingConfig(
        model=dataclasses.replace(SHORT, use_pallas_train_bilstm=True),
        train_compute_dtype="float32", use_stream_bilstm=use_stream, train_batch_size=12,
        val_batch_size=4, schedule="fixed", max_epochs=1, decompress_workers=0, device="cpu"))
    losses = [v for v, _ in result.training_losses + result.validation_losses]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert calls[kernel] > 0 and sum(calls.values()) == calls[kernel]


@pytest.mark.parametrize("name", sorted(FLAG_CONFIGS))
def test_predictor_under_each_flag_matches_jax(name, jax_kernels):
    """The port's Predictor (CPU) and the JAX Predictor (kernels in
    interpret mode) on the same uint8 batch, short of the batch size: the
    same heads; the port's model runs the flag's kernel layer."""
    config = dataclasses.replace(FLAG_CONFIGS[name], input_shape=SHORT.input_shape)
    params = _numpy(jax_init_params(jax.random.PRNGKey(2), config))
    x = np.random.RandomState(3).randint(0, 40, (10, 11, 8, 4)).astype(np.uint8)
    jax_pred = JaxPredictor(params, config, batch_size=16)
    port = Predictor(params, config, batch_size=16, device="cpu")
    assert port.model.bilstm is select_bilstm(config)
    assert port.model.bilstm in (bilstm_train, bilstm_precomputed)
    want = jax_pred.gather(*jax_pred.predict_async(x))
    got = port.gather(*port.predict_async(x))
    tol = BF16_TOL if config.compute_dtype == "bfloat16" else F32_TOL
    for w, g in zip(want, got):
        assert g.shape == w.shape == (10, w.shape[1])
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
