"""The port's scan BiLSTM (models/bilstm.py:bilstm_scan) against the JAX
package's lax.scan (clair_tpu/models/bilstm.py: ``bilstm``, and
``_bilstm_fused`` above batch 512), on the CPU: forward and gradients in
both step forms and both dtypes; the fused form's recomputed steps against
the same form without recomputation; ``train_model`` under
``use_stream_bilstm=False`` against the JAX ``train_model`` under the same
flag, every forward of the run on the scan; and two data-parallel ranks
under the flag against one process.

Tolerances, from what this box measured (the largest |difference| of an
array over its largest |value|, "of scale"):
- float32: outputs and every gradient within 2e-6 of scale (seen: 3.3e-7;
  XLA and torch sum the products in another order);
- bfloat16: outputs within 2**-6 absolute (seen: 2**-9) and a mean
  |difference| below 2**-11 (seen: 1.4e-4), as both round the products,
  the sums and h to bf16 at the same places but may land a bf16 step
  apart, which later steps carry on; every gradient within 2**-5 of scale
  (seen: 1.2e-2; the two backwards round their bf16 intermediates at other
  places). chip_smoke.py phase 10g holds the scan on the card against the
  CPU to these bounds at full width, where B = 10,000 rows reach 1.5 *
  2**-8 (an H100's run), so the maximum stays at 2**-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clair_tpu.data.bins as jax_bins
from clair_tpu.models.bilstm import _bilstm_fused as jax_bilstm_fused
from clair_tpu.models.bilstm import bilstm as jax_bilstm
from clair_tpu_torch.data import bins
from clair_tpu_torch.models import bilstm as port_bilstm
from clair_tpu_torch.models import clair as port_clair
from clair_tpu_torch.models.bilstm import FUSED_ABOVE, bilstm_scan
from clair_tpu_torch.models.checkpoint import checkpoint_path, save_checkpoint
from clair_tpu_torch.models.clair import init_params
from clair_tpu_torch.pipeline.train import TrainingConfig, train_model, train_on_devices
from test_torch_distributed import CONFIG as DDP_CONFIG
from test_torch_distributed import LOSS_RTOL, SPAWN_TIMEOUT_S, write_bin
from test_torch_train import SHORT, _bin, jax_config

F32_REL = 2e-6
BF16_MAX, BF16_MEAN, BF16_GRAD_REL = 2.0 ** -6, 2.0 ** -11, 2.0 ** -5
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# train_model under the flag against the JAX loop: per-epoch loss sums
LOOP_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# (batch, steps, features, hidden): the hoisted form at 33 steps, and the
# fused form one row above FUSED_ABOVE at narrow widths
FORMS = {"hoisted": (5, 33, 4, 8), "fused": (FUSED_ABOVE + 1, 9, 4, 8)}


def _params(rs, feat, hidden):
    def one():
        return {"w": (rs.randn(feat, 4 * hidden) * 0.3).astype(np.float32),
                "u": (rs.randn(hidden, 4 * hidden) * 0.3).astype(np.float32),
                "b": (rs.randn(4 * hidden) * 0.1).astype(np.float32)}
    return {"fw": one(), "bw": one()}


def _port(params, x, weights, dtype):
    """The scan's output and the gradients of sum(out * weights) for the
    float32 parameters and input, cast to ``dtype`` at use (as ClairNet
    casts them)."""
    leaves = {d: {k: torch.tensor(v, requires_grad=True) for k, v in q.items()}
              for d, q in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    out = bilstm_scan({d: {k: v.to(dtype) for k, v in q.items()} for d, q in leaves.items()},
                      tx.to(dtype))
    (out.float() * torch.from_numpy(weights)).sum().backward()
    grads = {f"{d}.{k}": v.grad.numpy() for d, q in leaves.items() for k, v in q.items()}
    return out.detach().float().numpy(), {"x": tx.grad.numpy(), **grads}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_scan_matches_jax_scan(form, dtype):
    """Forward and jax.grad against autograd; the JAX function the step
    form's own (``bilstm`` up to batch 512, ``_bilstm_fused`` above)."""
    b, t_len, feat, hidden = FORMS[form]
    rs = np.random.RandomState(b + t_len)
    params = _params(rs, feat, hidden)
    x = rs.randn(b, t_len, feat).astype(np.float32)
    weights = rs.randn(b, t_len, 2 * hidden).astype(np.float32)
    torch_dtype, jax_dtype = DTYPES[dtype]
    jax_fn = jax_bilstm if form == "hoisted" else jax_bilstm_fused

    def loss(p, xs):
        out = jax_fn(jax.tree.map(lambda a: a.astype(jax_dtype), p), xs.astype(jax_dtype))
        return (out.astype(jnp.float32) * weights).sum(), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, x)
    want = np.asarray(want.astype(jnp.float32))
    want_grads = {"x": np.asarray(gx), **{f"{d}.{k}": np.asarray(v)
                                          for d, q in gp.items() for k, v in q.items()}}
    got, got_grads = _port(params, x, weights, torch_dtype)

    assert got.shape == want.shape == (b, t_len, 2 * hidden)
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= F32_REL * np.abs(want).max(), diff.max()
    else:
        assert diff.max() <= BF16_MAX and diff.mean() < BF16_MEAN, (diff.max(), diff.mean())
    rel = F32_REL if dtype == "float32" else BF16_GRAD_REL
    assert sorted(got_grads) == sorted(want_grads)
    for name, g in got_grads.items():
        scale = np.abs(want_grads[name]).max()
        assert np.abs(g - want_grads[name]).max() <= rel * scale, name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_form_recomputes_each_step_to_the_same_gradients(dtype, monkeypatch):
    """Above FUSED_ABOVE rows every step runs under torch.utils.checkpoint,
    once a step, and its gradients equal, bit for bit, those of the same
    steps run without it."""
    b, t_len, feat, hidden = FUSED_ABOVE + 3, 6, 4, 8
    rs = np.random.RandomState(3)
    params = _params(rs, feat, hidden)
    x = rs.randn(b, t_len, feat).astype(np.float32)
    weights = rs.randn(b, t_len, 2 * hidden).astype(np.float32)
    torch_dtype = DTYPES[dtype][0]
    calls = []
    checkpoint = port_bilstm.checkpoint

    def counting(fn, *args, **kwargs):
        calls.append(kwargs)
        return checkpoint(fn, *args, **kwargs)

    monkeypatch.setattr(port_bilstm, "checkpoint", counting)
    out, grads = _port(params, x, weights, torch_dtype)
    assert len(calls) == t_len
    assert all(k == {"use_reentrant": False, "preserve_rng_state": False} for k in calls)
    monkeypatch.setattr(port_bilstm, "checkpoint", lambda fn, *args, **kwargs: fn(*args))
    plain_out, plain_grads = _port(params, x, weights, torch_dtype)
    np.testing.assert_array_equal(out, plain_out)
    for name, g in grads.items():
        np.testing.assert_array_equal(g, plain_grads[name], err_msg=name)


def _counting_layers(monkeypatch):
    """Each call of the scan or the streaming layer, by the model's
    selection, with the mode it ran in: "train" (autograd on), "val"
    (no_grad) or "eval" (inference_mode, the evaluation at the end)."""
    calls = []

    def counting(fn):
        def wrapped(params, x):
            mode = ("eval" if torch.is_inference_mode_enabled()
                    else "train" if torch.is_grad_enabled() else "val")
            calls.append((fn.__name__, mode))
            return fn(params, x)
        return wrapped

    for fn in (port_clair.bilstm_scan, port_clair.bilstm_stream):
        monkeypatch.setattr(port_clair, fn.__name__, counting(fn))
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_model_on_the_scan_matches_jax_train_model(dtype, tmp_path, monkeypatch):
    """Two epochs under use_stream_bilstm=False in both packages from one
    init checkpoint, dropout off, 11 positions, the same block order:
    per-epoch loss sums within LOOP_RTOL: 1e-3 in bfloat16
    (test_torch_train.py's tolerance for the train loop; seen: 2.7e-4),
    1e-5 in float32 (seen: 1.1e-7). Every forward of the
    port's run (train and validation steps, the evaluation at the end)
    runs the scan, and the streaming layer never."""
    from clair_tpu.pipeline.train import TrainingConfig as JaxTrainingConfig
    from clair_tpu.pipeline.train import train_model as jax_train_model

    monkeypatch.setenv("CLAIR_TPU_JAX_CACHE", str(tmp_path / "jax_cache"))
    path = _bin(tmp_path, positions=11)
    init = checkpoint_path(str(tmp_path / "init"), 0)
    save_checkpoint(init, init_params(torch.Generator().manual_seed(9), SHORT))
    common = dict(init_checkpoint=init, train_batch_size=18, val_batch_size=6,
                  schedule="fixed", max_epochs=2, train_compute_dtype=dtype,
                  decompress_workers=0, use_stream_bilstm=False)
    want = jax_train_model(jax_bins.load_bin(path), JaxTrainingConfig(
        model=jax_config(SHORT), evaluate_at_end=False, **common))
    calls = _counting_layers(monkeypatch)
    got = train_model(bins.load_bin(path), TrainingConfig(model=SHORT, device="cpu", **common))

    for g, w in ((got.training_losses, want.training_losses),
                 (got.validation_losses, want.validation_losses)):
        assert [e for _, e in g] == [e for _, e in w] == [1, 2]
        np.testing.assert_allclose([v for v, _ in g], [v for v, _ in w], rtol=LOOP_RTOL[dtype])
    assert {name for name, _ in calls} == {"bilstm_scan"}
    assert {mode for _, mode in calls} == {"train", "val", "eval"}


def test_default_train_model_stays_on_the_streaming_layer(tmp_path, monkeypatch):
    """use_stream_bilstm unset (the auto rule), bfloat16: the streaming
    layer (rows 1 and 2 on a card) carries every forward, the scan none."""
    calls = _counting_layers(monkeypatch)
    train_model(bins.load_bin(_bin(tmp_path, n=40, positions=11)), TrainingConfig(
        model=SHORT, train_batch_size=12, val_batch_size=4,
        schedule="fixed", max_epochs=1, decompress_workers=0, device="cpu"))
    assert {name for name, _ in calls} == {"bilstm_stream"}
    assert {mode for _, mode in calls} == {"train", "val", "eval"}


def test_data_parallel_ranks_under_the_flag_match_one_process(tmp_path):
    """Two gloo ranks (train_on_devices, DDP over the data axis) under
    use_stream_bilstm=False, float32, against one process under the same
    flag: the same loss sums within test_torch_distributed.py's LOSS_RTOL.
    A global batch of 1,040 rows gives each rank a stripe of 520, above
    FUSED_ABOVE, so the ranks' backward recomputes the fused steps under
    DDP; the epoch's last batch (40 rows) runs the hoisted form."""
    bin_path = write_bin(str(tmp_path / "train.bin"), n=1200, block=100, positions=11)
    config = dataclasses.replace(DDP_CONFIG, model=SHORT, train_batch_size=2 * (FUSED_ABOVE + 8),
                                 val_batch_size=60, max_epochs=1, use_stream_bilstm=False)
    single = train_model(bins.load_bin(bin_path), config)
    result, launches = train_on_devices(functools.partial(bins.load_bin, bin_path), config, 2,
                                        timeout_s=SPAWN_TIMEOUT_S)
    assert set(launches.values()) == {0}
    for key in ("training_losses", "validation_losses"):
        got, want = getattr(result, key), getattr(single, key)
        assert [e for _, e in got] == [e for _, e in want] == [1]
        np.testing.assert_allclose([v for v, _ in got], [v for v, _ in want], rtol=LOSS_RTOL)
