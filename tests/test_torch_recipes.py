"""The port's train-to-accuracy entry points against the JAX scripts
(``demo.py``, ``examples/train_synthetic.py``, ``examples/train_production.py``,
imported from their paths), on the CPU at a few kb: each dataset function's
bin array for array, held-out calling with a vendored checkpoint to the same
(recall, precision, exact, n), each recipe's main writing a checkpoint the
JAX package loads, and the demo end to end."""

import importlib.util
import math
import os
from pathlib import Path

import jax
import numpy as np
import pytest

from clair_tpu.models.checkpoint import load_checkpoint as jax_load_checkpoint
from clair_tpu.models.clair import init_params as jax_init_params
from clair_tpu.params import ModelConfig as JaxModelConfig
from clair_tpu_torch import demo
from clair_tpu_torch.examples import train_production, train_synthetic
from clair_tpu_torch.models.checkpoint import checkpoint_path
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.utils.simulate import PLATFORM_RECIPES

ROOT = Path(__file__).resolve().parent.parent
# the keys of the JAX demo's returned dict (demo.py:211-220)
DEMO_KEYS = ("work_dir", "n_truth", "n_called", "recall", "precision", "exact", "snp",
             "indel")


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _assert_same_bin(got, want):
    assert (got.dataset_size, got.block_size, got.n_blocks) == (
        want.dataset_size, want.block_size, want.n_blocks)
    assert got.dataset_size > 0
    for i in range(want.n_blocks):
        for block in ("x_block", "y_block", "pos_block"):
            a, b = getattr(got, block)(i), getattr(want, block)(i)
            assert a.dtype == b.dtype and np.array_equal(a, b), (block, i)


class _Captured(Exception):
    def __init__(self, dataset):
        self.dataset = dataset


def _jax_demo_dataset(tmp_path, monkeypatch, **kwargs):
    """The bin the JAX demo's steps 1-4 build: its run_demo, stopped where
    it hands the bin to train_model."""
    import clair_tpu.pipeline.train as jax_train

    def capture(dataset, config):
        raise _Captured(dataset)

    monkeypatch.setattr(jax_train, "train_model", capture)
    with pytest.raises(_Captured) as captured:
        _script("demo").run_demo(work_dir=str(tmp_path), verbose=False, **kwargs)
    return captured.value.dataset


@pytest.mark.parametrize("recipe", ["synthetic_ont", "synthetic_ccs", "synthetic_ilmn",
                                    "production_ont", "demo_ont"])
def test_datasets_match_jax(tmp_path, monkeypatch, recipe):
    """Each dataset function of the port against its JAX counterpart on
    the same seed at a 6 kb genome: the same BinDataset, every block's x, y
    and positions. The bin's shuffle draws from numpy's global generator,
    seeded alike before each."""
    kind, profile = recipe.split("_")
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir(), port_dir.mkdir()
    if kind == "synthetic":
        args = (11, 6_000, 24)
        np.random.seed(5)
        want, want_variants = _script("examples/train_synthetic").build_dataset(
            str(jax_dir), *args, **PLATFORM_RECIPES[profile])
        np.random.seed(5)
        got, variants = train_synthetic.build_dataset(str(port_dir), *args,
                                                      **PLATFORM_RECIPES[profile])
    elif kind == "production":
        args = (21, 6, 0, 100)
        np.random.seed(5)
        want, want_variants = _script("examples/train_production").build_ont_dataset(
            str(jax_dir), *args)
        np.random.seed(5)
        got, variants = train_production.build_ont_dataset(str(port_dir), *args)
    else:
        kwargs = demo.demo_kwargs(True, profile)
        kwargs.update(genome_length=6_000, n_variants=30, epochs=1)
        np.random.seed(5)
        want = _jax_demo_dataset(jax_dir, monkeypatch, **kwargs)
        want_variants = None
        np.random.seed(5)
        got, _ = demo.demo_dataset(
            str(port_dir), kwargs["genome_length"], kwargs["n_variants"], kwargs["coverage"],
            0.002, 7, kwargs["error_profile"], kwargs["read_length"],
            kwargs["read_length_sigma"], 150)
    _assert_same_bin(got, want)
    if want_variants is not None:
        assert [(v.position, v.ref, v.alt) for v in variants] == [
            (v.position, v.ref, v.alt) for v in want_variants]


@pytest.mark.parametrize("recipe", ["synthetic", "production"])
def test_evaluate_held_out_matches_jax(recipe):
    """Held-out calling with a vendored model (the JAX checkpoint's tree,
    through params_from_jax) on a small genome never seen in training:
    evaluate_held_out with ont_synthetic.ckpt at 6 kb and 20 variants,
    evaluate_held_out_ont with ont_production.ckpt on a 6 kb flowcell. The
    same (recall, precision, exact, n) as the JAX function's on the CPU."""
    if recipe == "synthetic":
        params, _ = jax_load_checkpoint(str(ROOT / "examples" / "ont_synthetic.ckpt"))
        args = (PLATFORM_RECIPES["ont"],)
        kwargs = dict(genome_length=6_000, n_variants=20)
        want = _script("examples/train_synthetic").evaluate_held_out(
            params, JaxModelConfig(), *args, **kwargs)
        got = train_synthetic.evaluate_held_out(params, ModelConfig(), *args, device="cpu",
                                                **kwargs)
        assert got[3] == 20
    else:
        params, _ = jax_load_checkpoint(str(ROOT / "examples" / "ont_production.ckpt"))
        want = _script("examples/train_production").evaluate_held_out_ont(
            params, JaxModelConfig(), genome_kb=6)
        got = train_production.evaluate_held_out_ont(params, ModelConfig(), genome_kb=6,
                                                     device="cpu")
    assert got == want
    assert got[0] > 0.5, got


@pytest.mark.parametrize("recipe", ["synthetic", "production"])
def test_main_writes_a_checkpoint_the_jax_package_loads(tmp_path, recipe):
    """Each recipe's main on the CPU at a tiny size: the full-width model
    trained two epochs, written where --output says in the JAX layout (the
    JAX loader reads it, with the JAX recipe's metadata), and the held-out
    numbers it prints returned."""
    output = str(tmp_path / "model.ckpt")
    if recipe == "synthetic":
        out = train_synthetic.main(["--profile", "ilmn", "--epochs", "2", "--genome_length",
                                    "6000", "--n_variants", "20", "--train_compute_dtype",
                                    "float32", "--output", output], device="cpu")
        meta = {"epoch": 2}
    else:
        bin_fn = str(tmp_path / "flowcell.bin")
        out = train_production.main(["--genome_kb", "6", "--hard_max_epochs", "2",
                                     "--dataset_bin", bin_fn, "--output", output],
                                    device="cpu")
        assert os.path.isfile(bin_fn)
        meta = {"recipe": "production-adaptive-b10000", "epochs": 2,
                "best_epoch": out["result"].best_epoch}
    params, extra = jax_load_checkpoint(output)
    assert extra == meta
    want = jax_init_params(jax.random.PRNGKey(0), JaxModelConfig())
    assert jax.tree_util.tree_map(np.shape, params) == jax.tree_util.tree_map(np.shape, want)
    assert 0.0 <= out["recall"] <= 1.0 and out["n"] > 0
    assert len(out["result"].training_losses) == 2


def test_run_demo_end_to_end_on_the_cpu(tmp_path):
    """run_demo at a tiny size on the CPU (5 kb, a few epochs): a VCF of
    calls, the JAX demo's keys and consistent tallies."""
    stats = demo.run_demo(genome_length=5_000, n_variants=15, coverage=30, epochs=3,
                          work_dir=str(tmp_path), verbose=False, device="cpu")
    assert tuple(stats) == DEMO_KEYS
    vcf = tmp_path / "calls.vcf"
    assert vcf.is_file() and vcf.read_text().startswith("##fileformat=VCF")
    calls = [row for row in vcf.read_text().splitlines() if not row.startswith("#")]
    assert stats["n_truth"] == 15 and stats["n_called"] == len(calls)
    # the final epoch's checkpoint, in the JAX layout
    _, extra = jax_load_checkpoint(checkpoint_path(str(tmp_path / "model"), 3))
    assert extra["epoch"] == 3
    snp, indel = stats["snp"], stats["indel"]
    assert snp["tp"] + snp["fn"] + indel["tp"] + indel["fn"] == 15
    assert snp["tp"] + indel["tp"] == round(stats["recall"] * 15)
    assert all(math.isfinite(tally["f1"]) for tally in (snp, indel))
