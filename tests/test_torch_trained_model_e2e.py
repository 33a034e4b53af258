"""The vendored trained models called on the card through the port: each
platform's full-size checkpoint (examples/{ont,ccs,ilmn}_synthetic.ckpt) on
a genome it never saw, and the production-recipe checkpoint
(examples/ont_production.ckpt) on a held-out flowcell, with the floors of
tests/test_trained_model_e2e.py. Card only: the port's calling path on
CUDA tensors launches its kernels (row 1 for every batch)."""

from pathlib import Path

import pytest
import torch

from clair_tpu_torch.examples.simulated import call_and_score, simulate_flowcell, simulate_genome
from clair_tpu_torch.models.checkpoint import load_checkpoint
from clair_tpu_torch.ops import launch_counts, launches_since
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.utils.simulate import PLATFORM_RECIPES

ROOT = Path(__file__).resolve().parent.parent


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")


@pytest.mark.cuda
@pytest.mark.parametrize("platform", sorted(PLATFORM_RECIPES))
def test_trained_checkpoint_calls_unseen_genome_on_the_card(tmp_path, platform):
    _needs_card()
    params, meta = load_checkpoint(str(ROOT / "examples" / f"{platform}_synthetic.ckpt"))
    assert meta.get("epoch") == 400
    fasta, bam, variants = simulate_genome(str(tmp_path), PLATFORM_RECIPES[platform],
                                           seed=424242, genome_length=30_000, n_variants=120)
    before = launch_counts()
    recall, precision, exact, n = call_and_score(bam, fasta, variants, params, ModelConfig(),
                                                 batch_size=256, device="cuda")
    assert launches_since(before)["bilstm_stream"] > 0
    assert recall >= 0.9, (recall, precision)
    assert precision >= 0.9, (recall, precision)
    assert exact >= 0.85 * n, exact


@pytest.mark.cuda
def test_production_checkpoint_calls_unseen_flowcell_on_the_card(tmp_path):
    _needs_card()
    params, meta = load_checkpoint(str(ROOT / "examples" / "ont_production.ckpt"))
    assert meta.get("recipe") == "production-adaptive-b10000"
    fasta, bam, variants = simulate_flowcell(str(tmp_path), seed=626262, genome_kb=40,
                                             coverage=35)
    before = launch_counts()
    recall, precision, exact, n = call_and_score(bam, fasta, variants, params, ModelConfig(),
                                                 batch_size=256, device="cuda")
    assert launches_since(before)["bilstm_stream"] > 0
    assert recall >= 0.93, (recall, n)
    assert exact >= 0.9 * n, (exact, n)
    # the flowcell plants systematic error hotspots near the candidate AF
    # cutoff: precision's floor is low by design
    assert precision >= 0.6
