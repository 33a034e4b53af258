"""The port's process-pool WGS runner (``call_bam_parallel --run
--process_pool``), on the CPU: each spawn worker builds its own Predictor
on the device its work carries and calls a disjoint set of windows. Every
window is called once, no site is lost or duplicated, and the merged VCF
equals a one-worker run's; a worker that cannot reach its device records
its windows as failed in the joblog; and --num_devices with --process_pool
is a usage error, as in the JAX CLI."""

import functools
import json

import numpy as np
import pytest
import torch

from clair_tpu_torch import cli
from clair_tpu_torch.io.bai import build_bai
from clair_tpu_torch.models.checkpoint import save_checkpoint
from clair_tpu_torch.models.clair import init_params
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline import call_var
from clair_tpu_torch.utils.simulate import (
    plant_variants, random_reference, simulate_bam, write_fasta,
)


@pytest.fixture(scope="module")
def pool_genome(tmp_path_factory):
    """tests/test_process_pool.py's genome cut from 8 kb to 6 kb (three
    windows: every window costs a full-width forward of a padded 512-row
    batch on the CPU) and a full-width random checkpoint, which the workers
    load."""
    tmp = tmp_path_factory.mktemp("pool")
    rs = np.random.RandomState(29)
    ref = random_reference(rs, 6_000)
    variants = plant_variants(rs, ref, n_variants=15, spacing=300)
    bam, fa = str(tmp / "s.bam"), str(tmp / "ref.fa")
    simulate_bam(bam, ref, variants, rs, coverage=25)
    write_fasta(fa, ref)
    build_bai(bam, bam + ".bai")
    ckpt = str(tmp / "model.ckpt")
    save_checkpoint(ckpt, init_params(torch.Generator().manual_seed(0), ModelConfig()))
    return bam, fa, ckpt


def _argv(genome, prefix, *flags):
    bam, fa, ckpt = genome
    return ["--bam_fn", bam, "--ref_fn", fa, "--chkpnt_fn", ckpt, "--output_prefix", prefix,
            "--refChunkSize", "2000", "--threshold", "0.2", "--run", "--process_pool", *flags]


def _rows(path):
    return [r for r in open(path) if not r.startswith("#")]


def test_pool_calls_every_window_once_and_merges_the_one_worker_vcf(pool_genome, tmp_path,
                                                                    monkeypatch):
    pool = str(tmp_path / "pool")
    cli.cmd_call_bam_parallel(_argv(pool_genome, pool, "--workers", "2"), pool_device="cpu")
    entries = [json.loads(line) for line in open(pool + ".joblog")]
    assert [e["status"] for e in entries] == ["ok"] * 3
    windows = [tuple(e["window"]) for e in entries]
    assert sorted(windows) == [("chr1", s, s + 1999) for s in (1, 2001, 4001)]

    # no overlap, no loss: the windows' rows are disjoint and make the merge
    per_window = [_rows(e["output"]) for e in sorted(entries, key=lambda e: e["window"][1])]
    positions = [int(r.split("\t")[1]) for rows in per_window for r in rows]
    assert len(positions) == len(set(positions)) > 0
    merged = _rows(pool + ".vcf")
    assert merged == [r for rows in per_window for r in rows]

    # one worker: the command's own process calls every window, with the
    # predictor of the command's factory
    monkeypatch.setattr(call_var, "Predictor", functools.partial(call_var.Predictor, device="cpu"))
    one = str(tmp_path / "one")
    cli.cmd_call_bam_parallel(_argv(pool_genome, one, "--workers", "1"))
    assert [json.loads(line)["status"] for line in open(one + ".joblog")] == ["ok"] * 3
    assert _rows(one + ".vcf") == merged


def test_a_worker_without_its_device_fails_its_windows_in_the_joblog(pool_genome, tmp_path):
    """Here no worker reaches a CUDA device: the pool keeps going, each
    window is logged failed with the Predictor's error, and nothing merges."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the workers would reach it")
    prefix = str(tmp_path / "nocard")
    cli.cmd_call_bam_parallel(_argv(pool_genome, prefix, "--workers", "2",
                                    "--refChunkSize", "3000"))
    entries = [json.loads(line) for line in open(prefix + ".joblog")]
    assert [e["status"] for e in entries] == ["failed"] * 2
    assert all("torch.cuda.is_available() is false" in e["error"] for e in entries)
    assert _rows(prefix + ".vcf") == []


def test_num_devices_with_the_pool_is_a_usage_error(pool_genome, tmp_path, capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["call_bam_parallel", *_argv(pool_genome, str(tmp_path / "x"),
                                              "--num_devices", "2")])
    assert exit_info.value.code == 2
    assert "--process_pool each worker process owns its own device" in capsys.readouterr().err
