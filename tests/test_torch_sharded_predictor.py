"""ShardedPredictor (one Predictor per device, each on an equal slice of
the batch) against one Predictor, on two CPU "devices"; ``call_bam
--num_devices 2`` against the single-device command, as
tests/test_cli_sharded.py holds the JAX package's; the refusal of more
cards than are visible; and the card twin (``cuda``)."""

import numpy as np
import pytest
import torch

from clair_tpu_torch import cli
from clair_tpu_torch.models.checkpoint import load_checkpoint
from clair_tpu_torch.ops.bilstm_stream import bilstm_stream
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline.call_bam_parallel import call_bam_windows_threaded
from clair_tpu_torch.pipeline.call_bam import CallBamConfig
from clair_tpu_torch.pipeline.call_var import Predictor, ShardedPredictor
from clair_tpu_torch.utils.simulate import (
    plant_variants, random_reference, simulate_bam, write_fasta,
)

CKPT = "examples/ont_synthetic.ckpt"


@pytest.fixture(scope="module")
def params():
    return load_checkpoint(CKPT)[0]


@pytest.fixture(scope="module")
def flowcell(tmp_path_factory):
    """tests/test_cli_sharded.py's genome."""
    tmp = tmp_path_factory.mktemp("sharded")
    rs = np.random.RandomState(11)
    reference = random_reference(rs, 5000)
    variants = plant_variants(rs, reference, n_variants=15, spacing=220)
    fasta_path, bam_path = str(tmp / "ref.fa"), str(tmp / "s.bam")
    write_fasta(fasta_path, reference, contig="chr1")
    simulate_bam(bam_path, reference, variants, rs, coverage=25)
    return tmp, bam_path, fasta_path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_predictor_gives_the_single_predictors_outputs(params, dtype):
    """A full batch, a short one and one shorter than a slice: the same
    head arrays as one Predictor, in order; the batch rounds up to a
    multiple of the devices."""
    config = ModelConfig(compute_dtype=dtype)
    single = Predictor(params, config, batch_size=10, device="cpu")
    sharded = ShardedPredictor(params, config, batch_size=9, devices=["cpu", "cpu"])
    assert sharded.batch_size == 10 and len(sharded.predictors) == 2
    assert all(p.batch_size == 5 for p in sharded.predictors)
    rs = np.random.RandomState(3)
    batches = [rs.randint(0, 40, (n, 33, 8, 4)).astype(np.uint8) for n in (10, 7, 3)]
    handles = [sharded.predict_async(x) for x in batches]
    for x, (handle, n), grouped in zip(batches, handles,
                                        sharded.gather_group(*zip(*handles))):
        want = single.gather(*single.predict_async(x))
        got = sharded.gather(handle, n)
        for w, g, gg in zip(want, got, grouped):
            assert g.shape == w.shape == (len(x), w.shape[1])
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(gg, g)


def test_sharded_predictor_passes_eager_host_copy_on(params):
    sharded = ShardedPredictor(params, ModelConfig(), batch_size=4, devices=["cpu"] * 2)
    assert sharded.eager_host_copy
    sharded.eager_host_copy = False
    assert not any(p.eager_host_copy for p in sharded.predictors)


@pytest.mark.parametrize("runner", ["call_bam", "call_bam_parallel"])
def test_call_bam_num_devices_identical(flowcell, runner):
    """The single-device rows from ``--num_devices 2`` (here two CPU
    Predictors), through call_bam and the threaded WGS runner."""
    tmp, bam, fasta = flowcell

    def run(name, extra):
        out = str(tmp / f"{runner}_{name}")
        argv = ["--bam_fn", bam, "--ref_fn", fasta, "--chkpnt_fn", CKPT, "--threshold", "0.2",
                *extra]
        if runner == "call_bam":
            cli.cmd_call_bam(argv + ["--ctgName", "chr1", "--call_fn", out + ".vcf"],
                             device="cpu")
        else:
            cli.cmd_call_bam_parallel(argv + ["--run", "--output_prefix", out], device="cpu")
        return [r for r in open(out + ".vcf") if not r.startswith("#")]

    single = run("single", [])
    assert run("sharded", ["--num_devices", "2"]) == single
    assert len(single) > 0


def test_call_bam_refuses_more_cards_than_visible(flowcell):
    tmp, bam, fasta = flowcell
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match=f"--num_devices {n} needs {n} CUDA devices"):
        cli.main(["call_bam", "--bam_fn", bam, "--ref_fn", fasta, "--chkpnt_fn", CKPT,
                  "--ctgName", "chr1", "--num_devices", str(n)])


@pytest.mark.cuda
def test_cuda_sharded_predictor_on_one_card(params, flowcell):
    """On the card: two Predictors on cuda:0 give the single Predictor's
    rows through the threaded runner, each slice launching row 1 twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    tmp, bam, fasta = flowcell
    base = CallBamConfig(bam_path=bam, fasta_path=fasta, minimum_af=0.2)
    rows = {}
    for name, predictor in (("single", Predictor(params, ModelConfig())),
                            ("sharded", ShardedPredictor(params, ModelConfig(),
                                                         devices=["cuda:0", "cuda:0"]))):
        before = bilstm_stream.launches
        out = str(tmp / f"cuda_{name}.vcf")
        call_bam_windows_threaded(base, predictor, out, chunk_size=2500)
        rows[name] = ([r for r in open(out) if not r.startswith("#")],
                      bilstm_stream.launches - before)
    assert rows["sharded"][0] == rows["single"][0]
    assert rows["sharded"][1] == 2 * rows["single"][1] > 0
