"""The port's Predictor against the JAX Predictor (both float32 on the CPU):
the same head probabilities on uint8 and float32 link batches, and the same
VCF from the port's call_bam as from the JAX package's on a small simulated
ONT genome with the vendored ONT checkpoint, sequentially, through the
threaded WGS runner and through both command lines."""

import dataclasses

import numpy as np
import pytest

from clair_tpu.models.checkpoint import load_checkpoint as jax_load_checkpoint
from clair_tpu.params import ModelConfig as JaxModelConfig
from clair_tpu.pipeline.call_bam import CallBamConfig as JaxCallBamConfig
from clair_tpu.pipeline.call_bam import call_bam as jax_call_bam
from clair_tpu.pipeline.call_var import Predictor as JaxPredictor
from clair_tpu_torch.models.checkpoint import load_checkpoint
from clair_tpu_torch.ops.bilstm_stream import bilstm_stream
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline.call_bam import CallBamConfig, call_bam
from clair_tpu_torch.pipeline.call_var import Predictor
from clair_tpu_torch.utils import simulate
from clair_tpu_torch.utils.simulate import (
    PLATFORM_RECIPES, plant_variants, random_reference, simulate_bam, write_fasta,
)

CKPT = "examples/ont_synthetic.ckpt"
# QUAL = (10*log10(p / (1 - p)) + 16)^2. Above 3000, 1 - p < 1.3e-4, and the
# float32 rounding of p near 1 (6e-8) moves QUAL by more than 1: two float32
# forwards that sum in another order land anywhere above it.
QUAL_RESOLVED = 3000


@pytest.fixture(scope="module")
def params():
    return load_checkpoint(CKPT)[0]


def _uint8_batch(rs, n):
    return rs.randint(0, 40, (n, 33, 8, 4)).astype(np.uint8)


def _normalized_f32_batch(rs, n):
    x = rs.randint(0, 400, (n, 33, 8, 4)).astype(np.float32)
    x[..., 1:] -= x[..., :1]
    return x


def test_predictor_matches_jax_on_both_link_dtypes(params):
    """uint8 (normalized on the device) and over-byte float32 (shipped as
    int16) batches in one run, the second one short of the batch size:
    every head within 2e-5 of the JAX Predictor."""
    rs = np.random.RandomState(0)
    jax_pred = JaxPredictor(jax_load_checkpoint(CKPT)[0], JaxModelConfig(), batch_size=32)
    port = Predictor(params, ModelConfig(), batch_size=32, device="cpu")
    for x in (_uint8_batch(rs, 32), _normalized_f32_batch(rs, 21)):
        want = jax_pred.gather(*jax_pred.predict_async(x))
        got = port.gather(*port.predict_async(x))
        for w, g in zip(want, got):
            assert g.shape == w.shape == (len(x), w.shape[1])
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)


def test_gather_group_is_gathers_in_order(params):
    rs = np.random.RandomState(1)
    port = Predictor(params, ModelConfig(), batch_size=16, device="cpu")
    batches = [_uint8_batch(rs, 16), _uint8_batch(rs, 5)]
    sent = [port.predict_async(x) for x in batches]
    grouped = port.gather_group([h for h, _ in sent], [n for _, n in sent])
    for (handle, n), heads in zip(sent, grouped):
        for a, b in zip(port.gather(handle, n), heads):
            np.testing.assert_array_equal(a, b)


def test_cpu_predictor_never_launches_the_kernel(params):
    before = bilstm_stream.launches
    port = Predictor(params, ModelConfig(), batch_size=8, device="cpu")
    port.gather(*port.predict_async(_uint8_batch(np.random.RandomState(2), 8)))
    assert bilstm_stream.launches == before


@pytest.fixture(scope="module")
def ont_genome(tmp_path_factory):
    """A 4 kb genome with planted variants, reads at the ONT recipe."""
    recipe = PLATFORM_RECIPES["ont"]
    root = tmp_path_factory.mktemp("ont")
    rs = np.random.RandomState(424242)
    reference = random_reference(rs, 4_000)
    variants = plant_variants(rs, reference, n_variants=16, spacing=200)
    fasta, bam = str(root / "ref.fa"), str(root / "s.bam")
    write_fasta(fasta, reference)
    simulate_bam(bam, reference, variants, rs, coverage=recipe["coverage"],
                 read_length=recipe["read_length"],
                 read_length_sigma=recipe["read_length_sigma"],
                 error_profile=getattr(simulate, recipe["profile_name"]))
    return root, CallBamConfig(bam_path=bam, fasta_path=fasta, contig="chr1",
                               minimum_af=0.2, minimum_coverage=4)


def _rows(path):
    return [r.rstrip("\n").split("\t") for r in open(path) if not r.startswith("#")]


def _assert_same_calls(got_rows, want_rows):
    """CHROM, POS, REF, ALT and GT identical; QUAL within 1 where float32
    resolves it, and above QUAL_RESOLVED on both sides where it does not."""
    assert len(got_rows) == len(want_rows) > 0
    for g, w in zip(got_rows, want_rows):
        assert (g[0], g[1], g[3], g[4], g[9].split(":")[0]) == \
               (w[0], w[1], w[3], w[4], w[9].split(":")[0])
        qual_g, qual_w = float(g[5]), float(w[5])
        assert abs(qual_g - qual_w) <= 1.0 or min(qual_g, qual_w) > QUAL_RESOLVED, (g, w)


def test_call_bam_vcf_matches_jax_predictor(params, ont_genome):
    root, config = ont_genome
    want, got = str(root / "jax.vcf"), str(root / "port.vcf")
    jax_call_bam(JaxCallBamConfig(**dataclasses.asdict(config)),
                 JaxPredictor(jax_load_checkpoint(CKPT)[0], JaxModelConfig(), batch_size=64),
                 output_path=want)
    call_bam(config, Predictor(params, ModelConfig(), batch_size=64, device="cpu"),
             output_path=got)
    _assert_same_calls(_rows(got), _rows(want))


def test_threaded_runner_takes_the_port_predictor(params, ont_genome):
    """call_bam_windows_threaded probes eager_host_copy and gather_group;
    over two windows it writes the rows the sequential call_bam writes."""
    from clair_tpu_torch.pipeline.call_bam_parallel import call_bam_windows_threaded

    root, config = ont_genome
    sequential, threaded = str(root / "seq.vcf"), str(root / "threaded.vcf")
    predictor = Predictor(params, ModelConfig(), batch_size=64, device="cpu")
    call_bam(config, predictor, output_path=sequential)
    call_bam_windows_threaded(config, predictor, threaded, chunk_size=2_000,
                              pileup_workers=2)
    assert predictor.eager_host_copy  # restored after the run
    _assert_same_calls(_rows(threaded), _rows(sequential))


def test_cli_call_bam_runs_the_jax_runner_with_the_port_predictor(
        ont_genome, monkeypatch, capsys):
    """`python -m clair_tpu_torch call_bam` takes the JAX command's flags and
    runs the port's copy of its runner with the port's predictor (here
    placed on the CPU, where the command itself refuses to run): the JAX
    command's calls, and one JSON line of kernel launches."""
    import functools
    import json

    from clair_tpu import cli as jax_cli
    from clair_tpu_torch import cli
    from clair_tpu_torch.pipeline import call_var as port_call_var

    root, config = ont_genome
    monkeypatch.setattr(port_call_var, "Predictor",
                        functools.partial(Predictor, device="cpu"))
    argv = ["call_bam", "--bam_fn", config.bam_path, "--ref_fn", config.fasta_path,
            "--chkpnt_fn", CKPT, "--ctgName", "chr1", "--threshold", "0.2",
            "--dtype", "float32"]
    want, got = str(root / "cli_jax.vcf"), str(root / "cli_port.vcf")
    assert jax_cli.main(argv + ["--call_fn", want]) == 0
    assert cli.main(argv + ["--call_fn", got]) == 0
    _assert_same_calls(_rows(got), _rows(want))
    report = capsys.readouterr().err.strip().splitlines()[-1]
    assert json.loads(report) == {"kernel_launches": dict.fromkeys(
        ["bilstm_stream", "bilstm_stream_backward", "bilstm_train", "bilstm_train_backward",
         "bilstm_precomputed", "bilstm2"], 0)}


def test_cli_call_bam_parallel_threaded_matches_jax(ont_genome, monkeypatch):
    """The threaded WGS runner through both CLIs, over two windows."""
    import functools

    from clair_tpu import cli as jax_cli
    from clair_tpu_torch import cli
    from clair_tpu_torch.pipeline import call_var as port_call_var

    root, config = ont_genome
    monkeypatch.setattr(port_call_var, "Predictor",
                        functools.partial(Predictor, device="cpu"))
    argv = ["call_bam_parallel", "--bam_fn", config.bam_path,
            "--ref_fn", config.fasta_path, "--chkpnt_fn", CKPT,
            "--threshold", "0.2", "--dtype", "float32", "--refChunkSize", "2000",
            "--workers", "2", "--run"]
    assert jax_cli.main(argv + ["--output_prefix", str(root / "wgs_jax")]) == 0
    assert cli.main(argv + ["--output_prefix", str(root / "wgs_port")]) == 0
    _assert_same_calls(_rows(str(root / "wgs_port.vcf")), _rows(str(root / "wgs_jax.vcf")))


def test_cli_call_var_matches_jax(ont_genome, monkeypatch):
    """call_var over a text tensor file (the window's pileup tensors)."""
    import functools

    from clair_tpu import cli as jax_cli
    from clair_tpu.data.tensor_stream import tensor_line_from
    from clair_tpu.pipeline.call_bam import prepare_window
    from clair_tpu_torch import cli
    from clair_tpu_torch.pipeline import call_var as port_call_var

    root, config = ont_genome
    work = prepare_window(config)
    tensors = str(root / "tensors.txt")
    with open(tensors, "w") as fh:
        for i, center in enumerate(work.centers):
            print(tensor_line_from("chr1", int(center), work.sequences[i],
                                   work.tensors[i]), file=fh)
    monkeypatch.setattr(port_call_var, "Predictor",
                        functools.partial(Predictor, device="cpu"))
    argv = ["call_var", "--tensor_fn", tensors, "--chkpnt_fn", CKPT,
            "--bam_fn", config.bam_path, "--ref_fn", config.fasta_path,
            "--dtype", "float32"]
    want, got = str(root / "var_jax.vcf"), str(root / "var_port.vcf")
    assert jax_cli.main(argv + ["--call_fn", want]) == 0
    assert cli.main(argv + ["--call_fn", got]) == 0
    _assert_same_calls(_rows(got), _rows(want))


PARALLEL_ARGS = ["call_bam_parallel", "--bam_fn", "x.bam", "--ref_fn", "x.fa",
                 "--chkpnt_fn", CKPT, "--output_prefix", "x"]


@pytest.mark.parametrize("argv,match", [
    (["call_var", "--activation_only"], "activation_only"),
    (PARALLEL_ARGS + ["--run", "--num_devices", "2"], "num_devices"),
])
def test_cli_refuses_what_is_not_ported(argv, match):
    from clair_tpu_torch import cli

    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv)


def test_cli_command_sheet_names_the_port(ont_genome):
    """call_bam_parallel without --run prints one port call_bam command per
    window, as the JAX command sheet prints its own."""
    import subprocess
    import sys

    root, config = ont_genome
    proc = subprocess.run(
        [sys.executable, "-m", "clair_tpu_torch", "call_bam_parallel", "--bam_fn", config.bam_path,
         "--ref_fn", config.fasta_path, "--chkpnt_fn", CKPT,
         "--output_prefix", str(root / "sheet"), "--refChunkSize", "2000"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 2
    for i, line in enumerate(lines):
        assert line.startswith(f"python -m clair_tpu_torch call_bam --bam_fn {config.bam_path} ")
        assert f"--ctgStart {i * 2000 + 1} --ctgEnd {(i + 1) * 2000}" in line


def test_cli_refuses_more_than_one_device():
    from clair_tpu_torch import cli

    with pytest.raises(NotImplementedError, match="num_devices"):
        cli._predictor_from(CKPT, num_devices=2)


def test_cli_refuses_to_run_without_cuda(ont_genome):
    """No CPU fallback: on a machine without a card the command fails."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the command would run")
    root, config = ont_genome
    proc = subprocess.run(
        [sys.executable, "-m", "clair_tpu_torch", "call_bam",
         "--bam_fn", config.bam_path, "--ref_fn", config.fasta_path,
         "--chkpnt_fn", CKPT, "--ctgName", "chr1",
         "--call_fn", str(root / "none.vcf")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
