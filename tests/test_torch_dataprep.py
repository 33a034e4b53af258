"""The port's training-data commands against the JAX CLI's, on the CPU and
one small simulated genome (seeded with numpy): get_truth,
extract_candidates and create_tensor (the native scans and the Python
events engine, BAM and CRAM), pair_with_non_variants and tensor_transform
write the same bytes; tensor2bin, combine_bins and convert_bin write bins
with the same arrays. Then the whole chain through the port's CLI alone,
from the BAM and the truth VCF to a bin that the port's train_model takes
three steps on."""

import io
import math

import numpy as np
import pytest

import clair_tpu.cli as jax_cli
from clair_tpu.data import bins as jax_bins
from clair_tpu_torch import cli
from clair_tpu_torch.data import bins
from clair_tpu_torch.data.tensor_stream import tensor_line_from
from clair_tpu_torch.io.bai import build_bai
from clair_tpu_torch.io.cram import bam_to_cram
from clair_tpu_torch.params import TRAINING_DATASET_PERCENTAGE, ModelConfig
from clair_tpu_torch.parallel.sharding import make_train_step
from clair_tpu_torch.pipeline import train as train_module
from clair_tpu_torch.pipeline.train import TrainingConfig, train_model
from clair_tpu_torch.task.labels import GENOTYPE_SPAN
from clair_tpu_torch.utils.simulate import (
    ErrorProfile, plant_variants, random_reference, simulate_bam, write_fasta,
    write_truth_vcf,
)

LENGTH = 6_000
NARROW = ModelConfig(lstm1_num_units=8, lstm2_num_units=8, l3_num_units=4,
                     l4_num_units=16, l5_num_units=8)


class _SeededRandomState(np.random.RandomState):
    """extract_candidates --gen4Training and pair_with_non_variants sample
    the non-variants they keep from an unseeded generator, as the reference
    does; the tests seed it the same in both packages."""

    def __init__(self, seed=None):
        super().__init__(0 if seed is None else seed)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dataprep")
    rs = np.random.RandomState(61)
    reference = random_reference(rs, LENGTH)
    variants = plant_variants(rs, reference, n_variants=10, spacing=450)
    paths = {k: str(tmp / name) for k, name in (
        ("fa", "ref.fa"), ("bam", "reads.bam"), ("cram", "reads.cram"),
        ("vcf", "truth.vcf"))}
    write_fasta(paths["fa"], reference)
    simulate_bam(paths["bam"], reference, variants, rs, coverage=20,
                 error_profile=ErrorProfile(mismatch=0.03, insertion=0.01, deletion=0.01))
    build_bai(paths["bam"], paths["bam"] + ".bai")
    bam_to_cram(paths["bam"], paths["cram"], paths["fa"])
    write_truth_vcf(paths["vcf"], variants)
    paths["tmp"] = tmp
    paths["variants"] = variants
    return paths


def _both(command, argv, tmp, suffix=""):
    """Run the JAX command and the port's on the same argv, ``{out}`` taking
    each its own output path; the two outputs' bytes."""
    outs = []
    for name, module in (("jax", jax_cli), ("port", cli)):
        out = str(tmp / f"{command}{suffix}.{name}")
        getattr(module, f"cmd_{command}")([a.replace("{out}", out) for a in argv])
        with open(out, "rb") as fh:
            outs.append(fh.read())
    return outs


def _off(monkeypatch, native):
    """The Python events engine in both CLIs, or the native scans; seeded
    sampling."""
    monkeypatch.setattr(np.random, "RandomState", _SeededRandomState)
    if not native:
        for module in (jax_cli, cli):
            monkeypatch.setattr(module, "_native_region_scan", lambda *a, **kw: None)


@pytest.fixture(scope="module")
def truth_vars(genome):
    path = genome["tmp"] / "truth_vars.txt"
    cli.cmd_get_truth(["--vcf_fn", genome["vcf"], "--ctgName", "chr1", "--var_fn", str(path)])
    return str(path)


@pytest.mark.parametrize("region", [[], ["--ctgStart", "1500", "--ctgEnd", "4000"]],
                         ids=["contig", "region"])
def test_get_truth_writes_the_jax_bytes(genome, region):
    want, got = _both("get_truth", ["--vcf_fn", genome["vcf"], "--ref_fn", genome["fa"],
                                    "--ctgName", "chr1", "--var_fn", "{out}", *region],
                      genome["tmp"], "-".join(region))
    assert got == want
    rows = got.decode().splitlines()
    assert len(rows) == (len(genome["variants"]) if not region else
                         sum(1500 <= v.position <= 4000 for v in genome["variants"]))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("aln", ["bam", "cram"])
def test_extract_candidates_writes_the_jax_bytes(genome, truth_vars, monkeypatch, aln, native):
    """--gen4Training: the non-variants sampled near and away from the
    truth sites, and none of those."""
    _off(monkeypatch, native)
    want, got = _both("extract_candidates", [
        "--bam_fn", genome[aln], "--ref_fn", genome["fa"], "--ctgName", "chr1",
        "--gen4Training", "--var_fn", truth_vars, "--can_fn", "{out}"],
        genome["tmp"], f"{aln}{native}")
    assert got == want
    positions = {int(r.split()[1]) for r in got.decode().splitlines()}
    assert positions and not positions & {v.position for v in genome["variants"]}


def test_the_native_scan_engages_in_both_clis(genome):
    """Else the native cases above would compare two Python runs."""
    for module in (jax_cli, cli):
        for aln in ("bam", "cram"):
            scan = module._native_region_scan(genome[aln], genome["fa"], "chr1", 1, LENGTH, 0)
            assert scan is not None, (module.__name__, aln)
            scan.close()


@pytest.fixture(scope="module")
def candidates(genome, truth_vars):
    path = str(genome["tmp"] / "candidates.txt")
    cli.cmd_extract_candidates(["--bam_fn", genome["bam"], "--ref_fn", genome["fa"],
                                "--ctgName", "chr1", "--gen4Training", "--var_fn",
                                truth_vars, "--can_fn", path])
    return path


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("aln", ["bam", "cram"])
def test_create_tensor_writes_the_jax_bytes(genome, candidates, monkeypatch, aln, native):
    _off(monkeypatch, native)
    want, got = _both("create_tensor", [
        "--bam_fn", genome[aln], "--ref_fn", genome["fa"], "--ctgName", "chr1",
        "--can_fn", candidates, "--tensor_fn", "{out}"], genome["tmp"], f"{aln}{native}")
    assert got == want
    lines = got.decode().splitlines()
    assert len(lines) == len(open(candidates).read().splitlines())
    assert len(lines[0].split()) == 3 + 33 * 8 * 4


def test_create_tensor_parity_modes_write_the_jax_bytes(genome, candidates):
    """The reference-parity tensors (Python engine only) over a region."""
    want, got = _both("create_tensor", [
        "--bam_fn", genome["bam"], "--ref_fn", genome["fa"], "--ctgName", "chr1",
        "--ctgStart", "1000", "--ctgEnd", "3000", "--can_fn", candidates,
        "--stop_consider_left_edge", "--compat_slot_throttle", "5000000",
        "--tensor_fn", "{out}"], genome["tmp"], "parity")
    assert got == want and got


@pytest.fixture(scope="module")
def tensors(genome, candidates, truth_vars):
    """The candidates' tensors and the truth sites' tensors (port)."""
    out = {}
    for name, can_fn in (("can", candidates), ("var", truth_vars)):
        out[name] = str(genome["tmp"] / f"tensor_{name}.txt")
        cli.cmd_create_tensor(["--bam_fn", genome["bam"], "--ref_fn", genome["fa"],
                               "--ctgName", "chr1", "--can_fn", can_fn,
                               "--tensor_fn", out[name]])
    return out


def test_pair_with_non_variants_writes_the_jax_bytes(genome, tensors, monkeypatch):
    monkeypatch.setattr(np.random, "RandomState", _SeededRandomState)
    want, got = _both("pair_with_non_variants", [
        "--tensor_can_fn", tensors["can"], "--tensor_var_fn", tensors["var"],
        "--output_fn", "{out}", "--amp", "2"], genome["tmp"])
    assert got == want
    n_var = len(open(tensors["var"]).read().splitlines())
    assert n_var == len(genome["variants"]) and len(got.decode().splitlines()) > n_var


@pytest.fixture(scope="module")
def paired(genome, tensors):
    path = str(genome["tmp"] / "paired.txt")
    cli.cmd_pair_with_non_variants(["--tensor_can_fn", tensors["can"], "--tensor_var_fn",
                                    tensors["var"], "--output_fn", path, "--amp", "2"])
    return path


def _arrays(path, module):
    dataset = module.load_bin(path)
    return dataset.dataset_size, [
        (dataset.x_block(i), dataset.y_block(i), dataset.pos_block(i))
        for i in range(dataset.n_blocks)]


def _assert_same_bin(port_path, jax_path):
    """The port's bin read by both packages, against the JAX bin."""
    size, want = _arrays(jax_path, jax_bins)
    for module in (bins, jax_bins):
        got_size, got = _arrays(port_path, module)
        assert got_size == size and len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _bins_of_both(command, argv, tmp, suffix="", seed=None):
    paths = []
    for name, module in (("jax", jax_cli), ("port", cli)):
        out = str(tmp / f"{command}{suffix}.{name}.bin")
        if seed is not None:
            np.random.seed(seed)  # tensor2bin's shuffle draws from numpy's global generator
        getattr(module, f"cmd_{command}")([a.replace("{out}", out) for a in argv])
        paths.append(out)
    return paths


@pytest.mark.parametrize("shuffle", [[], ["--no_shuffle"]], ids=["shuffled", "in_order"])
def test_tensor2bin_writes_the_jax_arrays(genome, paired, truth_vars, shuffle):
    jax_bin, port_bin = _bins_of_both("tensor2bin", [
        "--tensor_fn", paired, "--var_fn", truth_vars, "--bin_fn", "{out}", *shuffle],
        genome["tmp"], "".join(shuffle), seed=5)
    _assert_same_bin(port_bin, jax_bin)
    assert bins.load_bin(port_bin).dataset_size == len(open(paired).read().splitlines())


@pytest.fixture(scope="module")
def halves(genome, paired, truth_vars):
    """tensor2bin over each half of the contig (the port)."""
    lines = open(paired).read().splitlines()
    paths = []
    for i, keep in enumerate((lambda p: p <= LENGTH // 2, lambda p: p > LENGTH // 2)):
        part = genome["tmp"] / f"paired_{i}.txt"
        part.write_text("".join(r + "\n" for r in lines if keep(int(r.split()[1]))))
        paths.append(str(genome["tmp"] / f"half_{i}.bin"))
        np.random.seed(i)
        cli.cmd_tensor2bin(["--tensor_fn", str(part), "--var_fn", truth_vars,
                            "--bin_fn", paths[-1]])
    return paths


def test_combine_bins_writes_the_jax_arrays(genome, halves, paired):
    jax_bin, port_bin = _bins_of_both("combine_bins", [*halves, "--output_fn", "{out}"],
                                      genome["tmp"])
    _assert_same_bin(port_bin, jax_bin)
    assert bins.load_bin(port_bin).dataset_size == len(open(paired).read().splitlines())


def test_convert_bin_writes_the_jax_arrays(genome, halves):
    jax_bin, port_bin = _bins_of_both("convert_bin", ["--input_fn", halves[0],
                                                      "--output_fn", "{out}"], genome["tmp"])
    _assert_same_bin(port_bin, jax_bin)
    _assert_same_bin(port_bin, halves[0])


def test_convert_bin_refuses_a_blosc_bin(tmp_path):
    """The reference's layout (four pickles) needs blosc, which the port
    does not read; the refusal says where it is read."""
    import pickle

    path = tmp_path / "reference.bin"
    with open(path, "wb") as fh:
        for item in (1, [b""], [b""], [b""]):
            pickle.dump(item, fh)
    with pytest.raises(ValueError, match="blosc"):
        cli.main(["convert_bin", "--input_fn", str(path), "--output_fn", str(tmp_path / "o")])


@pytest.mark.parametrize("collapse", [[], ["--collapse_strand"]], ids=["strands", "collapsed"])
def test_tensor_transform_writes_the_jax_bytes(monkeypatch, capsys, collapse):
    rs = np.random.RandomState(4)
    text = "".join(
        tensor_line_from("chr1", 900 + i, "".join(rs.choice(list("ACGT"), 65)),
                         rs.randint(0, 50, (65, 8, 4))) + "\n" for i in range(3))
    outs = []
    for module in (jax_cli, cli):
        monkeypatch.setattr("sys.stdin", io.StringIO(text))
        module.cmd_tensor_transform(["--source_flanking", "32", *collapse])
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert len(outs[1].splitlines()) == 3 and len(outs[1].split("\n")[0].split()) == 3 + 33 * 32


def test_the_chain_through_the_port_cli_trains(genome, tmp_path, monkeypatch):
    """get_truth -> extract_candidates --gen4Training -> create_tensor (twice)
    -> pair_with_non_variants -> tensor2bin (each half) -> combine_bins, all
    through ``cli.main``; then three CPU steps of train_model on the bin at a
    narrow width, with finite losses."""
    fa, bam, vcf = genome["fa"], genome["bam"], genome["vcf"]
    p = {k: str(tmp_path / k) for k in ("var", "can", "t_can", "t_var", "paired", "a", "b",
                                        "bin_a", "bin_b", "bin")}
    half = LENGTH // 2
    for argv in (
        ["get_truth", "--vcf_fn", vcf, "--ctgName", "chr1", "--var_fn", p["var"]],
        ["extract_candidates", "--bam_fn", bam, "--ref_fn", fa, "--ctgName", "chr1",
         "--gen4Training", "--var_fn", p["var"], "--can_fn", p["can"]],
        ["create_tensor", "--bam_fn", bam, "--ref_fn", fa, "--ctgName", "chr1",
         "--can_fn", p["can"], "--tensor_fn", p["t_can"]],
        ["create_tensor", "--bam_fn", bam, "--ref_fn", fa, "--ctgName", "chr1",
         "--can_fn", p["var"], "--tensor_fn", p["t_var"]],
        ["pair_with_non_variants", "--tensor_can_fn", p["t_can"], "--tensor_var_fn",
         p["t_var"], "--output_fn", p["paired"]],
    ):
        assert cli.main(argv) == 0, argv
    rows = open(p["paired"]).read().splitlines()
    for name, keep in (("a", lambda pos: pos <= half), ("b", lambda pos: pos > half)):
        with open(p[name], "w") as fh:
            fh.writelines(r + "\n" for r in rows if keep(int(r.split()[1])))
        assert cli.main(["tensor2bin", "--tensor_fn", p[name], "--var_fn", p["var"],
                         "--bin_fn", p[f"bin_{name}"]]) == 0
    assert cli.main(["combine_bins", p["bin_a"], p["bin_b"], "--output_fn", p["bin"]]) == 0

    dataset = bins.load_bin(p["bin"])
    assert dataset.dataset_size == len(rows)
    keys = [str(k) for i in range(dataset.n_blocks) for k in dataset.pos_block(i)]
    labels = np.concatenate([dataset.y_block(i) for i in range(dataset.n_blocks)])
    for v in genome["variants"]:
        # a planted variant's genotype label is not the reference's 0/0
        assert labels[keys.index(f"chr1:{v.position}"), GENOTYPE_SPAN[0]] == 0, v

    steps = []

    def counting(*args):
        step = make_train_step(*args)
        return lambda *a: steps.append(1) or step(*a)

    monkeypatch.setattr(train_module, "make_train_step", counting)
    n_train = int(dataset.dataset_size * TRAINING_DATASET_PERCENTAGE)
    result = train_model(dataset, TrainingConfig(
        model=NARROW, train_batch_size=-(-n_train // 3), val_batch_size=64,
        schedule="fixed", max_epochs=1, evaluate_at_end=False,
        train_compute_dtype="float32", decompress_workers=0, device="cpu"))
    assert len(steps) == 3 and len(result.training_losses) == 1
    assert all(math.isfinite(v) for v, _ in result.training_losses + result.validation_losses)
