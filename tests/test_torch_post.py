"""The port's post-processing, alignment-file, TF1-conversion and plotting
commands against the JAX CLI's, on the CPU: overlap_variant, ensemble and
merge_gvcf on the inputs of tests/test_{pipeline_e2e,ensemble_chain,
gvcf_merge}.py, view/sam2bam, bam2cram then cram2bam, and index_vcf write
the same bytes; convert_tf1 on the real-TensorFlow fixtures writes the same
parameter arrays, which the port's model runs to the fixtures' golden heads;
plot_tensor writes its PNG."""

import io
from pathlib import Path

import numpy as np
import pytest
import torch

import clair_tpu.cli as jax_cli
from clair_tpu.data.tensor_stream import tensor_line_from
from clair_tpu.models.checkpoint import load_checkpoint as jax_load_checkpoint
from clair_tpu.pipeline.call_var import call_variants_for_ensemble
from clair_tpu_torch import cli
from clair_tpu_torch.io.bam import BamReader
from clair_tpu_torch.models.checkpoint import load_checkpoint
from clair_tpu_torch.models.clair import ClairNet
from clair_tpu_torch.params import ModelConfig
from tests.test_call_var import SEQ, FakePredictor, _counts_tensor
from tests.test_gvcf_merge import two_sample_gvcfs  # noqa: F401  (a fixture)
from tests.test_sam import REFS, _bam_with_everything

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"


def _stdio(monkeypatch, capsys, command, argv, text):
    """Each CLI's ``command`` on ``text`` as stdin; the two stdouts."""
    outs = []
    for module in (jax_cli, cli):
        monkeypatch.setattr("sys.stdin", io.StringIO(text))
        rc = module.main([command, *argv])
        assert rc == 0
        outs.append(capsys.readouterr().out)
    return outs


def _files(tmp_path, command, argv, suffix=""):
    """Each CLI's ``command``, ``{out}`` its own output path; the two
    outputs' bytes."""
    outs = []
    for name, module in (("jax", jax_cli), ("port", cli)):
        args = [a.replace("{out}", str(tmp_path / f"{name}{suffix}")) for a in argv]
        assert module.main([command, *args]) == 0
        with open(next(b for a, b in zip(argv, args) if a != b), "rb") as fh:
            outs.append(fh.read())
    return outs


# ---------------------------------------------------------------------------
# post-processing
# ---------------------------------------------------------------------------

OVERLAP_VCF = "\n".join([
    "##fileformat=VCFv4.1",
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS",
    "chr1\t100\t.\tGAAA\tG\t300\t.\t.\tGT:GQ:DP:AF\t1/1:300:20:0.9",
    "chr1\t102\t.\tA\tT\t50\t.\t.\tGT:GQ:DP:AF\t0/1:50:20:0.4",
    "chr1\t200\t.\tC\tG\t90\t.\t.\tGT:GQ:DP:AF\t0/1:90:20:0.5",
]) + "\n"


def test_overlap_variant_writes_the_jax_bytes(monkeypatch, capsys):
    want, got = _stdio(monkeypatch, capsys, "overlap_variant", [], OVERLAP_VCF)
    assert got == want
    assert [r.split("\t")[1] for r in got.splitlines() if not r.startswith("#")] == ["100", "200"]


def _pipeline_e2e_ensemble_input():
    tensor_cols = "\t".join(["1"] * (33 * 8 * 4))
    return "".join(f"chr1\t500\tACG\t{tensor_cols}\t{p}\n" for p in (
        "\t".join(["0.100000"] * 90), "\t".join(["0.300000"] * 90)))


def _ensemble_chain_input():
    """Two runs of call_var --output_for_ensemble over five sites."""
    lines = [tensor_line_from("chr3", 700 + i, SEQ, _counts_tensor("G", 9)) for i in range(5)]
    runs = []
    for _ in range(2):
        sink = io.StringIO()
        call_variants_for_ensemble(iter(lines), FakePredictor(), sink)
        runs.append(sink.getvalue())
    return runs[0] + runs[1]


@pytest.mark.parametrize("make_input,count", [(_pipeline_e2e_ensemble_input, 1),
                                              (_ensemble_chain_input, 5)],
                         ids=["pipeline_e2e", "ensemble_chain"])
def test_ensemble_writes_the_jax_bytes(monkeypatch, capsys, make_input, count):
    want, got = _stdio(monkeypatch, capsys, "ensemble", ["--minimum_count_to_output", "2"],
                       make_input())
    assert got == want
    assert len(got.splitlines()) == count


@pytest.mark.parametrize("names", [[], ["--sample_names", "X,Y"]], ids=["headers", "renamed"])
def test_merge_gvcf_writes_the_jax_bytes(two_sample_gvcfs, tmp_path, names):  # noqa: F811
    paths, *_ = two_sample_gvcfs
    want, got = _files(tmp_path, "merge_gvcf", [paths["A"], paths["B"], "--output_fn", "{out}",
                                                *names])
    assert got == want
    assert (b"\tX\tY\n" if names else b"\tA\tB\n") in got
    assert sum(not r.startswith(b"#") for r in got.splitlines()) > 0


# ---------------------------------------------------------------------------
# alignment files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def alignments(tmp_path_factory):
    """tests/test_sam.py's BAM (every tag type, a cross-contig mate) over a
    random two-contig FASTA."""
    from clair_tpu_torch.io.fasta import build_fai

    tmp = tmp_path_factory.mktemp("alignments")
    bam = _bam_with_everything(tmp)
    fa = str(tmp / "ref.fa")
    rs = np.random.RandomState(3)
    with open(fa, "w") as fh:
        for name, length in REFS:
            seq = "".join(rs.choice(list("ACGT"), length))
            fh.write(f">{name}\n")
            for off in range(0, length, 60):
                fh.write(seq[off:off + 60] + "\n")
    build_fai(fa)
    return bam, fa


@pytest.mark.parametrize("flags", [[], ["--region", "chr1:1-200"], ["--output_fn", "{out}.bam"]],
                         ids=["sam", "region", "bam"])
def test_view_of_a_bam_writes_the_jax_bytes(alignments, tmp_path, capsys, flags):
    bam, _ = alignments
    if "--output_fn" in flags:
        want, got = _files(tmp_path, "view", ["--input_fn", bam, *flags])
        with BamReader(str(tmp_path / "port.bam")) as reader:
            assert len(list(reader)) == 3
    else:
        outs = []
        for module in (jax_cli, cli):
            assert module.main(["view", "--input_fn", bam, *flags]) == 0
            outs.append(capsys.readouterr().out)
        want, got = outs
        assert sum(not r.startswith("@") for r in got.splitlines()) == (1 if flags else 3)
    assert got == want


def test_sam2bam_and_cram_round_trip_write_the_jax_bytes(alignments, tmp_path, capsys):
    """view BAM -> SAM text, sam2bam SAM -> BAM; bam2cram (3.0 and 3.1
    arith with fqzcomp qualities) then cram2bam, and view of the CRAM."""
    bam, fa = alignments
    assert cli.main(["view", "--input_fn", bam, "--output_fn", str(tmp_path / "in.sam")]) == 0
    want, got = _files(tmp_path, "sam2bam", ["--input_fn", str(tmp_path / "in.sam"),
                                             "--output_fn", "{out}.bam"], ".sam2bam")
    assert got == want
    for i, flags in enumerate(([], ["--cram_version", "3.1", "--codec", "arith",
                                    "--fqzcomp_quals"])):
        want, got = _files(tmp_path, "bam2cram", ["--bam_fn", bam, "--ref_fn", fa,
                                                  "--cram_fn", "{out}", *flags], f".{i}.cram")
        assert got == want
        cram = str(tmp_path / f"port.{i}.cram")
        want, got = _files(tmp_path, "cram2bam", ["--cram_fn", cram, "--ref_fn", fa,
                                                  "--bam_fn", "{out}"], f".{i}.bam")
        assert got == want
        outs = []
        for module in (jax_cli, cli):
            assert module.main(["view", "--input_fn", cram, "--ref_fn", fa]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0]
        assert [r for r in outs[1].splitlines() if not r.startswith("@")] == \
            [r for r in open(tmp_path / "in.sam").read().splitlines() if not r.startswith("@")]


def test_index_vcf_writes_the_jax_bytes(tmp_path):
    from clair_tpu_torch.io.tbi import bgzip_file

    rs = np.random.RandomState(9)
    vcf = tmp_path / "calls.vcf"
    rows = [f"chr{c}\t{p}\t.\tA\tG\t{q}\tPASS\t.\tGT\t0/1"
            for c in (1, 2) for p, q in zip(np.sort(rs.choice(10**6, 300, replace=False)) + 1,
                                             rs.randint(1, 99, 300))]
    vcf.write_text("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                   "FORMAT\tS\n" + "".join(r + "\n" for r in rows))
    gz = bgzip_file(str(vcf))
    want, got = _files(tmp_path, "index_vcf", ["--vcf_fn", gz, "--tbi_fn", "{out}"])
    assert got == want and got


# ---------------------------------------------------------------------------
# TF1 checkpoints, plotting
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path + (k,))
        else:
            yield "/".join(path + (k,)), tree[k]


@pytest.mark.parametrize("fixture", ["tf_real", "tf_real_gpu"])
def test_convert_tf1_writes_the_jax_arrays(tmp_path, capsys, fixture):
    """Both TF1 layouts (cudnn_compatible_lstm_cell kernels, CudnnLSTM
    blobs) at the fixtures' 4 units: the same audit text, the same
    parameters, and the port's model on them gives the golden heads."""
    prefix = f"{FIXTURES}/{fixture}/model"
    widths = ["--lstm1_num_units", "4", "--lstm2_num_units", "4"]
    audits = []
    for module in (jax_cli, cli):
        assert module.main(["convert_tf1", "--chkpnt_fn", prefix, "--audit_only", *widths]) == 0
        audits.append(capsys.readouterr().out)
    assert audits[1] == audits[0] and audits[1]

    outs = {}
    for name, module in (("jax", jax_cli), ("port", cli)):
        outs[name] = str(tmp_path / f"{name}.ckpt")
        assert module.main(["convert_tf1", "--chkpnt_fn", prefix, "--output_fn", outs[name],
                            *widths]) == 0
    want, want_extra = jax_load_checkpoint(outs["jax"])
    got, got_extra = load_checkpoint(outs["port"])
    assert got_extra == want_extra == {"source": prefix}
    want_leaves, got_leaves = list(_leaves(want)), list(_leaves(got))
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves]
    for (name, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)

    golden = np.load(f"{FIXTURES}/{fixture}/golden.npz")
    model = ClairNet.from_jax(got, ModelConfig(lstm1_num_units=4, lstm2_num_units=4))
    with torch.no_grad():
        heads = model(torch.from_numpy(golden["x"]))
    for i, head in enumerate(heads):
        np.testing.assert_allclose(head.numpy(), golden[f"head{i}"], rtol=1e-5, atol=1e-6)


def test_convert_tf1_audit_fails_at_the_wrong_width(capsys):
    """Strict by default: the reference width against the 4-unit fixture."""
    for module in (jax_cli, cli):
        assert module.main(["convert_tf1", "--chkpnt_fn", f"{FIXTURES}/tf_real/model",
                            "--audit_only"]) == 1
    with pytest.raises(ValueError, match="structural audit"):
        cli.main(["convert_tf1", "--chkpnt_fn", f"{FIXTURES}/tf_real/model",
                  "--output_fn", "unused.ckpt"])


def test_plot_tensor_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    x = np.random.RandomState(0).randint(0, 40, (33, 8, 4))
    tensor_fn = tmp_path / "t.txt"
    tensor_fn.write_text(tensor_line_from("chr1", 42, "G" * 33, x) + "\n")
    assert cli.main(["plot_tensor", "--array_fn", str(tensor_fn),
                     "--name", str(tmp_path / "viz")]) == 0
    assert (tmp_path / "viz_chr1_42.png").stat().st_size > 1000


def test_the_port_has_every_jax_command_but_the_two_model_commands():
    """Since the model commands (variables, learning_rate_finder) came, every
    command of the JAX CLI, under its function's name."""
    assert set(cli.COMMANDS) == set(jax_cli.COMMANDS)
    assert all(cli.COMMANDS[k].__name__ == jax_cli.COMMANDS[k].__name__ for k in cli.COMMANDS)


def test_the_console_script_runs_the_port_entry():
    import subprocess
    import sys
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    assert scripts["clair-tpu-torch"] == "clair_tpu_torch.__main__:entry"
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; from clair_tpu_torch.__main__ import entry; "
         "sys.exit(entry())", "--help"], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-len(cli.COMMANDS):] == list(cli.COMMANDS)
