"""The port's own copy of the host side against the JAX package's, on the CPU
and the same seeded inputs: every copied module has its original's public
names; the parameters are the same; the native library builds from the
port's sources into build/; both simulators write the same genome; the two
pileups give the same window tensors bit for bit (native engine, Python
engine, reference-parity tensors, gVCF); and the port's call_bam with its
plain kernels makes the JAX call_bam's decisions."""

import dataclasses
import importlib
import os
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "examples" / "ont_synthetic.ckpt")
# each copy of clair_tpu/<path>.py and the public names only it has
COPIED = {
    "params": set(), "task": set(), "task.genotype": set(), "task.gt21": set(),
    "task.variant_length": set(), "task.labels": set(), "utils": set(),
    "utils.genomics": set(), "utils.intervals": set(), "utils.simulate": set(),
    "io.lz4": set(), "io.vcf": set(), "io.fasta": set(), "io.bam": set(), "io.rans": set(),
    "io.cram": set(), "io.tbi": set(), "io.bai": set(), "io.bgzf": set(), "io.arith": set(),
    "io.fqzcomp": set(), "io.rans4x16": set(), "io.tok3": set(),
    "native": {"BUILD_SECONDS", "BUILD_ERROR"},
    "data": set(), "data.tensor_stream": set(), "data.candidates": set(),
    "data.pileup": set(), "data.truth": set(),
    "pipeline.schedules": set(), "pipeline.decode": set(), "pipeline.batch_decode": set(),
    "pipeline.gvcf": set(), "pipeline.work_queue": set(), "pipeline.call_bam": set(),
    "pipeline.call_bam_parallel": set(),
    "data.pairing": set(), "data.transform": set(), "post": set(), "post.overlap_variant": set(),
    "post.ensemble": set(), "post.gvcf_merge": set(), "io.sam": set(), "io.tfckpt": set(),
    "models.audit": set(), "models.convert_tf1": set(), "plot_tensor": set(),
}
# QUAL = (10*log10(p / (1 - p)) + 16)^2: float32 does not resolve it above
# 3000 (tests/test_torch_predictor.py)
QUAL_RESOLVED = 3000


def _public(module):
    return {k for k, v in vars(module).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("name", sorted(COPIED))
def test_copy_has_the_public_names_of_its_original(name):
    port = importlib.import_module(f"clair_tpu_torch.{name}")
    ref = importlib.import_module(f"clair_tpu.{name}")
    assert _public(port) == _public(ref) | COPIED[name]


def test_params_match_the_jax_package():
    """ModelConfig's fields and defaults, and every constant."""
    from clair_tpu import params as ref
    from clair_tpu_torch import params as port

    fields = [(f.name, f.default, f.default_factory) for f in dataclasses.fields(port.ModelConfig)]
    assert fields == [(f.name, f.default, f.default_factory)
                      for f in dataclasses.fields(ref.ModelConfig)]
    assert dataclasses.asdict(port.ModelConfig()) == dataclasses.asdict(ref.ModelConfig())
    constants = {k: v for k, v in vars(port).items() if k.isupper()}
    assert constants == {k: v for k, v in vars(ref).items() if k.isupper()}
    assert len(constants) > 30


def test_native_library_builds_from_the_port_sources():
    """The port's library is built from its own sources into
    build/clair_tpu_torch/native/, under a name that carries their hash;
    none lies in the package."""
    from clair_tpu_torch import native

    assert native.available()
    path = Path(native._lib_path())
    assert path.parent == ROOT / "build" / "clair_tpu_torch" / "native"
    assert path.is_file() and path.name.startswith("libclair_native-")
    assert not list((ROOT / "clair_tpu_torch" / "native").glob("*.so"))
    assert sorted(p.name for p in (ROOT / "clair_tpu_torch" / "native").glob("*.cpp")) == \
        sorted(p.name for p in (ROOT / "clair_tpu" / "native").glob("*.cpp"))


def test_native_library_rebuilds_an_unloadable_artifact(tmp_path, monkeypatch):
    """A file under the library's name that does not load (a partial build,
    or one made on another machine) is rebuilt once, and the new library
    loads with every symbol bound."""
    from clair_tpu_torch import native

    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    path = Path(native._lib_path())
    path.write_bytes(b"not a shared library")
    assert native.load_library() is not None
    assert path.stat().st_size > 10_000 and native.BUILD_SECONDS is not None
    assert not list(tmp_path.glob("*.tmp"))


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """A 3 kb genome with planted variants and ONT reads, written by the
    port's simulator, and the same written by the JAX package's."""
    from clair_tpu.utils import simulate as ref_sim
    from clair_tpu_torch.utils import simulate as port_sim

    root = tmp_path_factory.mktemp("host")
    paths = {}
    for name, sim in (("port", port_sim), ("jax", ref_sim)):
        recipe = sim.PLATFORM_RECIPES["ont"]
        rs = np.random.RandomState(77)
        reference = sim.random_reference(rs, 3_000)
        variants = sim.plant_variants(rs, reference, n_variants=12, spacing=200)
        fasta, bam = str(root / f"{name}.fa"), str(root / f"{name}.bam")
        sim.write_fasta(fasta, reference)
        sim.simulate_bam(bam, reference, variants, rs, coverage=recipe["coverage"],
                         read_length=recipe["read_length"],
                         read_length_sigma=recipe["read_length_sigma"],
                         error_profile=getattr(sim, recipe["profile_name"]))
        paths[name] = (fasta, bam)
    return root, paths


def test_both_simulators_write_the_same_genome(genome):
    _, paths = genome
    for port_path, jax_path in zip(paths["port"], paths["jax"]):
        assert Path(port_path).read_bytes() == Path(jax_path).read_bytes()


def _configs(genome, **flags):
    from clair_tpu.pipeline.call_bam import CallBamConfig as JaxCallBamConfig
    from clair_tpu_torch.pipeline.call_bam import CallBamConfig

    _, paths = genome
    fasta, bam = paths["port"]
    config = CallBamConfig(bam_path=bam, fasta_path=fasta, contig="chr1", minimum_af=0.2,
                           **flags)
    return config, JaxCallBamConfig(**dataclasses.asdict(config))


@pytest.mark.parametrize("case", ["native", "python", "left_edge", "gvcf"])
def test_pileup_windows_match_the_jax_package(case, genome, monkeypatch):
    """prepare_window of both packages on one simulated BAM region: the
    same candidate centers, sequences and window tensors, bit for bit, with
    the native engines, with both forced onto their Python engines, in the
    reference-parity tensor mode, and with the gVCF block data."""
    import clair_tpu.native as ref_native
    from clair_tpu.pipeline.call_bam import prepare_window as ref_prepare
    from clair_tpu_torch import native as port_native
    from clair_tpu_torch.pipeline.call_bam import prepare_window

    if case == "python":
        for module in (port_native, ref_native):
            monkeypatch.setattr(module, "_lib", None)
            monkeypatch.setattr(module, "_build_failed", True)
    assert port_native.available() == ref_native.available() == (case != "python")
    flags = {"left_edge": {"stop_consider_left_edge": True}, "gvcf": {"gvcf": True}}
    config, ref_config = _configs(genome, **flags.get(case, {}))
    got, want = prepare_window(config), ref_prepare(ref_config)
    assert len(got.centers) > 10
    assert got.tensors.dtype == want.tensors.dtype
    np.testing.assert_array_equal(got.tensors, want.tensors)
    np.testing.assert_array_equal(got.centers, want.centers)
    assert list(got.sequences) == list(want.sequences)
    assert got.contigs == want.contigs
    if case == "gvcf":
        assert got.gvcf_data is not None
        for a, b in zip(got.gvcf_data, want.gvcf_data):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _rows(path):
    return [r.rstrip("\n").split("\t") for r in open(path) if not r.startswith("#")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_call_bam_makes_the_jax_decisions(dtype, genome):
    """The port's call_bam with its Predictor on the CPU (the plain
    kernels) against the JAX call_bam with the JAX Predictor, float32:
    identical (CHROM, POS, REF, ALT, GT); QUAL within 1 where float32
    resolves it. A bfloat16 port run makes the same decisions too (the
    JAX package's guard for its calling default, tests/test_bf16.py)."""
    from clair_tpu.models.checkpoint import load_checkpoint as ref_load
    from clair_tpu.params import ModelConfig as JaxModelConfig
    from clair_tpu.pipeline.call_bam import call_bam as ref_call_bam
    from clair_tpu.pipeline.call_var import Predictor as JaxPredictor
    from clair_tpu_torch.models.checkpoint import load_checkpoint
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.pipeline.call_bam import call_bam
    from clair_tpu_torch.pipeline.call_var import Predictor

    root, _ = genome
    config, ref_config = _configs(genome)
    want, got = str(root / f"jax_{dtype}.vcf"), str(root / f"port_{dtype}.vcf")
    ref_call_bam(ref_config, JaxPredictor(ref_load(CKPT)[0], JaxModelConfig(), batch_size=64),
                 output_path=want)
    call_bam(config, Predictor(load_checkpoint(CKPT)[0], ModelConfig(compute_dtype=dtype),
                               batch_size=64, device="cpu"), output_path=got)
    got_rows, want_rows = _rows(got), _rows(want)
    assert len(got_rows) == len(want_rows) > 5
    for g, w in zip(got_rows, want_rows):
        assert (g[0], g[1], g[3], g[4], g[9].split(":")[0]) == \
               (w[0], w[1], w[3], w[4], w[9].split(":")[0])
        if dtype == "float32":
            qual_g, qual_w = float(g[5]), float(w[5])
            assert abs(qual_g - qual_w) <= 1.0 or min(qual_g, qual_w) > QUAL_RESOLVED, (g, w)
    assert os.path.getsize(got) > 0
