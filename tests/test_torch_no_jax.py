"""The port stands alone: no file of it, and not chip_smoke.py, imports the
JAX package or JAX (checked on the sources), and in a fresh interpreter
that imports every module of the port and runs its call_bam on the CPU
over a tiny simulated genome, no module of the JAX package, no jax and no
zstandard binding (the machine with the card lacks it) is loaded."""

import ast
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "clair_tpu_torch"

PROBE = """
import pkgutil, sys, tempfile
import numpy as np
import clair_tpu_torch
modules = [m.name for m in pkgutil.walk_packages(clair_tpu_torch.__path__, "clair_tpu_torch.")]
for name in modules:
    __import__(name)
from clair_tpu_torch.models.checkpoint import load_checkpoint
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline.call_bam import CallBamConfig, call_bam
from clair_tpu_torch.pipeline.call_var import Predictor
from clair_tpu_torch.utils import simulate
with tempfile.TemporaryDirectory() as tmp:
    rs = np.random.RandomState(5)
    reference = simulate.random_reference(rs, 2_000)
    variants = simulate.plant_variants(rs, reference, n_variants=6, spacing=200)
    simulate.write_fasta(tmp + "/ref.fa", reference)
    simulate.simulate_bam(tmp + "/reads.bam", reference, variants, rs, coverage=30,
                          read_length=600)
    config = CallBamConfig(bam_path=tmp + "/reads.bam", fasta_path=tmp + "/ref.fa",
                           contig="chr1", minimum_af=0.2)
    predictor = Predictor(load_checkpoint("examples/ont_synthetic.ckpt")[0], ModelConfig(),
                          batch_size=32, device="cpu")
    sites = call_bam(config, predictor, output_path=tmp + "/calls.vcf")
    rows = [r for r in open(tmp + "/calls.vcf") if not r.startswith("#")]
assert "torch" in sys.modules and len(modules) > 50 and sites > 0 and rows, (sites, rows)
loaded = sorted(m for m in sys.modules
                if m in ("clair_tpu", "jax", "zstandard")
                or m.startswith(("clair_tpu.", "jax.", "zstandard.")))
print(loaded)
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], capture_output=True, text=True,
        timeout=600, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.MULTILINE)
    sources = _sources()
    assert len(sources) >= 60
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []


def _jax_package_imports(path):
    """(line, module) of every import of clair_tpu or clair_tpu.* in a file,
    at any depth (inside functions too); strings and docstrings may name
    the JAX files."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n == "clair_tpu" or n.startswith("clair_tpu.")]
    return found


def test_no_port_source_imports_the_jax_package():
    offenders = {str(p.relative_to(ROOT)): hits for p in _sources()
                 if (hits := _jax_package_imports(p))}
    assert offenders == {}


def test_the_import_scan_sees_a_jax_package_import(tmp_path):
    """The AST scan flags plain, dotted, aliased and function-level imports
    and leaves the port's own package and strings alone."""
    probe = tmp_path / "probe.py"
    probe.write_text('"""from clair_tpu import cli"""\n'
                     "import clair_tpu_torch.cli\n"
                     "import clair_tpu\n"
                     "from clair_tpu.params import ModelConfig\n"
                     "def f():\n"
                     "    import clair_tpu.io.bam as bam\n"
                     "    from clair_tpu import native\n")
    assert [n for _, n in _jax_package_imports(probe)] == [
        "clair_tpu", "clair_tpu.params", "clair_tpu.io.bam", "clair_tpu"]
