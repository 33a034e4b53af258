"""The port never imports JAX, nor the zstandard binding that the machine
with the card lacks: not its package, its CLI, its predictor, models,
losses, bins, training loop or any of its kernel wrappers (checked in a
fresh interpreter), and no file of it names jax in an import."""

import pathlib
import re
import subprocess
import sys

PORT = pathlib.Path(__file__).resolve().parent.parent / "clair_tpu_torch"

PROBE = """
import sys
import clair_tpu_torch, clair_tpu_torch.cli, clair_tpu_torch.__main__
import clair_tpu_torch.pipeline.call_var
import clair_tpu_torch.models.checkpoint, clair_tpu_torch.models.layers
import clair_tpu_torch.models.bilstm, clair_tpu_torch.models.clair
import clair_tpu_torch.ops.build, clair_tpu_torch.ops.bilstm_stream
import clair_tpu_torch.ops.bilstm_train, clair_tpu_torch.ops.bilstm
import clair_tpu_torch.ops.bilstm2
import clair_tpu_torch.io.zstd, clair_tpu_torch.data.bins
import clair_tpu_torch.models.losses, clair_tpu_torch.parallel.sharding
import clair_tpu_torch.pipeline.train, clair_tpu_torch.pipeline.evaluate
from clair_tpu_torch.models.checkpoint import load_checkpoint
load_checkpoint("examples/ont_synthetic.ckpt")
assert "torch" in sys.modules
print("jax" in sys.modules, "zstandard" in sys.modules,
      sorted(m for m in sys.modules if m.startswith(("jax", "zstandard"))))
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], capture_output=True, text=True,
        timeout=300, cwd=PORT.parent,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False False []"


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.MULTILINE)
    sources = sorted(PORT.rglob("*.py"))
    assert len(sources) >= 25
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
