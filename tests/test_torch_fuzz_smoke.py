"""Bounded run of tools/torch_fuzz_native.py: the port's own decoders and
native library (clair_tpu_torch/io, clair_tpu_torch/native) under the
crash-freedom gate that tests/test_fuzz_smoke.py keeps for the JAX
package's copies. Seed 5 is the seed whose container tier found the
round-3 heap overflow in clair_region_open2 (block_size trusted before the
record geometry check); each tier runs 4 iterations in a subprocess, so a
decoder that crashes aborts the subprocess, not the suite."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("tier,iters", [("codec", 4), ("container", 4), ("slice", 4)])
def test_torch_fuzz_smoke_survives(tier, iters):
    from clair_tpu_torch import native

    if not native.available():
        pytest.skip("the port's native library is unavailable")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_fuzz_native.py"),
         "--seed", "5", "--iters", str(iters), "--tier", tier],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert r.returncode == 0, (r.returncode, r.stdout[-2000:], r.stderr[-2000:])
    assert "DONE" in r.stdout
    # the tier ran on the port's library, and reached its decoders
    assert "survived" in r.stdout and "nothing captured" not in r.stdout
