"""Where the port writes what it builds or makes at run time: the host
library (``native/``), the CUDA kernels' libraries (``ops/build.py``) and
the recipes' checkpoints (``examples/simulated.py``).

In a checkout, where the package's parent holds ``pyproject.toml``, that is
``<checkout>/build/clair_tpu_torch/``, which ``.gitignore`` lists. Installed
(from the wheel), the package's parent is ``site-packages``, shared with
every other package, so the output goes inside the package's own directory,
``clair_tpu_torch/_build/``, as the JAX package builds its library inside
its own directory.
"""

from __future__ import annotations

from pathlib import Path

PACKAGE = Path(__file__).resolve().parent


def build_root(package: Path = PACKAGE) -> Path:
    """The port's output directory for the package at ``package``."""
    if (package.parent / "pyproject.toml").is_file():
        return package.parent / "build" / package.name
    return package / "_build"
