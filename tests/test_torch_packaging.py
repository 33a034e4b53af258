"""Where the port writes what it builds, in a checkout and installed, and the
installed port itself (the counterpart of tests/test_packaging.py).

The rule (``clair_tpu_torch/build_root.py``): in a checkout, where the
package's parent holds pyproject.toml, the host library, the kernels'
libraries and the recipes' checkpoints go under
``<checkout>/build/clair_tpu_torch/``; installed, inside the package's own
``_build/``, never into a ``build/`` beside it in site-packages.

The slow test builds the wheel from a copy of the packaging files (no write
into the checkout), installs it into a fresh venv with no network
(``--no-index``, build isolation off, the host's packages through a ``.pth``
shim as tests/test_packaging.py does), and runs the installed port:
``clair-tpu-torch call_bam --help``, the kernel and host sources shipped as
package data, the host library built from the installed tree, and the
kernels' build directory resolved inside the package (the path only: there
is no nvcc here).
"""

import glob
import os
import shutil
import site
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGING_FILES = ("pyproject.toml", "README.md", "clair_tpu", "clair_tpu_torch")
# what an installed port prints about itself: its directory, the sources it
# ships, whether its host library loads and where each output directory is
REPORT = """
import os, sys
import clair_tpu_torch
from clair_tpu_torch import native
from clair_tpu_torch.examples import simulated
from clair_tpu_torch.ops import build
pkg = os.path.dirname(clair_tpu_torch.__file__)
print(pkg)
print(sorted(os.listdir(os.path.join(pkg, "csrc"))))
print(sorted(f for f in os.listdir(os.path.join(pkg, "native")) if f.endswith((".cpp", "Makefile"))))
print(native.available())
print(native._lib_path())
print(build.BUILD_DIR)
print(simulated.OUTPUT_DIR)
"""


def _run(cmd, **kw):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600, **kw)


def _copy_package(dst: Path) -> None:
    shutil.copytree(ROOT / "clair_tpu_torch", dst / "clair_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))


def test_checkout_layout_builds_under_the_checkouts_build_dir(tmp_path):
    from clair_tpu_torch.build_root import build_root

    assert build_root() == ROOT / "build" / "clair_tpu_torch"
    (tmp_path / "clair_tpu_torch").mkdir()
    (tmp_path / "pyproject.toml").write_text("[project]\n")
    assert build_root(tmp_path / "clair_tpu_torch") == tmp_path / "build" / "clair_tpu_torch"


def test_installed_layout_builds_inside_the_package(tmp_path):
    from clair_tpu_torch.build_root import build_root

    package = tmp_path / "site-packages" / "clair_tpu_torch"
    package.mkdir(parents=True)
    assert build_root(package) == package / "_build"


def test_the_three_output_directories_come_from_the_rule(tmp_path):
    """The port's package imported from a directory without pyproject.toml
    (as site-packages is): the host library's, the kernels' and the
    recipes' directories all lie in its _build/; from the checkout, in
    build/clair_tpu_torch/."""
    from clair_tpu_torch import native
    from clair_tpu_torch.examples import simulated
    from clair_tpu_torch.ops import build

    here = ROOT / "build" / "clair_tpu_torch"
    assert (Path(native._BUILD_DIR), build.BUILD_DIR, simulated.OUTPUT_DIR) == \
        (here / "native", here, here / "examples")

    _copy_package(tmp_path)
    script = ("import clair_tpu_torch.native as n, clair_tpu_torch.ops.build as b, "
              "clair_tpu_torch.examples.simulated as s; print(n._BUILD_DIR); "
              "print(b.BUILD_DIR); print(s.OUTPUT_DIR)")
    r = _run([sys.executable, "-c", script], cwd=str(tmp_path),
             env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-2000:]
    inside = tmp_path / "clair_tpu_torch" / "_build"
    assert [Path(p) for p in r.stdout.split()] == [inside / "native", inside, inside / "examples"]
    assert not (tmp_path / "build").exists()


@pytest.mark.slow
def test_installed_port_builds_inside_its_package(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in PACKAGING_FILES:
        if (ROOT / name).is_dir():
            shutil.copytree(ROOT / name, src / name,
                            ignore=shutil.ignore_patterns("__pycache__", "_build"))
        else:
            shutil.copy(ROOT / name, src / name)
    r = _run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-index",
              "--no-build-isolation", "-w", str(tmp_path), str(src)])
    assert r.returncode == 0, r.stderr[-2000:]
    wheels = glob.glob(str(tmp_path / "clair_tpu-*.whl"))
    assert len(wheels) == 1, wheels

    venv = tmp_path / "venv"
    r = _run([sys.executable, "-m", "venv", "--system-site-packages", str(venv)])
    assert r.returncode == 0, r.stderr[-2000:]
    vpy = str(venv / "bin" / "python")
    vsp = _run([vpy, "-c", "import site; print(site.getsitepackages()[0])"]).stdout.strip()
    host_sps = [p for p in site.getsitepackages() + sys.path
                if p.endswith("site-packages") and os.path.isdir(p)]
    with open(os.path.join(vsp, "_host_env.pth"), "w") as fh:
        fh.write("\n".join(dict.fromkeys(host_sps)) + "\n")
    r = _run([vpy, "-m", "pip", "install", "--no-deps", "--no-index", wheels[0]])
    assert r.returncode == 0, r.stderr[-2000:]

    # the console script answers
    script = venv / "bin" / "clair-tpu-torch"
    assert script.is_file() and os.access(script, os.X_OK)
    r = _run([str(script), "call_bam", "--help"], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "--bam_fn" in r.stdout and "--chkpnt_fn" in r.stdout

    # the installed package (not the checkout) ships its sources and builds
    # inside itself
    r = _run([vpy, "-c", REPORT], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    pkg, csrc, native_src, available, lib, kernels, recipes = r.stdout.strip().splitlines()[-7:]
    assert pkg == os.path.join(vsp, "clair_tpu_torch"), (pkg, vsp)
    want_csrc = sorted(p.name for p in (ROOT / "clair_tpu_torch" / "csrc").iterdir()
                       if p.suffix in (".cu", ".cuh"))
    assert csrc == str(want_csrc)
    want_native = sorted(p.name for p in (ROOT / "clair_tpu_torch" / "native").iterdir()
                         if p.suffix == ".cpp" or p.name == "Makefile")
    assert native_src == str(want_native)
    assert available == "True"
    inside = Path(pkg) / "_build"
    assert Path(lib).parent == inside / "native" and Path(lib).is_file()
    assert Path(kernels) == inside and Path(recipes) == inside / "examples"
    assert not (Path(vsp) / "build").exists()
