import os
import sys


def _export_thread_cap() -> None:
    """Honor ``--threads N`` before numpy/torch initialize their pools.

    numpy (via OpenBLAS/MKL) and torch size their thread pools from
    ``OMP_NUM_THREADS`` at import time, mirroring the reference's pre-exec
    clamping (reference call_var.py:176-189).  argparse runs far too late
    for that, so the entry point scans argv directly.
    """
    argv = sys.argv[1:]
    for i, a in enumerate(argv):
        if a == "--threads" and i + 1 < len(argv):
            val = argv[i + 1]
        elif a.startswith("--threads="):
            val = a.split("=", 1)[1]
        else:
            continue
        if val.isdigit() and int(val) > 0:
            os.environ.setdefault("OMP_NUM_THREADS", val)
        return


def entry() -> int:
    """``python -m clair_tpu_torch``: honours ``--threads N`` before numpy
    and torch size their thread pools, as the JAX entry point does."""
    _export_thread_cap()
    from clair_tpu_torch.cli import main

    return main()


if __name__ == "__main__":
    sys.exit(entry())
