import sys

from clair_tpu.__main__ import _export_thread_cap


def entry() -> int:
    """``python -m clair_tpu_torch``: honours ``--threads N`` before numpy
    and torch size their thread pools, as the JAX entry point does."""
    _export_thread_cap()
    from clair_tpu_torch.cli import main

    return main()


if __name__ == "__main__":
    sys.exit(entry())
