"""Render the 4 channels of a 33x8 pileup tensor as heat maps (PNG), the
reference's plot_tensor visualizer (reference clair/plot_tensor.py)."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from clair_tpu_torch.data.tensor_stream import open_maybe_gzip, parse_tensor_line
from clair_tpu_torch.params import MATRIX_NUM

CHANNEL_NAMES = ("reference", "insertion", "deletion", "SNP")


def plot_tensor(tensor: np.ndarray, name: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(MATRIX_NUM, 1, figsize=(12, 8))
    for channel in range(MATRIX_NUM):
        ax = axes[channel]
        ax.imshow(tensor[:, :, channel].T, cmap="bwr", aspect="auto", vmin=-50, vmax=50)
        ax.set_ylabel(CHANNEL_NAMES[channel])
        ax.set_yticks(range(8))
        ax.set_yticklabels(list("ACGTacgt"))
    fig.tight_layout()
    fig.savefig(name + ".png", dpi=120)
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Visualize tensors as heat maps")
    parser.add_argument("--array_fn", default="PIPE", help="Tensor input, PIPE for stdin")
    parser.add_argument("--name", default="tensor", help="Output PNG name prefix")
    parser.add_argument("--max_plot", type=int, default=10)
    args = parser.parse_args(argv)

    plotted = 0
    with open_maybe_gzip(args.array_fn) as fh:
        for line in fh:
            if plotted >= args.max_plot >= 0:
                break
            info, tensor = parse_tensor_line(line)
            plot_tensor(tensor, f"{args.name}_{info[0]}_{info[1]}")
            plotted += 1
    print(f"plotted {plotted} tensors", file=sys.stderr)


if __name__ == "__main__":
    main()
