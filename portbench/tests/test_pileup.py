"""The seed makes the same bin twice, and another bin for another seed."""

import numpy as np
import torch

from portbench import harness
from portbench.kinds.train import pack_bin, seeds
from portbench.pileup import make_rows

PROFILE = harness.load_traffic("train-b10k")["pileup"]
CPU = torch.device("cpu")


def rows(seed, n=1000):
    x, y = make_rows(n, PROFILE, torch.Generator().manual_seed(seeds(seed)["rows"]), CPU)
    return x.numpy(), y.numpy()


def test_same_seed_same_bin():
    (x1, y1), (x2, y2) = rows(2**31 + 11), rows(2**31 + 11)
    assert np.array_equal(x1, x2) and np.array_equal(y1, y2)
    b1, b2 = pack_bin(x1, y1), pack_bin(x2, y2)
    assert b1.x_blocks == b2.x_blocks and b1.y_blocks == b2.y_blocks
    assert b1.dataset_size == 1000 and b1.n_blocks == 2


def test_other_seed_other_bin():
    (x1, y1), (x2, y2) = rows(5), rows(6)
    assert not np.array_equal(x1, x2) and not np.array_equal(y1, y2)


def test_rows_look_like_pileup():
    x, y = rows(7, 4000)
    assert x.dtype == np.int16 and x.shape == (4000, 33, 8, 4)
    # every label row: one class in each of the four heads' spans
    for a, b in ((0, 21), (21, 24), (24, 57), (57, 90)):
        assert (y[:, a:b].sum(1) == 1).all()
    # channel 0 holds the matched reads at the reference base's row: depth
    # about 50 at each position, split between the strands
    depth = x[..., 0].sum(axis=2)
    assert 40 < depth.mean() < 50
    assert abs(x[:, :, :4, 0].sum() / x[..., 0].sum() - 0.5) < 0.01
    # half the sites carry no variant (genotype 0/0)
    assert abs(y[:, 21].mean() - 0.5) < 0.05


def test_bin_reads_back_through_the_port_feed():
    from clair_tpu_torch.data.bins import EpochBatches

    x, y = rows(8, 1500)
    dataset = pack_bin(x, y)
    batches = list(EpochBatches(dataset, np.arange(dataset.n_blocks), 1500, 600, 300,
                                decompress_workers=2, cast_to_float32=False))
    assert [len(b[0]) for b in batches] == [600, 600, 300]
    assert np.array_equal(np.concatenate([b[0] for b in batches]), x)
    assert np.array_equal(np.concatenate([b[1] for b in batches]), y)
