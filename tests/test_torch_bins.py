"""The port's bins against clair_tpu.data.bins: each package reads what the
other wrote, with LZ4S blocks and with zstd blocks (the codec a writer
takes where liblz4 is missing), LZ4S blocks are the same bytes, the tensor
text builds the same bin, and the port's EpochBatches yields the JAX
package's batches in the same order."""

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import clair_tpu.data.bins as jax_bins
from clair_tpu.data.tensor_stream import tensor_line_from
from clair_tpu.io import lz4
from clair_tpu_torch.data import bins

SEQ = "ACGTACGTACGTACGTAGGTACGTACGTACGTA"


def _arrays(n=40, seed=0):
    rs = np.random.RandomState(seed)
    xs = rs.randint(-60, 61, (n, 33, 8, 4)).astype(np.float32)  # packs as int16
    ys = np.zeros((n, 90), np.float32)
    ys[np.arange(n), rs.randint(0, 21, n)] = 1.0
    ys[np.arange(n), 21 + rs.randint(0, 3, n)] = 1.0
    ys[:, 24 + 16] = 1.0
    ys[:, 57 + 16] = 1.0
    pos = np.array([f"chr1:{100 + i}" for i in range(n)])
    return xs, ys, pos


def _dataset(module, xs, ys, pos, block):
    offs = range(0, len(xs), block)
    return module.BinDataset(
        len(xs),
        [module._pack(xs[o:o + block]) for o in offs],
        [module._pack(ys[o:o + block]) for o in offs],
        [module._pack(pos[o:o + block]) for o in offs],
        block,
    )


def _assert_same_contents(a, b):
    assert a.dataset_size == b.dataset_size and a.n_blocks == b.n_blocks
    assert a.block_size == b.block_size
    for i in range(a.n_blocks):
        for cast in (True, False):
            xa, xb = a.x_block(i, cast=cast), b.x_block(i, cast=cast)
            assert xa.dtype == xb.dtype
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(a.y_block(i, cast=cast), b.y_block(i, cast=cast))
        np.testing.assert_array_equal(a.pos_block(i), b.pos_block(i))


@pytest.fixture(params=["lz4s", "zstd"])
def codec(request, monkeypatch):
    """Both packages' writers pick the codec through clair_tpu.io.lz4."""
    if request.param == "zstd":
        monkeypatch.setattr(lz4, "available", lambda: False)
    return request.param


def _blocks_are(dataset, codec):
    magic = b"LZ4S" if codec == "lz4s" else b"\x28\xb5\x2f\xfd"  # zstd frame magic
    return all(blob[:4] == magic for blob in dataset.x_blocks + dataset.pos_blocks)


def test_port_reads_jax_written_bins(tmp_path, codec, monkeypatch):
    xs, ys, pos = _arrays()
    path = str(tmp_path / "jax.bin")
    jax_bins.write_bin(path, _dataset(jax_bins, xs, ys, pos, 8))
    monkeypatch.undo()  # read with liblz4 present
    got = bins.load_bin(path)
    assert _blocks_are(got, codec)
    _assert_same_contents(got, jax_bins.load_bin(path))
    np.testing.assert_array_equal(np.concatenate([got.x_block(i) for i in range(5)]), xs)
    assert got.x_block(0, cast=False).dtype == np.int16


def test_jax_reads_port_written_bins(tmp_path, codec, monkeypatch):
    xs, ys, pos = _arrays(seed=1)
    path = str(tmp_path / "port.bin")
    bins.write_bin(path, _dataset(bins, xs, ys, pos, 8))
    monkeypatch.undo()
    got = jax_bins.load_bin(path)
    assert _blocks_are(got, codec)
    _assert_same_contents(got, bins.load_bin(path))
    np.testing.assert_array_equal(np.concatenate([got.y_block(i) for i in range(5)]), ys)


def test_lz4s_blocks_are_the_same_bytes():
    xs, ys, pos = _arrays(seed=2)
    for array in (xs[:8], ys[:8], pos[:8], xs[:3] + 0.5):
        assert bins._pack(array) == jax_bins._pack(array)


def test_lz4s_block_without_liblz4_raises(monkeypatch):
    blob = bins._pack(_arrays(seed=3)[0][:4])
    assert blob[:4] == b"LZ4S"
    monkeypatch.setattr(lz4, "available", lambda: False)
    with pytest.raises(RuntimeError, match="liblz4"):
        bins._unpack(blob)


def test_refuses_what_is_no_clair_tpu_bin(tmp_path):
    import pickle

    path = tmp_path / "reference.bin"
    with open(path, "wb") as fh:
        for item in (8, [b"x"], [b"y"], [b"pos"]):   # the reference's 4 pickles
            pickle.dump(item, fh)
    with pytest.raises(ValueError, match="not a clair_tpu bin"):
        bins.load_bin(str(path))


def test_first_lz4_lookup_from_many_threads(monkeypatch):
    """The feed's decompress pool makes the first liblz4 lookup from several
    threads at once (clair_tpu.io.lz4 marks the library as looked for before
    loading it): every thread must find it and decode the block."""
    blob = bins._pack(_arrays(seed=7)[0][:4])
    want = bins._unpack(blob)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(10):
            monkeypatch.setattr(lz4, "_lib", None)
            monkeypatch.setattr(lz4, "_lib_checked", False)
            with ThreadPoolExecutor(16) as pool:
                outs = list(pool.map(lambda _: bins._unpack(blob), range(64)))
            for out in outs:
                np.testing.assert_array_equal(out, want)
    finally:
        sys.setswitchinterval(old)


def test_train_val_bins_and_text_build_match(tmp_path):
    xs, ys, pos = _arrays(seed=4)
    paths = [str(tmp_path / n) for n in ("train.bin", "val.bin")]
    bins.write_bin(paths[0], _dataset(bins, xs[:24], ys[:24], pos[:24], 8))
    bins.write_bin(paths[1], _dataset(bins, xs[24:], ys[24:], pos[24:], 8))
    got, want = bins.load_train_val_bins(*paths), jax_bins.load_train_val_bins(*paths)
    assert got.train_size_hint == want.train_size_hint == 24
    _assert_same_contents(got, want)

    rs = np.random.RandomState(5)
    tensor_path, var_path = tmp_path / "tensors.txt", tmp_path / "vars.txt"
    tensor_path.write_text("".join(
        tensor_line_from("chr1", 100 + i, SEQ, rs.randint(0, 20, (33, 8, 4))) + "\n"
        for i in range(10)))
    var_path.write_text("chr1 103 A G 0 1\n")
    args = (str(tensor_path), str(var_path))
    _assert_same_contents(bins.build_bin_from_tensors(*args, shuffle=False, block_size=4),
                          jax_bins.build_bin_from_tensors(*args, shuffle=False, block_size=4))


@pytest.mark.parametrize("order,n_train,train_bs,val_bs,workers,cast", [
    (np.arange(5), 36, 16, 3, 0, True),
    (np.array([3, 0, 4, 1, 2]), 32, 16, 4, 3, True),
    (np.array([4, 2, 0, 1, 3]), 40, 7, 5, 2, False),
    (np.array([1, 0, 2, 3, 4]), 8, 10, 12, 0, False),
])
def test_epoch_batches_match(order, n_train, train_bs, val_bs, workers, cast):
    xs, ys, pos = _arrays(seed=6)
    kwargs = dict(train_batch_size=train_bs, val_batch_size=val_bs,
                  decompress_workers=workers, cast_to_float32=cast)
    got = list(bins.EpochBatches(_dataset(bins, xs, ys, pos, 8), order, n_train, **kwargs))
    want = list(jax_bins.EpochBatches(_dataset(jax_bins, xs, ys, pos, 8), order, n_train,
                                      **kwargs))
    assert len(got) == len(want)
    for (xg, yg, tg), (xw, yw, tw) in zip(got, want):
        assert tg == tw and xg.dtype == xw.dtype and yg.dtype == yw.dtype
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)
