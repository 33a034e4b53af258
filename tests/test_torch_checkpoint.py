"""The port's checkpoint IO against clair_tpu.models.checkpoint: every
vendored checkpoint loads to the same arrays, each package reads what the
other wrote, and both write the same bytes for the same parameters."""

import numpy as np
import pytest
import torch

from clair_tpu.models import checkpoint as jax_ckpt
from clair_tpu_torch.io import zstd
from clair_tpu_torch.models import checkpoint as port_ckpt

VENDORED = [
    "examples/ont_synthetic.ckpt",
    "examples/ccs_synthetic.ckpt",
    "examples/ilmn_synthetic.ckpt",
    "examples/ont_production.ckpt",
]


def _assert_trees_equal(a, b):
    assert isinstance(a, dict) and isinstance(b, dict)
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _small_tree(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "lstm1": {"fw": {"w": rs.randn(4, 8).astype(np.float32),
                         "b": np.zeros(8, np.float32)},
                  "bw": {"w": rs.randn(4, 8).astype(np.float32),
                         "b": np.ones(8, np.float32)}},
        "head": {"w": rs.randn(8, 3).astype(np.float32), "b": rs.randn(3).astype(np.float32)},
    }


@pytest.mark.parametrize("path", VENDORED)
def test_vendored_checkpoints_load_identically(path):
    want_params, want_extra = jax_ckpt.load_checkpoint(path)
    got_params, got_extra = port_ckpt.load_checkpoint(path)
    _assert_trees_equal(got_params, want_params)
    assert got_extra == want_extra


def test_port_writes_what_jax_reads(tmp_path):
    tree = _small_tree()
    path = str(tmp_path / "port.ckpt")
    port_ckpt.save_checkpoint(path, tree, {"epoch": 3})
    params, extra = jax_ckpt.load_checkpoint(path)
    _assert_trees_equal(params, tree)
    assert extra == {"epoch": 3}


def test_jax_writes_what_port_reads(tmp_path):
    tree = _small_tree(1)
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(path, tree, {"epoch": 7})
    params, extra = port_ckpt.load_checkpoint(path)
    _assert_trees_equal(params, tree)
    assert extra == {"epoch": 7}


def test_same_bytes_from_numpy_and_from_torch_leaves(tmp_path):
    """Byte-compatible: both packages write the same magic and the same
    pickled payload for the same parameters, whether the port is handed
    numpy arrays or torch tensors (the zstd frames around it may differ
    between zstd library versions)."""
    def as_torch(node):
        return {k: as_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
                for k, v in node.items()}

    tree = _small_tree(2)
    torch_tree = as_torch(tree)
    paths = [str(tmp_path / n) for n in ("jax.ckpt", "port_np.ckpt", "port_torch.ckpt")]
    jax_ckpt.save_checkpoint(paths[0], tree, {"epoch": 1})
    port_ckpt.save_checkpoint(paths[1], tree, {"epoch": 1})
    port_ckpt.save_checkpoint(paths[2], torch_tree, {"epoch": 1})
    blobs = [open(p, "rb").read() for p in paths]
    assert {b[:10] for b in blobs} == {b"CLTPUCKPT1"}
    payloads = [zstd.decompress(b[10:]) for b in blobs]
    assert payloads[1] == payloads[0] and payloads[2] == payloads[0]


def test_rejects_a_file_without_the_magic(tmp_path):
    path = tmp_path / "not.ckpt"
    path.write_bytes(b"NOTACKPT00" + b"\0" * 16)
    with pytest.raises(ValueError, match="not a clair_tpu checkpoint"):
        port_ckpt.load_checkpoint(str(path))


@pytest.mark.parametrize("prefix,epoch", [("model", 0), ("/tmp/run/m", 42), ("a-b", 123456)])
def test_checkpoint_path_naming_matches(prefix, epoch):
    path = port_ckpt.checkpoint_path(prefix, epoch)
    assert path == jax_ckpt.checkpoint_path(prefix, epoch)
    assert port_ckpt.epoch_from_path(path) == jax_ckpt.epoch_from_path(path) == epoch
    with pytest.raises(ValueError):
        port_ckpt.epoch_from_path(prefix)
