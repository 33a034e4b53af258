"""The port's commands that read a model without calling: forward_activations
against the JAX function name by name, ``call_var --activation_only``
against the JAX command's files, and ``variables`` against the JAX
command's stdout, on the CPU; the activation dump on the card (``cuda``)."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from clair_tpu import cli as jax_cli
from clair_tpu.models.clair import forward as jax_forward
from clair_tpu.models.clair import forward_activations as jax_forward_activations
from clair_tpu.models.clair import init_params as jax_init_params
from clair_tpu.params import ModelConfig as JaxModelConfig
from clair_tpu_torch import cli
from clair_tpu_torch.data.tensor_stream import tensor_line_from
from clair_tpu_torch.models.checkpoint import load_checkpoint, save_checkpoint
from clair_tpu_torch.models.clair import ClairNet, forward_activations
from clair_tpu_torch.ops.bilstm_stream import bilstm_stream
from clair_tpu_torch.params import ModelConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "examples", "ont_synthetic.ckpt")
NARROW = ModelConfig(lstm1_num_units=8, lstm2_num_units=8, l3_num_units=4,
                     l4_num_units=16, l5_num_units=8)
NAMES = ["input", "lstm1", "lstm2", "l3", "l4", "l5_1", "l5_2", "l5_3", "l5_4",
         "gt21", "genotype", "indel_length_1", "indel_length_2"]
# float32 on both sides, the same weights: the two packages sum in another
# order (XLA's scan against torch's matmuls), so each activation agrees
# within this many units of its largest magnitude
ACT_RTOL = 1e-5


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in tree.items()}


def _assert_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=ACT_RTOL * scale)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_activations_match_the_jax_function(compute_dtype):
    """The 14 names in the JAX order, each array within ACT_RTOL; like the
    JAX function the port computes in float32 whatever the model's dtype."""
    config = dataclasses.replace(NARROW, compute_dtype=compute_dtype)
    params = _numpy(jax_init_params(jax.random.PRNGKey(3), JaxModelConfig(**vars(config))))
    x = np.random.RandomState(4).rand(5, 33, 8, 4).astype(np.float32)
    want = jax_forward_activations(params, x, JaxModelConfig(**vars(config)))
    got = forward_activations(params, torch.from_numpy(x), config)
    assert list(got) == list(want) == NAMES
    for name in NAMES:
        assert got[name].dtype == torch.float32, name
        _assert_close(got[name].numpy(), np.asarray(want[name]))


def test_forward_activations_heads_equal_the_forward():
    """As tests/test_activations.py: the head activations are the float32
    forward's outputs, and the same of a ClairNet or its parameters."""
    config = dataclasses.replace(NARROW, compute_dtype="float32")
    params = _numpy(jax_init_params(jax.random.PRNGKey(0), JaxModelConfig(**vars(config))))
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 33, 8, 4).astype(np.float32))
    model = ClairNet.from_jax(params, config)
    acts = forward_activations(model, x)
    assert acts["input"].shape == (2, 33, 32)
    assert acts["lstm1"].shape == acts["lstm2"].shape == (2, 33, 16)
    assert acts["l3"].shape == (2, 4, 16) and acts["l4"].shape == (2, 16)
    with torch.inference_mode():
        out = model(x)
    for i, name in enumerate(("gt21", "genotype", "indel_length_1", "indel_length_2")):
        assert torch.equal(acts[name], out[i]), name
    again = forward_activations(params, x, config)
    assert all(torch.equal(again[k], acts[k]) for k in NAMES)
    np.testing.assert_allclose(acts["gt21"].numpy(),
                               np.asarray(jax_forward(params, x.numpy(),
                                                      JaxModelConfig(**vars(config)))[0]),
                               rtol=0, atol=ACT_RTOL)


def test_forward_activations_run_the_streaming_layer_whatever_the_flags():
    """use_pallas_bilstm picks another layer for the forward; the dump, as
    the JAX function's plain scan, runs the streaming layer (on the card,
    row 1) and gives the same arrays as without the flag."""
    params = _numpy(jax_init_params(jax.random.PRNGKey(1), JaxModelConfig(**vars(NARROW))))
    x = torch.from_numpy(np.random.RandomState(2).rand(3, 33, 8, 4).astype(np.float32))
    flagged = ClairNet.from_jax(params, dataclasses.replace(NARROW, use_pallas_bilstm=True))
    assert flagged.bilstm is not bilstm_stream
    plain = forward_activations(params, x, NARROW)
    other = forward_activations(flagged, x)
    assert all(torch.equal(plain[k], other[k]) for k in NAMES)


def _tensor_file(path, n, seed):
    rs = np.random.RandomState(seed)
    with open(path, "w") as fh:
        for i in range(n):
            seq = "".join(rs.choice(list("ACGT"), 33))
            print(tensor_line_from("chr1", 1000 + 7 * i, seq,
                                   rs.randint(0, 30, (33, 8, 4))), file=fh)


@pytest.mark.parametrize("max_plot", [5, 70])
def test_activation_only_writes_the_jax_commands_files(tmp_path, max_plot):
    """``call_var --activation_only`` on 70 sites (two batches of 64):
    the JAX command's file names and, in each, its arrays."""
    tensors = str(tmp_path / "tensors.txt")
    _tensor_file(tensors, 70, seed=max_plot)
    argv = ["call_var", "--activation_only", "--tensor_fn", tensors, "--chkpnt_fn", CKPT,
            "--max_plot", str(max_plot)]
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    assert jax_cli.main(argv + ["--log_path", str(want_dir)]) == 0
    cli.cmd_call_var(argv[1:] + ["--log_path", str(got_dir)], device="cpu")
    files = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == files and len(files) == min(max_plot, 70)
    for name in files:
        want, got = np.load(want_dir / name), np.load(got_dir / name)
        assert sorted(got.files) == sorted(want.files) == sorted(NAMES)
        for key in NAMES:
            assert got[key].shape == want[key].shape, (name, key)
            _assert_close(got[key], want[key])


@pytest.mark.parametrize("pattern", ["l4/.*", ".*"])
def test_variables_prints_the_jax_commands_bytes(tmp_path, capsys, pattern):
    """The same stdout byte for byte, on a narrow checkpoint (so that some
    arrays have at most 64 elements and print) and on a vendored one."""
    path = str(tmp_path / "m-000001")
    save_checkpoint(path, _numpy(jax_init_params(jax.random.PRNGKey(0),
                                                 JaxModelConfig(**vars(NARROW)))))
    outputs = []
    for ckpt in (path, CKPT):
        argv = ["variables", "--chkpnt_fn", ckpt, "-v", pattern]
        assert jax_cli.main(argv) == 0
        want = capsys.readouterr().out
        assert cli.main(argv) == 0
        got = capsys.readouterr().out
        assert got == want and want
        outputs.append(got)
    assert "l4/w (64, 16) mean=" in outputs[0]
    assert ("lstm1/bw/b (32,) mean=0.000000" in outputs[0]) == (pattern == ".*")


def test_variables_needs_no_device(tmp_path, capsys):
    path = str(tmp_path / "m-000001")
    save_checkpoint(path, _numpy(jax_init_params(jax.random.PRNGKey(0),
                                                 JaxModelConfig(**vars(NARROW)))))
    cli.main(["variables", "--chkpnt_fn", path, "-v", "head_genotype/b"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "head_genotype/b (3,) mean=0.000000 std=0.000000"
    assert out[1] == "[0. 0. 0.]"


@pytest.mark.cuda
def test_cuda_forward_activations_run_row_1_and_match_the_cpu(tmp_path):
    """On the card: row 1 launches twice a batch (float32) and every
    activation agrees with the plain version on the CPU; the command
    writes the files."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    params, _ = load_checkpoint(CKPT)
    x = torch.from_numpy(np.random.RandomState(5).randint(0, 40, (512, 33, 8, 4))
                         .astype(np.float32))
    before = bilstm_stream.launches
    card = forward_activations(params, x.cuda())
    assert bilstm_stream.launches == before + 2
    plain = forward_activations(params, x)
    for name in NAMES:
        scale = max(1.0, plain[name].abs().max().item())
        assert (card[name].cpu() - plain[name]).abs().max().item() <= 1e-4 * scale, name
    tensors = str(tmp_path / "tensors.txt")
    _tensor_file(tensors, 70, seed=1)
    before = bilstm_stream.launches
    cli.cmd_call_var(["--activation_only", "--tensor_fn", tensors, "--chkpnt_fn", CKPT,
                      "--max_plot", "70", "--log_path", str(tmp_path / "acts")])
    assert bilstm_stream.launches == before + 4
    assert len(os.listdir(tmp_path / "acts")) == 70
