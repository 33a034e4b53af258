"""The port's full-width train step at batch 10,000 in two trees on one
card, in turns: this tree and another commit's unpacked checkout (parent,
this, this, parent, ``--rounds`` times), each in a process of its own,
timing each tree's chip_smoke.full_width_step on
examples/ont_production.ckpt by CUDA events (chip_smoke.cuda_ms: the mean
of ``--iters`` steps after a warm-up step).

    python3 tools/torch_step_compare.py --parent DIR [--dtypes float32,bfloat16]
                                        [--train_pair] [--kernels] [--rounds 1]
                                        [--iters 10]

``--train_pair`` times the step under ``use_pallas_train_bilstm`` (the
resident train pair, float32 only) instead of the streaming pair.
``--kernels`` times, in the same turns, the kernels at the shapes of
chip_smoke.py's kernel line (CUDA events, mean of 5 calls after a warm-up,
through each tree's own wrappers): the two backwards (B = 10,000, both
layers, dx for lstm2 only), row 6 in float32 and row 2 in bfloat16 and
float32; the resident forward (row 5, float32, both layers) at B = 10,000
and at B = 512; bilstm2 (row 4, float32), the streaming forward (row 1,
bfloat16, both layers; and float32, both layers, at B = 512 and, with c,
at B = 10,000) and the recurrence on precomputed projections (row
3, both layers in the bf16 calling default's dtype pairs: lstm1 xw and U
bf16, lstm2 xw float32 and U bf16) at B = 512; and the model's calling
forward on examples/ont_production.ckpt at B = 512 in bfloat16, streaming
and under use_pallas_bilstm.
Prints each run's ms and the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

STEP = """
import json, sys, torch
import chip_smoke
from clair_tpu_torch.models.checkpoint import load_checkpoint
params, _ = load_checkpoint("examples/ont_production.ckpt")
flags, iters = json.loads(sys.argv[2]), int(sys.argv[3])
print(json.dumps({d: chip_smoke.cuda_ms(
    chip_smoke.full_width_step(params, torch.device("cuda"), d, **flags), iters)
    for d in sys.argv[1].split(",")}))
"""

KERNELS = """
import json, numpy as np, torch
import chip_smoke as cs
from clair_tpu_torch.ops.bilstm import bilstm_recurrence
from clair_tpu_torch.ops.bilstm2 import bilstm2
from clair_tpu_torch.ops.bilstm_stream import _forward, _stack_params, bilstm_stream_backward
from clair_tpu_torch.ops.bilstm_train import bilstm_train_backward, bilstm_train_forward
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
ms = {"row 6 float32": 0.0, "row 2 bfloat16": 0.0, "row 2 float32": 0.0,
      "row 5 float32": 0.0, "row 5 float32 B=512": 0.0, "row 1 bfloat16 B=512": 0.0,
      "row 1 float32 B=512": 0.0, "row 1 float32": 0.0, "row 3 bfloat16 B=512": 0.0}
for feat in (32, 256):
    p_dtype, x_dtype = cs.PRECOMPUTED_DTYPES[1 if feat == 32 else 2]
    xw, u16 = cs.precomputed_inputs((512, 33, feat, 128), dev, p_dtype, x_dtype, feat + 6)
    ms["row 3 bfloat16 B=512"] += cs.cuda_ms(lambda: bilstm_recurrence(xw, u16))
    for batch, key in ((10000, "row 5 float32"), (512, "row 5 float32 B=512")):
        xs, w, u, b, _ = cs.stacked_inputs((batch, 33, feat, 128), dev, feat + 5)
        ms[key] += cs.cuda_ms(lambda: bilstm_train_forward(xs, w, u, b), 5 if batch > 512 else 20)
    rs = np.random.RandomState(feat)
    w, u, b = _stack_params(cs.lstm_params(rs, feat, 128, dev), torch.bfloat16)
    x = torch.tensor(rs.randn(512, 33, feat), dtype=torch.bfloat16, device=dev)
    ms["row 1 bfloat16 B=512"] += cs.cuda_ms(lambda: _forward(x, w, u, b, with_cell=False))
    w, u, b = _stack_params(cs.lstm_params(rs, feat, 128, dev), torch.float32)
    for batch, key in ((512, "row 1 float32 B=512"), (10000, "row 1 float32")):
        x = torch.tensor(rs.randn(batch, 33, feat), dtype=torch.float32, device=dev)
        ms[key] += cs.cuda_ms(lambda: _forward(x, w, u, b, with_cell=batch > 512),
                              5 if batch > 512 else 20)
    need_dx = feat != 32  # lstm1's input takes no gradient
    xs, w, u, b, dh = cs.stacked_inputs((10000, 33, feat, 128), dev, feat + 5)
    h, c = bilstm_train_forward(xs, w, u, b)
    ms["row 6 float32"] += cs.cuda_ms(
        lambda: bilstm_train_backward(xs, w, u, b, h, c, dh, need_dx=need_dx), 5)
    rs = np.random.RandomState(feat + 3)
    p = cs.lstm_params(rs, feat, 128, dev)
    x = torch.tensor(rs.randn(10000, 33, feat), dtype=torch.float32, device=dev)
    dh32 = torch.tensor(rs.randn(10000, 33, 256), dtype=torch.float32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        w, u, b = _stack_params(p, dtype)
        xd, dhd = x.to(dtype), dh32.to(dtype)
        h, c = _forward(xd, w, u, b, with_cell=True)
        ms[f"row 2 {str(dtype)[6:]}"] += cs.cuda_ms(
            lambda: bilstm_stream_backward(xd, w, u, b, h, c, dhd, need_dx=need_dx), 5)
rs = np.random.RandomState(9)
p1, p2 = cs.lstm_params(rs, 32, 128, dev), cs.lstm_params(rs, 256, 128, dev)
x = torch.tensor(rs.randn(512, 33, 32), dtype=torch.float32, device=dev)
with torch.no_grad():
    ms["row 4 float32 B=512"] = cs.cuda_ms(lambda: bilstm2(p1, p2, x))
from clair_tpu_torch.models.checkpoint import load_checkpoint
from clair_tpu_torch.models.clair import ClairNet
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline.call_var import _device_input
params, _ = load_checkpoint("examples/ont_production.ckpt")
xu = torch.from_numpy(np.random.RandomState(8).randint(0, 40, (512, 33, 8, 4)).astype(np.uint8)).to(dev)
for name, flags in (("streaming", {}), ("use_pallas_bilstm", {"use_pallas_bilstm": True})):
    model = ClairNet.from_jax(params, ModelConfig(compute_dtype="bfloat16", **flags), dev)
    with torch.inference_mode():
        ms[f"forward bfloat16 B=512 {name}"] = cs.cuda_ms(lambda: model(_device_input(xu)))
print(json.dumps(ms))
"""


def run(tree: Path, script: str, *argv: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", script, *argv], cwd=tree, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True)
    parser.add_argument("--dtypes", default="float32,bfloat16")
    parser.add_argument("--train_pair", action="store_true",
                        help="the step under use_pallas_train_bilstm (float32)")
    parser.add_argument("--kernels", action="store_true",
                        help="also time rows 1 to 6 at the kernel line's shapes")
    parser.add_argument("--rounds", type=int, default=1,
                        help="turns of parent, this, this, parent")
    parser.add_argument("--iters", type=int, default=10, help="steps timed a turn")
    args = parser.parse_args()
    dtypes, flags = args.dtypes, {}
    if args.train_pair:
        dtypes, flags = "float32", {"use_pallas_train_bilstm": True}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    pair = "train pair" if args.train_pair else "streaming pair"
    parent = Path(args.parent).resolve()
    turns = (("parent", parent), ("this tree", ROOT), ("this tree", ROOT), ("parent", parent))
    for label, tree in turns * args.rounds:
        ms = run(tree, STEP, dtypes, json.dumps(flags), str(args.iters))
        print(f"{label}: step ({pair}) " + ", ".join(f"{d} {v:.2f} ms" for d, v in ms.items()),
              flush=True)
        if args.kernels:
            ms = run(tree, KERNELS)
            print(f"{label}: kernels " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()),
                  flush=True)


if __name__ == "__main__":
    main()
