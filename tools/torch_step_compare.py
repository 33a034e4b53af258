"""The port's full-width train step at batch 10,000 in two trees on one
card, in turns: this tree and another commit's unpacked checkout (parent,
this, this, parent), each in a process of its own, through each tree's
chip_smoke.train_step_times on examples/ont_production.ckpt.

    python3 tools/torch_step_compare.py --parent DIR [--dtypes float32,bfloat16]

Prints each run's ms per step (host clock over 5 synchronized steps after a
warm-up step) and the card's name and power limit. Needs a CUDA card.
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
print(json.dumps({d: chip_smoke.train_step_times(params, torch.device("cuda"), d)[0]
                  for d in sys.argv[1].split(",")}))
"""


def run(tree: Path, dtypes: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", STEP, dtypes], cwd=tree, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True)
    parser.add_argument("--dtypes", default="float32,bfloat16")
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    parent = Path(args.parent).resolve()
    for label, tree in (("parent", parent), ("this tree", ROOT), ("this tree", ROOT),
                        ("parent", parent)):
        ms = run(tree, args.dtypes)
        print(f"{label}: " + ", ".join(f"{d} {v:.2f} ms" for d, v in ms.items()), flush=True)


if __name__ == "__main__":
    main()
