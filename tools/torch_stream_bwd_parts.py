"""Row 2 of the port's kernel table, the streaming BiLSTM backward
(clair_tpu_torch/csrc/bilstm_stream_bwd.cu), split into its kernels on the
card: the device time of each kernel that ``bilstm_stream_backward`` runs
(torch.profiler's key_averages), per layer of ``ModelConfig()`` (lstm1:
F = 32 without dx, lstm2: F = 256 with dx; H = 128, T = 33) and dtype, at
the training batch, beside the CUDA-event time of the whole call.

    python3 tools/torch_stream_bwd_parts.py [--batch 10000] [--sweep_rows 0,4,8,16,32]

Prints the card's name and power limit, the kernels' compiler report, one
line per kernel and one split line per (layer, dtype), then a JSON line of
the splits. ``--sweep_rows`` times the sweep at other rows a block: 0 is
the kernel's own choice (both dtypes), 16 and 32 the bf16 tensor-core
sweep, 4 and 8 the float32 FMA sweep. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=10_000)
    parser.add_argument("--sweep_rows", default="0")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    from clair_tpu_torch.ops import bilstm_stream, build

    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for name in ("bilstm_stream_fwd", "bilstm_stream_bwd"):
        build.build(name)
        report = build.BUILD_REPORTS.get(name, "built before this run")
        print("\n".join(line for line in report.splitlines()
                        if "Compiling" in line or "registers" in line or "spill" in line))
    dtypes = {0: (torch.bfloat16, torch.float32), 16: (torch.bfloat16,),
              32: (torch.bfloat16,), 4: (torch.float32,), 8: (torch.float32,)}
    splits = {}
    for rows in (int(r) for r in args.sweep_rows.split(",")):
        bilstm_stream._SWEEP_ROWS = rows
        print(f"sweep rows a block: {rows or 'chosen by the kernel'}")
        split = chip_smoke.backward_split(torch.device("cuda"), args.batch, dtypes=dtypes[rows])
        splits.update({f"{k[0]} {k[1]} rows {rows}": v for k, v in split.items()})
    print(json.dumps({"card": card, "batch": args.batch, "split_ms": splits}))


if __name__ == "__main__":
    main()
