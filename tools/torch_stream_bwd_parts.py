"""A backward of the port's kernel table split into its kernels on the card:
row 2, the streaming BiLSTM backward (clair_tpu_torch/csrc/bilstm_stream_bwd.cu),
or with ``--pair train`` row 6, the resident training backward
(clair_tpu_torch/csrc/bilstm_train.cu, float32). Gives the device time of
each kernel the backward's entry point runs (torch.profiler's
key_averages), per layer of ``ModelConfig()`` (lstm1: F = 32 without dx,
lstm2: F = 256 with dx; H = 128, T = 33) and dtype, at the training batch,
beside the CUDA-event time of the whole call. The kernels fall into parts by
chip_smoke.BWD_PARTS: row 2's bf16 products are
``wgmma_product<TmaGateProblem>``, ``<TmaWeightSumProblem>`` and
``<TmaDxProblem>``, its float32 ones ``mma_product<GateProblem>``, ...

    python3 tools/torch_stream_bwd_parts.py [--pair stream|train] [--batch 10000]
                                            [--sweep_rows 0,16,32] [--f32_sweep 2:16,4:32]

Prints the card's name and power limit, the kernels' compiler report, one
line per kernel and one split line per (layer, dtype), then a JSON line of
the splits. The sweep runs at the kernel's own choice unless asked:
``--sweep_rows`` (row 2's bf16 mode) times its tensor-core sweep at 16 or
32 rows a block (0: the choice, both dtypes); ``--f32_sweep`` times the
float32 reverse sweep (row 2's float32 mode, or row 6 with ``--pair
train``) at each (cluster size, rows per tile), ``C:R``, that
``ops/lstm_sweep.py: bwd_sweep_geometries`` lists. Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def geometries(text: str):
    """(cluster, rows) pairs from "C:R,C:R"."""
    return [tuple(int(v) for v in item.split(":")) for item in text.split(",") if item]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pair", choices=("stream", "train"), default="stream")
    parser.add_argument("--batch", type=int, default=10_000)
    parser.add_argument("--sweep_rows", default="0")
    parser.add_argument("--f32_sweep", default="", help="C:R,... of the float32 reverse sweep")
    args = parser.parse_args()
    bf16_rows = [int(r) for r in args.sweep_rows.split(",")]
    if args.pair == "train" and bf16_rows != [0]:
        parser.error("--sweep_rows times row 2's bf16 sweep; row 6 takes --f32_sweep")
    if any(r not in (0, 16, 32) for r in bf16_rows):
        parser.error("--sweep_rows takes the bf16 sweep's rows a block, 16 or 32 (0: the "
                     "kernel's choice); the float32 sweep takes (cluster, rows) through "
                     "--f32_sweep, e.g. 2:16,4:32")
    from clair_tpu_torch.ops.lstm_sweep import bwd_sweep_geometries

    f32_geometries = geometries(args.f32_sweep)
    fits = bwd_sweep_geometries(128)
    for geometry in f32_geometries:
        if geometry not in fits:
            parser.error(f"--f32_sweep {geometry[0]}:{geometry[1]} does not fit the reverse "
                         f"sweep at H = 128; these do: {fits}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    from clair_tpu_torch.ops import build

    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    libraries = (("bilstm_train",) if args.pair == "train"
                 else ("bilstm_stream_fwd", "bilstm_stream_bwd"))
    for name in libraries:
        build.build(name)
        report = build.BUILD_REPORTS.get(name, "built before this run")
        print("\n".join(line for line in report.splitlines()
                        if "Compiling" in line or "registers" in line or "spill" in line))
    dev = torch.device("cuda")
    pair = chip_smoke.TRAIN_PAIR if args.pair == "train" else chip_smoke.STREAM_PAIR
    row = 6 if args.pair == "train" else 2
    splits = {}
    runs = [(f"rows {rows}" if rows else "chosen", {"rows": rows},
             (torch.bfloat16, torch.float32) if rows == 0 else (torch.bfloat16,))
            for rows in (bf16_rows if args.pair == "stream" else [0])]
    runs += [(f"cluster {c} rows {r}", {"cluster": c, "rows": r}, (torch.float32,))
             for c, r in f32_geometries]
    for label, geometry, dtypes in runs:
        print(f"row {row}'s sweep: {label}")
        split = chip_smoke.backward_split(dev, args.batch, dtypes=dtypes, pair=pair, **geometry)
        splits.update({f"{k[0]} {k[1]} row {row} {label}": v for k, v in split.items()})
    print(json.dumps({"card": card, "batch": args.batch, "pair": args.pair, "split_ms": splits}))


if __name__ == "__main__":
    main()
