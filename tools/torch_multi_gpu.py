"""The port across the cards of one host: data-parallel training
(``train_on_devices``: one rank process a card, DistributedDataParallel on
NCCL) against one process at the same global batch, and calling through
``ShardedPredictor`` (one Predictor a card, each on a slice of the batch)
against one Predictor.

    python3 tools/torch_multi_gpu.py [--devices 4] [--device cuda|cpu] [--rows 24000]

Training: chip_smoke.py's learnable bin (``--rows`` rows, batch 10,000,
two epochs, dropout off, bfloat16): the per-epoch loss sums of the ranks
within rtol 1e-3 of one process's (the JAX package's tolerance,
tests/test_distributed.py), each rank launching what the single process
launches. Calling: chip_smoke.py's simulated 30 kb ONT genome through
``call_bam.call_bam``: the same VCF rows from ShardedPredictor over every
card as from one Predictor. Prints the card's name and power limit, each
run's wall (host clock, the ranks' spawn included) and launches, and a
JSON line last; exits non-zero on a disagreement. ``--device cpu``
rehearses it on the CPU (gloo ranks, CPU Predictors) at a small
``--rows``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LOSS_RTOL = 1e-3


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=4)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--rows", type=int, default=24_000)
    args = parser.parse_args()

    import chip_smoke
    from clair_tpu_torch.data.bins import load_bin
    from clair_tpu_torch.models.checkpoint import load_checkpoint
    from clair_tpu_torch.ops import launch_counts, launches_since
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.parallel.mesh import visible_devices
    from clair_tpu_torch.pipeline.call_bam import CallBamConfig, call_bam
    from clair_tpu_torch.pipeline.call_var import Predictor, ShardedPredictor
    from clair_tpu_torch.pipeline.train import TrainingConfig, train_model, train_on_devices

    n, cuda = args.devices, args.device == "cuda"
    devices = visible_devices(n, args.device)
    card = "CPU"
    if cuda:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().replace("\n", "; ")
        chip_smoke.build_all()
    print(f"card(s): {card}; torch {torch.__version__}, {torch.cuda.device_count()} visible")
    chip_smoke.TRAIN_ROWS = args.rows
    summary = {"devices": n, "device": args.device}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        bin_fn = tmp / "train.bin"
        chip_smoke.write_training_bin(bin_fn)
        model = dataclasses.replace(ModelConfig(), lstm2_dropout_rate=0.0, l4_dropout_rate=0.0,
                                    l5_dropout_rate=0.0)
        config = TrainingConfig(model=model, schedule="fixed", max_epochs=2,
                                evaluate_at_end=False, device=devices[0])
        before, started = launch_counts(), time.perf_counter()
        single = train_model(load_bin(str(bin_fn)), config)
        runs = {"one process": (single, launches_since(before), time.perf_counter() - started)}
        started = time.perf_counter()
        result, launches = train_on_devices(
            functools.partial(load_bin, str(bin_fn)), dataclasses.replace(config, device=args.device),
            n, devices=devices, timeout_s=900)
        runs[f"{n} ranks"] = (result, launches, time.perf_counter() - started)
        for name, (r, launched, wall) in runs.items():
            print(f"  train {name}: training loss sums {r.training_losses}, validation "
                  f"{r.validation_losses}, kernel launches {launched}, wall {wall:.2f} s")
        rel = max(abs(a - b) / abs(b) for key in ("training_losses", "validation_losses")
                  for (a, _), (b, _) in zip(getattr(result, key), getattr(single, key)))
        print(f"  {n} ranks vs one process: max rel diff of the loss sums {rel:.3e} "
              f"(limit {LOSS_RTOL})")
        summary["train"] = {k: {"wall_s": w, "launches": l} for k, (_, l, w) in runs.items()}
        summary["train_max_rel_diff"] = rel
        assert rel <= LOSS_RTOL, rel
        assert launches == {k: n * v for k, v in runs["one process"][1].items()}, launches

        chip_smoke.GENOME_LENGTH = 30_000 if cuda else 6_000
        fasta, bam, _, _ = chip_smoke.simulate_genome(tmp)
        params, _ = load_checkpoint(str(ROOT / "examples" / "ont_synthetic.ckpt"))
        base = CallBamConfig(bam_path=bam, fasta_path=fasta, contig="chr1", minimum_af=0.2)
        rows = {}
        for name, predictor in (("one Predictor", Predictor(params, ModelConfig(compute_dtype="bfloat16"),
                                                             device=devices[0])),
                                (f"ShardedPredictor x {n}", ShardedPredictor(
                                    params, ModelConfig(compute_dtype="bfloat16"),
                                    devices=devices))):
            out = str(tmp / f"{len(rows)}.vcf")
            before, started = launch_counts(), time.perf_counter()
            sites = call_bam(base, predictor, output_path=out)
            wall = time.perf_counter() - started
            rows[name] = [r for r in open(out) if not r.startswith("#")]
            print(f"  call_bam {name}: {sites} sites, {len(rows[name])} rows, kernel launches "
                  f"{launches_since(before)}, wall {wall:.2f} s")
            summary.setdefault("call_bam", {})[name] = {"wall_s": wall, "rows": len(rows[name])}
        first, second = rows.values()
        assert first == second and first, "ShardedPredictor's rows differ from one Predictor's"
        print("  the same VCF rows")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
