"""Run the reference's production training recipe on the card.

The recipe: train batch 10,000 and the adaptive-decay schedule (initial LR
1e-3, x0.1 on validation-loss oscillation or increase, three switches, the
best validation epoch restored; reference shared/param.py:15 and
clair/train.py:18-62). This script runs it end to end over a simulated
flowcell of the platform (the fast vectorized simulator, with systematic
error hotspots), through the production data chain, and reports held-out
calling metrics on a flowcell the model never saw.

    python -m clair_tpu_torch.examples.train_production [--genome_kb 600] [--coverage 50]

About 0.6 Mb at variant spacing 100 gives ~6k truth variants and ~2x
sampled non-variants: a few batches an epoch at batch 10,000. The
reference's epochs span millions of samples; what is exercised here is the
recipe (batch size, schedule, loss, clipping) at a dataset the host builds
in minutes.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from clair_tpu_torch.examples.simulated import (
    OUTPUT_DIR,
    call_and_score,
    simulate_flowcell,
    training_bin,
    work_paths,
)
from clair_tpu_torch.utils.simulate import (
    platform_fast_kwargs,
    simulate_platform_fast,
    write_fasta,
)


def build_ont_dataset(work_dir, seed, genome_kb, coverage, variant_spacing,
                      platform="ont"):
    """(BinDataset, planted variants) of a flowcell simulated from ``seed``."""
    length = genome_kb * 1000
    rs = np.random.RandomState(seed)
    paths = work_paths(work_dir)
    reference, variants = simulate_platform_fast(
        paths["sample.bam"], rs, length=length,
        variant_spacing=variant_spacing,
        **platform_fast_kwargs(platform, coverage),
    )
    write_fasta(paths["ref.fa"], reference)
    dataset = training_bin(paths, reference, variants, length, seed,
                           output_probability=0.03, block_size=500)
    return dataset, variants


def evaluate_held_out_ont(params, model_config, seed=515151, genome_kb=60,
                          coverage=None, platform="ont", device="cuda"):
    """Call a fresh flowcell the model never saw; return (recall,
    precision, exact, n)."""
    with tempfile.TemporaryDirectory(prefix="clair_tpu_torch_prod_heldout_") as tmp:
        fasta_path, bam_path, variants = simulate_flowcell(tmp, seed, genome_kb, platform,
                                                           coverage)
        return call_and_score(bam_path, fasta_path, variants, params, model_config,
                              batch_size=512, device=device)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--platform", choices=("ont", "ccs", "ilmn"),
                        default="ont")
    parser.add_argument("--genome_kb", type=int, default=600)
    parser.add_argument("--coverage", type=int, default=0,
                        help="override the platform recipe's coverage")
    parser.add_argument("--variant_spacing", type=int, default=100)
    parser.add_argument("--seed", type=int, default=21)
    parser.add_argument("--hard_max_epochs", type=int, default=200)
    parser.add_argument("--output", default=None,
                        help="default: build/clair_tpu_torch/examples/<platform>_production.ckpt "
                             "in a checkout, clair_tpu_torch/_build/examples/ where installed")
    parser.add_argument("--train_compute_dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="default: the TrainingConfig default (bfloat16)")
    parser.add_argument("--dataset_bin", default=None,
                        help="cache the built dataset at this path (loaded "
                             "if it exists; a 2 Mb dataset takes many minutes "
                             "to simulate, so build it once)")
    return parser.parse_args(argv)


def main(argv=None, device="cuda"):
    """The recipe on ``device``; returns what it printed, as a dict."""
    args = parse_args(argv)

    from clair_tpu_torch.data.bins import load_bin, write_bin
    from clair_tpu_torch.models.checkpoint import save_checkpoint
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.pipeline.train import TrainingConfig, train_model

    with tempfile.TemporaryDirectory(prefix="clair_tpu_torch_prod_train_") as work_dir:
        t0 = time.perf_counter()
        if args.dataset_bin and os.path.isfile(args.dataset_bin):
            dataset = load_bin(args.dataset_bin)
            print(f"[prod] dataset {dataset.dataset_size} examples loaded from "
                  f"{args.dataset_bin} in {time.perf_counter()-t0:.0f}s",
                  file=sys.stderr)
        else:
            dataset, variants = build_ont_dataset(
                work_dir, args.seed, args.genome_kb, args.coverage,
                args.variant_spacing, platform=args.platform,
            )
            if args.dataset_bin:
                write_bin(args.dataset_bin, dataset)
            print(f"[prod] dataset {dataset.dataset_size} examples "
                  f"({len(variants)} truth variants) in "
                  f"{time.perf_counter()-t0:.0f}s", file=sys.stderr)
        data_secs = time.perf_counter() - t0

        model_config = ModelConfig()
        t0 = time.perf_counter()
        # the production recipe: batch 10000, adaptive decay, best-val restore
        result = train_model(
            dataset,
            TrainingConfig(
                model=model_config,
                output_prefix=os.path.join(work_dir, "model"),
                schedule="adaptive",
                hard_max_epochs=args.hard_max_epochs,
                checkpoint_every=10,
                evaluate_at_end=True,
                seed=args.seed,
                device=device,
                **({"train_compute_dtype": args.train_compute_dtype}
                   if args.train_compute_dtype else {}),
            ),
        )
        train_secs = time.perf_counter() - t0
        print(f"[prod] trained {len(result.training_losses)} epochs in "
              f"{train_secs:.0f}s (best epoch {result.best_epoch})",
              file=sys.stderr)

        output = args.output or str(OUTPUT_DIR / f"{args.platform}_production.ckpt")
        os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
        save_checkpoint(output, result.params, extra={
            "recipe": "production-adaptive-b10000",
            "epochs": len(result.training_losses),
            "best_epoch": result.best_epoch,
        })
        print(f"[prod] wrote {output}", file=sys.stderr)

    recall, precision, exact, n = evaluate_held_out_ont(
        result.params, model_config, platform=args.platform, device=device
    )
    print(f"[held-out] recall {recall:.3f} precision {precision:.3f} "
          f"exact {exact}/{n} "
          f"(epochs {len(result.training_losses)}, best {result.best_epoch}, "
          f"{train_secs:.0f}s train)")
    return {"dataset_size": dataset.dataset_size, "data_seconds": data_secs,
            "train_seconds": train_secs, "result": result, "recall": recall,
            "precision": precision, "exact": exact, "n": n}


if __name__ == "__main__":
    main()
