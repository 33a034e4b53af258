"""Train one full-size model per platform on the card: the recipe behind the
vendored ``examples/<profile>_synthetic.ckpt``.

The full-size 2BiLSTM (``ModelConfig()``) is trained over a simulated
genome with the platform's error profile, through the production data
chain (simulate -> truth extraction -> candidate sampling -> tensor
creation -> pairing -> binning -> train_model), then called on a genome it
never saw (another seed) and scored against its planted variants.

    python -m clair_tpu_torch.examples.train_synthetic --profile ont|ccs|ilmn

writes ``build/clair_tpu_torch/examples/<profile>_synthetic.ckpt`` (the
JAX package's checkpoint layout; ``--output`` elsewhere) and prints the
held-out recall, precision and exact allele matches. The recipe: 150 kb
genome, 700 planted variants, 400 epochs at train batch 256, fixed 1e-3,
final-epoch parameters (the small validation split is too noisy to pick a
best epoch by).
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
    simulate_genome,
    training_bin,
    work_paths,
)
from clair_tpu_torch.utils import simulate
from clair_tpu_torch.utils.simulate import PLATFORM_RECIPES as PROFILES


def build_dataset(work_dir, seed, genome_length, n_variants, profile_name,
                  coverage, read_length, read_length_sigma, spacing=200):
    """(BinDataset, planted variants) of a genome simulated from ``seed``
    with the profile's reads."""
    rs = np.random.RandomState(seed)
    paths = work_paths(work_dir)
    reference = simulate.random_reference(rs, genome_length)
    variants = simulate.plant_variants(rs, reference, n_variants=n_variants, spacing=spacing)
    simulate.write_fasta(paths["ref.fa"], reference)
    simulate.simulate_bam(
        paths["sample.bam"], reference, variants, rs, coverage=coverage,
        error_profile=getattr(simulate, profile_name),
        read_length=read_length, read_length_sigma=read_length_sigma,
    )
    dataset = training_bin(paths, reference, variants, genome_length, seed,
                           output_probability=0.03, block_size=200)
    return dataset, variants


def evaluate_held_out(params, model_config, profile_kwargs, seed=424243,
                      genome_length=30_000, n_variants=120, device="cuda"):
    """Call a genome the model never saw; return (recall, precision, exact, n)."""
    with tempfile.TemporaryDirectory(prefix="clair_tpu_torch_heldout_") as tmp:
        fasta_path, bam_path, variants = simulate_genome(
            tmp, profile_kwargs, seed, genome_length, n_variants)
        return call_and_score(bam_path, fasta_path, variants, params, model_config,
                              batch_size=256, device=device)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--profile", choices=sorted(PROFILES), required=True)
    parser.add_argument("--epochs", type=int, default=400)
    parser.add_argument("--genome_length", type=int, default=150_000)
    parser.add_argument("--n_variants", type=int, default=700)
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--output", default=None,
                        help="default: build/clair_tpu_torch/examples/<profile>_synthetic.ckpt")
    parser.add_argument("--train_compute_dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="default: the TrainingConfig default (bfloat16 "
                             "compute, f32 master/loss/cell state). The "
                             "vendored examples/*_synthetic.ckpt were "
                             "trained with float32")
    return parser.parse_args(argv)


def main(argv=None, device="cuda"):
    """The recipe on ``device``; returns what it printed, as a dict."""
    args = parse_args(argv)

    from clair_tpu_torch.models.checkpoint import save_checkpoint
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.pipeline.train import TrainingConfig, train_model

    profile = PROFILES[args.profile]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=f"clair_tpu_torch_train_{args.profile}_") as work_dir:
        dataset, variants = build_dataset(
            work_dir, args.seed, args.genome_length, args.n_variants, **profile
        )
        data_secs = time.perf_counter() - t0
        print(f"[train] {dataset.dataset_size} examples "
              f"({len(variants)} truth variants) in {data_secs:.0f}s", file=sys.stderr)

        model_config = ModelConfig()  # full-size 2BiLSTM
        t0 = time.perf_counter()
        result = train_model(
            dataset,
            TrainingConfig(
                model=model_config,
                output_prefix=os.path.join(work_dir, "model"),
                learning_rate=1e-3, train_batch_size=256, val_batch_size=32,
                schedule="fixed", max_epochs=args.epochs, checkpoint_every=100,
                evaluate_at_end=False, seed=args.seed, restore_best=False,
                device=device,
                **({"train_compute_dtype": args.train_compute_dtype}
                   if args.train_compute_dtype else {}),
            ),
        )
        train_secs = time.perf_counter() - t0

    output = args.output or str(OUTPUT_DIR / f"{args.profile}_synthetic.ckpt")
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    save_checkpoint(output, result.params, extra={"epoch": args.epochs})
    print(f"[train] wrote {output} ({train_secs:.0f}s train)", file=sys.stderr)

    t0 = time.perf_counter()
    recall, precision, exact, n = evaluate_held_out(
        result.params, model_config, profile, device=device
    )
    print(f"[held-out] recall {recall:.3f} precision {precision:.3f} "
          f"exact {exact}/{n}")
    return {"dataset_size": dataset.dataset_size, "n_truth": len(variants),
            "data_seconds": data_secs, "train_seconds": train_secs,
            "held_out_seconds": time.perf_counter() - t0, "output": output,
            "result": result, "recall": recall, "precision": precision,
            "exact": exact, "n": n}


if __name__ == "__main__":
    main()
