"""Self-contained end-to-end demo on the card, with no external data.

Simulates a diploid genome with planted SNPs and indels, builds training
data through the real pipeline (truth extraction -> candidate sampling ->
tensor creation -> pairing -> binning), trains a narrow model (32 LSTM
units), calls variants on the BAM and scores the calls against the planted
truth.

    python -m clair_tpu_torch.demo [--quick] [--profile clean|ont|ccs|ilmn]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from clair_tpu_torch.examples.simulated import (
    call_vcf,
    read_calls,
    training_bin,
    work_paths,
)
from clair_tpu_torch.utils import simulate


def demo_dataset(work_dir, genome_length, n_variants, coverage, error_rate, seed,
                 error_profile, read_length, read_length_sigma, spacing, log=None):
    """Steps 1-4 of the demo: (BinDataset, planted variants) of a genome
    simulated from ``seed``, its files in ``work_dir``."""
    rs = np.random.RandomState(seed)
    paths = work_paths(work_dir)
    reference = simulate.random_reference(rs, genome_length)
    variants = simulate.plant_variants(rs, reference, n_variants=n_variants, spacing=spacing)
    simulate.write_fasta(paths["ref.fa"], reference)
    n_reads = simulate.simulate_bam(
        paths["sample.bam"], reference, variants, rs,
        coverage=coverage, error_rate=error_rate,
        error_profile=error_profile,
        read_length=read_length, read_length_sigma=read_length_sigma,
    )
    if log is not None:
        log(f"simulated {len(variants)} variants, {n_reads} reads at ~{coverage}x")
    dataset = training_bin(paths, reference, variants, genome_length, seed,
                           output_probability=0.05, block_size=100, log=log)
    if log is not None:
        log(f"training bin: {dataset.dataset_size} examples")
    return dataset, variants


def _is_snp(ref, alt):
    return len(ref) == 1 and all(len(a) == 1 for a in alt.split(","))


def score(variants, called):
    """The demo's tallies of the calls {POS: (REF, ALT, GT)}: site recall
    and precision, exact allele matches, and SNPs and indels apart."""
    truth_by_pos = {v.position: v for v in variants}

    def tally(snp):
        truth = {p for p, v in truth_by_pos.items() if _is_snp(v.ref, v.alt) == snp}
        calls = {p for p, (r, a, _) in called.items() if _is_snp(r, a) == snp}
        tp = len(truth & set(called))   # site found at all (any representation)
        fp = len(calls - set(truth_by_pos))
        fn = len(truth - set(called))
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-9)
        return {"tp": tp, "fp": fp, "fn": fn,
                "precision": precision, "recall": recall, "f1": f1}

    tp = sum(1 for p in truth_by_pos if p in called)
    exact = sum(
        1 for p, v in truth_by_pos.items()
        if p in called and called[p][0] == v.ref and called[p][1].split(",")[-1] == v.alt
    )
    return {
        "n_truth": len(truth_by_pos),
        "n_called": len(called),
        "recall": tp / max(len(truth_by_pos), 1),
        "precision": tp / max(len(called), 1),
        "exact": exact,
        "snp": tally(True),
        "indel": tally(False),
    }


def run_demo(
    genome_length=40_000,
    n_variants=200,
    coverage=30,
    error_rate=0.002,
    lstm_units=32,
    epochs=400,
    work_dir=None,
    seed=7,
    verbose=True,
    error_profile=None,
    read_length=150,
    read_length_sigma=0.0,
    spacing=150,
    device="cuda",
):
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.pipeline.train import TrainingConfig, train_model

    work_dir = work_dir or tempfile.mkdtemp(prefix="clair_tpu_torch_demo_")
    os.makedirs(work_dir, exist_ok=True)

    def log(*args):
        if verbose:
            print("[demo]", *args, file=sys.stderr)

    # 1-4. simulate, extract truth, tensors at truth and sampled sites, pair, bin
    dataset, variants = demo_dataset(
        work_dir, genome_length, n_variants, coverage, error_rate, seed, error_profile,
        read_length, read_length_sigma, spacing, log,
    )

    # 5. train
    model_config = ModelConfig(
        lstm1_num_units=lstm_units, lstm2_num_units=lstm_units,
        l3_num_units=8, l4_num_units=64, l5_num_units=32,
    )
    result = train_model(
        dataset,
        TrainingConfig(
            model=model_config,
            output_prefix=os.path.join(work_dir, "model"),
            learning_rate=1e-3,
            train_batch_size=256, val_batch_size=32,
            schedule="fixed", max_epochs=epochs, checkpoint_every=50,
            evaluate_at_end=False, seed=seed,
            # the demo's validation split is ~50 examples, too noisy to
            # pick a best epoch by validation loss: keep the final parameters
            restore_best=False,
            device=device,
        ),
    )
    log(f"trained; best epoch {result.best_epoch}")

    # 6. call variants on the BAM
    paths = work_paths(work_dir, ("ref.fa", "sample.bam", "calls.vcf"))
    call_vcf(paths["sample.bam"], paths["ref.fa"], paths["calls.vcf"], result.params,
             model_config, batch_size=256, device=device)

    # 7. score against the planted truth (site and allele level), SNPs and
    # indels tallied apart as the reference's benchmark tables do
    stats = score(variants, read_calls(paths["calls.vcf"]))
    snp, indel = stats["snp"], stats["indel"]
    log(
        f"calls: {stats['n_called']}; site recall {stats['recall']:.3f}, precision "
        f"{stats['precision']:.3f}, exact allele matches {stats['exact']}/{stats['n_truth']}"
    )
    log(
        f"SNP   P {snp['precision']:.3f} R {snp['recall']:.3f} F1 {snp['f1']:.3f} | "
        f"Indel P {indel['precision']:.3f} R {indel['recall']:.3f} F1 {indel['f1']:.3f}"
    )
    return {"work_dir": work_dir, **stats}


def demo_kwargs(quick, profile):
    """run_demo's arguments for ``--quick`` and ``--profile``."""
    reads = {
        "ont": dict(error_profile=simulate.ONT_R94, coverage=60,
                    read_length=1000, read_length_sigma=0.4),
        "ccs": dict(error_profile=simulate.PACBIO_CCS, coverage=30,
                    read_length=2000, read_length_sigma=0.2),
        "ilmn": dict(error_profile=simulate.ILLUMINA, coverage=60, read_length=150),
    }.get(profile, dict(coverage=60))
    size = (dict(genome_length=30_000, n_variants=150, epochs=400) if quick
            else dict(genome_length=60_000, n_variants=300, epochs=600))
    return {**size, **reads}


def recall_floor(profile):
    return 0.8 if profile == "ont" else 0.95


def main(argv=None, device="cuda"):
    parser = argparse.ArgumentParser(description="clair_tpu_torch end-to-end demo")
    parser.add_argument("--quick", action="store_true", help="smaller/faster settings")
    parser.add_argument(
        "--profile", choices=("clean", "ont", "ccs", "ilmn"), default="clean",
        help="read error model: 'ont' = R9.4.1-like noise (homopolymer-"
             "biased indels, 5%% mismatch, lognormal read lengths); "
             "'ccs' = PacBio HiFi (~0.5%% indel-leaning); 'ilmn' = "
             "Illumina short reads (0.2%% mismatch)",
    )
    parser.add_argument("--work_dir", default=None)
    args = parser.parse_args(argv)

    stats = run_demo(work_dir=args.work_dir, device=device,
                     **demo_kwargs(args.quick, args.profile))
    print(stats)
    floor = recall_floor(args.profile)
    if stats["recall"] < floor:
        sys.exit(f"demo recall below {floor} — something is off")
    return stats


if __name__ == "__main__":
    main()
