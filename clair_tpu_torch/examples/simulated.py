"""What the demo and the two training recipes share: a simulated genome's
BAM and planted truth through the production data chain (truth extraction
-> candidate sampling -> tensor creation -> pairing -> binning), and calls
on a BAM scored against its planted truth."""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np

from clair_tpu_torch.data.bins import BinDataset, build_bin_from_tensors
from clair_tpu_torch.data.candidates import CandidateConfig, candidate_sites_from_events
from clair_tpu_torch.data.pairing import pair_with_non_variants
from clair_tpu_torch.data.pileup import create_tensors
from clair_tpu_torch.data.tensor_stream import tensor_line_from
from clair_tpu_torch.data.truth import write_truth
from clair_tpu_torch.pipeline.call_bam import CallBamConfig, call_bam, load_region_events
from clair_tpu_torch.pipeline.call_var import Predictor
from clair_tpu_torch.utils import simulate
from clair_tpu_torch.utils.simulate import write_truth_vcf

# where the recipes write their checkpoints by default (the vendored ones
# in examples/ stay as they are)
OUTPUT_DIR = Path(__file__).resolve().parents[2] / "build" / "clair_tpu_torch" / "examples"
CONTIG = "chr1"
CHAIN_FILES = ("ref.fa", "sample.bam", "truth.vcf", "truth.var", "var_tensors.txt",
               "can_tensors.txt", "paired.txt")


def work_paths(work_dir: str, names=CHAIN_FILES) -> dict:
    return {name: os.path.join(work_dir, name) for name in names}


def _write_tensors(path: str, tensors) -> int:
    x, kept, seqs = tensors
    with open(path, "w") as fh:
        for i in range(len(kept)):
            print(tensor_line_from(CONTIG, int(kept[i]), seqs[i], x[i]), file=fh)
    return len(kept)


def training_bin(paths: dict, reference: str, variants, length: int, seed: int,
                 output_probability: float, block_size: int, log=None) -> BinDataset:
    """The bin of a simulated genome whose BAM (``paths["sample.bam"]``) is
    written: the truth VCF and its GetTruth lines, tensors at every truth
    site and at sampled candidate sites, truth paired with about twice as
    many non-variants, shuffled into blocks. The shuffle draws from numpy's
    global generator, as the JAX recipes' does."""
    write_truth_vcf(paths["truth.vcf"], variants)
    with open(paths["truth.var"], "w") as fh:
        write_truth(paths["truth.vcf"], CONTIG, fh)

    candidate_events, tensor_events = load_region_events(
        paths["sample.bam"], CONTIG, 0, length, minimum_mapq=0, dcov=250,
    )
    truth_centers = np.array(sorted(v.position for v in variants), dtype=np.int64)
    n_truth = _write_tensors(paths["var_tensors.txt"], create_tensors(
        tensor_events, truth_centers, reference, 0, minimum_coverage=4))
    config = CandidateConfig(
        gen4training=True, output_probability=output_probability,
        minimum_coverage=4, contig=CONTIG, seed=seed,
    )
    sites = candidate_sites_from_events(candidate_events, reference, 0, length, 0, config)
    n_candidates = _write_tensors(paths["can_tensors.txt"], create_tensors(
        tensor_events, sites.positions + 1, reference, 0, minimum_coverage=4))
    if log is not None:
        log(f"{n_truth} truth tensors, {n_candidates} candidate tensors")
    pair_with_non_variants(
        paths["can_tensors.txt"], paths["var_tensors.txt"], paths["paired.txt"],
        amplification=2.0, seed=seed,
    )
    return build_bin_from_tensors(
        paths["paired.txt"], paths["truth.var"], shuffle=True, block_size=block_size
    )


def simulate_genome(work_dir: str, profile_kwargs: dict, seed: int, genome_length: int,
                    n_variants: int) -> tuple:
    """(fasta, bam, planted variants) of a genome simulated from ``seed``
    with a platform recipe's reads (``PLATFORM_RECIPES``), variants 200
    apart: the held-out genomes of the per-platform models."""
    rs = np.random.RandomState(seed)
    reference = simulate.random_reference(rs, genome_length)
    variants = simulate.plant_variants(rs, reference, n_variants=n_variants, spacing=200)
    fasta_path, bam_path = os.path.join(work_dir, "ref.fa"), os.path.join(work_dir, "s.bam")
    simulate.write_fasta(fasta_path, reference)
    simulate.simulate_bam(
        bam_path, reference, variants, rs,
        coverage=profile_kwargs["coverage"],
        error_profile=getattr(simulate, profile_kwargs["profile_name"]),
        read_length=profile_kwargs["read_length"],
        read_length_sigma=profile_kwargs["read_length_sigma"],
    )
    return fasta_path, bam_path, variants


def simulate_flowcell(work_dir: str, seed: int, genome_kb: int, platform: str = "ont",
                      coverage=None) -> tuple:
    """(fasta, indexed bam, planted variants) of a flowcell simulated from
    ``seed`` by the fast simulator (systematic error hotspots), variants
    400 apart: the held-out flowcells of the production recipe."""
    from clair_tpu_torch.io.bai import build_bai

    rs = np.random.RandomState(seed)
    fasta_path, bam_path = os.path.join(work_dir, "ref.fa"), os.path.join(work_dir, "s.bam")
    reference, variants = simulate.simulate_platform_fast(
        bam_path, rs, length=genome_kb * 1000,
        variant_spacing=400, **simulate.platform_fast_kwargs(platform, coverage),
    )
    simulate.write_fasta(fasta_path, reference)
    build_bai(bam_path, bam_path + ".bai")
    return fasta_path, bam_path, variants


def read_calls(vcf_path: str) -> dict:
    """{POS: (REF, ALT, GT)} of a VCF's records."""
    called = {}
    with open(vcf_path) as fh:
        for row in fh:
            if not row.startswith("#"):
                columns = row.split("\t")
                called[int(columns[1])] = (columns[3], columns[4], columns[9].split(":")[0])
    return called


def call_vcf(bam_path: str, fasta_path: str, output_path: str, params: dict, model_config,
             batch_size: int, device: str) -> int:
    """``call_bam`` over the contig with a Predictor of ``params`` on
    ``device``; returns the candidate sites called."""
    return call_bam(
        CallBamConfig(bam_path=bam_path, fasta_path=fasta_path, contig=CONTIG,
                      minimum_af=0.2, minimum_coverage=4),
        Predictor(params, model_config, batch_size=batch_size, device=device),
        output_path=output_path,
    )


def score_calls(vcf_path: str, variants) -> tuple:
    """(recall, precision, exact, n) of the calls against the planted
    variants: a site counts when any record is at its position, exact when
    REF and ALT are the planted ones."""
    truth = {v.position: (v.ref, v.alt) for v in variants}
    called = {pos: (ref, alt) for pos, (ref, alt, _) in read_calls(vcf_path).items()}
    tp = len(set(truth) & set(called))
    exact = sum(1 for p in truth if p in called and called[p] == truth[p])
    return tp / len(truth), tp / max(len(called), 1), exact, len(truth)


def call_and_score(bam_path: str, fasta_path: str, variants, params: dict, model_config,
                   batch_size: int, device: str) -> tuple:
    """``call_vcf`` into a temporary directory, then ``score_calls``."""
    with tempfile.TemporaryDirectory(prefix="clair_tpu_torch_calls_") as tmp:
        out = os.path.join(tmp, "calls.vcf")
        call_vcf(bam_path, fasta_path, out, params, model_config, batch_size, device)
        return score_calls(out, variants)
