"""QUAL calibration sweep of the PyTorch port: precision/recall against the
quality cutoff per platform, with the vendored checkpoints called on the
card (the port of tools/qual_sweep.py, which derives the cutoffs that
README.md and docs/ACCURACY.md publish from the JAX Predictor).

The methodology is tools/qual_sweep.py's: simulate a genome the vendored
checkpoint never saw (the same seeds and simulator, so the same genome),
call it through the port's production pipeline (``call_bam`` with a
``Predictor`` of ``ModelConfig()``, float32 on the card: the streaming
forward's float32 mode), and score the calls above each QUAL cutoff
against the planted truth, allele-aware.

Platforms:

- ont:  examples/ont_production.ckpt on the production held-out flowcell
- ccs:  examples/ccs_synthetic.ckpt, PacBio CCS fast profile
- ilmn: examples/ilmn_synthetic.ckpt, Illumina fast profile

Usage: python tools/torch_qual_sweep.py [--platform ont|ccs|ilmn|all]
                                        [--genome-kb N] [--markdown]
                                        [--compare DIR] [--cutoffs Q,Q,...]

Prints one JSON line per platform; --markdown adds the table block, and
with --cutoffs the sweep's rows at those QUAL cutoffs.
--compare DIR holds site by site each platform's calls against
DIR/<platform>.vcf, another run's calls on the same genome (tools/
qual_sweep.py's calls.vcf): the same sites and decisions (REF, ALT, GT),
and QUAL within 1 where both are below 3000 (float32 does not resolve QUAL
above it). Calls on the card; tests call ``call_heldout`` with
device="cpu".
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# fresh seeds per platform, disjoint from every training seed (the JAX
# tool's)
HELDOUT_SEEDS = {"ont": 515151, "ccs": 626262, "ilmn": 636363}
CHECKPOINTS = {
    "ont": "examples/ont_production.ckpt",
    "ccs": "examples/ccs_synthetic.ckpt",
    "ilmn": "examples/ilmn_synthetic.ckpt",
}
# QUAL = (10 log10(p / (1 - p)) + 16)^2: one float32 step of p moves it by
# more than 1 above this
QUAL_RESOLVED = 3000.0


def vcf_rows(path: str):
    """[(position, REF, ALT, genotype, QUAL)] of a VCF's records."""
    rows = []
    with open(path) as fh:
        for row in fh:
            if row.startswith("#"):
                continue
            c = row.rstrip("\n").split("\t")
            called_gt = c[9].split(":", 1)[0].replace("|", "/")
            rows.append((int(c[1]), c[3], c[4], called_gt, float(c[5])))
    return rows


def _call(platform: str, genome_kb: int, batch_size: int, device: str):
    """(truth, VCF rows) of the platform's held-out genome called on
    ``device``."""
    from clair_tpu_torch.io.bai import build_bai
    from clair_tpu_torch.models.checkpoint import load_checkpoint
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.pipeline.call_bam import CallBamConfig, call_bam
    from clair_tpu_torch.pipeline.call_var import Predictor
    from clair_tpu_torch.utils.simulate import (
        platform_fast_kwargs,
        simulate_platform_fast,
        write_fasta,
    )

    params, _ = load_checkpoint(os.path.join(REPO, CHECKPOINTS[platform]))
    rs = np.random.RandomState(HELDOUT_SEEDS[platform])
    with tempfile.TemporaryDirectory(prefix=f"clair_tpu_torch_qual_{platform}_") as tmp:
        bam = os.path.join(tmp, "s.bam")
        fasta = os.path.join(tmp, "ref.fa")
        reference, variants = simulate_platform_fast(
            bam, rs, length=genome_kb * 1000, variant_spacing=400,
            **platform_fast_kwargs(platform, None),
        )
        write_fasta(fasta, reference)
        build_bai(bam, bam + ".bai")
        out = os.path.join(tmp, "calls.vcf")
        # the reference's per-platform candidate alt-AF defaults: Illumina
        # 0.1, CCS 0.2, ONT 0.2
        minimum_af = 0.1 if platform == "ilmn" else 0.2
        call_bam(
            CallBamConfig(bam_path=bam, fasta_path=fasta, contig="chr1",
                          minimum_af=minimum_af, minimum_coverage=4),
            Predictor(params, ModelConfig(), batch_size=batch_size, device=device),
            output_path=out,
        )
        rows = vcf_rows(out)
    # a genotype other than 0/1 or 1/1 raises KeyError, as the JAX tool does
    gt_str = {(0, 1): "0/1", (1, 1): "1/1"}
    truth = {
        v.position: (v.ref, v.alt, gt_str[tuple(v.genotype)])
        for v in variants
    }
    return truth, rows


def scored(truth, rows):
    """[(position, qual, is_tp)]: a call is a TP only when position, REF,
    ALT and genotype ALL match the planted truth."""
    return [(p, qual, truth.get(p) == (ref, alt, gt)) for p, ref, alt, gt, qual in rows]


def call_heldout(platform: str, genome_kb: int = 60, batch_size: int = 512,
                 device: str = "cuda"):
    """Simulate a held-out flowcell, call it on ``device``, return (truth,
    calls): truth maps position -> (REF, ALT, genotype_string) for every
    planted variant, calls is [(position, qual, is_tp)]. A call is a TP only
    when position, REF, ALT and genotype ALL match the planted truth (the
    allele-aware matching of the hap.py-style methodology): a wrong-allele
    or wrong-genotype call at a truth position is a false positive, and its
    truth site can no longer be recalled by any cutoff."""
    truth, rows = _call(platform, genome_kb, batch_size, device)
    return truth, scored(truth, rows)


def sweep(truth, calls, thresholds=None):
    """Precision/recall/F1 at each QUAL threshold (calls with
    QUAL >= threshold kept). Returns list of dict rows, ascending."""
    if thresholds is None:
        quals = sorted({q for _, q, _ in calls})
        # candidate cutoffs: 0 plus every distinct call QUAL (the exact
        # sweep: each threshold between two quals scores identically to
        # the upper one)
        thresholds = [0.0] + quals
    n_truth = len(truth)
    rows = []
    for t in thresholds:
        kept = [(p, q, is_tp) for p, q, is_tp in calls if q >= t]
        tp = len({p for p, _, is_tp in kept if is_tp})
        fp = sum(1 for _, _, is_tp in kept if not is_tp)
        precision = tp / max(tp + fp, 1)
        recall = tp / max(n_truth, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-9)
        rows.append({"qual": t, "tp": tp, "fp": fp,
                     "precision": round(precision, 4),
                     "recall": round(recall, 4), "f1": round(f1, 4)})
    return rows


def operating_point(rows):
    """Best-F1 threshold (the reference's cutoff selection criterion);
    ties break toward the LOWER threshold (more recall headroom)."""
    return max(rows, key=lambda r: (r["f1"], -r["qual"]))


def differences(rows, other):
    """Site by site, what differs between two runs' VCF rows on one genome:
    a site one run calls and the other not, another decision (REF, ALT,
    GT), or QUALs more than 1 apart where both are below QUAL_RESOLVED."""
    mine, theirs = {r[0]: r for r in rows}, {r[0]: r for r in other}
    out = []
    for p in sorted(set(mine) | set(theirs)):
        a, b = mine.get(p), theirs.get(p)
        if a is None or b is None:
            out.append(f"{p}: called by {'the other run' if a is None else 'this run'} only")
        elif a[1:4] != b[1:4]:
            out.append(f"{p}: {a[1:4]} against {b[1:4]}")
        elif max(a[4], b[4]) < QUAL_RESOLVED and abs(a[4] - b[4]) > 1.0:
            out.append(f"{p}: QUAL {a[4]} against {b[4]}")
    return out


def run_platform(platform: str, genome_kb: int, device: str = "cuda", compare=None,
                 cutoffs=None):
    """The platform's sweep on ``device``; with ``compare`` (a directory),
    also its calls against ``compare``/<platform>.vcf site by site; with
    ``cutoffs``, the sweep's rows at those QUAL cutoffs."""
    truth, rows = _call(platform, genome_kb, 512, device)
    calls = scored(truth, rows)
    sweep_rows = sweep(truth, calls)
    best = operating_point(sweep_rows)
    unfiltered = sweep_rows[0]
    result = {
        "platform": platform,
        "genome_kb": genome_kb,
        "n_truth": len(truth),
        "n_called": len(calls),
        "unfiltered": unfiltered,
        "best": best,
        "fp_quals": sorted(q for _, q, is_tp in calls if not is_tp),
        "tp_qual_p10": float(np.percentile(
            [q for _, q, is_tp in calls if is_tp], 10))
        if any(is_tp for _, _, is_tp in calls) else 0.0,
        "sweep": sweep_rows,
    }
    if cutoffs:
        result["cutoffs"] = sweep(truth, calls, cutoffs)
    if compare is not None:
        other = vcf_rows(os.path.join(compare, f"{platform}.vcf"))
        theirs = {r[0]: r[4] for r in other}
        resolved = [abs(q - theirs[p]) for p, _, _, _, q in rows
                    if p in theirs and max(q, theirs[p]) < QUAL_RESOLVED]
        result["compare"] = {"sites": len(rows), "other_sites": len(other),
                             "above_resolved": len(rows) - len(resolved),
                             "max_qual_difference_below": max(resolved, default=0.0),
                             "differences": differences(rows, other)}
    return result


def markdown_table(results):
    lines = [
        "| Platform | Unfiltered P / R | Best cutoff | P / R / F1 at cutoff | FPs removed |",
        "|---|---|---|---|---|",
    ]
    for r in results:
        u, b = r["unfiltered"], r["best"]
        lines.append(
            f"| {r['platform'].upper()} | {u['precision']:.3f} / {u['recall']:.3f} "
            f"| QUAL >= {b['qual']:.0f} | {b['precision']:.3f} / {b['recall']:.3f} / {b['f1']:.3f} "
            f"| {u['fp'] - b['fp']}/{u['fp']} |"
        )
    return "\n".join(lines)


def cutoff_table(result):
    """The sweep's rows at the requested cutoffs, the chosen one in bold."""
    lines = [f"{result['platform'].upper()}:", "",
             "| QUAL cutoff | TP | FP | Precision | Recall | F1 |", "|---|---|---|---|---|---|"]
    for r in result["cutoffs"]:
        cells = [f"{r['qual']:.0f}", str(r["tp"]), str(r["fp"]), f"{r['precision']:.3f}",
                 f"{r['recall']:.3f}", f"{r['f1']:.3f}"]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", default="all",
                    choices=["all", "ont", "ccs", "ilmn"])
    ap.add_argument("--genome-kb", type=int, default=60)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--compare", default=None,
                    help="a directory of <platform>.vcf from another run on the same genome")
    ap.add_argument("--cutoffs", default=None,
                    help="comma-separated QUAL cutoffs at which to print the sweep's rows")
    args = ap.parse_args()
    cutoffs = [float(c) for c in args.cutoffs.split(",")] if args.cutoffs else None

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_qual_sweep calls on the card: no CUDA device is visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    platforms = ["ont", "ccs", "ilmn"] if args.platform == "all" else [args.platform]
    results = []
    for platform in platforms:
        r = run_platform(platform, args.genome_kb, compare=args.compare, cutoffs=cutoffs)
        results.append(r)
        compact = {k: v for k, v in r.items() if k not in ("sweep", "fp_quals", "cutoffs")}
        compact["sweep_points"] = len(r["sweep"])
        compact["device"] = f"{torch.cuda.get_device_name(0)} ({card})"
        print(json.dumps(compact))
    if args.markdown:
        print()
        print(markdown_table(results))
        for r in results:
            if "cutoffs" in r:
                print()
                print(cutoff_table(r))


if __name__ == "__main__":
    main()
