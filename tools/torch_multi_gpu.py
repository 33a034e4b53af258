"""The port across the cards of one host: parallel training
(``train_on_devices``: one rank process a card, DistributedDataParallel on
NCCL, the dense trunk split over ``--model_parallel`` of them) against one
process at the same global batch, and calling through ``ShardedPredictor``
(one Predictor a card, each on a slice of the batch) against one Predictor.

    python3 tools/torch_multi_gpu.py [--devices 4] [--model_parallel 1,2,4]
                                     [--device cuda|cpu] [--rows 24000]

Training, once for each model-axis width M of ``--model_parallel`` (a mesh
of devices // M data rows of M): chip_smoke.py's learnable bin (``--rows``
rows, batch 10,000, two epochs, dropout off, bfloat16): the per-epoch loss
sums of the ranks within rtol 1e-3 of one process's (the JAX package's
tolerance, tests/test_distributed.py, held for every M: the model axis
sums its bfloat16 partial products in float32), each rank launching what
the single process launches; then the full-width train step's wall on the
same mesh (host clock around five synchronized steps after a warm-up, at
a global batch of 10,000, bfloat16, rank 0's). Calling: chip_smoke.py's
simulated 30 kb ONT genome through ``call_bam.call_bam``: the same VCF rows
from ShardedPredictor over every card as from one Predictor. Prints the
card's name and power limit, each run's wall (host clock, the ranks' spawn
included) and launches, and a JSON line last; exits non-zero on a
disagreement. ``--device cpu`` rehearses it on the CPU (gloo ranks, CPU
Predictors, a step of 64 rows) at a small ``--rows``.
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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LOSS_RTOL = 1e-3
STEP_ITERS = 5


def step_rank(rank: int, world: int, address: str, model_parallel: int, devices, batch: int):
    """One rank's ms per full-width train step (bfloat16) on a mesh of
    (world // model_parallel, model_parallel), at a global batch of
    ``batch`` rows of which it steps on its data row's stripe."""
    import chip_smoke
    import torch.distributed as dist
    from clair_tpu_torch.models.clair import ClairNet, init_params
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.parallel.distributed import init_distributed, local_stripe
    from clair_tpu_torch.parallel.mesh import make_mesh
    from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step
    from clair_tpu_torch.parallel.tensor_parallel import TensorParallel, shard_params

    device_type = torch.device(devices[rank]).type
    if device_type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    device = init_distributed(address, world, rank, device_type, device=devices[rank],
                              timeout_s=600)
    try:
        mesh = make_mesh(world, model_parallel, device_type=device_type)
        tp = TensorParallel.of(mesh)
        config = ModelConfig(compute_dtype="bfloat16")
        params = init_params(torch.Generator().manual_seed(1), config)
        if tp is not None:
            params = shard_params(params, tp.index, tp.size)
        model = ClairNet.from_jax(params, config, device, tp)
        step = make_train_step(model, make_optimizer(dict(model.named_parameters()), "Adam",
                                                     1e-3), mesh)
        x, y = chip_smoke.pileup_batch(np.random.RandomState(14), batch)
        rows = local_stripe(batch, mesh.get_local_rank("data"), mesh.get_group("data").size())
        xd = torch.from_numpy(x[rows].astype(np.int16)).to(device)
        yd = torch.from_numpy(y[rows].astype(np.int16)).to(device)
        generator = torch.Generator(device=device).manual_seed(0)

        def synchronized():
            if device_type == "cuda":
                torch.cuda.synchronize(device)
            dist.barrier()

        step(xd, yd, generator, 0.005)
        synchronized()
        started = time.perf_counter()
        for _ in range(STEP_ITERS):
            step(xd, yd, generator, 0.005)
        synchronized()
        return (time.perf_counter() - started) / STEP_ITERS * 1e3
    finally:
        dist.destroy_process_group()


def compare_calling(tmp: Path, devices, cuda: bool, summary: dict) -> None:
    """call_bam on the simulated genome through one Predictor and through
    ShardedPredictor over ``devices``: the same VCF rows."""
    import chip_smoke
    from clair_tpu_torch.models.checkpoint import load_checkpoint
    from clair_tpu_torch.ops import launch_counts, launches_since
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.pipeline.call_bam import CallBamConfig, call_bam
    from clair_tpu_torch.pipeline.call_var import Predictor, ShardedPredictor

    n = len(devices)
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=4)
    parser.add_argument("--model_parallel", default="1",
                        help="model-axis widths to train at, comma-separated (each must "
                             "divide --devices)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--rows", type=int, default=24_000)
    args = parser.parse_args()

    import chip_smoke
    from clair_tpu_torch.data.bins import load_bin
    from clair_tpu_torch.ops import launch_counts, launches_since
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.parallel.distributed import free_port, spawn
    from clair_tpu_torch.parallel.mesh import visible_devices
    from clair_tpu_torch.pipeline.train import TrainingConfig, train_model, train_on_devices

    n, cuda = args.devices, args.device == "cuda"
    widths = [int(m) for m in args.model_parallel.split(",")]
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
        failures = []
        for m in widths:
            name = f"{n} ranks, model_parallel {m}"
            started = time.perf_counter()
            result, launches = train_on_devices(
                functools.partial(load_bin, str(bin_fn)),
                dataclasses.replace(config, device=args.device), n, devices=devices,
                timeout_s=900, model_parallel=m)
            runs[name] = (result, launches, time.perf_counter() - started)
            rel = max(abs(a - b) / abs(b) for key in ("training_losses", "validation_losses")
                      for (a, _), (b, _) in zip(getattr(result, key), getattr(single, key)))
            step_ms = spawn(step_rank, n, (n, f"localhost:{free_port()}", m, devices,
                                           10_000 if cuda else 64), timeout_s=900)[0]
            print(f"  train {name}: training loss sums {result.training_losses}, validation "
                  f"{result.validation_losses}, kernel launches {launches}, wall "
                  f"{runs[name][2]:.2f} s; vs one process: max rel diff of the loss sums "
                  f"{rel:.3e} (limit {LOSS_RTOL}); train step {step_ms:.2f} ms on {card}")
            summary.setdefault("train_max_rel_diff", {})[m] = rel
            summary.setdefault("step_ms", {})[m] = step_ms
            # every width is run and printed before a disagreement raises
            if rel > LOSS_RTOL:
                failures.append(f"{name}: loss sums {rel:.3e} from one process's")
            if launches != {k: n * v for k, v in runs["one process"][1].items()}:
                failures.append(f"{name}: launches {launches}")
        single_run = runs["one process"]
        print(f"  train one process: training loss sums {single_run[0].training_losses}, "
              f"validation {single_run[0].validation_losses}, kernel launches "
              f"{single_run[1]}, wall {single_run[2]:.2f} s")
        summary["train"] = {k: {"wall_s": w, "launches": l} for k, (_, l, w) in runs.items()}
        assert not failures, failures
        compare_calling(tmp, devices, cuda, summary)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
