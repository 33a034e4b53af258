"""Smoke test of the PyTorch port (clair_tpu_torch) on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing its results and seconds:

1. the card (nvidia-smi name and power limit); no CUDA device -> exit 1
2. build every kernel in clair_tpu_torch/csrc/ (one nvcc each, all at once)
3. the streaming forward kernel against its plain PyTorch version (at the
   calling, training and phase 11's shapes), and at
   every launchable (cluster size, rows per tile) at a small batch: bf16
   over its cluster kernel's geometries, float32 over the sweep's
   3b. the resident train pair (use_pallas_train_bilstm) against its plain
       versions and torch.autograd, and two backward runs bit for bit, at
       every TRAIN_GEOMETRIES geometry; its forward at every launchable
       (cluster size, rows per tile) of the sweep at a small batch, and its
       backward at every geometry of the reverse sweep that fits (each
       must launch) at that batch and at H = 8; a CUDA width the kernels do
       not take raises
   3c. use_pallas_bilstm's recurrence kernel (the sweep on the caller's
       xw) against its plain version in the three dtype pairs the model
       gives it, at the launcher's geometry and at every launchable
       (cluster size, rows per tile) for U's piece count; a CUDA width the
       sweep does not take raises
   3d. the two-layer bilstm2 against the two plain layers, at every
       BILSTM2_BATCHES batch and every launchable sweep geometry
4. the streaming backward kernel against its plain PyTorch version, and
   against torch.autograd of the plain forward, on the card, at both
   layers' widths, the training batch, a ragged batch, T = 1 and T = 2
   (every row at a sequence edge), F = H = 8 and F = H = 8 over more tiles
   than multiprocessors; two runs at
   the training shape of lstm2 bit for bit; its float32 mode at every
   geometry of the reverse sweep that fits (each must launch) at a small
   batch and at H = 8;
   a float32 width the reverse sweep does not take raises
   4b. poisoned memory (every torch.empty filled: NaN in floating types,
       so a kernel that reads bytes nobody wrote gives NaN): every kernel
       against its plain version at the recipes' geometries (rows 1 and 2
       in both dtypes, with and without c and dx; rows 3-6), no NaN and
       each output within its bound; then rows 1 and 2 in float32 launched
       as often as one 11b run launches them at each of its geometries
       (RECIPE_LAUNCHES, counted by tools/torch_recipe_nan.py), still
       poisoned: every launch bit for bit the first, and finite
5. the full-width forward of examples/ont_production.ckpt on the card
   against the plain forward on the CPU, float32, batch 512
6. three full-width Adam steps of make_train_step on the card (kernels)
   against the same steps on the CPU (plain), float32, batch 512
   6b. the same under use_pallas_train_bilstm (the train pair)
7. the calling path: ``python -m clair_tpu_torch call_bam`` on a simulated
   ONT genome with examples/ont_synthetic.ckpt, in the default bfloat16 and
   in float32; recall and precision against the planted truth, the same
   decisions in both dtypes, and the kernels' launch counts in each run
   7b. ``call_bam.call_bam`` with ``Predictor(params, ModelConfig(
       use_pallas_bilstm=True, compute_dtype=d))`` on the same genome, in
       bfloat16 and float32; the float32 decisions equal phase 7's
   7c. ``python -m clair_tpu_torch call_bam_parallel --run --process_pool``
       over the genome's three 10 kb windows with two worker processes (each
       builds its Predictor on the card), then with one: every joblog line
       ok, the same VCF rows from both, recall and precision at the floors
8. the training path: ``python -m clair_tpu_torch train`` at batch 10,000 on
   a bin of 24,000 learnable rows written by the port, in the default
   bfloat16 and in float32; finite losses that fall, checkpoints that load,
   the evaluation report, and both kernels' launch counts in each run
   8b. ``train_model`` under ``use_pallas_train_bilstm``, float32, on the
       same bin: the same checks, only the train pair launching
   8c. phase 7's BAM and a truth VCF of its planted variants through the
       port's CLI alone, one process a command: get_truth, extract_candidates
       --gen4Training, create_tensor (candidates, truth sites),
       pair_with_non_variants, tensor2bin over each half of the contig,
       combine_bins, train (full width, two epochs), call_bam with the new
       checkpoint; the bin holds every paired line and every planted variant
       with a non-reference genotype, finite losses, checkpoints that load,
       only the streaming pair launching in train, a well-formed VCF
10. the commands that need the model, and more than one device, on the card
   (run after 8c, on phase 7's genome and phase 8's bin):
   10a. forward_activations of examples/ont_production.ckpt at B = 512 on
        the card (row 1, float32) against the plain version on the CPU,
        name by name; ``call_var --activation_only`` through the CLI: the
        npz files, row 1 launching twice a batch
   10b. ``learning_rate_finder`` through the CLI on phase 8's bin at batch
        10,000: rising learning rates, finite losses, the two suggested
        lines, only rows 1 and 2 launching
   10c. ``train --profile_dir`` on phase 8's bin (one epoch): the trace holds
        rows 1 and 2 by name; each train step's device time split by kernel
        and by the rest (tools/torch_trace_split.py)
   10d. data-parallel training (DistributedDataParallel under make_mesh) on
        the one card, dropout off, on phase 8's bin: world size 1 on NCCL
        against the unwrapped train_model (the same losses), and two ranks
        on cuda:0 with gloo against one process (losses within rtol 1e-3),
        the ranks' launches summed
   10e. call_bam through ShardedPredictor(devices=["cuda:0", "cuda:0"]): the
        rows of phase 7's bfloat16 run; ``call_bam --num_devices 2`` on a
        one-card machine raises
   10f. the model axis on the one card: train_model on a (1, 2) mesh (two
        gloo ranks on cuda:0, the dense trunk split between them) against
        the unwrapped train_model, phase 8's bin, float32, dropout off:
        loss sums within rtol 1e-3 and the same best epoch, the gathered
        parameters within rtol 1e-3, atol 1e-5 of the unwrapped run's but
        for a 1e-3 share of each leaf, the ranks' launches twice its (rows
        1 and 2 only); then the first train step with dropout on, on the
        mesh and in one process: the global norm before the clip within
        rtol 1e-5, each leaf's gradient within 1e-4 of its largest
   10g. the scan BiLSTM (the JAX package's lax.scan, models/bilstm.py:
        bilstm_scan): each layer at full width on the card against the
        same function on the CPU, forward and gradients, at B = 512 (the
        hoisted step form) and 10,000 (the fused form, its steps
        recomputed in the backward), float32 and bfloat16; the float32
        scan against row 1 at B = 512; ``train --no_stream_bilstm`` on
        phase 8's bin in bfloat16 and float32 (finite losses that fall, no
        kernel launching) beside phase 8's default runs (rows 1 and 2
        launching); three full-width Adam steps of the scan, card vs CPU;
        its train step at B = 10,000 and its peak memory, beside the
        streaming pair's step
11. the repo's train-to-accuracy recipes on the card, in this process, every
   launch count set to 0 just before each run and read just after:
   11a. ``demo.run_demo`` at ``--quick --profile ont`` (30 kb, 150 planted
        variants, 400 epochs of the narrow model, H = 32, bfloat16): recall
        at the demo's floor; precision, exact and the SNP/indel split
   11b. ``examples.train_synthetic.main --profile ont --train_compute_dtype
        float32`` (the vendored checkpoints' recipe: 150 kb, 700 variants,
        the full-width model, 400 epochs at batch 256), its checkpoint in the
        JAX layout, and its held-out genome (seed 424243, 30 kb) at the
        vendored models' floors (recall and precision 0.9, exact 0.85 n)
   In both, row 2 launches twice a train step, row 1 at least twice a train
   and a validation step, no other kernel and never the scan; the bin's
   short last training batch is the one phases 3 and 4 check.
   11c. the vendored ccs and ilmn models on their held-out genomes (seed
        424242, 30 kb) and the production model on its 40 kb held-out
        flowcell, at tests/test_trained_model_e2e.py's floors
9. times (CUDA events after warm-up) beside the card's name and power limit;
   the streaming forward per layer at B = 512 and 10,000 in both dtypes
   (float32 beside the float32 FMA kernel's times that the sweep replaced);
   the model's calling forward at B = 512 in both dtypes, streaming and
   under use_pallas_bilstm; the train step and its peak memory
   9a. the two backwards (rows 2 and 6) and the float32 forwards (row 5,
       and row 1's float32 mode) split by kernel (torch.profiler) at
       B = 10,000; the float32 reverse sweep of rows 2 and 6 beside the
       float32 FMA sweep's times that it replaced
   9b. the other kernels' times, and the train step under each training pair
   9c. bilstm2 as a library call on the vendored checkpoint's two layers
   9d. each kernel's bound (the least time the card could take for its
       work) and the time of the one PyTorch call that computes the same
       function, where there is one (torch.nn.LSTM, cuDNN, TF32 off); row
       1's float32 mode too, at B = 512 and 10,000, and row 2's at 10,000

Each run of phases 7, 7b, 7c, 8, 8b, 8c and 10a-10g runs in a process of
its own, so the launch counts it reports start from 0 just before it and
are read just after it (phase 11's runs set them to 0 in this process);
the processes a run spawns (7c's pool workers, 10d's and 10f's ranks)
return their counts, which the run adds to its own. 9c sets bilstm2's
count to 0 just before its call. Any failed
phase raises, so the script exits non-zero without the last line. The last
two lines are a JSON summary of the kernels and the device line
``{"ok": true, "device": {...}}``. Nothing here imports JAX or the JAX
package; phase 2 also builds the port's native host library (C++ pileup and
decode) and says whether it loaded.
"""

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNELS = {
    "bilstm_stream": {
        "name": "bilstm_stream_fwd",
        "route": "cuda",
        "source": "clair_tpu_torch/csrc/bilstm_stream_fwd.cu",
        "replaces": "clair_tpu/ops/pallas_bilstm_stream.py:56",
    },
    "bilstm_stream_backward": {
        "name": "bilstm_stream_bwd",
        "route": "cuda",
        "source": "clair_tpu_torch/csrc/bilstm_stream_bwd.cu",
        "sources": ["clair_tpu_torch/csrc/bilstm_stream_bwd.cu",
                    "clair_tpu_torch/csrc/wgmma_product.cuh"],
        "replaces": "clair_tpu/ops/pallas_bilstm_stream.py:80",
    },
    "bilstm_train": {
        "name": "bilstm_train_fwd",
        "route": "cuda",
        "source": "clair_tpu_torch/csrc/bilstm_train.cu",
        "replaces": "clair_tpu/ops/pallas_bilstm_train.py:56",
    },
    "bilstm_train_backward": {
        "name": "bilstm_train_bwd",
        "route": "cuda",
        "source": "clair_tpu_torch/csrc/bilstm_train.cu",
        "replaces": "clair_tpu/ops/pallas_bilstm_train.py:84",
    },
    "bilstm_precomputed": {
        "name": "bilstm_recurrence",
        "route": "cuda",
        "source": "clair_tpu_torch/csrc/bilstm.cu",
        "sources": ["clair_tpu_torch/csrc/bilstm.cu", "clair_tpu_torch/csrc/lstm_sweep.cuh"],
        "replaces": "clair_tpu/ops/pallas_bilstm.py:36",
    },
    "bilstm2": {
        "name": "bilstm2",
        "route": "cuda",
        "source": "clair_tpu_torch/csrc/lstm_sweep.cuh",
        "replaces": "clair_tpu/ops/pallas_bilstm2.py:43",
    },
}
STREAM_PAIR = ("bilstm_stream", "bilstm_stream_backward")
TRAIN_PAIR = ("bilstm_train", "bilstm_train_backward")
# forward kernel vs plain on the card: float32 sums run in another order
# over 33 steps; bf16 h is rounded to a 2**-8 step every step (h and c)
F32_TOL, BF16_TOL = 1e-4, 2e-2
# row 1's float32 mode at lstm2's width (F = 256), kernel vs plain: twice
# the worst error phase 3 measured there (c at B = 10,000: 2.861e-06 on an
# NVIDIA H100 80GB HBM3 at 700 W) once the x.W product summed its (0, 0)
# piece pair apart from the smaller pairs (csrc/mma_product.cuh,
# "Numerics"; tools/torch_xw_error.py: h then 1.157e-06 from float64, the
# plain version 1.663e-06)
ROW1_F32_TOL_F256 = 2 * 2.861e-6
# phase 11's recipes at their batches: training at 256, validation at 32,
# calling at 256, at full width (H = 128) and at the demo's narrow width
# (H = 32: lstm1 F = 32, lstm2 F = 64); and the short last training batch
# of each recipe's bin (n_train % 256 of the 1,753-row 11b bin and of the
# 459-row 11a bin; phase 11 asserts them)
SYNTHETIC_SHORT_BATCH, DEMO_SHORT_BATCH = 41, 157
RECIPE_GEOMETRIES = ((256, 33, 32, 128), (256, 33, 256, 128), (32, 33, 256, 128),
                     (256, 33, 32, 32), (256, 33, 64, 32), (32, 33, 64, 32),
                     (SYNTHETIC_SHORT_BATCH, 33, 32, 128), (SYNTHETIC_SHORT_BATCH, 33, 256, 128),
                     (DEMO_SHORT_BATCH, 33, 32, 32), (DEMO_SHORT_BATCH, 33, 64, 32))
# rows 1 and 2's float32 launches in one 11b run, by (row, B, F, with c /
# with dx): 400 epochs of six training steps at 256 and one at 41, five
# validation steps at 32 and one at 16, and the held-out genome's one
# calling batch at 256 (tools/torch_recipe_nan.py recipe, which counts them;
# 10,402 of row 1 and 5,600 of row 2); phase 4b launches each as often
RECIPE_LAUNCHES = tuple((row, b, f, flag, n) for f in (32, 256) for row, b, flag, n in (
    (1, 256, True, 2400), (1, 256, False, 1), (1, SYNTHETIC_SHORT_BATCH, True, 400),
    (1, 32, False, 2000), (1, 16, False, 400), (2, 256, f != 32, 2400),
    (2, SYNTHETIC_SHORT_BATCH, f != 32, 400)))
# the forward at the shapes the calling path (B = 512) and the training path
# (B = 10,000, c saved for the backward) give it, a batch of 12, a ragged
# batch of 13 (no multiple of the 4-row tile), a tiny odd geometry and F and
# H no multiples of 8 (float32 pads them), and the recipes' shapes
FWD_GEOMETRIES = ((512, 33, 32, 128), (512, 33, 256, 128), (10000, 33, 32, 128),
                  (10000, 33, 256, 128), (12, 33, 32, 128), (13, 33, 256, 128),
                  (8, 7, 16, 8), (13, 9, 12, 20), *RECIPE_GEOMETRIES)
# backward kernel vs plain: float32 max |diff| of each gradient within this
# share of the reference's max |value| (the 3e-4 family of
# tests/test_pallas_bilstm_stream.py; sums over up to 330,000 rows in
# another order); bf16 gradients by cosine, as that file's bf16 test, and
# by max |diff| within BF16_REL_TOL of the reference's max |value| (bf16 dx
# is rounded to a 2**-8 step)
BWD_REL_TOL, BF16_COSINE, BF16_REL_TOL = 3e-4, 0.99, 1e-2
FORWARD_TOL = 1e-4          # probabilities, card vs CPU, float32
# phase 10g: the scan on the card against the scan on the CPU, each layer's
# output and every gradient: float32 within SCAN_F32_REL of the array's
# largest |value| (sums in another order); bfloat16 within the bounds of
# tests/test_torch_scan_bilstm.py (outputs: max and mean |difference|;
# gradients: of the largest |value|)
SCAN_F32_REL = 1e-5
SCAN_BF16_MAX, SCAN_BF16_MEAN, SCAN_BF16_GRAD_REL = 2.0 ** -6, 2.0 ** -11, 2.0 ** -5
# the step forms: hoisted at the calling batch, fused at the training batch
SCAN_BATCHES = (512, 10_000)
# the float32 scan against row 1 at B = 512: the JAX package's bound
# between its two step forms (tests/test_model.py:145-162)
SCAN_ROW1_ATOL, SCAN_ROW1_RTOL = 2e-4, 1e-4
STEP_RTOL = 3e-4            # train-step losses, card vs CPU, float32
RECALL_FLOOR = PRECISION_FLOOR = 0.9
# the simulated ONT genome of phases 7 to 8c, and phase 7c's windows on it
GENOME_LENGTH, POOL_CHUNK = 30_000, 10_000
POOL_WINDOWS = GENOME_LENGTH // POOL_CHUNK
TRAIN_ROWS, TRAIN_EPOCHS = 24_000, 2
# row 2 run twice and compared bit for bit at the training shape of lstm2
BITWISE_GEOMETRY = (10000, 33, 256, 128)
# the forward at every launchable geometry: one small ragged batch
GEOMETRY_BATCH = 100
# the backward at both layers' widths, the training batch, a ragged batch
# (B*T = 429, no multiple of the products' 64- and 128-row tiles), T = 1 and
# T = 2 (every row at a sequence edge, where h_prev is the zero state),
# F = H = 8 (every box of the bf16 products mostly past the operands' edges)
# and H = 8 at B*T = 13,200 (more gate tiles than multiprocessors, each one
# epilogue chunk: a block's tiles reuse its chunk buffers)
BWD_GEOMETRIES = ((512, 33, 32, 128), (512, 33, 256, 128), (10000, 33, 256, 128),
                  (13, 33, 256, 128), (8, 7, 16, 8), (5, 1, 32, 128), (6, 2, 256, 128),
                  (9, 33, 8, 8), (400, 33, 8, 8), *RECIPE_GEOMETRIES)
# the train pair at the training batch (10,000) and at 512 for both layers,
# a ragged batch (13, no multiple of the sweeps' 8- and 16-row tiles) and a
# tiny odd geometry;
# use_pallas_bilstm's kernel at the calling batch and a ragged one (and, at
# every sweep geometry, also GEOMETRY_BATCH and the tiny odd geometry);
# bilstm2 at the calling batch, a ragged one and the training batch
TRAIN_GEOMETRIES = ((10000, 33, 32, 128), (10000, 33, 256, 128), (512, 33, 32, 128),
                    (512, 33, 256, 128), (13, 33, 256, 128), (8, 7, 16, 8))
PRECOMPUTED_GEOMETRIES = ((512, 33, 32, 128), (512, 33, 256, 128), (13, 33, 32, 128),
                          (13, 33, 256, 128))
BILSTM2_BATCHES = (512, 13, 10000)
# the card's peaks (NVIDIA's H100 SXM data sheet, dense, at 700 W): float32
# outside the tensor cores, bf16 on them, and device memory
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
T_LEN, HIDDEN, CALL_BATCH, TRAIN_BATCH = 33, 128, 512, 10_000
LAYERS = (("lstm1", 32), ("lstm2", 256))
# row 1's float32 mode as the float32 FMA kernel ran it before the sweep, ms
# per (layer, batch) (B = 10,000 with c): phase 9 of this script on an
# NVIDIA H100 80GB HBM3 at 700 W, beside which phase 9 prints the sweep's
ROW1_F32_FMA_MS = {("lstm1", 512): 0.2576, ("lstm2", 512): 0.9695,
                   ("lstm1", 10_000): 4.6980, ("lstm2", 10_000): 14.5463}
# the float32 reverse sweep of rows 2 and 6 as the float32 FMA sweep ran it
# before the cluster sweep, ms a layer at B = 10,000
# (tools/torch_stream_bwd_parts.py on an NVIDIA H100 80GB HBM3 at 700 W),
# beside which phase 9a prints the cluster sweep's
FMA_SWEEP_MS = {(2, "lstm1"): 5.355, (2, "lstm2"): 5.381,
                (6, "lstm1"): 5.442, (6, "lstm2"): 5.262}
# the reverse sweep at every geometry that fits: both layers' widths at
# GEOMETRY_BATCH, and the tiny odd geometry (H = 8)
BWD_SWEEP_SHAPES = ((GEOMETRY_BATCH, T_LEN, 32, HIDDEN), (GEOMETRY_BATCH, T_LEN, 256, HIDDEN),
                    (8, 7, 16, 8))

# calling under use_pallas_bilstm, in a process of its own (phase 7b)
CALL_SCRIPT = """
import json, sys
from clair_tpu_torch.ops import launch_counts
from clair_tpu_torch.models.checkpoint import load_checkpoint
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline.call_bam import CallBamConfig, call_bam
from clair_tpu_torch.pipeline.call_var import Predictor
bam, fasta, ckpt, out, dtype = sys.argv[1:]
params, _ = load_checkpoint(ckpt)
# the flags of phase 7's call_bam command: --ctgName chr1 --threshold 0.2
config = CallBamConfig(bam_path=bam, fasta_path=fasta, contig="chr1", minimum_af=0.2)
predictor = Predictor(params, ModelConfig(use_pallas_bilstm=True, compute_dtype=dtype))
total = call_bam(config, predictor, output_path=out)
print(f"[INFO] {total} candidate sites processed", file=sys.stderr)
print(json.dumps({"kernel_launches": launch_counts()}), file=sys.stderr)
"""
# training under use_pallas_train_bilstm, in a process of its own (phase 8b)
TRAIN_SCRIPT = """
import json, logging, sys
from clair_tpu_torch.ops import launch_counts
from clair_tpu_torch.data.bins import load_bin
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline.train import TrainingConfig, train_model
logging.basicConfig(format="%(message)s", level=logging.INFO)
bin_fn, prefix, epochs = sys.argv[1], sys.argv[2], int(sys.argv[3])
result = train_model(load_bin(bin_fn), TrainingConfig(
    model=ModelConfig(use_pallas_train_bilstm=True), train_compute_dtype="float32",
    output_prefix=prefix, max_epochs=epochs, hard_max_epochs=epochs))
print(json.dumps({"kernel_launches": launch_counts(),
                  "training_losses": result.training_losses,
                  "validation_losses": result.validation_losses,
                  "best_epoch": result.best_epoch}), file=sys.stderr)
"""
# phase 10d: data-parallel training on the one card, in a process of its own
# (it spawns the ranks): the unwrapped run, world size 1 on NCCL, two ranks
# on cuda:0 with gloo
DDP_SCRIPT = """
import dataclasses, functools, json, logging, sys, time
from clair_tpu_torch.data.bins import load_bin
from clair_tpu_torch.ops import launch_counts, launches_since
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline.train import TrainingConfig, train_model, train_on_devices
logging.basicConfig(format="%(message)s", level=logging.INFO)
bin_fn, epochs = sys.argv[1], int(sys.argv[2])
model = dataclasses.replace(ModelConfig(), lstm2_dropout_rate=0.0, l4_dropout_rate=0.0,
                            l5_dropout_rate=0.0)
config = TrainingConfig(model=model, schedule="fixed", max_epochs=epochs,
                        evaluate_at_end=False, device="cuda")
load = functools.partial(load_bin, bin_fn)
runs = {}
before, started = launch_counts(), time.perf_counter()
single = train_model(load(), config)
runs["single"] = (single, launches_since(before), time.perf_counter() - started)
started = time.perf_counter()
runs["nccl_1"] = (*train_on_devices(load, config, 1, timeout_s=600),
                  time.perf_counter() - started)
started = time.perf_counter()
runs["gloo_2"] = (*train_on_devices(load, config, 2, backend="gloo",
                                    devices=["cuda:0", "cuda:0"], timeout_s=600),
                  time.perf_counter() - started)
print(json.dumps({k: {"training_losses": r.training_losses,
                      "validation_losses": r.validation_losses,
                      "best_epoch": r.best_epoch, "kernel_launches": launches, "wall": wall}
                  for k, (r, launches, wall) in runs.items()}), file=sys.stderr)
"""
# phase 10f: the model axis on the one card, in a process of its own (it
# spawns the ranks): the unwrapped run, and two gloo ranks on cuda:0 on a
# (1, 2) mesh; the parameters, and the first step's gradients, are compared
# here, leaf by leaf
MODEL_PARALLEL_SCRIPT = """
import dataclasses, functools, json, logging, sys, time
import numpy as np
from clair_tpu_torch.data.bins import load_bin
from clair_tpu_torch.models.clair import param_shapes
from clair_tpu_torch.ops import launch_counts, launches_since
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.parallel.distributed import free_port, spawn
from clair_tpu_torch.parallel.tensor_parallel import shard_dim
from clair_tpu_torch.pipeline.train import TrainingConfig, train_model, train_on_devices
from chip_smoke import first_step
logging.basicConfig(format="%(message)s", level=logging.INFO)
bin_fn, epochs = sys.argv[1], int(sys.argv[2])
model = dataclasses.replace(ModelConfig(), lstm2_dropout_rate=0.0, l4_dropout_rate=0.0,
                            l5_dropout_rate=0.0)
# the final parameters on both sides (no best-epoch snapshot to restore)
config = TrainingConfig(model=model, schedule="fixed", max_epochs=epochs, evaluate_at_end=False,
                        train_compute_dtype="float32", restore_best=False, device="cuda")
load = functools.partial(load_bin, bin_fn)
runs = {}
before, started = launch_counts(), time.perf_counter()
single = train_model(load(), config)
runs["single"] = (single, launches_since(before), time.perf_counter() - started)
started = time.perf_counter()
runs["model_2"] = (*train_on_devices(load, config, 2, backend="gloo",
                                     devices=["cuda:0", "cuda:0"], timeout_s=600,
                                     model_parallel=2),
                   time.perf_counter() - started)
def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)
want = dict(leaves(single.params))
# by leaf: its size, its elements outside rtol 1e-3, atol 1e-5 of the
# unwrapped run's, the largest |difference|, whether all are finite
params = {name: [value.size,
                 int(np.sum(np.abs(value - want[name]) > 1e-5 + 1e-3 * np.abs(want[name]))),
                 float(np.max(np.abs(value - want[name]))), bool(np.isfinite(value).all())]
          for name, value in leaves(runs["model_2"][0].params)}
full_shapes = ({name: value.shape for name, value in leaves(runs["model_2"][0].params)}
               == {name: tuple(shape) for name, shape in leaves(param_shapes(model))})
# the first train step, dropout on, in this process and on the mesh: each
# leaf's largest |gradient difference| over its largest |gradient| (a split
# leaf's shards joined), and the global norms
one = first_step(0, 1, None, bin_fn)
ranks = spawn(first_step, 2, (2, f"localhost:{free_port()}", bin_fn), timeout_s=600)
grads = {}
for name, want in one["grads"].items():
    dim = shard_dim(name)
    got = ([np.concatenate([r["grads"][name] for r in ranks], dim)] if dim is not None
           else [r["grads"][name] for r in ranks])
    grads[name] = max(float(np.abs(g - want).max()) for g in got) / float(np.abs(want).max())
step = {"grads": grads, "norm": one["norm"], "rank_norms": [r["norm"] for r in ranks],
        "loss": one["loss"], "rank_losses": [r["loss"] for r in ranks]}
print(json.dumps({"params": params, "full_shapes": full_shapes, "first_step": step,
                  **{k: {"training_losses": r.training_losses,
                         "validation_losses": r.validation_losses,
                         "kernel_launches": launches, "wall": wall}
                     for k, (r, launches, wall) in runs.items()}}), file=sys.stderr)
"""
# phase 10e: call_bam through two Predictors on the one card
SHARDED_SCRIPT = """
import json, sys
from clair_tpu_torch.ops import launch_counts
from clair_tpu_torch.models.checkpoint import load_checkpoint
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline.call_bam import CallBamConfig, call_bam
from clair_tpu_torch.pipeline.call_var import ShardedPredictor
bam, fasta, ckpt, out = sys.argv[1:]
params, _ = load_checkpoint(ckpt)
# phase 7's call_bam flags and its bfloat16 default
config = CallBamConfig(bam_path=bam, fasta_path=fasta, contig="chr1", minimum_af=0.2)
predictor = ShardedPredictor(params, ModelConfig(compute_dtype="bfloat16"),
                             devices=["cuda:0", "cuda:0"])
total = call_bam(config, predictor, output_path=out)
print(f"[INFO] {total} candidate sites processed", file=sys.stderr)
print(json.dumps({"kernel_launches": launch_counts()}), file=sys.stderr)
"""
# the train step split from 10c's trace (tools/torch_trace_split.py)
DDP_RTOL = 1e-3
# phase 10f's parameters against the unwrapped run's: elementwise within
# rtol 1e-3, atol 1e-5 (tests/test_parallel.py's), but for a 1e-3 share of
# each leaf at most. While a gradient is new Adam moves an element by about
# lr * sign(g), so an element whose gradient sums to near 0 over the batch
# moves up to 2 lr a step apart where two right reductions round it to
# opposite signs; a wrong shard or gather puts most of a leaf outside
PARAM_OUTSIDE_SHARE = 1e-3
# 10f's first step, where Adam has not amplified a rounding yet: the global
# norm before the clip (tests/test_torch_model_parallel.py's rtol), and each
# leaf's gradient against its largest |element| (float32 sums over 10,000
# rows in another order); a doubled or missing sum, or dropout masks that
# differ between the ranks, move both by far more
NORM_RTOL, GRAD_RTOL = 1e-5, 1e-4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase(name, started):
    print(f"[phase] {name}: {time.perf_counter() - started:.2f} s", flush=True)


def cuda_ms(fn, iters=20) -> float:
    """Mean device time of fn() over iters runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_counts():
    from clair_tpu_torch.ops import launch_counts

    return launch_counts()


def launched_since(before):
    from clair_tpu_torch.ops import launches_since

    return launches_since(before)


def lstm_params(rs, feat, hidden, device):
    def one():
        scale = 1.0 / np.sqrt(hidden)
        return {"w": torch.tensor(rs.randn(feat, 4 * hidden) * scale, dtype=torch.float32, device=device),
                "u": torch.tensor(rs.randn(hidden, 4 * hidden) * scale, dtype=torch.float32, device=device),
                "b": torch.tensor(rs.randn(4 * hidden) * 0.1, dtype=torch.float32, device=device)}
    return {"fw": one(), "bw": one()}


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def build_all():
    """Phase 2: one nvcc per source and the native host library (g++), all
    started together."""
    from clair_tpu_torch import native
    from clair_tpu_torch.ops import build

    names = sorted(p.stem for p in (ROOT / "clair_tpu_torch" / "csrc").glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names) + 1) as pool:
        host = pool.submit(native.available)
        libs = dict(zip(names, pool.map(build.build, names)))
        loaded = host.result()
    built = ("built before this run" if native.BUILD_SECONDS is None
             else f"built in {native.BUILD_SECONDS:.2f} s")
    print(f"  native host library {Path(native._lib_path()).relative_to(ROOT)}: "
          f"loaded {loaded}, {built}")
    assert loaded, f"the port's native host library did not build or load:\n{native.BUILD_ERROR}"
    for name, lib in libs.items():
        report = build.BUILD_REPORTS.get(name)
        regs = ([line.strip() for line in report.splitlines()
                 if "registers" in line or "spill stores" in line]
                if report is not None else "built before this run")
        print(f"  {lib.relative_to(ROOT)}: {regs}")


def check_kernel(dev):
    """Phase 3: forward kernel vs plain, h and c, at FWD_GEOMETRIES: float32
    within F32_TOL (ROW1_F32_TOL_F256 at F = 256), bf16 within BF16_TOL."""
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream, bilstm_stream_reference

    max_err = 0.0
    before = bilstm_stream.launches
    calls = 0
    for b, t, f, h in FWD_GEOMETRIES:
        rs = np.random.RandomState(b + f + h)
        params = lstm_params(rs, f, h, dev)
        x = torch.tensor(rs.randn(b, t, f), dtype=torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            h_k, c_k = bilstm_stream(params, xd, with_cell=True)
            h_p, c_p = bilstm_stream_reference(params, xd)
            calls += 1
            torch.cuda.synchronize()
            err_h = (h_k.float() - h_p.float()).abs().max().item()
            err_c = (c_k - c_p).abs().max().item()
            assert h_k.dtype == dtype and c_k.dtype == torch.float32
            print(f"  kernel vs plain {(b, t, f, h)} {str(dtype)[6:]}: "
                  f"max|dh| {err_h:.3e} max|dc| {err_c:.3e}")
            if dtype == torch.float32:
                tol = ROW1_F32_TOL_F256 if f == 256 else F32_TOL
                assert err_h <= tol and err_c <= tol, ((b, t, f, h), err_h, err_c, tol)
                max_err = max(max_err, err_h, err_c)
            else:
                assert err_h <= BF16_TOL and err_c <= BF16_TOL, (err_h, err_c)
    assert bilstm_stream.launches == before + calls, "the kernel did not launch"
    # a float32 width that no sweep geometry fits raises before any launch
    wide = lstm_params(np.random.RandomState(3), 8, 264, dev)
    try:
        bilstm_stream(wide, torch.zeros((2, 3, 8), device=dev))
    except ValueError as refused:
        print(f"  float32 H=264 refused before a launch: {refused}")
    else:
        raise AssertionError("the float32 forward took H = 264 on the card")
    assert bilstm_stream.launches == before + calls
    return max(max_err, check_forward_geometries(dev))


def check_forward_geometries(dev):
    """Phase 3, second part: the forward at every (cluster size, rows per
    tile) that launches (clair_bilstm_stream_fwd_geometry), at a small
    ragged batch of each layer's width, in both dtypes, against the plain
    version within F32_TOL (ROW1_F32_TOL_F256 at F = 256) / BF16_TOL (idle
    warps at the larger clusters, where a race once hid): bf16 over
    FWD_CLUSTERS x FWD_ROWS, float32 over every geometry of the sweep that
    fits (f32_geometries)."""
    from clair_tpu_torch.ops.bilstm_stream import (
        FWD_CLUSTERS, FWD_ROWS, _stack_params, bilstm_stream_reference, f32_geometries,
        forward_geometry,
    )

    max_err = 0.0
    for layer, feat in LAYERS:
        rs = np.random.RandomState(feat + 2)
        params = lstm_params(rs, feat, HIDDEN, dev)
        x = torch.tensor(rs.randn(GEOMETRY_BATCH, T_LEN, feat), dtype=torch.float32, device=dev)
        bf16_geometries = [(c, r) for c in FWD_CLUSTERS for r in FWD_ROWS]
        f32_tol = ROW1_F32_TOL_F256 if feat == 256 else F32_TOL
        for dtype, tol, geometries in ((torch.float32, f32_tol, f32_geometries(feat, HIDDEN)),
                                       (torch.bfloat16, BF16_TOL, bf16_geometries)):
            xd = x.to(dtype)
            want_h, want_c = bilstm_stream_reference(params, xd)
            launched, worst = [], 0.0
            for cluster, rows in geometries:
                got = forward_geometry(xd, *_stack_params(params, dtype), cluster, rows)
                if got is None:
                    continue
                torch.cuda.synchronize()
                err = max((got[0].float() - want_h.float()).abs().max().item(),
                          (got[1] - want_c).abs().max().item())
                assert err <= tol, (layer, str(dtype), cluster, rows, err)
                launched.append((cluster, rows))
                worst = max(worst, err)
            assert launched, (layer, dtype)
            if dtype == torch.float32:
                max_err = max(max_err, worst)
            print(f"  forward {layer} B={GEOMETRY_BATCH} {str(dtype)[6:]} at every launchable "
                  f"(cluster, rows), {len(launched)} of {len(geometries)} that fit: "
                  f"max|d| {worst:.3e}; {launched}")
    return max_err


def stacked_inputs(geometry, dev, seed):
    """The train pair's inputs on the stacked layout: xs (T, 2B, F), w, u,
    b, and a cotangent dh (T, 2B, H), from a seed."""
    from clair_tpu_torch.models.bilstm import _stack_directions
    from clair_tpu_torch.ops.bilstm_train import _stack_params

    b, t, f, h = geometry
    rs = np.random.RandomState(seed)
    params = lstm_params(rs, f, h, dev)
    xs = _stack_directions(torch.tensor(rs.randn(b, t, f), dtype=torch.float32, device=dev))
    dh = torch.tensor(rs.randn(t, 2 * b, h), dtype=torch.float32, device=dev)
    return (xs.contiguous(), *_stack_params(params), dh)


def check_train_pair(dev):
    """Phase 3b: the resident forward (h, c) and backward (dx, dW, dU, db)
    kernels vs their plain versions on the same inputs, the backward also
    vs torch.autograd.grad of the plain forward, and two backward runs bit
    for bit (fixed-order partial sums, no atomics)."""
    from clair_tpu_torch.ops.bilstm_train import (
        bilstm_train_backward, bilstm_train_backward_reference, bilstm_train_forward,
        bilstm_train_reference,
    )

    errs = {"bilstm_train": 0.0, "bilstm_train_backward": 0.0}
    before = kernel_counts()
    names = ("dx", "dw", "du", "db")
    for geometry in TRAIN_GEOMETRIES:
        xs, w, u, b, dh = stacked_inputs(geometry, dev, sum(geometry))
        h_out, c_out = bilstm_train_forward(xs, w, u, b)
        h_p, c_p = bilstm_train_reference(xs, w, u, b)
        got = bilstm_train_backward(xs, w, u, b, h_out, c_out, dh)
        again = bilstm_train_backward(xs, w, u, b, h_out, c_out, dh)
        want = bilstm_train_backward_reference(xs, w, u, b, h_out, c_out, dh)
        leaves = [t_.detach().requires_grad_() for t_ in (xs, w, u, b)]
        grads = torch.autograd.grad((bilstm_train_reference(*leaves)[0] * dh).sum(), leaves)
        torch.cuda.synchronize()
        err_h, err_c = ((h_out - h_p).abs().max().item(), (c_out - c_p).abs().max().item())
        assert err_h <= F32_TOL and err_c <= F32_TOL, (geometry, err_h, err_c)
        errs["bilstm_train"] = max(errs["bilstm_train"], err_h, err_c)
        line = [f"max|dh| {err_h:.3e} max|dc| {err_c:.3e}"]
        for name, g, g2, r, a in zip(names, got, again, want, grads):
            assert g.shape == r.shape and torch.isfinite(g).all(), name
            assert torch.equal(g, g2), f"{name}: two runs differ"
            err, scale = (g - r).abs().max().item(), r.abs().max().item()
            err_ag = (g - a).abs().max().item()
            assert err <= BWD_REL_TOL * scale and err_ag <= BWD_REL_TOL * scale, (
                geometry, name, err, err_ag, scale)
            errs["bilstm_train_backward"] = max(errs["bilstm_train_backward"], err)
            line.append(f"{name} {err:.2e}/{scale:.2e}")
        print(f"  train pair vs plain {geometry}: " + ", ".join(line)
              + "; autograd agrees; backward bit-identical over two runs")
    launched = launched_since(before)
    assert launched["bilstm_train"] == len(TRAIN_GEOMETRIES), launched
    assert launched["bilstm_train_backward"] == 2 * len(TRAIN_GEOMETRIES), launched
    errs["bilstm_train"] = max(errs["bilstm_train"], check_sweep_geometries(dev))
    errs["bilstm_train_backward"] = max(errs["bilstm_train_backward"],
                                        check_bwd_sweep_geometries(dev, TRAIN_PAIR))
    # no fallback to the plain version for a CUDA tensor: a width whose
    # 16-byte chunks the products cannot stage (F = 12), or that no sweep
    # geometry fits (H = 264), raises in both kernels before any launch
    before = kernel_counts()
    for geometry in ((4, 5, 12, 8), (2, 3, 8, 264)):
        xs, w, u, b, dh = stacked_inputs(geometry, dev, 7)
        h_out, c_out = bilstm_train_reference(xs, w, u, b)
        for name, run in (("forward", lambda: bilstm_train_forward(xs, w, u, b)),
                          ("backward",
                           lambda: bilstm_train_backward(xs, w, u, b, h_out, c_out, dh))):
            try:
                run()
            except ValueError as refused:
                print(f"  train {name} at F = {geometry[2]}, H = {geometry[3]} on the card "
                      f"raises: {refused}")
            else:
                raise AssertionError(f"the train {name} took {geometry} on the card")
    assert launched_since(before) == dict.fromkeys(before, 0)
    return errs


def check_sweep_geometries(dev):
    """Phase 3b, second part: row 5's forward at every (cluster size, rows
    per tile) of the sweep that launches, at a small ragged batch of each
    layer's width, against the plain version within F32_TOL (h and c). No
    count moves (the geometry runs serve no path)."""
    from clair_tpu_torch.ops.bilstm_train import _forward_launch, bilstm_train_reference
    from clair_tpu_torch.ops.lstm_sweep import sweep_geometries

    worst_all, before = 0.0, kernel_counts()
    for layer, feat in LAYERS:
        xs, w, u, b, _ = stacked_inputs((GEOMETRY_BATCH, T_LEN, feat, HIDDEN), dev, feat + 11)
        want_h, want_c = bilstm_train_reference(xs, w, u, b)
        launched, worst = [], 0.0
        candidates = sweep_geometries(HIDDEN)
        for cluster, rows in candidates:
            got = _forward_launch(xs, w, u, b, cluster=cluster, rows=rows)
            if got is None:
                continue
            torch.cuda.synchronize()
            err = max((got[0] - want_h).abs().max().item(), (got[1] - want_c).abs().max().item())
            assert err <= F32_TOL, (layer, cluster, rows, err)
            launched.append((cluster, rows))
            worst = max(worst, err)
        assert launched, layer
        worst_all = max(worst_all, worst)
        print(f"  row 5 forward {layer} B={GEOMETRY_BATCH} at every launchable (cluster, rows) "
              f"of the sweep, {len(launched)} of {len(candidates)} that fit: max|d| "
              f"{worst:.3e}; {launched}")
    assert launched_since(before) == dict.fromkeys(before, 0)
    return worst_all


def check_bwd_sweep_geometries(dev, pair):
    """Phases 3b and 4, the reverse sweep: a float32 backward (row 6 for
    TRAIN_PAIR, row 2's float32 mode for STREAM_PAIR) at every (cluster
    size, rows per tile) that ``bwd_sweep_geometries`` lists
    (``_backward_launch``, which raises where one does not fit or launch),
    at BWD_SWEEP_SHAPES, against the plain version on the same saved
    forward: dx, dW, dU and db within BWD_REL_TOL of the reference's largest
    |value|. No count moves (the geometry runs serve no path)."""
    from clair_tpu_torch.models.bilstm import bilstm_with_cell
    from clair_tpu_torch.ops import bilstm_stream, bilstm_train
    from clair_tpu_torch.ops.lstm_sweep import bwd_sweep_geometries

    train = pair == TRAIN_PAIR
    worst_all, before = 0.0, kernel_counts()
    for geometry in BWD_SWEEP_SHAPES:
        b, t, f, h = geometry
        if train:
            xs, w, u, bias, dh = stacked_inputs(geometry, dev, sum(geometry) + 1)
            h_out, c_out = bilstm_train.bilstm_train_reference(xs, w, u, bias)
            args = (xs, w, u, bias, h_out, c_out, dh)
            want = bilstm_train.bilstm_train_backward_reference(*args)
            launch = bilstm_train._backward_launch
        else:
            rs = np.random.RandomState(sum(geometry) + 1)
            params = lstm_params(rs, f, h, dev)
            x = torch.tensor(rs.randn(b, t, f), dtype=torch.float32, device=dev)
            dh = torch.tensor(rs.randn(b, t, 2 * h), dtype=torch.float32, device=dev)
            w, u, bias = bilstm_stream._stack_params(params, torch.float32)
            h_out, c_out = bilstm_with_cell(bilstm_stream._unstacked(w, u, bias), x)
            args = (x, w, u, bias, h_out, c_out, dh)
            want = bilstm_stream.bilstm_stream_backward_reference(*args)
            launch = bilstm_stream._backward_launch
        scales = [r.abs().max().item() for r in want]
        candidates = bwd_sweep_geometries(h)
        assert candidates, (pair[1], geometry)
        worst, worst_share = 0.0, 0.0
        for cluster, rows in candidates:
            got = launch(*args, cluster=cluster, rows=rows)
            torch.cuda.synchronize()
            for name, g, r, scale in zip(("dx", "dw", "du", "db"), got, want, scales):
                err = (g - r).abs().max().item()
                assert torch.isfinite(g).all() and err <= BWD_REL_TOL * scale, (
                    pair[1], geometry, name, cluster, rows, err, scale)
                worst, worst_share = max(worst, err), max(worst_share, err / scale)
        worst_all = max(worst_all, worst)
        print(f"  row {6 if train else 2} float32 backward {geometry} at all {len(candidates)} "
              f"(cluster, rows) of the reverse sweep that fit, every one launched: max|d| "
              f"{worst:.3e}, at most {worst_share:.2e} of a gradient's largest |value| (bound "
              f"{BWD_REL_TOL}); {candidates}")
    assert launched_since(before) == dict.fromkeys(before, 0)
    return worst_all


def precomputed_inputs(geometry, dev, p_dtype, x_dtype, seed):
    """(xw, u) as use_pallas_bilstm's layer gives them to its kernel."""
    from clair_tpu_torch.ops.bilstm import projections

    b, t, f, h = geometry
    rs = np.random.RandomState(seed)
    params = {d: {k: v.to(p_dtype) for k, v in p.items()}
              for d, p in lstm_params(rs, f, h, dev).items()}
    x = torch.tensor(rs.randn(b, t, f), dtype=torch.float32, device=dev).to(x_dtype)
    return projections(params, x)


# (parameter dtype, input dtype) pairs the model gives use_pallas_bilstm's
# layer: float32; lstm1 under bf16 (xw bf16); lstm2 under bf16 (xw float32)
PRECOMPUTED_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                      (torch.bfloat16, torch.float32))


def check_precomputed(dev):
    """Phase 3c: the recurrence kernel vs its plain version on the same xw
    and u, in each dtype pair (U as one bf16 piece or three), float32
    output within F32_TOL (both compute in float32 from the same values):
    at the launcher's geometry (one count each) and at every (cluster size,
    rows per tile) of the sweep that launches for U's piece count (no
    count), at a small ragged batch of each layer's width, at
    PRECOMPUTED_GEOMETRIES and at a tiny odd geometry. No fallback to the
    plain version for a CUDA tensor: a width the sweep cannot take raises."""
    from clair_tpu_torch.ops.bilstm import (
        _launch, bilstm_recurrence, bilstm_recurrence_reference, u_pieces,
    )
    from clair_tpu_torch.ops.lstm_sweep import sweep_geometries

    max_err, calls, before = 0.0, 0, kernel_counts()
    shapes = ([(GEOMETRY_BATCH, T_LEN, feat, HIDDEN) for _, feat in LAYERS]
              + list(PRECOMPUTED_GEOMETRIES) + [(8, 7, 16, 8)])
    for geometry in shapes:
        for p_dtype, x_dtype in PRECOMPUTED_DTYPES:
            xw, u = precomputed_inputs(geometry, dev, p_dtype, x_dtype, sum(geometry))
            want = bilstm_recurrence_reference(xw, u)
            got = bilstm_recurrence(xw, u)
            calls += 1
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            assert got.dtype == torch.float32 and err <= F32_TOL, (geometry, err)
            candidates = sweep_geometries(geometry[3], u_pieces(u))
            launched, worst = [], err
            for cluster, rows in candidates:
                got = _launch(xw, u, cluster, rows)
                if got is None:
                    continue
                torch.cuda.synchronize()
                e = (got - want).abs().max().item()
                assert e <= F32_TOL, (geometry, str(xw.dtype), str(u.dtype), cluster, rows, e)
                launched.append((cluster, rows))
                worst = max(worst, e)
            assert launched, (geometry, xw.dtype, u.dtype)
            max_err = max(max_err, worst)
            print(f"  recurrence vs plain {geometry} xw {str(xw.dtype)[6:]} u {str(u.dtype)[6:]} "
                  f"(U in {u_pieces(u)} piece(s)): launcher's max|dh| {err:.3e}; at every "
                  f"launchable (cluster, rows), {len(launched)} of {len(candidates)} that fit: "
                  f"max|dh| {worst:.3e}")
    launched = launched_since(before)
    assert launched == {**dict.fromkeys(before, 0), "bilstm_precomputed": calls}, launched
    xw, u = precomputed_inputs((4, 5, 16, 12), dev, torch.float32, torch.float32, 7)
    try:
        bilstm_recurrence(xw, u)
    except ValueError as refused:
        print(f"  recurrence at H = 12 on the card raises: {refused}")
    else:
        raise AssertionError("the recurrence took H = 12 on the card")
    return max_err


def check_bilstm2(dev):
    """Phase 3d: bilstm2 vs the two plain layers, float32, within F32_TOL,
    at every BILSTM2_BATCHES batch (one count of bilstm2 each, none of the
    train forward whose kernels it runs), and at every launchable sweep
    geometry at a small ragged batch (no count)."""
    from clair_tpu_torch.ops.bilstm2 import _layers, bilstm2, bilstm2_reference
    from clair_tpu_torch.ops.lstm_sweep import sweep_geometries

    max_err = 0.0
    before = kernel_counts()
    with torch.no_grad():
        for batch in BILSTM2_BATCHES:
            rs = np.random.RandomState(batch)
            p1, p2 = lstm_params(rs, 32, 128, dev), lstm_params(rs, 256, 128, dev)
            x = torch.tensor(rs.randn(batch, 33, 32), dtype=torch.float32, device=dev)
            got, want = bilstm2(p1, p2, x), bilstm2_reference(p1, p2, x)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            assert got.shape == (batch, 33, 256) and err <= F32_TOL, (batch, err)
            max_err = max(max_err, err)
            print(f"  bilstm2 vs plain B={batch}: max|dh| {err:.3e}")
        launched = launched_since(before)
        assert launched == {**dict.fromkeys(before, 0), "bilstm2": len(BILSTM2_BATCHES)}, launched
        rs = np.random.RandomState(GEOMETRY_BATCH)
        p1, p2 = lstm_params(rs, 32, 128, dev), lstm_params(rs, 256, 128, dev)
        x = torch.tensor(rs.randn(GEOMETRY_BATCH, 33, 32), dtype=torch.float32, device=dev)
        want = bilstm2_reference(p1, p2, x)
        done, worst = [], 0.0
        for cluster, rows in sweep_geometries(HIDDEN):
            got = _layers(p1, p2, x, cluster, rows)
            if got is None:
                continue
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            assert err <= F32_TOL, (cluster, rows, err)
            done.append((cluster, rows))
            worst = max(worst, err)
    assert done and launched_since(before)["bilstm2"] == len(BILSTM2_BATCHES)
    max_err = max(max_err, worst)
    print(f"  bilstm2 B={GEOMETRY_BATCH} at every launchable (cluster, rows) of the sweep, "
          f"{len(done)}: max|dh| {worst:.3e}")
    return max_err


def check_backward_kernel(dev):
    """Phase 4: backward kernel vs the plain sweep on the same saved
    forward, and vs torch.autograd.grad of the plain forward on the card
    (float32), at both layers' widths, the training batch (10,000), a
    ragged batch and a tiny odd geometry."""
    from clair_tpu_torch.models.bilstm import bilstm_with_cell
    from clair_tpu_torch.ops.bilstm_stream import (
        _stack_params, _unstacked, bilstm_stream_backward, bilstm_stream_backward_reference,
    )

    max_err = 0.0
    before = bilstm_stream_backward.launches
    calls = 0
    names = ("dx", "dw", "du", "db")
    for b, t, f, h in BWD_GEOMETRIES:
        rs = np.random.RandomState(b + f + h + 1)
        params = lstm_params(rs, f, h, dev)
        x = torch.tensor(rs.randn(b, t, f), dtype=torch.float32, device=dev)
        weight = torch.tensor(rs.randn(b, t, 2 * h), dtype=torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            w, u, bias = _stack_params(params, dtype)
            xd, dh = x.to(dtype), weight.to(dtype)
            h_out, c_out = bilstm_with_cell(_unstacked(w, u, bias), xd)
            got = bilstm_stream_backward(xd, w, u, bias, h_out, c_out, dh)
            calls += 1
            line = []
            if (b, t, f, h) == BITWISE_GEOMETRY:
                # fixed-order partial sums, no atomics: the same bits every run
                again = bilstm_stream_backward(xd, w, u, bias, h_out, c_out, dh)
                calls += 1
                for name, g, g2 in zip(names, got, again):
                    assert torch.equal(g, g2), f"{name}: two runs differ"
                line.append("bit-identical over two runs")
            want = bilstm_stream_backward_reference(xd, w, u, bias, h_out, c_out, dh)
            torch.cuda.synchronize()
            for name, g, r in zip(names, got, want):
                assert g.shape == r.shape and g.dtype == r.dtype, name
                g, r = g.float(), r.float()
                assert torch.isfinite(g).all(), name
                err, scale = (g - r).abs().max().item(), r.abs().max().item()
                if dtype == torch.float32:
                    assert err <= BWD_REL_TOL * scale, (name, err, scale)
                    max_err = max(max_err, err)
                    line.append(f"{name} {err:.2e}/{scale:.2e}")
                elif scale == 0.0:
                    # du at T = 1: every h_prev is the zero state, so the
                    # gradient is exactly 0 (a cosine is undefined)
                    assert err == 0.0, (name, err)
                    line.append(f"{name} exactly 0")
                else:
                    cos = cosine(g, r)
                    assert cos > BF16_COSINE and err <= BF16_REL_TOL * scale, (
                        name, cos, err, scale)
                    line.append(f"{name} cos {cos:.6f} {err:.2e}/{scale:.2e}")
            if dtype == torch.float32:
                # the same gradients from autograd of the plain forward
                leaves = [t_.detach().requires_grad_() for t_ in (xd, w, u, bias)]
                h_ag, _ = bilstm_with_cell(_unstacked(*leaves[1:]), leaves[0])
                grads = torch.autograd.grad((h_ag * weight).sum(), leaves)
                for name, g, a in zip(names, got, grads):
                    err, scale = (g - a).abs().max().item(), a.abs().max().item()
                    assert err <= BWD_REL_TOL * scale, ("autograd", name, err, scale)
                line.append("autograd agrees")
            print(f"  backward kernel vs plain {(b, t, f, h)} {str(dtype)[6:]}: "
                  + ", ".join(line))
    assert bilstm_stream_backward.launches == before + calls, "the kernel did not launch"
    max_err = max(max_err, check_bwd_sweep_geometries(dev, STREAM_PAIR))
    # a float32 width that no reverse-sweep geometry fits raises before any
    # launch (bf16 takes it on its FMA sweep)
    wide = lstm_params(np.random.RandomState(4), 8, 264, dev)
    w, u, bias = _stack_params(wide, torch.float32)
    x = torch.zeros((2, 3, 8), device=dev)
    h_out, c_out = bilstm_with_cell(wide, x)
    try:
        bilstm_stream_backward(x, w, u, bias, h_out, c_out, torch.zeros_like(h_out))
    except ValueError as refused:
        print(f"  float32 backward at H = 264 refused before a launch: {refused}")
    else:
        raise AssertionError("the float32 backward took H = 264 on the card")
    assert bilstm_stream_backward.launches == before + calls
    return max_err


@contextlib.contextmanager
def poisoned():
    """Every torch.empty inside comes back filled (NaN in floating types,
    the largest value in integer ones, so a uint8 scratch's bf16 pieces
    read as NaN): deterministic algorithms on, warn only, with
    fill_uninitialized_memory. A kernel that reads bytes nobody wrote then
    gives NaN. The previous settings come back on exit."""
    import torch.utils.deterministic as deterministic

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    deterministic.fill_uninitialized_memory = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        deterministic.fill_uninitialized_memory = was[2]


def bits(t: torch.Tensor) -> torch.Tensor:
    """t's bits as integers of its width (NaN == NaN, -0.0 != 0.0)."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


class Findings:
    """Each output's check: its non-finite values and its error against the
    plain version within a bound (absolute, or a share of the plain
    version's largest |value|); ``faults`` lists those that fail."""

    def __init__(self):
        self.lines = []

    @property
    def faults(self):
        return [line for line in self.lines if not line["ok"]]

    def add(self, kernel, geometry, output, got, want, bound, relative=False):
        got_f, want_f = got.float(), want.float()
        non_finite = int((~torch.isfinite(got_f)).sum().item())
        scale = want_f.abs().max().item()
        err = (got_f - want_f).abs().max().item() if non_finite == 0 else math.nan
        ok = non_finite == 0 and err <= (bound * scale if relative else bound)
        self.lines.append({"kernel": kernel, "geometry": list(geometry), "output": output,
                           "non_finite": non_finite, "max_abs_err": err, "scale": scale,
                           "bound": bound, "relative": relative, "ok": bool(ok)})
        if not ok:
            of = f" of {scale:.3e}" if relative else ""
            print(f"  FAULT {kernel} {tuple(geometry)} {output}: {non_finite} non-finite, "
                  f"max|d| {err:.3e} (bound {bound}{of})", flush=True)


def check_poisoned(dev, findings, fwd=(), bwd=(), train=(), precomputed=(), bilstm2=()):
    """Every kernel through its wrapper with each call poisoned (the plain
    versions run outside the mode), against its plain version: row 1 in
    both dtypes with and without c at ``fwd``, row 2 in both dtypes with and
    without dx at ``bwd``, rows 5 and 6 at ``train``, row 3 in its three
    dtype pairs at ``precomputed`` and row 4 at the ``bilstm2`` batches
    (the model's two layers); each output's non-finite values and error go
    into ``findings``. Returns the kernel calls made, by wrapper."""
    from clair_tpu_torch.models.bilstm import bilstm_with_cell
    from clair_tpu_torch.ops import bilstm as b3
    from clair_tpu_torch.ops import bilstm2 as b2
    from clair_tpu_torch.ops import bilstm_stream as stream
    from clair_tpu_torch.ops import bilstm_train as b5

    # every wrapper's count, the kernels this phase does not run at 0
    calls = dict.fromkeys(kernel_counts(), 0)
    for geometry in fwd:
        b, t, f, h = geometry
        rs = np.random.RandomState(b + f + h)
        params = lstm_params(rs, f, h, dev)
        x = torch.tensor(rs.randn(b, t, f), dtype=torch.float32, device=dev)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            xd = x.to(dtype)
            want_h, want_c = stream.bilstm_stream_reference(params, xd)
            for with_cell in (True, False):
                with poisoned():
                    out = stream.bilstm_stream(params, xd, with_cell=with_cell)
                calls["bilstm_stream"] += 1
                got_h, got_c = out if with_cell else (out, None)
                name = f"row 1 {str(dtype)[6:]}"
                findings.add(name, geometry, f"h (with_cell={with_cell})", got_h, want_h, tol)
                if with_cell:
                    findings.add(name, geometry, "c", got_c, want_c, tol)
    for geometry in bwd:
        b, t, f, h = geometry
        rs = np.random.RandomState(b + f + h + 1)
        params = lstm_params(rs, f, h, dev)
        x = torch.tensor(rs.randn(b, t, f), dtype=torch.float32, device=dev)
        weight = torch.tensor(rs.randn(b, t, 2 * h), dtype=torch.float32, device=dev)
        for dtype, bound in ((torch.float32, BWD_REL_TOL), (torch.bfloat16, BF16_REL_TOL)):
            w, u, bias = stream._stack_params(params, dtype)
            xd, dh = x.to(dtype), weight.to(dtype)
            h_out, c_out = bilstm_with_cell(stream._unstacked(w, u, bias), xd)
            want = stream.bilstm_stream_backward_reference(xd, w, u, bias, h_out, c_out, dh)
            for need_dx in (True, False):
                with poisoned():
                    got = stream.bilstm_stream_backward(xd, w, u, bias, h_out, c_out, dh,
                                                        need_dx=need_dx)
                calls["bilstm_stream_backward"] += 1
                for name, g, r in zip(("dx", "dw", "du", "db"), got, want):
                    if g is not None:
                        findings.add(f"row 2 {str(dtype)[6:]}", geometry,
                                     f"{name} (need_dx={need_dx})", g, r, bound, relative=True)
    for geometry in train:
        xs, w, u, b, dh = stacked_inputs(geometry, dev, sum(geometry))
        want_h, want_c = b5.bilstm_train_reference(xs, w, u, b)
        want = b5.bilstm_train_backward_reference(xs, w, u, b, want_h, want_c, dh)
        with poisoned():
            h_out, c_out = b5.bilstm_train_forward(xs, w, u, b)
            got = b5.bilstm_train_backward(xs, w, u, b, want_h, want_c, dh)
        calls["bilstm_train"] += 1
        calls["bilstm_train_backward"] += 1
        findings.add("row 5", geometry, "h", h_out, want_h, F32_TOL)
        findings.add("row 5", geometry, "c", c_out, want_c, F32_TOL)
        for name, g, r in zip(("dx", "dw", "du", "db"), got, want):
            findings.add("row 6", geometry, name, g, r, BWD_REL_TOL, relative=True)
    for geometry in precomputed:
        for p_dtype, x_dtype in PRECOMPUTED_DTYPES:
            xw, u = precomputed_inputs(geometry, dev, p_dtype, x_dtype, sum(geometry))
            want = b3.bilstm_recurrence_reference(xw, u)
            with poisoned():
                got = b3.bilstm_recurrence(xw, u)
            calls["bilstm_precomputed"] += 1
            findings.add(f"row 3 xw {str(xw.dtype)[6:]} u {str(u.dtype)[6:]}", geometry, "h",
                         got, want, F32_TOL)
    for batch in bilstm2:
        rs = np.random.RandomState(batch + 9)
        p1 = lstm_params(rs, LAYERS[0][1], HIDDEN, dev)
        p2 = lstm_params(rs, LAYERS[1][1], HIDDEN, dev)
        x = torch.tensor(rs.randn(batch, T_LEN, LAYERS[0][1]), dtype=torch.float32, device=dev)
        want = b2.bilstm2_reference(p1, p2, x)
        with poisoned():
            got = b2.bilstm2(p1, p2, x)
        calls["bilstm2"] += 1
        findings.add("row 4", (batch, T_LEN, LAYERS[0][1], HIDDEN), "h", got, want, F32_TOL)
    return calls


def repeated_launches(dev, launches):
    """Rows 1 and 2 in float32 at each (row, B, F, with c / with dx,
    launches) of ``launches``, on fixed inputs from a seed, launched that
    many times, every call poisoned: how many launches differ from the
    first bit for bit, and how many give a non-finite output. Counts no
    launch (``_launch``, ``_backward_launch``); one host sync a geometry.
    Returns a line a geometry."""
    from clair_tpu_torch.ops import bilstm_stream as stream

    lines = []
    for row, batch, feat, flag, n in launches:
        rs = np.random.RandomState(batch * 7 + feat)
        params = lstm_params(rs, feat, HIDDEN, dev)
        x = torch.tensor(rs.randn(batch, T_LEN, feat), dtype=torch.float32, device=dev)
        w, u, bias = stream._stack_params(params, torch.float32)
        if row == 1:
            def launch():
                return stream._launch(x, w, u, bias, with_cell=flag)
        else:
            h_out, c_out = stream._launch(x, w, u, bias, with_cell=True)
            dh = torch.tensor(rs.randn(batch, T_LEN, 2 * HIDDEN), dtype=torch.float32,
                              device=dev)

            def launch():
                return stream._backward_launch(x, w, u, bias, h_out, c_out, dh, need_dx=flag)
        differ = torch.zeros((), dtype=torch.int64, device=dev)
        non_finite = torch.zeros((), dtype=torch.int64, device=dev)
        started = time.perf_counter()
        with poisoned():
            first = [bits(o).clone() for o in launch() if o is not None]
            for _ in range(n):
                outs = [o for o in launch() if o is not None]
                differ += torch.stack([(bits(o) != f).any() for o, f in zip(outs, first)]).any()
                non_finite += torch.stack([(~torch.isfinite(o)).any() for o in outs]).any()
        first_finite = all(torch.isfinite(f.view(torch.float32)).all().item() for f in first)
        line = {"row": row, "batch": batch, "feat": feat,
                ("with_cell" if row == 1 else "need_dx"): flag, "launches": n,
                "differ": int(differ.item()), "non_finite": int(non_finite.item()),
                "first_finite": first_finite, "seconds": time.perf_counter() - started}
        line["ok"] = line["differ"] == 0 and line["non_finite"] == 0 and first_finite
        lines.append(line)
        print(f"  row {row} float32 ({batch}, {T_LEN}, {feat}, {HIDDEN}) "
              f"{'with c' if row == 1 else 'with dx'} {flag}: {n} launches, {line['differ']} "
              f"differ from the first bit for bit, {line['non_finite']} non-finite "
              f"({line['seconds']:.2f} s)", flush=True)
    return lines


def check_recipe_poisoned(dev):
    """Phase 4b: every kernel poisoned against its plain version at the
    recipes' geometries (RECIPE_GEOMETRIES and 11b's RECIPE_LAUNCHES), then
    rows 1 and 2 in float32 launched as often as one 11b run launches them
    at each of its geometries: no NaN, every output within its bound, every
    launch bit for bit the first."""
    shapes = list(dict.fromkeys([*RECIPE_GEOMETRIES, *((b, T_LEN, f, HIDDEN)
                                                       for _, b, f, _, _ in RECIPE_LAUNCHES)]))
    findings = Findings()
    before = kernel_counts()
    calls = check_poisoned(dev, findings, fwd=shapes, bwd=shapes, train=shapes,
                           precomputed=shapes,
                           bilstm2=sorted({b for b, _, _, h in shapes if h == HIDDEN}))
    assert launched_since(before) == calls, (launched_since(before), calls)
    print(f"  poisoned memory: {len(findings.lines)} outputs of {sum(calls.values())} kernel "
          f"calls at {len(shapes)} recipe geometries, {len(findings.faults)} faults; launches "
          f"{calls}")
    assert not findings.faults, findings.faults
    lines = repeated_launches(dev, RECIPE_LAUNCHES)
    assert all(line["ok"] for line in lines), [line for line in lines if not line["ok"]]
    assert launched_since(before) == calls
    print(f"  repeated launches: {sum(line['launches'] for line in lines)} at "
          f"{len(lines)} geometries of 11b (one run's), every one bit for bit the first and "
          f"finite")


def check_forward(dev):
    """Phase 5: full-width forward, card vs CPU, float32, batch 512."""
    from clair_tpu_torch.models.checkpoint import load_checkpoint
    from clair_tpu_torch.models.clair import ClairNet
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.pipeline.call_var import _device_input

    params, _ = load_checkpoint(str(ROOT / "examples" / "ont_production.ckpt"))
    x = torch.from_numpy(np.random.RandomState(7).randint(0, 40, (512, 33, 8, 4)).astype(np.uint8))
    with torch.inference_mode():
        card = ClairNet.from_jax(params, ModelConfig(), dev)(_device_input(x.to(dev)))
        plain = ClairNet.from_jax(params, ModelConfig(), "cpu")(_device_input(x))
    errs = [(c.cpu() - p).abs().max().item() for c, p in zip(card, plain)]
    print(f"  forward card vs CPU, max|dp| per head: {errs}")
    assert all(e <= FORWARD_TOL for e in errs), errs
    assert all(torch.isfinite(c).all() for c in card)
    return params


def pileup_batch(rs, n):
    """Learnable rows in the manner of tests/test_training.py: integer
    pileup counts (so blocks pack as int16, as real bins do), half hom-ref
    AA sites and half hom-alt GG SNPs, told apart by channel 0."""
    x = rs.randint(0, 20, (n, 33, 8, 4)).astype(np.float32)
    y = np.zeros((n, 90), np.float32)
    hom = np.arange(n) % 2 == 1
    x[~hom, :, :, 0] += 10
    x[hom, :, :, 0] -= 10
    y[~hom, 0] = 1.0        # gt21 AA
    y[hom, 6] = 1.0         # gt21 GG
    y[~hom, 21] = 1.0       # genotype hom-ref
    y[hom, 22] = 1.0        # genotype hom-alt
    y[:, 24 + 16] = 1.0     # indel lengths 0
    y[:, 57 + 16] = 1.0
    return x, y


def first_step(rank: int, world: int, address, bin_fn: str):
    """Phase 10f's first train step as train_model takes it at seed 0 (its
    initial parameters, the bin's first batch, data row 0's dropout
    generator), float32, with the model's dropout on: the reported loss,
    the global norm before the clip and each leaf's gradient before it
    (this rank's shard of a split leaf). ``world`` 1: this process, no
    mesh; else rank ``rank`` of a (1, world) mesh of gloo ranks on cuda:0
    (a module-level function: the spawned ranks import it)."""
    import torch.distributed as dist
    from clair_tpu_torch.data.bins import load_bin
    from clair_tpu_torch.models.clair import ClairNet, init_params
    from clair_tpu_torch.params import L2_REGULARIZATION_LAMBDA, ModelConfig
    from clair_tpu_torch.parallel.distributed import init_distributed
    from clair_tpu_torch.parallel.mesh import make_mesh
    from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step
    from clair_tpu_torch.parallel.tensor_parallel import TensorParallel, shard_params

    mesh = tp = None
    if world > 1:
        init_distributed(address, world, rank, "cuda", device="cuda:0", backend="gloo",
                         timeout_s=600)
        mesh = make_mesh(world, world, device_type="cuda")
        tp = TensorParallel.of(mesh)
    try:
        config = ModelConfig(compute_dtype="float32")
        params = init_params(torch.Generator().manual_seed(1), config)
        if tp is not None:
            params = shard_params(params, tp.index, tp.size)
        model = ClairNet.from_jax(params, config, "cuda:0", tp)
        optimizer = make_optimizer(dict(model.named_parameters()), "Adam", 1e-3)
        seen, clip_and_update = {}, optimizer.step

        def recording_step(tensor_parallel=None):
            seen["grads"] = {k: p.grad.cpu().numpy() for k, p in model.named_parameters()}
            seen["norm"] = clip_and_update(tensor_parallel).item()

        optimizer.step = recording_step
        dataset = load_bin(bin_fn)
        blocks = range(TRAIN_BATCH // dataset.block_size)
        x, y = (torch.from_numpy(np.concatenate([block(i, cast=False) for i in blocks]))
                .to("cuda:0") for block in (dataset.x_block, dataset.y_block))
        loss, _ = make_train_step(model, optimizer, mesh)(
            x, y, torch.Generator(device="cuda:0").manual_seed(0), L2_REGULARIZATION_LAMBDA)
        seen["loss"] = loss.item()
        return seen
    finally:
        if world > 1:
            dist.destroy_process_group()


def check_train_step(params, pair=STREAM_PAIR, scan=False, **flags):
    """Phases 6, 6b and 10g: three full-width Adam steps, card (kernels) vs
    CPU (plain), float32, every dropout rate 0, batch 512, with the kernel
    pair the ModelConfig ``flags`` select (or, with ``scan``, the scan
    BiLSTM on both); only that pair launches, 6 + 6 times."""
    from clair_tpu_torch.models.clair import ClairNet, params_to_jax
    from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step
    from clair_tpu_torch.params import ModelConfig

    config = dataclasses.replace(ModelConfig(), lstm2_dropout_rate=0.0, l4_dropout_rate=0.0,
                                 l5_dropout_rate=0.0, **flags)
    x, y = pileup_batch(np.random.RandomState(11), 512)
    runs = {}
    before = kernel_counts()
    for device in ("cuda", "cpu"):
        model = ClairNet.from_jax(params, config, device, scan=scan)
        step = make_train_step(model, make_optimizer(dict(model.named_parameters()), "Adam", 1e-3))
        xd, yd = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
        generator = torch.Generator(device=device)
        losses = [step(xd, yd, generator, 0.005)[0].item() for _ in range(3)]
        runs[device] = (losses, params_to_jax(model.state_dict()))
    launched = launched_since(before)
    assert launched == {k: (6 if k in pair else 0) for k in launched}, launched
    card, cpu = runs["cuda"][0], runs["cpu"][0]
    assert all(math.isfinite(v) for v in card)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    print(f"  train step card vs CPU {flags or ('scan' if scan else '')}, losses {card} vs {cpu}, "
          f"max rel diff {rel:.2e}; launches {launched}")
    assert rel <= STEP_RTOL, (card, cpu)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)])

    cpu_params = dict(leaves(runs["cpu"][1]))
    diff = {k: float(np.abs(v - cpu_params[k]).max()) for k, v in leaves(runs["cuda"][1])}
    worst = max(diff, key=diff.get)
    print(f"  final parameters card vs CPU: max|d| {diff[worst]:.3e} ({worst})")


def simulate_genome(workdir: Path):
    """The ONT genome of phases 7 to 8c: FASTA, BAM, {position: (ref, alt)}
    and the planted variants."""
    from clair_tpu_torch.utils import simulate

    recipe = simulate.PLATFORM_RECIPES["ont"]
    rs = np.random.RandomState(424242)
    reference = simulate.random_reference(rs, GENOME_LENGTH)
    variants = simulate.plant_variants(rs, reference, n_variants=120, spacing=200)
    fasta, bam = str(workdir / "ref.fa"), str(workdir / "reads.bam")
    simulate.write_fasta(fasta, reference)
    simulate.simulate_bam(bam, reference, variants, rs, coverage=recipe["coverage"],
                          read_length=recipe["read_length"],
                          read_length_sigma=recipe["read_length_sigma"],
                          error_profile=getattr(simulate, recipe["profile_name"]))
    return fasta, bam, {v.position: (v.ref, v.alt) for v in variants}, variants


def run_command(args, timeout):
    """``python <args>`` in a process of its own: (wall seconds, stderr)."""
    cmd = [sys.executable, *args]
    started = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - started
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:4])} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return wall, proc.stderr


def run_process(args, timeout):
    """``python <args>`` in a process of its own; its kernel launch counts
    start from 0 there and are reported on its last stderr line."""
    wall, stderr = run_command(args, timeout)
    report = json.loads(stderr.strip().splitlines()[-1])
    return report, wall, stderr


def run_port(args, timeout):
    """One run of the port's CLI in a process of its own."""
    return run_process(["-m", "clair_tpu_torch", *args], timeout)


def calls_of(out, report, wall, stderr):
    sites = [line for line in stderr.splitlines() if "candidate sites processed" in line]
    rows = [r.split("\t") for r in open(out) if not r.startswith("#")]
    return rows, report["kernel_launches"], wall, sites[-1] if sites else ""


def call_bam(fasta, bam, out, dtype_flags):
    return calls_of(out, *run_port(
        ["call_bam", "--bam_fn", bam, "--ref_fn", fasta,
         "--chkpnt_fn", str(ROOT / "examples" / "ont_synthetic.ckpt"),
         "--ctgName", "chr1", "--threshold", "0.2", "--call_fn", out, *dtype_flags], 500))


def call_bam_precomputed(fasta, bam, out, dtype):
    """Phase 7b, one run: call_bam.call_bam with use_pallas_bilstm."""
    return calls_of(out, *run_process(
        ["-c", CALL_SCRIPT, bam, fasta, str(ROOT / "examples" / "ont_synthetic.ckpt"), out,
         dtype], 500))


def score(rows, truth):
    called = {int(r[1]): (r[3], r[4]) for r in rows}
    tp = len(set(truth) & set(called))
    return tp / len(truth), tp / max(len(called), 1)


def decisions(rows):
    """(CHROM, POS, REF, ALT, GT) of each VCF row."""
    return [(r[0], r[1], r[3], r[4], r[9].split(":")[0]) for r in rows]


def process_pool(fasta, bam, truth, tmp: Path, card):
    """Phase 7c: ``call_bam_parallel --run --process_pool`` over the genome's
    POOL_WINDOWS windows with two worker processes (each builds its own
    Predictor on the card), then with one (in the command's process). Every
    joblog line ok, the same VCF rows from both, recall and precision at the
    floors."""
    rows_of = {}
    for workers in (2, 1):
        prefix = str(tmp / f"pool_{workers}")
        report, wall, _ = run_port(
            ["call_bam_parallel", "--run", "--process_pool", "--bam_fn", bam, "--ref_fn", fasta,
             "--chkpnt_fn", str(ROOT / "examples" / "ont_synthetic.ckpt"),
             "--output_prefix", prefix, "--refChunkSize", str(POOL_CHUNK), "--threshold", "0.2",
             "--workers", str(workers)], 600)
        log = [json.loads(line) for line in open(prefix + ".joblog")]
        assert [e["status"] for e in log] == ["ok"] * POOL_WINDOWS, \
            f"--workers {workers}: windows not all ok: {log}"
        rows = [r.split("\t") for r in open(prefix + ".vcf") if not r.startswith("#")]
        recall, precision = score(rows, truth)
        launches = report["kernel_launches"]
        elapsed = ", ".join(f"{e['elapsed']:.2f}" for e in log)
        print(f"  call_bam_parallel --process_pool --workers {workers}: {len(log)} windows ok "
              f"({elapsed} s each), {len(rows)} calls, "
              f"recall {recall:.4f}, precision {precision:.4f}, kernel launches {launches} "
              f"(the command's and its workers'), wall {wall:.2f} s (process start to exit) "
              f"on {card}")
        assert recall >= RECALL_FLOOR and precision >= PRECISION_FLOOR, (recall, precision)
        # the workers' launches come back with their windows
        assert launches["bilstm_stream"] > 0, launches
        rows_of[workers] = (rows, launches)
    assert rows_of[2][0] == rows_of[1][0], "the VCF rows of --workers 2 and --workers 1 differ"
    # the same windows, so the same batches
    assert rows_of[2][1] == rows_of[1][1], "--workers 2 and --workers 1 launch counts differ"
    print("  --workers 2 and --workers 1 VCF rows and kernel launches identical")


def training_data_path(fasta, bam, variants, tmp: Path, card):
    """Phase 8c: BAM + truth VCF -> bin -> full-width model -> VCF, each step
    a command of the port's CLI in a process of its own. No accuracy floor:
    two epochs on a few hundred rows show the path, not a caller."""
    from clair_tpu_torch import cli
    from clair_tpu_torch.data.bins import load_bin
    from clair_tpu_torch.models.checkpoint import checkpoint_path, load_checkpoint
    from clair_tpu_torch.task.labels import GENOTYPE_SPAN
    from clair_tpu_torch.utils.simulate import write_truth_vcf

    scan = cli._native_region_scan(bam, fasta, "chr1", 1, GENOME_LENGTH, 0)
    assert scan is not None, "the native counts pass does not engage on the genome's BAM"
    scan.close()
    p = {k: str(tmp / k) for k in ("truth.vcf", "var", "can", "t_can", "t_var", "paired",
                                   "half_1", "half_2", "half_1.bin", "half_2.bin", "all.bin",
                                   "model", "calls.vcf")}
    write_truth_vcf(p["truth.vcf"], variants)
    walls = {}

    def host(name, args):
        walls[name], _ = run_command(["-m", "clair_tpu_torch", *args], 300)

    host("get_truth", ["get_truth", "--vcf_fn", p["truth.vcf"], "--ctgName", "chr1",
                       "--var_fn", p["var"]])
    host("extract_candidates", ["extract_candidates", "--bam_fn", bam, "--ref_fn", fasta,
                                "--ctgName", "chr1", "--gen4Training", "--var_fn", p["var"],
                                "--can_fn", p["can"]])
    for which, sites in (("t_can", "can"), ("t_var", "var")):
        host(f"create_tensor {sites}", ["create_tensor", "--bam_fn", bam, "--ref_fn", fasta,
                                        "--ctgName", "chr1", "--can_fn", p[sites],
                                        "--tensor_fn", p[which]])
    host("pair_with_non_variants", ["pair_with_non_variants", "--tensor_can_fn", p["t_can"],
                                    "--tensor_var_fn", p["t_var"], "--output_fn", p["paired"]])
    paired = open(p["paired"]).read().splitlines()
    half = GENOME_LENGTH // 2
    for name, keep in (("half_1", lambda pos: pos <= half), ("half_2", lambda pos: pos > half)):
        with open(p[name], "w") as fh:
            fh.writelines(r + "\n" for r in paired if keep(int(r.split(maxsplit=2)[1])))
        host(f"tensor2bin {name}", ["tensor2bin", "--tensor_fn", p[name], "--var_fn", p["var"],
                                    "--bin_fn", p[f"{name}.bin"]])
    host("combine_bins", ["combine_bins", p["half_1.bin"], p["half_2.bin"],
                          "--output_fn", p["all.bin"]])

    dataset = load_bin(p["all.bin"])
    assert dataset.dataset_size == len(paired), (dataset.dataset_size, len(paired))
    keys = [str(k) for i in range(dataset.n_blocks) for k in dataset.pos_block(i)]
    labels = np.concatenate([dataset.y_block(i) for i in range(dataset.n_blocks)])
    row = {k: i for i, k in enumerate(keys)}
    missing = [v.position for v in variants if f"chr1:{v.position}" not in row]
    assert not missing, f"planted variants not in the bin: {missing}"
    homref = [v.position for v in variants if labels[row[f"chr1:{v.position}"], GENOTYPE_SPAN[0]]]
    assert not homref, f"planted variants labelled 0/0: {homref}"
    print(f"  bin: {dataset.dataset_size} rows (= paired tensor lines), "
          f"{len(open(p['t_var']).read().splitlines())} truth tensors, every planted "
          f"variant with a non-reference genotype label")

    report, walls["train"], stderr = run_port(
        ["train", "--bin_fn", p["all.bin"], "--ochk_prefix", p["model"],
         "--maxEpoch", str(TRAIN_EPOCHS)], 600)
    losses = [v for v, _ in report["training_losses"] + report["validation_losses"]]
    assert len(report["training_losses"]) == TRAIN_EPOCHS and all(map(math.isfinite, losses)), \
        report
    for epoch in range(1, TRAIN_EPOCHS + 1):
        params, extra = load_checkpoint(checkpoint_path(p["model"], epoch))
        assert extra["epoch"] == epoch and params["l3"]["w"].shape == (256, 33, 30)
    launches = report["kernel_launches"]
    assert all((launches[k] > 0) == (k in STREAM_PAIR) for k in KERNELS), launches
    epochs = [line for line in stderr.splitlines() if "Epoch time elapsed" in line]
    print(f"  train at full width, batch {TRAIN_BATCH}: loss sums {report['training_losses']} "
          f"(training), {report['validation_losses']} (validation), kernel launches "
          f"{launches}; {epochs}")

    report, walls["call_bam"], _ = run_port(
        ["call_bam", "--bam_fn", bam, "--ref_fn", fasta,
         "--chkpnt_fn", checkpoint_path(p["model"], TRAIN_EPOCHS), "--ctgName", "chr1",
         "--threshold", "0.2", "--call_fn", p["calls.vcf"]], 500)
    lines = open(p["calls.vcf"]).read().splitlines()
    header = [r for r in lines if r.startswith("#CHROM")]
    rows = [r.split("\t") for r in lines if not r.startswith("#")]
    assert lines[0].startswith("##fileformat=VCF") and len(header) == 1, lines[:3]
    assert all(len(r) == 10 and r[0] == "chr1" for r in rows), rows[:3]
    positions = [int(r[1]) for r in rows]
    assert positions == sorted(positions) and all(1 <= x <= GENOME_LENGTH for x in positions)
    assert report["kernel_launches"]["bilstm_stream"] > 0, report
    print(f"  call_bam with the epoch-{TRAIN_EPOCHS} checkpoint: {len(rows)} rows, kernel "
          f"launches {report['kernel_launches']}")
    print(f"  walls (process start to exit) on {card}: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))


def activations(params, dev, tmp: Path, card):
    """Phase 10a: forward_activations on the card (row 1, float32) against
    the plain version on the CPU, name by name within FORWARD_TOL of each
    array's largest magnitude (at least 1); then ``call_var
    --activation_only`` through the CLI on 70 sites (two batches of 64)."""
    from clair_tpu_torch.data.tensor_stream import tensor_line_from
    from clair_tpu_torch.models.clair import forward_activations
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream

    x = torch.from_numpy(np.random.RandomState(15).randint(0, 40, (CALL_BATCH, 33, 8, 4))
                         .astype(np.float32))
    before = bilstm_stream.launches
    card_acts = forward_activations(params, x.to(dev))
    assert bilstm_stream.launches == before + 2, "forward_activations did not run row 1 twice"
    plain = forward_activations(params, x)
    errs = {}
    for name, want in plain.items():
        scale = max(1.0, want.abs().max().item())
        errs[name] = (card_acts[name].cpu() - want).abs().max().item() / scale
        assert card_acts[name].dtype == torch.float32 and errs[name] <= FORWARD_TOL, \
            (name, errs[name])
    print(f"  forward_activations B={CALL_BATCH} card vs CPU, max|d| / max(1, max|ref|) per "
          f"name: {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}")
    rs = np.random.RandomState(16)
    tensors, out = tmp / "act_tensors.txt", tmp / "activations"
    with open(tensors, "w") as fh:
        for i in range(70):
            fh.write(tensor_line_from("chr1", 100 + i, "".join(rs.choice(list("ACGT"), 33)),
                                      rs.randint(0, 30, (33, 8, 4))) + "\n")
    report, wall, _ = run_port(
        ["call_var", "--activation_only", "--tensor_fn", str(tensors),
         "--chkpnt_fn", str(ROOT / "examples" / "ont_production.ckpt"), "--max_plot", "70",
         "--log_path", str(out)], 300)
    files = sorted(out.glob("*.npz"))
    launches = report["kernel_launches"]
    assert len(files) == 70, len(files)
    assert launches == {k: (4 if k == "bilstm_stream" else 0) for k in launches}, launches
    dump = np.load(files[0])
    assert sorted(dump.files) == sorted(plain) and all(np.isfinite(dump[k]).all() for k in dump)
    print(f"  call_var --activation_only: {len(files)} npz files of {len(dump.files)} arrays, "
          f"kernel launches {launches}, wall {wall:.2f} s (process start to exit) on {card}")
    return launches


def lr_finder(bin_fn: Path, tmp: Path, card):
    """Phase 10b: ``learning_rate_finder`` through the CLI on phase 8's bin
    at its default batch (10,000): rising learning rates, finite losses, the
    two suggested lines; only rows 1 and 2, four forwards (two for the
    step, two for its accuracy) and two backwards a step."""
    out = tmp / "lr_finder.txt"
    report, wall, _ = run_port(["learning_rate_finder", "--bin_fn", str(bin_fn),
                                "--olog_fn", str(out)], 300)
    lines = out.read_text().splitlines()
    rows = [tuple(map(float, line.split(","))) for line in lines[1:-2]]
    lrs, losses = [r[0] for r in rows], [r[2] for r in rows]
    assert lines[0] == "lr,accuracy,loss" and len(rows) == math.ceil(int(TRAIN_ROWS * 0.9) / 10_000)
    assert lrs == sorted(lrs) and len(set(lrs)) == len(lrs), lrs
    assert all(map(math.isfinite, losses)), losses
    assert lines[-2].startswith("# suggested min_lr ") and lines[-1].startswith(
        "# suggested max_lr "), lines[-2:]
    launches = report["kernel_launches"]
    assert launches == {k: {"bilstm_stream": 4 * len(rows),
                            "bilstm_stream_backward": 2 * len(rows)}.get(k, 0)
                        for k in launches}, launches
    print(f"  learning_rate_finder: {len(rows)} steps, lr {lrs}, accuracy "
          f"{[r[1] for r in rows]}, loss {losses}; {lines[-2]}; {lines[-1]}; kernel launches "
          f"{launches}, wall {wall:.2f} s (process start to exit) on {card}")
    return launches


def profiled_train(bin_fn: Path, tmp: Path, card):
    """Phase 10c: ``train --profile_dir`` on phase 8's bin, one epoch: a
    trace whose CUDA kernels include rows 1 and 2 by name, and the train
    step's device time from it, by kernel and by the rest."""
    sys.path.insert(0, str(ROOT))
    from tools.torch_trace_split import KERNEL_ROWS, split_train_steps

    trace_dir = tmp / "trace"
    report, wall, _ = run_port(["train", "--bin_fn", str(bin_fn), "--maxEpoch", "1",
                                "--profile_dir", str(trace_dir)], 600)
    traces = sorted(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    kernels = {e["name"] for e in json.loads(traces[0].read_text())["traceEvents"]
               if e.get("cat") == "kernel"}
    for row, marks in KERNEL_ROWS:
        assert any(m in k for k in kernels for m in marks), (row, sorted(kernels)[:30])
    split = split_train_steps(str(traces[0]))
    launches = report["kernel_launches"]
    assert all((launches[k] > 0) == (k in STREAM_PAIR) for k in KERNELS), launches
    print(f"  train --profile_dir (bf16, B={TRAIN_BATCH}, one epoch): trace "
          f"{traces[0].name} ({traces[0].stat().st_size / 1e6:.1f} MB), kernel launches "
          f"{launches}, wall {wall:.2f} s (process start to exit) on {card}")
    print(f"  the train steps from the trace on {card} (device time of the kernels each "
          f"step launched; the epoch's batches are 10,000, 10,000 and 1,600 rows):")
    for i, step in enumerate(split["per_step"]):
        print(f"    step {i + 1}: {sum(step.values()):.4f} ms: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in step.items()))
    print("    mean over the steps, by kernel:")
    for name, ms in list(split["kernels_ms_per_step"].items())[:12]:
        print(f"    {ms:.4f} ms  {name[:110]}")
    return launches, split


def data_parallel(bin_fn: Path, card):
    """Phase 10d: DDP on the one card, dropout off, on phase 8's bin: world
    size 1 on NCCL gives the unwrapped run's losses; two ranks on cuda:0
    with gloo (NCCL refuses two ranks on one device) give one process's
    within DDP_RTOL; the ranks' launch counts come back summed."""
    report, wall, _ = run_process(["-c", DDP_SCRIPT, str(bin_fn), str(TRAIN_EPOCHS)], 900)
    single, nccl, gloo = report["single"], report["nccl_1"], report["gloo_2"]
    for name, run in report.items():
        print(f"  {name}: training loss sums {run['training_losses']}, validation "
              f"{run['validation_losses']}, best epoch {run['best_epoch']}, kernel launches "
              f"{run['kernel_launches']}, wall {run['wall']:.2f} s")
    for key in ("training_losses", "validation_losses"):
        assert nccl[key] == single[key], (key, nccl[key], single[key])
        got, want = [v for v, _ in gloo[key]], [v for v, _ in single[key]]
        rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        print(f"  two gloo ranks vs one process, {key}: max rel diff {rel:.3e}")
        assert rel <= DDP_RTOL, (key, got, want)
    assert nccl["best_epoch"] == single["best_epoch"] == gloo["best_epoch"]
    for run in (nccl, gloo):
        assert all((run["kernel_launches"][k] > 0) == (k in STREAM_PAIR) for k in KERNELS), run
    # two ranks each launch what one process does: the same steps, a stripe each
    assert nccl["kernel_launches"] == single["kernel_launches"]
    assert gloo["kernel_launches"] == {k: 2 * v for k, v in single["kernel_launches"].items()}
    print(f"  world size 1 (NCCL) losses equal the unwrapped run's; wall {wall:.2f} s "
          f"(process start to exit) on {card}")
    return gloo["kernel_launches"]


def model_parallel(bin_fn: Path, card):
    """Phase 10f: the model axis on the one card, dropout off, float32, on
    phase 8's bin: two gloo ranks on cuda:0 on a (1, 2) mesh, each holding
    half of L4 and of the stems, against the unwrapped train_model: loss
    sums within DDP_RTOL and the same best epoch, the gathered parameters
    at their full shapes, finite, and within rtol 1e-3, atol 1e-5 but for
    Adam's outliers (PARAM_OUTSIDE_SHARE), and twice the single run's
    launches (each rank runs the whole BiLSTM on the one stripe). Then the
    first train step, dropout on, on the mesh against one process: the
    global norm before the clip within NORM_RTOL on both ranks, each leaf's
    gradient within GRAD_RTOL of its largest, the same loss within
    DDP_RTOL."""
    started = time.perf_counter()
    report, wall, _ = run_process(["-c", MODEL_PARALLEL_SCRIPT, str(bin_fn), str(TRAIN_EPOCHS)],
                                  900)
    single, split = report["single"], report["model_2"]
    for name in ("single", "model_2"):
        run = report[name]
        print(f"  {name}: training loss sums {run['training_losses']}, validation "
              f"{run['validation_losses']}, kernel launches {run['kernel_launches']}, wall "
              f"{run['wall']:.2f} s")
    for key in ("training_losses", "validation_losses"):
        got, want = [v for v, _ in split[key]], [v for v, _ in single[key]]
        rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        print(f"  (1, 2) mesh vs one process, {key}: max rel diff {rel:.3e}")
        assert rel <= DDP_RTOL, (key, got, want)
    best = [min(run["validation_losses"])[1] for run in (single, split)]
    assert best[0] == best[1], best
    assert report["full_shapes"], "the gathered parameters are not the full model's"
    params = report["params"]
    outside = {k: v[1] for k, v in params.items() if v[1]}
    print(f"  gathered parameters vs one process: {sum(outside.values())} of "
          f"{sum(v[0] for v in params.values())} elements outside rtol 1e-3, atol 1e-5 "
          f"{outside} (at most a {PARAM_OUTSIDE_SHARE} share of each leaf); largest |diff| "
          f"{max(v[2] for v in params.values()):.3e}")
    assert all(v[3] for v in params.values()), params
    assert all(count <= PARAM_OUTSIDE_SHARE * params[k][0] for k, count in outside.items()), params
    step = report["first_step"]
    norm_rel = [abs(n - step["norm"]) / step["norm"] for n in step["rank_norms"]]
    loss_rel = [abs(v - step["loss"]) / abs(step["loss"]) for v in step["rank_losses"]]
    worst = max(step["grads"], key=step["grads"].get)
    print(f"  first step, dropout on, (1, 2) mesh vs one process: loss {step['rank_losses']} "
          f"vs {step['loss']}; global norm before the clip {step['rank_norms']} vs "
          f"{step['norm']} (rel diff {max(norm_rel):.3e}, limit {NORM_RTOL}); gradients: "
          f"largest |diff| / the leaf's largest |gradient| {step['grads'][worst]:.3e} ({worst}, "
          f"limit {GRAD_RTOL})")
    assert step["norm"] > 5.0, step["norm"]  # the clip engages (GRADIENT_CLIP_NORM)
    assert max(norm_rel) <= NORM_RTOL, step
    assert step["grads"][worst] <= GRAD_RTOL, step["grads"]
    assert max(loss_rel) <= DDP_RTOL, step
    launches = split["kernel_launches"]
    assert all((launches[k] > 0) == (k in STREAM_PAIR) for k in KERNELS), launches
    assert launches == {k: 2 * v for k, v in single["kernel_launches"].items()}, launches
    print(f"  best epoch {best[0]} on both; phase wall {time.perf_counter() - started:.2f} s "
          f"(process {wall:.2f} s) on {card}")
    return launches


def scan_layers_vs_cpu(dev):
    """Phase 10g, first part: each layer of the scan BiLSTM at full width
    (lstm1 32 -> 128, lstm2 256 -> 128) on the card against the same
    function on the CPU, at each SCAN_BATCHES batch (the hoisted and the
    fused step form), in float32 and bfloat16: the output and the gradients
    of sum(out * weights) for the input and every parameter (float32
    masters cast at use, as ClairNet casts them). Returns the float32
    layers' parameters and the B = 512 inputs, on the card, for the
    comparison with row 1."""
    from clair_tpu_torch.models.bilstm import bilstm_scan

    def run(p, x, weights, dtype, device):
        # fresh leaves each run (.to on the CPU would return the tensor itself)
        leaves = {d: {k: v.detach().to(device).requires_grad_() for k, v in q.items()}
                  for d, q in p.items()}
        xd = x.detach().to(device).requires_grad_()
        out = bilstm_scan({d: {k: v.to(dtype) for k, v in q.items()} for d, q in leaves.items()},
                          xd.to(dtype))
        (out.float() * weights.to(device)).sum().backward()
        grads = {"x": xd.grad, **{f"{d}.{k}": v.grad for d, q in leaves.items()
                                  for k, v in q.items()}}
        return out.detach().float().cpu(), {k: g.cpu() for k, g in grads.items()}

    kept = {}
    for layer, feat in LAYERS:
        p = lstm_params(np.random.RandomState(feat + 1), feat, HIDDEN, "cpu")
        generator = torch.Generator().manual_seed(feat)
        for batch in SCAN_BATCHES:
            x = torch.randn(batch, T_LEN, feat, generator=generator)
            weights = torch.randn(batch, T_LEN, 2 * HIDDEN, generator=generator)
            for dtype in (torch.float32, torch.bfloat16):
                started = time.perf_counter()
                card_out, card_grads = run(p, x, weights, dtype, dev)
                torch.cuda.synchronize()
                card_s = time.perf_counter() - started
                started = time.perf_counter()
                cpu_out, cpu_grads = run(p, x, weights, dtype, "cpu")
                cpu_s = time.perf_counter() - started
                diff = (card_out - cpu_out).abs()
                rel = {k: ((g - cpu_grads[k]).abs().max() / cpu_grads[k].abs().max()).item()
                       for k, g in card_grads.items()}
                worst = max(rel, key=rel.get)
                out_rel = (diff.max() / cpu_out.abs().max()).item()
                print(f"  scan {layer} B={batch} {str(dtype)[6:]} card vs CPU: output max|d| "
                      f"{diff.max().item():.3e} (of scale {out_rel:.3e}), mean "
                      f"{diff.mean().item():.3e}; gradients max|d| of scale {rel[worst]:.3e} "
                      f"({worst}); card {card_s:.2f} s, CPU {cpu_s:.2f} s")
                assert torch.isfinite(card_out).all()
                if dtype == torch.float32:
                    assert out_rel <= SCAN_F32_REL and rel[worst] <= SCAN_F32_REL, (out_rel, rel)
                else:
                    assert diff.max() <= SCAN_BF16_MAX and diff.mean() < SCAN_BF16_MEAN, diff
                    assert rel[worst] <= SCAN_BF16_GRAD_REL, rel
                if batch == CALL_BATCH and dtype == torch.float32:
                    kept[layer] = ({d: {k: v.to(dev) for k, v in q.items()} for d, q in p.items()},
                                   x.to(dev))
    return kept


def scan_bilstm(params, bin_fn: Path, dev, trains, card):
    """Phase 10g: the scan BiLSTM on the card. Its layers against the CPU
    (scan_layers_vs_cpu); the float32 scan against row 1 at B = 512 within
    SCAN_ROW1_ATOL + SCAN_ROW1_RTOL; ``train --no_stream_bilstm`` on phase
    8's bin in bfloat16 and float32 (phase 8's checks, no kernel launching)
    beside phase 8's default runs, where rows 1 and 2 launched; three Adam
    steps of the scan, card vs CPU (STEP_RTOL); the scan's train step at B =
    10,000 and its peak memory beside the streaming pair's, in turns.
    Returns the bfloat16 run's launches."""
    from clair_tpu_torch.models.bilstm import bilstm_scan
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream

    started = time.perf_counter()
    for layer, (p, x) in scan_layers_vs_cpu(dev).items():
        with torch.no_grad():
            got, row1 = bilstm_scan(p, x), bilstm_stream(p, x)
        err = (got - row1).abs()
        excess = (err - SCAN_ROW1_RTOL * row1.abs()).max().item()
        print(f"  scan vs row 1, {layer} B={CALL_BATCH} float32: max|d| {err.max().item():.3e} "
              f"(limit {SCAN_ROW1_ATOL} + {SCAN_ROW1_RTOL}*|row 1|)")
        assert excess <= SCAN_ROW1_ATOL, excess
    print(f"  layers: {time.perf_counter() - started:.2f} s")

    runs = {}
    with tempfile.TemporaryDirectory(dir=bin_fn.parent) as out_dir:
        def cli_run(dtype):
            prefix = Path(out_dir) / f"model_scan_{dtype}"
            flags = ["--train_compute_dtype", "float32"] if dtype == "float32" else []
            return train(prefix, lambda: run_port(
                ["train", "--bin_fn", str(bin_fn), "--ochk_prefix", str(prefix),
                 "--maxEpoch", str(TRAIN_EPOCHS), "--no_stream_bilstm", *flags], 600), pair=())

        # the two runs at once, each in its process, sharing the card
        dtypes = ("bfloat16", "float32")
        with ThreadPoolExecutor(len(dtypes)) as pool:
            results = dict(zip(dtypes, pool.map(cli_run, dtypes)))
        for dtype, (report, wall, top, epochs) in results.items():
            default = trains[dtype][0]["kernel_launches"]
            print(f"  train --no_stream_bilstm {dtype}: validation loss sums "
                  f"{report['validation_losses']}, training loss sums "
                  f"{report['training_losses']}, kernel launches {report['kernel_launches']} "
                  f"(phase 8's default run: {default}), wall {wall:.2f} s (process start to "
                  f"exit, the two runs at once); {top}; {epochs}")
            assert all(default[k] > 0 for k in STREAM_PAIR), default
            runs[dtype] = report["kernel_launches"]

    check_train_step(params, pair=(), scan=True)
    print(f"train step B={TRAIN_BATCH} on {card} (host clock, mean of 5 synchronized steps "
          f"after one, in turns; the step's peak: torch.cuda.max_memory_allocated over those "
          f"steps above what was allocated before them):")
    for dtype in ("bfloat16", "float32"):
        steps = {"streaming pair": full_width_step(params, dev, dtype),
                 "scan": full_width_step(params, dev, dtype, scan=True)}
        for name in ("streaming pair", "scan", "scan", "streaming pair"):
            step_ms, rate, peak = step_times(steps[name])
            print(f"  {dtype} {name}: {step_ms:.2f} ms, {rate:.0f} samples/s, peak "
                  f"{peak / 2 ** 30:.2f} GiB")
        for name, run in steps.items():
            busy, kernels = step_device_time(run)
            print(f"  {dtype} {name}: device {busy:.2f} ms a step in {kernels:.0f} kernel "
                  f"launches (torch.profiler, kernel times summed over 5 steps)")
    return runs["bfloat16"]


def sharded_calling(fasta, bam, tmp: Path, phase7_rows, card):
    """Phase 10e: call_bam through ShardedPredictor on cuda:0 twice: phase
    7's bfloat16 rows; then ``call_bam --num_devices N`` with N one more
    than the visible cards raises, naming the flag."""
    out = str(tmp / "sharded.vcf")
    rows, launches, wall, sites = calls_of(out, *run_process(
        ["-c", SHARDED_SCRIPT, bam, fasta, str(ROOT / "examples" / "ont_synthetic.ckpt"), out],
        500))
    assert rows == phase7_rows, "ShardedPredictor's rows differ from phase 7's bfloat16 rows"
    assert launches["bilstm_stream"] > 0, launches
    print(f"  call_bam, ShardedPredictor on cuda:0 x 2: {len(rows)} rows identical to phase "
          f"7's bfloat16 run, kernel launches {launches}, wall {wall:.2f} s; {sites}")
    n = torch.cuda.device_count() + 1
    proc = subprocess.run(
        [sys.executable, "-m", "clair_tpu_torch", "call_bam", "--bam_fn", bam, "--ref_fn", fasta,
         "--chkpnt_fn", str(ROOT / "examples" / "ont_synthetic.ckpt"), "--ctgName", "chr1",
         "--num_devices", str(n), "--call_fn", str(tmp / "refused.vcf")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    want = f"--num_devices {n} needs {n} CUDA devices"
    assert proc.returncode != 0 and want in proc.stderr, (proc.returncode, proc.stderr[-2000:])
    print(f"  call_bam --num_devices {n} on {torch.cuda.device_count()} card(s): exit "
          f"{proc.returncode}, {proc.stderr.strip().splitlines()[-1]}")
    return launches


def write_training_bin(path: Path):
    """TRAIN_ROWS learnable rows in blocks of BIN_BLOCK_SIZE, written by the
    port's bins module."""
    from clair_tpu_torch.data import bins
    from clair_tpu_torch.io import lz4
    from clair_tpu_torch.params import BIN_BLOCK_SIZE

    x, y = pileup_batch(np.random.RandomState(12), TRAIN_ROWS)
    order = np.random.RandomState(13).permutation(TRAIN_ROWS)
    x, y = x[order], y[order]
    offs = range(0, TRAIN_ROWS, BIN_BLOCK_SIZE)
    dataset = bins.BinDataset(
        TRAIN_ROWS,
        [bins._pack(x[o:o + BIN_BLOCK_SIZE]) for o in offs],
        [bins._pack(y[o:o + BIN_BLOCK_SIZE]) for o in offs],
        [bins._pack(np.array([f"chr1:{o + j}" for j in range(BIN_BLOCK_SIZE)])) for o in offs],
        BIN_BLOCK_SIZE,
    )
    bins.write_bin(str(path), dataset)
    reread = bins.load_bin(str(path))
    assert reread.x_block(0, cast=False).dtype == np.int16
    codec = "LZ4S" if dataset.x_blocks[0][:4] == b"LZ4S" else "zstd"
    print(f"  wrote {TRAIN_ROWS} rows in {dataset.n_blocks} blocks ({codec}, int16 x), "
          f"{path.stat().st_size / 1e6:.1f} MB; system liblz4 found: {lz4.available()}")


def train(prefix: Path, run, pair=STREAM_PAIR):
    """Phases 8 and 8b, one run: ``run()`` trains into ``prefix`` in a
    process of its own; then its checks. Only the kernel ``pair`` launches."""
    from clair_tpu_torch.models.checkpoint import checkpoint_path, load_checkpoint

    report, wall, stderr = run()
    val = [v for v, _ in report["validation_losses"]]
    trn = [v for v, _ in report["training_losses"]]
    assert len(val) == TRAIN_EPOCHS and all(math.isfinite(v) for v in val + trn), report
    assert val[-1] < val[0], f"validation loss did not fall: {val}"
    for epoch in range(1, TRAIN_EPOCHS + 1):
        params, extra = load_checkpoint(checkpoint_path(str(prefix), epoch))
        assert extra["epoch"] == epoch and params["l3"]["w"].shape == (256, 33, 30)
    assert "[INFO] Evaluation on gt21:" in stderr and "gt21 all/top1/top2" in stderr
    launches = report["kernel_launches"]
    assert all((launches[k] > 0) == (k in pair) for k in KERNELS), launches
    top = [line for line in stderr.splitlines() if "gt21 all/top1/top2" in line][-1]
    epochs = [line for line in stderr.splitlines() if "Epoch time elapsed" in line]
    return report, wall, top, epochs


def full_width_step(params, dev, dtype, scan=False, **flags):
    """A full-width train step at batch 10,000 on fixed inputs, as a
    callable of no argument, after one warm-up step."""
    from clair_tpu_torch.models.clair import ClairNet
    from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step
    from clair_tpu_torch.params import TRAIN_BATCH_SIZE, ModelConfig

    model = ClairNet.from_jax(params, ModelConfig(compute_dtype=dtype, **flags), dev, scan=scan)
    step = make_train_step(model, make_optimizer(dict(model.named_parameters()), "Adam", 1e-3))
    x, y = pileup_batch(np.random.RandomState(14), TRAIN_BATCH_SIZE)
    xd = torch.from_numpy(x.astype(np.int16)).to(dev)
    yd = torch.from_numpy(y.astype(np.int16)).to(dev)
    generator = torch.Generator(device=dev).manual_seed(0)

    def run():
        step(xd, yd, generator, 0.005)

    run()
    torch.cuda.synchronize()
    return run


def step_times(run, iters=5):
    """ms per call of ``run``, a full-width train step at batch 10,000 (host
    clock around synchronized calls), samples/s, and the step's peak of
    device memory: the most allocated during the calls above what was
    allocated before them (bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    started = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - started) / iters * 1e3
    return ms, TRAIN_BATCH / ms * 1e3, torch.cuda.max_memory_allocated() - resident


def step_device_time(run, iters=5):
    """run()'s device time (torch.profiler's kernel times summed) and its
    kernel launches, per call, over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    us = kernels = 0
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            us += e.self_device_time_total
            kernels += e.count
    return us / 1e3 / iters, kernels / iters


# the backwards' kernels by part, from substrings of their names (the rest
# are the wrapper's torch ops: U's transpose and the sum of the weight
# partials); row 2's problems are GateProblem, ... (its bf16 mode's
# TmaGateProblem, ... on wgmma_product), row 6's StackedGateProblem,
# and the float32 forwards' x.W products are row 5's StackedGateProblem and
# row 1's StreamXWProblem
BWD_PARTS = (("gate product", ("GateProblem", "XWProblem")), ("sweep", ("sweep",)),
             ("weight sums", ("WeightSumProblem",)), ("dx", ("DxProblem",)),
             ("float32 pieces", ("split_pieces",)))
PROFILE_ATTEMPTS = 2  # profiles of device_parts before a split is printed as incomplete


def device_parts(run, iters, label):
    """run()'s device time by part of BWD_PARTS (torch.profiler's
    key_averages over ``iters`` calls after a warm-up), ms per call, with
    "total" the CUDA-event time of the same calls. A profile in which some
    kernel's launches are no positive multiple of ``iters`` lost events (a
    long process on the card has shown 1-4 of 5 calls recorded) and is
    taken again, up to PROFILE_ATTEMPTS times. Each kernel's ms per call is
    its mean per launch times its launches a call: count / iters, or, in a
    profile still short, its count over the fewest launches any kernel
    recorded, rounded (exact for the kernels launched once a call, as the
    products and the sweeps are), and the split is printed as estimated."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    total = cuda_ms(run, iters)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                run()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if device_us(e) > 0]
        complete = all(e.count >= iters and e.count % iters == 0 for e in events)
        if complete:
            break
        print(f"    {label}: profile {attempt} of {PROFILE_ATTEMPTS} recorded launch counts "
              f"{sorted({e.count for e in events})}, not multiples of {iters} calls"
              + ("; profiling again" if attempt < PROFILE_ATTEMPTS else "; the split below is "
                 "ESTIMATED from each kernel's mean per launch (events lost), its total is "
                 "the CUDA-event time"))
    calls = iters if complete else min(e.count for e in events)
    parts = {name: 0.0 for name, _ in BWD_PARTS}
    parts["other (torch ops)"] = 0.0
    for e in events:
        launches = e.count / iters if complete else max(1, round(e.count / calls))
        ms = device_us(e) / 1e3 / e.count * launches
        part = next((name for name, keys in BWD_PARTS
                     if any(k in e.key for k in keys)), "other (torch ops)")
        parts[part] += ms
        print(f"    {label} {e.key[:90]}: {ms:.4f} ms x{launches:g}")
    parts["total"] = total
    print(f"  {label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()), flush=True)
    return parts


def backward_split(dev, batch=TRAIN_BATCH, iters=5, dtypes=(torch.bfloat16, torch.float32),
                   pair=STREAM_PAIR, cluster=0, rows=0):
    """A backward's device time by part (``device_parts``), per layer (lstm1
    without dx, as the train step runs it) and dtype: row 2 (``pair`` =
    STREAM_PAIR) in ``dtypes``, or row 6 (TRAIN_PAIR, float32 only) on the
    stacked layout, its sweep at ``cluster`` and ``rows`` (0: the kernel's
    choice; bf16 takes ``rows`` alone), counting no launch
    (``_backward_launch``). {(layer, dtype): {part: ms per call}}."""
    from clair_tpu_torch.ops.bilstm_stream import _backward_launch as stream_backward
    from clair_tpu_torch.ops.bilstm_stream import _forward, _stack_params
    from clair_tpu_torch.ops.bilstm_train import _backward_launch as train_backward
    from clair_tpu_torch.ops.bilstm_train import bilstm_train_forward

    train = pair == TRAIN_PAIR
    split = {}
    for layer, feat in LAYERS:
        need_dx = layer == "lstm2"  # lstm1's input takes no gradient
        if not train:
            rs = np.random.RandomState(feat + 3)
            p = lstm_params(rs, feat, HIDDEN, dev)
            x = torch.tensor(rs.randn(batch, T_LEN, feat), dtype=torch.float32, device=dev)
            dh32 = torch.tensor(rs.randn(batch, T_LEN, 2 * HIDDEN), dtype=torch.float32,
                                device=dev)
        for dtype in (torch.float32,) if train else dtypes:
            if train:
                xs, w, u, bias, dh = stacked_inputs((batch, T_LEN, feat, HIDDEN), dev, feat + 5)
                h_out, c_out = bilstm_train_forward(xs, w, u, bias)

                def run():
                    return train_backward(xs, w, u, bias, h_out, c_out, dh, need_dx=need_dx,
                                          cluster=cluster, rows=rows)
            else:
                w, u, bias = _stack_params(p, dtype)
                xd, dh = x.to(dtype), dh32.to(dtype)
                h_out, c_out = _forward(xd, w, u, bias, with_cell=True)

                def run():
                    return stream_backward(xd, w, u, bias, h_out, c_out, dh, need_dx=need_dx,
                                           cluster=cluster, rows=rows)

            name = str(dtype)[6:]
            split[(layer, name)] = device_parts(
                run, iters, f"row {6 if train else 2} split {layer} B={batch} {name}")
    return split


def forward_split(dev, batch=TRAIN_BATCH, iters=5):
    """The float32 forwards' device time by part (``device_parts``: the
    float32 pieces of x and W, the product xw = x.W + b under "gate
    product", the sweep), per layer at the training batch: row 5, and row
    1's float32 mode with c. {(row, layer): {part: ms per call}}."""
    from clair_tpu_torch.ops.bilstm_stream import _forward, _stack_params
    from clair_tpu_torch.ops.bilstm_train import bilstm_train_forward

    split = {}
    for layer, feat in LAYERS:
        xs, w, u, bias, _ = stacked_inputs((batch, T_LEN, feat, HIDDEN), dev, feat + 5)
        split[(5, layer)] = device_parts(lambda: bilstm_train_forward(xs, w, u, bias), iters,
                                         f"row 5 split {layer} B={batch} float32")
        rs = np.random.RandomState(feat + 5)
        stacked = _stack_params(lstm_params(rs, feat, HIDDEN, dev), torch.float32)
        x = torch.tensor(rs.randn(batch, T_LEN, feat), dtype=torch.float32, device=dev)
        split[(1, layer)] = device_parts(lambda: _forward(x, *stacked, with_cell=True), iters,
                                         f"row 1 split {layer} B={batch} float32")
    return split


def new_kernel_times(params, dev, ms, plain_ms):
    """Phase 9b: the new kernels and their plain versions at the paths'
    shapes (CUDA events after a warm-up), and the train step at batch
    10,000 under each training pair. Fills ``ms`` and ``plain_ms`` with the
    JSON line's sums: the train pair per layer at B = 10,000, the
    recurrence per layer at B = 512 in bfloat16 (the calling default's
    dtypes), bilstm2 at B = 512."""
    from clair_tpu_torch.ops.bilstm import (
        bilstm_recurrence, bilstm_recurrence_reference,
    )
    from clair_tpu_torch.ops.bilstm2 import bilstm2, bilstm2_reference
    from clair_tpu_torch.ops.bilstm_train import (
        bilstm_train_backward, bilstm_train_backward_reference, bilstm_train_forward,
        bilstm_train_reference,
    )

    for layer, feat in (("lstm1", 32), ("lstm2", 256)):
        xs, w, u, b, dh = stacked_inputs((10000, 33, feat, 128), dev, feat + 5)
        h_out, c_out = bilstm_train_forward(xs, w, u, b)
        need_dx = layer == "lstm2"  # lstm1's input takes no gradient
        times = {
            "bilstm_train": (cuda_ms(lambda: bilstm_train_forward(xs, w, u, b), 5),
                             cuda_ms(lambda: bilstm_train_reference(xs, w, u, b), 5)),
            "bilstm_train_backward": (
                cuda_ms(lambda: bilstm_train_backward(xs, w, u, b, h_out, c_out, dh,
                                                      need_dx=need_dx), 5),
                cuda_ms(lambda: bilstm_train_backward_reference(xs, w, u, b, h_out, c_out, dh,
                                                                need_dx=need_dx), 5)),
        }
        for name, (k, pl) in times.items():
            print(f"  {name} {layer} B=10000 f32: kernel {k:.4f} ms, plain {pl:.4f} ms")
            ms[name] += k
            plain_ms[name] += pl
        xs, w, u, b, _ = stacked_inputs((CALL_BATCH, 33, feat, 128), dev, feat + 7)
        print(f"  bilstm_train {layer} B={CALL_BATCH} f32: kernel "
              f"{cuda_ms(lambda: bilstm_train_forward(xs, w, u, b)):.4f} ms")
        geometry = (512, 33, feat, 128)
        for p_dtype, x_dtype in PRECOMPUTED_DTYPES:
            if (layer == "lstm1") != (x_dtype == p_dtype):
                continue  # lstm1 takes x in the compute dtype, lstm2 float32 h
            xw, u16 = precomputed_inputs(geometry, dev, p_dtype, x_dtype, feat + 6)
            k = cuda_ms(lambda: bilstm_recurrence(xw, u16))
            pl = cuda_ms(lambda: bilstm_recurrence_reference(xw, u16))
            print(f"  recurrence {layer} B=512 xw {str(xw.dtype)[6:]} u {str(u16.dtype)[6:]}: "
                  f"kernel {k:.4f} ms, plain {pl:.4f} ms")
            if p_dtype == torch.bfloat16:
                ms["bilstm_precomputed"] += k
                plain_ms["bilstm_precomputed"] += pl
    rs = np.random.RandomState(9)
    p1, p2 = lstm_params(rs, 32, 128, dev), lstm_params(rs, 256, 128, dev)
    x = torch.tensor(rs.randn(512, 33, 32), dtype=torch.float32, device=dev)
    with torch.no_grad():
        ms["bilstm2"] = cuda_ms(lambda: bilstm2(p1, p2, x))
        plain_ms["bilstm2"] = cuda_ms(lambda: bilstm2_reference(p1, p2, x))
    print(f"  bilstm2 B=512 f32: kernel {ms['bilstm2']:.4f} ms, plain {plain_ms['bilstm2']:.4f} ms")
    for name, flags in (("streaming pair", {}),
                        ("train pair", {"use_pallas_train_bilstm": True})):
        step_ms, rate, _ = step_times(full_width_step(params, dev, "float32", **flags))
        print(f"  train step B=10000 float32, {name}: {step_ms:.2f} ms, {rate:.0f} samples/s "
              f"(host clock, mean of 5 synchronized steps)")


def bilstm2_library_call(params, dev):
    """Phase 9c: bilstm2 as a library user calls it, on the vendored
    checkpoint's two BiLSTM layers and a calling batch, against the model's
    two streaming layers in float32; its count set to 0 just before."""
    from clair_tpu_torch.ops.bilstm2 import bilstm2
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream
    from clair_tpu_torch.pipeline.call_var import _device_input

    layers = [{d: {k: torch.from_numpy(np.array(v)).to(dev) for k, v in p.items()}
               for d, p in params[name].items()} for name in ("lstm1", "lstm2")]
    x = torch.from_numpy(np.random.RandomState(10).randint(0, 40, (512, 33, 8, 4))
                         .astype(np.uint8)).to(dev)
    x = _device_input(x).reshape(512, 33, 32)
    bilstm2.launches = 0
    with torch.inference_mode():
        out = bilstm2(*layers, x)
    launches = bilstm2.launches
    with torch.inference_mode():
        want = bilstm_stream(layers[1], bilstm_stream(layers[0], x))
    err = (out - want).abs().max().item()
    print(f"  bilstm2 on ont_production.ckpt's layers, B=512: launches {launches}, "
          f"max|d| vs the streaming layers {err:.3e}")
    assert launches == 1 and torch.isfinite(out).all() and err <= F32_TOL, (launches, err)
    return launches


def fwd_work(batch, feat, dtype, with_cell=False, stacked=False):
    """(operations, bytes) of one BiLSTM layer's forward: the two products
    of every step (2 * 2B * T * (F + H) * 4H; the gate nonlinearities are
    not counted), and x, W, U, b read once and h (and the float32 c)
    written once. ``stacked``: the train pair's input, both directions
    stacked along the batch (x twice)."""
    e = torch.tensor([], dtype=dtype).element_size()
    rows = batch * T_LEN
    flops = 2 * 2 * rows * (feat + HIDDEN) * 4 * HIDDEN
    weights = 2 * (feat + HIDDEN) * 4 * HIDDEN * e + 2 * 4 * HIDDEN * 4
    out = rows * 2 * HIDDEN * (e + (4 if with_cell else 0))
    return flops, rows * feat * e * (2 if stacked else 1) + weights + out


def bwd_work(batch, feat, dtype, need_dx, stacked=False):
    """(operations, bytes) of one layer's backward: the gates from
    [x | h], dh carried through U, dW and dU, and dx where wanted;
    x, h, c (float32), dh and the weights read once, dx and the float32
    dW, dU, db written once."""
    e = torch.tensor([], dtype=dtype).element_size()
    rows = batch * T_LEN
    depth = (feat + HIDDEN) + HIDDEN + (feat + HIDDEN) + (feat if need_dx else 0)
    flops = 2 * 2 * rows * 4 * HIDDEN * depth
    x = rows * feat * e * (2 if stacked else 1)
    weights = 2 * (feat + HIDDEN) * 4 * HIDDEN * e + 2 * 4 * HIDDEN * 4
    saved = rows * 2 * HIDDEN * (e + 4 + e)           # h, float32 c, dh
    grads = 2 * (feat + HIDDEN + 1) * 4 * HIDDEN * 4
    return flops, x + weights + saved + grads + (x if need_dx else 0)


def bound(works, dtype):
    """(ms, "operations" or "bytes"): the larger of the operations over the
    card's peak for dtype and the bytes over its memory rate, summed over
    the layers' (operations, bytes)."""
    ops_s = sum(f for f, _ in works) / PEAK_FLOPS[dtype]
    bytes_s = sum(b for _, b in works) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def library_lstm(layers, dtype, dev):
    """torch.nn.LSTM (cuDNN) carrying the layers' weights: weight_ih = w.T,
    weight_hh = u.T, bias_ih = b, bias_hh = 0 (ROADMAP Queue 3's oracle)."""
    feat = layers[0]["fw"]["w"].shape[0]
    lstm = torch.nn.LSTM(feat, HIDDEN, num_layers=len(layers), bidirectional=True,
                         batch_first=True).to(dev)
    with torch.no_grad():
        for i, p in enumerate(layers):
            for suffix, d in (("", "fw"), ("_reverse", "bw")):
                getattr(lstm, f"weight_ih_l{i}{suffix}").copy_(p[d]["w"].T)
                getattr(lstm, f"weight_hh_l{i}{suffix}").copy_(p[d]["u"].T)
                getattr(lstm, f"bias_ih_l{i}{suffix}").copy_(p[d]["b"])
                getattr(lstm, f"bias_hh_l{i}{suffix}").zero_()
    lstm = lstm.to(dtype)
    lstm.flatten_parameters()  # one weight buffer, as cuDNN takes it
    return lstm


def backward_ms(lstm, x, dh, iters):
    """Mean device time of lstm's backward alone (CUDA events around
    .backward() after each forward)."""
    total = 0.0
    for i in range(iters + 1):
        out, _ = lstm(x)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out.backward(dh)
        end.record()
        torch.cuda.synchronize()
        if i:  # the first is the warm-up
            total += start.elapsed_time(end)
    return total / iters


def precomputed_library(dev):
    """Row 3's library time: per layer and direction, torch.nn.LSTM with
    input size 4H, weight_ih = I, no bias and weight_hh = U^T, fed that
    direction's xw (T, B, 4H) as the model gives it to the kernel at the
    calling batch in bf16 (lstm1: xw and U bf16; lstm2: xw float32, U the
    bf16 weights widened). It computes the same recurrence, plus a 4H x 4H
    product of xw with the identity. Summed over the four calls."""
    total = 0.0
    for p_dtype, x_dtype in PRECOMPUTED_DTYPES[1:]:
        feat = 32 if x_dtype == torch.bfloat16 else 256
        xw, u = precomputed_inputs((CALL_BATCH, T_LEN, feat, HIDDEN), dev, p_dtype, x_dtype, 16)
        for d in range(2):
            lstm = torch.nn.LSTM(4 * HIDDEN, HIDDEN, bias=False).to(dev)
            with torch.no_grad():
                lstm.weight_ih_l0.copy_(torch.eye(4 * HIDDEN, device=dev))
                lstm.weight_hh_l0.copy_(u[d].float().T)
            lstm = lstm.to(xw.dtype)
            lstm.flatten_parameters()
            seq = xw[d].contiguous()
            with torch.no_grad():
                ms = cuda_ms(lambda: lstm(seq))
            print(f"    torch.nn.LSTM(4H, H, weight_ih = I) on xw {str(xw.dtype)[6:]} direction "
                  f"{d} B={CALL_BATCH}: {ms:.4f} ms")
            total += ms
    return total


def yardsticks(dev):
    """Phase 9d: each kernel's bound_ms at the shapes of its JSON ``ms``
    (rows 1 and 3 the calling path, B = 512, both layers, bf16; row 4 both
    layers fused, B = 512, float32; rows 2, 5 and 6 the training batch,
    B = 10,000, both layers, bf16 for the streaming pair and float32 for
    the train pair, lstm1 without dx), and library_ms, the time of
    torch.nn.LSTM computing the same function on the same shapes (row 3:
    with an identity weight_ih, fed xw; None where it refuses the dtype).
    Row 1's float32 mode gets the same at B = 512 and 10,000 (both layers,
    c at the training batch), returned as a third dict by batch, and row
    2's float32 mode at 10,000 as a fourth (its library call is row 6's:
    torch.nn.LSTM's float32 backward of the same layers).
    Prints beside each bound the tensor-core term of the kernel's passes
    (passes x operations / the bf16 peak): the float32 rows run their
    products as six bf16 passes, row 3 its h.U as three (U bf16)."""
    bf16, f32 = torch.bfloat16, torch.float32
    works = {
        "bilstm_stream": ([fwd_work(CALL_BATCH, f, bf16) for _, f in LAYERS], bf16, 1),
        "bilstm_stream_backward": (
            [bwd_work(TRAIN_BATCH, f, bf16, need_dx=f != 32) for _, f in LAYERS], bf16, 1),
        "bilstm_train": ([fwd_work(TRAIN_BATCH, f, f32, with_cell=True, stacked=True)
                          for _, f in LAYERS], f32, 6),
        "bilstm_train_backward": (
            [bwd_work(TRAIN_BATCH, f, f32, need_dx=f != 32, stacked=True) for _, f in LAYERS],
            f32, 6),
        # the recurrence alone on precomputed xw: 2 * 2B * T * H * 4H per
        # layer, xw (lstm1 bf16, lstm2 float32) and U read, float32 h written
        "bilstm_precomputed": (
            [(2 * 2 * CALL_BATCH * T_LEN * HIDDEN * 4 * HIDDEN,
              2 * T_LEN * CALL_BATCH * 4 * HIDDEN * xw_e + 2 * HIDDEN * 4 * HIDDEN * 2
              + CALL_BATCH * T_LEN * 2 * HIDDEN * 4) for xw_e in (2, 4)], bf16, 3),
        # both layers, layer 1's h kept on chip
        "bilstm2": ([(fwd_work(CALL_BATCH, 32, f32)[0] + fwd_work(CALL_BATCH, 256, f32)[0],
                      CALL_BATCH * T_LEN * (32 + 2 * HIDDEN) * 4
                      + sum(2 * (f + HIDDEN) * 4 * HIDDEN * 4 for _, f in LAYERS))], f32, 6),
    }
    bounds = {name: bound(w, dtype) for name, (w, dtype, _) in works.items()}
    pass_ms = {name: passes * sum(f for f, _ in w) / PEAK_FLOPS[bf16] * 1e3
               for name, (w, _, passes) in works.items()}
    library = dict.fromkeys(KERNELS)
    rs = np.random.RandomState(15)
    params = {f: lstm_params(rs, f, HIDDEN, dev) for _, f in LAYERS}

    def each_layer(batch, dtype, run):
        total = 0.0
        for layer, feat in LAYERS:
            lstm = library_lstm([params[feat]], dtype, dev)
            x = torch.tensor(rs.randn(batch, T_LEN, feat), dtype=dtype, device=dev)
            ms = run(lstm, x, feat)
            print(f"    torch.nn.LSTM {layer} B={batch} {str(dtype)[6:]}: {ms:.4f} ms")
            total += ms
        return total

    def inference(lstm, x, feat):
        with torch.no_grad():
            return cuda_ms(lambda: lstm(x))

    def training_forward(lstm, x, feat):
        return cuda_ms(lambda: lstm(x), 5)

    def training_backward(lstm, x, feat):
        x = x.requires_grad_(feat != 32)  # lstm1's input takes no gradient
        dh = torch.tensor(rs.randn(*x.shape[:2], 2 * HIDDEN), dtype=x.dtype, device=dev)
        return backward_ms(lstm, x, dh, 5)

    for name, batch, dtype, run in (("bilstm_stream", CALL_BATCH, bf16, inference),
                                    ("bilstm_stream_backward", TRAIN_BATCH, bf16, training_backward),
                                    ("bilstm_train", TRAIN_BATCH, f32, training_forward),
                                    ("bilstm_train_backward", TRAIN_BATCH, f32, training_backward)):
        try:
            library[name] = each_layer(batch, dtype, run)
        except RuntimeError as refused:  # the yardstick, not the port: record and go on
            print(f"    torch.nn.LSTM refuses {name}'s shapes in {dtype}: {refused}")
    try:
        library["bilstm_precomputed"] = precomputed_library(dev)
    except RuntimeError as refused:  # the yardstick, not the port: record and go on
        print(f"    torch.nn.LSTM refuses bilstm_precomputed's shapes: {refused}")
    two = library_lstm([params[32], params[256]], f32, dev)
    x = torch.tensor(rs.randn(CALL_BATCH, T_LEN, 32), dtype=f32, device=dev)
    library["bilstm2"] = inference(two, x, 32)
    print(f"    torch.nn.LSTM num_layers=2 B={CALL_BATCH} float32: {library['bilstm2']:.4f} ms")
    # row 1's float32 mode, both layers: at the calling batch, and at the
    # training batch with c, where its library call is row 5's (the same
    # layers in cuDNN's training forward)
    f32_mode = {}
    for batch, lib in ((CALL_BATCH, each_layer(CALL_BATCH, f32, inference)),
                       (TRAIN_BATCH, library["bilstm_train"])):
        b_ms, b_by = bound([fwd_work(batch, f, f32, with_cell=batch == TRAIN_BATCH)
                            for _, f in LAYERS], f32)
        f32_mode[f"B={batch}"] = {"bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    row2_works = [bwd_work(TRAIN_BATCH, f, f32, need_dx=f != 32) for _, f in LAYERS]
    b_ms, b_by = bound(row2_works, f32)
    row2_f32 = {f"B={TRAIN_BATCH}": {"bound_ms": b_ms, "bound_by": b_by,
                                     "library_ms": library["bilstm_train_backward"]}}
    for name in KERNELS:
        ms, by = bounds[name]
        lib = "none" if library[name] is None else f"{library[name]:.4f} ms"
        print(f"  {name}: bound {ms:.4f} ms ({by}), {works[name][2]}-pass tensor-core term "
              f"{pass_ms[name]:.4f} ms, library {lib}")
    for batch, y in f32_mode.items():
        lib = "none" if y["library_ms"] is None else f"{y['library_ms']:.4f} ms"
        print(f"  bilstm_stream float32 {batch}: bound {y['bound_ms']:.4f} ms ({y['bound_by']}), "
              f"library {lib}")
    for batch, y in row2_f32.items():
        lib = "none" if y["library_ms"] is None else f"{y['library_ms']:.4f} ms"
        print(f"  bilstm_stream_backward float32 {batch}: bound {y['bound_ms']:.4f} ms "
              f"({y['bound_by']}), 6-pass tensor-core term "
              f"{6 * sum(f for f, _ in row2_works) / PEAK_FLOPS[bf16] * 1e3:.4f} ms, library {lib} "
              f"(torch.nn.LSTM float32 backward, row 6's call)")
    return bounds, library, f32_mode, row2_f32


# phase 11: each recipe's epochs and batches (demo.py --quick and
# examples/train_synthetic.py), and the floors of
# tests/test_trained_model_e2e.py:69-71 (the per-platform models) and
# :111-115 (the production model); the demo's is demo.recall_floor
RECIPE_EPOCHS, RECIPE_BATCH, RECIPE_VAL_BATCH = 400, 256, 32
HELD_OUT_RECALL = HELD_OUT_PRECISION = 0.9
HELD_OUT_EXACT_SHARE = 0.85
PRODUCTION_RECALL, PRODUCTION_PRECISION, PRODUCTION_EXACT_SHARE = 0.93, 0.6, 0.9


# Clair3_F's stride-1 convolutions (ops/conv3x3.py) at its training batch:
# (channels, height, width) of the three BasicBlocks
CONV_BATCH = 2_000
CONV_STAGES = ((64, 45, 17), (128, 23, 9), (256, 12, 5))
# each kernel's gap from float64, as a share of the largest element: the
# float32 sums' round-off (tests/test_torch_conv3x3.py:CARD_TOL), which the
# plain versions with three piece pairs must miss
CONV_TOL = 1e-6


def conv3x3_checks(dev, card):
    """Phase 9e: the conv3x3 kernels' forward, dgrad and wgrad at B = 2,000
    at each stage's shape, held against float64 (F.conv2d and its gradients
    on the same card tensors) within CONV_TOL, where the plain versions with
    three piece pairs must miss it; their ms (the split passes included)
    beside the bound (the six-pass products at the bf16 peak, or the float32
    tensors' bytes at 3.35 TB/s), the plain version's ms and cuDNN's
    (``library_ms``, float32, TF32 off). Then one train step of the published
    Clair3_F at B = 2,000, every launch count set to 0 just before it: six
    launches of each kernel and six ``fa.conv`` counts of 1. Returns the
    records and the step's launches."""
    import torch.nn.functional as F
    from clair_tpu_torch.ops.conv3x3 import (
        PIECE_PAIRS, conv3x3, conv3x3_dgrad, conv3x3_dgrad_reference, conv3x3_reference,
        conv3x3_wgrad, conv3x3_wgrad_reference,
    )

    three = tuple((i, j) for i, j in PIECE_PAIRS if i + j < 2)
    print(f"conv3x3 at B={CONV_BATCH} on {card} (gaps from float64 as shares of the largest "
          f"element, limit {CONV_TOL:g}; CUDA events, kernel and cuDNN mean of 5, plain 1, "
          f"after a warm-up):")
    records, misses = [], []
    g = torch.Generator(device=dev).manual_seed(25)
    for c, h, w in CONV_STAGES:
        x = torch.randn((CONV_BATCH, c, h, w), generator=g, device=dev)
        go = torch.randn((CONV_BATCH, c, h, w), generator=g, device=dev)
        wt = torch.randn((3, 3, c, c), generator=g, device=dev) / math.sqrt(9 * c)
        b = torch.randn((c,), generator=g, device=dev)
        oihw = wt.permute(3, 2, 0, 1).contiguous()
        x64, go64, oihw64 = x.double(), go.double(), oihw.double()
        products = {
            "forward": (lambda: conv3x3(x, wt, b),
                        lambda pairs=PIECE_PAIRS: conv3x3_reference(x, wt, b, pairs),
                        lambda: F.conv2d(x, oihw, b, padding=1),
                        lambda: F.conv2d(x64, oihw64, b.double(), padding=1)),
            "dgrad": (lambda: conv3x3_dgrad(go, wt),
                      lambda pairs=PIECE_PAIRS: conv3x3_dgrad_reference(go, wt, pairs),
                      lambda: torch.nn.grad.conv2d_input(x.shape, oihw, go, padding=1),
                      lambda: torch.nn.grad.conv2d_input(x.shape, oihw64, go64, padding=1)),
            "wgrad": (lambda: conv3x3_wgrad(x, go),
                      lambda pairs=PIECE_PAIRS: conv3x3_wgrad_reference(x, go, pairs),
                      lambda: torch.nn.grad.conv2d_weight(x, oihw.shape, go, padding=1),
                      lambda: (torch.nn.grad.conv2d_weight(x64, oihw.shape, go64, padding=1)
                               .permute(2, 3, 1, 0), go64.sum(dim=(0, 2, 3)))),
        }
        cells, act = CONV_BATCH * h * w, 4 * CONV_BATCH * h * w * c
        ops = 6 * 2 * cells * c * 9 * c  # six bf16 passes
        for name, (kernel, plain, library, exact) in products.items():
            # the wgrad's outputs are (dw, db); gaps of dw, and of db apart
            got, want, control = kernel(), exact(), plain(three)
            if name != "wgrad":
                got, want, control = (got,), (want,), (control,)
            gaps = [((k.double() - e).abs().max() / e.abs().max()).item()
                    for k, e in zip(got, want)]
            three_gap = ((control[0].double() - want[0]).abs().max()
                         / want[0].abs().max()).item()
            del got, want, control
            if max(gaps) > CONV_TOL or three_gap <= CONV_TOL:
                misses.append((c, name, gaps, three_gap))
            k, pl, lib = cuda_ms(kernel, 5), cuda_ms(plain, 1), cuda_ms(library, 5)
            # float32 in and out: two activations (wgrad: two in, the kernel out)
            moved = 2 * act + 4 * 9 * c * c
            bound = max(ops / 989e12, moved / 3.35e12) * 1e3
            term = "ops" if ops / 989e12 >= moved / 3.35e12 else "bytes"
            print(f"  C={c} {h}x{w} {name}: gap {', '.join(f'{v:.3g}' for v in gaps)} (three "
                  f"pairs {three_gap:.3g}); kernel {k:.4f} ms, bound {bound:.4f} ms ({term}), "
                  f"plain {pl:.4f} ms, cuDNN {lib:.4f} ms")
            records.append({"channels": c, "map": [h, w], "product": name, "gap": gaps,
                            "three_pair_gap": three_gap, "ms": k, "bound_ms": bound,
                            "bound_by": term, "plain_ms": pl, "library_ms": lib})
        del x, go, x64, go64
    total = sum(r["ms"] for r in records)
    cudnn = sum(r["library_ms"] for r in records)
    print(f"  one of each block's convolutions, all three products: kernel {total:.3f} ms, "
          f"cuDNN {cudnn:.3f} ms (a train step runs two a block)")
    assert not misses, f"conv3x3 against float64 (limit {CONV_TOL:g}): {misses}"
    return records, conv3x3_train_step(dev)


def conv3x3_train_step(dev):
    """One train step of the published Clair3_F at B = 2,000 (random rows,
    one label a task), every launch count set to 0 just before it: each
    conv3x3 kernel six times and the forward's ``fa.conv`` six 1s and three
    0s. Returns the step's launches."""
    from clair_tpu_torch.models import clair3_fa
    from clair_tpu_torch.ops import launch_counts, reset_launch_counts
    from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step
    from clair_tpu_torch.reference.clair3_fa import SPANS
    from clair_tpu_torch.utils import trace

    config = clair3_fa.FullAlignmentConfig()
    model = clair3_fa.Clair3FANet.from_jax(
        clair3_fa.init_params(torch.Generator().manual_seed(25), config), config, dev)
    step = make_train_step(model, make_optimizer(dict(model.named_parameters()), "Adam", 1e-3))
    g = torch.Generator().manual_seed(26)
    x = torch.randint(-100, 101, (CONV_BATCH, *config.input_shape), generator=g)
    x = x.to(torch.int16).to(dev)
    y = torch.zeros(CONV_BATCH, 90, device=dev)
    for first, _ in SPANS:
        y[:, first] = 1
    with clair3_fa.float32_products():
        reset_launch_counts()
        since = trace._clock()
        loss = step(x, y, torch.Generator(device=dev).manual_seed(27), 1e-4)[0]
        launched = launch_counts()
    conv = [r.value for r in trace.records(since) if r.name == "fa.conv"]
    print(f"  one Clair3_F train step at B={CONV_BATCH}: loss {float(loss):.5f}, launches "
          f"{json.dumps({k: v for k, v in launched.items() if v})}, fa.conv {conv}")
    assert torch.isfinite(loss).all()
    assert {k: v for k, v in launched.items() if v} == {
        "conv3x3": 6, "conv3x3_dgrad": 6, "conv3x3_wgrad": 6}, launched
    assert sorted(conv) == [0, 0, 0, 1, 1, 1, 1, 1, 1], conv
    return {k: launched[k] for k in ("conv3x3", "conv3x3_dgrad", "conv3x3_wgrad")}


@contextlib.contextmanager
def recipe_run():
    """Around one recipe's run: every launch count set to 0 just before
    it; each train_model call's bin size and batches recorded, and the scan
    BiLSTM's calls counted (the recipe must not reach it)."""
    import clair_tpu_torch.models.clair as clair
    import clair_tpu_torch.pipeline.train as train
    from clair_tpu_torch.ops import reset_launch_counts

    seen = {"bins": [], "scan_calls": 0}
    scan, train_model = clair.bilstm_scan, train.train_model

    def counting_scan(*args, **kwargs):
        seen["scan_calls"] += 1
        return scan(*args, **kwargs)

    def recording_train_model(dataset, config):
        seen["bins"].append((dataset.dataset_size, config.train_batch_size,
                             config.val_batch_size, config.max_epochs))
        return train_model(dataset, config)

    clair.bilstm_scan, train.train_model = counting_scan, recording_train_model
    try:
        reset_launch_counts()
        yield seen
    finally:
        clair.bilstm_scan, train.train_model = scan, train_model


def check_recipe_launches(seen, launches, short_batch):
    """Every train step of the run went through rows 1 and 2: two backward
    launches a step (one a layer), at least two forward launches a train
    and a validation step, no scan; the bin's short last training batch is
    the one phases 3 and 4 checked. Returns the train steps."""
    from clair_tpu_torch.params import TRAINING_DATASET_PERCENTAGE

    (size, batch, val_batch, epochs), = seen["bins"]
    assert (batch, val_batch, epochs) == (RECIPE_BATCH, RECIPE_VAL_BATCH, RECIPE_EPOCHS)
    n_train = int(size * TRAINING_DATASET_PERCENTAGE)
    assert n_train % batch == short_batch, (size, n_train, short_batch)
    steps = epochs * math.ceil(n_train / batch)
    val_steps = epochs * math.ceil((size - n_train) / val_batch)
    assert launches["bilstm_stream_backward"] == 2 * steps, (launches, steps)
    assert launches["bilstm_stream"] >= 2 * (steps + val_steps), (launches, steps, val_steps)
    assert seen["scan_calls"] == 0, seen
    assert all(launches[k] == 0 for k in KERNELS if k not in STREAM_PAIR), launches
    return steps, val_steps, size


def recipe_demo(tmp: Path, card):
    """Phase 11a: the demo at ``--quick --profile ont`` (30 kb, 150 planted
    variants, ONT reads at 60x, 400 epochs of the narrow model, H = 32, in
    the training default bfloat16) on the card, held to its recall floor."""
    from clair_tpu_torch import demo

    with recipe_run() as seen:
        started = time.perf_counter()
        stats = demo.run_demo(work_dir=str(tmp / "demo"), **demo.demo_kwargs(True, "ont"))
        wall = time.perf_counter() - started
        launches = kernel_counts()
    steps, val_steps, size = check_recipe_launches(seen, launches, DEMO_SHORT_BATCH)
    snp, indel = stats["snp"], stats["indel"]
    print(f"  demo --quick --profile ont: bin {size} rows, {steps} train steps and {val_steps} "
          f"validation steps; recall {stats['recall']:.4f}, precision {stats['precision']:.4f}, "
          f"exact {stats['exact']}/{stats['n_truth']}, {stats['n_called']} calls; SNP P "
          f"{snp['precision']:.4f} R {snp['recall']:.4f} F1 {snp['f1']:.4f} | indel P "
          f"{indel['precision']:.4f} R {indel['recall']:.4f} F1 {indel['f1']:.4f}; kernel "
          f"launches {launches}, no scan; wall {wall:.2f} s on {card}")
    floor = demo.recall_floor("ont")
    assert stats["recall"] >= floor, (stats["recall"], floor)
    return {k: launches[k] for k in STREAM_PAIR}


def recipe_synthetic(tmp: Path, card):
    """Phase 11b: ``train_synthetic --profile ont --train_compute_dtype
    float32`` (the vendored checkpoints' recipe: 150 kb, 700 planted
    variants, the full-width model, 400 epochs at batch 256, fixed 1e-3,
    final-epoch parameters) on the card, then its held-out genome (seed
    424243, 30 kb) called on the card; the floors of the vendored models."""
    from clair_tpu_torch.examples import train_synthetic
    from clair_tpu_torch.models.checkpoint import load_checkpoint
    from clair_tpu_torch.models.clair import ClairNet
    from clair_tpu_torch.params import ModelConfig

    output = tmp / "ont_synthetic.ckpt"
    with recipe_run() as seen:
        out = train_synthetic.main(["--profile", "ont", "--train_compute_dtype", "float32",
                                    "--output", str(output)])
        launches = kernel_counts()
    steps, val_steps, size = check_recipe_launches(seen, launches, SYNTHETIC_SHORT_BATCH)
    params, extra = load_checkpoint(str(output))
    assert extra == {"epoch": RECIPE_EPOCHS}, extra
    # the JAX layout at full width: every leaf loads into the model
    ClairNet.from_jax(params, ModelConfig(), "cpu")
    losses = [v for v, _ in out["result"].validation_losses]
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], losses
    recall, precision, exact, n = out["recall"], out["precision"], out["exact"], out["n"]
    print(f"  train_synthetic --profile ont float32: bin {size} rows ({out['n_truth']} planted "
          f"variants), {steps} train steps and {val_steps} validation steps, validation loss "
          f"sums {losses[0]:.4f} (epoch 1) -> {losses[-1]:.4f} (epoch {len(losses)}); held-out "
          f"recall {recall:.4f}, precision {precision:.4f}, exact {exact}/{n}; kernel launches "
          f"{launches}, no scan; data {out['data_seconds']:.2f} s, train "
          f"{out['train_seconds']:.2f} s ({out['train_seconds'] / RECIPE_EPOCHS * 1e3:.3f} ms an "
          f"epoch), held-out {out['held_out_seconds']:.2f} s on {card}")
    assert recall >= HELD_OUT_RECALL and precision >= HELD_OUT_PRECISION, (recall, precision)
    assert exact >= HELD_OUT_EXACT_SHARE * n, (exact, n)
    return {k: launches[k] for k in STREAM_PAIR}


def vendored_held_out(tmp: Path, card):
    """Phase 11c: the vendored ccs and ilmn models on their held-out
    genomes (seed 424242, 30 kb) and the production model on its 40 kb
    held-out flowcell (seed 626262), called on the card at batch 256, as
    tests/test_trained_model_e2e.py calls them, with its floors."""
    from clair_tpu_torch.examples.simulated import (
        call_and_score, simulate_flowcell, simulate_genome,
    )
    from clair_tpu_torch.models.checkpoint import load_checkpoint
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.utils.simulate import PLATFORM_RECIPES

    runs = [(f"{p}_synthetic", (HELD_OUT_RECALL, HELD_OUT_PRECISION, HELD_OUT_EXACT_SHARE),
             lambda d, p=p: simulate_genome(d, PLATFORM_RECIPES[p], 424242, 30_000, 120))
            for p in ("ccs", "ilmn")]
    runs.append(("ont_production", (PRODUCTION_RECALL, PRODUCTION_PRECISION,
                                    PRODUCTION_EXACT_SHARE),
                 lambda d: simulate_flowcell(d, 626262, 40, "ont", 35)))
    launched = {}
    for name, (recall_floor, precision_floor, exact_share), simulate in runs:
        params, _ = load_checkpoint(str(ROOT / "examples" / f"{name}.ckpt"))
        work = tmp / name
        work.mkdir()
        started = time.perf_counter()
        fasta, bam, variants = simulate(str(work))
        simulated = time.perf_counter() - started
        with recipe_run():
            started = time.perf_counter()
            recall, precision, exact, n = call_and_score(
                bam, fasta, variants, params, ModelConfig(), batch_size=256, device="cuda")
            wall = time.perf_counter() - started
            launches = kernel_counts()
        print(f"  {name}.ckpt on its held-out genome: recall {recall:.4f}, precision "
              f"{precision:.4f}, exact {exact}/{n}; kernel launches {launches}; simulate "
              f"{simulated:.2f} s, call {wall:.2f} s on {card}")
        assert launches["bilstm_stream"] > 0, launches
        assert recall >= recall_floor and precision >= precision_floor, (name, recall, precision)
        assert exact >= exact_share * n, (name, exact, n)
        launched[name] = {k: launches[k] for k in STREAM_PAIR}
    return launched


def main():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} device(s)")
    # the plain versions are the yardstick: keep their float32 products in
    # full float32 (no TF32) on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul False, cudnn False")
    phase("1 card", t0)

    t = time.perf_counter()
    build_all()
    phase("2 build", t)

    t = time.perf_counter()
    max_err = {"bilstm_stream": check_kernel(dev)}
    phase("3 forward kernel vs plain", t)

    t = time.perf_counter()
    max_err.update(check_train_pair(dev))
    phase("3b train pair vs plain", t)

    t = time.perf_counter()
    max_err["bilstm_precomputed"] = check_precomputed(dev)
    phase("3c precomputed forward vs plain", t)

    t = time.perf_counter()
    max_err["bilstm2"] = check_bilstm2(dev)
    phase("3d bilstm2 vs plain", t)

    t = time.perf_counter()
    max_err["bilstm_stream_backward"] = check_backward_kernel(dev)
    phase("4 backward kernel vs plain", t)

    t = time.perf_counter()
    check_recipe_poisoned(dev)
    phase("4b poisoned memory and repeated launches at the recipes' geometries", t)

    t = time.perf_counter()
    params = check_forward(dev)
    phase("5 full-width forward", t)

    t = time.perf_counter()
    check_train_step(params)
    phase("6 full-width train step", t)

    t = time.perf_counter()
    check_train_step(params, TRAIN_PAIR, use_pallas_train_bilstm=True)
    phase("6b full-width train step, use_pallas_train_bilstm", t)

    t = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    # the genome of phases 7 to 8c
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as genome_dir:
        tmp = Path(genome_dir)
        fasta, bam, truth, variants = simulate_genome(tmp)
        print(f"  simulated {GENOME_LENGTH // 1000} kb ONT genome, {len(truth)} planted variants: "
              f"{time.perf_counter() - t:.2f} s")
        runs = {}
        for dtype, flags in (("bfloat16", []), ("float32", ["--dtype", "float32"])):
            rows, launches, wall, sites = call_bam(fasta, bam, str(tmp / f"{dtype}.vcf"), flags)
            recall, precision = score(rows, truth)
            print(f"  call_bam {dtype}: {len(rows)} calls, recall {recall:.4f}, precision "
                  f"{precision:.4f}, kernel launches {launches}, wall {wall:.2f} s; {sites}")
            assert recall >= RECALL_FLOOR and precision >= PRECISION_FLOOR, (recall, precision)
            assert launches["bilstm_stream"] > 0, launches
            runs[dtype] = (rows, launches, wall, sites)
        assert decisions(runs["bfloat16"][0]) == decisions(runs["float32"][0]), \
            "bf16 and f32 decisions differ"
        print("  bfloat16 and float32 decisions (CHROM, POS, REF, ALT, GT) identical")
        phase("7 calling path", t)

        t = time.perf_counter()
        precomputed_runs = {}
        for dtype in ("bfloat16", "float32"):
            rows, launches, wall, sites = call_bam_precomputed(
                fasta, bam, str(tmp / f"precomputed_{dtype}.vcf"), dtype)
            recall, precision = score(rows, truth)
            print(f"  call_bam use_pallas_bilstm {dtype}: {len(rows)} calls, recall "
                  f"{recall:.4f}, precision {precision:.4f}, kernel launches {launches}, "
                  f"wall {wall:.2f} s; {sites}")
            assert recall >= RECALL_FLOOR and precision >= PRECISION_FLOOR, (recall, precision)
            assert launches["bilstm_precomputed"] > 0 and launches["bilstm_stream"] == 0, launches
            precomputed_runs[dtype] = (rows, launches, wall, sites)
        streaming = decisions(runs["float32"][0])
        assert decisions(precomputed_runs["float32"][0]) == streaming, \
            "use_pallas_bilstm f32 decisions differ from the streaming f32 run"
        print("  use_pallas_bilstm float32 decisions identical to the streaming float32 run")
        differ = sorted(set(decisions(precomputed_runs["bfloat16"][0])) ^ set(streaming))
        print(f"  use_pallas_bilstm bfloat16 vs streaming float32: {len(differ)} decisions "
              f"differ {differ}")
        phase("7b calling path, use_pallas_bilstm", t)

        t = time.perf_counter()
        process_pool(fasta, bam, truth, tmp, card)
        phase("7c call_bam_parallel --process_pool", t)

        t = time.perf_counter()
        trains = {}
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as bin_dir:
            bin_fn = Path(bin_dir) / "train.bin"
            write_training_bin(bin_fn)
            for dtype, flags in (("bfloat16", []), ("float32", ["--train_compute_dtype", "float32"])):
                prefix = Path(bin_dir) / f"model_{dtype}"
                report, wall, top, epochs = train(prefix, lambda: run_port(
                    ["train", "--bin_fn", str(bin_fn), "--ochk_prefix", str(prefix),
                     "--maxEpoch", str(TRAIN_EPOCHS), *flags], 600))
                print(f"  train {dtype}: validation loss sums {report['validation_losses']}, "
                      f"training loss sums {report['training_losses']}, best epoch "
                      f"{report['best_epoch']}, kernel launches {report['kernel_launches']}, "
                      f"wall {wall:.2f} s (process start to exit); {top}; {epochs}")
                trains[dtype] = (report, wall)
            phase("8 training path", t)

            t = time.perf_counter()
            prefix = Path(bin_dir) / "model_train_pair"
            report, wall, top, epochs = train(prefix, lambda: run_process(
                ["-c", TRAIN_SCRIPT, str(bin_fn), str(prefix), str(TRAIN_EPOCHS)], 600),
                TRAIN_PAIR)
            print(f"  train_model use_pallas_train_bilstm float32: validation loss sums "
                  f"{report['validation_losses']}, training loss sums "
                  f"{report['training_losses']}, best epoch {report['best_epoch']}, kernel "
                  f"launches {report['kernel_launches']}, wall {wall:.2f} s (process start to "
                  f"exit); {top}; {epochs}")
            trains["float32, use_pallas_train_bilstm"] = (report, wall)
            phase("8b training path, use_pallas_train_bilstm", t)

            t = time.perf_counter()
            (tmp / "chain").mkdir()
            training_data_path(fasta, bam, variants, tmp / "chain", card)
            phase("8c BAM + truth VCF -> bin -> model -> VCF, the port's CLI", t)

            t = time.perf_counter()
            new_paths = {"activations": activations(params, dev, tmp, card)}
            phase("10a forward_activations and call_var --activation_only", t)

            t = time.perf_counter()
            new_paths["learning_rate_finder"] = lr_finder(bin_fn, tmp, card)
            phase("10b learning_rate_finder", t)

            t = time.perf_counter()
            new_paths["train --profile_dir"], step_split = profiled_train(bin_fn, tmp, card)
            phase("10c train --profile_dir", t)

            t = time.perf_counter()
            new_paths["DDP, two gloo ranks"] = data_parallel(bin_fn, card)
            phase("10d data-parallel training on one card", t)

            t = time.perf_counter()
            new_paths["ShardedPredictor"] = sharded_calling(fasta, bam, tmp,
                                                            runs["bfloat16"][0], card)
            phase("10e call_bam through ShardedPredictor", t)

            t = time.perf_counter()
            new_paths["model axis, (1, 2) gloo ranks"] = model_parallel(bin_fn, card)
            phase("10f the model axis on one card", t)

            t = time.perf_counter()
            new_paths["train --no_stream_bilstm"] = scan_bilstm(params, bin_fn, dev, trains, card)
            phase("10g the scan BiLSTM", t)

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as recipe_dir:
        tmp = Path(recipe_dir)
        t = time.perf_counter()
        recipe_paths = {"demo --quick --profile ont": recipe_demo(tmp, card)}
        phase("11a demo --quick --profile ont", t)

        t = time.perf_counter()
        recipe_paths["train_synthetic --profile ont float32"] = recipe_synthetic(tmp, card)
        phase("11b train_synthetic, full width, float32, and its held-out genome", t)

        t = time.perf_counter()
        recipe_paths.update(vendored_held_out(tmp, card))
        phase("11c the vendored ccs, ilmn and production models on held-out genomes", t)

    t = time.perf_counter()
    from clair_tpu_torch.models.bilstm import bilstm_with_cell
    from clair_tpu_torch.models.clair import ClairNet
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.ops.bilstm_stream import (
        _forward, _stack_params, _unstacked, bilstm_stream, bilstm_stream_backward,
        bilstm_stream_backward_reference, bilstm_stream_reference,
    )
    from clair_tpu_torch.pipeline.call_var import _device_input

    print(f"times on {card} (CUDA events, mean of 20 after warm-up; B=10000: mean of 5):")
    ms = {k: 0.0 for k in KERNELS}
    plain_ms = dict(ms)
    row1_f32 = {}  # (layer, batch): (kernel ms, plain ms) of row 1's float32 mode
    row2_f32_ms = {}  # layer: (kernel ms, plain ms) of row 2's float32 mode, B = 10,000
    for layer, feat in (("lstm1", 32), ("lstm2", 256)):
        rs = np.random.RandomState(feat)
        p = lstm_params(rs, feat, 128, dev)
        x = torch.tensor(rs.randn(512, 33, feat), dtype=torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            # the kernel's launch on stacked parameters (the wrapper also
            # stacks and casts them per call, by three torch ops)
            xd, stacked = x.to(dtype), _stack_params(p, dtype)
            k = cuda_ms(lambda: _forward(xd, *stacked, with_cell=False))
            pl = cuda_ms(lambda: bilstm_stream_reference(p, xd))
            wrapped = cuda_ms(lambda: bilstm_stream(p, xd))
            print(f"  forward {layer} B=512 {str(dtype)[6:]}: kernel {k:.4f} ms, plain {pl:.4f} ms, "
                  f"through the wrapper {wrapped:.4f} ms" + (
                      f"; the float32 FMA kernel before the sweep took "
                      f"{ROW1_F32_FMA_MS[(layer, 512)]:.4f} ms" if dtype == torch.float32 else ""))
            if dtype == torch.bfloat16:
                ms["bilstm_stream"] += k
                plain_ms["bilstm_stream"] += pl
            else:
                row1_f32[(layer, 512)] = (k, pl)
        # the training forward: B = 10,000, the float32 c saved for the backward
        xt = torch.tensor(rs.randn(TRAIN_BATCH, 33, feat), dtype=torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd, stacked = xt.to(dtype), _stack_params(p, dtype)
            k = cuda_ms(lambda: _forward(xd, *stacked, with_cell=True), 5)
            pl = cuda_ms(lambda: bilstm_stream_reference(p, xd), 5)
            print(f"  forward {layer} B={TRAIN_BATCH} {str(dtype)[6:]} (with c): kernel {k:.4f} ms, "
                  f"plain {pl:.4f} ms" + (
                      f"; the float32 FMA kernel before the sweep took "
                      f"{ROW1_F32_FMA_MS[(layer, TRAIN_BATCH)]:.4f} ms"
                      if dtype == torch.float32 else ""))
            if dtype == torch.float32:
                row1_f32[(layer, TRAIN_BATCH)] = (k, pl)
        for batch in (512, 10_000):
            iters = 20 if batch == 512 else 5
            xb = torch.tensor(rs.randn(batch, 33, feat), dtype=torch.float32, device=dev)
            dh32 = torch.tensor(rs.randn(batch, 33, 256), dtype=torch.float32, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                w, u, bias = _stack_params(p, dtype)
                xd, dh = xb.to(dtype), dh32.to(dtype)
                h_out, c_out = bilstm_with_cell(_unstacked(w, u, bias), xd)
                need_dx = layer == "lstm2"  # lstm1's input takes no gradient
                k = cuda_ms(lambda: bilstm_stream_backward(
                    xd, w, u, bias, h_out, c_out, dh, need_dx=need_dx), iters)
                pl = cuda_ms(lambda: bilstm_stream_backward_reference(
                    xd, w, u, bias, h_out, c_out, dh, need_dx=need_dx), iters)
                print(f"  backward {layer} B={batch} {str(dtype)[6:]}: kernel {k:.4f} ms, "
                      f"plain {pl:.4f} ms")
                if batch == 10_000 and dtype == torch.bfloat16:
                    ms["bilstm_stream_backward"] += k
                    plain_ms["bilstm_stream_backward"] += pl
                elif batch == 10_000:
                    row2_f32_ms[layer] = (k, pl)
    xu = torch.from_numpy(np.random.RandomState(8).randint(0, 40, (512, 33, 8, 4)).astype(np.uint8)).to(dev)
    for dtype in ("float32", "bfloat16"):
        for kernel, flags in (("streaming", {}), ("use_pallas_bilstm", {"use_pallas_bilstm": True})):
            model = ClairNet.from_jax(params, ModelConfig(compute_dtype=dtype, **flags), dev)
            with torch.inference_mode():
                fwd = cuda_ms(lambda: model(_device_input(xu)))
            print(f"  forward B=512 {dtype} {kernel}: {fwd:.4f} ms, {512 / fwd * 1e3:.0f} tensors/s")
    for dtype in ("bfloat16", "float32"):
        step_ms, rate, peak = step_times(full_width_step(params, dev, dtype))
        print(f"  train step B=10000 {dtype}: {step_ms:.2f} ms, {rate:.0f} samples/s, peak "
              f"{peak / 2 ** 30:.2f} GiB (host clock, mean of 5 synchronized steps; the peak "
              f"above what was allocated before them)")
    for dtype, (rows, _, wall, sites) in runs.items():
        print(f"  call_bam {dtype}: wall {wall:.2f} s (process start to exit), "
              f"{len(rows)} VCF rows; {sites}")
    for dtype, (_, wall) in trains.items():
        print(f"  train {dtype}: wall {wall:.2f} s (process start to exit), "
              f"{TRAIN_EPOCHS} epochs of {TRAIN_ROWS} rows")
    phase("9 times", t)

    t = time.perf_counter()
    print(f"rows 2, 6, 5 and 1 (float32) by kernel on {card} (torch.profiler, mean of 5 calls "
          f"after a warm-up):")
    splits = {2: backward_split(dev), 6: backward_split(dev, pair=TRAIN_PAIR)}
    for row, split in splits.items():
        for layer, _ in LAYERS:
            print(f"  row {row} float32 {layer} B={TRAIN_BATCH}: the reverse cluster sweep "
                  f"{split[(layer, 'float32')]['sweep']:.4f} ms; the float32 FMA sweep before "
                  f"it {FMA_SWEEP_MS[(row, layer)]:.3f} ms")
    forward_split(dev)
    phase("9a the backwards' and the float32 forwards' split", t)

    t = time.perf_counter()
    new_kernel_times(params, dev, ms, plain_ms)
    phase("9b times of the new kernels", t)

    t = time.perf_counter()
    library_launches = bilstm2_library_call(params, dev)
    phase("9c bilstm2 as a library call", t)

    t = time.perf_counter()
    print(f"bounds and library calls on {card}:")
    bounds, library, f32_mode, row2_f32 = yardsticks(dev)
    phase("9d bounds and library calls", t)

    t = time.perf_counter()
    conv_records, conv_launches = conv3x3_checks(dev, card)
    phase("9e conv3x3 at Clair3_F's training batch", t)

    assert "jax" not in sys.modules
    print(f"launches on the phase-10 paths (each run's, rows 1 and 2 only): "
          f"{json.dumps({k: {r: v[r] for r in STREAM_PAIR} for k, v in new_paths.items()})}")
    print(f"launches on the phase-11 paths (each run's, rows 1 and 2 only): "
          f"{json.dumps(recipe_paths)}")
    print(f"card: {card}")
    # each kernel's launches in the run of the path that carries it
    launches = {**{k: trains["bfloat16"][0]["kernel_launches"][k] for k in STREAM_PAIR},
                **{k: trains["float32, use_pallas_train_bilstm"][0]["kernel_launches"][k] for k in TRAIN_PAIR},
                "bilstm_precomputed": precomputed_runs["bfloat16"][1]["bilstm_precomputed"],
                "bilstm2": library_launches}
    # row 1's float32 mode beside its bf16 numbers: both layers per batch,
    # its launches in the float32 call_bam run (B = 512) and the float32
    # train run (B = 10,000)
    f32_launches = {CALL_BATCH: runs["float32"][1]["bilstm_stream"],
                    TRAIN_BATCH: trains["float32"][0]["kernel_launches"]["bilstm_stream"]}
    for batch in (CALL_BATCH, TRAIN_BATCH):
        f32_mode[f"B={batch}"].update(
            launches=f32_launches[batch],
            ms=sum(row1_f32[(layer, batch)][0] for layer, _ in LAYERS),
            plain_ms=sum(row1_f32[(layer, batch)][1] for layer, _ in LAYERS),
            **{f"{layer}_ms": row1_f32[(layer, batch)][0] for layer, _ in LAYERS})
    # row 2's float32 mode: both layers at B = 10,000, its launches in the
    # float32 train run
    row2_f32[f"B={TRAIN_BATCH}"].update(
        launches=trains["float32"][0]["kernel_launches"]["bilstm_stream_backward"],
        ms=sum(k for k, _ in row2_f32_ms.values()),
        plain_ms=sum(pl for _, pl in row2_f32_ms.values()),
        **{f"{layer}_ms": row2_f32_ms[layer][0] for layer, _ in LAYERS})
    float32_modes = {"bilstm_stream": f32_mode, "bilstm_stream_backward": row2_f32}
    print(json.dumps({"kernels": [dict(
        KERNELS[k], launches=launches[k], max_abs_err=max_err[k], ms=ms[k],
        plain_ms=plain_ms[k], bound_ms=bounds[k][0], bound_by=bounds[k][1],
        library_ms=library[k], **({"float32": float32_modes[k]} if k in float32_modes else {}))
        for k in KERNELS]}))
    print(json.dumps({"conv3x3": conv_records, "conv3x3_train_step_launches": conv_launches}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
