"""Hyperparameter registry — single source of truth for tensor geometry and
training constants.

Mirrors the behavioural contract of the reference registry
(reference shared/param.py:1-56): the 33x8x4 input geometry, batch
sizes, LR schedule and CLR constants must be identical for data prep, model
training and variant calling to interoperate.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Tensor geometry (must match across data prep / training / calling)
# ---------------------------------------------------------------------------
FLANKING_BASE_NUM = 16
NO_OF_POSITIONS = 2 * FLANKING_BASE_NUM + 1        # 33
MATRIX_ROW = 8                                      # ACGT x strand
MATRIX_NUM = 4                                      # channels: ref/ins/del/SNP
INPUT_SHAPE = (NO_OF_POSITIONS, MATRIX_ROW, MATRIX_NUM)
INPUT_TENSOR_SIZE = NO_OF_POSITIONS * MATRIX_ROW * MATRIX_NUM  # 1056

# Expanded reference fetch around a region (bp), ref param.py:5
EXPAND_REFERENCE_REGION = 1_000_000

# BAM record filter: UNMAP|SECONDARY|QCFAIL|DUP|SUPPLEMENTARY (2316),
# ref param.py:6
BAM_EXCLUDE_FLAG = 2316

# ---------------------------------------------------------------------------
# Batch sizes and LR schedule (ref param.py:15-27)
# ---------------------------------------------------------------------------
TRAIN_BATCH_SIZE = 10_000
# The reference predicts at batch 1000 (param.py:16). On a v5e chip the
# fully unrolled BiLSTM holds its working set in VMEM up to ~batch 640 and
# spills beyond it — batch 512 measured ~2x the tensors/sec of batch 1000
# (0.35 vs 1.38 ms/batch). Batch size does not change outputs, only speed.
PREDICT_BATCH_SIZE = 512
# compute dtype the CALLING pipelines build their predictors with when the
# user passes no --dtype. bfloat16: measured 1.97M tensors/s (streaming
# Pallas kernel, auto-picked by Predictor on TPU) vs 1.34M f32 at batch
# 512 under the stable in-jit protocol (v5e), and decode DECISIONS (site,
# alleles, genotype) are guarded identical to f32 on confident outputs
# (tests/test_bf16.py, incl. the demo-trained model end to end).
# `--dtype float32` is the exact-probability escape hatch (e.g. when
# diffing QUAL against a converted reference checkpoint).
# ModelConfig.compute_dtype itself stays float32: raw model/convert/audit
# contexts default to exact parity.
PREDICT_COMPUTE_DTYPE = "bfloat16"
INITIAL_LEARNING_RATE = 1e-3
LEARNING_RATE_DECAY = 0.1
MAX_LEARNING_RATE_SWITCH = 3
TRAINING_DATASET_PERCENTAGE = 0.9

L2_REGULARIZATION_LAMBDA = 0.005
L2_REGULARIZATION_LAMBDA_DECAY = 1.0

DEFAULT_OPTIMIZER = "Adam"            # Adam / SGDM
DEFAULT_LOSS_FUNCTION = "FocalLoss"   # CrossEntropy / FocalLoss

# Cyclical learning rate (ref param.py:32-37)
CLR_MAX_LR = 3e-2
CLR_MIN_LR = 1e-4
CLR_STEPSIZE_CONSTANT = 1
CLR_GAMMA = 0.95
MOMENTUM = 0.9
MAX_EPOCH = 30

# LR finder (ref param.py:40-42)
LR_FINDER_MIN_LR = 1e-6
LR_FINDER_MAX_LR = 1e-1
LR_FINDER_MAX_EPOCH = 1

# Gradient clipping for recurrent structures (ref model.py:727)
GRADIENT_CLIP_NORM = 5.0

# Training-bin block size (ref param.py:12); our bins use zstd, not blosc
BIN_BLOCK_SIZE = 500

# Default candidate-site thresholds (ref ExtractVariantCandidates.py:424-431)
MIN_CANDIDATE_AF = 0.125
MIN_CANDIDATE_COVERAGE = 4
MAX_DEPTH_PER_POSITION = 250          # --dcov

# Random seed: None -> nondeterministic per run (ref param.py:44-48)
RANDOM_SEED = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Structural hyperparameters of the multi-task BiLSTM network.

    Defaults replicate the reference "2BiLSTM" structure
    (reference clair/model.py:61-105).
    """

    input_shape: tuple = INPUT_SHAPE
    lstm1_num_units: int = 128
    lstm2_num_units: int = 128
    lstm1_dropout_rate: float = 0.0
    lstm2_dropout_rate: float = 0.5
    # L3 "slice dense": an independent dense(time 33 -> 30) per feature column
    l3_num_units: int = 30
    l4_num_units: int = 192
    l4_dropout_rate: float = 0.5
    l5_num_units: int = 96
    l5_dropout_rate: float = 0.2
    output_gt21_shape: int = 21
    output_genotype_shape: int = 3
    output_indel_length_shape_1: int = 33
    output_indel_length_shape_2: int = 33
    # task loss weights: gt21, genotype, len1, len2, l2 (ref model.py:64-70)
    task_loss_weights: tuple = (1.0, 1.0, 1.0, 1.0, 1.0)
    l2_regularization_lambda: float = L2_REGULARIZATION_LAMBDA
    optimizer_name: str = DEFAULT_OPTIMIZER
    loss_function: str = DEFAULT_LOSS_FUNCTION
    # compute dtype for matmuls; params are kept in float32 (casts happen
    # at use). float32 here = exact probability parity with converted
    # reference checkpoints, the right default for raw model / convert /
    # audit contexts. Under the r04 stable protocol (hoisted step form,
    # batch 512) bf16 measures 1.51M vs 1.34M tensors/s, so the CALLING
    # pipelines default to bfloat16 via PREDICT_COMPUTE_DTYPE (decode
    # decisions guarded f32-identical, tests/test_bf16.py); training
    # defaults to bf16 via TrainingConfig.train_compute_dtype.
    compute_dtype: str = "float32"
    # use the fused Pallas BiLSTM kernel (TPU backends only; the lax.scan
    # path is used automatically elsewhere)
    use_pallas_bilstm: bool = False
    # use the fused-VMEM Pallas forward+backward BiLSTM for TRAINING
    # (ops/pallas_bilstm_train.py): keeps each batch tile's recurrence in
    # VMEM across all 33 steps instead of streaming per-step gate tensors
    # through HBM. f32 only; TPU backends only.
    use_pallas_train_bilstm: bool = False
    # use the streaming-grid Pallas forward+backward BiLSTM
    # (ops/pallas_bilstm_stream.py): time is a grid dimension, only the
    # (tile, H) h/c carry persists in VMEM, per-step blocks stream from
    # HBM and the backward recomputes gates. Unlike the fused-VMEM kernel
    # it has no batch-tile cap (512-row tiles, full MXU) and supports
    # bf16 compute. Measured 2x over the lax.scan at train batch 10k and
    # 1.3x at predict batch 512 bf16; train_model and the single-device
    # Predictor auto-enable it on TPU (pjit paths keep the scan — a
    # pallas_call is opaque to the partitioner). TPU only.
    use_pallas_stream_bilstm: bool = False

    @property
    def no_of_positions(self) -> int:
        return self.input_shape[0]

    @property
    def feature_dim(self) -> int:
        return self.input_shape[1] * self.input_shape[2]

    @property
    def output_shape(self) -> int:
        return (
            self.output_gt21_shape
            + self.output_genotype_shape
            + self.output_indel_length_shape_1
            + self.output_indel_length_shape_2
        )
