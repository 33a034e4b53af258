"""Model evaluation: per-head confusion matrices, F1, gt21 top-1/top-2
(port of clair_tpu/pipeline/evaluate.py).

Only the forward differs (ClairNet on a torch device, batches of
``batch_size``); the metrics are the JAX package's numpy, copied because
that module imports JAX, including the order-normalized indel-length pair.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from clair_tpu.params import PREDICT_BATCH_SIZE, ModelConfig
from clair_tpu.task.labels import split_label_vector
from clair_tpu_torch.data.bins import BinDataset
from clair_tpu_torch.models.clair import ClairNet

logger = logging.getLogger(__name__)


def f1_scores(confusion_matrix: np.ndarray) -> np.ndarray:
    column_sum = confusion_matrix.sum(axis=0)
    row_sum = confusion_matrix.sum(axis=1)
    tp = np.diag(confusion_matrix).astype(np.float64)
    epsilon = 1e-15
    precision = tp / (column_sum + epsilon)
    recall = tp / (row_sum + epsilon)
    return (2.0 * precision * recall) / (precision + recall + epsilon)


@dataclass
class EvaluationResult:
    confusion_gt21: np.ndarray
    confusion_genotype: np.ndarray
    confusion_length_1: np.ndarray
    confusion_length_2: np.ndarray
    gt21_top1: float = 0.0
    gt21_top2: float = 0.0
    f1: Dict[str, np.ndarray] = field(default_factory=dict)


def _bincount2d(true_idx: np.ndarray, pred_idx: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(true_idx * n + pred_idx, minlength=n * n).reshape(n, n)


def evaluate_model(
    params: dict,
    model_config: ModelConfig,
    dataset: BinDataset,
    batch_size: int = PREDICT_BATCH_SIZE,
    print_report: bool = True,
    device: str = "cuda",
) -> EvaluationResult:
    """Score the parameter tree ``params`` on every block of ``dataset``."""
    model = ClairNet.from_jax(params, model_config, torch.device(device))
    start = time.time()

    cm_gt21 = np.zeros((21, 21), dtype=np.int64)
    cm_geno = np.zeros((3, 3), dtype=np.int64)
    cm_len1 = np.zeros((33, 33), dtype=np.int64)
    cm_len2 = np.zeros((33, 33), dtype=np.int64)
    n_total = top1 = top2 = 0

    for block_index in range(dataset.n_blocks):
        x = dataset.x_block(block_index)
        y = dataset.y_block(block_index)
        for off in range(0, len(x), batch_size):
            xb, yb = x[off:off + batch_size], y[off:off + batch_size]
            with torch.inference_mode():
                probs = model(torch.from_numpy(np.ascontiguousarray(xb)).to(device))
            gt21_p, geno_p, vl1_p, vl2_p = (p.cpu().numpy() for p in probs)
            y_gt21, y_geno, y_vl1, y_vl2 = split_label_vector(yb)

            t_gt21 = y_gt21.argmax(-1)
            p_sorted = np.argsort(gt21_p, axis=-1)
            n_total += len(xb)
            top1_hit = p_sorted[:, -1] == t_gt21
            top2_hit = top1_hit | (p_sorted[:, -2] == t_gt21)
            top1 += int(top1_hit.sum())
            top2 += int(top2_hit.sum())
            cm_gt21 += _bincount2d(t_gt21, gt21_p.argmax(-1), 21)
            cm_geno += _bincount2d(y_geno.argmax(-1), geno_p.argmax(-1), 3)

            # order-normalize (true, pred) indel-length pairs
            t1, t2 = y_vl1.argmax(-1), y_vl2.argmax(-1)
            p1, p2 = vl1_p.argmax(-1), vl2_p.argmax(-1)
            cm_len1 += _bincount2d(np.minimum(t1, t2), np.minimum(p1, p2), 33)
            cm_len2 += _bincount2d(np.maximum(t1, t2), np.maximum(p1, p2), 33)

    result = EvaluationResult(
        confusion_gt21=cm_gt21,
        confusion_genotype=cm_geno,
        confusion_length_1=cm_len1,
        confusion_length_2=cm_len2,
        gt21_top1=top1 / max(n_total, 1),
        gt21_top2=top2 / max(n_total, 1),
        f1={
            "gt21": f1_scores(cm_gt21),
            "genotype": f1_scores(cm_geno),
            "indel_length_1": f1_scores(cm_len1),
            "indel_length_2": f1_scores(cm_len2),
        },
    )

    if print_report:
        logger.info("[INFO] Prediction time elapsed: %.2f s", time.time() - start)
        logger.info(
            "[INFO] gt21 all/top1/top2: %d/%.2f%%/%.2f%%",
            n_total, 100 * result.gt21_top1, 100 * result.gt21_top2,
        )
        for name, cm in (
            ("gt21", cm_gt21), ("Genotype", cm_geno),
            ("indel length 1", cm_len1), ("indel length 2", cm_len2),
        ):
            logger.info("[INFO] Evaluation on %s:", name)
            for row in cm:
                logger.info("\t".join(str(v) for v in row))
            logger.info("[INFO] f-measure: %s", f1_scores(cm))

    return result
