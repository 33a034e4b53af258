"""Strict structural audit of TF1 checkpoint variables before conversion.

The published reference checkpoints (ont 122HD34 / pacbio ccs 15 /
illumina 12345, reference README.md:96-108) were written by real
TensorFlow 1.x — this repo's converter chain (io/tfckpt.py +
models/convert_tf1.py) was built from reading the reference's graph
construction (reference clair/model.py:237-303, 464-620), so the
first contact with real bytes must FAIL LOUD on any drift: a missing
scope, an extra trainable variable, or a shape mismatch each mean the
graph differed from what the converter assumes, and a silent partial
conversion would produce wrong probabilities with no error.

``expected_manifest`` is the machine-readable contract: every trainable
variable name and shape the reference graph creates, per checkpoint
layout.  ``audit_tf1_vars`` diffs a real variable dict against it.

Known-extra variables that tf.train.Saver persists but conversion ignores
(optimizer slots, step counters) are classified as *ignored*, not
unexpected: the reference saves with a default Saver over the whole graph
(reference clair/model.py:712), so Adam creates ``<var>/Adam`` +
``<var>/Adam_1`` slots plus ``beta1_power``/``beta2_power``
(tf.train.AdamOptimizer slot naming), and SGDM creates ``<var>/Momentum``
(ref model.py:714-738).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from clair_tpu_torch.params import ModelConfig

LAYOUT_COMPATIBLE = "compatible"   # CPU path: CudnnCompatibleLSTMCell vars
LAYOUT_CUDNN = "cudnn"             # GPU path: CudnnLSTM opaque blobs

# Saver-persisted, conversion-irrelevant variable classes.
_IGNORED_SUFFIXES = ("/Adam", "/Adam_1", "/Momentum")
_IGNORED_NAMES = frozenset({
    "beta1_power", "beta2_power", "global_step", "learning_rate",
    # slot-variable spellings seen across TF1 minor versions
    "Adam/beta1_power", "Adam/beta2_power",
})


def _is_ignored(name: str) -> bool:
    if name in _IGNORED_NAMES:
        return True
    return any(name.endswith(s) for s in _IGNORED_SUFFIXES)


def expected_manifest(
    config: ModelConfig = ModelConfig(), layout: str = LAYOUT_COMPATIBLE
) -> Dict[str, Tuple[int, ...]]:
    """Expected trainable variable name -> shape for one checkpoint layout.

    Shapes follow the reference graph:
    - CudnnCompatibleLSTMCell kernel is ((input+hidden), 4*hidden), bias
      (4*hidden,) (TF BasicLSTMCell layout; ref model.py:266-325).
    - The CudnnLSTM opaque blob is a flat float vector holding both
      directions' 8 matrices + 16 bias vectors (ref model.py:281-296);
      TF saves it as a 1-D opaque_kernel of that length.
    - L3 slice-dense: one (positions, l3_units) kernel per feature column
      (2*lstm2_units columns; ref model.py:226-244, 464-472).
    - L4 flattens l3's (positions-collapsed) output: in = l3_units *
       2*lstm2_units (ref model.py:474-502).
    """
    positions = config.input_shape[0]
    feat = config.feature_dim
    h1, h2 = config.lstm1_num_units, config.lstm2_num_units
    out: Dict[str, Tuple[int, ...]] = {}

    def lstm(scope: str, input_dim: int, hidden: int) -> None:
        if layout == LAYOUT_CUDNN:
            n = 2 * (4 * hidden * input_dim + 4 * hidden * hidden) + 2 * 8 * hidden
            out[f"{scope}/cudnn_lstm/opaque_kernel"] = (n,)
            return
        base = f"{scope}/stack_bidirectional_rnn/cell_0/bidirectional_rnn"
        for d in ("fw", "bw"):
            out[f"{base}/{d}/cudnn_compatible_lstm_cell/kernel"] = (
                input_dim + hidden, 4 * hidden,
            )
            out[f"{base}/{d}/cudnn_compatible_lstm_cell/bias"] = (4 * hidden,)

    lstm("LSTM1", feat, h1)
    lstm("LSTM2", 2 * h1, h2)
    for i in range(2 * h2):
        out[f"L3/Unit_{i}/kernel"] = (positions, config.l3_num_units)
        out[f"L3/Unit_{i}/bias"] = (config.l3_num_units,)
    l4_in = config.l3_num_units * 2 * h2
    dense_shapes = [
        ("L4", l4_in, config.l4_num_units),
        ("L5_1", config.l4_num_units, config.l5_num_units),
        ("L5_2", config.l4_num_units, config.l5_num_units),
        ("L5_3", config.l4_num_units, config.l5_num_units),
        ("L5_4", config.l4_num_units, config.l5_num_units),
        ("Prediction/Y_base_change_logits", config.l5_num_units,
         config.output_gt21_shape),
        ("Prediction/Y_genotype_logits", config.l5_num_units,
         config.output_genotype_shape),
        ("Prediction/Y_indel_length_logits_1", config.l5_num_units,
         config.output_indel_length_shape_1),
        ("Prediction/Y_indel_length_logits_2", config.l5_num_units,
         config.output_indel_length_shape_2),
    ]
    for scope, n_in, n_out in dense_shapes:
        out[f"{scope}/kernel"] = (n_in, n_out)
        out[f"{scope}/bias"] = (n_out,)
    return out


def detect_layout(tf_vars: Dict[str, np.ndarray]) -> str:
    if any(k.endswith("/cudnn_lstm/opaque_kernel") for k in tf_vars):
        return LAYOUT_CUDNN
    return LAYOUT_COMPATIBLE


@dataclass
class AuditReport:
    layout: str
    missing: List[str] = field(default_factory=list)
    unexpected: List[str] = field(default_factory=list)
    mismatched: List[Tuple[str, Tuple[int, ...], Tuple[int, ...]]] = (
        field(default_factory=list)
    )
    ignored: List[str] = field(default_factory=list)
    matched: int = 0

    @property
    def ok(self) -> bool:
        return not (self.missing or self.unexpected or self.mismatched)

    def render(self) -> str:
        lines = [
            f"layout: {self.layout}",
            f"matched: {self.matched} variables",
            f"ignored (optimizer/bookkeeping): {len(self.ignored)}",
        ]
        for name in self.missing:
            lines.append(f"MISSING   {name}")
        for name in self.unexpected:
            lines.append(f"UNEXPECTED {name}")
        for name, want, got in self.mismatched:
            lines.append(f"SHAPE     {name}: expected {want}, got {got}")
        lines.append("audit: " + ("OK" if self.ok else "FAILED"))
        return "\n".join(lines)


def audit_tf1_vars(
    tf_vars: Dict[str, np.ndarray], config: ModelConfig = ModelConfig()
) -> AuditReport:
    """Diff a real checkpoint's variables against the expected manifest."""
    layout = detect_layout(tf_vars)
    manifest = expected_manifest(config, layout)
    report = AuditReport(layout=layout)
    for name, want in sorted(manifest.items()):
        if name not in tf_vars:
            report.missing.append(name)
            continue
        got = tuple(np.asarray(tf_vars[name]).shape)
        if got != tuple(want):
            report.mismatched.append((name, tuple(want), got))
        else:
            report.matched += 1
    for name in sorted(tf_vars):
        if name in manifest:
            continue
        if _is_ignored(name):
            report.ignored.append(name)
        else:
            report.unexpected.append(name)
    return report
