"""Indel length task: 33 classes covering lengths -16..+16.

Negative = deletion, positive = insertion, 0 = no length change; lengths
beyond +/-16 are clamped to the boundary class and recovered from the BAM at
decode time (ref reference clair/task/variant_length.py:3-12).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class _VariantLength:
    index_offset: int = 16

    @property
    def min(self) -> int:
        return -self.index_offset

    @property
    def max(self) -> int:
        return self.index_offset

    @property
    def output_label_count(self) -> int:
        return 2 * self.index_offset + 1


VariantLength = _VariantLength()
