"""Label spaces for the four prediction tasks.

The output vector layout is 21 (gt21) + 3 (genotype) + 33 (indel length 1)
+ 33 (indel length 2) = 90 classes, matching the reference task definitions
(reference clair/task/main.py:10-29).
"""

from clair_tpu_torch.task.gt21 import (  # noqa: F401
    GT21_LABELS,
    GT21,
    HOMO_SNP_GT21,
    HETERO_SNP_GT21,
    gt21_code_from,
    gt21_code_from_label,
    gt21_label_from,
)
from clair_tpu_torch.task.genotype import (  # noqa: F401
    GENOTYPES,
    Genotype,
    genotype_code_from,
    genotype_for_task,
    genotype_string_from,
)
from clair_tpu_torch.task.variant_length import VariantLength  # noqa: F401
from clair_tpu_torch.task.labels import (  # noqa: F401
    GT21_SPAN,
    GENOTYPE_SPAN,
    LENGTH1_SPAN,
    LENGTH2_SPAN,
    OUTPUT_LABEL_COUNT,
    label_vector_from_reference,
    label_vector_from_truth,
    split_label_vector,
)
