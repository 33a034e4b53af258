from clair_tpu_torch.utils.genomics import (  # noqa: F401
    BASE2ACGT,
    BASE2NUM,
    BASIC_BASES,
    NUM2BASE,
)
from clair_tpu_torch.utils.intervals import BedIntervals  # noqa: F401
