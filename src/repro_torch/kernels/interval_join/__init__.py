"""Interval-list joins of the APRIL filter: CUDA kernels, wrappers and
their plain PyTorch versions."""
from .ops import april_trichotomy, interval_overlap  # noqa: F401
from .ref import (CSRLists, april_trichotomy_plain,  # noqa: F401
                  interval_overlap_plain)
