"""Edge x edge orientation sweep of refinement: CUDA kernel, wrapper and
its plain PyTorch version."""
from .ops import edges_intersect  # noqa: F401
from .ref import EPS, edges_intersect_plain  # noqa: F401
