"""Edge x edge orientation sweep of refinement: CUDA kernel, wrappers
(ragged CSR and the reference's padded signature) and plain PyTorch
versions."""
from .ops import edges_intersect, edges_intersect_csr, pack_edges  # noqa: F401
from .ref import (EPS, edges_intersect_csr_plain,  # noqa: F401
                  edges_intersect_plain)
