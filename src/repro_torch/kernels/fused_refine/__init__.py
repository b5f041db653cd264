"""The fused chain's float64 refine of the INDECISIVE prefix (B7): CUDA
kernel and its wrapper. The plain version is the eager chunk loop of
``spatial.refine.fused_refine_lanes``, which runs it for CPU tensors and
for the ``torch`` refine backend, and calls this kernel on the card."""
from .ops import fused_refine_rows  # noqa: F401
