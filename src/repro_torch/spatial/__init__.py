from .filters import (  # noqa: F401
    Approximation, BACKENDS, BUILD_BACKENDS, FILTER_BACKENDS,
    IntermediateFilter, available_filters, get_filter, register_filter,
    unregister_filter,
)
from .fused import PIPELINE_MODES  # noqa: F401
from .mbr_join import MBR_BACKENDS, mbr_join  # noqa: F401
from .plan import JoinPlan, JoinStats  # noqa: F401
from .refine import REFINE_BACKENDS  # noqa: F401
