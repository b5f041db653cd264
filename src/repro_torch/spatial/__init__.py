from .filters import (  # noqa: F401
    Approximation, BACKENDS, BUILD_BACKENDS, FILTER_BACKENDS,
    IntermediateFilter, available_filters, get_filter, register_filter,
    unregister_filter,
)
from .fused import PIPELINE_MODES  # noqa: F401
from .mbr_join import MBR_BACKENDS, MBRIndex, adaptive_grid, mbr_join  # noqa: F401,E501
from .plan import JoinPlan, JoinStats  # noqa: F401
from .planner import (  # noqa: F401
    PLAN_MODES, PlanChoice, ProfileCache, check_plan_mode, choose_plan,
)
from .refine import REFINE_BACKENDS  # noqa: F401
from .pipeline import (  # noqa: F401
    spatial_intersection_join, spatial_within_join,
    polygon_linestring_join, selection_queries, tiled_spatial_join,
)
from .scaleout import (  # noqa: F401
    BALANCE_MODES, SCALEOUT_DEFAULTS, TilePartition, TilePlan,
    plan_scaleout, tiled_join,
)
from .store_cache import StoreCache  # noqa: F401
from .service import JoinService, JoinTicket, SERVICE_PREDICATES  # noqa: F401
