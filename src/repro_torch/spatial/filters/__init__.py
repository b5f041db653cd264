"""Pluggable intermediate filters. Importing this package registers the
port's filters (``none``, ``april``, ``april-c``, ``ri``, ``ra``,
``5cch``) in its own registry."""
from .base import (  # noqa: F401
    BACKENDS, BUILD_BACKENDS, FILTER_BACKENDS, PREDICATES, Approximation,
    IntermediateFilter, available_filters, get_filter, register_filter,
    unregister_filter,
)
from .april_filter import AprilCompressedFilter, AprilFilter  # noqa: F401
from .fivecch_filter import FiveCCHFilter  # noqa: F401
from .none_filter import NoneFilter  # noqa: F401
from .ra_filter import RAFilter  # noqa: F401
from .ri_filter import RIFilter  # noqa: F401
