"""Pluggable intermediate filters. Importing this package registers the
port's filters (``april``) in its own registry."""
from .base import (  # noqa: F401
    FILTER_BACKENDS, PREDICATES, Approximation, IntermediateFilter,
    available_filters, get_filter, register_filter,
)
from .april_filter import AprilFilter  # noqa: F401
