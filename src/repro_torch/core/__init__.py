"""Core library: the APRIL, APRIL-C and RI raster-interval approximations
and their intermediate filters."""
from . import (  # noqa: F401
    april, compress, geometry, granularity, hilbert, intervalize, join,
    partition, rasterize, ri,
)
from .april import AprilStore, build_april, build_april_polygon  # noqa: F401
from .join import (  # noqa: F401
    INDECISIVE, TRUE_HIT, TRUE_NEG, april_filter_batch, april_verdict_pair,
)
from .rasterize import Extent, GLOBAL_EXTENT  # noqa: F401
