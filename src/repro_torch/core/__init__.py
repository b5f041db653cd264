"""Core library: APRIL raster-interval approximations and the interval-join
intermediate filter."""
from . import april, geometry, hilbert, intervalize, join, rasterize  # noqa: F401
from .april import AprilStore, build_april  # noqa: F401
from .join import INDECISIVE, TRUE_HIT, TRUE_NEG  # noqa: F401
from .rasterize import Extent, GLOBAL_EXTENT  # noqa: F401
