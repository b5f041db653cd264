"""Core library: the APRIL, APRIL-C and RI raster-interval approximations
and their intermediate filters."""
from . import (april, compress, geometry, hilbert, intervalize,  # noqa: F401
               join, rasterize, ri)
from .april import AprilStore, build_april, build_april_polygon  # noqa: F401
from .join import INDECISIVE, TRUE_HIT, TRUE_NEG  # noqa: F401
from .rasterize import Extent, GLOBAL_EXTENT  # noqa: F401
