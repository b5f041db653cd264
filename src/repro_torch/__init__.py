"""PyTorch/CUDA port of the raster-interval spatial join.

Mirrors the reference package's layout (``core``, ``datagen``,
``kernels``, ``spatial``); imports ``torch`` and ``numpy``, never JAX and
nothing of the reference. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``, which runs the kernels' plain PyTorch
versions.
"""
from .datagen import (  # noqa: F401
    PolygonDataset, make_dataset, make_linestrings)
from .spatial import JoinPlan, JoinStats  # noqa: F401
