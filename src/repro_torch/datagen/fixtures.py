"""Boundary-touch regression geometry, shared by the tests and the
refinement checks so the float literals cannot drift apart (the same
literals as the JAX package's ``datagen.fixtures``).

``SNAPPED_TRI`` / ``SNAPPED_HOST``: a triangle whose first vertex was
snapped onto a diagonal edge of the host polygon (found by exact-rational
search): the segment sweep sees no crossing and a first-vertex
crossing-parity fallback classifies the snapped vertex outside, a false
negative on touching containment; the exact truth on the stored floats is
True.

``CSHAPE`` / ``CSHAPE_INNER``: a concave C-shaped container whose vertex
centroid lies in the cavity, and an inner triangle with one vertex exactly
on the container boundary: a nudge-toward-centroid within fallback pushes
the vertex out of the polygon, a false negative on touching within.
"""
from __future__ import annotations

import numpy as np

__all__ = ["SNAPPED_TRI", "SNAPPED_HOST", "CSHAPE", "CSHAPE_INNER"]

SNAPPED_TRI = np.array([
    [0.52826315, 0.22223645],
    [0.53367238, 0.30697867],
    [0.50589603, 0.30415236],
])

SNAPPED_HOST = np.array([
    [0.876275, 0.5392158],
    [0.84509312, 0.59085845],
    [0.47389812, 0.7088683],
    [0.14926845, 0.4013808],
    [0.33066059, 0.36583674],
    [0.45614802, 0.16149059],
    [0.59354244, 0.27722416],
    [0.81183718, 0.30959406],
])

CSHAPE = np.array([
    [0., 0.], [10., 0.], [10., 2.], [2., 2.],
    [2., 8.], [10., 8.], [10., 10.], [0., 10.],
])

CSHAPE_INNER = np.array([[6., 2.], [7., .5], [5., .5]])
