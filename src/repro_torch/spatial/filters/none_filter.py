"""The 'none' filter: no intermediate step, every MBR candidate is
forwarded to refinement (the paper's baseline column)."""
from __future__ import annotations

import numpy as np
import torch

from ...core.join import INDECISIVE
from ...core.rasterize import Extent, GLOBAL_EXTENT
from ...device import resolve_device
from .base import Approximation, IntermediateFilter, register_filter

__all__ = ["NoneFilter"]


@register_filter("none")
class NoneFilter(IntermediateFilter):

    def build(self, dataset, *, n_order: int = 10,
              extent: Extent = GLOBAL_EXTENT, kind: str = "polygon",
              side: str = "r", **opts) -> Approximation:
        # nothing to build, and nothing is
        return Approximation(filter=self.name, store=None, n_order=n_order,
                             extent=extent, kind=kind)

    def verdicts(self, approx_r, approx_s, pairs, *,
                 predicate: str = "intersects", backend: str = "numpy",
                 device=None, **opts) -> np.ndarray:
        self._check(predicate, backend)
        # every backend (sequential included) forwards everything
        return self._all_indecisive(pairs)

    def status_lane(self, approx_r, approx_s, ri, si, *,
                    predicate: str = "intersects", backend: str = "numpy",
                    device=None, rows=None, **opts) -> torch.Tensor:
        # a constant lane, minted on the device: no host round trip
        self._check(predicate, backend)
        return torch.full((len(np.asarray(ri)),), INDECISIVE,
                          dtype=torch.int8, device=resolve_device(device))

    def _verdict_one(self, approx_r, approx_s, i, j, *, predicate, **opts):
        return INDECISIVE

    # nothing is stored, so maintenance is a no-op (ids are tracked by the
    # dataset, not the store)
    def patch_insert(self, approx, dataset_one) -> None:
        if len(dataset_one) != 1:
            raise ValueError(f"patch_insert expects a 1-object dataset, "
                             f"got {len(dataset_one)}")

    def patch_delete(self, approx, idx: int) -> None:
        pass
