"""The LDDMM fluid metric.

Port of ``lagomorph_tpu/metric.py``: ``FluidMetric`` applies the Green's
function of ``L'L = (-alpha Laplacian - beta grad div + gamma)^2``
(:mod:`.ops.fluid`), keeping the per-frequency multiplier it built for each
field shape, dtype and device.
"""
from __future__ import annotations

import torch

from .ops.fluid import flat_path, fluid_multiplier_entries, fluid_operator

__all__ = ["FluidMetric"]


class FluidMetric:
    """``params = (alpha, beta, gamma)``.  ``sharp`` raises indices
    (momentum -> velocity, the inverse operator); ``flat`` lowers them."""

    def __init__(self, params=(0.1, 0.0, 0.001)):
        params = tuple(float(p) for p in params)
        if len(params) != 3:
            raise ValueError("FluidMetric takes (alpha, beta, gamma)")
        self.params = params
        self._multipliers = {}

    def multiplier(self, shape, dtype: torch.dtype, device, inverse: bool):
        """The multiplier ``fluid_operator`` uses on fields of ``shape``:
        the full-spectrum scalar for the packed path, else the
        half-spectrum ``d x d`` entries.  Built once per key."""
        return self._entries(tuple(shape[2:]), dtype, device, inverse,
                             flat_path(shape, self.params))

    def packed_multiplier(self, spatial, dtype: torch.dtype, device) -> torch.Tensor:
        """The full-spectrum scalar multiplier of ``sharp`` on a grid of
        ``spatial`` size, as the packed-pair solves take it (the 2D
        whole-shoot kernels; valid for ``beta == 0``).  Built once per key."""
        return self._entries(tuple(spatial), dtype, device, True, True)

    def _entries(self, spatial, dtype, device, inverse, full):
        key = (spatial, dtype, torch.device(device), bool(inverse), full)
        if key not in self._multipliers:
            M = fluid_multiplier_entries(spatial, self.params, inverse, dtype,
                                         device, full_spectrum=full)
            self._multipliers[key] = M[(0, 0)] if full else M
        return self._multipliers[key]

    def operator(self, mv: torch.Tensor, inverse: bool) -> torch.Tensor:
        M = self.multiplier(mv.shape, mv.dtype, mv.device, inverse)
        return fluid_operator(mv, self.params, inverse, M=M)

    def sharp(self, m: torch.Tensor) -> torch.Tensor:
        """Momentum (covector field) -> velocity: the smoothing inverse."""
        return self.operator(m, inverse=True)

    def flat(self, v: torch.Tensor) -> torch.Tensor:
        """Velocity -> momentum: the differential operator."""
        return self.operator(v, inverse=False)
