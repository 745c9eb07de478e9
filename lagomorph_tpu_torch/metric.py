"""The LDDMM fluid metric.

Port of ``lagomorph_tpu/metric.py``: ``FluidMetric`` applies the Green's
function of ``L'L = (-alpha Laplacian - beta grad div + gamma)^2``
(:mod:`.ops.fluid`), keeping the per-frequency multiplier it built for each
field shape, dtype, device and multiplier form (the form of the route the
selectors give: half or full spectrum, natural or bit-reversed order);
``Metric``, the command-line interface to the metric factory.
"""
from __future__ import annotations

import torch

from .ops.fluid import fluid_operator, fluid_route, form_multiplier, multiplier_form

__all__ = ["FluidMetric", "Metric"]


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
        """The multiplier ``fluid_operator`` uses on fields of ``shape`` on
        the route the selectors give now: the full-spectrum scalar (in
        bit-reversed order on the radix route) for the packed solves, else
        the ``d x d`` entries.  Built once per key."""
        form = multiplier_form(fluid_route(shape, self.params))
        return self._entries(tuple(shape[2:]), dtype, device, inverse, form)

    def packed_multiplier(self, spatial, dtype: torch.dtype, device) -> torch.Tensor:
        """The full-spectrum scalar multiplier of ``sharp`` on a grid of
        ``spatial`` size, as the packed-pair solves take it (the 2D
        whole-shoot kernels; valid for ``beta == 0``).  Built once per key."""
        return self._entries(tuple(spatial), dtype, device, True, multiplier_form("fluid_flat"))

    def _entries(self, spatial, dtype, device, inverse, form):
        key = (spatial, dtype, torch.device(device), bool(inverse), form)
        if key not in self._multipliers:
            self._multipliers[key] = form_multiplier(form, spatial, self.params, inverse,
                                                     dtype, device)
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


class Metric:
    """Command-line interface to a metric factory: the arguments that
    describe a metric and the metric they describe."""

    @staticmethod
    def add_args(parser):
        parser.add_argument(
            "--metric_type",
            default="fluid",
            type=str,
            help="Type of metric. Currently only 'fluid' is supported.",
        )
        parser.add_argument(
            "--fluid_alpha",
            default=0.1,
            type=float,
            help="Fluid parameter for vector Laplacian term",
        )
        parser.add_argument(
            "--fluid_beta",
            default=0.0,
            type=float,
            help="Fluid parameter for gradient divergence term",
        )
        parser.add_argument(
            "--fluid_gamma",
            default=0.01,
            type=float,
            help="Fluid parameter for L2 term",
        )

    @classmethod
    def from_args(cls, args):
        if args.metric_type.lower() == "fluid":
            return FluidMetric(params=[args.fluid_alpha, args.fluid_beta, args.fluid_gamma])
        raise ValueError(f"Unknown metric type {args.metric_type}")
