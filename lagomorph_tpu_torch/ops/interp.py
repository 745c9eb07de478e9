"""Free-form deformation interpolation (forward).

Port of ``lagomorph_tpu/ops/interp.py``: sample an image or vector field
``I`` through a displacement field ``u``,

    out_{n,c}(x) = I_{n,c}(x + dt * u_n(x)),

with CLAMP boundary and broadcasting of a size-1 image batch.
:func:`interp_auto` picks one of three exact tiers from the displacement's
bound; where the JAX package switches with ``lax.cond``, the port reads the
tier flags on the host (one sync per call) and branches.
"""
from __future__ import annotations

import torch

from .kernels import warp_unit
from .sampling import (
    identity_grid,
    sample_displacement_bounded,
    sample_displacement_unit,
    sample_linear,
)

WARP_MODES = ("auto", "unit", "bounded", "general")


def interp(I: torch.Tensor, u: torch.Tensor, dt: float = 1.0,
           background: str = "clamp", background_value: float = 0.0) -> torch.Tensor:
    """Deform ``I`` (``(NI, C, *spatial)``, ``NI in {1, N}``) by the
    displacement ``u`` (``(N, dim, *spatial)``, voxel units) through the
    general gather: ``out(x) = I(x + dt*u(x))``."""
    grid = identity_grid(u.shape[2:], dtype=u.dtype, device=u.device)
    coords = grid[None] + dt * u
    return sample_linear(I, coords, background=background,
                         background_value=background_value)


def in_unit(d: torch.Tensor) -> torch.Tensor:
    """0-dim bool tensor: every component of ``d`` lies in ``[-1, 1)``."""
    return torch.logical_and(torch.all(d >= -1.0), torch.all(d < 1.0))


def tier_flags(d: torch.Tensor, radius: int):
    """(unit, bounded) 0-dim bool tensors: every component of ``d`` in
    ``[-1, 1)``, and in ``[-radius, radius + 1)`` (half-open bounds)."""
    bounded = torch.logical_and(
        torch.all(d >= -float(radius)), torch.all(d < float(radius + 1))
    )
    return in_unit(d), bounded


def warp_tier(d: torch.Tensor, radius: int = 2) -> str:
    """The tier :func:`interp_auto` takes for displacement ``d``: "unit",
    "bounded" or "general" (reads both flags on the host in one sync)."""
    unit, bounded = torch.stack(tier_flags(d, radius)).tolist()
    if unit:
        return "unit"
    return "bounded" if bounded else "general"


def interp_auto(I: torch.Tensor, u: torch.Tensor, dt: float = 1.0, radius: int = 2,
                mode: str | None = None) -> torch.Tensor:
    """:func:`interp` through the exact tiered fast paths.

    Tier 1, "unit": every component of ``dt*u`` in ``[-1, 1)``: the 27-tap
    stencil (kernel K4 on CUDA).  Tier 2, "bounded": components in
    ``[-radius, radius + 1)``: the dense offset sweep.  Tier 3, "general":
    the gather.  Every tier equals the gather in its regime.  ``mode``
    forces a tier (the caller guarantees its regime); None or "auto" picks
    it from the displacement."""
    d = dt * u if dt != 1.0 else u
    mode = "auto" if mode is None else mode
    if mode not in WARP_MODES:
        raise ValueError(mode)
    if mode == "auto":
        mode = warp_tier(d, radius)
    if mode == "unit":
        # kernel K4 covers 3D fields; 2D takes the plain stencil, as the JAX
        # package's warp kernel is 3D only
        if d.dim() == 5:
            return warp_unit.sample_displacement_unit(I, d)
        return sample_displacement_unit(I, d)
    if mode == "bounded":
        return sample_displacement_bounded(I, d, radius)
    return interp(I, d, 1.0)
