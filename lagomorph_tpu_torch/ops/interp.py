"""Free-form deformation interpolation and its transpose.

Port of ``lagomorph_tpu/ops/interp.py``: sample an image or vector field
``I`` through a displacement field ``u``,

    out_{n,c}(x) = I_{n,c}(x + dt * u_n(x)),

with CLAMP boundary and broadcasting of a size-1 image batch; its
transpose in ``I`` (:func:`splat`) and the diagonal of the Hessian of a
sum of squares through it (:func:`interp_hessian_diagonal_image`).
:func:`interp_auto` picks one of three exact tiers from the displacement's
bound; where the JAX package switches with ``lax.cond``, the port reads the
tier flags on the host (one sync per call) and branches.  The global warp
mode (:func:`set_warp_mode`) forces a tier wherever no ``mode`` is passed,
and a forced "bounded" or "general" mode keeps every unit-regime kernel
(K1, K2, K4, K8, K10, K11, K17) off.
"""
from __future__ import annotations

import torch

from ..profiling import span
from .kernels import warp2d, warp_unit
from .sampling import (
    identity_grid,
    sample_displacement_bounded,
    sample_displacement_unit,
    sample_linear,
    scatter_corners,
    splat_linear,
)

WARP_MODES = ("auto", "unit", "bounded", "general")

# The global warp mode: "auto" picks each warp's tier from its displacement
# and lets the unit-regime kernels run; "unit", "bounded" and "general"
# force that tier (the caller guarantees its regime), and the last two keep
# the unit-regime kernels and the hoisted shooting off.
_WARP_MODE = "auto"


def set_warp_mode(mode: str) -> str:
    """Set the global warp mode (one of :data:`WARP_MODES`); returns the
    previous one.  The port reads it at every call that is given no
    ``mode`` (:func:`interp_auto`, ``deform.compose``, ``adjrep.Ad_star``,
    the shooting's choice of the hoisted path), so a change takes effect at
    the next call; the JAX package reads it when a function is traced, and
    a function jitted before the change keeps the mode it was traced
    with."""
    global _WARP_MODE
    if mode not in WARP_MODES:
        raise ValueError(mode)
    prev = _WARP_MODE
    _WARP_MODE = mode
    return prev


def get_warp_mode() -> str:
    """The current global warp mode (see :func:`set_warp_mode`)."""
    return _WARP_MODE


def resolve_mode(mode: str | None) -> str:
    """``mode``, or the global warp mode when it is None; raises outside
    :data:`WARP_MODES`."""
    mode = _WARP_MODE if mode is None else mode
    if mode not in WARP_MODES:
        raise ValueError(mode)
    return mode


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
    "bounded" or "general" (reads both flags on the host in one sync, the
    span ``lt.read.tier``)."""
    flags = torch.stack(tier_flags(d, radius))
    with span("lt.read.tier"):
        unit, bounded = flags.tolist()
    if unit:
        return "unit"
    return "bounded" if bounded else "general"


def interp_auto(I: torch.Tensor, u: torch.Tensor, dt: float = 1.0, radius: int = 2,
                mode: str | None = None) -> torch.Tensor:
    """:func:`interp` through the exact tiered fast paths.

    Tier 1, "unit": every component of ``dt*u`` in ``[-1, 1)``: the 27-tap
    stencil (kernel K4 on CUDA; in 2D the 9-tap one, K17).  Tier 2,
    "bounded": components in ``[-radius, radius + 1)``: the dense offset
    sweep.  Tier 3, "general": the gather.  Every tier equals the gather in
    its regime.  ``mode`` forces a tier (the caller guarantees its regime);
    "auto" picks it from the displacement; None takes the global warp mode
    (:func:`set_warp_mode`)."""
    d = dt * u if dt != 1.0 else u
    mode = resolve_mode(mode)
    if mode == "auto":
        mode = warp_tier(d, radius)
    if mode == "unit":
        # kernel K4 covers 3D fields, K17 2D ones
        if d.dim() == 5:
            return warp_unit.sample_displacement_unit(I, d)
        if d.dim() == 4:
            return warp2d.sample_displacement_unit(I, d)
        return sample_displacement_unit(I, d)
    if mode == "bounded":
        return sample_displacement_bounded(I, d, radius)
    return interp(I, d, 1.0)


def splat(values: torch.Tensor, u: torch.Tensor, dt: float = 1.0) -> torch.Tensor:
    """Transpose of :func:`interp` in the image slot: ``values`` (``(N, C,
    *spatial)``) scattered through the displacement ``u`` (``(N, dim,
    *spatial)``, the same ``N``) at ``x + dt*u(x)`` (:func:`splat_linear`;
    atomic adds on the card)."""
    grid = identity_grid(u.shape[2:], dtype=u.dtype, device=u.device)
    return splat_linear(values, grid[None] + dt * u, tuple(u.shape[2:]))


def interp_hessian_diagonal_image(I: torch.Tensor, u: torch.Tensor,
                                  dt: float = 1.0) -> torch.Tensor:
    """Diagonal of the Hessian in ``I`` of a sum of squares through
    :func:`interp`: the squared multilinear weights of every output point
    added at its clamped corners.  Dimension-generic, batched ``(N, C,
    *spatial)`` (each channel the same), in ``I``'s dtype."""
    N = u.shape[0]
    spatial = tuple(u.shape[2:])
    grid = identity_grid(spatial, dtype=u.dtype, device=u.device)
    ones = torch.ones((N, 1) + spatial, dtype=u.dtype, device=u.device)
    H = scatter_corners(ones, grid[None] + dt * u, spatial, square=True)
    return H.expand((N, I.shape[1]) + spatial).to(I.dtype)
