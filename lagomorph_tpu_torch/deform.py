"""Deformation-field utilities: identity, composition.

Port of ``lagomorph_tpu/deform.py``.  Tensors are NC(D)HW; a displacement
field has ``dim`` channels.
"""
from __future__ import annotations

import torch

from .ops.interp import interp_auto, warp_tier
from .ops.kernels import epdiff2d, epdiff_unit
from .ops.sampling import identity_grid

__all__ = ["identity", "compose", "compose_disp_vel"]


def identity(defshape, dtype=torch.float32, *, device) -> torch.Tensor:
    """Identity coordinate field ``(N, dim, *spatial)`` for a deformation
    shape in NC(D)HW order, on ``device`` (required: nothing is built on a
    default device)."""
    spatial = tuple(defshape[2:])
    grid = identity_grid(spatial, dtype=dtype, device=device)
    return grid[None].expand((defshape[0], len(spatial)) + spatial)


def _unit_kernel(u, v):
    """The unit-regime compose kernel covering these fields: K2 for 3D
    three-channel fields, K11 for 2D two-channel ones, both of one batch
    and grid, else None."""
    dim = u.dim() - 2
    if (dim not in (2, 3) or u.shape[1] != dim or v.dim() != u.dim() or v.shape[1] != dim
            or v.shape[0] != u.shape[0] or v.shape[2:] != u.shape[2:]):
        return None
    return epdiff_unit.compose if dim == 3 else epdiff2d.compose2d


def compose(u: torch.Tensor, v: torch.Tensor, ds: float = 1.0, dt: float = 1.0,
            mode: str | None = None) -> torch.Tensor:
    """``ds*u(x) + dt*v(x + ds*u(x))``.

    With ``dt == 1`` the unit regime runs kernel K2 on 3D fields, K11 on 2D
    ones: always for ``mode="unit"``; for ``mode`` None or "auto" when the
    warp tier of ``ds*u`` (read on the host once) is "unit", else that
    tier's warp.  ``mode`` "bounded" / "general" forces that warp tier."""
    mode = "auto" if mode is None else mode
    kernel = _unit_kernel(u, v) if isinstance(ds, (int, float)) and dt == 1.0 else None
    if kernel is not None and mode == "auto":
        mode = warp_tier(ds * u)
    if kernel is not None and mode == "unit":
        return kernel(v, u, float(ds))[0]
    return ds * u + dt * interp_auto(v, u, dt=ds, mode=mode)


def compose_disp_vel(u: torch.Tensor, v: torch.Tensor, dt: float = 1.0,
                     mode: str | None = None) -> torch.Tensor:
    """Displacement-then-velocity composition ``dt*v(x) + u(x + dt*v(x))``."""
    return compose(v, u, ds=dt, dt=1.0, mode=mode)
