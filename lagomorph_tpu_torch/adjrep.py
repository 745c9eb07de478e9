r"""Big coadjoint action of :math:`\mathrm{Diff}(\mathbb{R}^d)`, d = 2 or 3.

Port of ``Ad_star`` from ``lagomorph_tpu/adjrep.py``.
"""
from __future__ import annotations

import torch

from .ops.diff import jacobian_times_vectorfield
from .ops.interp import interp_auto, warp_tier
from .ops.kernels import epdiff2d, epdiff_unit

__all__ = ["Ad_star"]


def _unit_kernel(phiinv, m):
    """The unit-regime Ad* kernel covering these fields: K1 for 3D
    three-channel fields, K10 for 2D two-channel ones (``m`` of batch 1 or
    ``phiinv``'s, on its grid), else None."""
    dim = phiinv.dim() - 2
    if (dim not in (2, 3) or phiinv.shape[1] != dim or m.dim() != phiinv.dim()
            or m.shape[1] != dim or m.shape[0] not in (1, phiinv.shape[0])
            or m.shape[2:] != phiinv.shape[2:]):
        return None
    return epdiff_unit.ad_star if dim == 3 else epdiff2d.ad_star2d


def Ad_star(phiinv: torch.Tensor, m: torch.Tensor, mode: str | None = None) -> torch.Tensor:
    r""":math:`\mathrm{Ad}^*(\varphi, m)(x) = (D\varphi(x))\, m(\varphi(x))`
    with :math:`\varphi` given by the displacement ``phiinv``:
    ``jacobian_times_vectorfield(phiinv, m(x + phiinv(x)), displacement=True)``.

    The unit regime runs kernel K1 on 3D fields, K10 on 2D ones: always for
    ``mode="unit"``; for ``mode`` None or "auto" when the warp tier of
    ``phiinv`` (read on the host once) is "unit", else that tier's warp.
    ``mode`` "bounded" / "general" forces that warp tier."""
    mode = "auto" if mode is None else mode
    kernel = _unit_kernel(phiinv, m)
    if kernel is not None and mode == "auto":
        mode = warp_tier(phiinv)
    if kernel is not None and mode == "unit":
        return kernel(phiinv, m)[0]
    mphiinv = interp_auto(m, phiinv, mode=mode)
    return jacobian_times_vectorfield(phiinv, mphiinv, displacement=True)
