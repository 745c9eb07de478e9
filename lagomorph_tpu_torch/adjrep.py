r"""Big coadjoint action of :math:`\mathrm{Diff}(\mathbb{R}^3)`.

Port of ``Ad_star`` from ``lagomorph_tpu/adjrep.py``.
"""
from __future__ import annotations

import torch

from .ops.diff import jacobian_times_vectorfield
from .ops.interp import interp_auto, warp_tier
from .ops.kernels import epdiff_unit

__all__ = ["Ad_star"]


def _k1_covers(phiinv, m):
    return (phiinv.dim() == 5 and phiinv.shape[1] == 3 and m.shape[1] == 3
            and m.shape[0] in (1, phiinv.shape[0]) and m.shape[2:] == phiinv.shape[2:])


def Ad_star(phiinv: torch.Tensor, m: torch.Tensor, mode: str | None = None) -> torch.Tensor:
    r""":math:`\mathrm{Ad}^*(\varphi, m)(x) = (D\varphi(x))\, m(\varphi(x))`
    with :math:`\varphi` given by the displacement ``phiinv``:
    ``jacobian_times_vectorfield(phiinv, m(x + phiinv(x)), displacement=True)``.

    On 3D fields the unit regime runs kernel K1: always for ``mode="unit"``;
    for ``mode`` None or "auto" when the warp tier of ``phiinv`` (read on
    the host once) is "unit", else that tier's warp.  ``mode`` "bounded" /
    "general" forces that warp tier."""
    mode = "auto" if mode is None else mode
    k1 = _k1_covers(phiinv, m)
    if k1 and mode == "auto":
        mode = warp_tier(phiinv)
    if k1 and mode == "unit":
        return epdiff_unit.ad_star(phiinv, m)[0]
    mphiinv = interp_auto(m, phiinv, mode=mode)
    return jacobian_times_vectorfield(phiinv, mphiinv, displacement=True)
