r"""Adjoint representation of :math:`\mathrm{Diff}(\mathbb{R}^d)`, d = 2 or 3.

Port of ``lagomorph_tpu/adjrep.py``: the adjoint and coadjoint actions,
small and big, their metric duals and the symmetrised forms, as
compositions of the port's grid ops.  ``Ad_star`` runs the unit-regime
kernels (K1, K10); the others are plain PyTorch over the ops they call
(the fluid solves of ``metric.sharp`` / ``flat`` run K3 on 3D fields).
"""
from __future__ import annotations

import torch

from .ops.diff import jacobian_times_vectorfield, jacobian_times_vectorfield_adjoint
from .ops.interp import interp_auto, resolve_mode, splat, warp_tier
from .ops.kernels import epdiff2d, epdiff_unit

__all__ = ["ad", "Ad", "ad_star", "Ad_star", "ad_dagger", "Ad_dagger", "sym", "sym_dagger"]


def ad(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    r""":math:`\mathrm{ad}(v, w) = -[v, w] = Dv\,w - Dw\,v`."""
    return (jacobian_times_vectorfield(v, w, displacement=False)
            - jacobian_times_vectorfield(w, v, displacement=False))


def Ad(phi: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    r""":math:`\mathrm{Ad}(\varphi, v) = (D\varphi \circ \varphi^{-1})\, v
    \circ \varphi^{-1}` from the inverse displacement ``phi``:
    :math:`(D\varphi^{-1})^T v`, splatted through ``phi``."""
    DphiTv = jacobian_times_vectorfield(phi, v, displacement=True, transpose=True)
    return splat(DphiTv, phi)


def ad_star(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    r""":math:`\mathrm{ad}^*(v, m) = (Dv)^T m + Dm\,v + m\,\mathrm{div}\,v`,
    the discrete adjoint of :math:`\mathrm{ad}(v, \cdot)`."""
    return (jacobian_times_vectorfield(v, m, displacement=False, transpose=True)
            - jacobian_times_vectorfield_adjoint(m, v))


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

    ``mode`` None takes the global warp mode (``ops.interp.set_warp_mode``).
    The unit regime runs kernel K1 on 3D fields, K10 on 2D ones: always for
    ``mode="unit"``; for "auto" when the warp tier of ``phiinv`` (read on
    the host once) is "unit", else that tier's warp.  ``mode`` "bounded" /
    "general" forces that warp tier, and no kernel."""
    mode = resolve_mode(mode)
    kernel = _unit_kernel(phiinv, m) if mode in ("auto", "unit") else None
    if kernel is not None and mode == "auto":
        mode = warp_tier(phiinv)
    if kernel is not None and mode == "unit":
        return kernel(phiinv, m)[0]
    mphiinv = interp_auto(m, phiinv, mode=mode)
    return jacobian_times_vectorfield(phiinv, mphiinv, displacement=True)


def ad_dagger(x: torch.Tensor, y: torch.Tensor, metric) -> torch.Tensor:
    r""":math:`\mathrm{ad}^\dagger(x, y) = \mathrm{ad}^*(x, y^\flat)^\sharp`."""
    return metric.sharp(ad_star(x, metric.flat(y)))


def Ad_dagger(phi: torch.Tensor, y: torch.Tensor, metric) -> torch.Tensor:
    r""":math:`\mathrm{Ad}^\dagger(\varphi, y) = \mathrm{Ad}^*(\varphi,
    y^\flat)^\sharp` (K1 or K10 between two fluid solves)."""
    return metric.sharp(Ad_star(phi, metric.flat(y)))


def sym(x: torch.Tensor, y: torch.Tensor, metric) -> torch.Tensor:
    r"""Negative symmetrised :math:`\mathrm{ad}^\dagger`, for reduced Jacobi
    fields: :math:`-(\mathrm{ad}^\dagger(x, y) + \mathrm{ad}^\dagger(y, x))`."""
    return -(ad_dagger(x, y, metric) + ad_dagger(y, x, metric))


def sym_dagger(x: torch.Tensor, y: torch.Tensor, metric) -> torch.Tensor:
    r""":math:`\mathrm{sym}^\dagger(x, y) = \mathrm{ad}^\dagger(y, x) -
    \mathrm{ad}(x, y)`."""
    return ad_dagger(y, x, metric) - ad(x, y)
