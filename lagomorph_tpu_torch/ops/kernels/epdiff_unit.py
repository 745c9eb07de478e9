"""K1 and K2: the two stencil steps of one EPDiff substep, forward, each
with the unit-regime flag of its warp displacement
(``csrc/epdiff_unit.cu``).

* K1, :func:`ad_star`: ``out_c = sum_a (D_a phiinv_c + delta_ca) * mw_a``
  with ``mw = sample_displacement_unit(m0, phiinv)``, and the flag of
  ``phiinv``.  Replaces ``lagomorph_tpu/ops/pallas/epdiff_unit.py``
  ``_adstar_fwd_kernel[_mw]`` / ``_adstar_fwd_kernel_yb[_mw]`` and
  ``lagomorph_tpu/ops/pallas/padres.py`` ``_adstar_fwd_kernel_pr[_mw]``.
* K2, :func:`compose`: ``d = s * v``; ``out = d + phiinv(x + d)``, and the
  flag of ``d``.  Replaces ``epdiff_unit.py`` ``_compose_fwd_kernel[_yb]``
  and ``padres.py`` ``_compose_fwd_kernel_pr``.

A flag is a 0-dim bool tensor on the fields' device, true iff every
component of the displacement lies in ``[-1, 1)``; reading it is the
caller's one host sync.  Both kernels are bound by memory on the H100
(three 100.7 MB fields each at 128^3 b4); see the source for the design.
"""
from __future__ import annotations

import torch

from . import _build, check_cuda_f32, forward_only, register, stream_of, use_kernel
from ..diff import jacobian_times_vectorfield
from ..interp import in_unit
from ..sampling import sample_displacement_unit

AD_STAR = register(
    "ad_star_fwd",
    source="lagomorph_tpu_torch/csrc/epdiff_unit.cu",
    replaces="lagomorph_tpu/ops/pallas/padres.py:423, 436; lagomorph_tpu/ops/pallas/epdiff_unit.py:233, 370",
)
COMPOSE = register(
    "compose_fwd",
    source="lagomorph_tpu_torch/csrc/epdiff_unit.cu",
    replaces="lagomorph_tpu/ops/pallas/padres.py:456; lagomorph_tpu/ops/pallas/epdiff_unit.py:629, 661",
)


def ad_star_plain(phiinv: torch.Tensor, m0: torch.Tensor):
    """Plain version of K1: ``(Ad*(phiinv, m0), in_unit(phiinv))``."""
    mw = sample_displacement_unit(m0, phiinv)
    return jacobian_times_vectorfield(phiinv, mw, displacement=True), in_unit(phiinv)


def compose_plain(phiinv: torch.Tensor, v: torch.Tensor, s: float):
    """Plain version of K2: ``(s*v + phiinv(x + s*v), in_unit(s*v))``."""
    d = s * v
    return d + sample_displacement_unit(phiinv, d), in_unit(d)


def _check(name, phiinv, other):
    check_cuda_f32(name, phiinv, other)
    if phiinv.dim() != 5 or phiinv.shape[1] != 3:
        raise ValueError(f"{name}: phiinv must be (N, 3, X, Y, Z), got {tuple(phiinv.shape)}")
    if other.dim() != 5 or other.shape[1] != 3 or other.shape[2:] != phiinv.shape[2:]:
        raise ValueError(
            f"{name}: field {tuple(other.shape)} does not match phiinv {tuple(phiinv.shape)}"
        )


def _launch_ad_star(phiinv, m0):
    N, _, X, Y, Z = phiinv.shape
    out = torch.empty_like(phiinv)
    flag = torch.ones((), dtype=torch.int32, device=phiinv.device)
    _build.call(
        "lagomorph_ad_star_fwd",
        phiinv.data_ptr(), m0.data_ptr(), out.data_ptr(), flag.data_ptr(),
        N, m0.shape[0], X, Y, Z, stream_of(phiinv),
    )
    AD_STAR.launches += 1
    return out, flag.bool()


def _launch_compose(phiinv, v, s):
    N, _, X, Y, Z = phiinv.shape
    out = torch.empty_like(phiinv)
    flag = torch.ones((), dtype=torch.int32, device=phiinv.device)
    _build.call(
        "lagomorph_compose_fwd",
        phiinv.data_ptr(), v.data_ptr(), float(s), out.data_ptr(), flag.data_ptr(),
        N, X, Y, Z, stream_of(phiinv),
    )
    COMPOSE.launches += 1
    return out, flag.bool()


def ad_star(phiinv: torch.Tensor, m0: torch.Tensor):
    """K1: ``(Ad*(phiinv, m0), flag of phiinv)`` for 3D fields; ``m0`` may
    have batch 1.  The result is exact where the flag is true."""
    if not use_kernel(phiinv):
        return ad_star_plain(phiinv, m0)
    _check("ad_star", phiinv, m0)
    if m0.shape[0] not in (1, phiinv.shape[0]):
        raise ValueError(f"ad_star: m0 batch {m0.shape[0]} vs phiinv {phiinv.shape[0]}")
    return forward_only(_launch_ad_star, phiinv, m0)


def compose(phiinv: torch.Tensor, v: torch.Tensor, s: float):
    """K2: ``(s*v + phiinv(x + s*v), flag of s*v)`` for 3D fields of equal
    batch.  The result is exact where the flag is true."""
    if not use_kernel(phiinv):
        return compose_plain(phiinv, v, s)
    _check("compose", phiinv, v)
    if v.shape[0] != phiinv.shape[0]:
        raise ValueError(f"compose: v batch {v.shape[0]} vs phiinv {phiinv.shape[0]}")
    return forward_only(lambda p, vv: _launch_compose(p, vv, s), phiinv, v)
