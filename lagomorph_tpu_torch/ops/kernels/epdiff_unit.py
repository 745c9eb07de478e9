"""K1, K2, K6 and K7: the two stencil steps of one EPDiff substep, each
with the unit-regime flag of its warp displacement, and their backwards
(``csrc/epdiff_unit.cu``).

* K1, :func:`ad_star`: ``out_c = sum_a (D_a phiinv_c + delta_ca) * mw_a``
  with ``mw = sample_displacement_unit(m0, phiinv)``, and the flag of
  ``phiinv``; under autograd it also writes ``mw`` for the backward.
  Replaces ``lagomorph_tpu/ops/pallas/epdiff_unit.py``
  ``_adstar_fwd_kernel[_mw]`` / ``_adstar_fwd_kernel_yb[_mw]`` and
  ``lagomorph_tpu/ops/pallas/padres.py`` ``_adstar_fwd_kernel_pr[_mw]``.
* K2, :func:`compose`: ``d = s * v``; ``out = d + phiinv(x + d)``, and the
  flag of ``d``.  Replaces ``epdiff_unit.py`` ``_compose_fwd_kernel[_yb]``
  and ``padres.py`` ``_compose_fwd_kernel_pr``.
* K6, K1's backward: ``(d_phiinv, d_m0)`` (``d_m0`` summed over the
  subjects for a batch-1 ``m0``).  Replaces ``epdiff_unit.py``
  ``_adstar_bwd_fused_dispatch`` and ``padres.py`` ``_adstar_bwd_pr``.
* K7, K2's backward: ``(d_phiinv, d_v)``.  Replaces ``epdiff_unit.py``
  ``_compose_bwd_fused_dispatch`` and ``padres.py`` ``_compose_bwd_pr``.

A flag is a 0-dim bool tensor on the fields' device, true iff every
component of the displacement lies in ``[-1, 1)``; reading it is the
caller's one host sync.  All four kernels are bound by memory traffic and
per-voxel arithmetic on the H100 (100.7 MB fields at 128^3 b4); see the
source for the design.
"""
from __future__ import annotations

import torch

from . import _build, check_cuda_f32, checked, grad_needed, register, stream_of, use_kernel
from .warp_unit import sample_displacement_unit_bwd_plain
from ..diff import jacobian_times_vectorfield, jacobian_times_vectorfield_adjoint
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
AD_STAR_BWD = register(
    "ad_star_bwd",
    source="lagomorph_tpu_torch/csrc/epdiff_unit.cu",
    replaces="lagomorph_tpu/ops/pallas/epdiff_unit.py:1374, 1416; lagomorph_tpu/ops/pallas/padres.py:493",
)
COMPOSE_BWD = register(
    "compose_bwd",
    source="lagomorph_tpu_torch/csrc/epdiff_unit.cu",
    replaces="lagomorph_tpu/ops/pallas/epdiff_unit.py:1884, 1923; lagomorph_tpu/ops/pallas/padres.py:523",
)


def ad_star_plain(phiinv: torch.Tensor, m0: torch.Tensor, want_mw: bool = False):
    """Plain version of K1: ``(Ad*(phiinv, m0), in_unit(phiinv))``, and the
    warped momentum ``mw`` third when ``want_mw``."""
    mw = sample_displacement_unit(m0, phiinv)
    out = jacobian_times_vectorfield(phiinv, mw, displacement=True), in_unit(phiinv)
    return (*out, mw) if want_mw else out


def compose_plain(phiinv: torch.Tensor, v: torch.Tensor, s: float):
    """Plain version of K2: ``(s*v + phiinv(x + s*v), in_unit(s*v))``."""
    d = s * v
    return d + sample_displacement_unit(phiinv, d), in_unit(d)


def _ad_star_bwd_parts(phiinv, m0, g, mw):
    d_mw = jacobian_times_vectorfield(phiinv, g, displacement=True, transpose=True)
    d_m0, d_p_w = sample_displacement_unit_bwd_plain(m0, phiinv, d_mw)
    return d_mw, d_p_w + jacobian_times_vectorfield_adjoint(g, mw), d_m0


def ad_star_bwd_plain(phiinv: torch.Tensor, m0: torch.Tensor, g: torch.Tensor,
                      mw: torch.Tensor):
    """Plain version of K6: ``(d_phiinv, d_m0)`` for the cotangent ``g`` of
    ``Ad*(phiinv, m0)``, composed as the JAX package's ``_adstar_bwd``
    (epdiff_unit.py:489-497): ``d_mw = (J + I)^T g``; ``(d_m0, d_phiinv_w)``
    = the warp's backward with cotangent ``d_mw``; ``d_phiinv = d_phiinv_w
    + sum_a D_a^T (g * mw_a)``."""
    return _ad_star_bwd_parts(phiinv, m0, g, mw)[1:]


def ad_star_bwd_first_plain(phiinv: torch.Tensor, m0: torch.Tensor, g: torch.Tensor,
                            mw: torch.Tensor):
    """Plain version of K6's first pass (the C entry point
    ``lagomorph_ad_star_bwd_first``, which timings and tests call alone):
    ``(d_mw, d_phiinv)``, as :func:`ad_star_bwd_plain` forms them."""
    return _ad_star_bwd_parts(phiinv, m0, g, mw)[:2]


def compose_bwd_plain(phiinv: torch.Tensor, v: torch.Tensor, s: float,
                      g: torch.Tensor):
    """Plain version of K7: ``(d_phiinv, d_v)`` for the cotangent ``g`` of
    ``s*v + phiinv(x + s*v)`` (epdiff_unit.py:721-725): the warp's backward
    at ``s*v`` gives ``(d_phiinv, d_d)``; ``d_v = s*g + s*d_d``."""
    d_p, d_d = sample_displacement_unit_bwd_plain(phiinv, s * v, g)
    return d_p, s * g + s * d_d


def _check(name, phiinv, other):
    check_cuda_f32(name, phiinv, other)
    if phiinv.dim() != 5 or phiinv.shape[1] != 3:
        raise ValueError(f"{name}: phiinv must be (N, 3, X, Y, Z), got {tuple(phiinv.shape)}")
    if other.dim() != 5 or other.shape[1] != 3 or other.shape[2:] != phiinv.shape[2:]:
        raise ValueError(
            f"{name}: field {tuple(other.shape)} does not match phiinv {tuple(phiinv.shape)}"
        )


def _launch_ad_star(phiinv, m0, want_mw=False):
    N, _, X, Y, Z = phiinv.shape
    out = torch.empty_like(phiinv)
    mw = torch.empty_like(phiinv) if want_mw else None
    flag = torch.ones((), dtype=torch.int32, device=phiinv.device)
    _build.call(
        "lagomorph_ad_star_fwd",
        phiinv.data_ptr(), m0.data_ptr(), out.data_ptr(),
        None if mw is None else mw.data_ptr(), flag.data_ptr(),
        N, m0.shape[0], X, Y, Z, 0, stream_of(phiinv),
    )
    AD_STAR.launches += 1
    return checked(AD_STAR, (out, flag.bool(), mw) if want_mw else (out, flag.bool()))


def _launch_compose(phiinv, v, s):
    N, _, X, Y, Z = phiinv.shape
    out = torch.empty_like(phiinv)
    flag = torch.ones((), dtype=torch.int32, device=phiinv.device)
    _build.call(
        "lagomorph_compose_fwd",
        phiinv.data_ptr(), v.data_ptr(), float(s), out.data_ptr(), flag.data_ptr(),
        N, X, Y, Z, 0, stream_of(phiinv),
    )
    COMPOSE.launches += 1
    return checked(COMPOSE, (out, flag.bool()))


def _launch_ad_star_bwd(phiinv, m0, g, mw):
    N, _, X, Y, Z = phiinv.shape
    d_mw = torch.empty_like(phiinv)  # scratch of the first pass
    d_p = torch.empty_like(phiinv)
    d_m0 = torch.empty_like(m0)
    _build.call(
        "lagomorph_ad_star_bwd",
        phiinv.data_ptr(), m0.data_ptr(), g.data_ptr(), mw.data_ptr(),
        d_mw.data_ptr(), d_p.data_ptr(), d_m0.data_ptr(),
        N, m0.shape[0], X, Y, Z, stream_of(phiinv),
    )
    AD_STAR_BWD.launches += 1
    return checked(AD_STAR_BWD, (d_p, d_m0))


def _launch_compose_bwd(phiinv, v, s, g):
    N, _, X, Y, Z = phiinv.shape
    d_p = torch.empty_like(phiinv)
    d_v = torch.empty_like(v)
    _build.call(
        "lagomorph_compose_bwd",
        phiinv.data_ptr(), v.data_ptr(), float(s), g.data_ptr(), d_p.data_ptr(),
        d_v.data_ptr(), N, X, Y, Z, stream_of(phiinv),
    )
    COMPOSE_BWD.launches += 1
    return checked(COMPOSE_BWD, (d_p, d_v))


class _AdStar(torch.autograd.Function):
    """K1 (writing ``mw``) under autograd; its backward is K6."""

    @staticmethod
    def forward(ctx, phiinv, m0):
        out, flag, mw = _launch_ad_star(phiinv, m0, want_mw=True)
        ctx.mark_non_differentiable(flag)
        ctx.save_for_backward(phiinv, m0, mw)
        return out, flag

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _g_flag):
        phiinv, m0, mw = ctx.saved_tensors
        return _launch_ad_star_bwd(phiinv, m0, g.contiguous(), mw)


class _Compose(torch.autograd.Function):
    """K2 under autograd; its backward is K7."""

    @staticmethod
    def forward(ctx, phiinv, v, s):
        out, flag = _launch_compose(phiinv, v, s)
        ctx.mark_non_differentiable(flag)
        ctx.save_for_backward(phiinv, v)
        ctx.s = s
        return out, flag

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _g_flag):
        phiinv, v = ctx.saved_tensors
        return (*_launch_compose_bwd(phiinv, v, ctx.s, g.contiguous()), None)


def ad_star(phiinv: torch.Tensor, m0: torch.Tensor):
    """K1: ``(Ad*(phiinv, m0), flag of phiinv)`` for 3D fields; ``m0`` may
    have batch 1.  The result is exact where the flag is true; under
    autograd its backward is K6."""
    if not use_kernel(phiinv):
        return checked(AD_STAR, ad_star_plain(phiinv, m0))
    _check("ad_star", phiinv, m0)
    if m0.shape[0] not in (1, phiinv.shape[0]):
        raise ValueError(f"ad_star: m0 batch {m0.shape[0]} vs phiinv {phiinv.shape[0]}")
    if grad_needed(phiinv, m0):
        return _AdStar.apply(phiinv, m0)
    return _launch_ad_star(phiinv, m0)


def compose(phiinv: torch.Tensor, v: torch.Tensor, s: float):
    """K2: ``(s*v + phiinv(x + s*v), flag of s*v)`` for 3D fields of equal
    batch.  The result is exact where the flag is true; under autograd its
    backward is K7."""
    if not use_kernel(phiinv):
        return checked(COMPOSE, compose_plain(phiinv, v, s))
    _check("compose", phiinv, v)
    if v.shape[0] != phiinv.shape[0]:
        raise ValueError(f"compose: v batch {v.shape[0]} vs phiinv {phiinv.shape[0]}")
    if grad_needed(phiinv, v):
        return _Compose.apply(phiinv, v, float(s))
    return _launch_compose(phiinv, v, s)
