"""K10-K13: the two stencil steps of one 2D EPDiff substep, each with the
unit-regime flag of its warp displacement, and their backwards
(``csrc/epdiff2d.cu``).  They carry the 2D shootings that the whole-shoot
kernels K8/K9 do not take (a momentum mask, ``beta != 0``) and the
unit-regime substeps of the exact general integration.

* K10, :func:`ad_star2d`: ``out_c = sum_a (D_a phiinv_c + delta_ca) *
  mw_a`` with ``mw = sample_displacement_unit(m0, phiinv)``, and
  the flag of ``phiinv``; under autograd it also writes ``mw`` for the
  backward.  Replaces ``lagomorph_tpu/ops/pallas/epdiff2d.py``
  ``_adstar2d_fwd_kernel`` (``_adstar2d_fwd_dispatch``).
* K11, :func:`compose2d`: ``d = s * v``; ``out = d + phiinv(x + d)``, and
  the flag of ``d``.  Replaces ``epdiff2d.py`` ``_compose2d_fwd_kernel``
  (``compose2d_pallas``).
* K12, K10's backward: ``(d_phiinv, d_m0)`` (``d_m0`` summed over the
  subjects for a batch-1 ``m0``).  Replaces ``epdiff2d.py``
  ``_adstar2d_bwd_kernel`` (``_adstar2d_bwd``).
* K13, K11's backward: ``(d_phiinv, d_v)``.  Replaces ``epdiff2d.py``
  ``_compose2d_bwd_kernel`` (``_compose2d_bwd``).

Fields are ``(N, 2, H, W)``, any ``H, W >= 2``.  A flag is a 0-dim bool
tensor on the fields' device, true iff every component of the displacement
lies in ``[-1, 1)``.  The plain versions are the 3D ones' formulas, which
hold in any dimension; see the source for the kernels' design.

K10 and K11 run on column strips (:func:`fwd_route`): a warp's lanes own
consecutive strips of 1, 2 or 4 columns of a row and march down a band of
rows, holding three rows of their stencil's inputs in register rings (the
halo columns shuffled between lanes) and summing the warp's 4 live taps;
:func:`fwd_launch_config` reports the strip width and band height chosen
for a shape.  Fields of ``2**31`` elements or more, and ``march``
:data:`THREAD`, take one thread a pixel over the 9 taps, with the same
bits.

K12 takes one of two routes (:func:`bwd_route`): for batch-N momenta, row
tiles staged in shared memory with a halo row on each side, one launch; for
a batch-1 ``m0``, or where a tile of one row does not fit a block's shared
memory or a field has ``2**31`` elements or more, one thread a pixel in two
launches through a ``d_mw`` field (the second sums ``d_m0`` over the
subjects for a batch-1 ``m0``).  For batch-N momenta the two give the same
bits.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, check_cuda_f32, grad_needed, register, stream_of, use_kernel
from .epdiff_unit import ad_star_bwd_plain, ad_star_plain, compose_bwd_plain, compose_plain

AD_STAR = register(
    "ad_star2d_fwd",
    source="lagomorph_tpu_torch/csrc/epdiff2d.cu",
    replaces="lagomorph_tpu/ops/pallas/epdiff2d.py:281",
)
COMPOSE = register(
    "compose2d_fwd",
    source="lagomorph_tpu_torch/csrc/epdiff2d.cu",
    replaces="lagomorph_tpu/ops/pallas/epdiff2d.py:456",
)
AD_STAR_BWD = register(
    "ad_star2d_bwd",
    source="lagomorph_tpu_torch/csrc/epdiff2d.cu",
    replaces="lagomorph_tpu/ops/pallas/epdiff2d.py:324",
)
COMPOSE_BWD = register(
    "compose2d_bwd",
    source="lagomorph_tpu_torch/csrc/epdiff2d.cu",
    replaces="lagomorph_tpu/ops/pallas/epdiff2d.py:490",
)


def ad_star2d_plain(phiinv: torch.Tensor, m0: torch.Tensor, want_mw: bool = False):
    """Plain version of K10: ``(Ad*(phiinv, m0), in_unit(phiinv))``, and the
    warped momentum ``mw`` third when ``want_mw``."""
    return ad_star_plain(phiinv, m0, want_mw)


def compose2d_plain(phiinv: torch.Tensor, v: torch.Tensor, s: float):
    """Plain version of K11: ``(s*v + phiinv(x + s*v), in_unit(s*v))``."""
    return compose_plain(phiinv, v, s)


def ad_star2d_bwd_plain(phiinv: torch.Tensor, m0: torch.Tensor, g: torch.Tensor,
                        mw: torch.Tensor):
    """Plain version of K12: ``(d_phiinv, d_m0)`` for the cotangent ``g``:
    ``d_mw = (J + I)^T g``; the warp's backward with cotangent ``d_mw`` gives
    ``d_m0`` and the weight-gradient term; plus ``sum_a D_a^T (g * mw_a)``."""
    return ad_star_bwd_plain(phiinv, m0, g, mw)


def compose2d_bwd_plain(phiinv: torch.Tensor, v: torch.Tensor, s: float, g: torch.Tensor):
    """Plain version of K13: ``(d_phiinv, d_v)`` for the cotangent ``g``: the
    warp's backward at ``s*v`` gives ``(d_phiinv, d_d)``; ``d_v = s*g +
    s*d_d``."""
    return compose_bwd_plain(phiinv, v, s, g)


def _check(name, phiinv, other):
    check_cuda_f32(name, phiinv, other)
    if phiinv.dim() != 4 or phiinv.shape[1] != 2 or min(phiinv.shape[2:]) < 2:
        raise ValueError(f"{name}: phiinv must be (N, 2, H, W), H, W >= 2, got "
                         f"{tuple(phiinv.shape)}")
    if other.dim() != 4 or other.shape[1] != 2 or other.shape[2:] != phiinv.shape[2:]:
        raise ValueError(
            f"{name}: field {tuple(other.shape)} does not match phiinv {tuple(phiinv.shape)}"
        )


THREAD = -1  # the ``march`` of K10's and K11's, and the ``tile`` of K12's, per-thread route


def fwd_route(N: int, H: int, W: int) -> str:
    """The route K10 and K11 take for ``N`` subjects of ``(H, W)``:
    ``"march"`` (column strips marching down bands of rows, int indices)
    where the fields hold fewer than ``2**31`` elements, else ``"thread"``."""
    return "march" if 2 * N * H * W < 2**31 else "thread"


def _march(march, N, H, W):
    return march if march is not None else (0 if fwd_route(N, H, W) == "march" else THREAD)


def _launch_ad_star(phiinv, m0, want_mw=False, march=None):
    """K10: ``(out, flag)``, and ``mw`` third when ``want_mw``.  ``march``:
    0 the strips' chooser (:func:`fwd_launch_config`), > 0 bands of that many
    rows, :data:`THREAD` the per-thread kernel; by default the route
    :func:`fwd_route` names (the strips refuse fields of ``2**31`` elements
    or more)."""
    N, _, H, W = phiinv.shape
    march = _march(march, N, H, W)
    out = torch.empty_like(phiinv)
    mw = torch.empty_like(phiinv) if want_mw else None
    flag = torch.ones((), dtype=torch.int32, device=phiinv.device)
    _build.call(
        "lagomorph_ad_star2d_fwd",
        phiinv.data_ptr(), m0.data_ptr(), out.data_ptr(),
        None if mw is None else mw.data_ptr(), flag.data_ptr(),
        N, m0.shape[0], H, W, int(march), stream_of(phiinv),
    )
    AD_STAR.launches += 1
    return (out, flag.bool(), mw) if want_mw else (out, flag.bool())


def _launch_compose(phiinv, v, s, march=None):
    """K11: ``(out, flag)``; ``march`` as :func:`_launch_ad_star`'s."""
    N, _, H, W = phiinv.shape
    march = _march(march, N, H, W)
    out = torch.empty_like(phiinv)
    flag = torch.ones((), dtype=torch.int32, device=phiinv.device)
    _build.call(
        "lagomorph_compose2d_fwd",
        phiinv.data_ptr(), v.data_ptr(), float(s), out.data_ptr(), flag.data_ptr(),
        N, H, W, int(march), stream_of(phiinv),
    )
    COMPOSE.launches += 1
    return out, flag.bool()


def fwd_launch_config(kernel: str, N: int, H: int, W: int, march: int = 0) -> dict:
    """The launch K10 (``kernel`` ``"ad_star2d_fwd"``) or K11
    (``"compose2d_fwd"``) makes on its strips for ``N`` subjects of ``(H,
    W)`` on the current card: the strip's columns ``px``, the band's rows
    ``rj`` (``march`` if > 0), the blocks of 256 threads (a warp a band of
    one subject's row strips) and the blocks an SM holds of that kernel.
    Builds the kernels on first use; launches nothing."""
    out = (ctypes.c_int * 4)()
    _build.call("lagomorph_epdiff2d_fwd_grid", 0 if kernel == "ad_star2d_fwd" else 1, N, H, W,
                int(march), ctypes.cast(out, ctypes.c_void_p))
    return {"px": out[0], "rj": out[1], "blocks": out[2], "threads": 256, "per_sm": out[3]}

_MAX_SMEM = 227 * 1024  # a block's shared memory on the H100
_STAGE_PIXEL = 32  # K12's staged pixel: its packed weights, g and d_mw


def bwd_route(N: int, Nm: int, H: int, W: int) -> str:
    """The route K12 takes for ``N`` subjects of ``(H, W)`` and an ``m0`` of
    batch ``Nm``: ``"tile"`` for batch-N momenta where the stage of one row
    and its two halo rows fits a block's shared memory and the fields hold
    fewer than ``2**31`` elements (the tile kernel's int indices), else
    ``"thread"``."""
    fits = 3 * W * _STAGE_PIXEL <= _MAX_SMEM and 2 * N * H * W < 2**31
    return "tile" if fits and Nm == N else "thread"


def _launch_ad_star_bwd(phiinv, m0, g, mw, tile=None):
    """K12: ``(d_phiinv, d_m0)``.  ``tile``: the tile height (0: the
    kernel's choice, :func:`bwd_launch_config`; batch-N ``m0`` only) or
    :data:`THREAD` (the per-thread route); by default the route
    :func:`bwd_route` names."""
    N, _, H, W = phiinv.shape
    if tile is None:
        tile = 0 if bwd_route(N, m0.shape[0], H, W) == "tile" else THREAD
    d_mw = torch.empty_like(phiinv) if tile < 0 else None  # the per-thread passes' scratch
    d_p = torch.empty_like(phiinv)
    d_m0 = torch.empty_like(m0)
    _build.call(
        "lagomorph_ad_star2d_bwd",
        phiinv.data_ptr(), m0.data_ptr(), g.data_ptr(), mw.data_ptr(),
        None if d_mw is None else d_mw.data_ptr(), d_p.data_ptr(), d_m0.data_ptr(),
        N, m0.shape[0], H, W, int(tile), stream_of(phiinv),
    )
    AD_STAR_BWD.launches += 1
    return d_p, d_m0


def _launch_compose_bwd(phiinv, v, s, g):
    N, _, H, W = phiinv.shape
    d_p = torch.empty_like(phiinv)
    d_v = torch.empty_like(v)
    _build.call(
        "lagomorph_compose2d_bwd",
        phiinv.data_ptr(), v.data_ptr(), float(s), g.data_ptr(), d_p.data_ptr(),
        d_v.data_ptr(), N, H, W, stream_of(phiinv),
    )
    COMPOSE_BWD.launches += 1
    return d_p, d_v


def bwd_launch_config(N: int, H: int, W: int, tile: int = 0) -> dict:
    """The launch K12 makes on its tiles for ``N`` subjects of ``(H, W)``
    on the current card: the tile height (one block of 256 threads a tile,
    a halo row staged on each side of its rows), the blocks and the dynamic
    shared memory in bytes.  Builds the kernels on first use; launches
    nothing."""
    out = (ctypes.c_int * 3)()
    _build.call("lagomorph_ad_star2d_bwd_grid", N, H, W, int(tile),
                ctypes.cast(out, ctypes.c_void_p))
    return {"tile": out[0], "blocks": out[1], "threads": 256, "smem": out[2]}


class _AdStar2d(torch.autograd.Function):
    """K10 (writing ``mw``) under autograd; its backward is K12."""

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


class _Compose2d(torch.autograd.Function):
    """K11 under autograd; its backward is K13."""

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


def ad_star2d(phiinv: torch.Tensor, m0: torch.Tensor):
    """K10: ``(Ad*(phiinv, m0), flag of phiinv)`` for 2D fields; ``m0`` may
    have batch 1.  The result is exact where the flag is true; under
    autograd its backward is K12."""
    if not use_kernel(phiinv):
        return ad_star2d_plain(phiinv, m0)
    _check("ad_star2d", phiinv, m0)
    if m0.shape[0] not in (1, phiinv.shape[0]):
        raise ValueError(f"ad_star2d: m0 batch {m0.shape[0]} vs phiinv {phiinv.shape[0]}")
    if grad_needed(phiinv, m0):
        return _AdStar2d.apply(phiinv, m0)
    return _launch_ad_star(phiinv, m0)


def compose2d(phiinv: torch.Tensor, v: torch.Tensor, s: float):
    """K11: ``(s*v + phiinv(x + s*v), flag of s*v)`` for 2D fields of equal
    batch.  The result is exact where the flag is true; under autograd its
    backward is K13."""
    if not use_kernel(phiinv):
        return compose2d_plain(phiinv, v, s)
    _check("compose2d", phiinv, v)
    if v.shape[0] != phiinv.shape[0]:
        raise ValueError(f"compose2d: v batch {v.shape[0]} vs phiinv {phiinv.shape[0]}")
    if grad_needed(phiinv, v):
        return _Compose2d.apply(phiinv, v, float(s))
    return _launch_compose(phiinv, v, s)
