"""K8 and K9: the whole 2D shooting in one launch, forward and backward
(``csrc/shoot2d.cu``).

* K8, :func:`shoot2d`: ``T`` Euler substeps of 2D EPDiff from ``phiinv0``
  and ``m0`` with step ``s`` (``= -dt``): ``m = Ad*(phiinv, m0)``, ``v =
  K(m)`` (the fluid solve for ``beta == 0``, the two channels packed as one
  complex plane), ``phiinv <- s v + phiinv(x + s v)``, with the
  unit-regime flag of ``phiinv`` entering every substep and of ``s v``.
  Under autograd it also stashes the trajectory ``(phiinv_t, v_t, mw_t)``.
  Replaces ``lagomorph_tpu/ops/pallas/shoot2d.py`` ``_shoot_fwd_kernel``
  (``_shoot_fwd_dispatch``).
* K9, its backward: the reverse sweep over the stash, giving ``d_phiinv0``
  and ``d_m0`` (summed over the subjects for a batch-1 ``m0``).  Replaces
  ``shoot2d.py`` ``_shoot_bwd_kernel`` (``_shoot_bwd_dispatch``).

Each is one cooperative launch whose phases are separated by grid-wide
barriers; both are bound by the bytes of their fields and stash on the
H100.  K8 takes three barriers a substep (Ad* and the row transform, the
columns, the inverse rows and compose).  K9 takes three barriers a reverse
step: its last phase transforms a halo row on each side of its tile, so dm
and d_mw stay in shared memory (a batch-1 ``m0`` adds a phase that sums
``d_m0`` over the subjects from a d_mw field).  See the source for the
design.  The plain versions (:func:`shoot2d_fwd_plain`,
:func:`shoot2d_bwd_plain`) run the same substeps on the plain 2D stencils
and a ``torch.fft`` packed solve.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, check_cuda_f32, checked, grad_needed, register, stream_of, use_kernel
from .epdiff_unit import ad_star_bwd_plain, ad_star_plain, compose_bwd_plain, compose_plain

FWD = register(
    "shoot2d_fwd",
    source="lagomorph_tpu_torch/csrc/shoot2d.cu",
    replaces="lagomorph_tpu/ops/pallas/shoot2d.py:540",
)
BWD = register(
    "shoot2d_bwd",
    source="lagomorph_tpu_torch/csrc/shoot2d.cu",
    replaces="lagomorph_tpu/ops/pallas/shoot2d.py:569",
)


def fluid2d_plain(m: torch.Tensor, Mn: torch.Tensor) -> torch.Tensor:
    """The packed-pair fluid solve of a ``(N, 2, H, W)`` field:
    ``v_0 + i v_1 = ifft2(Mn * fft2(m_0 + i m_1))`` (``Mn``: the
    full-spectrum scalar multiplier, real and even in k)."""
    c = torch.complex(m[:, 0], m[:, 1])
    y = torch.fft.ifftn(torch.fft.fftn(c, dim=(1, 2)) * Mn, dim=(1, 2))
    return torch.stack([y.real, y.imag], dim=1)


def shoot2d_fwd_plain(phiinv0: torch.Tensor, m0: torch.Tensor, Mn: torch.Tensor, s: float,
                      T: int, stash: bool = True):
    """Plain version of K8: ``(phiinv_T, ok)``, and the trajectories
    ``traj_p, traj_v, traj_mw`` (each ``(T, N, 2, H, W)``: ``phiinv_t``
    entering substep t, its velocity, its warped momentum) after them when
    ``stash``."""
    phi = phiinv0
    ok = torch.ones((), dtype=torch.bool, device=phiinv0.device)
    traj = ([], [], [])
    for _ in range(T):
        m, f_transport, mw = ad_star_plain(phi, m0, want_mw=True)
        v = fluid2d_plain(m, Mn)
        nxt, f_compose = compose_plain(phi, v, s)
        ok = ok & f_transport & f_compose
        if stash:
            for lst, x in zip(traj, (phi, v, mw)):
                lst.append(x)
        phi = nxt
    if not stash:
        return phi, ok
    return (phi, ok, *(torch.stack(lst) for lst in traj))


def shoot2d_bwd_plain(m0: torch.Tensor, g: torch.Tensor, traj_p: torch.Tensor,
                      traj_v: torch.Tensor, traj_mw: torch.Tensor, Mn: torch.Tensor, s: float):
    """Plain version of K9: ``(d_phiinv0, d_m0)`` for the cotangent ``g`` of
    ``phiinv_T``, by the reverse sweep over the trajectories of
    :func:`shoot2d_fwd_plain` (compose backward, the self-adjoint fluid
    solve, Ad* backward; shoot2d.py:447-456)."""
    d_m0 = None
    for t in reversed(range(traj_p.shape[0])):
        d_p, d_v = compose_bwd_plain(traj_p[t], traj_v[t], s, g)
        d_pa, d_m0_t = ad_star_bwd_plain(traj_p[t], m0, fluid2d_plain(d_v, Mn), traj_mw[t])
        g = d_p + d_pa
        d_m0 = d_m0_t if d_m0 is None else d_m0 + d_m0_t
    return g, d_m0


def _launch_fwd(phiinv0, m0, Mn, s, T, stash, tile=0):
    """K8: ``(phiinv_T, ok)``, and the trajectories after them when
    ``stash``.  ``tile``: the tile height (0: the kernel's choice,
    :func:`fwd_launch_config`)."""
    N, _, H, W = phiinv0.shape
    out = torch.empty_like(phiinv0)
    flag = torch.ones((), dtype=torch.int32, device=phiinv0.device)
    cbuf = torch.empty((N, H, W, 2), dtype=phiinv0.dtype, device=phiinv0.device)
    if stash:
        traj = [torch.empty((T,) + tuple(phiinv0.shape), dtype=phiinv0.dtype,
                            device=phiinv0.device) for _ in range(3)]
        pp = None
    else:  # two planes for phiinv_t to ping-pong between
        traj = [None] * 3
        pp = torch.empty((2,) + tuple(phiinv0.shape), dtype=phiinv0.dtype, device=phiinv0.device)
    _build.call(
        "lagomorph_shoot2d_fwd",
        phiinv0.data_ptr(), m0.data_ptr(), Mn.data_ptr(), out.data_ptr(), flag.data_ptr(),
        *(None if x is None else x.data_ptr() for x in traj),
        None if pp is None else pp.data_ptr(), cbuf.data_ptr(),
        N, m0.shape[0], H, W, int(T), float(s), int(tile), stream_of(phiinv0),
    )
    FWD.launches += 1
    checked(FWD, out)  # the trajectories are the backward's stash
    return (out, flag.bool(), *traj) if stash else (out, flag.bool())


def _launch_bwd(m0, g, traj_p, traj_v, traj_mw, Mn, s, tile=0):
    """K9: ``(d_phiinv0, d_m0)``.  ``tile``: the tile height (0: the
    kernel's choice, :func:`bwd_launch_config`)."""
    T, N, _, H, W = traj_p.shape
    Nm = m0.shape[0]
    d_m0 = torch.empty_like(m0)
    d_phi0 = torch.empty_like(g)
    cbuf = torch.empty((N, H, W, 2), dtype=g.dtype, device=g.device)
    # a batch-1 m0 of several subjects sums d_m0 over them from a d_mw field
    dmw = torch.empty_like(g) if Nm != N else None
    gbuf = torch.empty((2,) + tuple(g.shape), dtype=g.dtype, device=g.device)
    _build.call(
        "lagomorph_shoot2d_bwd",
        m0.data_ptr(), g.data_ptr(), Mn.data_ptr(), traj_p.data_ptr(), traj_v.data_ptr(),
        traj_mw.data_ptr(), d_m0.data_ptr(), d_phi0.data_ptr(), cbuf.data_ptr(),
        None if dmw is None else dmw.data_ptr(), gbuf.data_ptr(),
        N, Nm, H, W, T, float(s), int(tile), stream_of(g),
    )
    BWD.launches += 1
    return checked(BWD, (d_phi0, d_m0))


def _launch_config(entry, N, H, W, tile):
    out = (ctypes.c_int * 8)()
    _build.call(entry, N, H, W, int(tile), ctypes.cast(out, ctypes.c_void_p))
    return {"path": "register" if out[0] else "tile", "tile": out[1], "blocks": out[2],
            "threads": out[3], "smem": out[4], "tiles": tuple(out[5:8])}


def fwd_launch_config(N: int, H: int, W: int, tile: int = 0) -> dict:
    """The launch K8 makes for ``N`` subjects of ``(H, W)`` on the current
    card, as :func:`bwd_launch_config` gives K9's; its phases' tiles are
    those of A, B and C (row tiles of ``tile`` rows, column tiles of
    ``tile`` columns).  The two kernels' launches come from one chooser."""
    return _launch_config("lagomorph_shoot2d_fwd_grid", N, H, W, tile)


def bwd_launch_config(N: int, H: int, W: int, tile: int = 0) -> dict:
    """The launch K9 makes for ``N`` subjects of ``(H, W)`` on the current
    card: its path (``"register"``: H and W powers of two from 32 to 256;
    else ``"tile"``), the tile height, the cooperative grid's blocks, the
    threads of a block, its dynamic shared memory in bytes and the tiles of
    its three phases.  Builds the kernels on first use; launches nothing."""
    return _launch_config("lagomorph_shoot2d_bwd_grid", N, H, W, tile)


class _Shoot2d(torch.autograd.Function):
    """K8 (with the stash) under autograd; its backward is K9.  The flag is
    an indicator output: non-differentiable, its cotangent ignored
    (shoot2d.py:605-609)."""

    @staticmethod
    def forward(ctx, phiinv0, m0, Mn, s, T):
        out, flag, traj_p, traj_v, traj_mw = _launch_fwd(phiinv0, m0, Mn, s, T, True)
        ctx.mark_non_differentiable(flag)
        ctx.save_for_backward(m0, Mn, traj_p, traj_v, traj_mw)
        ctx.s = s
        return out, flag

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _g_flag):
        m0, Mn, traj_p, traj_v, traj_mw = ctx.saved_tensors
        d_phi0, d_m0 = _launch_bwd(m0, g.contiguous(), traj_p, traj_v, traj_mw, Mn, ctx.s)
        return d_phi0, d_m0, None, None, None


def shoot2d(phiinv0: torch.Tensor, m0: torch.Tensor, Mn: torch.Tensor, s: float, T: int):
    """K8: ``T`` substeps of 2D EPDiff with step ``s`` from ``phiinv0``
    (``(N, 2, H, W)``) and ``m0`` (batch 1 or N): ``(phiinv_T, ok)``, ``ok``
    a 0-dim bool tensor, true iff every warp displacement of the
    trajectory lay in ``[-1, 1)``; the result is exact where it is true.
    ``Mn``: the full-spectrum ``(H, W)`` multiplier of the sharp operator
    (``beta == 0``).  The kernel on CUDA (differentiable through K9), the
    plain version on the CPU."""
    if not use_kernel(phiinv0):
        return checked(FWD, shoot2d_fwd_plain(phiinv0, m0, Mn, s, T, stash=False))
    check_cuda_f32("shoot2d", phiinv0, m0, Mn)
    if phiinv0.dim() != 4 or phiinv0.shape[1] != 2 or min(phiinv0.shape[2:]) < 2:
        raise ValueError(f"shoot2d: phiinv0 must be (N, 2, H, W), H, W >= 2, got "
                         f"{tuple(phiinv0.shape)}")
    if (m0.dim() != 4 or m0.shape[1] != 2 or m0.shape[0] not in (1, phiinv0.shape[0])
            or m0.shape[2:] != phiinv0.shape[2:]):
        raise ValueError(f"shoot2d: m0 {tuple(m0.shape)} does not match {tuple(phiinv0.shape)}")
    if tuple(Mn.shape) != tuple(phiinv0.shape[2:]) or int(T) < 1:
        raise ValueError(f"shoot2d: Mn {tuple(Mn.shape)}, T {T}")
    if grad_needed(phiinv0, m0):
        return _Shoot2d.apply(phiinv0, m0, Mn, float(s), int(T))
    return _launch_fwd(phiinv0, m0, Mn, s, T, False)
