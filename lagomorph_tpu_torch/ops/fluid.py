"""Fourier-domain fluid (Helmholtz-type) vector operator.

Port of ``lagomorph_tpu/ops/fluid.py``.  The operator
``L = (-alpha * Laplacian - beta * grad div + gamma)^2`` acts per spatial
frequency ``k`` as a small real symmetric ``d x d`` matrix built from the
discrete eigenvalues ``w_a = 2 (1 - cos(2 pi k_a / N_a))`` and
``s_a = sin(2 pi k_a / N_a)``::

    lambda  = gamma + alpha * sum_a w_a
    l[a][a] = lambda - beta * w_a
    l[a][b] = beta * s_a * s_b          (a != b)
    L       = l @ l

``flat`` multiplies Fourier coefficients by ``L``; ``sharp`` applies the
floored-Cholesky solve whose pivots are ``safe_sqrt`` (``sqrt(x)``, but
``1e-4`` whenever ``x < 1e-8``).

Two paths, chosen by the parameters alone:

* ``beta == 0`` in 3D: the multiplier is one scalar field, so the ``B * d``
  component slabs are packed in complex pairs and solved by kernel K3
  (:func:`.kernels.fft_unit.fluid_flat`; its ``torch.fft`` plain version on
  the CPU).  An odd slab count pads one zero slab.
* otherwise: ``rfftn`` -> per-frequency ``d x d`` product -> ``irfftn``
  (``norm="ortho"``), plain PyTorch on every device, as the JAX package
  leaves this case to XLA's FFT.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels import fft_unit


def fluid_multiplier(spatial, params, inverse: bool, dtype=np.float32) -> np.ndarray:
    """The per-frequency multiplier as one numpy array ``M[d, d,
    *half_spectrum]`` (the layout of the JAX package's ``fluid_multiplier``),
    built in float64 by :func:`fluid_multiplier_entries` and cast to
    ``dtype``."""
    d = len(spatial)
    ent = fluid_multiplier_entries(tuple(spatial), params, inverse, torch.float64,
                                   device="cpu")
    M = torch.stack([torch.stack([ent[max(i, j), min(i, j)] for j in range(d)])
                     for i in range(d)])
    return M.numpy().astype(dtype)


def _inv_safe_sqrt(x):
    """``1 / safe_sqrt(x)``: ``safe_sqrt`` is ``sqrt(x)``, but ``1e-4``
    whenever ``x < 1e-8`` (the floored pivot)."""
    return 1.0 / torch.where(x < 1e-8, torch.full_like(x, 1e-4),
                             torch.sqrt(torch.clamp(x, min=1e-8)))


def _cholesky_inverse(L, d):
    """Entries ``{(a, b): M_ab}`` (a >= b) of the matrix applied by the
    floored-Cholesky solve of the symmetric ``L`` (entries keyed a >= b)."""
    one = torch.ones_like(L[(0, 0)])
    zero = torch.zeros_like(L[(0, 0)])
    if d == 2:
        ooG00 = _inv_safe_sqrt(L[(0, 0)])
        G10 = L[(1, 0)] * ooG00
        ooG11 = _inv_safe_sqrt(L[(1, 1)] - G10 * G10)

        def solve(b0, b1):
            y0 = b0 * ooG00
            y1 = (b1 - G10 * y0) * ooG11
            x1 = y1 * ooG11
            x0 = (y0 - G10 * x1) * ooG00
            return x0, x1

        c00, c10 = solve(one, zero)
        _, c11 = solve(zero, one)
        return {(0, 0): c00, (1, 0): c10, (1, 1): c11}
    if d == 3:
        ooG00 = _inv_safe_sqrt(L[(0, 0)])
        G10 = L[(1, 0)] * ooG00
        G20 = L[(2, 0)] * ooG00
        ooG11 = _inv_safe_sqrt(L[(1, 1)] - G10 * G10)
        G21 = (L[(2, 1)] - G20 * G10) * ooG11
        ooG22 = _inv_safe_sqrt(L[(2, 2)] - G20 * G20 - G21 * G21)

        def solve(b0, b1, b2):
            y0 = b0 * ooG00
            y1 = (b1 - G10 * y0) * ooG11
            y2 = (b2 - G20 * y0 - G21 * y1) * ooG22
            x2 = y2 * ooG22
            x1 = (y1 - G21 * x2) * ooG11
            x0 = (y0 - G10 * x1 - G20 * x2) * ooG00
            return x0, x1, x2

        c00, c10, c20 = solve(one, zero, zero)
        _, c11, c21 = solve(zero, one, zero)
        _, _, c22 = solve(zero, zero, one)
        return {(0, 0): c00, (1, 0): c10, (1, 1): c11,
                (2, 0): c20, (2, 1): c21, (2, 2): c22}
    raise ValueError("Only 2D and 3D fluid operators are supported")


def fluid_multiplier_entries(spatial, params, inverse, dtype=torch.float32,
                             device=None, full_spectrum=False):
    """The per-frequency multiplier as torch tensors: a dict
    ``{(a, b): M_ab}`` (``a >= b``) of the symmetric matrix entries, each of
    the half-spectrum shape (or of ``spatial`` with ``full_spectrum``, the
    layout of the complex packed path).  Built in float64 on ``device`` and
    cast to ``dtype``."""
    alpha, beta, gamma = (float(p) for p in params)
    d = len(spatial)
    freq_shape = (
        tuple(spatial) if full_spectrum
        else tuple(spatial[:-1]) + (spatial[-1] // 2 + 1,)
    )
    f64 = dict(dtype=torch.float64, device=device)
    ws, ss = [], []
    for a in range(d):
        k = torch.arange(freq_shape[a], **f64)
        shape = [1] * d
        shape[a] = freq_shape[a]
        ang = 2.0 * np.pi * k / spatial[a]
        ws.append((2.0 * (1.0 - torch.cos(ang))).reshape(shape).expand(freq_shape))
        ss.append(torch.sin(ang).reshape(shape).expand(freq_shape))
    lam = gamma + alpha * sum(ws)
    l = {}
    for a in range(d):
        l[(a, a)] = lam - beta * ws[a]
        for b in range(a):
            l[(a, b)] = beta * (ss[a] * ss[b])

    def lget(a, b):
        return l[(a, b)] if a >= b else l[(b, a)]

    L = {}
    for a in range(d):
        for b in range(a + 1):
            acc = None
            for c in range(d):
                term = lget(a, c) * lget(c, b)
                acc = term if acc is None else acc + term
            L[(a, b)] = acc
    if inverse:
        L = _cholesky_inverse(L, d)
    return {key: val.to(dtype).contiguous() for key, val in L.items()}


def flat_path(shape, params) -> bool:
    """True when ``fluid_operator`` on a ``(B, d, *spatial)`` field takes the
    packed scalar-multiplier path (kernel K3): 3D with ``beta == 0``."""
    return len(shape) == 5 and float(params[1]) == 0.0


def fluid_operator(mv: torch.Tensor, params, inverse: bool, M=None) -> torch.Tensor:
    """Apply the fluid operator (``inverse=False``) or its floored-Cholesky
    inverse to a batch of vector fields ``mv`` of shape ``(N, dim,
    *spatial)``.

    ``M``: the multiplier to use, as :func:`fluid_multiplier_entries` builds
    it for this path (the full-spectrum ``(0, 0)`` entry for the packed path,
    the half-spectrum entries otherwise); built here when None."""
    B, dim = mv.shape[:2]
    spatial = tuple(mv.shape[2:])
    if dim != len(spatial):
        raise ValueError("Vector field has incorrect shape for dimension")
    if flat_path(mv.shape, params):
        if M is None:
            M = fluid_multiplier_entries(spatial, params, inverse, mv.dtype,
                                         mv.device, full_spectrum=True)[(0, 0)]
        n = B * dim
        x = mv.reshape((n,) + spatial)
        if n % 2:
            x = torch.cat([x, x.new_zeros((1,) + spatial)])
        return fft_unit.fluid_flat(x, M)[:n].reshape(mv.shape)
    if M is None:
        M = fluid_multiplier_entries(spatial, params, inverse, mv.dtype, mv.device)
    axes = tuple(range(2, 2 + dim))
    F = torch.fft.rfftn(mv, dim=axes, norm="ortho")

    def mget(a, b):
        return M[(a, b)] if a >= b else M[(b, a)]

    rows = []
    for a in range(dim):
        acc = None
        for b in range(dim):
            term = mget(a, b)[None] * F[:, b]
            acc = term if acc is None else acc + term
        rows.append(acc)
    F = torch.stack(rows, dim=1)
    return torch.fft.irfftn(F, s=spatial, dim=axes, norm="ortho")

