"""Plain float64 reference of one LDDMM atlas iteration, written from the
semantics of the ``lddmm atlas`` command (upstream lagomorph's), not from
the port's code.  It imports nothing of the port nor of the JAX package.

Semantics followed:

* fields are ``(N, d, *spatial)``, voxel units, ``d`` = 2 or 3;
* the fluid metric ``L = (-alpha Laplacian - beta grad div + gamma)^2`` acts
  per discrete frequency as ``l @ l`` with ``w_a = 2 (1 - cos(2 pi k_a /
  N_a))``, ``s_a = sin(2 pi k_a / N_a)``, ``l_aa = gamma + alpha sum w -
  beta w_a`` and ``l_ab = beta s_a s_b``; ``sharp`` applies the inverse
  by a Cholesky solve whose pivots are ``sqrt(x)``, floored to ``1e-4``
  where ``x < 1e-8``; both are periodic (FFT) operators;
* ``interp(I, u)(x) = I(x + u(x))``, multilinear: corners ``floor(c)`` and
  ``floor(c) + 1`` clamped into the grid, weights from the unclamped
  coordinate ``c``;
* the central difference is clamped: ``(a[i+1] - a[i-1]) / 2`` inside,
  one-sided half differences at the two edges;
* ``Ad*(phi, m)_i = m_i(x + phi) + sum_j D_j phi_i m_j(x + phi)``;
* a shooting of ``T`` steps, ``dt = 1 / T``, starts with ``phi = -dt v0``
  (``v0 = sharp(m0)``) and then ``T - 1`` times ``v = sharp(Ad*(phi, m0))``,
  ``phi <- -dt v + phi(x - dt v)``;
* the loss of a minibatch is ``(sum (I(x + phi) - img)^2 + reg_weight
  sum <v0, m0>) / (count * voxels)``, ``count`` the subjects of the global
  minibatch; each iteration moves ``m <- m - lr_m dL/dm`` and adds
  ``dL/dI`` to the atlas's accumulator, and each epoch ends with ``I <- I -
  lr_I * accumulator / iterations``.
"""
from __future__ import annotations

import itertools
import math

import torch


class FluidMetric:
    """The fluid metric of ``params = (alpha, beta, gamma)`` on one grid,
    its multipliers built once in float64."""

    def __init__(self, params, spatial, device):
        self.params = tuple(float(p) for p in params)
        self.spatial = tuple(spatial)
        self.d = len(self.spatial)
        self._flat = self._build(False, device)
        self._sharp = self._build(True, device)

    def _build(self, inverse, device):
        alpha, beta, gamma = self.params
        d, sp = self.d, self.spatial
        half = sp[:-1] + (sp[-1] // 2 + 1,)
        ws, ss = [], []
        for a in range(d):
            k = torch.arange(half[a], dtype=torch.float64, device=device)
            ang = 2 * math.pi * k / sp[a]
            shape = [1] * d
            shape[a] = half[a]
            ws.append((2 * (1 - torch.cos(ang))).view(shape).expand(half))
            ss.append(torch.sin(ang).view(shape).expand(half))
        lam = gamma + alpha * sum(ws)
        l = [[(lam - beta * ws[a]) if a == b else beta * ss[a] * ss[b] for b in range(d)]
             for a in range(d)]
        L = [[sum(l[a][c] * l[c][b] for c in range(d)) for b in range(d)] for a in range(d)]
        if not inverse:
            return L
        # Cholesky L = G G^T with floored pivots, then the inverse's columns
        G = [[None] * d for _ in range(d)]
        inv_piv = [None] * d
        for a in range(d):
            for b in range(a):
                G[a][b] = (L[a][b] - sum(G[a][c] * G[b][c] for c in range(b))) * inv_piv[b]
            x = L[a][a] - sum(G[a][c] ** 2 for c in range(a))
            piv = torch.where(x < 1e-8, torch.full_like(x, 1e-4),
                              torch.sqrt(torch.clamp(x, min=1e-8)))
            inv_piv[a] = 1 / piv
            G[a][a] = piv
        cols = []
        for b in range(d):
            rhs = [torch.ones_like(lam) if a == b else torch.zeros_like(lam) for a in range(d)]
            y = [None] * d
            for a in range(d):
                y[a] = (rhs[a] - sum(G[a][c] * y[c] for c in range(a))) * inv_piv[a]
            x = [None] * d
            for a in reversed(range(d)):
                x[a] = (y[a] - sum(G[c][a] * x[c] for c in range(a + 1, d))) * inv_piv[a]
            cols.append(x)
        return [[cols[b][a] for b in range(d)] for a in range(d)]

    def _apply(self, M, f):
        dims = tuple(range(2, f.dim()))
        F = torch.fft.rfftn(f, dim=dims)
        out = [sum(M[a][b] * F[:, b] for b in range(self.d)) for a in range(self.d)]
        return torch.fft.irfftn(torch.stack(out, 1), s=self.spatial, dim=dims)

    def sharp(self, m):
        return self._apply(self._sharp, m)

    def flat(self, v):
        return self._apply(self._flat, v)


def _grid(spatial, like):
    axes = [torch.arange(n, dtype=like.dtype, device=like.device) for n in spatial]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))


def interp(I, u):
    """``I(x + u(x))``: ``I`` is ``(1 or N, C, *spatial)``, ``u`` is ``(N, d,
    *spatial)``; clamped corners, weights from the unclamped coordinate."""
    N, d = u.shape[:2]
    spatial = tuple(u.shape[2:])
    C = I.shape[1]
    c = _grid(spatial, u)[None] + u
    f = torch.floor(c)
    t = c - f
    f = f.long()
    strides = [math.prod(spatial[a + 1:]) for a in range(d)]
    src = I.reshape(I.shape[0], C, -1).expand(N, C, -1)
    out = 0
    for corner in itertools.product((0, 1), repeat=d):
        lin = 0
        w = 1
        for a in range(d):
            lin = lin + (f[:, a] + corner[a]).clamp(0, spatial[a] - 1) * strides[a]
            w = w * (t[:, a] if corner[a] else 1 - t[:, a])
        vals = torch.gather(src, 2, lin.reshape(N, 1, -1).expand(N, C, -1))
        out = out + w[:, None] * vals.reshape((N, C) + spatial)
    return out


def diff(a, axis):
    """Clamped central difference of ``a`` along tensor axis ``axis``."""
    n = a.shape[axis]
    p = torch.cat([a.narrow(axis, 0, 1), a, a.narrow(axis, n - 1, 1)], dim=axis)
    return 0.5 * (p.narrow(axis, 2, n) - p.narrow(axis, 0, n))


def ad_star(phi, m0):
    """``Ad*(phi, m0)`` with ``phi`` an inverse displacement."""
    d = phi.shape[1]
    w = interp(m0, phi)
    return torch.stack([w[:, i] + sum(diff(phi[:, i], 1 + j) * w[:, j] for j in range(d))
                        for i in range(d)], 1)


def shoot(metric, m0, v0, steps):
    """The inverse displacement at time 1 of the geodesic from ``m0``."""
    dt = 1.0 / steps
    phi = -dt * v0
    for _ in range(steps - 1):
        v = metric.sharp(ad_star(phi, m0))
        phi = -dt * v + interp(phi, -dt * v)
    return phi


def sums(metric, I, m, img, steps):
    """``(sum of squared errors, sum <v0, m>)`` of one minibatch."""
    v0 = metric.sharp(m)
    phi = shoot(metric, m, v0, steps)
    return torch.sum((interp(I, phi) - img) ** 2), torch.sum(v0 * m)


def atlas_grad_sq(metric, I, m, img, steps):
    """``(sq, vm, dsq/dI)`` of one minibatch, the shooting held fixed (the
    atlas gradient needs no backward through it)."""
    with torch.no_grad():
        v0 = metric.sharp(m)
        phi = shoot(metric, m, v0, steps)
        vm = torch.sum(v0 * m)
    I = I.detach().requires_grad_(True)
    with torch.enable_grad():
        sq = torch.sum((interp(I, phi) - img) ** 2)
        (gI,) = torch.autograd.grad(sq, I)
    return sq.detach(), vm, gI


def momenta_grad(metric, I, m, img, steps, reg_weight, numel):
    """``(sq, vm, dL/dm)`` of one minibatch, ``L = (sq + reg_weight vm) /
    numel``, by autograd through the whole shooting."""
    m = m.detach().requires_grad_(True)
    with torch.enable_grad():
        sq, vm = sums(metric, I.detach(), m, img, steps)
        (g,) = torch.autograd.grad((sq + reg_weight * vm) / numel, m)
    return sq.detach(), vm.detach(), g
