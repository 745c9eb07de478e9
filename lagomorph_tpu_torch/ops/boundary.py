"""Boundary-aware shift and finite-difference primitives.

Port of ``lagomorph_tpu/ops/boundary.py``: CLAMP (replicate-edge) shifts,
the clamped central difference along one axis of an arbitrary-rank tensor
and its exact transpose, built from static slices.
"""
from __future__ import annotations

import torch


def shift_clamp(a: torch.Tensor, axis: int, offset: int) -> torch.Tensor:
    """``a`` sampled at ``i + offset`` along ``axis`` with clamped
    out-of-range indices (``|offset| <= 1``)."""
    if offset == 0:
        return a
    n = a.shape[axis]
    if n < 2:
        raise ValueError("shift_clamp requires size >= 2 along axis")
    if offset == 1:
        # a[1], a[2], ..., a[n-1], a[n-1]
        return torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)], dim=axis)
    if offset == -1:
        # a[0], a[0], a[1], ..., a[n-2]
        return torch.cat([a.narrow(axis, 0, 1), a.narrow(axis, 0, n - 1)], dim=axis)
    raise ValueError("only |offset| <= 1 supported")


def diff_central(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Clamped central difference ``0.5 * (a[clamp(i+1)] - a[clamp(i-1)])``
    along ``axis``; one-sided half-differences at the two edges."""
    n = a.shape[axis]
    if n < 2:
        raise ValueError("diff_central requires size >= 2 along axis")
    first = 0.5 * (a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1))
    mid = 0.5 * (a.narrow(axis, 2, n - 2) - a.narrow(axis, 0, n - 2))
    last = 0.5 * (a.narrow(axis, n - 1, 1) - a.narrow(axis, n - 2, 1))
    return torch.cat([first, mid, last], dim=axis)


def diff_central_adjoint(p: torch.Tensor, axis: int) -> torch.Tensor:
    """The exact matrix transpose of :func:`diff_central` along ``axis``:
    ``-0.5 * (p[0] + p[1])`` at ``i == 0``, ``0.5 * (p[i-1] - p[i+1])``
    inside, ``0.5 * (p[n-1] + p[n-2])`` at ``i == n-1``."""
    n = p.shape[axis]
    if n < 2:
        raise ValueError("diff_central_adjoint requires size >= 2 along axis")
    first = -0.5 * (p.narrow(axis, 0, 1) + p.narrow(axis, 1, 1))
    mid = 0.5 * (p.narrow(axis, 0, n - 2) - p.narrow(axis, 2, n - 2))
    last = 0.5 * (p.narrow(axis, n - 1, 1) + p.narrow(axis, n - 2, 1))
    return torch.cat([first, mid, last], dim=axis)
