"""Transpose-based (pencil) fluid operator for fields sharded along X.

Port of ``lagomorph_tpu/parallel/sharded_fft.py`` (the design of
docs/spatial_sharding.md).  A field ``(B, 3, X, Y, Z)`` lies on the mesh as
X slabs ``(B, 3, X/n, Y, Z)``, one per entry; the operator never gathers it:

1. a slab-local ``rfftn`` over (Y, Z);
2. the X-split -> Y-split transpose: entry ``j`` receives the ``j``-th band
   of Y frequencies of every slab and joins them along X (the all-to-all of
   the JAX package: ``.to(device)`` and ``torch.cat``);
3. on each band, the 1D FFT along the whole X axis, the per-frequency
   ``3 x 3`` product with the band's multiplier (frequencies from
   ``j * Y/n``) and the inverse FFT;
4. the transpose back and the slab-local ``irfftn``.

Each entry holds O(V/n) of the field throughout.  The transforms are
``torch.fft``, as the JAX package's are ``jnp.fft`` outside any Pallas
kernel.  The map is self-adjoint in the real L2 inner product (as the
dense operator), so its backward applies it again to the cotangent
(:class:`_ShardedFluid`, which keeps no complex intermediate).
"""
from __future__ import annotations

import torch

from ..ops.fluid import _mix, fluid_multiplier_entries
from .mesh import as_shards, join_like


def _band_multiplier(shape_xyzf, y0, Y_full, Z_full, params, inverse, dtype, device=None):
    """Fluid multiplier entries ``{(a, b): arr}`` (``a >= b``) on a frequency
    grid of shape ``(X, Yb, Zf)`` where the Y axis is this shard's band
    starting at global frequency ``y0``; X carries full complex frequencies,
    Z the rFFT half spectrum.  The dense operator's multiplier
    (:func:`..ops.fluid.fluid_multiplier_entries`) restricted to the band."""
    X, Yb, _ = shape_xyzf
    return fluid_multiplier_entries((X, Y_full, Z_full), params, inverse, dtype, device,
                                    band=(1, int(y0), Yb))


def _multipliers(cache, spatial, n, params, inverse, dtype, devices):
    """The band multiplier of each mesh entry, from ``cache`` (a dict) or
    built into it."""
    X, Y, Z = spatial
    Yb = Y // n
    out = []
    for j, dev in enumerate(devices):
        key = (spatial, j * Yb, Yb, dtype, dev, bool(inverse))
        if key not in cache:
            cache[key] = _band_multiplier((X, Yb, Z // 2 + 1), j * Yb, Y, Z, params, inverse,
                                          dtype, dev)
        out.append(cache[key])
    return out


def _local_apply(slabs, devices, Y, Z, multipliers):
    """The work of every shard (the JAX package's shard_map body) on the X
    slabs ``(B, 3, X/n, Y, Z)``, ``slabs[k]`` on ``devices[k]``, with band
    ``j``'s multiplier on ``devices[j]``; returns the result's slabs."""
    n = len(slabs)
    Xl = slabs[0].shape[2]
    Yb = Y // n
    F = [torch.fft.rfftn(s, dim=(3, 4), norm="ortho") for s in slabs]  # (B,3,Xl,Y,Zf)
    # X-split -> Y-split: entry j gathers band j of every slab along X
    G = [torch.cat([F[k][:, :, :, j * Yb:(j + 1) * Yb].to(devices[j]) for k in range(n)], dim=2)
         for j in range(n)]  # (B,3,X,Yb,Zf)
    del F
    G = [torch.fft.ifft(_mix(torch.fft.fft(g, dim=2, norm="ortho"), M, 3), dim=2, norm="ortho")
         for g, M in zip(G, multipliers)]
    # Y-split -> X-split
    F = [torch.cat([G[j][:, :, k * Xl:(k + 1) * Xl].to(devices[k]) for j in range(n)], dim=3)
         for k in range(n)]  # (B,3,Xl,Y,Zf)
    del G
    return [torch.fft.irfftn(f, s=(Y, Z), dim=(3, 4), norm="ortho").to(s.dtype)
            for f, s in zip(F, slabs)]


class _ShardedFluid(torch.autograd.Function):
    """The pencil operator on slabs under autograd: the backward applies the
    same operator to the cotangents (self-adjoint), so nothing is saved."""

    @staticmethod
    def forward(ctx, op, *slabs):
        ctx.op = op
        return tuple(op(list(slabs)))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None, *ctx.op([g.contiguous() for g in grads]))


def _sharded_apply(slabs, params, inverse, cache=None):
    """The operator on a list of X slabs (one per mesh entry; the shape
    checked by :func:`_check_shape`), differentiable; ``cache``: a dict that
    keeps the band multipliers between calls."""
    _, _, Xl, Y, Z = slabs[0].shape
    n = len(slabs)
    devices = [s.device for s in slabs]
    Ms = _multipliers({} if cache is None else cache, (Xl * n, Y, Z), n, params, inverse,
                      slabs[0].dtype, devices)

    def apply(xs):
        return _local_apply(xs, devices, Y, Z, Ms)

    return list(_ShardedFluid.apply(apply, *slabs))


def _check_shape(shape, n):
    if len(shape) != 5 or shape[1] != 3:
        raise ValueError("sharded fluid operator is 3D (d == 3) only")
    if shape[2] % n or shape[3] % n:
        raise ValueError(f"X and Y must be divisible by the mesh axis size {n}")


def sharded_fluid_operator(mv, params, inverse, mesh, axis_name="data", cache=None):
    """Apply the fluid operator (``inverse=False``) or its floored-Cholesky
    inverse to an X-sharded ``(B, 3, X, Y, Z)`` field by the pencil
    decomposition.  ``mv``: a :class:`.mesh.Sharded` of X slabs over
    ``mesh`` (returned as one), or one tensor (split here, and the result
    joined on its device).  Numerically equivalent to
    :func:`..ops.fluid.fluid_operator` (same multiplier and floored-Cholesky
    solve; the FFTs associate differently, at the 1e-6 level in float32)."""
    n = mesh.shape[axis_name]
    _check_shape(tuple(mv.shape), n)
    params = tuple(float(p) for p in params)
    out = _sharded_apply(as_shards(mv, mesh, 2), params, bool(inverse), cache)
    return join_like(out, mv, 2)


class ShardedFluidMetric:
    """Drop-in FluidMetric for spatially-sharded shooting: ``sharp``/``flat``
    run the pencil solve on X-sharded fields (a :class:`.mesh.Sharded` or a
    tensor, as :func:`sharded_fluid_operator` takes them), keeping the band
    multipliers it built."""

    def __init__(self, params, mesh, axis_name="data"):
        self.params = tuple(float(p_) for p_ in params)
        self.mesh = mesh
        self.axis_name = axis_name
        self._multipliers = {}

    def operator(self, mv, inverse):
        return sharded_fluid_operator(mv, self.params, inverse, self.mesh, self.axis_name,
                                      cache=self._multipliers)

    def sharp(self, m):
        return self.operator(m, inverse=True)

    def flat(self, v):
        return self.operator(v, inverse=False)
