"""Multilinear sampling on regular grids.

Port of ``lagomorph_tpu/ops/sampling.py``: the general gather
(:func:`sample_linear`) and its linear transpose, the splat
(:func:`splat_linear`), the exact 27-tap form for displacements in
``[-1, 1)`` (:func:`sample_displacement_unit`, the plain version of kernel
K4) and the dense offset sweep for displacements bounded by a radius
(:func:`sample_displacement_bounded`, with the JAX package's scatter-free
custom backward).  Same semantics throughout: corner
index ``floor(x)`` and ``floor(x) + 1``, weights from the unclamped
coordinate, corner indices clamped (CLAMP boundary) or handled by the
chosen background strategy.
"""
from __future__ import annotations

import itertools

import torch

BACKGROUND_STRATEGIES = ("clamp", "wrap", "zero", "val")


def identity_grid(spatial, dtype=torch.float32, *, device) -> torch.Tensor:
    """``(dim, *spatial)`` identity coordinate grid in voxel units, on
    ``device`` (required: nothing is built on a default device)."""
    axes = [torch.arange(n, dtype=dtype, device=device) for n in spatial]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)


def _pad_edge(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Replicate-edge pad every spatial axis (dims 2..) by ``lo``/``hi``."""
    for ax in range(2, x.dim()):
        n = x.shape[ax]
        idx = torch.arange(-lo, n + hi, device=x.device).clamp_(0, n - 1)
        x = x.index_select(ax, idx)
    return x


def _strides(spatial):
    """Row-major strides of a grid of ``spatial`` size, and its size."""
    strides = []
    s = 1
    for n in reversed(spatial):
        strides.append(s)
        s *= n
    return strides[::-1], s


def sample_linear(I: torch.Tensor, coords: torch.Tensor, background: str = "clamp",
                  background_value: float = 0.0) -> torch.Tensor:
    """Batched multilinear sampling at fractional voxel coordinates.

    ``I``: ``(NI, C, *spatial)`` with ``NI`` in ``{1, N}`` (1 broadcasts);
    ``coords``: ``(N, dim, *out_spatial)``.  Returns ``(N, C, *out_spatial)``.
    ``background``: ``"clamp"`` (replicate edge), ``"wrap"`` (periodic),
    ``"zero"`` / ``"val"`` (out-of-range corners contribute
    ``background_value``, 0 for "zero")."""
    if background not in BACKGROUND_STRATEGIES:
        raise ValueError(f"unknown background strategy {background!r}")
    N, dim = coords.shape[:2]
    spatial = tuple(I.shape[2:])
    if len(spatial) != dim:
        raise ValueError(f"coords dim {dim} does not match image rank {len(spatial)}")
    if I.shape[0] not in (1, N):
        raise ValueError(f"Incompatible batch sizes I={I.shape[0]}, coords={N}")
    floor = torch.floor(coords)
    frac = coords - floor  # weights from unclamped coordinates
    return _sample_corners(I, floor.to(torch.int64), frac, background, background_value)


def sample_displaced(I: torch.Tensor, disp: torch.Tensor, offset=None) -> torch.Tensor:
    """``out(x) = I(x + offset + disp(x))`` for every voxel ``x`` of
    ``disp``'s grid, multilinearly with CLAMP: :func:`sample_linear` at the
    coordinates ``identity + offset + disp``, with each coordinate kept as
    its integer part ``x + offset + floor(disp)`` and the fraction of
    ``disp``, so that the weights keep ``disp``'s precision (a float32
    coordinate of a few hundred voxels is rounded to 1e-5 voxel).

    I: ``(NI, C, *spatial)`` (``NI in {1, N}``; ``spatial`` may differ from
    ``disp``'s grid); disp: ``(N, dim, *out_spatial)``; offset: integer
    voxels per axis (0 by default)."""
    dim = disp.shape[1]
    out_spatial = tuple(disp.shape[2:])
    offset = (0,) * dim if offset is None else tuple(int(o) for o in offset)
    f = torch.floor(disp)
    frac = disp - f
    floor = f.to(torch.int64)
    base = []
    for d in range(dim):
        shape = [1] * dim
        shape[d] = out_spatial[d]
        base.append(torch.arange(out_spatial[d], device=disp.device).view(shape) + offset[d])
    floor = torch.stack([floor[:, d] + base[d] for d in range(dim)], dim=1)
    return _sample_corners(I, floor, frac, "clamp", 0.0)


def _sample_corners(I, floor, frac, background, background_value):
    """The multilinear sum over the ``2^dim`` corners ``floor + {0, 1}``
    (``floor``: int64 ``(N, dim, *out_spatial)``) with weights from
    ``frac``, the corners handled by ``background``."""
    N, dim = floor.shape[:2]
    spatial = tuple(I.shape[2:])
    C = I.shape[1]
    out_spatial = tuple(floor.shape[2:])
    bg = 0.0 if background == "zero" else background_value
    strides, _ = _strides(spatial)
    Iflat = I.reshape(I.shape[0], C, -1).expand(N, C, -1)

    out = None
    for corner in itertools.product((0, 1), repeat=dim):
        lin = None
        w = None
        valid = None
        for d in range(dim):
            raw = floor[:, d] + corner[d]
            if background == "wrap":
                idx = torch.remainder(raw, spatial[d])
            else:
                idx = raw.clamp(0, spatial[d] - 1)
            if background in ("zero", "val"):
                vd = (raw >= 0) & (raw < spatial[d])
                valid = vd if valid is None else valid & vd
            lin = idx * strides[d] if lin is None else lin + idx * strides[d]
            wd = frac[:, d] if corner[d] else 1.0 - frac[:, d]
            w = wd if w is None else w * wd
        gidx = lin.reshape(N, 1, -1).expand(N, C, -1)
        vals = torch.gather(Iflat, 2, gidx).reshape((N, C) + out_spatial)
        if valid is not None:
            vals = torch.where(valid[:, None], vals, torch.full_like(vals, bg))
        term = w[:, None] * vals
        out = term if out is None else out + term
    return out


def scatter_corners(values: torch.Tensor, coords: torch.Tensor, spatial, square=False):
    """``(N, C, *spatial)``: each of ``values`` (``(N, C, *out_spatial)``)
    times each multilinear weight of the fractional voxel coordinates
    ``coords`` (``(N, dim, *out_spatial)``; its square with ``square``)
    added at that corner of its own subject's grid, clamped into it
    (CLAMP), the weights from the unclamped coordinate: one ``index_add_``
    a corner on int64 linear indices offset by subject and channel."""
    N, C = values.shape[:2]
    dim = coords.shape[1]
    floor = torch.floor(coords)
    frac = coords - floor
    floor = floor.to(torch.int64)
    strides, nvox = _strides(spatial)
    out = torch.zeros(N * C * nvox, dtype=values.dtype, device=values.device)
    base = (torch.arange(N * C, device=values.device) * nvox).view(N, C, 1)
    for corner in itertools.product((0, 1), repeat=dim):
        lin = None
        w = None
        for d in range(dim):
            idx = (floor[:, d] + corner[d]).clamp(0, spatial[d] - 1)
            lin = idx * strides[d] if lin is None else lin + idx * strides[d]
            wd = frac[:, d] if corner[d] else 1.0 - frac[:, d]
            w = wd if w is None else w * wd
        if square:
            w = w * w
        idx = base + lin.reshape(N, 1, -1)
        out.index_add_(0, idx.reshape(-1), (w[:, None] * values).reshape(-1))
    return out.view((N, C) + tuple(spatial))


def splat_linear(values: torch.Tensor, coords: torch.Tensor, spatial) -> torch.Tensor:
    """Linear transpose of :func:`sample_linear` with CLAMP: ``values``
    (``(N, C, *out_spatial)``) scattered at the fractional voxel
    coordinates ``coords`` (``(N, dim, *out_spatial)``, the same ``N``: no
    broadcasting) into a zero grid ``(N, C, *spatial)``.  Out-of-range
    corners are clamped, so their mass piles up at the edge.  On the card
    ``index_add_`` adds with atomics, in no fixed order."""
    if values.shape[0] != coords.shape[0]:
        raise ValueError(f"Incompatible batch sizes values={values.shape[0]}, "
                         f"coords={coords.shape[0]}")
    return scatter_corners(values, coords, tuple(spatial))


def sample_displacement_unit(I: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Exact sampling ``out(x) = I(x + disp(x))`` for every component of
    ``disp`` in ``[-1, 1)``: a weighted sum of the ``3^dim`` clamped shifts
    (the plain version of kernel K4).  Outside that regime an axis whose
    floor is not -1 or 0 gets weight 0.

    I: ``(NI, C, *spatial)`` (``NI in {1, N}``); disp: ``(N, dim, *spatial)``.
    """
    dim = disp.shape[1]
    spatial = disp.shape[2:]
    N = disp.shape[0]
    if I.shape[0] not in (1, N):
        raise ValueError("Incompatible batch sizes")
    Ib = I.expand((N,) + tuple(I.shape[1:])) if I.shape[0] == 1 and N > 1 else I

    f = torch.floor(disp)
    t = disp - f
    is_m1 = (f == -1).to(I.dtype)
    is_0 = (f == 0).to(I.dtype)
    # per-axis weights for shifts -1, 0, +1 (elementwise at the output point)
    w = {
        -1: is_m1 * (1.0 - t),
        0: is_m1 * t + is_0 * (1.0 - t),
        1: is_0 * t,
    }
    Ipad = _pad_edge(Ib, 1, 1)
    out = None
    for offsets in itertools.product((-1, 0, 1), repeat=dim):
        wprod = None
        for d, o in enumerate(offsets):
            wd = w[o][:, d]
            wprod = wd if wprod is None else wprod * wd
        idx = (slice(None), slice(None)) + tuple(
            slice(1 + o, 1 + o + n) for o, n in zip(offsets, spatial)
        )
        term = wprod[:, None] * Ipad[idx]
        out = term if out is None else out + term
    return out


def _offset_weight(f, t, o):
    """Per-axis shift weight: offset ``o`` receives (1-t) when floor==o and
    t when floor==o-1 (the two stencil corners that land on o)."""
    return (f == o).to(t.dtype) * (1.0 - t) + (f == (o - 1)).to(t.dtype) * t


def _offset_slope(f, o, dtype):
    """Slope of :func:`_offset_weight` in the displacement (``t`` has slope
    1, the floor masks none): ``[f == o - 1] - [f == o]``."""
    return (f == (o - 1)).to(dtype) - (f == o).to(dtype)


def _unpad_edge(d: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Transpose of :func:`_pad_edge`: the pad strips of every spatial axis
    are summed back onto that axis's edge slices (dense, no scatter)."""
    for ax in range(2, d.dim()):
        n = d.shape[ax] - lo - hi
        core = d.narrow(ax, lo, n).clone()
        core.narrow(ax, 0, 1).add_(d.narrow(ax, 0, lo).sum(ax, keepdim=True))
        core.narrow(ax, n - 1, 1).add_(d.narrow(ax, lo + n, hi).sum(ax, keepdim=True))
        d = core
    return d


class _SampleBounded(torch.autograd.Function):
    """The bounded tier with the JAX package's scatter-free custom VJP
    (``ops/sampling.py`` ``_sdb_fwd`` / ``_sdb_bwd``): the forward saves only
    ``I`` and ``disp``, and the backward sweeps the offsets again, adding
    each tap's transposed weighted slice into an edge-padded ``d_I`` and the
    weights' slopes times ``<g, tap>`` into ``d_disp``.  Autograd of the
    sweep itself would keep every tap's intermediates: (2R + 2)^dim of them."""

    @staticmethod
    def forward(ctx, I, disp, radius):
        ctx.save_for_backward(I, disp)
        ctx.radius = radius
        dim = disp.shape[1]
        spatial = tuple(disp.shape[2:])
        N = disp.shape[0]
        Ib = I.expand((N,) + tuple(I.shape[1:])) if I.shape[0] == 1 and N > 1 else I
        Ipad = _pad_edge(Ib, radius, radius + 1)
        f = torch.floor(disp).to(torch.int64)
        t = disp - torch.floor(disp)
        offsets = range(-radius, radius + 2)
        inner = list(itertools.product(offsets, repeat=dim - 1))

        out = torch.zeros((N, Ib.shape[1]) + spatial, dtype=I.dtype, device=I.device)
        for o0 in offsets:
            sl0 = Ipad[:, :, radius + o0: radius + o0 + spatial[0]]
            w0 = _offset_weight(f[:, 0], t[:, 0], o0)
            term0 = None
            for oin in inner:
                w = w0
                for d, o in enumerate(oin):
                    w = w * _offset_weight(f[:, d + 1], t[:, d + 1], o)
                idx = (slice(None), slice(None), slice(None)) + tuple(
                    slice(radius + o, radius + o + n) for o, n in zip(oin, spatial[1:])
                )
                contrib = w[:, None] * sl0[idx]
                term0 = contrib if term0 is None else term0 + contrib
            out = out + term0
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        I, disp = ctx.saved_tensors
        radius = ctx.radius
        dim = disp.shape[1]
        spatial = tuple(disp.shape[2:])
        N = disp.shape[0]
        broadcasting = I.shape[0] == 1 and N > 1
        Ib = I.expand((N,) + tuple(I.shape[1:])) if broadcasting else I
        Ipad = _pad_edge(Ib, radius, radius + 1)
        f = torch.floor(disp).to(torch.int64)
        t = disp - torch.floor(disp)
        offsets = range(-radius, radius + 2)
        inner = list(itertools.product(offsets, repeat=dim - 1))

        d_Ipad = torch.zeros_like(Ipad)
        d_t = [torch.zeros_like(t[:, d]) for d in range(dim)]
        for o0 in offsets:
            lead = slice(radius + o0, radius + o0 + spatial[0])
            sl0 = Ipad[:, :, lead]
            w0 = _offset_weight(f[:, 0], t[:, 0], o0)
            dw0 = _offset_slope(f[:, 0], o0, t.dtype)
            d_sl0 = d_Ipad[:, :, lead]
            for oin in inner:
                ws_in = [_offset_weight(f[:, d + 1], t[:, d + 1], o) for d, o in enumerate(oin)]
                w_in = None
                for wd in ws_in:
                    w_in = wd if w_in is None else w_in * wd
                w = w0 if w_in is None else w0 * w_in
                idx = (slice(None), slice(None), slice(None)) + tuple(
                    slice(radius + o, radius + o + n) for o, n in zip(oin, spatial[1:])
                )
                d_sl0[idx] += w[:, None] * g  # transpose of the weighted slice, in place
                gsl = torch.sum(g * sl0[idx], dim=1)
                d_t[0] += (dw0 if w_in is None else dw0 * w_in) * gsl
                for d, o in enumerate(oin):
                    others = w0
                    for e, we in enumerate(ws_in):
                        if e != d:
                            others = others * we
                    d_t[d + 1] += _offset_slope(f[:, d + 1], o, t.dtype) * others * gsl
        d_I = _unpad_edge(d_Ipad, radius, radius + 1)
        if broadcasting:
            d_I = torch.sum(d_I, dim=0, keepdim=True)
        return d_I, torch.stack(d_t, dim=1), None


def sample_displacement_bounded(I: torch.Tensor, disp: torch.Tensor,
                                radius: int) -> torch.Tensor:
    """Exact sampling ``out(x) = I(x + disp(x))`` for every component of
    ``disp`` in ``[-radius, radius + 1)``: a sweep over the integer offsets
    ``o in [-radius, radius + 1]^dim``, each a slice of the edge-padded
    volume times a mask-weight.  Out-of-range points contribute zero.
    Differentiable through the scatter-free backward of
    :class:`_SampleBounded`, which keeps only ``I`` and ``disp``.

    I: ``(N or 1, C, *spatial)``; disp: ``(N, dim, *spatial)``."""
    return _SampleBounded.apply(I, disp, int(radius))
