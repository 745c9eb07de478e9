"""Affine warps and regridding.

Port of ``lagomorph_tpu/ops/affine.py``: ``affine_interp`` samples images
through affine maps about the grid centre, ``regrid`` resamples a field
from one regular grid to another.  Plain PyTorch on the port's general
gather (:func:`.sampling.sample_linear`), as the JAX functions are plain
XLA; autograd gives their backwards (on CUDA the gather's backward adds
with atomics, so two runs agree within rounding, not bit for bit).
"""
from __future__ import annotations

import torch

from .sampling import identity_grid, sample_linear

__all__ = ["affine_interp", "regrid"]


def affine_interp(I: torch.Tensor, A: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply batched affine transforms to images:
    ``out_n(x) = I_n(A_n (x - o) + T_n + o)`` with ``o = (N - 1) / 2`` the
    grid centre.

    ``I``: ``(NI, C, *spatial)`` with ``NI`` in ``{1, N}`` (1 broadcasts over
    the transforms); ``A``: ``(N, dim, dim)``; ``T``: ``(N, dim)``, both
    cast to ``I``'s dtype.  Returns ``(N, C, *spatial)``."""
    if A.shape[0] != T.shape[0]:
        raise ValueError("A and T must have same first dimension")
    dim = A.shape[1]
    spatial = tuple(I.shape[2:])
    if len(spatial) != dim:
        raise ValueError("A/T dimension does not match image rank")
    dtype = I.dtype
    grid = identity_grid(spatial, dtype=dtype, device=I.device)
    o = torch.tensor([(n - 1) * 0.5 for n in spatial], dtype=dtype, device=I.device)
    centered = grid - o.reshape((dim,) + (1,) * dim)
    coords = (torch.einsum("nab,b...->na...", A.to(dtype), centered)
              + (T.to(dtype) + o).reshape((A.shape[0], dim) + (1,) * dim))
    return sample_linear(I, coords)


def regrid(I: torch.Tensor, shape=None, origin=None, spacing=None,
           displacement: bool = False) -> torch.Tensor:
    """Interpolate ``I`` (``(N, C, *spatial)``) from its grid onto another.

    The input grid has its origin at ``(N_in - 1) / 2`` and unit spacing.
    The output grid, centred at ``(N_out - 1) / 2``, follows the JAX
    function's rules (scalars broadcast to every dimension):

    * ``shape`` alone: origin ``(N_in - 1) / 2`` and spacing ``(N_in - 1) /
      (N_out - 1)``, so that corners map to corners;
    * ``shape`` with ``origin`` and/or ``spacing``: the given values, a
      missing spacing 1 and a missing origin the input's centre;
    * no ``shape`` raises.

    With ``displacement`` the values are also scaled by ``1 / spacing`` per
    channel (``C`` must equal the dimension): a displacement in input voxels
    becomes one in output voxels."""
    d = I.dim() - 2
    if shape is None:
        if origin is None and spacing is None:
            raise ValueError("At least one of shape, origin, or spacing required")
        raise NotImplementedError("regrid without an explicit shape is not implemented")
    if not isinstance(shape, (list, tuple)):
        shape = (int(shape),) * d
    shape = tuple(int(s) for s in shape)
    if origin is None:
        origin = tuple((s - 1) * 0.5 for s in I.shape[2:])
        if spacing is None:
            spacing = tuple((sI - 1) / (s - 1) for sI, s in zip(I.shape[2:], shape))
    if spacing is None:
        spacing = (1.0,) * d
    if not isinstance(origin, (list, tuple)):
        origin = (float(origin),) * d
    if not isinstance(spacing, (list, tuple)):
        spacing = (float(spacing),) * d
    if not len(shape) == len(origin) == len(spacing) == d:
        raise ValueError(f"shape, origin and spacing must have {d} entries")

    rs = (d,) + (1,) * d
    o_out = torch.tensor([(n - 1) * 0.5 for n in shape], dtype=I.dtype, device=I.device)
    S = torch.tensor(spacing, dtype=I.dtype, device=I.device)
    O = torch.tensor(origin, dtype=I.dtype, device=I.device)
    grid = identity_grid(shape, dtype=I.dtype, device=I.device)
    coords = (grid - o_out.reshape(rs)) * S.reshape(rs) + O.reshape(rs)
    out = sample_linear(I, coords[None].expand((I.shape[0],) + coords.shape))
    if displacement:
        if I.shape[1] != d:
            raise ValueError("Incorrect num channels for regridding displacement")
        out = out * (1.0 / S).reshape((1, d) + (1,) * d)
    return out
