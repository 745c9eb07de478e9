"""K16: the whole-volume fluid solve for ``beta == 0`` on packed pairs of
real fields in one launch (``csrc/fft_whole.cu``).

``y1 + i*y2 = ifftn(Mn * fftn(x1 + i*x2))`` over the three spatial axes on
the ``(2F, X, Y, Z)`` layout of K3 (:mod:`.fft_unit`), with the
natural-order multiplier ``Mn``.  Replaces ``lagomorph_tpu/ops/pallas/
fft_unit.py`` ``_whole_dft_kernel`` (``fluid_flat_mxu_whole``).  One
cooperative persistent launch runs the five axis phases of K3 (z, y, x
times ``Mn`` and back, y, z) with grid-wide barriers between them and the
complex scratch in L2 (64^3 b4: 12.6 MB); see the source.  Any axis
lengths.  Its plain version is K3's, :func:`.fft_unit.fluid_flat_plain`
(the ``torch.fft`` packed solve), and, the operator being self-adjoint,
its backward is K16 on the cotangent.
"""
from __future__ import annotations

import torch

from . import _build, check_cuda_f32, grad_needed, register, stream_of, use_kernel
from .fft_unit import fluid_flat_plain

KERNEL = register(
    "fluid_whole",
    source="lagomorph_tpu_torch/csrc/fft_whole.cu",
    replaces="lagomorph_tpu/ops/pallas/fft_unit.py:602",
)


def _launch(x, Mn):
    F2, X, Y, Z = x.shape
    F = F2 // 2
    y = torch.empty_like(x)
    scratch = torch.empty((F, X, Y, Z, 2), dtype=x.dtype, device=x.device)
    _build.call(
        "lagomorph_fluid_whole",
        x[:F].data_ptr(), x[F:].data_ptr(), Mn.data_ptr(), y[:F].data_ptr(),
        y[F:].data_ptr(), scratch.data_ptr(), F, X, Y, Z, stream_of(x),
    )
    KERNEL.launches += 1
    return y


class _FluidWhole(torch.autograd.Function):
    """K16 under autograd; self-adjoint, so its backward is K16 on the
    cotangent (no gradient for the multiplier)."""

    @staticmethod
    def forward(ctx, x, Mn):
        ctx.save_for_backward(Mn)
        return _launch(x, Mn)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (Mn,) = ctx.saved_tensors
        return _launch(g.contiguous(), Mn), None


def fluid_whole(x: torch.Tensor, Mn: torch.Tensor) -> torch.Tensor:
    """K16: the packed-pair fluid solve in one launch.  ``x``: ``(2F, X, Y,
    Z)``, read as ``x[:F] + i*x[F:]``; ``Mn``: ``(X, Y, Z)``, real and even
    in k.  Returns ``y`` of the same layout.  The kernel on CUDA (float32,
    contiguous; differentiable through K16 itself), the plain version on
    the CPU."""
    if not use_kernel(x):
        return fluid_flat_plain(x, Mn)
    check_cuda_f32("fluid_whole", x, Mn)
    if x.dim() != 4 or x.shape[0] % 2 or tuple(Mn.shape) != tuple(x.shape[1:]):
        raise ValueError(
            f"fluid_whole: x {tuple(x.shape)}, Mn {tuple(Mn.shape)}: want "
            "(2F, X, Y, Z) pairs and an (X, Y, Z) multiplier"
        )
    if grad_needed(x):
        return _FluidWhole.apply(x, Mn)
    return _launch(x, Mn)
