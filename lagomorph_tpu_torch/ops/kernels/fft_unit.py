"""K3: the fluid solve for ``beta == 0`` on packed pairs of real fields
(``csrc/fft_unit.cu``).

``y1 + i*y2 = ifftn(Mn * fftn(x1 + i*x2))`` over the three spatial axes,
where ``Mn`` is the full-spectrum scalar multiplier (even in k, so the real
and imaginary parts are the operator applied to ``x1`` and ``x2``).  The
pairs are the two halves of one ``(2F, X, Y, Z)`` tensor.

Replaces ``lagomorph_tpu/ops/pallas/fft_unit.py`` ``_zy_dft_kernel`` and
``_x_mul_dft_kernel`` (``fluid_flat_mxu``); it calls no cuFFT or cuBLAS.
Three paths, chosen by shape in the kernel:

* ``Y == Z`` in 64, 128 and ``X`` a power of two up to 256 (128^3 and 64^3,
  the 3D step's shapes): three passes.  A block holds a whole (y, z)
  plane in registers and transforms it along z, then y (a line transform in
  registers with one exchange through shared memory each,
  ``csrc/fft_reg.cuh``); then one pass along x with the product by ``Mn``
  and the inverse; then the planes back;
* other power-of-two axes up to 256 (a 256^2 plane, ``Y != Z``, smaller
  planes): five register line passes (z, y, x with the product and the x
  inverse, y, z);
* any other shape (``chip_smoke.ODD`` = 96 x 80 x 112): five passes of a
  shared-memory tile per block of lines (radix-2 FFT for a power-of-two
  axis, direct DFT sums otherwise, ``csrc/fft_lines.cuh``), through an
  ``(F, X, Y, Z)`` complex scratch (:func:`needs_scratch`).

The first pass writes the output's two halves and the others run in place
on them, so the first two paths need no scratch.  On the H100 each radix-2
pass is bound by its device-memory traffic (the field, 100.7 MB at 128^3
b4 as a float pair, read and written once per pass: ~0.6 GB a solve in
three passes, ~1 GB in five); direct-sum passes are bound by arithmetic.
Its plain version, :func:`fluid_flat_plain`, is the ``torch.fft`` packed
operator.  See the source for the design.

The operator is self-adjoint (``Mn`` real and even in k makes
``ifftn(Mn * fftn(.))`` Hermitian), so its backward is K3 again on the
cotangent, as in the JAX package's ``_fluid_cvjp`` (ops/fluid.py:273-286).
"""
from __future__ import annotations

import torch

from . import _build, check_cuda_f32, grad_needed, register, stream_of, use_kernel

KERNEL = register(
    "fluid_flat",
    source="lagomorph_tpu_torch/csrc/fft_unit.cu",
    replaces="lagomorph_tpu/ops/pallas/fft_unit.py:438, 463",
)


def fluid_flat_plain(x: torch.Tensor, Mn: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: the ``torch.fft`` packed operator on the
    complex field ``x[:F] + i*x[F:]`` of shape ``(F, X, Y, Z)`` (or of any
    number of spatial axes, the packed solve of the fluid routes)."""
    F = x.shape[0] // 2
    dims = tuple(range(1, x.dim()))
    c = torch.complex(x[:F], x[F:])
    y = torch.fft.ifftn(torch.fft.fftn(c, dim=dims) * Mn, dim=dims)
    return torch.cat([y.real, y.imag])


def needs_scratch(X: int, Y: int, Z: int) -> bool:
    """Whether K3 and K16 take their tile path at this shape, which needs an
    ``(F, X, Y, Z)`` complex scratch: some axis is not a power of two up to
    256 (the register paths' lengths, ``reg_axis`` in ``csrc/fft_plane.cuh``)."""
    return not all(1 <= n <= 256 and n & (n - 1) == 0 for n in (X, Y, Z))


def _launch(x, Mn):
    F2, X, Y, Z = x.shape
    F = F2 // 2
    y = torch.empty_like(x)
    scratch = (torch.empty((F, X, Y, Z, 2), dtype=x.dtype, device=x.device)
               if needs_scratch(X, Y, Z) else None)
    _build.call(
        "lagomorph_fluid_flat",
        x[:F].data_ptr(), x[F:].data_ptr(), Mn.data_ptr(), y[:F].data_ptr(),
        y[F:].data_ptr(), None if scratch is None else scratch.data_ptr(), F, X, Y, Z,
        stream_of(x),
    )
    KERNEL.launches += 1
    return y


class _FluidFlat(torch.autograd.Function):
    """K3 under autograd; the operator is self-adjoint, so its backward is
    K3 on the cotangent (no gradient for the multiplier)."""

    @staticmethod
    def forward(ctx, x, Mn):
        ctx.save_for_backward(Mn)
        return _launch(x, Mn)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (Mn,) = ctx.saved_tensors
        return _launch(g.contiguous(), Mn), None


def fluid_flat(x: torch.Tensor, Mn: torch.Tensor) -> torch.Tensor:
    """K3: the packed-pair fluid solve.  ``x``: ``(2F, X, Y, Z)``, read as
    the ``F`` complex fields ``x[:F] + i*x[F:]``; ``Mn``: ``(X, Y, Z)``,
    real and even in k.  Returns ``y`` of the same layout, with
    ``y[:F] + i*y[F:] = ifftn(Mn * fftn(x[:F] + i*x[F:]))``.  The kernel on
    CUDA (float32, contiguous; differentiable through K3 itself), the plain
    version on the CPU."""
    if not use_kernel(x):
        return fluid_flat_plain(x, Mn)
    check_cuda_f32("fluid_flat", x, Mn)
    if x.dim() != 4 or x.shape[0] % 2 or tuple(Mn.shape) != tuple(x.shape[1:]):
        raise ValueError(
            f"fluid_flat: x {tuple(x.shape)}, Mn {tuple(Mn.shape)}: want "
            "(2F, X, Y, Z) pairs and an (X, Y, Z) multiplier"
        )
    if grad_needed(x):
        return _FluidFlat.apply(x, Mn)
    return _launch(x, Mn)
