"""K14 and K15: the radix-2 fluid solve for ``beta == 0`` on packed pairs
of real fields (``csrc/fft_radix.cu``), spectra in bit-reversed order.

``fluid_radix(x, Mbr)`` computes ``y1 + i*y2 = ifftn(Mn * fftn(x1 + i*x2))``
over the three spatial axes, as K3 (:mod:`.fft_unit`) does, in three
launches on the same ``(2F, X, Y, Z)`` layout (the pairs are its halves):

* K14 ``fluid_radix_zy`` forward: the DFT along z, then along y, of every
  (pair, x) plane, frequencies out in bit-reversed z and y order;
* K15 ``fluid_radix_x``: the DFT along x, times ``Mbr`` (the multiplier
  with every axis in bit-reversed order), the inverse along x with 1/X;
* K14 inverse: the inverse DFT along y, then along z, with 1/(Y Z), back
  to natural order.

The kernels are K3's register passes with the spectrum side of each pass
in bit-reversed order (a whole (Y, Z) plane per block when ``Y == Z`` is
64 or 128, else two line passes; a shared-memory tile of radix-2 stages
for an axis longer than 256), so on K3's register paths the pipeline is
bit-equal to K3.  They replace ``lagomorph_tpu/ops/pallas/fft_unit.py``
``_zy_call`` (``_zy_fwd_kernel``, ``_zy_inv_kernel``) and ``_x_mul_call``
(``_x_mul_kernel``), the kernels of ``fluid_flat_pallas``.  Their plain
versions, :func:`radix_zy_plain` and :func:`radix_x_plain`, run the TPU
kernels' radix-2 DIF and DIT stages through :mod:`..fft_radix`.  The
operator is self-adjoint, so the pipeline's backward is the pipeline on the
cotangent, as K3's.  Power-of-two axes only, none longer than ``MAX_N``.
"""
from __future__ import annotations

import torch

from ..fft_radix import fft_dif, fft_dit, fftn_br, is_pow2
from . import _build, check_cuda_f32, checked, grad_needed, register, stream_of, use_kernel

SOURCE = "lagomorph_tpu_torch/csrc/fft_radix.cu"
KERNEL_ZY = register("fluid_radix_zy", source=SOURCE,
                     replaces="lagomorph_tpu/ops/pallas/fft_unit.py:232")
KERNEL_X = register("fluid_radix_x", source=SOURCE,
                    replaces="lagomorph_tpu/ops/pallas/fft_unit.py:256")

# the longest axis whose lines one block of the tile path holds in shared
# memory
MAX_N = 8192


def radix_zy_plain(re, im, inverse):
    """Plain version of K14 on the real and imaginary ``(F, X, Y, Z)``
    parts: forward, DIF along z then y (bit-reversed out); inverse, DIT
    along y then z with 1/(Y Z) (natural out).  Returns ``(re, im)``."""
    if not inverse:
        return fftn_br(re, im, (3, 2))
    re, im = fft_dit(re, im, 2)
    return fft_dit(re, im, 3)


def radix_x_plain(re, im, Mbr):
    """Plain version of K15: DIF along x, times ``Mbr`` (``(X, Y, Z)``,
    indexed like the bit-reversed spectrum), DIT along x with 1/X.  Returns
    ``(re, im)``."""
    re, im = fft_dif(re, im, 1)
    return fft_dit(re * Mbr, im * Mbr, 1)


def fluid_radix_plain(x, Mbr):
    """Plain version of the pipeline K14, K15, K14 on ``(2F, X, Y, Z)``
    pairs."""
    F = x.shape[0] // 2
    re, im = radix_zy_plain(x[:F], x[F:], False)
    re, im = radix_x_plain(re, im, Mbr)
    return torch.cat(radix_zy_plain(re, im, True))


def _launch_zy(x, inverse):
    F2, X, Y, Z = x.shape
    F = F2 // 2
    y = torch.empty_like(x)
    _build.call("lagomorph_fluid_radix_zy", x[:F].data_ptr(), x[F:].data_ptr(),
                y[:F].data_ptr(), y[F:].data_ptr(), F, X, Y, Z, int(bool(inverse)),
                stream_of(x))
    KERNEL_ZY.launches += 1
    return checked(KERNEL_ZY, y)


def _launch_x(x, Mbr):
    F2, X, Y, Z = x.shape
    F = F2 // 2
    y = torch.empty_like(x)
    _build.call("lagomorph_fluid_radix_x", x[:F].data_ptr(), x[F:].data_ptr(), Mbr.data_ptr(),
                y[:F].data_ptr(), y[F:].data_ptr(), F, X, Y, Z, stream_of(x))
    KERNEL_X.launches += 1
    return checked(KERNEL_X, y)


def _pipeline(x, Mbr):
    return _launch_zy(_launch_x(_launch_zy(x, False), Mbr), True)


class _FluidRadix(torch.autograd.Function):
    """K14, K15, K14 under autograd; the operator is self-adjoint, so its
    backward is the same three launches on the cotangent (no gradient for
    the multiplier)."""

    @staticmethod
    def forward(ctx, x, Mbr):
        ctx.save_for_backward(Mbr)
        return _pipeline(x, Mbr)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (Mbr,) = ctx.saved_tensors
        return _pipeline(g.contiguous(), Mbr), None


def _check(name, x, *others):
    """Raise unless ``x`` is contiguous float32 ``(2F, X, Y, Z)`` pairs on a
    CUDA device with power-of-two axes no longer than ``MAX_N`` (and the
    ``others`` alike, of shape ``(X, Y, Z)``)."""
    check_cuda_f32(name, x, *others)
    if (x.dim() != 4 or x.shape[0] % 2
            or not all(is_pow2(n) and n <= MAX_N for n in x.shape[1:])
            or any(tuple(o.shape) != tuple(x.shape[1:]) for o in others)):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, {[tuple(o.shape) for o in others]}: want (2F, X, Y, Z) "
            f"pairs with power-of-two axes <= {MAX_N} and an (X, Y, Z) multiplier")


def _halves(fn, x, *args):
    F = x.shape[0] // 2
    return torch.cat(fn(x[:F], x[F:], *args))


def radix_zy(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """K14 on ``(2F, X, Y, Z)`` pairs (the halves are the real and
    imaginary parts), forward or inverse.  The kernel on CUDA (float32,
    contiguous; no backward of its own: under autograd use
    :func:`fluid_radix`), the plain version on the CPU."""
    if not use_kernel(x):
        return checked(KERNEL_ZY, _halves(radix_zy_plain, x, inverse))
    _check("fluid_radix_zy", x)
    if grad_needed(x):
        raise RuntimeError("fluid_radix_zy has no backward alone; differentiate fluid_radix")
    return _launch_zy(x, inverse)


def radix_x(x: torch.Tensor, Mbr: torch.Tensor) -> torch.Tensor:
    """K15 on ``(2F, X, Y, Z)`` pairs from K14's forward, with the
    bit-reversed multiplier ``Mbr`` of shape ``(X, Y, Z)``."""
    if not use_kernel(x):
        return checked(KERNEL_X, _halves(radix_x_plain, x, Mbr))
    _check("fluid_radix_x", x, Mbr)
    if grad_needed(x):
        raise RuntimeError("fluid_radix_x has no backward alone; differentiate fluid_radix")
    return _launch_x(x, Mbr)


def fluid_radix(x: torch.Tensor, Mbr: torch.Tensor) -> torch.Tensor:
    """The radix-2 packed-pair fluid solve, K14, K15, K14: ``x`` of shape
    ``(2F, X, Y, Z)`` read as ``x[:F] + i*x[F:]``, ``Mbr`` of shape ``(X,
    Y, Z)`` with every axis in bit-reversed order.  Returns ``y`` of the
    same layout with ``y[:F] + i*y[F:] = ifftn(Mn * fftn(x[:F] +
    i*x[F:]))``.  The kernels on CUDA (float32, contiguous, power-of-two
    axes; differentiable through the same launches), the plain version on
    the CPU."""
    if not use_kernel(x):
        return checked(KERNEL_ZY, fluid_radix_plain(x, Mbr))
    _check("fluid_radix", x, Mbr)
    if grad_needed(x):
        return _FluidRadix.apply(x, Mbr)
    return _pipeline(x, Mbr)
