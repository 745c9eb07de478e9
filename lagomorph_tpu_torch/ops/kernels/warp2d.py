"""K17 and K18: the 2D unit-regime warp, forward and backward
(``csrc/warp2d.cu``).

``out(p) = sum_{o in {-1,0,1}^2} w_o(d(p)) * I[clamp(p + o)]``: exact
bilinear CLAMP sampling of ``I`` at ``p + d(p)`` wherever every
displacement component lies in ``[-1, 1)``; the 2D tier "unit" of
``ops.interp.interp_auto`` (the atlas loss's warp, and the 2D warps of the
general tiers).  The JAX package warps 2D fields with the plain stencil
(``lagomorph_tpu/ops/sampling.py`` ``sample_displacement_unit`` and its
autodiff; its warp kernel is 3D only), so these kernels replace no TPU
kernel.

* K17, the forward: one thread a pixel on its 4 live taps, bit-equal to
  the plain version on finite inputs.
* K18, its backward, in one pass: ``dI`` (the transpose of the warp, in
  gather form; summed over the subjects, in subject order, for a batch-1
  image) and ``d_disp`` (the weight-gradient path), from a tile and its
  halo staged in shared memory once a subject.

K18 launches once a pair of channels, and counts each in ``BWD.launches``.
See the source for the design.
"""
from __future__ import annotations

import torch

from . import (_build, check_cuda_f32, checked, grad_needed, register, stream_of,
               use_kernel)
from ..sampling import sample_displacement_unit as sample_displacement_unit_plain
from .warp_unit import sample_displacement_unit_bwd_plain

KERNEL = register(
    "warp2d_fwd",
    source="lagomorph_tpu_torch/csrc/warp2d.cu",
    replaces="lagomorph_tpu/ops/sampling.py:176",
)
BWD = register(
    "warp2d_bwd",
    source="lagomorph_tpu_torch/csrc/warp2d.cu",
    replaces="lagomorph_tpu/ops/sampling.py:176",
)

__all__ = ["sample_displacement_unit", "sample_displacement_unit_plain",
           "sample_displacement_unit_bwd_plain"]


def _launch(I, disp):
    """K17: the warp of ``I`` by ``disp``."""
    N, _, H, W = disp.shape
    NI, C = I.shape[:2]
    out = torch.empty((N, C, H, W), dtype=disp.dtype, device=disp.device)
    _build.call("lagomorph_warp2d_fwd", I.data_ptr(), disp.data_ptr(), out.data_ptr(),
                N, NI, C, H, W, stream_of(disp))
    KERNEL.launches += 1
    return checked(KERNEL, out)


def _launch_bwd(I, disp, g):
    """K18: ``(dI, d_disp)`` for the cotangent ``g`` (``dI`` has ``I``'s
    batch)."""
    N, _, H, W = disp.shape
    NI, C = I.shape[:2]
    dI = torch.empty_like(I)
    dd = torch.empty_like(disp)
    _build.call("lagomorph_warp2d_bwd", I.data_ptr(), disp.data_ptr(), g.data_ptr(),
                dI.data_ptr(), dd.data_ptr(), N, NI, C, H, W, stream_of(disp))
    BWD.launches += -(-C // 2)  # one launch a pair of channels
    return checked(BWD, (dI, dd))


class _Warp(torch.autograd.Function):
    """K17 under autograd; its backward is K18."""

    @staticmethod
    def forward(ctx, I, disp):
        ctx.save_for_backward(I, disp)
        return _launch(I, disp)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        I, disp = ctx.saved_tensors
        return _launch_bwd(I, disp, g.contiguous())


def sample_displacement_unit(I: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Unit-regime warp of ``I`` (``(N or 1, C, H, W)``) by ``disp``
    (``(N, 2, H, W)``).  The kernel on CUDA (differentiable through K18),
    the plain version on the CPU and for other dtypes than float32; values
    equal :func:`..sampling.sample_displacement_unit`."""
    if not use_kernel(disp):
        return checked(KERNEL, sample_displacement_unit_plain(I, disp))
    check_cuda_f32("sample_displacement_unit", I, disp)
    if disp.dim() != 4 or disp.shape[1] != 2:
        raise ValueError(f"disp must be (N, 2, H, W), got {tuple(disp.shape)}")
    if I.dim() != 4 or I.shape[0] not in (1, disp.shape[0]) or I.shape[2:] != disp.shape[2:]:
        raise ValueError(f"I {tuple(I.shape)} does not match disp {tuple(disp.shape)}")
    if grad_needed(I, disp):
        return _Warp.apply(I, disp)
    return _launch(I, disp)
