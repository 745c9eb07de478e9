"""K4 and K5: the unit-regime warp, forward and backward
(``csrc/warp_unit.cu``).

``out(p) = sum_{o in {-1,0,1}^3} w_o(d(p)) * I[clamp(p + o)]``: exact
multilinear CLAMP sampling of ``I`` at ``p + d(p)`` wherever every
displacement component lies in ``[-1, 1)``.

* K4 replaces ``lagomorph_tpu/ops/pallas/warp_unit.py`` ``_fwd_kernel`` and
  ``_fwd_kernel_yb`` (the forward of ``sample_displacement_unit_pallas``).
* K5, its backward, gives ``dI`` (the transpose of the warp, in gather form;
  summed over the subjects for a batch-1 image) and ``d_disp`` (the
  weight-gradient path).  It replaces ``warp_unit.py``
  ``_warp_unit_bwd_pallas`` and ``_warp_unit_bwd_yb`` (``_sdu_bwd``).

On the H100 K4 sums the 8 taps whose weights can be non-zero (bit-equal to
the plain version on finite inputs); K5 is one pass, which K6 and K7 launch
too, that stages x-planes of the volume with a halo in shared memory,
asynchronously, and takes the transpose and the weight gradient from that
one staging, one launch per chunk of up to 3 channels (each counted in
``BWD.launches``).  See the source for the design.
"""
from __future__ import annotations

import torch

from . import (_build, check_cuda_f32, checked, grad_needed, register, stream_of,
               use_kernel)
from ..sampling import sample_displacement_unit as sample_displacement_unit_plain

KERNEL = register(
    "warp_unit_fwd",
    source="lagomorph_tpu_torch/csrc/warp_unit.cu",
    replaces="lagomorph_tpu/ops/pallas/warp_unit.py:273, 758",
)
BWD = register(
    "warp_unit_bwd",
    source="lagomorph_tpu_torch/csrc/warp_unit.cu",
    replaces="lagomorph_tpu/ops/pallas/warp_unit.py:607, 627, 1007, 1027",
)


def sample_displacement_unit_bwd_plain(I: torch.Tensor, disp: torch.Tensor,
                                       g: torch.Tensor):
    """Plain version of K5: ``(dI, d_disp)``, the vector-Jacobian product of
    the plain warp with cotangent ``g`` (``dI`` has ``I``'s batch)."""
    with torch.enable_grad():
        I_ = I.detach().requires_grad_(True)
        d_ = disp.detach().requires_grad_(True)
        out = sample_displacement_unit_plain(I_, d_)
        dI, dd = torch.autograd.grad(out, (I_, d_), g)
    return dI, dd


def _launch(I, disp):
    N, _, X, Y, Z = disp.shape
    NI, C = I.shape[:2]
    out = torch.empty((N, C, X, Y, Z), dtype=disp.dtype, device=disp.device)
    _build.call(
        "lagomorph_warp_unit_fwd",
        I.data_ptr(), disp.data_ptr(), out.data_ptr(),
        N, NI, C, X, Y, Z, stream_of(disp),
    )
    KERNEL.launches += 1
    return checked(KERNEL, out)


def _launch_bwd(I, disp, g):
    N, _, X, Y, Z = disp.shape
    NI, C = I.shape[:2]
    dI = torch.empty_like(I)
    dd = torch.empty_like(disp)
    _build.call(
        "lagomorph_warp_unit_bwd",
        I.data_ptr(), disp.data_ptr(), g.data_ptr(), dI.data_ptr(), dd.data_ptr(),
        N, NI, C, X, Y, Z, stream_of(disp),
    )
    BWD.launches += -(-C // 3)  # one launch a chunk of up to 3 channels
    return checked(BWD, (dI, dd))


class _Warp(torch.autograd.Function):
    """K4 under autograd; its backward is K5."""

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
    """Unit-regime warp of ``I`` (``(N or 1, C, X, Y, Z)``) by ``disp``
    (``(N, 3, X, Y, Z)``).  The kernel on CUDA (differentiable through K5),
    the plain version on the CPU; values equal
    :func:`..sampling.sample_displacement_unit`."""
    if not use_kernel(disp):
        return checked(KERNEL, sample_displacement_unit_plain(I, disp))
    check_cuda_f32("sample_displacement_unit", I, disp)
    if disp.dim() != 5 or disp.shape[1] != 3:
        raise ValueError(f"disp must be (N, 3, X, Y, Z), got {tuple(disp.shape)}")
    if I.dim() != 5 or I.shape[0] not in (1, disp.shape[0]) or I.shape[2:] != disp.shape[2:]:
        raise ValueError(
            f"I {tuple(I.shape)} does not match disp {tuple(disp.shape)}"
        )
    if grad_needed(I, disp):
        return _Warp.apply(I, disp)
    return _launch(I, disp)
