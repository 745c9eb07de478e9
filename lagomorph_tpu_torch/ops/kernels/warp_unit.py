"""K4: the unit-regime warp, forward (``csrc/warp_unit.cu``).

``out(p) = sum_{o in {-1,0,1}^3} w_o(d(p)) * I[clamp(p + o)]``: exact
multilinear CLAMP sampling of ``I`` at ``p + d(p)`` wherever every
displacement component lies in ``[-1, 1)``.

Replaces ``lagomorph_tpu/ops/pallas/warp_unit.py`` ``_fwd_kernel`` and
``_fwd_kernel_yb`` (the forward of ``sample_displacement_unit_pallas``).  On
the H100 the kernel is bound by memory (one read of the displacement, one
write of the output; the 27 taps of ``I`` come from cache); see the source
for the design.
"""
from __future__ import annotations

import torch

from . import _build, check_cuda_f32, forward_only, register, stream_of, use_kernel
from ..sampling import sample_displacement_unit as sample_displacement_unit_plain

KERNEL = register(
    "warp_unit_fwd",
    source="lagomorph_tpu_torch/csrc/warp_unit.cu",
    replaces="lagomorph_tpu/ops/pallas/warp_unit.py:273, 758",
)


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
    return out


def sample_displacement_unit(I: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Unit-regime warp of ``I`` (``(N or 1, C, X, Y, Z)``) by ``disp``
    (``(N, 3, X, Y, Z)``).  The kernel on CUDA, the plain version on the
    CPU; values equal :func:`..sampling.sample_displacement_unit`."""
    if not use_kernel(disp):
        return sample_displacement_unit_plain(I, disp)
    check_cuda_f32("sample_displacement_unit", I, disp)
    if disp.dim() != 5 or disp.shape[1] != 3:
        raise ValueError(f"disp must be (N, 3, X, Y, Z), got {tuple(disp.shape)}")
    if I.dim() != 5 or I.shape[0] not in (1, disp.shape[0]) or I.shape[2:] != disp.shape[2:]:
        raise ValueError(
            f"I {tuple(I.shape)} does not match disp {tuple(disp.shape)}"
        )
    return forward_only(_launch, I, disp)
