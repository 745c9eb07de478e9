"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each kernel module (``warp_unit``, ``epdiff_unit``, ``fft_unit``,
``fft_radix``, ``fft_whole``, ``shoot2d``, ``epdiff2d``, ``warp2d``) holds, for every
kernel, a wrapper that launches the CUDA kernel for tensors on a CUDA
device and the plain PyTorch function of the same signature that it is held
against.  Dispatch is by device and dtype (:func:`use_kernel`):

* a CPU tensor goes to the plain version;
* a tensor of another dtype than float32 goes to the plain version on its
  own device (the JAX package gates its kernels to float32 the same way and
  leaves float64 to XLA);
* a float32 CUDA tensor launches the kernel, or the wrapper raises (mixed
  dtypes, shape, layout).  Nothing falls back to the plain version or to
  the CPU.

The one exception is explicit: inside ``with plain_versions():`` every
wrapper runs its plain version on any device.  That is how a caller puts the
kernels and their plain versions side by side on the card; nothing in the
package enters it on its own.

Under autograd, a kernel launch goes through a ``torch.autograd.Function``
of its module whose backward launches the backward kernel (the fluid
solves K3, K14-K15 and K16 are their own backwards, being self-adjoint).  Flag outputs are marked
non-differentiable.  Autograd hands a backward zeros for an output that
was not used (it materialises them), and may hand it an expanded or
strided view (the cotangent of a ``sum`` has stride 0), so every backward
makes its cotangent contiguous before the launch.  A plain version is
ordinary torch code, which autograd differentiates.

Every kernel is a :class:`Kernel` record in :data:`KERNELS` whose
``launches`` counts the launches of that kernel (not the plain-version calls),
so a run can show that its main path went through the kernels: one a call of
its C entry point, but one a chunk of channels for the warp backwards K5 (3
channels a chunk) and K18 (2), whose entry points launch their pass once a
chunk.  It is the package's only count of launches.

The debug mode (:func:`set_debug_mode`, the package's ``set_debug_mode``)
synchronises the device after every launch and raises its CUDA error under
the entry point's name (``_build.call``), and makes every wrapper, kernel or
plain version, raise ``FloatingPointError`` naming the kernel when an
output holds a non-finite value (:func:`checked`).  It never switches a
kernel to its plain version; while it is off nothing is added to a launch.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch

__all__ = [
    "Kernel",
    "KERNELS",
    "checked",
    "debug_mode",
    "grad_needed",
    "launch_counts",
    "plain_versions",
    "reset_launches",
    "same_versions",
    "set_debug_mode",
    "use_kernel",
]


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, which TPU kernel it
    replaces, and how often it was launched."""

    name: str
    source: str  # path of the CUDA source in the repository
    replaces: str  # file:line of the Pallas kernel it replaces (of the JAX
    # function, where the JAX package has no kernel for it)
    launches: int = 0


KERNELS: dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str) -> Kernel:
    k = Kernel(name, source, replaces)
    KERNELS[name] = k
    return k


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


_PLAIN = contextvars.ContextVar("lagomorph_plain_versions", default=False)
_DEBUG = False


def set_debug_mode(mode: bool = True) -> None:
    """Turn the debug mode on or off for every thread of the process."""
    global _DEBUG
    _DEBUG = bool(mode)


def debug_mode() -> bool:
    return _DEBUG


def checked(kernel: Kernel, out):
    """``out`` (a tensor or a tuple of them) of ``kernel``'s wrapper; in the
    debug mode, ``FloatingPointError`` naming the kernel when a floating
    output holds a non-finite value (the device is read to know)."""
    if _DEBUG:
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(
                    f"{kernel.name}: non-finite value in an output of shape "
                    f"{tuple(t.shape)} (debug mode)")
    return out


@contextlib.contextmanager
def plain_versions():
    """Run every kernel wrapper's plain PyTorch version, on any device, for
    the duration of the block (for comparisons against the kernels)."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def same_versions():
    """The pair of context managers that ``torch.utils.checkpoint``'s
    ``context_fn`` asks for, at the forward: none around the forward, and
    around its recomputation the versions the forward ran
    (:func:`plain_versions` when it was active).  Autograd runs a card's
    backward, and so the recomputation, on a thread of its own, to which the
    context variable does not pass."""
    return contextlib.nullcontext(), plain_versions() if _PLAIN.get() else contextlib.nullcontext()


def use_kernel(t: torch.Tensor) -> bool:
    """True when a wrapper given ``t`` must launch its kernel: ``t`` is a
    float32 tensor on a CUDA device and :func:`plain_versions` is not
    active.  A CPU tensor, or one of another dtype, takes the plain
    version; any other device raises.  The one place the port decides by
    dtype: the kernels take float32 only, as the JAX package's kernel gates
    do (``lagomorph_tpu/ops/pallas/warp_unit.py:68-73``)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return t.dtype == torch.float32 and not _PLAIN.get()


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current CUDA stream on ``t``'s device, for
    a kernel launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on the same
    CUDA device (what the kernels take)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")


def grad_needed(*tensors: torch.Tensor) -> bool:
    """True when autograd records an operation on ``tensors``: grad mode is
    on and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
