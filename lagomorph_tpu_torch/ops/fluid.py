"""Fourier-domain fluid (Helmholtz-type) vector operator.

Port of ``lagomorph_tpu/ops/fluid.py``.  The operator
``L = (-alpha * Laplacian - beta * grad div + gamma)^2`` acts per spatial
frequency ``k`` as a small real symmetric ``d x d`` matrix built from the
discrete eigenvalues ``w_a = 2 (1 - cos(2 pi k_a / N_a))`` and
``s_a = sin(2 pi k_a / N_a)``::

    lambda  = gamma + alpha * sum_a w_a
    l[a][a] = lambda - beta * w_a
    l[a][b] = beta * s_a * s_b          (a != b)
    L       = l @ l

``flat`` multiplies Fourier coefficients by ``L``; ``sharp`` applies the
floored-Cholesky solve whose pivots are ``safe_sqrt`` (``sqrt(x)``, but
``1e-4`` whenever ``x < 1e-8``).

The route a field takes is decided by its shape, the parameters and the
four selectors below (the JAX package's, same values), never by the
device (:func:`fluid_route`):

* ``"fluid_flat"`` (the default for 3D fields with ``beta == 0``): the
  multiplier is one scalar field, so the ``B * d`` component slabs are
  packed in complex pairs (an odd count pads one zero slab) and solved by
  kernel K3 (:func:`.kernels.fft_unit.fluid_flat`);
* ``"fluid_radix"`` (``set_fluid_fft_kernel("radix")``, power-of-two axes):
  the same packed solve by the radix-2 kernels K14, K15, K14
  (:func:`.kernels.fft_radix.fluid_radix`), spectra in bit-reversed order;
* ``"fluid_whole"`` (``set_fluid_mxu_whole(True)``, or ``"auto"`` where
  :func:`mxu_whole_supported`): the same packed solve in one launch of K16
  (:func:`.kernels.fft_whole.fluid_whole`);
* ``"rfftn"`` (the default otherwise): ``rfftn`` -> per-frequency ``d x d``
  product -> ``irfftn`` (``norm="ortho"``);
* ``"packed"`` (``set_fluid_fft_kernel(False)``), ``"batch"``
  (``set_fluid_packing(True)`` with ``beta != 0``: batch halves packed in
  pairs, odd B padded) and ``"dft"`` (``set_fluid_dft(True)``: per-axis DFT
  ``tensordot`` calls): the JAX package's XLA paths, plain PyTorch on every
  device, taken only when a selector asks for them.

Each call of :func:`fluid_operator` adds one to the count
``fluid.route.<route>`` (:func:`..profiling.add`).

On the kernel routes a wrapper launches its kernel for a float32 CUDA
tensor and runs its plain version for a CPU tensor or a tensor of another
dtype (``kernels.use_kernel``): a float64 field on the card takes the
kernel route's plain version there (K3's and K16's is the ``"packed"``
solve), as the JAX package leaves float64 to XLA.
"""
from __future__ import annotations

import numpy as np
import torch

from ..profiling import add as _count
from .fft_radix import bitrev_perm, is_pow2
from .kernels import fft_radix, fft_unit, fft_whole


def fluid_multiplier(spatial, params, inverse: bool, dtype=np.float32) -> np.ndarray:
    """The per-frequency multiplier as one numpy array ``M[d, d,
    *half_spectrum]`` (the layout of the JAX package's ``fluid_multiplier``),
    built in float64 by :func:`fluid_multiplier_entries` and cast to
    ``dtype``."""
    d = len(spatial)
    ent = fluid_multiplier_entries(tuple(spatial), params, inverse, torch.float64,
                                   device="cpu")
    M = torch.stack([torch.stack([ent[max(i, j), min(i, j)] for j in range(d)])
                     for i in range(d)])
    return M.numpy().astype(dtype)


def _inv_safe_sqrt(x):
    """``1 / safe_sqrt(x)``: ``safe_sqrt`` is ``sqrt(x)``, but ``1e-4``
    whenever ``x < 1e-8`` (the floored pivot)."""
    return 1.0 / torch.where(x < 1e-8, torch.full_like(x, 1e-4),
                             torch.sqrt(torch.clamp(x, min=1e-8)))


def _cholesky_inverse(L, d):
    """Entries ``{(a, b): M_ab}`` (a >= b) of the matrix applied by the
    floored-Cholesky solve of the symmetric ``L`` (entries keyed a >= b)."""
    one = torch.ones_like(L[(0, 0)])
    zero = torch.zeros_like(L[(0, 0)])
    if d == 2:
        ooG00 = _inv_safe_sqrt(L[(0, 0)])
        G10 = L[(1, 0)] * ooG00
        ooG11 = _inv_safe_sqrt(L[(1, 1)] - G10 * G10)

        def solve(b0, b1):
            y0 = b0 * ooG00
            y1 = (b1 - G10 * y0) * ooG11
            x1 = y1 * ooG11
            x0 = (y0 - G10 * x1) * ooG00
            return x0, x1

        c00, c10 = solve(one, zero)
        _, c11 = solve(zero, one)
        return {(0, 0): c00, (1, 0): c10, (1, 1): c11}
    if d == 3:
        ooG00 = _inv_safe_sqrt(L[(0, 0)])
        G10 = L[(1, 0)] * ooG00
        G20 = L[(2, 0)] * ooG00
        ooG11 = _inv_safe_sqrt(L[(1, 1)] - G10 * G10)
        G21 = (L[(2, 1)] - G20 * G10) * ooG11
        ooG22 = _inv_safe_sqrt(L[(2, 2)] - G20 * G20 - G21 * G21)

        def solve(b0, b1, b2):
            y0 = b0 * ooG00
            y1 = (b1 - G10 * y0) * ooG11
            y2 = (b2 - G20 * y0 - G21 * y1) * ooG22
            x2 = y2 * ooG22
            x1 = (y1 - G21 * x2) * ooG11
            x0 = (y0 - G10 * x1 - G20 * x2) * ooG00
            return x0, x1, x2

        c00, c10, c20 = solve(one, zero, zero)
        _, c11, c21 = solve(zero, one, zero)
        _, _, c22 = solve(zero, zero, one)
        return {(0, 0): c00, (1, 0): c10, (1, 1): c11,
                (2, 0): c20, (2, 1): c21, (2, 2): c22}
    raise ValueError("Only 2D and 3D fluid operators are supported")


def fluid_multiplier_entries(spatial, params, inverse, dtype=torch.float32,
                             device=None, full_spectrum=False, bitrev=False, band=None):
    """The per-frequency multiplier as torch tensors: a dict
    ``{(a, b): M_ab}`` (``a >= b``) of the symmetric matrix entries, each of
    the half-spectrum shape (or of ``spatial`` with ``full_spectrum``, the
    layout of the complex packed paths).  ``bitrev`` (full spectrum,
    power-of-two axes) puts every axis in the bit-reversed frequency order
    of the radix-2 kernels, as the JAX package's
    ``_fluid_multiplier_traced(bitrev=True)``.  ``band = (axis, start,
    length)`` keeps the frequencies ``start .. start + length - 1`` of one
    axis (the band of one shard of the pencil solve,
    :mod:`..parallel.sharded_fft`).  Built in float64 on ``device`` and
    cast to ``dtype``."""
    alpha, beta, gamma = (float(p) for p in params)
    d = len(spatial)
    freq_shape = list(
        tuple(spatial) if full_spectrum
        else tuple(spatial[:-1]) + (spatial[-1] // 2 + 1,)
    )
    if bitrev and not (full_spectrum and all(is_pow2(n) for n in spatial)):
        raise ValueError("a bit-reversed multiplier needs the full spectrum of power-of-two axes")
    if bitrev and band is not None:
        raise ValueError("a band of a bit-reversed multiplier is not defined")
    start = [0] * d
    if band is not None:
        axis, start[axis], freq_shape[axis] = (int(b) for b in band)
    freq_shape = tuple(freq_shape)
    f64 = dict(dtype=torch.float64, device=device)
    ws, ss = [], []
    for a in range(d):
        k = (torch.as_tensor(bitrev_perm(freq_shape[a]), **f64) if bitrev
             else start[a] + torch.arange(freq_shape[a], **f64))
        shape = [1] * d
        shape[a] = freq_shape[a]
        ang = 2.0 * np.pi * k / spatial[a]
        ws.append((2.0 * (1.0 - torch.cos(ang))).reshape(shape).expand(freq_shape))
        ss.append(torch.sin(ang).reshape(shape).expand(freq_shape))
    lam = gamma + alpha * sum(ws)
    l = {}
    for a in range(d):
        l[(a, a)] = lam - beta * ws[a]
        for b in range(a):
            l[(a, b)] = beta * (ss[a] * ss[b])

    def lget(a, b):
        return l[(a, b)] if a >= b else l[(b, a)]

    L = {}
    for a in range(d):
        for b in range(a + 1):
            acc = None
            for c in range(d):
                term = lget(a, c) * lget(c, b)
                acc = term if acc is None else acc + term
            L[(a, b)] = acc
    if inverse:
        L = _cholesky_inverse(L, d)
    return {key: val.to(dtype).contiguous() for key, val in L.items()}


# ---------------------------------------------------------------------------
# Selectors (the JAX package's, ops/fluid.py:296-548): module globals, read
# when a field's route is decided.  Each returns its previous value.
# ---------------------------------------------------------------------------

_DFT_MATMUL = "auto"  # "auto" resolves to the FFT routes, as in the JAX package
_PACKED_FFT = "auto"
_FFT_KERNEL = "auto"
_MXU_WHOLE = False

# K16's "auto" gate: the packed input, its complex scratch and the output
# (3 * 8 bytes per voxel of each packed pair) fit in the H100's 50 MB L2,
# which holds them between the kernel's phases
L2_BYTES = 50 * 2**20


def _assert_mode(mode, allowed):
    if mode not in allowed:
        raise AssertionError(f"mode {mode!r} not in {allowed}")


def set_fluid_dft(mode):
    """Select the per-axis DFT route: True (``tensordot`` calls with DFT
    matrices, plain PyTorch), False or "auto" (the FFT routes)."""
    global _DFT_MATMUL
    _assert_mode(mode, (True, False, "auto"))
    prev, _DFT_MATMUL = _DFT_MATMUL, mode
    return prev


def set_fluid_packing(mode):
    """Select packed-pair complex transforms: True (slabs in pairs when
    ``beta == 0``, batch halves otherwise), False (``rfftn`` per field) or
    "auto" (the port's default: slab pairs on 3D fields with ``beta == 0``,
    ``rfftn`` otherwise)."""
    global _PACKED_FFT
    _assert_mode(mode, (True, False, "auto"))
    prev, _PACKED_FFT = _PACKED_FFT, mode
    return prev


def set_fluid_fft_kernel(mode):
    """Select the kernel of the packed solve: "auto", True or "mxu" (K3, or
    K16 under :func:`set_fluid_mxu_whole`), "radix" (K14, K15, K14 on
    power-of-two axes) or False (the ``torch.fft`` packed solve)."""
    global _FFT_KERNEL
    _assert_mode(mode, (True, False, "auto", "mxu", "radix"))
    prev, _FFT_KERNEL = _FFT_KERNEL, mode
    return prev


def set_fluid_mxu_whole(mode):
    """Select the whole-volume solve K16 in place of K3: True (forced,
    bypassing its gate), False (the default) or "auto" (where
    :func:`mxu_whole_supported`)."""
    global _MXU_WHOLE
    _assert_mode(mode, (True, False, "auto"))
    prev, _MXU_WHOLE = _MXU_WHOLE, mode
    return prev


def fft_kernel_supported(spatial) -> bool:
    """Gate of the radix-2 route: 3D with power-of-two axes no longer than
    K14's and K15's ``MAX_N`` (lines one block holds in shared memory)."""
    return len(spatial) == 3 and all(is_pow2(n) and n <= fft_radix.MAX_N for n in spatial)


def mxu_whole_supported(shape) -> bool:
    """Gate of K16 under ``set_fluid_mxu_whole("auto")`` for a ``(B, d,
    *spatial)`` field: 3D, and the packed pairs' input, complex scratch and
    output (``3 * 8 * F * V`` bytes, ``F = ceil(B d / 2)`` pairs of ``V``
    voxels) fit in the card's L2 (64^3 b4: 37.7 MB of 50 MB)."""
    if len(shape) != 5:
        return False
    pairs = (shape[0] * shape[1] + 1) // 2
    return 3 * 8 * pairs * int(np.prod(shape[2:])) <= L2_BYTES


def _packing_mode(shape, params):
    """"flat" (the ``B * d`` slabs in pairs: ``beta == 0`` makes the
    multiplier one scalar field), "batch" (batch halves in pairs, ``d x d``
    mixing per packed value) or None (``rfftn``)."""
    if _PACKED_FFT is False:
        return None
    beta = float(params[1])
    if _PACKED_FFT == "auto":
        return "flat" if len(shape) == 5 and beta == 0.0 else None
    if beta == 0.0:
        return "flat" if shape[0] * shape[1] >= 2 else None
    return "batch"


def _fft_kernel_mode(spatial):
    """The kernel of the packed solve: "mxu" (K3 or K16), "radix" (K14,
    K15) or None (``torch.fft``)."""
    if _FFT_KERNEL is False:
        return None
    if _FFT_KERNEL == "radix":
        return "radix" if fft_kernel_supported(spatial) else None
    return "mxu" if len(spatial) == 3 else None


def _use_mxu_whole(shape) -> bool:
    if _MXU_WHOLE is False:
        return False
    if _MXU_WHOLE is True:  # forced: bypasses the gate, as in the JAX package
        return True
    return mxu_whole_supported(shape)


def fluid_route(shape, params) -> str:
    """The route ``fluid_operator`` takes for a ``(B, d, *spatial)`` field
    under the current selectors (the order of the JAX package's
    ``_fluid_apply``): "dft", "rfftn", "batch", "packed", "fluid_flat"
    (K3), "fluid_radix" (K14, K15) or "fluid_whole" (K16)."""
    if _DFT_MATMUL is True:
        return "dft"
    pmode = _packing_mode(shape, params)
    if pmode is None:
        return "rfftn"
    if pmode == "batch":
        return "batch"
    kmode = _fft_kernel_mode(tuple(shape[2:]))
    if kmode == "radix":
        return "fluid_radix"
    if kmode == "mxu":
        return "fluid_whole" if _use_mxu_whole(shape) else "fluid_flat"
    return "packed"


# the multiplier each route takes: (full spectrum, bit-reversed, scalar); a
# scalar route takes the (0, 0) entry alone
_FORMS = {
    "rfftn": (False, False, False),
    "dft": (True, False, False),
    "batch": (True, False, False),
    "packed": (True, False, True),
    "fluid_flat": (True, False, True),
    "fluid_whole": (True, False, True),
    "fluid_radix": (True, True, True),
}
# the packed solves on (2F, *spatial) pairs, by route
_PACKED_SOLVES = {
    "packed": fft_unit.fluid_flat_plain,
    "fluid_flat": fft_unit.fluid_flat,
    "fluid_radix": fft_radix.fluid_radix,
    "fluid_whole": fft_whole.fluid_whole,
}


def multiplier_form(route):
    """``(full_spectrum, bitrev, scalar)`` of the multiplier ``route``
    takes."""
    return _FORMS[route]


def form_multiplier(form, spatial, params, inverse, dtype, device):
    """The multiplier of ``form`` (:func:`multiplier_form`): the scalar
    ``(0, 0)`` entry, or the dict of entries."""
    full, bitrev, scalar = form
    M = fluid_multiplier_entries(spatial, params, inverse, dtype, device,
                                 full_spectrum=full, bitrev=bitrev)
    return M[(0, 0)] if scalar else M


def _mix(F, M, d):
    """The ``d x d`` product per frequency of the spectra ``F[:, b]``."""
    def mget(a, b):
        return M[(a, b)] if a >= b else M[(b, a)]

    return torch.stack([sum(mget(a, b)[None] * F[:, b] for b in range(d)) for a in range(d)], 1)


def _dft_pair(N, dtype, device, inverse):
    """cos and sin matrices of the DFT of length ``N`` (the inverse scaled
    by 1/N), built in float64."""
    n = torch.arange(N, dtype=torch.float64, device=device)
    ang = (2.0 if inverse else -2.0) * np.pi * ((n[:, None] * n[None, :]) % N) / N
    scale = 1.0 / N if inverse else 1.0
    return (torch.cos(ang) * scale).to(dtype), (torch.sin(ang) * scale).to(dtype)


def _apply_dft(mv, params, M):
    """The "dft" route (JAX ``_fluid_apply_dft``): per-axis DFTs as
    ``tensordot`` calls on packed pairs (the slabs when ``beta == 0``, batch
    halves otherwise), the full-spectrum multiplier between them."""
    B, d = mv.shape[:2]
    spatial = tuple(mv.shape[2:])

    def transform(re, im, inverse, dim0):
        for off, N in enumerate(spatial):
            C, S = _dft_pair(N, mv.dtype, mv.device, inverse)

            def t(x, W):
                return torch.tensordot(x.movedim(dim0 + off, -1), W, dims=1).movedim(-1, dim0 + off)

            re, im = t(re, C) - t(im, S), t(re, S) + t(im, C)
        return re, im

    if float(params[1]) == 0.0 and B * d >= 2:
        n = B * d
        x = mv.reshape((n,) + spatial)
        if n % 2:
            x = torch.cat([x, x.new_zeros((1,) + spatial)])
        half = x.shape[0] // 2
        re, im = transform(x[:half], x[half:], False, 1)
        re, im = transform(re * M[(0, 0)], im * M[(0, 0)], True, 1)
        return torch.cat([re, im])[:n].reshape(mv.shape)
    x = mv if B % 2 == 0 else torch.cat([mv, mv.new_zeros((1,) + mv.shape[1:])])
    half = x.shape[0] // 2
    re, im = transform(x[:half], x[half:], False, 2)
    re, im = transform(_mix(re, M, d), _mix(im, M, d), True, 2)
    return torch.cat([re, im])[:B]


def _apply_batch(mv, M):
    """The "batch" route (JAX ``_fluid_apply_packed`` "batch"/"batch_pad"):
    batch halves packed in complex pairs (odd B padded by a zero field),
    ``fftn``, ``d x d`` mixing, ``ifftn``."""
    B, d = mv.shape[:2]
    x = mv if B % 2 == 0 else torch.cat([mv, mv.new_zeros((1,) + mv.shape[1:])])
    half = x.shape[0] // 2
    dims = tuple(range(2, mv.dim()))
    F = torch.fft.fftn(torch.complex(x[:half], x[half:]), dim=dims)
    y = torch.fft.ifftn(_mix(F, M, d), dim=dims)
    return torch.cat([y.real, y.imag])[:B]


def fluid_operator(mv: torch.Tensor, params, inverse: bool, M=None) -> torch.Tensor:
    """Apply the fluid operator (``inverse=False``) or its floored-Cholesky
    inverse to a batch of vector fields ``mv`` of shape ``(N, dim,
    *spatial)``, on the route :func:`fluid_route` gives.

    ``M``: the multiplier of that route (:func:`multiplier_form`,
    :func:`form_multiplier`); built here when None.  Counts the call under
    ``fluid.route.<route>``."""
    B, dim = mv.shape[:2]
    spatial = tuple(mv.shape[2:])
    if dim != len(spatial):
        raise ValueError("Vector field has incorrect shape for dimension")
    route = fluid_route(mv.shape, params)
    _count("fluid.route." + route, 1)
    if M is None:
        M = form_multiplier(multiplier_form(route), spatial, params, inverse, mv.dtype,
                            mv.device)
    if route == "dft":
        return _apply_dft(mv, params, M)
    if route == "batch":
        return _apply_batch(mv, M)
    if route == "rfftn":
        dims = tuple(range(2, 2 + dim))
        F = torch.fft.rfftn(mv, dim=dims, norm="ortho")
        return torch.fft.irfftn(_mix(F, M, dim), s=spatial, dim=dims, norm="ortho")
    n = B * dim
    x = mv.reshape((n,) + spatial)
    if n % 2:
        x = torch.cat([x, x.new_zeros((1,) + spatial)])
    return _PACKED_SOLVES[route](x, M)[:n].reshape(mv.shape)
