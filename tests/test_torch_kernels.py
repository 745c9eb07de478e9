"""The port's kernel modules: each kernel's plain version against its JAX
counterpart on the CPU (float64), the autograd glue around the kernels,
and the dispatch rules.  The kernels themselves are held against their
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

* K1 ``epdiff_unit.ad_star`` vs ``lm.Ad_star(..., mode="unit")``;
* K2 ``epdiff_unit.compose`` vs ``lm.compose_disp_vel(..., mode="unit")``;
* K4 ``warp_unit.sample_displacement_unit`` vs
  ``ops.sampling.sample_displacement_unit``;
* K3 ``fft_unit.fluid_flat`` (through ``FluidMetric.sharp``) vs the JAX
  ``FluidMetric.sharp``;
* the backwards K5, K6, K7 (``*_bwd_plain``) vs ``jax.vjp`` of the same
  JAX functions, and K3's backward (the solve itself) vs ``jax.vjp`` of
  ``FluidMetric.sharp``;
* the K1/K2 flags vs ``lddmm._in_unit``.

On the CPU every ``*_supported()`` gate of the JAX package is false, so it
computes these functions through its plain formulations.  Tolerances: the
stencils do the same float64 operations in the same order (1e-12 absolute;
they come out bit-equal); the fluid solve goes through two libraries' FFTs
(1e-9 relative to max|ref|); the backwards sum the same float64 terms in
another order than JAX's autodiff (1e-10 * (1 + max|ref|)).
"""
import collections
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lagomorph_tpu as lm
from lagomorph_tpu import lddmm as jlddmm
from lagomorph_tpu.ops import sampling as jsamp
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch.ops import kernels
from lagomorph_tpu_torch.ops.kernels import epdiff_unit, fft_unit, warp_unit

torch.set_num_threads(2)

STENCIL_ATOL = 1e-12
FFT_RTOL = 1e-9
BWD_RTOL = 1e-10  # of 1 + max|ref|: another summation order than JAX's autodiff
SHAPES = [(2, 3, 16, 12, 20), (1, 3, 9, 8, 7)]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(ref, got, atol=STENCIL_ATOL):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("m_batch", ["one", "N"])
def test_ad_star_plain_matches_jax(rng, shape, m_batch):
    phiinv = rng.uniform(-1, 1, shape)
    m0 = rng.standard_normal(((1 if m_batch == "one" else shape[0]),) + shape[1:])
    out, flag = epdiff_unit.ad_star(t(phiinv), t(m0))
    close(lm.Ad_star(jnp.asarray(phiinv), jnp.asarray(m0), mode="unit"), out)
    assert bool(flag) is bool(jlddmm._in_unit(jnp.asarray(phiinv))) is True


@pytest.mark.parametrize("shape", SHAPES)
def test_compose_plain_matches_jax(rng, shape):
    phiinv = rng.uniform(-1, 1, shape)
    v = rng.uniform(-4.9, 4.9, shape)
    out, flag = epdiff_unit.compose(t(phiinv), t(v), -0.2)
    close(lm.compose_disp_vel(jnp.asarray(phiinv), jnp.asarray(v), dt=-0.2, mode="unit"), out)
    assert bool(flag) is bool(jlddmm._in_unit(-0.2 * jnp.asarray(v))) is True


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("channels,image_batch", [(1, "one"), (3, "N")])
def test_warp_unit_plain_matches_jax(rng, shape, channels, image_batch):
    I = rng.standard_normal(((1 if image_batch == "one" else shape[0]), channels) + shape[2:])
    d = rng.uniform(-1, 1, shape)
    close(jsamp.sample_displacement_unit(jnp.asarray(I), jnp.asarray(d)),
          warp_unit.sample_displacement_unit(t(I), t(d)))


@pytest.mark.parametrize("shape", SHAPES)
def test_fluid_flat_plain_matches_jax_sharp(rng, shape):
    """K3's plain version, reached through FluidMetric.sharp (beta = 0; the
    (1, 3, ...) shape packs an odd slab count with one zero slab)."""
    m = rng.standard_normal(shape)
    ref = np.asarray(lm.FluidMetric((0.1, 0.0, 0.01)).sharp(jnp.asarray(m)))
    before = kernels.launch_counts()
    got = lt.FluidMetric((0.1, 0.0, 0.01)).sharp(t(m))
    close(ref, got, atol=FFT_RTOL * float(np.abs(ref).max()))
    assert kernels.launch_counts() == before  # the plain version launches nothing


@pytest.mark.parametrize("where,value,expect", [
    (None, 0.0, True), ((0, 2, 3, 4, 5), 1.0, False), ((1, 0, 0, 0, 0), -1.0, True),
    ((0, 1, 8, 11, 19), -1.0000001, False), ((1, 2, 0, 0, 1), np.nan, False),
])
def test_flags_match_jax_in_unit(rng, where, value, expect):
    """K1's flag (of phiinv) and K2's flag (of s*v) against lddmm._in_unit,
    at the half-open bounds [-1, 1)."""
    shape = SHAPES[0]
    p = rng.uniform(-0.9, 0.9, shape)
    if where is not None:
        p[where] = value
    m0 = rng.standard_normal(shape)
    assert bool(epdiff_unit.ad_star(t(p), t(m0))[1]) is expect
    assert bool(jlddmm._in_unit(jnp.asarray(p))) is expect
    # compose flags s*v; s = 1 makes s*v = p exactly
    assert bool(epdiff_unit.compose(t(m0), t(p), 1.0)[1]) is expect


def test_plain_versions_context_and_counters(rng):
    """On the CPU the wrappers take the plain versions and count no
    launches; plain_versions() is explicit and scoped; a device without
    kernels raises."""
    shape = SHAPES[1]
    p = t(rng.uniform(-1, 1, shape))
    kernels.reset_launches()
    assert set(kernels.launch_counts()) == {
        "warp_unit_fwd", "ad_star_fwd", "compose_fwd", "fluid_flat",
        "warp_unit_bwd", "ad_star_bwd", "compose_bwd", "shoot2d_fwd", "shoot2d_bwd",
        "ad_star2d_fwd", "compose2d_fwd", "ad_star2d_bwd", "compose2d_bwd"}
    a = epdiff_unit.ad_star(p, p)[0]
    with kernels.plain_versions():
        assert kernels._PLAIN.get()
        b = epdiff_unit.ad_star_plain(p, p)[0]
    assert not kernels._PLAIN.get()
    assert torch.equal(a, b)
    assert all(n == 0 for n in kernels.launch_counts().values())
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.use_kernel(torch.empty(1, device="meta"))
    for k in kernels.KERNELS.values():
        assert k.source.startswith("lagomorph_tpu_torch/csrc/") and k.source.endswith(".cu")
        assert k.replaces.startswith("lagomorph_tpu/ops/pallas/")


def test_plain_versions_differentiate_on_cpu(rng):
    """On the CPU the plain versions are ordinary differentiable torch code:
    the warp's gradient in the image slot sums to the number of output
    voxels (each output's 27 weights sum to 1)."""
    d = t(rng.uniform(-0.9, 0.9, SHAPES[0]))
    I = t(rng.standard_normal((1, 1) + SHAPES[0][2:])).requires_grad_(True)
    warp_unit.sample_displacement_unit(I, d).sum().backward()
    n_out = SHAPES[0][0] * int(np.prod(SHAPES[0][2:]))
    assert abs(float(I.grad.sum()) - n_out) < 1e-9 * n_out


def close_bwd(ref, got):
    ref = np.asarray(ref)
    close(ref, got, atol=BWD_RTOL * (1.0 + float(np.abs(ref).max())))


@functools.lru_cache(maxsize=None)
def _jax_vjp(name, s=None):
    """``jax.vjp`` of one JAX function, jitted once per function (one
    compile per shape is cheaper than op-by-op dispatch)."""
    fns = {
        "warp": jsamp.sample_displacement_unit,
        "ad_star": lambda p, m: lm.Ad_star(p, m, mode="unit"),
        "compose": lambda p, v: lm.compose_disp_vel(p, v, dt=s, mode="unit"),
        "sharp": lm.FluidMetric((0.1, 0.0, 0.01)).sharp,
    }
    f = fns[name]
    return jax.jit(lambda g, *args: jax.vjp(f, *args)[1](g))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("channels,image_batch", [(1, "one"), (3, "N")])
def test_warp_unit_bwd_plain_matches_jax_vjp(rng, shape, channels, image_batch):
    """K5's plain version: dI (summed over the batch for a batch-1 image)
    and d_disp."""
    I = rng.standard_normal(((1 if image_batch == "one" else shape[0]), channels) + shape[2:])
    d = rng.uniform(-1, 1, shape)
    g = rng.standard_normal((shape[0], channels) + shape[2:])
    rI, rd = _jax_vjp("warp")(jnp.asarray(g), jnp.asarray(I), jnp.asarray(d))
    dI, dd = warp_unit.sample_displacement_unit_bwd_plain(t(I), t(d), t(g))
    close_bwd(rI, dI)
    close_bwd(rd, dd)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("m_batch", ["one", "N"])
def test_ad_star_bwd_plain_matches_jax_vjp(rng, shape, m_batch):
    """K6's plain version (the composed backward, with K1's mw residual)."""
    phiinv = rng.uniform(-1, 1, shape)
    m0 = rng.standard_normal(((1 if m_batch == "one" else shape[0]),) + shape[1:])
    g = rng.standard_normal(shape)
    rp, rm = _jax_vjp("ad_star")(jnp.asarray(g), jnp.asarray(phiinv), jnp.asarray(m0))
    _, _, mw = epdiff_unit.ad_star_plain(t(phiinv), t(m0), want_mw=True)
    dp, dm = epdiff_unit.ad_star_bwd_plain(t(phiinv), t(m0), t(g), mw)
    close_bwd(rp, dp)
    close_bwd(rm, dm)


@pytest.mark.parametrize("shape", SHAPES)
def test_compose_bwd_plain_matches_jax_vjp(rng, shape):
    """K7's plain version, with the step scale s = -0.2 of expmap."""
    phiinv = rng.uniform(-1, 1, shape)
    v = rng.uniform(-4.9, 4.9, shape)
    g = rng.standard_normal(shape)
    rp, rv = _jax_vjp("compose", -0.2)(jnp.asarray(g), jnp.asarray(phiinv), jnp.asarray(v))
    dp, dv = epdiff_unit.compose_bwd_plain(t(phiinv), t(v), -0.2, t(g))
    close_bwd(rp, dp)
    close_bwd(rv, dv)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharp_backward_matches_jax_vjp(rng, shape):
    """The backward of the fluid solve (K3's backward is K3 itself): torch
    autograd through FluidMetric.sharp against jax.vjp, and equal to sharp
    of the cotangent (self-adjoint)."""
    m = rng.standard_normal(shape)
    g = rng.standard_normal(shape)
    (ref,) = _jax_vjp("sharp")(jnp.asarray(g), jnp.asarray(m))
    metric = lt.FluidMetric((0.1, 0.0, 0.01))
    tm = t(m).requires_grad_(True)
    (got,) = torch.autograd.grad(metric.sharp(tm), tm, t(g))
    close(ref, got, atol=FFT_RTOL * float(np.abs(np.asarray(ref)).max()))
    close(metric.sharp(t(g)), got, atol=FFT_RTOL * float(got.abs().max()))


@pytest.fixture
def kernel_glue(monkeypatch):
    """Route the wrappers through their autograd Functions on the CPU:
    ``use_kernel`` is true, the device check is skipped, and every
    ``_launch*`` is replaced by its plain version, which first asserts that
    it was handed contiguous tensors (what the kernels take).  Yields the
    count of calls of each replaced ``_launch*``, by plain-version name."""
    calls = collections.Counter()

    def contiguous(fn):
        def launch(*args, **kw):
            for a in args:
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), f"{fn.__name__} handed a non-contiguous tensor"
            calls[fn.__name__] += 1
            return fn(*args, **kw)
        return launch

    for mod in (warp_unit, epdiff_unit, fft_unit):  # as for a tensor on the card
        monkeypatch.setattr(mod, "use_kernel", lambda _t: not kernels._PLAIN.get())
        monkeypatch.setattr(mod, "check_cuda_f32", lambda _name, *_ts: None)
    for mod, name, plain in (
        (warp_unit, "_launch", warp_unit.sample_displacement_unit_plain),
        (warp_unit, "_launch_bwd", warp_unit.sample_displacement_unit_bwd_plain),
        (epdiff_unit, "_launch_ad_star", epdiff_unit.ad_star_plain),
        (epdiff_unit, "_launch_ad_star_bwd", epdiff_unit.ad_star_bwd_plain),
        (epdiff_unit, "_launch_compose", epdiff_unit.compose_plain),
        (epdiff_unit, "_launch_compose_bwd", epdiff_unit.compose_bwd_plain),
        (fft_unit, "_launch", fft_unit.fluid_flat_plain),
    ):
        monkeypatch.setattr(mod, name, contiguous(plain))
    return calls


def _grads(fn, inputs, cot):
    """Gradients of ``fn(*inputs)`` in every input under three cotangents:
    a dense one, the expanded ones of ``sum`` (stride 0) and a transposed
    view (strided)."""
    out = []
    for how in ("dense", "sum", "strided"):
        leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
        y = fn(*leaves)
        if how == "dense":
            loss = (y * cot).sum()
        elif how == "sum":
            loss = y.sum()
        else:
            loss = (y.transpose(2, 4) * cot.transpose(2, 4).contiguous()).sum()
        out.append(torch.autograd.grad(loss, leaves))
    return out


@pytest.mark.parametrize("case", ["warp_atlas", "warp_N3", "ad_star_m1", "ad_star_mN",
                                  "compose", "fluid_flat", "sharp_odd"])
def test_autograd_functions_match_plain(rng, kernel_glue, case):
    """The Functions around the kernel launches, on the CPU with every
    launch replaced by its plain version: gradients equal autograd of the
    plain forward (under ``plain_versions()``), for batch-1 operands
    (summed over the batch), the flag outputs (non-differentiable, unused),
    the step scale s and non-contiguous cotangents."""
    shape = SHAPES[1] if case == "sharp_odd" else SHAPES[0]
    N, _, X, Y, Z = shape
    p = t(rng.uniform(-0.95, 0.95, shape))
    if case.startswith("warp"):
        C, NI = (1, 1) if case == "warp_atlas" else (3, N)
        I = t(rng.standard_normal((NI, C, X, Y, Z)))
        fn, plain, inputs = (warp_unit.sample_displacement_unit,
                             warp_unit.sample_displacement_unit_plain, (I, p))
        cot = t(rng.standard_normal((N, C, X, Y, Z)))
    elif case.startswith("ad_star"):
        m0 = t(rng.standard_normal(((1 if case == "ad_star_m1" else N),) + shape[1:]))
        fn, plain, inputs = (lambda a, b: epdiff_unit.ad_star(a, b)[0],
                             lambda a, b: epdiff_unit.ad_star_plain(a, b)[0], (p, m0))
        cot = t(rng.standard_normal(shape))
    elif case == "compose":
        v = t(rng.uniform(-4.9, 4.9, shape))
        fn, plain, inputs = (lambda a, b: epdiff_unit.compose(a, b, -0.2)[0],
                             lambda a, b: epdiff_unit.compose_plain(a, b, -0.2)[0], (p, v))
        cot = t(rng.standard_normal(shape))
    elif case == "fluid_flat":  # (1, 2N, X, Y, Z) views of the (2N, X, Y, Z) pairs
        Mn = lt.FluidMetric((0.1, 0.0, 0.01)).multiplier(shape, torch.float64, "cpu", True)
        fn, plain, inputs = (lambda a: fft_unit.fluid_flat(a, Mn)[None],
                             lambda a: fft_unit.fluid_flat_plain(a, Mn)[None],
                             (t(rng.standard_normal((2 * N, X, Y, Z))),))
        cot = t(rng.standard_normal((1, 2 * N, X, Y, Z)))
    else:  # sharp of an odd slab count: fluid_operator pads a zero slab, slices [:n]
        metric = lt.FluidMetric((0.1, 0.0, 0.01))
        fn = plain = metric.sharp
        inputs = (t(rng.standard_normal(shape)),)
        cot = t(rng.standard_normal(shape))
    got = _grads(fn, inputs, cot)
    backward = next(b for prefix, b in (
        ("warp", "sample_displacement_unit_bwd_plain"), ("ad_star", "ad_star_bwd_plain"),
        ("compose", "compose_bwd_plain"), ("", "fluid_flat_plain")) if case.startswith(prefix))
    assert kernel_glue[backward] >= 3  # one backward per cotangent, through the Function
    with kernels.plain_versions():
        ref = _grads(plain, inputs, cot)
    for g_case, r_case in zip(got, ref):
        for g, r in zip(g_case, r_case):
            assert g.shape == r.shape
            close_bwd(r.numpy(), g)
    if case.startswith("ad_star") or case == "compose":
        out, flag = (epdiff_unit.ad_star(p.requires_grad_(True), inputs[1]) if case != "compose"
                     else epdiff_unit.compose(p.requires_grad_(True), inputs[1], -0.2))
        assert out.requires_grad and not flag.requires_grad and flag.dtype == torch.bool


def test_atlas_step_through_functions_matches_plain(rng, kernel_glue):
    """One atlas step (5 integration steps, batch-1 atlas, momenta in the
    unit regime) through the Functions equals the step through the plain
    versions, and makes the launches of the card's main path: per step K1
    4, K2 4, K3 10 (5 solves, 5 backwards), K4 1, K5 1, K6 4, K7 4."""
    shape = SHAPES[0]
    metric = lt.FluidMetric((0.1, 0.0, 0.01))
    m = rng.standard_normal(shape)
    m = t(m * (0.5 / float(metric.sharp(t(m)).abs().max())))
    I = t(rng.standard_normal((1, 1) + shape[2:]))
    img = t(rng.standard_normal((shape[0], 1) + shape[2:]))
    step = lt.make_lddmm_atlas_step(metric, reg_weight=0.1, learning_rate_pose=1e-4)
    kernel_glue.clear()
    got = step(I, m, img)
    assert dict(kernel_glue) == {
        "ad_star_plain": 4, "compose_plain": 4, "fluid_flat_plain": 10,
        "sample_displacement_unit": 1, "sample_displacement_unit_bwd_plain": 1,
        "ad_star_bwd_plain": 4, "compose_bwd_plain": 4}
    with kernels.plain_versions():
        ref = step(I, m, img)
    for r, g in zip(ref, got):
        close_bwd(r.numpy(), g)
