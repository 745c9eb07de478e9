"""The port's radix-2 and whole-volume fluid solves and the fluid-transform
selectors that route to them, against the JAX package on the CPU.

* ``ops/fft_radix`` (``fft_dif``, ``fft_dit``, ``fftn_br``, ``ifftn_br``)
  against ``lagomorph_tpu.ops.fft_radix`` in float64, 1e-12 * max|ref|;
* the bit-reversed multiplier against ``_fluid_multiplier_traced(bitrev=
  True)`` in float64, 1e-12 * max|ref|;
* the plain K14 (both directions) and K15 against the TPU kernels
  ``_zy_call`` and ``_x_mul_call`` themselves, the plain pipeline against
  ``fluid_flat_pallas`` (Pallas in interpret mode, float32): 5e-6 * max|ref|,
  float32 butterflies in another rounding;
* K16's plain version against ``fluid_flat_mxu_whole`` in interpret mode,
  1e-4 * max|ref| (the TPU kernel's 3-pass bf16 matmuls, ``_dot3``);
* every selector: its values, the assert on a bad mode, the previous value
  returned, and the route a field takes;
* ``FluidMetric.sharp`` / ``flat`` on every route against the JAX
  ``_fluid_apply`` (1e-9 * max|ref|, float64: two libraries' FFTs), and the
  packed and DFT routes against ``_fluid_apply_packed`` /
  ``_fluid_apply_dft``; a metric used across a selector change;
* the atlas step on the radix and whole routes against the JAX step, and
  the backward against ``jax.vjp`` of ``_fluid_apply``, in float64;
* the autograd Functions around K14-K16 with their launches replaced by
  the plain versions (launch counts per step).

The kernels themselves are held against their plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
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
from lagomorph_tpu.ops import fft_radix as jfr
from lagomorph_tpu.ops import fluid as jfl
from lagomorph_tpu.ops import set_warp_mode
from lagomorph_tpu.ops.pallas import fft_unit as jfu
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch.ops import fft_radix as tfr
from lagomorph_tpu_torch.ops import fluid as tfl
from lagomorph_tpu_torch.ops import kernels
from lagomorph_tpu_torch.ops.kernels import fft_radix, fft_unit, fft_whole

torch.set_num_threads(2)

PARAMS = (0.1, 0.0, 0.01)
PARAMS_BETA = (0.1, 0.03, 0.01)
RADIX_RTOL = 1e-12  # float64, the same butterflies in another order
PALLAS_RTOL = 5e-6  # float32 against the Pallas kernels in interpret mode
WHOLE_RTOL = 1e-4  # the TPU whole kernel's 3-pass bf16 DFT matmuls
FFT_RTOL = 1e-9  # float64, two libraries' FFTs
# the JAX packed path builds its multiplier in float32 (ops/fluid.py:591-593)
PACKED_RTOL = 1e-6
STEP_SHAPE = (2, 3, 16, 16, 16)
SETTERS = {  # selector: (its values, its default)
    "set_fluid_dft": ((True, False, "auto"), "auto"),
    "set_fluid_packing": ((True, False, "auto"), "auto"),
    "set_fluid_fft_kernel": ((True, False, "auto", "mxu", "radix"), "auto"),
    "set_fluid_mxu_whole": ((True, False, "auto"), False),
}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close_rel(ref, got, rtol):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


@pytest.fixture
def selectors():
    """Every selector of the port and of the JAX package at its default
    for the test, and restored after it."""
    saved = []
    for mod in (tfl, jfl):
        for name, (_, default) in SETTERS.items():
            setter = getattr(mod, name)
            saved.append((setter, setter(default)))
    yield
    for setter, prev in saved:
        setter(prev)


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's Pallas fluid kernels in interpret mode (as
    tests/test_fft_radix.py runs them)."""
    monkeypatch.setattr(jfu.pl, "pallas_call",
                        functools.partial(jfu.pl.pallas_call, interpret=True))


# ---------------------------------------------------------------------------
# ops/fft_radix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn,axes,inverse", [
    ("fft_dif", 1, False), ("fft_dif", 3, True), ("fft_dit", 2, True), ("fft_dit", 1, False),
    ("fftn_br", (1, 2, 3), None), ("ifftn_br", (3, 1), None)])
def test_radix_stages_match_jax(rng, fn, axes, inverse):
    shape = (2, 8, 16, 4)
    re, im = rng.standard_normal(shape), rng.standard_normal(shape)
    extra = () if inverse is None else (inverse,)
    ref = getattr(jfr, fn)(jnp.asarray(re), jnp.asarray(im), axes, *extra)
    got = getattr(tfr, fn)(t(re), t(im), axes, *extra)
    for r, g in zip(ref, got):
        close_rel(r, g, RADIX_RTOL)
    assert tfr.is_pow2(8) and not tfr.is_pow2(1) and not tfr.is_pow2(12)
    np.testing.assert_array_equal(tfr.bitrev_perm(16), jfr.bitrev_perm(16))


@pytest.mark.parametrize("params", [PARAMS, PARAMS_BETA])
@pytest.mark.parametrize("inverse", [True, False])
def test_bitrev_multiplier_matches_jax(params, inverse):
    spatial = (8, 16, 4)
    ref = jfl._fluid_multiplier_traced(spatial, params, inverse, jnp.float64,
                                       full_spectrum=True, bitrev=True)
    got = tfl.fluid_multiplier_entries(spatial, params, inverse, torch.float64,
                                       full_spectrum=True, bitrev=True)
    assert set(got) == set(ref)
    for key in ref:
        close_rel(ref[key], got[key], RADIX_RTOL)
    with pytest.raises(ValueError):
        tfl.fluid_multiplier_entries((8, 12, 4), params, inverse, torch.float64,
                                     full_spectrum=True, bitrev=True)


def test_fluid_apply_radix_ref_matches_jax(rng):
    """The port's radix oracle on both packings against the JAX
    ``_fluid_apply``, float64."""
    mv = rng.standard_normal((3, 3, 8, 4, 16))
    for params in (PARAMS, PARAMS_BETA):
        for inverse in (True, False):
            ref = jfl._fluid_apply(jnp.asarray(mv), params, inverse)
            close_rel(ref, tfr.fluid_apply_radix_ref(t(mv), params, inverse), FFT_RTOL)


# ---------------------------------------------------------------------------
# the plain K14, K15 and K16 against the TPU kernels (interpret mode)
# ---------------------------------------------------------------------------

F_, X_, Y_, Z_ = 2, 8, 8, 16  # Y * Z = 128: the x kernel's lane blocks


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("inverse", [False, True])
def test_radix_zy_plain_matches_pallas(rng, jax_interpret, inverse):
    re, im = _f32(rng, (F_, X_, Y_, Z_)), _f32(rng, (F_, X_, Y_, Z_))
    kernel = jfu._zy_inv_kernel if inverse else jfu._zy_fwd_kernel
    with jax.enable_x64(False):
        ref = jfu._zy_call(kernel, Y_, Z_, jnp.asarray(re.reshape(F_, X_, -1)),
                           jnp.asarray(im.reshape(F_, X_, -1)))
    got = fft_radix.radix_zy_plain(t(re), t(im), inverse)
    for r, g in zip(ref, got):
        close_rel(np.asarray(r).reshape(F_, X_, Y_, Z_), g, PALLAS_RTOL)
    # the wrapper on (2F, X, Y, Z) pairs takes the plain version on the CPU
    pairs = fft_radix.radix_zy(t(np.concatenate([re, im])), inverse)
    assert torch.equal(pairs, torch.cat(got))


def _mbr(spatial, dtype=jnp.float32):
    return np.array(jfl._fluid_multiplier_traced(spatial, PARAMS, True, dtype,
                                                   full_spectrum=True, bitrev=True)[(0, 0)])


def test_radix_x_plain_matches_pallas(rng, jax_interpret):
    re, im = _f32(rng, (F_, X_, Y_, Z_)), _f32(rng, (F_, X_, Y_, Z_))
    with jax.enable_x64(False):
        Mbr = _mbr((X_, Y_, Z_))
        ref = jfu._x_mul_call(jnp.asarray(re.reshape(F_, X_, -1)),
                              jnp.asarray(im.reshape(F_, X_, -1)), jnp.asarray(Mbr.reshape(X_, -1)))
    got = fft_radix.radix_x_plain(t(re), t(im), t(Mbr))
    for r, g in zip(ref, got):
        close_rel(np.asarray(r).reshape(F_, X_, Y_, Z_), g, PALLAS_RTOL)
    pairs = fft_radix.radix_x(t(np.concatenate([re, im])), t(Mbr))
    assert torch.equal(pairs, torch.cat(got))


def test_radix_pipeline_plain_matches_pallas(rng, jax_interpret):
    """The plain K14, K15, K14 pipeline against ``fluid_flat_pallas``, and
    through ``fluid_radix`` and the port's own bit-reversed multiplier."""
    x = _f32(rng, (2 * F_, X_, Y_, Z_))
    with jax.enable_x64(False):
        Mbr = _mbr((X_, Y_, Z_))
        ref = jfu.fluid_flat_pallas(jnp.asarray(x[:F_]), jnp.asarray(x[F_:]), jnp.asarray(Mbr))
    ref = np.concatenate([np.asarray(r) for r in ref])
    close_rel(ref, fft_radix.fluid_radix_plain(t(x), t(Mbr)), PALLAS_RTOL)
    port_Mbr = lt.FluidMetric(PARAMS)._entries((X_, Y_, Z_), torch.float32, "cpu", True,
                                               tfl.multiplier_form("fluid_radix"))
    close_rel(ref, fft_radix.fluid_radix(t(x), port_Mbr), PALLAS_RTOL)


@pytest.mark.parametrize("spatial", [(16, 8, 64), (24, 8, 64)])
def test_fluid_whole_plain_matches_pallas(rng, jax_interpret, spatial):
    x = _f32(rng, (4,) + spatial)
    with jax.enable_x64(False):
        Mn = jfl._fluid_multiplier_traced(spatial, PARAMS, True, jnp.float32,
                                          full_spectrum=True)[(0, 0)]
        fwd = tuple(jfl._dft_pair(n, jnp.float32, False) for n in spatial)
        inv = tuple(jfl._dft_pair(n, jnp.float32, True) for n in spatial)
        ref = jfu.fluid_flat_mxu_whole(jnp.asarray(x[:2]), jnp.asarray(x[2:]), Mn, fwd, inv)
    ref = np.concatenate([np.asarray(r) for r in ref])
    close_rel(ref, fft_whole.fluid_whole(t(x), t(np.array(Mn))), WHOLE_RTOL)


# ---------------------------------------------------------------------------
# selectors and routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SETTERS))
def test_selector_values_and_previous(selectors, name):
    """Each selector takes the JAX package's values, returns the previous
    one, and refuses another with the JAX package's AssertionError."""
    values, default = SETTERS[name]
    port, jaxs = getattr(lt, name), getattr(jfl, name)
    assert port is getattr(tfl, name) and port is getattr(lt.ops, name)
    prev = default
    for v in values + values[:1]:
        assert port(v) == prev
        assert jaxs(v) == prev
        prev = v
    for fn in (port, jaxs):
        with pytest.raises(AssertionError):
            fn("bogus")
    assert port(default) == prev


FULL64, FULL128 = (4, 3, 64, 64, 64), (4, 3, 128, 128, 128)


@pytest.mark.parametrize("settings,shape,params,route", [
    ({}, (2, 3, 8, 8, 8), PARAMS, "fluid_flat"),
    ({}, (2, 3, 8, 8, 8), PARAMS_BETA, "rfftn"),
    ({}, (2, 2, 8, 8), PARAMS, "rfftn"),
    ({"set_fluid_fft_kernel": "radix"}, (2, 3, 8, 16, 4), PARAMS, "fluid_radix"),
    ({"set_fluid_fft_kernel": "radix"}, (2, 3, 8, 12, 4), PARAMS, "packed"),
    ({"set_fluid_fft_kernel": "radix"}, (2, 3, 8, 8, 8), PARAMS_BETA, "rfftn"),
    ({"set_fluid_fft_kernel": "radix", "set_fluid_mxu_whole": True}, (2, 3, 8, 8, 8), PARAMS,
     "fluid_radix"),
    ({"set_fluid_fft_kernel": "mxu"}, (2, 3, 9, 8, 7), PARAMS, "fluid_flat"),
    ({"set_fluid_fft_kernel": True}, (2, 3, 9, 8, 7), PARAMS, "fluid_flat"),
    ({"set_fluid_fft_kernel": False}, (2, 3, 8, 8, 8), PARAMS, "packed"),
    ({"set_fluid_mxu_whole": True}, FULL128, PARAMS, "fluid_whole"),
    ({"set_fluid_mxu_whole": True}, (2, 3, 9, 8, 7), PARAMS, "fluid_whole"),
    ({"set_fluid_mxu_whole": "auto"}, FULL64, PARAMS, "fluid_whole"),
    ({"set_fluid_mxu_whole": "auto"}, FULL128, PARAMS, "fluid_flat"),
    ({"set_fluid_mxu_whole": "auto"}, (8, 3, 64, 64, 64), PARAMS, "fluid_flat"),
    ({"set_fluid_mxu_whole": True, "set_fluid_fft_kernel": False}, FULL64, PARAMS, "packed"),
    ({"set_fluid_mxu_whole": True}, (2, 3, 8, 8, 8), PARAMS_BETA, "rfftn"),
    ({"set_fluid_packing": False}, (2, 3, 8, 8, 8), PARAMS, "rfftn"),
    ({"set_fluid_packing": True}, (2, 3, 8, 8, 8), PARAMS_BETA, "batch"),
    ({"set_fluid_packing": True}, (2, 2, 8, 8), PARAMS, "packed"),
    ({"set_fluid_packing": True, "set_fluid_fft_kernel": "radix"}, (3, 3, 8, 8, 8), PARAMS,
     "fluid_radix"),
    ({"set_fluid_dft": True}, (2, 3, 8, 8, 8), PARAMS, "dft"),
    ({"set_fluid_dft": True, "set_fluid_fft_kernel": "radix"}, (2, 3, 8, 8, 8), PARAMS, "dft"),
])
def test_fluid_route(selectors, settings, shape, params, route):
    """The route a field takes is decided by its shape, the parameters and
    the selectors: K3 by default in 3D with ``beta == 0``, K14/K15 under
    "radix" on power-of-two axes (else the ``torch.fft`` packed solve, as
    the JAX package falls back to XLA's), K16 forced anywhere in 3D or under
    "auto" where the packed working set fits the L2 (64^3 b4, not 128^3 b4
    nor 64^3 b8), and the plain routes where a selector asks for them."""
    for name, value in settings.items():
        getattr(lt, name)(value)
    assert tfl.fluid_route(shape, params) == route
    assert tfl.mxu_whole_supported(FULL64) and not tfl.mxu_whole_supported(FULL128)
    assert tfl.fft_kernel_supported((8, 16, 4)) and not tfl.fft_kernel_supported((8, 16))


ROUTES = {  # case: (settings, params, the route taken)
    "fluid_flat": ({}, PARAMS, "fluid_flat"),
    "fluid_radix": ({"set_fluid_fft_kernel": "radix"}, PARAMS, "fluid_radix"),
    "fluid_whole": ({"set_fluid_mxu_whole": True}, PARAMS, "fluid_whole"),
    "packed": ({"set_fluid_fft_kernel": False}, PARAMS, "packed"),
    "rfftn": ({"set_fluid_packing": False}, PARAMS, "rfftn"),
    "dft": ({"set_fluid_dft": True}, PARAMS, "dft"),
    "batch": ({"set_fluid_packing": True}, PARAMS_BETA, "batch"),
    "dft_batch": ({"set_fluid_dft": True}, PARAMS_BETA, "dft"),
    "rfftn_beta": ({}, PARAMS_BETA, "rfftn"),
}


def _select(case):
    """Set the selectors of ``case``; returns its parameters and route."""
    settings, params, route = ROUTES[case]
    for name, value in settings.items():
        getattr(lt, name)(value)
    return params, route


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_metric_routes_match_jax(rng, selectors, case):
    """``FluidMetric.sharp`` and ``flat`` on every route (an odd slab count
    and an odd batch, so both packings pad a zero field) against the JAX
    ``_fluid_apply`` in float64, and the packed and DFT routes against the
    JAX package's own packed and DFT functions."""
    params, route = _select(case)
    mv = rng.standard_normal((3, 3, 8, 4, 16))
    assert tfl.fluid_route(mv.shape, params) == route
    metric = lt.FluidMetric(params)
    for inverse, fn in ((True, metric.sharp), (False, metric.flat)):
        got = fn(t(mv))
        close_rel(jfl._fluid_apply(jnp.asarray(mv), params, inverse), got, FFT_RTOL)
        if route in ("fluid_flat", "fluid_radix", "fluid_whole", "packed", "batch"):
            mode = "flat" if params[1] == 0.0 else "batch_pad"
            ref = jfl._fluid_apply_packed(jnp.asarray(mv), params, inverse, mode)
            close_rel(ref, got, PACKED_RTOL)
        if route == "dft":
            close_rel(jfl._fluid_apply_dft(jnp.asarray(mv), params, inverse), got, FFT_RTOL)


def test_metric_across_selector_change(rng, selectors):
    """A metric used before a selector change gives what a fresh metric
    gives after it: its multipliers are kept per route form (natural or
    bit-reversed order)."""
    m = t(rng.standard_normal((2, 3, 8, 16, 4)))
    metric = lt.FluidMetric(PARAMS)
    before = metric.sharp(m)
    for setter, value in ((lt.set_fluid_fft_kernel, "radix"), (lt.set_fluid_mxu_whole, True),
                          (lt.set_fluid_dft, True)):
        prev = setter(value)
        try:
            assert torch.equal(metric.sharp(m), lt.FluidMetric(PARAMS).sharp(m))
            assert torch.equal(metric.flat(m), lt.FluidMetric(PARAMS).flat(m))
        finally:
            setter(prev)
    assert torch.equal(metric.sharp(m), before)
    assert len(metric._multipliers) == 6  # sharp and flat, three forms


@pytest.mark.parametrize("route", ["fluid_radix", "fluid_whole", "dft"])
def test_backward_matches_jax_vjp(rng, selectors, route):
    """The fluid solve's gradient on the route (the plain versions on the
    CPU, autograd through them) against ``jax.vjp`` of ``_fluid_apply``."""
    params, _ = _select(route)
    mv, cot = rng.standard_normal((3, 3, 8, 4, 16)), rng.standard_normal((3, 3, 8, 4, 16))
    _, vjp = jax.vjp(lambda a: jfl.fluid_operator(a, params, True), jnp.asarray(mv))
    x = t(mv).requires_grad_(True)
    (got,) = torch.autograd.grad(lt.FluidMetric(params).sharp(x), x, t(cot))
    close_rel(vjp(jnp.asarray(cot))[0], got, FFT_RTOL)


# ---------------------------------------------------------------------------
# the atlas step on the radix and whole routes
# ---------------------------------------------------------------------------

LR_POSE = 1e-4  # moves the momenta by 0.3-5% of max|m| per step here


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX atlas step at this file's config, jitted once, traced under
    the JAX package's "general" warp tier (the same function in every
    tier's regime).  On the CPU the JAX package takes its rfftn solve
    whatever its selectors say."""
    step = jax.jit(jlddmm.make_lddmm_atlas_step(
        lm.FluidMetric(PARAMS), reg_weight=0.1, learning_rate_pose=LR_POSE, integration_steps=5))

    def call(*args):
        prev = set_warp_mode("general")
        try:
            return step(*args)
        finally:
            set_warp_mode(prev)
    return call


@pytest.mark.parametrize("route", ["fluid_radix", "fluid_whole"])
@pytest.mark.parametrize("max_v0", [0.5, 6.0])
def test_atlas_step_matches_jax_on_route(rng, selectors, route, max_v0):
    """``make_lddmm_atlas_step`` with the route's selector set: the new
    momenta and the update, the atlas gradient, the loss and the
    regulariser against the JAX step, in the unit regime and on the
    fallback (max|v0| = 6), in float64."""
    _select(route)
    assert tfl.fluid_route(STEP_SHAPE, PARAMS) == route
    m = rng.standard_normal(STEP_SHAPE)
    m *= max_v0 / float(lt.FluidMetric(PARAMS).sharp(t(m)).abs().max())
    I = rng.standard_normal((1, 1) + STEP_SHAPE[2:])
    img = rng.standard_normal((STEP_SHAPE[0], 1) + STEP_SHAPE[2:])
    ref = _jax_step()(*(jnp.asarray(a) for a in (I, m, img)))
    step = lt.make_lddmm_atlas_step(lt.FluidMetric(PARAMS), reg_weight=0.1,
                                    learning_rate_pose=LR_POSE, integration_steps=5)
    m_new, I_grad, loss, reg = step(t(I), t(m), t(img))
    close_rel(ref[0], m_new, FFT_RTOL)
    update = np.asarray(ref[0]) - m
    assert np.abs(update).max() > 1e-3 * np.abs(m).max()  # the step moved the momenta
    close_rel(update, m_new - t(m), FFT_RTOL)
    close_rel(ref[1], I_grad, FFT_RTOL)
    for r, g in zip(ref[2:], (loss, reg)):
        assert abs(float(g) - float(r)) <= FFT_RTOL * abs(float(r))


# ---------------------------------------------------------------------------
# the autograd Functions around K14-K16, launches replaced by plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def solve_glue(monkeypatch):
    """Route the new wrappers through their Functions on the CPU:
    ``use_kernel`` is true, the device check skipped, and each launch
    replaced by its plain version (asserting contiguous operands) that
    counts its calls and adds to the kernel's ``launches`` as the real one
    does."""
    calls = collections.Counter()

    def launch(fn, kernel):
        def run(x, *args):
            assert x.is_contiguous() and all(a.is_contiguous() for a in args
                                             if isinstance(a, torch.Tensor))
            calls[kernel.name] += 1
            kernel.launches += 1
            return fn(x, *args)
        return run

    def plain_zy(x, inverse):
        return fft_radix._halves(fft_radix.radix_zy_plain, x, inverse)

    def plain_x(x, Mbr):
        return fft_radix._halves(fft_radix.radix_x_plain, x, Mbr)

    for mod in (fft_radix, fft_whole):
        monkeypatch.setattr(mod, "use_kernel", lambda _t: not kernels._PLAIN.get())
        monkeypatch.setattr(mod, "check_cuda_f32", lambda _name, *_ts: None)
    monkeypatch.setattr(fft_radix, "_launch_zy", launch(plain_zy, fft_radix.KERNEL_ZY))
    monkeypatch.setattr(fft_radix, "_launch_x", launch(plain_x, fft_radix.KERNEL_X))
    monkeypatch.setattr(fft_whole, "_launch", launch(fft_unit.fluid_flat_plain, fft_whole.KERNEL))
    return calls


@pytest.mark.parametrize("route", ["fluid_radix", "fluid_whole"])
def test_solve_functions_match_plain(rng, selectors, solve_glue, route):
    """``fluid_radix`` (K14, K15, K14) and ``fluid_whole`` (K16) under
    autograd, launches replaced by the plain versions: forward and
    gradient (a transposed cotangent, made contiguous for the launch)
    equal autograd of the plain version, with 3 (radix) or 1 (whole)
    launches each way; one atlas step on the route makes 20 K14 and 10
    K15, or 10 K16, launches and nothing of K3."""
    fn = fft_radix.fluid_radix if route == "fluid_radix" else fft_whole.fluid_whole
    plain = fft_radix.fluid_radix_plain if route == "fluid_radix" else fft_unit.fluid_flat_plain
    M = tfl.form_multiplier(tfl.multiplier_form(route), (8, 4, 16), PARAMS, True,
                            torch.float64, "cpu")
    x = t(rng.standard_normal((4, 8, 4, 16)))
    cot = t(rng.standard_normal((4, 16, 4, 8))).transpose(1, 3)
    leaf = x.clone().requires_grad_(True)
    out = fn(leaf, M)
    (got,) = torch.autograd.grad(out, leaf, cot)
    per_solve = 3 if route == "fluid_radix" else 1
    assert sum(solve_glue.values()) == 2 * per_solve
    ref_leaf = x.clone().requires_grad_(True)
    ref_out = plain(ref_leaf, M)
    (ref,) = torch.autograd.grad(ref_out, ref_leaf, cot)
    close_rel(ref_out.detach().numpy(), out, RADIX_RTOL)
    close_rel(ref.numpy(), got, RADIX_RTOL)

    _select(route)
    m = rng.standard_normal((2, 3, 8, 4, 16))
    metric = lt.FluidMetric(PARAMS)
    m = t(m * (0.5 / float(metric.sharp(t(m)).abs().max())))
    I = t(rng.standard_normal((1, 1, 8, 4, 16)))
    img = t(rng.standard_normal((2, 1, 8, 4, 16)))
    step = lt.make_lddmm_atlas_step(metric, reg_weight=0.1, learning_rate_pose=1e-4)
    solve_glue.clear()
    kernels.reset_launches()
    got_step = step(I, m, img)
    want = ({"fluid_radix_zy": 20, "fluid_radix_x": 10} if route == "fluid_radix"
            else {"fluid_whole": 10})
    assert dict(solve_glue) == want
    assert kernels.launch_counts()["fluid_flat"] == 0
    with kernels.plain_versions():
        ref_step = step(I, m, img)
    for r, g in zip(ref_step, got_step):
        close_rel(r.numpy(), g, RADIX_RTOL)


def test_cpu_dispatch_and_cuda_checks(rng, selectors):
    """On the CPU the wrappers take their plain versions and count no
    launch; the kernels' shape check refuses axes that are no power of two
    (K14, K15) and multipliers of the wrong shape."""
    kernels.reset_launches()
    x = t(rng.standard_normal((4, 8, 4, 16)))
    M = t(rng.standard_normal((8, 4, 16)))
    assert torch.equal(fft_radix.fluid_radix(x, M), fft_radix.fluid_radix_plain(x, M))
    assert torch.equal(fft_whole.fluid_whole(x, M), fft_unit.fluid_flat_plain(x, M))
    assert all(n == 0 for n in kernels.launch_counts().values())
    for bad, Mb in ((t(rng.standard_normal((4, 8, 6, 16))).float(), M[:, :3].float().contiguous()),
                    (x.float(), M[:4].float().contiguous())):
        with pytest.raises(ValueError):
            fft_radix._check("fluid_radix", bad, Mb)
