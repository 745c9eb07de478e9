"""The port's grid operators against the JAX package's, on the CPU in
float64: boundary stencils, the Jacobian contraction, the three sampling
tiers, interp_auto, and the fluid operator (``beta == 0`` packed path,
``beta != 0`` rfftn path, odd slab counts).

Tolerances: stencil and sampling ops do the same float64 operations in the
same order as the JAX package, so they agree to 1e-12 absolute (they come
out bit-equal); anything through an FFT agrees to 1e-9 relative to
max|ref| (the two libraries' FFTs round differently, ~1e-15).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lagomorph_tpu as lm
from lagomorph_tpu.ops import boundary as jb, sampling as jsamp
from lagomorph_tpu.ops import fluid as jfluid
from lagomorph_tpu.ops.interp import _tier_flags, interp as j_interp, interp_auto as j_interp_auto
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch.ops import boundary as tb, fluid as tfluid
from lagomorph_tpu_torch.ops.interp import interp, interp_auto, tier_flags, warp_tier
from lagomorph_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(2)

STENCIL_ATOL = 1e-12  # same float64 ops in the same order
FFT_RTOL = 1e-9  # relative to max|ref|: FFT roundoff differs between libraries
SHAPES = [(2, 3, 16, 12, 20), (1, 3, 9, 8, 7)]  # the second has odd axes


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(ref, got, atol=STENCIL_ATOL):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def close_rel(ref, got, rtol=FFT_RTOL):
    ref = np.asarray(ref)
    close(ref, got, atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("offset", [-1, 1])
def test_shift_clamp_and_diff_central(rng, axis, offset):
    a = rng.standard_normal((5, 4, 3))
    close(jb.shift_clamp(jnp.asarray(a), axis, offset), tb.shift_clamp(t(a), axis, offset))
    close(jb.diff_central(jnp.asarray(a), axis), tb.diff_central(t(a), axis))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("displacement,transpose", [(True, False), (False, False), (True, True)])
def test_jacobian_times_vectorfield(rng, shape, displacement, transpose):
    v = rng.standard_normal(shape)
    w = rng.standard_normal(shape)
    ref = lm.jacobian_times_vectorfield(jnp.asarray(v), jnp.asarray(w), displacement, transpose)
    close(ref, lt.jacobian_times_vectorfield(t(v), t(w), displacement, transpose))


def close_adjoint(ref, got):
    """1e-10 * (1 + max|ref|): the adjoints sum the same float64 terms, in
    an order that may differ from the JAX package's by one rounding."""
    close(ref, got, atol=1e-10 * (1.0 + float(np.abs(np.asarray(ref)).max())))


@pytest.mark.parametrize("n", [2, 3, 7])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_diff_central_adjoint(rng, n, axis):
    """The port's transpose against the JAX package's, and against the
    transpose of diff_central's matrix (<D a, p> == <a, D^T p>)."""
    shape = [4, 5, 3]
    shape[axis] = n
    p = rng.standard_normal(shape)
    got = tb.diff_central_adjoint(t(p), axis)
    close_adjoint(jb.diff_central_adjoint(jnp.asarray(p), axis), got)
    a = rng.standard_normal(shape)
    lhs = float((tb.diff_central(t(a), axis) * t(p)).sum())
    rhs = float((t(a) * got).sum())
    assert abs(lhs - rhs) <= 1e-12 * (1.0 + abs(lhs))


@pytest.mark.parametrize("shape", SHAPES)
def test_jacobian_times_vectorfield_adjoint(rng, shape):
    z = rng.standard_normal(shape)
    w = rng.standard_normal(shape)
    ref = lm.jacobian_times_vectorfield_adjoint(jnp.asarray(z), jnp.asarray(w))
    close_adjoint(ref, lt.jacobian_times_vectorfield_adjoint(t(z), t(w)))


def test_identity_grid():
    """The identity functions take ``device`` as a required keyword: nothing
    is built on a default device."""
    close(jsamp.identity_grid((4, 3, 5), dtype=jnp.float64),
          tsamp.identity_grid((4, 3, 5), dtype=torch.float64, device="cpu"))
    close(lm.identity((2, 3, 4, 3, 5), dtype=np.float64),
          lt.identity((2, 3, 4, 3, 5), dtype=torch.float64, device="cpu"))
    with pytest.raises(TypeError):
        tsamp.identity_grid((4, 3, 5), dtype=torch.float64)
    with pytest.raises(TypeError):
        lt.identity((2, 3, 4, 3, 5), torch.float64, "cpu")


@pytest.mark.parametrize("background", ["clamp", "wrap", "zero", "val"])
def test_sample_linear(rng, background):
    I = rng.standard_normal((1, 2, 6, 5, 7))
    coords = rng.uniform(-2, 8, (3, 3, 6, 5, 7))
    ref = jsamp.sample_linear(jnp.asarray(I), jnp.asarray(coords), background, 0.7)
    close(ref, tsamp.sample_linear(t(I), t(coords), background, 0.7))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("image_batch", ["one", "N"])
def test_sample_displacement_unit_and_bounded(rng, shape, image_batch):
    nI = 1 if image_batch == "one" else shape[0]
    I = rng.standard_normal((nI, 2) + shape[2:])
    unit = rng.uniform(-1, 1, shape)
    wide = rng.uniform(-2, 3, shape)
    close(jsamp.sample_displacement_unit(jnp.asarray(I), jnp.asarray(unit)),
          tsamp.sample_displacement_unit(t(I), t(unit)))
    close(jsamp.sample_displacement_bounded(jnp.asarray(I), jnp.asarray(wide), 2),
          tsamp.sample_displacement_bounded(t(I), t(wide), 2))


def test_sample_displacement_unit_2d(rng):
    I = rng.standard_normal((2, 1, 7, 6))
    d = rng.uniform(-1, 1, (2, 2, 7, 6))
    close(jsamp.sample_displacement_unit(jnp.asarray(I), jnp.asarray(d)),
          tsamp.sample_displacement_unit(t(I), t(d)))


@functools.lru_cache(maxsize=None)
def _jax_interp_auto():
    """The JAX tiered warp, jitted once and shared by the tier cases (its
    lax.cond compiles every tier; one compile serves all three)."""
    return jax.jit(j_interp_auto)


@pytest.mark.parametrize("scale,tier", [(0.9, "unit"), (1.9, "bounded"), (6.0, "general")])
def test_interp_auto_tiers(rng, scale, tier):
    """Each tier of interp_auto against the JAX package's tiered warp, with
    a batch-1 image; the half-open bounds pick the same tier."""
    shape = (2, 3, 10, 9, 8)
    I = rng.standard_normal((1, 1) + shape[2:])
    u = rng.uniform(-scale, scale, shape)
    assert warp_tier(t(u)) == tier
    close(_jax_interp_auto()(jnp.asarray(I), jnp.asarray(u)), interp_auto(t(I), t(u)))
    close(j_interp(jnp.asarray(I), jnp.asarray(u), 0.5), interp(t(I), t(u), 0.5))


def test_tier_flags_half_open_bounds():
    for val, unit, bounded in [(-1.0, True, True), (1.0, False, True),
                               (-2.0, False, True), (3.0, False, False), (float("nan"), False, False)]:
        d = np.zeros((1, 3, 2, 2, 2))
        d[0, 1, 1, 0, 1] = val
        ju, jbd = _tier_flags(jnp.asarray(d), 2)
        tu, tbd = tier_flags(t(d), 2)
        assert (bool(ju), bool(jbd)) == (bool(tu), bool(tbd)) == (unit, bounded)


@pytest.mark.parametrize("params", [(0.1, 0.0, 0.01), (0.1, 0.05, 0.01), (0.2, 0.3, 0.0)])
@pytest.mark.parametrize("shape", [(2, 3, 16, 12, 20), (1, 3, 9, 8, 7), (3, 2, 12, 10)])
def test_fluid_sharp_flat(rng, params, shape):
    """sharp and flat against the JAX FluidMetric: beta = 0 in 3D takes the
    packed path (K3's plain version; (1, 3, ...) has an odd slab count),
    beta != 0 and 2D the rfftn path."""
    m = rng.standard_normal(shape)
    jm, tm = lm.FluidMetric(params), lt.FluidMetric(params)
    close_rel(jm.sharp(jnp.asarray(m)), tm.sharp(t(m)))
    close_rel(jm.flat(jnp.asarray(m)), tm.flat(t(m)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("params", [(0.1, 0.0, 0.01), (0.1, 0.05, 0.0)])
def test_fluid_multiplier_entries(params, inverse):
    """The torch multiplier builder against the JAX package's numpy
    reference multiplier (both built in float64)."""
    spatial = (6, 5, 8)
    ref = jfluid.fluid_multiplier(spatial, params, inverse, np.float64)
    M = tfluid.fluid_multiplier_entries(spatial, params, inverse, torch.float64)
    for (a, b), val in M.items():
        close_rel(ref[a, b], val, rtol=1e-12)
    # the numpy layout fills the symmetric matrix from its lower-triangle entries
    close_rel(ref, torch.from_numpy(
        tfluid.fluid_multiplier(spatial, params, inverse, np.float64)), rtol=1e-12)
