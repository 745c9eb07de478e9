"""The port's shooting, atlas loss and atlas step against the JAX package,
on the CPU in float64: ``expmap`` in the unit regime (hoisted fast path
kept) and with momenta that trip its flag (exact general integration
re-run), the regime probe, ``_lddmm_loss`` with a batch-1 atlas and with a
mask, ``make_lddmm_atlas_step`` (momenta update, atlas gradient, loss), and
the state conversion.

Tolerance: 1e-9 relative to max|ref| (every step goes through a fluid
solve, and the two libraries' FFTs round differently, ~1e-15).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lagomorph_tpu as lm
from lagomorph_tpu import lddmm as jlddmm
from lagomorph_tpu.ops import set_warp_mode
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import convert, lddmm as tlddmm

torch.set_num_threads(2)

FFT_RTOL = 1e-9
PARAMS = (0.1, 0.0, 0.01)
SHAPE = (2, 3, 16, 12, 20)
STEPS = 5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close_rel(ref, got, rtol=FFT_RTOL):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


def momenta(rng, max_v0, shape=SHAPE):
    """Momenta scaled so that the initial velocity peaks at ``max_v0``
    voxels: 0.5 stays in the unit regime over 5 substeps; 6 leaves it
    (a substep moves up to 1.2 voxels)."""
    m = rng.standard_normal(shape)
    v0 = lt.FluidMetric(PARAMS).sharp(t(m))
    return m * (max_v0 / float(v0.abs().max()))


@functools.lru_cache(maxsize=None)
def _jax_shoot():
    """The JAX ``expmap`` and ``shooting_regime_ok`` at this file's config,
    jitted once and shared by the cases (one compile is cheaper than
    op-by-op dispatch)."""
    metric = lm.FluidMetric(PARAMS)
    return (jax.jit(lambda m: lm.expmap(metric, m, num_steps=STEPS)),
            jax.jit(lambda m: jlddmm.shooting_regime_ok(metric, m, num_steps=STEPS)))


@pytest.mark.parametrize("max_v0,hoisted", [(0.5, True), (6.0, False)])
def test_expmap_matches_jax(rng, max_v0, hoisted):
    m = momenta(rng, max_v0)
    metric = lt.FluidMetric(PARAMS)
    dt = 1.0 / STEPS
    phi0 = -dt * metric.sharp(t(m))
    fast, ok = tlddmm._expmap_fast_flagged(metric, t(m), dt, STEPS - 1, phi0, None)
    assert bool(ok) is hoisted
    jexpmap, jregime_ok = _jax_shoot()
    ref = jexpmap(jnp.asarray(m))
    got = lt.expmap(metric, t(m), num_steps=STEPS)
    close_rel(ref, got)
    if hoisted:
        assert torch.equal(got, fast)
    else:
        assert float(np.abs(np.asarray(ref)).max()) > 2.0  # the general tiers ran
        assert torch.equal(got, tlddmm._expmap_general(metric, t(m), dt, STEPS - 1, phi0, None))
    jok = jregime_ok(jnp.asarray(m))
    assert bool(tlddmm.shooting_regime_ok(metric, t(m), num_steps=STEPS)) is bool(jok) is hoisted


@functools.lru_cache(maxsize=None)
def _jax_general(length):
    """The JAX ``_expmap_general`` from the peeled first step, ``length``
    substeps at this file's config, with the value and momentum gradient of
    ``sum(phiinv * w)``, jitted once."""
    metric = lm.FluidMetric(PARAMS)
    dt = 1.0 / STEPS

    def f(m, w):
        h = jlddmm._expmap_general(metric, m, dt, length, -dt * metric.sharp(m), None)
        return jnp.sum(h * w), h
    return jax.jit(jax.value_and_grad(f, has_aux=True))


def test_expmap_general_rematerialised_matches_jax(rng):
    """The fallback's exact integration rematerialises each substep, as
    the JAX package's ``jax.checkpoint(step)``: on momenta whose flag trips,
    its value and momentum gradient match the JAX ``_expmap_general``, and
    the tensors autograd saves grow by each substep's two inputs (``phiinv``
    and ``m0``), not by its intermediates."""
    shape = (1, 3, 8, 6, 10)
    m = momenta(rng, 6.0, shape)
    w = rng.standard_normal(shape)
    metric = lt.FluidMetric(PARAMS)
    dt = 1.0 / STEPS
    _, ok = tlddmm._expmap_fast_flagged(metric, t(m), dt, STEPS - 1,
                                        -dt * metric.sharp(t(m)), None)
    assert not bool(ok)
    (_, ref), ref_grad = _jax_general(STEPS - 1)(jnp.asarray(m), jnp.asarray(w))
    saved = {}
    for length in (1, STEPS - 1):
        m_ = t(m).requires_grad_(True)
        saved[length] = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda x, into=saved[length]: into.append(x) or x, lambda x: x):
            h = tlddmm._expmap_general(metric, m_, dt, length, -dt * metric.sharp(m_), None)
    close_rel(ref, h)
    (grad,) = torch.autograd.grad((h * t(w)).sum(), m_)
    close_rel(ref_grad, grad)
    assert len(saved[STEPS - 1]) - len(saved[1]) == 2 * (STEPS - 2)


def test_expmap_jax_positional_signature(rng):
    """``expmap`` takes the JAX package's positional parameters, with
    ``checkpoints`` seventh: ``expmap(metric, m0, 1.0, 5, None, None,
    False)`` equals the JAX call in float64, and the tier overrides follow
    it in eighth and ninth place."""
    m = momenta(rng, 0.5)
    metric = lt.FluidMetric(PARAMS)
    ref = jax.jit(lambda m_: lm.expmap(lm.FluidMetric(PARAMS), m_, 1.0, STEPS, None, None,
                                       False))(jnp.asarray(m))
    close_rel(ref, lt.expmap(metric, t(m), 1.0, STEPS, None, None, False))
    ref = jax.jit(lambda m_: lm.expmap(lm.FluidMetric(PARAMS), m_, 1.0, 3, None, None, False,
                                       "unit", "unit"))(jnp.asarray(m))
    close_rel(ref, lt.expmap(metric, t(m), 1.0, 3, None, None, False, "unit", "unit"))


def test_expmap_checkpoints_not_ported(rng):
    """``checkpoints=True`` (rematerialised shooting), by keyword and in
    its JAX position, gives the shooting without it, bit for bit (its
    gradients: ``tests/test_torch_atlas.py``)."""
    m = t(momenta(rng, 0.5, (1, 3, 6, 5, 4)))
    metric = lt.FluidMetric(PARAMS)
    ref = lt.expmap(metric, m, num_steps=3)
    assert torch.equal(lt.expmap(metric, m, num_steps=3, checkpoints=True), ref)
    assert torch.equal(lt.expmap(metric, m, 1.0, 3, None, None, True), ref)


def test_expmap_forced_modes_and_mask(rng):
    """A momentum mask, through the hoisted path (no tier forced) and
    through the per-step loop with forced warp tiers."""
    m = momenta(rng, 0.5, (1, 3, 9, 8, 7))
    mask = (rng.uniform(size=(1, 1, 9, 8, 7)) > 0.3).astype(np.float64)
    for mode in (None, "unit", "general"):
        ref = jax.jit(lambda m_, k_: lm.expmap(
            lm.FluidMetric(PARAMS), m_, num_steps=3, mommask=k_, transport_mode=mode,
            compose_mode=mode))(jnp.asarray(m), jnp.asarray(mask))
        got = lt.expmap(lt.FluidMetric(PARAMS), t(m), num_steps=3, mommask=t(mask),
                        transport_mode=mode, compose_mode=mode)
        close_rel(ref, got)


@functools.lru_cache(maxsize=None)
def _jax_loss(use_mask):
    """The JAX ``_lddmm_loss`` at this file's config, jitted once per mask
    case (one compile is cheaper than op-by-op dispatch, and the cases
    share it)."""
    metric = lm.FluidMetric(PARAMS)
    if use_mask:
        return jax.jit(lambda I, m, img, mask: jlddmm._lddmm_loss(
            I, m, img, metric, 0.1, STEPS, False, mask=mask))
    return jax.jit(lambda I, m, img: jlddmm._lddmm_loss(I, m, img, metric, 0.1, STEPS, False))


@pytest.mark.parametrize("max_v0", [0.5, 6.0])
@pytest.mark.parametrize("use_mask", [False, True])
def test_lddmm_loss_matches_jax(rng, max_v0, use_mask):
    """The atlas loss with a batch-1 atlas broadcast over the batch, with
    and without a mask over padded subjects."""
    m = momenta(rng, max_v0)
    I = rng.standard_normal((1, 1) + SHAPE[2:])
    img = rng.standard_normal((SHAPE[0], 1) + SHAPE[2:])
    mask = np.array([1.0, 0.0]) if use_mask else None
    tm = None if mask is None else t(mask)
    args = (jnp.asarray(I), jnp.asarray(m), jnp.asarray(img))
    ref = _jax_loss(use_mask)(*args, *(() if mask is None else (jnp.asarray(mask),)))
    got = tlddmm._lddmm_loss(t(I), t(m), t(img), lt.FluidMetric(PARAMS), 0.1, STEPS, mask=tm)
    for r, g in zip(ref, got):
        assert abs(float(g) - float(r)) <= FFT_RTOL * abs(float(r))


def test_lddmm_loss_regrid_not_ported(rng):
    """The regrid branch (momenta on a half grid) and checkpoints=True (the
    JAX signature's seventh argument) run, the loss and the step finite
    (held against the JAX package in ``tests/test_torch_atlas.py``); a step
    on a spatial mesh runs on the same grid and gives the dense step's loss
    (held against the JAX package in ``tests/test_torch_parallel.py``)."""
    m = momenta(rng, 0.5, (1, 3, 9, 8, 7))
    img = t(np.zeros((1, 1, 18, 16, 14)))
    loss, reg = tlddmm._lddmm_loss(img, t(m), img, lt.FluidMetric(PARAMS), 0.1, 3, False,
                                   image_shape=(18, 16, 14))
    assert torch.isfinite(loss) and float(reg) > 0
    small = img[..., :9, :8, :7]
    pair = [tlddmm._lddmm_loss(small, t(m), small, lt.FluidMetric(PARAMS), 0.1, 3, ckpt)
            for ckpt in (False, True)]
    assert torch.equal(torch.stack(pair[0]), torch.stack(pair[1]))
    step = lt.make_lddmm_atlas_step(lt.FluidMetric(PARAMS), image_shape=(18, 16, 14))
    m_new = step(img, t(m), img)[0]
    assert m_new.shape == m.shape and torch.isfinite(m_new).all()
    from lagomorph_tpu_torch.parallel import get_mesh

    m8 = t(momenta(rng, 0.5, (1, 3, 8, 8, 6)))
    img8 = t(rng.standard_normal((1, 1, 8, 8, 6)))
    dense = lt.make_lddmm_atlas_step(lt.FluidMetric(PARAMS))(img8, m8, img8)
    spatial = lt.make_lddmm_atlas_step(lt.FluidMetric(PARAMS),
                                       spatial_mesh=get_mesh(devices=["cpu"] * 2))(img8, m8, img8)
    assert spatial[0].shape == m8.shape and torch.isfinite(spatial[0]).all()
    assert abs(float(spatial[2]) - float(dense[2])) <= 1e-9 * abs(float(dense[2]))


# learning rates that move the momenta by 0.3-5% of max|m| per step here
LR_POSE = {False: 1e-4, True: 5e-3}  # by momentum_preconditioning


@functools.lru_cache(maxsize=None)
def _jax_step(lddmm_steps, preconditioning, use_mask):
    """The JAX atlas step, jitted once per configuration; traced under the
    JAX package's "general" warp tier (one branch per warp to compile, the
    same function in every tier's regime)."""
    step = jlddmm.make_lddmm_atlas_step(
        lm.FluidMetric(PARAMS), reg_weight=0.1, learning_rate_pose=LR_POSE[preconditioning],
        lddmm_steps=lddmm_steps, integration_steps=STEPS,
        momentum_preconditioning=preconditioning)
    jstep = jax.jit(step if use_mask else (lambda I, m, img: step(I, m, img)))

    def call(*args):
        prev = set_warp_mode("general")
        try:
            return jstep(*args)
        finally:
            set_warp_mode(prev)
    return call


@pytest.mark.parametrize("lddmm_steps,preconditioning,use_mask", [
    (1, False, False), (2, True, True)])
@pytest.mark.parametrize("max_v0", [0.5, 6.0])
def test_atlas_step_matches_jax(rng, lddmm_steps, preconditioning, use_mask, max_v0):
    """``make_lddmm_atlas_step``: the new momenta (and the update), the
    atlas gradient, the loss and the regulariser, in the unit regime and
    on the fallback (max|v0| = 6), with a batch-1 atlas."""
    m = momenta(rng, max_v0)
    I = rng.standard_normal((1, 1) + SHAPE[2:])
    img = rng.standard_normal((SHAPE[0], 1) + SHAPE[2:])
    mask = np.array([1.0, 0.0]) if use_mask else None
    extra = () if mask is None else (mask,)
    ref = _jax_step(lddmm_steps, preconditioning, use_mask)(
        *(jnp.asarray(a) for a in (I, m, img) + extra))
    step = lt.make_lddmm_atlas_step(
        lt.FluidMetric(PARAMS), reg_weight=0.1, learning_rate_pose=LR_POSE[preconditioning],
        lddmm_steps=lddmm_steps, integration_steps=STEPS,
        momentum_preconditioning=preconditioning)
    tI = t(I)
    got = step(tI, t(m), t(img), *(t(a) for a in extra))
    m_new, I_grad, loss, reg = got
    assert not any(x.requires_grad for x in got) and not tI.requires_grad
    assert tuple(I_grad.shape) == I.shape and loss.dim() == reg.dim() == 0
    close_rel(ref[0], m_new)
    update = np.asarray(ref[0]) - m
    assert np.abs(update).max() > 1e-3 * np.abs(m).max()  # the step moved the momenta
    close_rel(update, m_new - t(m))
    close_rel(ref[1], I_grad)
    for r, g in zip(ref[2:], (loss, reg)):
        assert abs(float(g) - float(r)) <= FFT_RTOL * abs(float(r))


def test_convert_atlas_state(rng, tmp_path):
    """The JAX package's state, as arrays and as a saved atlas file, becomes
    the port's metric and tensors on the requested device and dtype."""
    h5py = pytest.importorskip("h5py")
    atlas = rng.standard_normal((1, 1, 6, 5, 4)).astype(np.float32)
    ms = rng.standard_normal((3, 3, 6, 5, 4)).astype(np.float32)
    jmetric = lm.FluidMetric(PARAMS)
    metric, I, m = convert.atlas_state(jmetric.params, jnp.asarray(atlas), jnp.asarray(ms),
                                       "cpu", torch.float64)
    assert metric.params == jmetric.params and I.dtype == m.dtype == torch.float64
    np.testing.assert_array_equal(I.numpy(), atlas)
    path = tmp_path / "atlas.h5"
    with h5py.File(path, "w") as f:  # the datasets LDDMMAtlasBuilder.save writes
        f.create_dataset("atlas", data=atlas)
        f.create_dataset("momenta", data=ms)
    with h5py.File(path, "r") as f:
        metric2, I2, m2 = convert.atlas_state_from_saved(f, jmetric.params, "cpu",
                                                         subjects=slice(1, 3))
    assert m2.dtype == torch.float32 and tuple(m2.shape) == (2, 3, 6, 5, 4)
    np.testing.assert_array_equal(m2.numpy(), ms[1:3])
    np.testing.assert_array_equal(I2.numpy(), atlas)
    assert metric2.params == jmetric.params
