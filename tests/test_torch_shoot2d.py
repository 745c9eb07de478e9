"""The port's 2D slice against the JAX package on the CPU: the whole-shoot
kernels' plain versions (K8/K9, ``ops/kernels/shoot2d.py``) against the JAX
``shoot2d`` run in interpret mode, the 2D ``expmap``, ``_lddmm_loss`` and
``make_lddmm_atlas_step`` in float64, the atlas step through the autograd
Function around K8/K9 (launches replaced by the plain versions), and the
bounded warp tier's scatter-free backward against the JAX custom VJP.

Tolerances: the JAX ``shoot2d`` solves the fluid equation with DFT matmuls
split into bf16 passes, so in float32 phiinv is held within 5e-4 *
max|ref| and the gradients within 1e-3 * max|ref| (the bounds of the JAX
package's own interpret-mode harness, scripts/kernel_interp_check.py:
332-354); float64 steps within 1e-9 * max|ref| (two libraries' FFTs); the
bounded tier does the same float64 operations as the JAX VJP in another
summation order (1e-12 * max|ref|).
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
from lagomorph_tpu.ops.pallas import shoot2d as js2
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import convert, lddmm as tlddmm
from lagomorph_tpu_torch.ops import kernels, sampling as tsamp
from lagomorph_tpu_torch.ops.kernels import epdiff_unit, fft_unit, shoot2d, warp_unit

torch.set_num_threads(2)

PARAMS = (0.1, 0.0, 0.01)
SHAPE = (2, 2, 24, 20)
STEPS = 5
FFT_RTOL = 1e-9
INTERP_SHAPE = (2, 2, 16, 128)  # the JAX kernel's gate: H % 8, W % 128
INTERP_T, INTERP_DT = 3, 0.25


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close_rel(ref, got, rtol):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's Pallas calls in interpret mode, in float32 (the
    kernel stores its flag as float32)."""
    monkeypatch.setattr(js2.pl, "pallas_call",
                        functools.partial(js2.pl.pallas_call, interpret=True))
    with jax.enable_x64(False):
        yield


def interp_inputs(rng, m_batch):
    """float32 ``(phiinv0, m0)`` whose trajectory keeps every warp
    displacement away from the integers, where the warp weights' slopes
    jump: a gradient compared between two float32 solves is only defined
    away from those kinks.  The momenta are noise plus a constant, so that
    ``s * v`` stays near -0.15 (the constant times ``Mn[0, 0] = 1e4``, times
    s = -0.25) within +-0.05, and phiinv0 is 0.7 plus a smooth field within
    +-0.05, so phiinv_t stays within (0.25, 0.8) over the 3 substeps."""
    N, _, H, W = INTERP_SHAPE
    Mn = lt.FluidMetric(PARAMS).packed_multiplier((H, W), torch.float64, "cpu")
    noise = rng.standard_normal(INTERP_SHAPE)
    noise *= 0.2 / float(shoot2d.fluid2d_plain(t(noise), Mn).abs().max())
    m = (noise + 0.6 / float(Mn[0, 0])).astype(np.float32)
    smooth = shoot2d.fluid2d_plain(t(rng.standard_normal(INTERP_SHAPE)), Mn).numpy()
    phiinv0 = (0.7 + smooth * (0.05 / np.abs(smooth).max())).astype(np.float32)
    return phiinv0, (m[:1] if m_batch == "one" else m)


def port_multiplier():
    return lt.FluidMetric(PARAMS).packed_multiplier(INTERP_SHAPE[2:], torch.float32, "cpu")


@pytest.mark.parametrize("m_batch", ["one", "N"])
def test_plain_shoot2d_matches_jax_interpret(rng, jax_interpret, m_batch):
    """``shoot2d`` on the CPU (the plain version of K8, differentiated by
    autograd) against the JAX ``shoot2d`` (its K8/K9 Pallas kernels in
    interpret mode): phiinv_T, the flag, and the gradients of sum(phiinv_T^2)
    in phiinv0 and m0 (a batch-1 m0 summed over the subjects)."""
    phiinv0, m0 = interp_inputs(rng, m_batch)

    def jloss(p_, m_):
        h, ok = js2.shoot2d(p_, m_, PARAMS, -INTERP_DT, INTERP_T)
        return jnp.sum(h * h), (h, ok)

    (_, (ref, jok)), (rp, rm) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(phiinv0), jnp.asarray(m0))
    traj_p, traj_v = shoot2d.shoot2d_fwd_plain(t(phiinv0), t(m0), port_multiplier(),
                                               -INTERP_DT, INTERP_T)[2:4]
    assert float((traj_p - traj_p.round()).abs().min()) > 0.2  # away from the kinks
    assert float((-INTERP_DT * traj_v - (-INTERP_DT * traj_v).round()).abs().min()) > 0.05
    leaves = [t(phiinv0).requires_grad_(True), t(m0).requires_grad_(True)]
    got, ok = shoot2d.shoot2d(*leaves, port_multiplier(), -INTERP_DT, INTERP_T)
    gp, gm = torch.autograd.grad((got * got).sum(), leaves)
    close_rel(ref, got, 5e-4)
    close_rel(rp, gp, 1e-3)
    close_rel(rm, gm, 1e-3)
    assert bool(ok) is (float(jok[0, 0]) > 0.5) is True


def test_plain_shoot2d_flag_trips_like_jax(rng, jax_interpret):
    """A displacement of 1.5 in phiinv0 leaves the unit regime: both flags
    are false."""
    phiinv0, m0 = interp_inputs(rng, "N")
    phiinv0[0, 0, 3, 7] = 1.5
    _, jok = js2.shoot2d(jnp.asarray(phiinv0), jnp.asarray(m0), PARAMS, -INTERP_DT, INTERP_T)
    _, ok = shoot2d.shoot2d(t(phiinv0), t(m0), port_multiplier(), -INTERP_DT, INTERP_T)
    assert float(jok[0, 0]) < 0.5 and not bool(ok)


def momenta(rng, max_v0, shape=SHAPE):
    """Momenta scaled so that the initial velocity peaks at ``max_v0``
    voxels: 0.5 stays in the unit regime over 5 substeps; 6 leaves it."""
    m = rng.standard_normal(shape)
    return m * (max_v0 / float(lt.FluidMetric(PARAMS).sharp(t(m)).abs().max()))


@pytest.fixture
def shoot_calls(monkeypatch):
    """Counts the calls of ``shoot2d.shoot2d`` (the hoisted 2D branch) and
    of ``_expmap_general`` (the re-run after a tripped flag)."""
    calls = collections.Counter()
    for mod, name in ((shoot2d, "shoot2d"), (tlddmm, "_expmap_general")):
        fn = getattr(mod, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


@functools.lru_cache(maxsize=None)
def _jax_expmap():
    metric = lm.FluidMetric(PARAMS)
    return jax.jit(lambda m: lm.expmap(metric, m, num_steps=STEPS))


@pytest.mark.parametrize("max_v0,hoisted", [(0.5, True), (6.0, False)])
@pytest.mark.parametrize("batch", [2, 1])
def test_expmap_2d_matches_jax(rng, shoot_calls, max_v0, hoisted, batch):
    """The 2D ``expmap`` takes the hoisted branch (one call of ``shoot2d``);
    at max|v0| = 6 its flag trips and the exact general integration re-runs;
    both match the JAX package."""
    m = momenta(rng, max_v0, (batch,) + SHAPE[1:])
    got = lt.expmap(lt.FluidMetric(PARAMS), t(m), num_steps=STEPS)
    close_rel(_jax_expmap()(jnp.asarray(m)), got, FFT_RTOL)
    assert dict(shoot_calls) == ({"shoot2d": 1} if hoisted else
                                 {"shoot2d": 1, "_expmap_general": 1})


def test_expmap_2d_gate(rng, shoot_calls):
    """The 2D gate keeps the JAX package's semantic conditions: a momentum
    mask, ``beta != 0`` or a forced warp tier take the per-step loop."""
    m = t(momenta(rng, 0.5))
    mask = t((rng.uniform(size=(1, 1) + SHAPE[2:]) > 0.3).astype(np.float64))
    lt.expmap(lt.FluidMetric(PARAMS), m, num_steps=3, mommask=mask)
    lt.expmap(lt.FluidMetric((0.1, 0.05, 0.01)), m, num_steps=3)
    lt.expmap(lt.FluidMetric(PARAMS), m, num_steps=3, transport_mode="unit", compose_mode="unit")
    assert not shoot_calls
    lt.expmap(lt.FluidMetric(PARAMS), m, num_steps=3)
    assert shoot_calls["shoot2d"] == 1


@functools.lru_cache(maxsize=None)
def _jax_loss(use_mask):
    metric = lm.FluidMetric(PARAMS)
    if use_mask:
        return jax.jit(lambda I, m, img, mask: jlddmm._lddmm_loss(
            I, m, img, metric, 0.1, STEPS, False, mask=mask))
    return jax.jit(lambda I, m, img: jlddmm._lddmm_loss(I, m, img, metric, 0.1, STEPS, False))


@pytest.mark.parametrize("max_v0", [0.5, 6.0])
@pytest.mark.parametrize("use_mask", [False, True])
def test_lddmm_loss_2d_matches_jax(rng, max_v0, use_mask):
    """The 2D atlas loss, a batch-1 atlas broadcast over the batch, with and
    without a mask over padded subjects."""
    m = momenta(rng, max_v0)
    I = rng.standard_normal((1, 1) + SHAPE[2:])
    img = rng.standard_normal((SHAPE[0], 1) + SHAPE[2:])
    mask = np.array([1.0, 0.0]) if use_mask else None
    ref = _jax_loss(use_mask)(jnp.asarray(I), jnp.asarray(m), jnp.asarray(img),
                              *(() if mask is None else (jnp.asarray(mask),)))
    got = tlddmm._lddmm_loss(t(I), t(m), t(img), lt.FluidMetric(PARAMS), 0.1, STEPS,
                             mask=None if mask is None else t(mask))
    for r, g in zip(ref, got):
        assert abs(float(g) - float(r)) <= FFT_RTOL * abs(float(r))


@functools.lru_cache(maxsize=None)
def _jax_step(use_mask):
    step = jlddmm.make_lddmm_atlas_step(lm.FluidMetric(PARAMS), reg_weight=0.1,
                                        learning_rate_pose=1e-3, integration_steps=STEPS)
    return jax.jit(step if use_mask else (lambda I, m, img: step(I, m, img)))


@pytest.mark.parametrize("max_v0", [0.5, 6.0])
@pytest.mark.parametrize("use_mask", [False, True])
def test_atlas_step_2d_matches_jax(rng, max_v0, use_mask):
    """``make_lddmm_atlas_step`` on 2D fields: the new momenta and the
    update, the atlas gradient, the loss and the regulariser."""
    m = momenta(rng, max_v0)
    I = rng.standard_normal((1, 1) + SHAPE[2:])
    img = rng.standard_normal((SHAPE[0], 1) + SHAPE[2:])
    extra = (np.array([1.0, 0.0]),) if use_mask else ()
    ref = _jax_step(use_mask)(*(jnp.asarray(a) for a in (I, m, img) + extra))
    step = lt.make_lddmm_atlas_step(lt.FluidMetric(PARAMS), reg_weight=0.1,
                                    learning_rate_pose=1e-3, integration_steps=STEPS)
    m_new, I_grad, loss, reg = step(t(I), t(m), t(img), *(t(a) for a in extra))
    close_rel(ref[0], m_new, FFT_RTOL)
    update = np.asarray(ref[0]) - m
    assert np.abs(update).max() > 1e-3 * np.abs(m).max()  # the step moved the momenta
    close_rel(update, m_new - t(m), FFT_RTOL)
    close_rel(ref[1], I_grad, FFT_RTOL)
    for r, g in zip(ref[2:], (loss, reg)):
        assert abs(float(g) - float(r)) <= FFT_RTOL * abs(float(r))


@pytest.fixture
def shoot_glue(monkeypatch):
    """Route every kernel wrapper through its autograd Function on the CPU,
    each launch replaced by its plain version (asserting contiguous
    operands); yields the count of calls by plain-version name."""
    calls = collections.Counter()

    def counted(fn):
        def launch(*args, **kw):
            for a in args:
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), f"{fn.__name__} handed a non-contiguous tensor"
            calls[fn.__name__] += 1
            return fn(*args, **kw)
        return launch

    for mod in (warp_unit, epdiff_unit, fft_unit, shoot2d):
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
        (shoot2d, "_launch_fwd", shoot2d.shoot2d_fwd_plain),
        (shoot2d, "_launch_bwd", shoot2d.shoot2d_bwd_plain),
    ):
        monkeypatch.setattr(mod, name, counted(plain))
    return calls


@pytest.mark.parametrize("m_batch", ["one", "N"])
def test_shoot2d_function_matches_plain(rng, shoot_glue, m_batch):
    """The Function around K8/K9 (plain launches): phiinv_T and the
    gradients in phiinv0 and m0 (batch-1 momenta summed over the subjects)
    equal autograd of the plain forward, under a dense and a strided
    cotangent; the flag is non-differentiable."""
    N, _, H, W = SHAPE
    m0 = t(momenta(rng, 0.5, ((1 if m_batch == "one" else N),) + SHAPE[1:]))
    Mn = lt.FluidMetric(PARAMS).packed_multiplier((H, W), torch.float64, "cpu")
    phiinv0 = (-0.2 * shoot2d.fluid2d_plain(m0, Mn)).expand(N, -1, -1, -1).contiguous()
    g = t(rng.standard_normal(SHAPE))
    for cot in (g, g.transpose(2, 3).contiguous().transpose(2, 3)):
        out = []
        for plain in (False, True):
            leaves = [phiinv0.clone().requires_grad_(True), m0.clone().requires_grad_(True)]
            with kernels.plain_versions() if plain else torch.enable_grad():
                h, ok = shoot2d.shoot2d(*leaves, Mn, -0.2, 4)
                out.append((h, *torch.autograd.grad(h, leaves, cot)))
            assert not ok.requires_grad and bool(ok)
        for got, ref in zip(*out):
            close_rel(ref.detach().numpy(), got, 1e-12)
    assert shoot_glue == {"shoot2d_fwd_plain": 2, "shoot2d_bwd_plain": 2}


def test_atlas_step_2d_through_function_matches_plain(rng, shoot_glue):
    """Two chained 2D atlas steps (5 integration steps, batch-1 atlas,
    momenta in the unit regime) through the Function equal the steps
    through the plain versions, with K8 and K9 each launched once per step
    and no other kernel (the 2D fluid solve, warp and general tiers are
    plain PyTorch, as in the JAX package)."""
    m = t(momenta(rng, 0.5))
    I = t(rng.standard_normal((1, 1) + SHAPE[2:]))
    img = t(rng.standard_normal((SHAPE[0], 1) + SHAPE[2:]))
    step = lt.make_lddmm_atlas_step(lt.FluidMetric(PARAMS), reg_weight=0.1,
                                    learning_rate_pose=1e-6)  # moves m by ~1%
    got, ref = [], []
    for out, plain in ((got, False), (ref, True)):
        mm = m
        with kernels.plain_versions() if plain else torch.enable_grad():
            for _ in range(2):
                shoot_glue.clear()
                out.append(step(I, mm, img))
                mm = out[-1][0]
                assert dict(shoot_glue) == ({} if plain else
                                            {"shoot2d_fwd_plain": 1, "shoot2d_bwd_plain": 1})
    for g_step, r_step in zip(got, ref):
        for g, r in zip(g_step, r_step):
            close_rel(r.numpy(), g, 1e-10)


def test_convert_atlas_state_2d(rng):
    """2D state carries over as it is: a (1, 1, H, W) atlas, (N, 2, H, W)
    momenta, and a step on them."""
    atlas = rng.standard_normal((1, 1) + SHAPE[2:])
    ms = momenta(rng, 0.5)
    metric, I, m = convert.atlas_state(PARAMS, jnp.asarray(atlas), jnp.asarray(ms), "cpu",
                                       torch.float64)
    np.testing.assert_array_equal(I.numpy(), atlas)
    np.testing.assert_array_equal(m.numpy(), ms)
    assert metric.params == PARAMS and tuple(m.shape) == SHAPE
    m_new, I_grad, _, _ = lt.make_lddmm_atlas_step(metric)(I, m, m[:, :1])
    assert m_new.shape == m.shape and I_grad.shape == I.shape


@functools.lru_cache(maxsize=None)
def _jax_bounded_vjp():
    return jax.jit(lambda g, I, d: jax.vjp(
        lambda a, b: jsamp.sample_displacement_bounded(a, b, 2), I, d)[1](g))


@pytest.mark.parametrize("shape", [(2, 2, 9, 7), (2, 3, 6, 5, 7)])
@pytest.mark.parametrize("image_batch", ["one", "N"])
def test_bounded_tier_backward_matches_jax_vjp(rng, shape, image_batch):
    """The bounded warp tier (radius 2, displacements across [-2, 3)) in 2D
    and 3D: values and both gradients against the JAX package's custom VJP
    (a batch-1 image's gradient summed over the subjects), and autograd
    keeps only ``I`` and ``disp`` for the backward."""
    N, dim = shape[:2]
    I = rng.standard_normal(((1 if image_batch == "one" else N), 2) + shape[2:])
    d = rng.uniform(-2, 3, shape)
    g = rng.standard_normal((N, 2) + shape[2:])
    ref = jsamp.sample_displacement_bounded(jnp.asarray(I), jnp.asarray(d), 2)
    rI, rd = _jax_bounded_vjp()(jnp.asarray(g), jnp.asarray(I), jnp.asarray(d))
    tI, td = t(I).requires_grad_(True), t(d).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x) or x, lambda x: x):
        out = tsamp.sample_displacement_bounded(tI, td, 2)
    assert [(x.data_ptr(), x.shape) for x in saved] == [(tI.data_ptr(), tI.shape),
                                                       (td.data_ptr(), td.shape)]
    gI, gd = torch.autograd.grad(out, (tI, td), t(g))
    for r, x in ((ref, out), (rI, gI), (rd, gd)):
        close_rel(r, x, 1e-12)
