"""The 2D per-substep kernels K10-K13 (``ops/kernels/epdiff2d.py``) and
the 2D shootings that run them (a fluid metric with ``beta != 0``, a
momentum mask) against the JAX package on the CPU.

(a) The plain K10-K13 against the JAX ``ad_star2d_pallas`` /
    ``compose2d_pallas`` and their VJPs, the Pallas kernels run in
    interpret mode, in float32: within 5e-6 (forwards) and 5e-5
    (backwards) absolute, the bounds of the JAX package's own
    interpret-mode harness (scripts/kernel_interp_check.py:139-167).
(b) The JAX flagged 2D path itself (``_expmap_fast_flagged`` with the
    ``epdiff2d`` pair, in interpret mode, float32) against the port's
    ``expmap``: phiinv within 1e-5 * max|ref| (the two libraries' float32
    FFTs round differently), the flags equal.
(c) In float64 against the JAX package (its plain formulations): the
    port's 2D ``expmap`` at ``beta = 0.05`` and at ``beta = 0`` with a
    ``mommask``, ``_lddmm_loss`` and ``make_lddmm_atlas_step`` at ``beta =
    0.05`` with and without ``mask``, within 1e-9 * max|ref| (FFT roundoff).
(d) The autograd Functions around K10-K13 with the launches replaced by
    the plain versions: gradients within 1e-10 * (1 + max|ref|) of autograd
    of the plain versions, 4 launches of each kernel per atlas step and
    none of K8/K9, and the ``Ad_star`` / ``compose`` dispatch by warp tier.
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
from lagomorph_tpu.ops.pallas import epdiff2d as je2, warp_unit as jwu
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import adjrep, deform, lddmm as tlddmm
from lagomorph_tpu_torch.ops import kernels
from lagomorph_tpu_torch.ops.kernels import epdiff2d, epdiff_unit, fft_unit, shoot2d, warp_unit

torch.set_num_threads(2)

PARAMS = (0.1, 0.05, 0.01)  # beta != 0: the whole-shoot kernels' gate is closed
SHAPE = (2, 2, 24, 20)
STEPS = 5
FFT_RTOL = 1e-9
FWD_TOL, BWD_TOL = 5e-6, 5e-5
INTERP_SHAPES = [(2, 2, 32, 128), (2, 2, 48, 256)]  # the JAX kernels' gate: H % 8, W % 128
SHOOT_TOL = 1e-5
GLUE_RTOL = 1e-10


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(ref, got, atol):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def close_rel(ref, got, rtol):
    close(ref, got, rtol * float(np.abs(np.asarray(ref)).max()))


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's Pallas calls in interpret mode with its warp-kernel
    gates open (as scripts/kernel_interp_check.py:27, 34 sets them), in
    float32 (the kernels' dtype)."""
    monkeypatch.setattr(je2.pl, "pallas_call",
                        functools.partial(je2.pl.pallas_call, interpret=True))
    monkeypatch.setattr(jwu, "pallas_warp_enabled", lambda: True)
    with jax.enable_x64(False):
        yield


@pytest.mark.parametrize("shape", INTERP_SHAPES)
@pytest.mark.parametrize("m_batch", ["one", "N"])
def test_plain_kernels_match_jax_interpret(rng, jax_interpret, shape, m_batch):
    """K10's and K12's plain versions (Ad* with batch-1 and batch-N momenta,
    its gradients, a batch-1 d_m0 summed over the subjects) and K11's and
    K13's (compose at s = -0.2) against the JAX ``epdiff2d`` kernels and
    their VJPs; the flags against ``lddmm._in_unit``."""
    N = shape[0]
    p = rng.uniform(-0.9, 0.9, shape).astype(np.float32)
    m0 = rng.standard_normal(((1 if m_batch == "one" else N),) + shape[1:]).astype(np.float32)
    v = rng.uniform(-4.0, 4.0, shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    assert je2.supported(p.shape, m0.shape, jnp.float32)

    ref, vjp = jax.vjp(je2.ad_star2d_pallas, jnp.asarray(p), jnp.asarray(m0))
    rp, rm = vjp(jnp.asarray(g))
    out, flag, mw = epdiff2d.ad_star2d_plain(t(p), t(m0), want_mw=True)
    close(ref, out, FWD_TOL)
    dp, dm = epdiff2d.ad_star2d_bwd_plain(t(p), t(m0), t(g), mw)
    close(rp, dp, BWD_TOL)
    close(rm, dm, BWD_TOL)
    assert bool(flag) is bool(jlddmm._in_unit(jnp.asarray(p))) is True

    ref, vjp = jax.vjp(lambda a, b: je2.compose2d_pallas(a, b, -0.2), jnp.asarray(p),
                       jnp.asarray(v))
    rp, rv = vjp(jnp.asarray(g))
    out, flag = epdiff2d.compose2d_plain(t(p), t(v), -0.2)
    close(ref, out, FWD_TOL)
    dp, dv = epdiff2d.compose2d_bwd_plain(t(p), t(v), -0.2, t(g))
    close(rp, dp, BWD_TOL)
    close(rv, dv, BWD_TOL)
    assert bool(flag) is bool(jlddmm._in_unit(-0.2 * jnp.asarray(v))) is True


def momenta(rng, max_v0, shape=SHAPE, params=PARAMS):
    """Momenta scaled so that the initial velocity peaks at ``max_v0``
    voxels: 0.5 stays in the unit regime over 5 substeps; 2 leaves it in
    the third; 6 in the first."""
    m = rng.standard_normal(shape)
    return m * (max_v0 / float(lt.FluidMetric(params).sharp(t(m)).abs().max()))


@pytest.mark.parametrize("max_v0,hoisted", [(0.5, True), (6.0, False)])
def test_jax_flagged_2d_path_matches_port(rng, jax_interpret, max_v0, hoisted):
    """The JAX hoisted 2D path at ``beta = 0.05``: ``_hoisted_fused_pair``
    gives the ``epdiff2d`` pair (shoot2d's gate is closed by beta), and its
    ``_expmap_fast_flagged`` (interpret mode) gives the port's fast result
    and flag; the whole ``expmap`` (the flag's ``lax.cond`` re-running the
    general integration when it trips) matches the port's."""
    shape = (2, 2, 16, 128)
    m = momenta(rng, max_v0, shape).astype(np.float32)
    jm = jnp.asarray(m)
    jmetric = lm.FluidMetric(PARAMS)
    assert jlddmm._hoisted_fused_pair(jm) == (je2.ad_star2d_pallas, je2.compose2d_pallas)
    dt = 1.0 / STEPS
    jphi0 = -dt * jmetric.sharp(jm)
    jfast, jok = jlddmm._expmap_fast_flagged(jmetric, jm, dt, STEPS - 1, jphi0, None, False,
                                             jlddmm._hoisted_fused_pair(jm))
    metric = lt.FluidMetric(PARAMS)
    fast, ok = tlddmm._expmap_fast_flagged(metric, t(m), dt, STEPS - 1,
                                           -dt * metric.sharp(t(m)), None)
    assert bool(ok) is bool(jok) is hoisted
    close_rel(jfast, fast, SHOOT_TOL)
    ref = jax.jit(lambda m_: lm.expmap(jmetric, m_, num_steps=STEPS))(jm)
    close_rel(ref, lt.expmap(metric, t(m), num_steps=STEPS), SHOOT_TOL)


@pytest.fixture
def shoot_calls(monkeypatch):
    """Counts the calls of the 2D fast integrators and of
    ``_expmap_general`` (the re-run after a tripped flag)."""
    calls = collections.Counter()
    for mod, name in ((tlddmm, "_expmap_fast_flagged"), (shoot2d, "shoot2d"),
                      (tlddmm, "_expmap_general")):
        fn = getattr(mod, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


@functools.lru_cache(maxsize=None)
def _jax_expmap(params, with_mask):
    metric = lm.FluidMetric(params)
    if with_mask:
        return jax.jit(lambda m, k: lm.expmap(metric, m, num_steps=STEPS, mommask=k))
    return jax.jit(lambda m: lm.expmap(metric, m, num_steps=STEPS))


@pytest.mark.parametrize("case", ["beta", "beta_batch1", "beta_tripped", "mommask",
                                  "mommask_tripped"])
def test_expmap_2d_per_substep_path_matches_jax(rng, shoot_calls, case):
    """The 2D shootings that the whole-shoot kernels do not take run the
    per-substep integrator (K10/K11 on the card): ``beta = 0.05`` with
    batch-2 and batch-1 momenta, and ``beta = 0`` with a momentum mask; at
    max|v0| = 6 the flag trips and the general integration re-runs.  All
    match the JAX package in float64."""
    params = (0.1, 0.0, 0.01) if case.startswith("mommask") else PARAMS
    batch = 1 if case == "beta_batch1" else 2
    max_v0 = 6.0 if case.endswith("tripped") else 0.5
    m = momenta(rng, max_v0, (batch,) + SHAPE[1:], params)
    mask = ((rng.uniform(size=(1, 1) + SHAPE[2:]) > 0.3).astype(np.float64)
            if case.startswith("mommask") else None)
    ref = _jax_expmap(params, mask is not None)(
        jnp.asarray(m), *(() if mask is None else (jnp.asarray(mask),)))
    got = lt.expmap(lt.FluidMetric(params), t(m), num_steps=STEPS,
                    mommask=None if mask is None else t(mask))
    close_rel(ref, got, FFT_RTOL)
    want = {"_expmap_fast_flagged": 1}
    if case.endswith("tripped"):
        want["_expmap_general"] = 1
    assert dict(shoot_calls) == want


@functools.lru_cache(maxsize=None)
def _jax_loss(use_mask):
    metric = lm.FluidMetric(PARAMS)
    if use_mask:
        return jax.jit(lambda I, m, img, mask: jlddmm._lddmm_loss(
            I, m, img, metric, 0.1, STEPS, False, mask=mask))
    return jax.jit(lambda I, m, img: jlddmm._lddmm_loss(I, m, img, metric, 0.1, STEPS, False))


@pytest.mark.parametrize("max_v0", [0.5, 6.0])
@pytest.mark.parametrize("use_mask", [False, True])
def test_lddmm_loss_2d_beta_matches_jax(rng, max_v0, use_mask):
    """The 2D atlas loss at ``beta = 0.05``, a batch-1 atlas broadcast over
    the batch, with and without a mask over padded subjects."""
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
def test_atlas_step_2d_beta_matches_jax(rng, max_v0, use_mask):
    """``make_lddmm_atlas_step`` at ``beta = 0.05`` on 2D fields: the new
    momenta and the update, the atlas gradient, the loss and the
    regulariser."""
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
def glue(monkeypatch):
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

    for mod in (warp_unit, epdiff_unit, fft_unit, shoot2d, epdiff2d):
        monkeypatch.setattr(mod, "use_kernel", lambda _t: not kernels._PLAIN.get())
        monkeypatch.setattr(mod, "check_cuda_f32", lambda _name, *_ts: None)
    for mod, name, plain in (
        (epdiff2d, "_launch_ad_star", epdiff2d.ad_star2d_plain),
        (epdiff2d, "_launch_ad_star_bwd", epdiff2d.ad_star2d_bwd_plain),
        (epdiff2d, "_launch_compose", epdiff2d.compose2d_plain),
        (epdiff2d, "_launch_compose_bwd", epdiff2d.compose2d_bwd_plain),
        (shoot2d, "_launch_fwd", shoot2d.shoot2d_fwd_plain),
        (shoot2d, "_launch_bwd", shoot2d.shoot2d_bwd_plain),
    ):
        monkeypatch.setattr(mod, name, counted(plain))
    return calls


def _grads(fn, inputs, cot):
    """Gradients of ``fn(*inputs)`` in every input under a dense cotangent,
    the expanded one of ``sum`` (stride 0) and a transposed view."""
    out = []
    for how in ("dense", "sum", "strided"):
        leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
        y = fn(*leaves)
        if how == "dense":
            loss = (y * cot).sum()
        elif how == "sum":
            loss = y.sum()
        else:
            loss = (y.transpose(2, 3) * cot.transpose(2, 3).contiguous()).sum()
        out.append(torch.autograd.grad(loss, leaves))
    return out


@pytest.mark.parametrize("case", ["ad_star_m1", "ad_star_mN", "compose"])
def test_functions_match_plain(rng, glue, case):
    """The Functions around K10/K12 and K11/K13 (plain launches): gradients
    equal autograd of the plain forward, for batch-1 momenta (summed over
    the subjects), the step scale s and non-contiguous cotangents; the flag
    is a non-differentiable bool."""
    N = SHAPE[0]
    p = t(rng.uniform(-0.95, 0.95, SHAPE))
    cot = t(rng.standard_normal(SHAPE))
    if case.startswith("ad_star"):
        m0 = t(rng.standard_normal(((1 if case == "ad_star_m1" else N),) + SHAPE[1:]))
        fn, plain, inputs = (lambda a, b: epdiff2d.ad_star2d(a, b)[0],
                             lambda a, b: epdiff2d.ad_star2d_plain(a, b)[0], (p, m0))
        backward = "ad_star2d_bwd_plain"
    else:
        v = t(rng.uniform(-4.9, 4.9, SHAPE))
        fn, plain, inputs = (lambda a, b: epdiff2d.compose2d(a, b, -0.2)[0],
                             lambda a, b: epdiff2d.compose2d_plain(a, b, -0.2)[0], (p, v))
        backward = "compose2d_bwd_plain"
    got = _grads(fn, inputs, cot)
    assert glue[backward] == 3  # one backward per cotangent, through the Function
    with kernels.plain_versions():
        ref = _grads(plain, inputs, cot)
    for g_case, r_case in zip(got, ref):
        for g, r in zip(g_case, r_case):
            assert g.shape == r.shape
            close(r.numpy(), g, GLUE_RTOL * (1.0 + float(r.abs().max())))
    call = epdiff2d.ad_star2d if case.startswith("ad_star") else (
        lambda a, b: epdiff2d.compose2d(a, b, -0.2))
    out, flag = call(p.requires_grad_(True), inputs[1])
    assert out.requires_grad and not flag.requires_grad and flag.dtype == torch.bool


@pytest.mark.parametrize("use_mask", [False, True])
def test_atlas_step_2d_beta_through_functions_matches_plain(rng, glue, use_mask):
    """Two chained 2D atlas steps at ``beta = 0.05`` (5 integration steps,
    batch-1 atlas, momenta in the unit regime; with and without a mask
    over padded subjects) through the Functions equal the steps through the
    plain versions, with K10, K11, K12 and K13 each launched 4 times per
    step and K8/K9 not at all."""
    m = t(momenta(rng, 0.5))
    I = t(rng.standard_normal((1, 1) + SHAPE[2:]))
    img = t(rng.standard_normal((SHAPE[0], 1) + SHAPE[2:]))
    extra = (t(np.array([1.0, 0.0])),) if use_mask else ()
    step = lt.make_lddmm_atlas_step(lt.FluidMetric(PARAMS), reg_weight=0.1,
                                    learning_rate_pose=1e-6)  # moves m by ~1%
    got, ref = [], []
    for out, plain in ((got, False), (ref, True)):
        mm = m
        with kernels.plain_versions() if plain else torch.enable_grad():
            for _ in range(2):
                glue.clear()
                out.append(step(I, mm, img, *extra))
                mm = out[-1][0]
                assert dict(glue) == ({} if plain else {
                    "ad_star2d_plain": 4, "compose2d_plain": 4, "ad_star2d_bwd_plain": 4,
                    "compose2d_bwd_plain": 4})
    for g_step, r_step in zip(got, ref):
        for g, r in zip(g_step, r_step):
            close_rel(r.numpy(), g, GLUE_RTOL)


def test_mommask_and_fallback_run_per_substep_kernels(rng, glue):
    """At ``beta = 0`` a momentum mask closes the whole-shoot gate: the
    shooting takes K10/K11 (4 each).  At max|v0| = 2 the flag trips in the
    third substep, and the general re-run picks each warp's tier: K10 where
    phiinv lies in the unit regime (the first two substeps; the bounded tier
    after) and K11 at every substep (each s*v stays under 0.5 voxel).  Both
    results equal the plain versions'."""
    metric0 = lt.FluidMetric((0.1, 0.0, 0.01))
    m = t(momenta(rng, 0.5, params=metric0.params))
    mask = t((rng.uniform(size=(1, 1) + SHAPE[2:]) > 0.3).astype(np.float64))
    got = lt.expmap(metric0, m, num_steps=STEPS, mommask=mask)
    assert dict(glue) == {"ad_star2d_plain": 4, "compose2d_plain": 4}
    with kernels.plain_versions():
        ref = lt.expmap(metric0, m, num_steps=STEPS, mommask=mask)
    close_rel(ref.numpy(), got, GLUE_RTOL)
    glue.clear()
    metric = lt.FluidMetric(PARAMS)
    m = t(momenta(rng, 2.0))
    got = lt.expmap(metric, m, num_steps=STEPS)
    assert dict(glue) == {"ad_star2d_plain": 4 + 2, "compose2d_plain": 4 + 4}
    with kernels.plain_versions():
        close_rel(lt.expmap(metric, m, num_steps=STEPS).numpy(), got, GLUE_RTOL)


@pytest.mark.parametrize("mode,launches", [("unit", 1), ("auto", 1), (None, 1),
                                           ("bounded", 0), ("general", 0)])
def test_ad_star_and_compose_dispatch_2d(rng, glue, mode, launches):
    """``Ad_star`` and ``compose`` on 2D fields launch K10 / K11 for
    ``mode="unit"``, and for "auto" (or None) when the displacement's warp
    tier is "unit"; "bounded" and "general" take the plain tiers.  Every
    mode gives the same values in the unit regime; out of it "auto" takes
    no kernel."""
    p = t(rng.uniform(-0.95, 0.95, SHAPE))
    m0 = t(rng.standard_normal((1,) + SHAPE[1:]))
    v = t(rng.uniform(-4.9, 4.9, SHAPE))
    with kernels.plain_versions():
        ref_a = adjrep.Ad_star(p, m0, mode="general")
        ref_c = deform.compose_disp_vel(p, v, dt=-0.2, mode="general")
    close(ref_a.numpy(), adjrep.Ad_star(p, m0, mode=mode), 1e-12)
    close(ref_c.numpy(), deform.compose_disp_vel(p, v, dt=-0.2, mode=mode), 1e-12)
    assert dict(glue) == ({"ad_star2d_plain": 1, "compose2d_plain": 1} if launches else {})
    if mode in ("auto", None):
        glue.clear()
        adjrep.Ad_star(1.5 * p, m0, mode=mode)
        deform.compose_disp_vel(p, 2 * v, dt=-0.2, mode=mode)
        assert not glue
