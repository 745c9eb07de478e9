"""The port's atlas builder and what it reaches beyond the atlas step,
against the JAX package on the CPU in float64:

* ``regrid`` (values and ``jax.vjp``) up and down a grid, with and without
  ``displacement``, and with an explicit origin and spacing;
* ``_lddmm_loss`` (value and gradients) and ``make_lddmm_atlas_step`` with
  momenta on a half grid (the regrid branch);
* ``checkpoints=True`` in ``expmap``, ``_lddmm_loss`` and the atlas step,
  equal to ``checkpoints=False`` (values and gradients), and through the
  kernels' autograd Functions with plain launches: the recomputed forwards'
  launches and the tensors autograd keeps;
* ``EPDiff_steps`` against the JAX one;
* ``LDDMMAtlasBuilder`` against the JAX builder over 2 epochs, in 2D and 3D
  and with each option that changes what it computes or how it stages.

Tolerance: 1e-9 relative to max|ref| (every step goes through fluid
solves, and the two libraries' FFTs round differently, ~1e-15).  The JAX
side runs under its exact "general" warp tier (``set_warp_mode``): every
tier computes the same function in its regime, and the forced tier
compiles a third of the branches.
"""
import collections
import contextlib
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
from lagomorph_tpu_torch import lddmm as tlddmm
from lagomorph_tpu_torch.ops import kernels
from lagomorph_tpu_torch.ops.kernels import epdiff2d, epdiff_unit, fft_unit, shoot2d, warp_unit

torch.set_num_threads(2)

RTOL = 1e-9
PARAMS = (0.1, 0.0, 0.01)
PARAMS_BETA = (0.1, 0.05, 0.01)  # beta != 0: 2D shooting on the per-substep kernels
STEPS = 5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close_rel(ref, got, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


@contextlib.contextmanager
def general_tier():
    prev = set_warp_mode("general")
    try:
        yield
    finally:
        set_warp_mode(prev)


def momenta(rng, shape, params=PARAMS, max_v0=0.5):
    """Momenta whose initial velocity peaks at ``max_v0`` voxels (0.5: the
    shooting stays in the unit regime, the kernels' fast path)."""
    m = rng.standard_normal(shape)
    return m * (max_v0 / float(lt.FluidMetric(params).sharp(t(m)).abs().max()))


# ---------------------------------------------------------------------------
# regrid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["up2d_disp", "up3d", "down3d_disp", "down2d", "origin_spacing"])
def test_regrid_matches_jax(rng, case):
    """Values and the vector-Jacobian product in the input."""
    shapes = {"up2d_disp": ((2, 2, 6, 7), (12, 13)), "up3d": ((1, 1, 4, 5, 6), (8, 9, 7)),
              "down3d_disp": ((2, 3, 9, 8, 10), (5, 4, 6)), "down2d": ((1, 3, 16, 12), (9, 7)),
              "origin_spacing": ((2, 1, 10, 9, 8), (6, 5, 7))}
    in_shape, shape = shapes[case]
    kw = {"shape": shape, "displacement": case.endswith("disp")}
    if case == "origin_spacing":
        kw.update(origin=(4.0, 3.5, 3.0), spacing=1.25)
    I = rng.standard_normal(in_shape)
    ref, vjp = jax.vjp(lambda x: lm.regrid(x, **kw), jnp.asarray(I))
    g = rng.standard_normal(np.asarray(ref).shape)
    (ref_grad,) = vjp(jnp.asarray(g))
    tI = t(I).requires_grad_(True)
    got = lt.regrid(tI, **kw)
    close_rel(ref, got)
    (grad,) = torch.autograd.grad(got, tI, t(g))
    close_rel(ref_grad, grad)


def test_regrid_raises_as_jax():
    I = t(np.zeros((1, 2, 4, 4)))
    with pytest.raises(ValueError):
        lt.regrid(I)
    with pytest.raises(NotImplementedError):
        lt.regrid(I, spacing=2.0)
    with pytest.raises(ValueError, match="channels"):
        lt.regrid(t(np.zeros((1, 3, 4, 4))), shape=8, displacement=True)


# ---------------------------------------------------------------------------
# momenta on a half grid
# ---------------------------------------------------------------------------

HALF = {2: ((2, 2, 7, 6), (14, 12)), 3: ((2, 3, 5, 4, 6), (10, 8, 12))}


@functools.lru_cache(maxsize=None)
def _jax_half(dim, what):
    metric = lm.FluidMetric(PARAMS)
    image_shape = HALF[dim][1]
    if what == "loss":
        def f(m, I, img):
            return jlddmm._lddmm_loss(I, m, img, metric, 0.1, STEPS, False,
                                      image_shape=image_shape)
        return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    step = jlddmm.make_lddmm_atlas_step(metric, reg_weight=0.1, learning_rate_pose=1e-4,
                                        integration_steps=STEPS, image_shape=image_shape)
    return jax.jit(lambda I, m, img: step(I, m, img))


def _half_inputs(rng, dim):
    mshape, image_shape = HALF[dim]
    m = momenta(rng, mshape)
    I = rng.standard_normal((1, 1) + image_shape)
    img = rng.standard_normal((mshape[0], 1) + image_shape)
    return m, I, img, image_shape


@pytest.mark.parametrize("dim", [3])
def test_lddmm_loss_half_grid_matches_jax(rng, dim):
    """The regrid branch: the deformation regridded (unscaled) onto the
    image grid and the regulariser scaled by the grids' ratio; the loss,
    the regulariser and both gradients."""
    m, I, img, image_shape = _half_inputs(rng, dim)
    with general_tier():
        (ref_loss, ref_reg), (ref_gm, ref_gI) = _jax_half(dim, "loss")(
            jnp.asarray(m), jnp.asarray(I), jnp.asarray(img))
    tm, tI = t(m).requires_grad_(True), t(I).requires_grad_(True)
    loss, reg = tlddmm._lddmm_loss(tI, tm, t(img), lt.FluidMetric(PARAMS), 0.1, STEPS,
                                   image_shape=image_shape)
    gm, gI = torch.autograd.grad(loss, (tm, tI))
    for r, g in ((ref_loss, loss), (ref_reg, reg)):
        assert abs(g.item() - float(r)) <= RTOL * abs(float(r))
    close_rel(ref_gm, gm)
    close_rel(ref_gI, gI)


@pytest.mark.parametrize("dim", [2])
def test_atlas_step_half_grid_matches_jax(rng, dim):
    m, I, img, image_shape = _half_inputs(rng, dim)
    with general_tier():
        ref = _jax_half(dim, "step")(jnp.asarray(I), jnp.asarray(m), jnp.asarray(img))
    step = lt.make_lddmm_atlas_step(lt.FluidMetric(PARAMS), reg_weight=0.1,
                                    learning_rate_pose=1e-4, integration_steps=STEPS,
                                    image_shape=image_shape)
    m_new, I_grad, loss, reg = step(t(I), t(m), t(img))
    close_rel(ref[0], m_new)
    update = np.asarray(ref[0]) - m
    assert np.abs(update).max() > 1e-3 * np.abs(m).max()  # the step moved the momenta
    close_rel(update, m_new - t(m))
    close_rel(ref[1], I_grad)
    for r, g in zip(ref[2:], (loss, reg)):
        assert abs(float(g) - float(r)) <= RTOL * abs(float(r))


# ---------------------------------------------------------------------------
# checkpoints=True
# ---------------------------------------------------------------------------

CKPT_CASES = {  # shape, params, max|v0|, expmap keywords
    "hoisted3d": ((2, 3, 8, 6, 10), PARAMS, 0.5, {}),
    "fallback3d": ((1, 3, 8, 6, 10), PARAMS, 6.0, {}),
    "per_step3d": ((1, 3, 7, 6, 5), PARAMS, 0.5,
                   {"transport_mode": "unit", "compose_mode": "unit"}),
    "shoot2d": ((2, 2, 12, 10), PARAMS, 0.5, {}),
    "per_substep2d": ((2, 2, 12, 10), PARAMS_BETA, 0.5, {}),
    "mommask2d": ((1, 2, 12, 10), PARAMS, 0.5, {"mommask": "random"}),
}


@pytest.mark.parametrize("case", list(CKPT_CASES))
def test_expmap_checkpoints_equal(rng, case):
    """``expmap(..., checkpoints=True)`` equals ``checkpoints=False``, value
    and momentum gradient, on each path: the hoisted 3D and 2D per-substep
    loops, the fallback, the per-step loop with forced tiers, and K8's
    whole shoot (which ignores the option)."""
    shape, params, max_v0, kw = CKPT_CASES[case]
    m = momenta(rng, shape, params, max_v0)
    w = t(rng.standard_normal(shape))
    if kw.get("mommask") == "random":
        kw = {"mommask": t((rng.uniform(size=(1, 1) + shape[2:]) > 0.3).astype(np.float64))}
    metric = lt.FluidMetric(params)
    out = []
    for ckpt in (False, True):
        m_ = t(m).requires_grad_(True)
        h = lt.expmap(metric, m_, num_steps=STEPS, checkpoints=ckpt, **kw)
        out.append((h, torch.autograd.grad((h * w).sum(), m_)[0]))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dim", [2, 3])
def test_lddmm_loss_and_step_checkpoints_equal(rng, dim):
    """``_lddmm_loss`` (``checkpoints`` in its JAX position) and two chained
    atlas steps with ``checkpoints=True`` equal those without, with a
    batch-1 atlas."""
    shape = (2, 3, 8, 6, 10) if dim == 3 else (2, 2, 12, 10)
    params = PARAMS if dim == 3 else PARAMS_BETA
    m = momenta(rng, shape, params)
    I = rng.standard_normal((1, 1) + shape[2:])
    img = rng.standard_normal((shape[0], 1) + shape[2:])
    metric = lt.FluidMetric(params)
    losses = [tlddmm._lddmm_loss(t(I), t(m), t(img), metric, 0.1, STEPS, ckpt)
              for ckpt in (False, True)]
    assert torch.equal(torch.stack(losses[0]), torch.stack(losses[1]))
    out = []
    for ckpt in (False, True):
        step = lt.make_lddmm_atlas_step(metric, reg_weight=0.1, learning_rate_pose=1e-4,
                                        integration_steps=STEPS, checkpoints=ckpt)
        mm, res = t(m), []
        for _ in range(2):
            res.append(step(t(I), mm, t(img)))
            mm = res[-1][0]
        out.append(res)
    for r_step, g_step in zip(*out):
        for r, g in zip(r_step, g_step):
            assert torch.equal(r, g)


@pytest.fixture
def glue(monkeypatch):
    """Route every kernel wrapper through its autograd Function on the CPU,
    as for a tensor on the card, each launch replaced by its plain version;
    yields the count of launches by plain-version name."""
    calls = collections.Counter()

    def counted(fn):
        def launch(*args, **kw):
            calls[fn.__name__] += 1
            return fn(*args, **kw)
        return launch

    for mod in (warp_unit, epdiff_unit, fft_unit, shoot2d, epdiff2d):
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
        (epdiff2d, "_launch_ad_star", epdiff2d.ad_star2d_plain),
        (epdiff2d, "_launch_ad_star_bwd", epdiff2d.ad_star2d_bwd_plain),
        (epdiff2d, "_launch_compose", epdiff2d.compose2d_plain),
        (epdiff2d, "_launch_compose_bwd", epdiff2d.compose2d_bwd_plain),
        (shoot2d, "_launch_fwd", shoot2d.shoot2d_fwd_plain),
        (shoot2d, "_launch_bwd", shoot2d.shoot2d_bwd_plain),
    ):
        monkeypatch.setattr(mod, name, counted(plain))
    return calls


# launches of one atlas step (5 integration steps, the fast path): the
# peeled first step runs no Ad* or compose, so 4 substeps; with checkpoints
# each substep's forward runs again in the backward
STEP3D = {"ad_star_plain": 4, "compose_plain": 4, "fluid_flat_plain": 10,
          "sample_displacement_unit": 1, "sample_displacement_unit_bwd_plain": 1,
          "ad_star_bwd_plain": 4, "compose_bwd_plain": 4}
STEP3D_CKPT = {**STEP3D, "ad_star_plain": 8, "compose_plain": 8, "fluid_flat_plain": 14}
STEP2D = {"ad_star2d_plain": 4, "compose2d_plain": 4, "ad_star2d_bwd_plain": 4,
          "compose2d_bwd_plain": 4}
STEP2D_CKPT = {**STEP2D, "ad_star2d_plain": 8, "compose2d_plain": 8}


@pytest.mark.parametrize("dim", [3, 2])
def test_checkpoints_through_functions(rng, glue, dim):
    """With the Functions around the kernels (plain launches), an atlas
    step with ``checkpoints=True`` equals the step without and the step on
    the plain versions; its backward launches each substep's forward
    kernels again (K1, K2 and the substeps' K3 in 3D; K10, K11 in 2D at
    ``beta = 0.05``), and autograd keeps fewer tensors: no substep's
    intermediates, only each checkpoint's inputs."""
    shape = (2, 3, 8, 6, 10) if dim == 3 else (2, 2, 12, 10)
    metric = lt.FluidMetric(PARAMS if dim == 3 else PARAMS_BETA)
    m = t(momenta(rng, shape, metric.params))
    I = t(rng.standard_normal((1, 1) + shape[2:]))
    img = t(rng.standard_normal((shape[0], 1) + shape[2:]))
    got, saved = {}, {}
    for ckpt in (False, True):
        step = lt.make_lddmm_atlas_step(metric, reg_weight=0.1, learning_rate_pose=1e-4,
                                        checkpoints=ckpt)
        glue.clear()
        got[ckpt] = step(I, m, img)
        want = {(3, False): STEP3D, (3, True): STEP3D_CKPT,
                (2, False): STEP2D, (2, True): STEP2D_CKPT}[dim, ckpt]
        assert dict(glue) == want
        saved[ckpt] = []
        m_ = m.clone().requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(
                lambda x, into=saved[ckpt]: into.append(x) or x, lambda x: x):
            tlddmm._lddmm_loss(I, m_, img, metric, 0.1, STEPS, ckpt)
    assert len(saved[True]) < len(saved[False])
    with kernels.plain_versions():
        ref = lt.make_lddmm_atlas_step(metric, reg_weight=0.1, learning_rate_pose=1e-4)(
            I, m, img)
    for a, b, r in zip(got[False], got[True], ref):
        assert torch.equal(a, b)
        close_rel(r.numpy(), b, 1e-10)


def test_epdiff_steps_matches_jax(rng):
    """``EPDiff_steps`` from a given ``phiinv``: value and gradients in the
    momenta and ``phiinv``, on 2D fields."""
    shape = (2, 2, 12, 10)
    m = momenta(rng, shape)
    phi0 = 0.3 * momenta(rng, shape)
    w = rng.standard_normal(shape)

    def f(m_, p_):
        return jnp.sum(jlddmm.EPDiff_steps(lm.FluidMetric(PARAMS), m_, 0.2, 3, p_) *
                       jnp.asarray(w))
    with general_tier():
        ref, (ref_gm, ref_gp) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
            jnp.asarray(m), jnp.asarray(phi0))
    tm, tp = t(m).requires_grad_(True), t(phi0).requires_grad_(True)
    h = lt.EPDiff_steps(lt.FluidMetric(PARAMS), tm, 0.2, 3, tp)
    loss = (h * t(w)).sum()
    assert abs(loss.item() - float(ref)) <= RTOL * abs(float(ref))
    gm, gp = torch.autograd.grad(loss, (tm, tp))
    close_rel(ref_gm, gm)
    close_rel(ref_gp, gp)


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------

def synth_images(n, res, dim, seed=3):
    """Blobs with random offsets: a dataset whose atlas is a centred blob."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(res, dtype=np.float64)] * dim, indexing="ij"))
    c = (res - 1) / 2.0
    imgs = [np.exp(-sum((grid[d] - c - off[d]) ** 2 for d in range(dim)) / (2 * (res / 6) ** 2))
            for off in rng.uniform(-1.5, 1.5, (n, dim))]
    return np.stack(imgs)[:, None]


BUILDER_BASE = dict(num_epochs=2, batch_size=2, lddmm_integration_steps=3, reg_weight=1e-1,
                    learning_rate_pose=1e-2, learning_rate_image=1e2, progress_bar=False,
                    dtype=np.float64)
# case: (dim, subjects, options of both builders, options of the port's
# alone).  The port-only options change nothing the builder computes, so
# those cases share the JAX run of the case they name.
BUILDER_CASES = {
    "2d": (2, 4, {}, {}),
    "3d": (3, 4, {}, {}),
    "uneven_last_batch": (2, 5, {}, {}),
    "image_update_freq": (2, 4, {"image_update_freq": 1}, {}),
    "lddmm_steps": (2, 4, {"lddmm_steps": 2}, {}),
    "momentum_preconditioning": (2, 4, {"momentum_preconditioning": True,
                                        "learning_rate_pose": 2e2}, {}),
    "momentum_half_grid": (2, 4, {"momentum_shape": (6, 6)}, {}),
    "gradient_checkpointing": ("3d", None, {}, {"gradient_checkpointing": True}),
    "keep_data_on_device": ("uneven_last_batch", None, {}, {"keep_data_on_device": True}),
    "dataloader_cache": ("2d", None, {}, {"dataloader_cache": "tmp"}),
    "loader_workers": ("uneven_last_batch", None, {}, {"loader_workers": 1}),
}


@functools.lru_cache(maxsize=None)
def _jax_builder(case):
    dim, n, opts, _ = BUILDER_CASES[case]
    with general_tier():
        b = lm.LDDMMAtlasBuilder(list(synth_images(n, 12 if dim == 2 else 8, dim)),
                                 metric=lm.FluidMetric([0.01, 0.0, 0.1]),
                                 **{**BUILDER_BASE, **opts})
        b.run()
    return (np.asarray(b.I), [np.asarray(m) for m in b.ms],
            {k: np.asarray(getattr(b, k)) for k in
             ("epoch_losses", "epoch_reg_terms", "iter_losses", "iter_reg_terms")})


@pytest.mark.parametrize("case", list(BUILDER_CASES))
def test_builder_matches_jax(case, tmp_path):
    """Two epochs of ``LDDMMAtlasBuilder`` on the CPU against the JAX
    builder: every iteration's and epoch's loss and regulariser, the atlas
    and each minibatch's momenta, within 1e-9 * max|ref|."""
    ref_case = case if BUILDER_CASES[case][1] is not None else BUILDER_CASES[case][0]
    dim, n, opts, _ = BUILDER_CASES[ref_case]
    port_opts = dict(BUILDER_CASES[case][3])
    if port_opts.get("dataloader_cache") == "tmp":
        port_opts["dataloader_cache"] = str(tmp_path)
    ref_I, ref_ms, ref_losses = _jax_builder(ref_case)
    b = lt.LDDMMAtlasBuilder(list(synth_images(n, 12 if dim == 2 else 8, dim)),
                             metric=lt.FluidMetric([0.01, 0.0, 0.1]), device="cpu",
                             **{**BUILDER_BASE, **opts, **port_opts})
    b.run()
    assert b.I.dtype == torch.float64 and b.I.device.type == "cpu"
    close_rel(ref_I, b.I)
    assert [m.shape[0] for m in b.ms] == [m.shape[0] for m in ref_ms]
    for r, m in zip(ref_ms, b.ms):
        assert np.abs(r).max() > 0  # the momenta moved
        close_rel(r, m if isinstance(m, torch.Tensor) else t(m))
    for k, r in ref_losses.items():
        close_rel(r, np.asarray(getattr(b, k)))
    if "keep_data_on_device" in port_opts:
        assert all(isinstance(m, torch.Tensor) for m in b.ms)
    if "dataloader_cache" in port_opts:
        assert len(list(tmp_path.iterdir())) == 1  # the cache's directory


def test_builder_device_and_unported_options():
    """The builder runs on the card unless given a device: with no CUDA
    device it raises rather than fall back to the CPU.  As in the JAX
    package, ``world_size`` and ``rank`` are read from the process group
    (none here: one process), a mesh pads the minibatch to its size, and
    ``spatial_shard`` without a mesh raises ``ValueError`` at
    ``initialize``, as does an unknown ``loader_mode``; the members freeze
    after it."""
    from lagomorph_tpu_torch.parallel import get_mesh

    imgs = list(synth_images(2, 8, 2))
    kw = dict(num_epochs=1, batch_size=2, progress_bar=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lt.LDDMMAtlasBuilder(imgs, **kw).initialize()
    for opts in ({"world_size": 2}, {"rank": 1}):
        b = lt.LDDMMAtlasBuilder(imgs, device="cpu", **kw, **opts)
        b.initialize()
        assert (b._world, b._rank, b._pad_multiple) == (1, 0, 1)
    b = lt.LDDMMAtlasBuilder(imgs, mesh=get_mesh(devices=["cpu"] * 2), **kw)
    b.initialize()
    assert b._pad_multiple == 2 and b._staged(0)[1].mesh.size == 2
    with pytest.raises(ValueError, match="requires a mesh"):
        lt.LDDMMAtlasBuilder(imgs, device="cpu", spatial_shard=True, **kw).initialize()
    with pytest.raises(ValueError, match="loader_mode"):
        lt.LDDMMAtlasBuilder(imgs, device="cpu", loader_mode="fork", **kw).initialize()
    b = lt.LDDMMAtlasBuilder(imgs, device="cpu", **kw)
    b.initialize()
    with pytest.raises(Exception, match="cannot be overwritten"):
        b.batch_size = 1


def test_builder_bfloat16_images_and_lddmm_atlas(rng):
    """``image_dtype="bfloat16"`` stages the images in bfloat16 and the
    loss computes in the builder's dtype: the same as a float32 run on the
    images rounded to bfloat16.  ``lddmm_atlas`` returns the builder's
    state."""
    imgs = synth_images(4, 12, 2).astype(np.float32)
    kw = dict(BUILDER_BASE, dtype=np.float32, metric=lt.FluidMetric([0.01, 0.0, 0.1]),
              device="cpu")
    b = lt.LDDMMAtlasBuilder(list(imgs), image_dtype="bfloat16", **kw)
    b.initialize()
    I0 = b.I.clone()
    assert b._staged(0)[0].dtype == torch.bfloat16
    b.run()
    rounded = t(imgs).to(torch.bfloat16).to(torch.float32).numpy()
    I, ms, el, er, il, ir = lt.lddmm_atlas(list(rounded), I0=I0.numpy(), **kw)
    assert I.dtype == torch.float32 and len(il) == 4 and len(ms) == 2
    assert torch.equal(I, b.I)
    assert (el, er, il, ir) == (b.epoch_losses, b.epoch_reg_terms, b.iter_losses,
                                b.iter_reg_terms)
