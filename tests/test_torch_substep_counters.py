"""The shooting's per-substep span, the counter of the fluid solve's
route, and the launches of the 2D per-substep kernels and of the 2D warp
(``kernels.launch_counts()``), on the CPU:

* ``lt.substep``: one span a substep of the per-substep loop
  (``lddmm._expmap_fast_flagged``), 4 a shoot of 5 steps, each inside the
  shoot's ``lt.shoot``, in 3D and in 2D with ``beta != 0``, with and
  without checkpoints; none on the 2D ``beta == 0`` whole shoot (K8);
* ``fluid.route.<route>``: one count a ``fluid_operator`` call, under the
  route that :func:`ops.fluid.fluid_route` names, for each route;
* K10-K13's launches: 4 of each through a 2D atlas step
  with ``beta != 0``, and 5 solves on the ``"rfftn"`` route, with the
  kernels' C entry points replaced by their plain versions (the wrappers'
  Python, routes and allocations run as on the card); none in a step with
  ``beta == 0``;
* K17's and K18's launches: 1 and 1 through a 2D atlas step (the atlas
  warp K17 and its backward K18, the same plain entry points), with and
  without ``beta``; none in a 3D step; and ``interp_auto``'s 2D unit tier
  keeping CPU tensors, and on a card other dtypes than float32, on the
  plain stencil.
"""
import ctypes
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import lddmm, profiling
from lagomorph_tpu_torch.ops import fluid, kernels, sampling
from lagomorph_tpu_torch.ops.interp import interp_auto
from lagomorph_tpu_torch.ops.kernels import _build, epdiff2d, warp2d

torch.set_num_threads(2)

BETA = (0.1, 0.05, 0.01)
FLAT = (0.1, 0.0, 0.01)
PER_SUBSTEP = ("ad_star2d_fwd", "compose2d_fwd", "ad_star2d_bwd", "compose2d_bwd")  # K10-K13


def _momenta(shape, batch, params, vmax, seed, dtype=torch.float64):
    """Seeded momenta whose velocities peak at ``vmax`` voxels."""
    g = torch.Generator().manual_seed(seed)
    m = torch.randn((batch, len(shape)) + shape, generator=g, dtype=torch.float64)
    v = lt.FluidMetric(params).sharp(m)
    return (m * (vmax / float(v.norm(dim=1).max()))).to(dtype)


def _spans(prof, tmp_path):
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("checkpoints", [False, True])
@pytest.mark.parametrize("shape,params", [((12, 12, 12), FLAT), ((24, 20), BETA)],
                         ids=["3d", "2d_beta"])
def test_substep_spans_nest_in_the_shoot(shape, params, checkpoints, tmp_path):
    m = _momenta(shape, 2, params, 0.5, seed=1).requires_grad_(True)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        h = lddmm.expmap(lt.FluidMetric(params), m, num_steps=5, checkpoints=checkpoints)
    counts = profiling.counters()
    assert counts["lt.substep"] == 4 and counts["lt.shoot"] == 1
    assert "lt.shoot.general" not in counts
    spans = _spans(prof, tmp_path)
    (shoot,) = [s for s in spans if s[0] == "lt.shoot"]
    subs = [s for s in spans if s[0] == "lt.substep"]
    assert len(subs) == 4
    assert all(shoot[1] <= s[1] and s[2] <= shoot[2] for s in subs)
    assert all(a[2] <= b[1] for a, b in zip(subs, subs[1:]))  # one after another
    profiling.reset_counters()
    torch.autograd.grad(h.sum(), m)
    # the backward opens no span; a checkpointed substep is recomputed there
    assert "lt.substep" not in profiling.counters()


def test_no_substep_span_on_the_2d_whole_shoot():
    m = _momenta((24, 20), 2, FLAT, 0.5, seed=2)
    profiling.reset_counters()
    lddmm.expmap(lt.FluidMetric(FLAT), m, num_steps=5)
    counts = profiling.counters()
    assert counts["lt.shoot"] == 1 and "lt.substep" not in counts


@pytest.fixture
def selectors():
    prev = (fluid.set_fluid_dft("auto"), fluid.set_fluid_packing("auto"),
            fluid.set_fluid_fft_kernel("auto"), fluid.set_fluid_mxu_whole(False))
    yield
    fluid.set_fluid_dft(prev[0])
    fluid.set_fluid_packing(prev[1])
    fluid.set_fluid_fft_kernel(prev[2])
    fluid.set_fluid_mxu_whole(prev[3])


# route: (selectors (dft, packing, fft kernel, whole), field shape, params)
ROUTES = {
    "rfftn": (("auto", "auto", "auto", False), (2, 2, 8, 6), BETA),
    "fluid_flat": (("auto", "auto", "auto", False), (2, 3, 4, 4, 4), FLAT),
    "fluid_radix": (("auto", "auto", "radix", False), (2, 3, 4, 4, 4), FLAT),
    "fluid_whole": (("auto", "auto", "auto", True), (2, 3, 4, 4, 4), FLAT),
    "packed": (("auto", True, False, False), (3, 2, 8, 6), FLAT),
    "batch": (("auto", True, "auto", False), (3, 2, 8, 6), BETA),
    "dft": ((True, "auto", "auto", False), (2, 3, 4, 6, 4), BETA),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_counter_counts_each_call(selectors, route):
    (dft, packing, kernel, whole), shape, params = ROUTES[route]
    fluid.set_fluid_dft(dft)
    fluid.set_fluid_packing(packing)
    fluid.set_fluid_fft_kernel(kernel)
    fluid.set_fluid_mxu_whole(whole)
    assert fluid.fluid_route(shape, params) == route
    x = torch.randn(shape, dtype=torch.float64)
    metric = lt.FluidMetric(params)
    profiling.reset_counters()
    v = metric.sharp(x)
    fluid.fluid_operator(v, params, inverse=False)
    assert profiling.counters() == {f"fluid.route.{route}": 2}


def _view(ptr, shape):
    """The float32 tensor of ``shape`` at host address ``ptr``."""
    n = int(np.prod(shape))
    return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))
                            ).view(shape)


def _put(ptr, t):
    t = t.contiguous()
    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


def _plain_entry_points(name, *args):
    """K10-K13's C entry points, computed by their plain versions on the
    host tensors at the pointers the wrappers pass."""
    if name == "lagomorph_ad_star2d_fwd":
        p, m0, out, mw, flag, N, Nm, H, W, _march, _stream = args
        r = epdiff2d.ad_star2d_plain(_view(p, (N, 2, H, W)), _view(m0, (Nm, 2, H, W)), True)
        _put(out, r[0])
        if mw is not None:
            _put(mw, r[2])
        _put(flag, r[1].to(torch.int32))
    elif name == "lagomorph_compose2d_fwd":
        p, v, s, out, flag, N, H, W, _march, _stream = args
        r = epdiff2d.compose2d_plain(_view(p, (N, 2, H, W)), _view(v, (N, 2, H, W)), s)
        _put(out, r[0])
        _put(flag, r[1].to(torch.int32))
    elif name == "lagomorph_ad_star2d_bwd":
        p, m0, g, mw, _d_mw, d_p, d_m0, N, Nm, H, W, _tile, _stream = args
        f = (N, 2, H, W)
        r = epdiff2d.ad_star2d_bwd_plain(_view(p, f), _view(m0, (Nm, 2, H, W)), _view(g, f),
                                         _view(mw, f))
        _put(d_p, r[0])
        _put(d_m0, r[1])
    elif name == "lagomorph_compose2d_bwd":
        p, v, s, g, d_p, d_v, N, H, W, _stream = args
        f = (N, 2, H, W)
        r = epdiff2d.compose2d_bwd_plain(_view(p, f), _view(v, f), s, _view(g, f))
        _put(d_p, r[0])
        _put(d_v, r[1])
    elif name == "lagomorph_warp2d_fwd":
        I, p, out, N, NI, C, H, W, _stream = args
        _put(out, warp2d.sample_displacement_unit_plain(_view(I, (NI, C, H, W)),
                                                        _view(p, (N, 2, H, W))))
    elif name == "lagomorph_warp2d_bwd":
        I, p, g, dI, dd, N, NI, C, H, W, _stream = args
        r = warp2d.sample_displacement_unit_bwd_plain(
            _view(I, (NI, C, H, W)), _view(p, (N, 2, H, W)), _view(g, (N, C, H, W)))
        _put(dI, r[0])
        _put(dd, r[1])
    else:
        raise AssertionError(f"no other entry point runs here: {name}")


@pytest.fixture
def plain_launches(monkeypatch):
    """The 2D per-substep and warp wrappers launch on float32 CPU tensors,
    as on the card, through their ``_launch*`` functions, whose entry
    points run the plain versions."""
    for mod in (epdiff2d, warp2d):
        monkeypatch.setattr(mod, "use_kernel",
                            lambda t: t.dtype == torch.float32 and not kernels._PLAIN.get())
        monkeypatch.setattr(mod, "check_cuda_f32", lambda _name, *_ts: None)
        monkeypatch.setattr(mod, "stream_of", lambda _t: None)
    monkeypatch.setattr(_build, "call", _plain_entry_points)


def _step(params):
    return lt.make_lddmm_atlas_step(lt.FluidMetric(params), reg_weight=0.1,
                                    learning_rate_pose=1e-6, integration_steps=5)


def _inputs(shape, params, seed):
    g = torch.Generator().manual_seed(seed)
    m = _momenta(shape, 2, params, 0.5, seed, dtype=torch.float32)
    I = torch.randn((1, 1) + shape, generator=g)
    img = torch.randn((2, 1) + shape, generator=g)
    return I, m, img


def test_2d_beta_step_counts_each_launch(plain_launches):
    I, m, img = _inputs((12, 10), BETA, 3)
    step = _step(BETA)
    for _ in range(2):
        kernels.reset_launches()
        profiling.reset_counters()
        got = step(I, m, img)
        counts = profiling.counters()
        assert {k: kernels.launch_counts()[k] for k in PER_SUBSTEP} == dict.fromkeys(PER_SUBSTEP, 4)
        # v0 and the 4 substeps; the backward differentiates torch.fft itself
        assert {k: v for k, v in counts.items() if k.startswith("fluid.route.")} == {
            "fluid.route.rfftn": 5}
        assert counts["lt.substep"] == 4 and "lt.shoot.general" not in counts
        m = got[0]
    with kernels.plain_versions():
        kernels.reset_launches()
        ref = step(I, m, img)
        assert not any(kernels.launch_counts()[k] for k in PER_SUBSTEP)
    got = step(I, m, img)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7 * float(b.abs().max()))


def test_2d_flat_step_launches_no_per_substep_kernel(plain_launches):
    I, m, img = _inputs((12, 10), FLAT, 4)
    kernels.reset_launches()
    profiling.reset_counters()
    _step(FLAT)(I, m, img)
    counts = profiling.counters()
    assert not any(kernels.launch_counts()[k] for k in PER_SUBSTEP)
    assert "lt.substep" not in counts
    assert counts["fluid.route.rfftn"] == 1  # v0; K8 solves its substeps itself


WARP_COUNTS = {"warp2d_fwd": 1, "warp2d_bwd": 1}


def _warp_counts():
    """K17's and K18's launches, those that are not 0."""
    return {k: n for k, n in kernels.launch_counts().items() if k.startswith("warp2d_") and n}


@pytest.mark.parametrize("params", [FLAT, BETA], ids=["flat", "beta"])
def test_2d_step_counts_one_warp_launch_each_way(plain_launches, params):
    """A 2D atlas step warps the atlas once through K17 and takes its
    gradient once through K18 (their ``launches`` 1 and 1), with ``beta`` 0 (K8/K9 plain here) and not
    (K10-K13); under ``plain_versions`` none, and the same step."""
    I, m, img = _inputs((12, 10), params, 5)
    step = _step(params)
    for _ in range(2):
        kernels.reset_launches()
        got = step(I, m, img)
        assert _warp_counts() == WARP_COUNTS
    with kernels.plain_versions():
        kernels.reset_launches()
        ref = step(I, m, img)
        assert _warp_counts() == {}
    for a, b in zip(got[:3], ref[:3]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7 * float(b.abs().max()))


def test_3d_step_counts_no_warp2d_launch(plain_launches):
    """The 3D atlas step's warp is K4's (plain here): no K17 or K18."""
    I, m, img = _inputs((6, 5, 4), FLAT, 6)
    kernels.reset_launches()
    profiling.reset_counters()
    _step(FLAT)(I, m, img)
    assert _warp_counts() == {} and profiling.counters()["lt.warp"] == 1


def test_interp_auto_2d_keeps_cpu_and_other_dtypes_plain(request):
    """``interp_auto``'s 2D unit tier: CPU tensors (float32 and bfloat16)
    take the plain stencil, no launch and its values bit for bit; with the
    card's dtype gate (the ``plain_launches`` wrappers), a float32 field
    launches K17 once and a bfloat16 one (the control's image dtype) or a
    float64 one stays on the plain stencil."""
    g = torch.Generator().manual_seed(7)
    d = torch.rand((2, 2, 9, 11), generator=g) * 1.98 - 0.99
    I = torch.randn((1, 1, 9, 11), generator=g)
    kernels.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        got = interp_auto(I.to(dtype), d.to(dtype))
        assert got.dtype == dtype
        assert torch.equal(got, sampling.sample_displacement_unit(I.to(dtype), d.to(dtype)))
    assert _warp_counts() == {}
    request.getfixturevalue("plain_launches")
    assert torch.equal(interp_auto(I, d), sampling.sample_displacement_unit(I, d))
    assert _warp_counts() == {"warp2d_fwd": 1}
    for dtype in (torch.bfloat16, torch.float64):
        got = interp_auto(I.to(dtype), d.to(dtype))
        assert torch.equal(got, sampling.sample_displacement_unit(I.to(dtype), d.to(dtype)))
    assert _warp_counts() == {"warp2d_fwd": 1}
