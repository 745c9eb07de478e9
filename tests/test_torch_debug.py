"""``set_debug_mode`` and ``profiling`` of the port, on the CPU, beside the
JAX package's:

* under both packages' debug modes the same NaN-bearing momentum through
  ``expmap`` raises ``FloatingPointError`` (2D: K8's wrapper; 3D: K3's),
  and with the modes off both return NaN; a finite atlas step is
  ``torch.equal`` with the mode on and off;
* every kernel wrapper's plain version raises naming its kernel on a
  non-finite output, and only in the debug mode;
* ``_build.call`` synchronises the device after a launch in the debug
  mode, and only then, and raises a launch's error under its name (a
  stand-in library and ``torch.cuda.synchronize`` here);
* ``profiling``: ``device_time``, ``Timer`` and ``trace``.
"""
import contextlib
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lagomorph_tpu as lm
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import lddmm as tlddmm
from lagomorph_tpu_torch import profiling
from lagomorph_tpu_torch.ops import fluid as tfluid
from lagomorph_tpu_torch.ops import kernels
from lagomorph_tpu_torch.ops.kernels import _build, epdiff2d, epdiff_unit, warp2d, warp_unit

torch.set_num_threads(2)
PARAMS = (0.1, 0.0, 0.01)


@pytest.fixture
def modes():
    """Both packages' debug modes, restored after the test (they are
    global, and a file's tests share a process)."""
    prev_jax, prev_port = jax.config.jax_debug_nans, kernels.debug_mode()
    yield
    jax.config.update("jax_debug_nans", prev_jax)
    kernels.set_debug_mode(prev_port)


def nan_momenta(rng, shape):
    m = rng.standard_normal(shape) * 0.01
    m[(0, 0) + (2,) * (len(shape) - 2)] = np.nan
    return m


@pytest.mark.parametrize("shape,kernel", [((2, 2, 12, 10), "shoot2d_fwd"),
                                          ((2, 3, 8, 6, 10), "fluid_flat")])
def test_expmap_nan_raises_under_both_debug_modes(rng, modes, shape, kernel):
    m = nan_momenta(rng, shape)
    for on in (True, False):
        lm.set_debug_mode(on)
        lt.set_debug_mode(on)
        ctx = pytest.raises(FloatingPointError) if on else contextlib.nullcontext()
        with ctx:
            ref = lm.expmap(lm.FluidMetric(PARAMS), jnp.asarray(m), num_steps=4)
        with ctx as e:
            got = lt.expmap(lt.FluidMetric(PARAMS), torch.from_numpy(m), num_steps=4)
        if on:
            assert kernel in str(e.value)
        else:
            assert np.isnan(np.asarray(ref)).any() and bool(got.isnan().any())


def test_debug_mode_leaves_a_finite_step_unchanged(rng, modes):
    """One 3D atlas step (float32) with the mode on is ``torch.equal`` to the
    step with it off: loss, momenta, atlas gradient."""
    shape = (2, 3, 8, 6, 10)
    m = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 1e-3)
    I = torch.from_numpy(rng.standard_normal((1, 1) + shape[2:]).astype(np.float32))
    img = torch.from_numpy(rng.standard_normal((2, 1) + shape[2:]).astype(np.float32))
    step = tlddmm.make_lddmm_atlas_step(lt.FluidMetric(PARAMS), reg_weight=0.1,
                                        learning_rate_pose=1e-2, integration_steps=4)
    out = {}
    for on in (False, True):
        lt.set_debug_mode(on)
        out[on] = step(I, m, img)
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))


@contextlib.contextmanager
def selected(setter, value):
    prev = setter(value)
    try:
        yield
    finally:
        setter(prev)


def _sharp3d(rng, setter=None, value=None):
    m = torch.from_numpy(nan_momenta(rng, (1, 3, 8, 8, 8)))
    with selected(setter, value) if setter else contextlib.nullcontext():
        return lt.FluidMetric(PARAMS).sharp(m)


NAN = float("nan")
WRAPPERS = {
    "warp_unit_fwd": lambda rng: warp_unit.sample_displacement_unit(
        torch.full((1, 1, 4, 5, 6), NAN), torch.zeros(1, 3, 4, 5, 6)),
    "ad_star_fwd": lambda rng: epdiff_unit.ad_star(
        torch.zeros(1, 3, 4, 5, 6), torch.full((1, 3, 4, 5, 6), NAN)),
    "compose_fwd": lambda rng: epdiff_unit.compose(
        torch.full((1, 3, 4, 5, 6), NAN), torch.zeros(1, 3, 4, 5, 6), 0.1),
    "warp2d_fwd": lambda rng: warp2d.sample_displacement_unit(
        torch.full((1, 1, 6, 7), NAN), torch.zeros(1, 2, 6, 7)),
    "ad_star2d_fwd": lambda rng: epdiff2d.ad_star2d(
        torch.zeros(1, 2, 6, 7), torch.full((1, 2, 6, 7), NAN)),
    "compose2d_fwd": lambda rng: epdiff2d.compose2d(
        torch.full((1, 2, 6, 7), NAN), torch.zeros(1, 2, 6, 7), 0.1),
    "fluid_flat": lambda rng: _sharp3d(rng),
    "fluid_whole": lambda rng: _sharp3d(rng, tfluid.set_fluid_mxu_whole, True),
    "fluid_radix_zy": lambda rng: _sharp3d(rng, tfluid.set_fluid_fft_kernel, "radix"),
    "shoot2d_fwd": lambda rng: lt.expmap(lt.FluidMetric(PARAMS),
                                         torch.from_numpy(nan_momenta(rng, (1, 2, 8, 8))),
                                         num_steps=3),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrappers_check_outputs_in_debug_mode(rng, modes, name):
    """A non-finite output of a kernel's wrapper (its plain version, on the
    CPU) raises ``FloatingPointError`` naming the kernel in the debug mode,
    and passes without it."""
    assert name in kernels.KERNELS
    kernels.set_debug_mode(False)
    out = WRAPPERS[name](rng)
    first = out[0] if isinstance(out, tuple) else out
    assert not bool(torch.isfinite(first).all())
    kernels.set_debug_mode(True)
    with pytest.raises(FloatingPointError, match=name):
        WRAPPERS[name](rng)


class _Library:
    """A stand-in for the kernel library: one entry point that reports
    success, and the error string."""

    def lagomorph_warp_unit_fwd(self, *args):
        return 0

    def lagomorph_error_string(self, err):
        return b"stand-in"


def test_build_call_synchronises_in_debug_mode(modes, monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: _Library())
    syncs = []

    def sync(device=None):
        syncs.append(device)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    kernels.set_debug_mode(False)
    _build.call("lagomorph_warp_unit_fwd", 1, 2)
    assert not syncs  # nothing is added to a launch while the mode is off
    kernels.set_debug_mode(True)
    with pytest.raises(RuntimeError, match="lagomorph_warp_unit_fwd.*illegal memory access"):
        _build.call("lagomorph_warp_unit_fwd", 1, 2)
    assert len(syncs) == 1


def test_set_debug_mode_is_global(modes):
    lt.set_debug_mode()
    assert kernels.debug_mode() is True
    lt.set_debug_mode(False)
    assert kernels.debug_mode() is False


def test_device_time_and_timer():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return (x * scale, [x.sum()])

    t = profiling.device_time(fn, torch.ones(64, 64), warmup=2, iters=5, scale=2.0)
    assert t >= 0 and len(calls) == 7
    tm = profiling.Timer()
    for _ in range(3):
        with tm("a"):
            pass
    with tm("b"):
        pass
    s = tm.summary()
    assert s["a"]["count"] == 3 and s["b"]["count"] == 1
    assert s["a"]["mean_s"] == pytest.approx(s["a"]["total_s"] / 3)


def test_trace_writes_a_chrome_trace(tmp_path, rng):
    """``trace(logdir)`` around a fluid solve writes one Chrome trace into
    ``logdir`` holding the solve's operators."""
    logdir = str(tmp_path / "trace")
    m = torch.from_numpy(rng.standard_normal((1, 3, 8, 8, 8)))
    with profiling.trace(logdir):
        lt.FluidMetric(PARAMS).sharp(m)
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") and "fft" in n for n in names), sorted(names)[:20]
