"""Guards of the PyTorch port: it never imports jax; ``chip_smoke.py``
refuses to run without a CUDA card, before building anything; and on the
CPU, autograd through the plain versions of the atlas loss gives the JAX
package's gradients (the reference the backward kernels will be held to).
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

import lagomorph_tpu as lm
from lagomorph_tpu import lddmm as jlddmm
from lagomorph_tpu.ops import set_warp_mode
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import lddmm as tlddmm

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL = 1e-9  # float64, relative to max|grad|: FFT roundoff differs


def _run(args, **kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_never_imports_jax():
    r = _run(["-c", "import sys, lagomorph_tpu_torch, lagomorph_tpu_torch.convert, "
                    "lagomorph_tpu_torch.ops.kernels._build, "
                    "lagomorph_tpu_torch.ops.kernels.epdiff2d, "
                    "chip_smoke, profile_warp, profile_radix, profile_shoot2d, profile_epdiff2d; "
                    "assert 'jax' not in sys.modules, 'jax imported'; "
                    "assert 'lagomorph_tpu' not in sys.modules; print('clean')"])
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def test_chip_smoke_fails_without_a_card():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no CUDA device" in r.stderr
    assert "build:" not in r.stdout  # failed at the device check, before any build


def test_plain_loss_gradients_match_jax(rng):
    """d loss / d m and d loss / d I of the plain ``_lddmm_loss`` (torch
    autograd, float64) against ``jax.grad`` of the JAX ``_lddmm_loss``, with
    a batch-1 atlas and momenta in the unit regime (the port's hoisted path).

    The JAX side forces its exact "general" warp tier with its own
    ``set_warp_mode``: every tier computes the same function in its regime,
    and the forced tier compiles one branch where the automatic tiers
    compile every branch of each ``lax.cond`` (a third of the compile
    time)."""
    shape = (2, 3, 10, 8, 12)
    m = rng.standard_normal(shape)
    m *= 0.5 / float(lt.FluidMetric((0.1, 0.0, 0.01)).sharp(torch.from_numpy(m)).abs().max())
    I = rng.standard_normal((1, 1) + shape[2:])
    img = rng.standard_normal((shape[0], 1) + shape[2:])
    assert bool(tlddmm.shooting_regime_ok(lt.FluidMetric((0.1, 0.0, 0.01)),
                                          torch.from_numpy(m), num_steps=5))

    def jloss(m_, I_):
        return jlddmm._lddmm_loss(I_, m_, jnp.asarray(img), lm.FluidMetric((0.1, 0.0, 0.01)),
                                  0.1, 5, False)[0]

    # jit: one compile of the whole gradient is cheaper than op-by-op dispatch
    prev = set_warp_mode("general")
    try:
        jgm, jgI = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(m), jnp.asarray(I))
    finally:
        set_warp_mode(prev)
    tm = torch.from_numpy(m.copy()).requires_grad_(True)
    tI = torch.from_numpy(I.copy()).requires_grad_(True)
    loss, _ = tlddmm._lddmm_loss(tI, tm, torch.from_numpy(img), lt.FluidMetric((0.1, 0.0, 0.01)),
                                 0.1, 5)
    loss.backward()
    for ref, got in ((jgm, tm.grad), (jgI, tI.grad)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(ref).max()))
