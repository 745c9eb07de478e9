"""The float64 reference against the port's plain path (its CPU versions)
in float64, at 16^3 and 32^2: the fluid solves, the warp, Ad*, the
shooting, and the atlas step's loss and gradients.  The test imports the
port; the reference does not."""
import numpy as np
import pytest
import torch

import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import adjrep, lddmm
from lagomorph_tpu_torch.ops.interp import interp as port_interp
from portbench.inputs import Inputs
from portbench.reference import atlas as ref

torch.set_num_threads(2)
F64 = torch.float64
TOL = 1e-10  # float64, relative to the largest value: FFTs and sums round differently
PARAMS = (0.1, 0.0, 0.01)
SHAPES = [(16, 16, 16), (32, 32)]


def close(a, b, tol=TOL):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= tol * max(scale, 1e-300), (
        float((a - b).abs().max()), scale)


def fields(shape, seed, scale=1.0, batch=2):
    g = torch.Generator().manual_seed(seed)
    return scale * torch.randn((batch, len(shape)) + shape, generator=g, dtype=F64)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("params", [PARAMS, (0.1, 0.05, 0.01), (0.2, 0.1, 0.0)])
def test_fluid(shape, params):
    m = fields(shape, 1)
    mine = ref.FluidMetric(params, shape, "cpu")
    port = lt.FluidMetric(params)
    close(mine.sharp(m), port.sharp(m))
    close(mine.flat(m), port.flat(m))


@pytest.mark.parametrize("shape", SHAPES)
def test_interp_and_ad_star(shape):
    u = fields(shape, 2, scale=3.0)  # well beyond the grid's edges in places
    I = fields(shape, 3)[:1, :1]
    close(ref.interp(I, u), port_interp(I, u))
    m = fields(shape, 4)
    phi = fields(shape, 5, scale=0.4)
    close(ref.ad_star(phi, m), adjrep.Ad_star(phi, m, mode="general"))


def _inputs(shape, batch):
    cfg = {"shape": list(shape), "batch_size": batch, "fluid_alpha": PARAMS[0],
           "fluid_beta": PARAMS[1], "fluid_gamma": PARAMS[2]}
    traffic = {"subjects": batch, "offset": 2.0, "bumps": 4, "vmax": 0.5}
    return Inputs(cfg, traffic, 2**33 + 7, 0, 1, torch.device("cpu"))


@pytest.mark.parametrize("shape", SHAPES)
def test_shooting(shape):
    inp = _inputs(shape, 2)
    m = inp.momenta([0, 1]).to(F64)
    metric = lt.FluidMetric(PARAMS)
    mine = ref.FluidMetric(PARAMS, shape, "cpu")
    close(ref.shoot(mine, m, mine.sharp(m), 5), lddmm.expmap(metric, m, num_steps=5))


@pytest.mark.parametrize("shape", SHAPES)
def test_atlas_step(shape):
    """The port's step (its loss, ``m - lr dL/dm`` and ``dL/dI``) against the
    reference's autograd in float64, on the benchmark's inputs."""
    inp = _inputs(shape, 2)
    m, img = inp.momenta([0, 1]).to(F64), inp.images([0, 1]).to(F64)
    I = inp.atlas().to(F64)
    reg, lr = 0.1, 1e-3
    step = lddmm.make_lddmm_atlas_step(lt.FluidMetric(PARAMS), reg_weight=reg,
                                       learning_rate_pose=lr, integration_steps=5)
    m_new, gI, loss, _ = step(I, m, img)
    numel = 2 * float(np.prod(shape))
    mine = ref.FluidMetric(PARAMS, shape, "cpu")
    sq, vm, gm = ref.momenta_grad(mine, I, m, img, 5, reg, numel)
    close(loss, (sq + reg * vm) / numel)
    close(m_new - m, -lr * gm)
    sq2, vm2, g_sq = ref.atlas_grad_sq(mine, I, m, img, 5)
    close(gI, g_sq / numel)
    close(sq2, sq)
    close(vm2, vm)


def test_reference_imports_nothing_of_the_port():
    import subprocess
    import sys

    code = ("import sys; import portbench.reference.atlas, portbench.inputs; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('lagomorph_tpu_torch', 'lagomorph_tpu', 'jax', 'jaxlib', 'flax')); "
            "assert not bad, bad; print('clean')")
    from conftest import ROOT

    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr
