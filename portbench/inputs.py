"""The benchmark's inputs, made from ``--seed`` on the device in a few
batched calls: the subjects, the starting atlas and the starting momenta.

The subjects follow ``profile_atlas.py``'s ``subjects`` (commit 7d81de2,
frozen here): a Gaussian blob of width ``res / 6 * (1 + 0.1 z)``, ``z``
standard normal, centred at ``(res - 1) / 2`` plus an offset drawn
uniformly in ``[-offset, offset]`` per axis, evaluated in float64 and kept
in float32.  The draws come from a ``torch.Generator`` seeded with the run's
seed instead of ``numpy.random.default_rng(0)``, and the blob is evaluated
as the product of its per-axis profiles.

The run resumes an atlas, as ``lddmm atlas --initial_atlas`` does: the atlas
is the blob of the mean width with no offset, and each subject's momenta are
``flat`` of a smooth velocity (``bumps`` Gaussians of width ``res / 8``,
random centres in the middle half of the grid and random directions),
scaled to a peak of ``vmax`` voxels, so that every shooting starts well
inside the unit regime of the fast path.

Every subject's draws depend only on the seed and its global index, so
each process of a data-parallel run makes its own subjects alike.  A
traffic's optional ``outliers`` (``{"every": k, "vmax": v}``) gives the
first subject of every ``k``-th minibatch of a process a peak of ``v``
voxels instead.  Images and momenta are made ``BLOCK`` subjects a call, so
that making them never holds more than a few fields of the device.
"""
from __future__ import annotations

import torch

from .reference.atlas import FluidMetric

BLOCK = 4  # subjects a call of the generator, and a block of the reference


def _generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    return g


def draws(seed, n, dim, offset, bumps, device):
    """Every subject's random draws, in one fixed order: blob offsets ``(n,
    dim)``, width factors ``(n,)``, bump centres ``(n, bumps, dim)`` as a
    fraction of the grid, bump directions ``(n, bumps, dim)``."""
    g = _generator(seed, device)
    f64 = dict(dtype=torch.float64, device=device, generator=g)
    off = (2 * torch.rand(n, dim, **f64) - 1) * offset
    width = 1 + 0.1 * torch.randn(n, **f64)
    centres = 0.25 + 0.5 * torch.rand(n, bumps, dim, **f64)
    dirs = torch.randn(n, bumps, dim, **f64)
    return off, width, centres, dirs


def _separable(profiles):
    """The outer product over axes of ``profiles`` (a list of ``(B, n_a)``
    tensors): ``(B, *n)``."""
    dim = len(profiles)
    out = None
    for a, p in enumerate(profiles):
        shape = [p.shape[0]] + [1] * dim
        shape[1 + a] = p.shape[1]
        p = p.reshape(shape)
        out = p if out is None else out * p
    return out


def blobs(res, dim, off, width, device):
    """``(B, 1, *[res] * dim)`` float32 blobs of the given offsets and width
    factors (``res / 6`` times the factor)."""
    x = torch.arange(res, dtype=torch.float64, device=device)
    c = (res - 1) / 2
    w = (res / 6 * width)[:, None]
    prof = [torch.exp(-((x[None] - c - off[:, a:a + 1]) ** 2) / (2 * w ** 2)) for a in range(dim)]
    return _separable(prof)[:, None].float()


def atlas(res, dim, device):
    """``(1, 1, *[res] * dim)``: the blob of the mean width, no offset."""
    z = torch.zeros(1, dim, dtype=torch.float64, device=device)
    return blobs(res, dim, z, torch.ones(1, dtype=torch.float64, device=device), device)


def momenta(metric, res, dim, centres, dirs, vmax):
    """``(B, dim, *[res] * dim)`` float32 momenta: ``metric.flat`` (the
    reference's, float64) of a sum of Gaussian bumps of width ``res / 8``
    whose peak speed is ``vmax`` voxels (a number, or ``(B,)`` one a
    subject)."""
    device = centres.device
    x = torch.arange(res, dtype=torch.float64, device=device)
    sigma = res / 8
    B, J = centres.shape[:2]
    v = 0
    for j in range(J):
        prof = [torch.exp(-((x[None] - res * centres[:, j, a:a + 1]) ** 2) / (2 * sigma ** 2))
                for a in range(dim)]
        v = v + dirs[:, j].reshape((B, dim) + (1,) * dim) * _separable(prof)[:, None]
    peak = v.norm(dim=1).flatten(1).amax(1).reshape((B,) + (1,) * (dim + 1))
    vmax = torch.as_tensor(vmax, dtype=torch.float64, device=device)
    return metric.flat(v * (vmax.reshape(-1, *[1] * (dim + 1)) / peak)).float()


class Inputs:
    """One process's inputs for a cell: its subjects' global indices (the
    interleaved ``rank, rank + world, ...``), their images and momenta by
    local minibatch, and the atlas; all made on ``device``."""

    def __init__(self, cfg, traffic, seed, rank, world, device):
        self.res, self.dim = int(cfg["shape"][0]), len(cfg["shape"])
        if list(cfg["shape"]) != [self.res] * self.dim:
            raise ValueError("the generator makes cubic (square) grids")
        self.n = int(traffic["subjects"]) * world
        self.batch = int(cfg["batch_size"])
        self.indices = list(range(rank, self.n, world))
        self.world = world
        self.device, self.traffic = device, traffic
        self.metric = FluidMetric(
            (cfg["fluid_alpha"], cfg["fluid_beta"], cfg["fluid_gamma"]), cfg["shape"], device)
        self._draws = draws(seed, self.n, self.dim, float(traffic["offset"]),
                            int(traffic["bumps"]), device)
        self.vmax = {}  # the outliers' peaks, by global index
        out = traffic.get("outliers")
        if out:
            for j, idx in enumerate(self.minibatches()):
                if j % int(out["every"]) == 0:
                    self.vmax[idx[0]] = float(out["vmax"])

    def minibatches(self):
        """``[[global index, ...], ...]``: this process's minibatches."""
        ix = self.indices
        return [ix[i:i + self.batch] for i in range(0, len(ix), self.batch)]

    def global_rows(self):
        """The real subjects of each iteration's global minibatch, over every
        process (the builder's iteration count is the longest shard's)."""
        shards = [len(range(r, self.n, self.world)) for r in range(self.world)]
        iters = max(-(-s // self.batch) for s in shards)
        return [sum(max(0, min(self.batch, s - j * self.batch)) for s in shards)
                for j in range(iters)]

    @staticmethod
    def blocks(idx):
        """``idx`` in runs of at most ``BLOCK`` subjects."""
        return [idx[i:i + BLOCK] for i in range(0, len(idx), BLOCK)]

    def images(self, idx):
        off, width, _, _ = self._draws
        idx = torch.as_tensor(idx, device=self.device)
        return blobs(self.res, self.dim, off[idx], width[idx], self.device)

    def momenta(self, idx):
        _, _, centres, dirs = self._draws
        vmax = [self.vmax.get(i, float(self.traffic["vmax"])) for i in idx]
        idx = torch.as_tensor(idx, device=self.device)
        return momenta(self.metric, self.res, self.dim, centres[idx], dirs[idx], vmax)

    def atlas(self):
        return atlas(self.res, self.dim, self.device)
