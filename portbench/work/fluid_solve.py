"""(bytes, float32 operations) of one fluid solve of the batch's momenta or
velocities: the ``N * d`` component slabs packed in complex pairs, each
pair two FFTs of ``V`` points and the product with the multiplier (read x
and the multiplier, write y). ``chip_smoke.work``'s ``fluid_flat`` (commit
7d81de2) with ``F`` the pairs of the configuration's batch and dimension;
the 2D solves run ``torch.fft`` on the same arithmetic."""
from __future__ import annotations

import math

from portbench.work._counts import shapes


def work(cfg):
    N, V, _ = shapes(cfg)
    F = -(-N * len(cfg["shape"]) // 2)
    return 4 * (2 * 2 * F * V + V), F * (2 * 5 * V * math.log2(V) + 2 * V)
