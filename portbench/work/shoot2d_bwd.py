"""(bytes, float32 operations) of K9, its backward: read m0, g, Mn and the 3T
stash; write d_phi0, d_m0. A frozen copy of ``chip_smoke.work`` (commit
7d81de2)."""
from __future__ import annotations

import math

from portbench.work._counts import ADSTAR2_BWD, COMPOSE2_BWD, shapes


def work(cfg):
    N, V, T = shapes(cfg)
    f2 = 4 * 2 * N * V  # one 2-channel 2D field
    mn = 4 * V  # the multiplier
    fft2 = 2 * 5 * V * math.log2(V) + 2 * V  # one packed 2D solve
    return (4 + 3 * T) * f2 + mn, T * N * (V * (ADSTAR2_BWD + COMPOSE2_BWD) + fft2)
