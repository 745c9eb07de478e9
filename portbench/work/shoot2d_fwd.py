"""(bytes, float32 operations) of K8, the 2D whole shoot of T substeps: read
phi0, m0, Mn; write phi_T and the 3T stash fields; a packed 2D solve per
subject and substep. A frozen copy of ``chip_smoke.work`` (commit
7d81de2)."""
from __future__ import annotations

import math

from portbench.work._counts import AD2, COMPOSE2, FLAG2, shapes


def work(cfg):
    N, V, T = shapes(cfg)
    f2 = 4 * 2 * N * V  # one 2-channel 2D field
    mn = 4 * V  # the multiplier
    fft2 = 2 * 5 * V * math.log2(V) + 2 * V  # one packed 2D solve
    return (3 + 3 * T) * f2 + mn, T * N * (V * (AD2 + COMPOSE2 + FLAG2) + fft2)
