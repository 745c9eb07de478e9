"""(bytes, float32 operations) of K12, the 2D Ad*'s backward: read phi, m0,
g, mw; write d_phi, d_m0; per pixel the transposed warp, the weight
gradient, d_mw and the divergence path. ``chip_smoke.work``'s
``ad_star2d_bwd`` at the configuration's batch and grid."""
from __future__ import annotations

from portbench.work._counts import ADSTAR2_BWD, shapes


def work(cfg):
    N, V, _ = shapes(cfg)
    f2 = 4 * 2 * N * V  # one 2-channel 2D field
    return 6 * f2, N * V * ADSTAR2_BWD
