"""(bytes, float32 operations) of K13, the 2D compose's backward: read phi,
v, g; write d_phi, d_v; per pixel the transposed warp, the weight gradient
and s*g + s*dd. ``chip_smoke.work``'s ``compose2d_bwd`` at the
configuration's batch and grid."""
from __future__ import annotations

from portbench.work._counts import COMPOSE2_BWD, shapes


def work(cfg):
    N, V, _ = shapes(cfg)
    f2 = 4 * 2 * N * V  # one 2-channel 2D field
    return 5 * f2, N * V * COMPOSE2_BWD
