"""(bytes, float32 operations) of K11, the 2D compose: read phi, v; write
out; per pixel s*v, the warp, the sums and the flag's half.
``chip_smoke.work``'s ``compose2d_fwd`` at the configuration's batch and
grid."""
from __future__ import annotations

from portbench.work._counts import COMPOSE2, FLAG2, shapes


def work(cfg):
    N, V, _ = shapes(cfg)
    f2 = 4 * 2 * N * V  # one 2-channel 2D field
    return 3 * f2, N * V * (COMPOSE2 + FLAG2 // 2)
