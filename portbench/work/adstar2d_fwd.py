"""(bytes, float32 operations) of K10, the 2D Ad*: read phi, m0; write out
and mw (under autograd, as in the step); per pixel the warp, the Jacobian's
products and sums and the flag's half. ``chip_smoke.work``'s
``ad_star2d_fwd`` at the configuration's batch and grid."""
from __future__ import annotations

from portbench.work._counts import AD2, FLAG2, shapes


def work(cfg):
    N, V, _ = shapes(cfg)
    f2 = 4 * 2 * N * V  # one 2-channel 2D field
    return 4 * f2, N * V * (AD2 + FLAG2 // 2)
