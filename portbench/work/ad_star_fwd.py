"""(bytes, float32 operations) of K1, Ad*: read phi, m0; write out and mw
(under autograd, as in the step). A frozen copy of ``chip_smoke.work``
(commit 7d81de2)."""
from __future__ import annotations

from portbench.work._counts import JAC_OPS, shapes, warp_ops


def work(cfg):
    N, V, _ = shapes(cfg)
    f3 = 4 * 3 * N * V  # one 3-channel field
    return 4 * f3, N * V * (warp_ops(3) + JAC_OPS + 6)
