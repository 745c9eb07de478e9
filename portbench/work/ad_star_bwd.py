"""(bytes, float32 operations) of K6, Ad*'s backward: read phi, m0, g, mw;
write d_phi, d_m0. A frozen copy of ``chip_smoke.work`` (commit 7d81de2)."""
from __future__ import annotations

from portbench.work._counts import DIV_OPS, JAC_OPS, shapes, transpose_ops, weight_grad_ops


def work(cfg):
    N, V, _ = shapes(cfg)
    f3 = 4 * 3 * N * V  # one 3-channel field
    return 6 * f3, N * V * (JAC_OPS + weight_grad_ops(3) + DIV_OPS + 3 + transpose_ops(3))
