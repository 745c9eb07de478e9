"""(bytes, float32 operations) of K7, compose's backward: read phi, v, g;
write d_phi, d_v. A frozen copy of ``chip_smoke.work`` (commit 7d81de2)."""
from __future__ import annotations

from portbench.work._counts import shapes, transpose_ops, weight_grad_ops


def work(cfg):
    N, V, _ = shapes(cfg)
    f3 = 4 * 3 * N * V  # one 3-channel field
    return 5 * f3, N * V * (3 + transpose_ops(3) + 3 + weight_grad_ops(3) + 9)
