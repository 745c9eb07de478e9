"""(bytes, float32 operations) of one fluid solve with ``beta != 0``, the
``"rfftn"`` route: read the ``(N, d, *spatial)`` field and the ``d (d + 1)
/ 2`` entries of the half-spectrum multiplier, write the result; ``N d``
real FFTs of ``V`` points each way (2.5 V log2 V each, half a complex
FFT's 5 V log2 V) and, per half-spectrum frequency of each subject, the
``d x d`` product of real entries and complex spectra (``2 d^2``
products and ``2 d (d - 1)`` sums)."""
from __future__ import annotations

import math

from portbench.work._counts import shapes


def work(cfg):
    N, V, _ = shapes(cfg)
    d = len(cfg["shape"])
    half = math.prod(cfg["shape"][:-1]) * (cfg["shape"][-1] // 2 + 1)
    nbytes = 4 * (2 * N * d * V + d * (d + 1) // 2 * half)
    return nbytes, 2 * N * d * 2.5 * V * math.log2(V) + N * half * (4 * d * d - 2 * d)
