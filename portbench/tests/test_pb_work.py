"""The frozen work arithmetic against counts by hand at small shapes: a
batch of 2 on a 4^3 grid (V = 64) and 2D on 4^2 (V = 16), 5 integration
steps (4 substeps after the peeled first)."""
import pytest

from portbench import manifest
from portbench.work._counts import bound_ms

CFG3 = {"shape": [4, 4, 4], "batch_size": 2, "lddmm_integration_steps": 5}
CFG2 = {"shape": [4, 4], "batch_size": 2, "lddmm_integration_steps": 5}
N, V, V2 = 2, 64, 16
F3 = 4 * 3 * N * V  # bytes of a 3-channel field: 1536
F2 = 4 * 2 * N * V2  # of a 2-channel 2D field: 256
# per voxel: 3 axes of weights (27) and 27 tap weights (36), then
# per channel 27 products and 26 sums (warp) or 27 products and sums
# (transpose); the weight gradient: 27 + 9 + 27 + 27 (2C - 1 + 9)
WARP1, WARP3 = 27 + 36 + 53, 27 + 36 + 159
TRANS1, TRANS3 = 27 + 36 + 54, 27 + 36 + 162
WGRAD1, WGRAD3 = 27 + 9 + 27 + 27 * 10, 27 + 9 + 27 + 27 * 14

HAND = [
    ("warp_unit_fwd", CFG3, F3 + 4 * V + 4 * N * V, N * V * WARP1),
    ("warp_unit_bwd", CFG3, 2 * F3 + 4 * N * V + 8 * V, N * V * (TRANS1 + WGRAD1)),
    ("ad_star_fwd", CFG3, 4 * F3, N * V * (WARP3 + 36 + 6)),
    ("compose_fwd", CFG3, 3 * F3, N * V * (WARP3 + 12)),
    ("ad_star_bwd", CFG3, 6 * F3, N * V * (36 + WGRAD3 + 51 + 3 + TRANS3)),
    ("compose_bwd", CFG3, 5 * F3, N * V * (TRANS3 + WGRAD3 + 15)),
    # 3 packed pairs of 64 points: 2 FFTs (5 V log2 V each) and 2 V a pair
    ("fluid_solve", CFG3, 4 * (2 * 2 * 3 * V + V), 3 * (10 * V * 6 + 2 * V)),
    # 2 pairs of 16 points in 2D
    ("fluid_solve", CFG2, 4 * (2 * 2 * 2 * V2 + V2), 2 * (10 * V2 * 4 + 2 * V2)),
    # K8: 4 substeps; per pixel Ad* 75, compose 65, flag 8; a 2D solve each
    ("shoot2d_fwd", CFG2, 15 * F2 + 4 * V2, 4 * N * (V2 * (75 + 65 + 8) + 10 * V2 * 4 + 2 * V2)),
    ("shoot2d_bwd", CFG2, 16 * F2 + 4 * V2,
     4 * N * (V2 * ((63 + 117 + 36) + (63 + 117 + 4)) + 10 * V2 * 4 + 2 * V2)),
    ("warp2d_fwd", CFG2, 4 * (2 * N * V2 + V2 + N * V2), N * V2 * 44),
    ("warp2d_bwd", CFG2, 4 * (4 * N * V2 + N * V2 + 2 * V2), N * V2 * (45 + 36 + 63)),
]


@pytest.mark.parametrize("name,cfg,nbytes,ops", HAND, ids=[h[0] + str(len(h[1]["shape"]))
                                                           for h in HAND])
def test_work_by_hand(name, cfg, nbytes, ops):
    assert manifest.work(name)(cfg) == (nbytes, ops)


def test_bound_takes_the_larger():
    assert bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert bound_ms(0, 67e9) == pytest.approx(1.0)
    assert bound_ms(3.35e9, 2 * 67e9) == pytest.approx(2.0)
