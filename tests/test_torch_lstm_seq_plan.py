"""``lstm_seq``'s launch plan (``ops.seq_plan``), on the CPU.

The plan is a pure function of B, H and the number of clusters the card
holds at once, so it is checked here without a card: every batch row in
exactly one tile of one cluster, never more clusters than are resident,
no cluster larger than the limit, and only (units, rows) cases the CUDA
source builds.
"""
import pytest

from repro_torch.kernels.lstm_seq import ops

# resident clusters by cluster size: an H100's counts at H = 256
# ({16: 7, 8: 15}), a card with room for more, one with no 16-CTA
# cluster, and a nearly full one
RESIDENT = [{16: 7, 8: 15}, {16: 8, 8: 16, 4: 33, 2: 66, 1: 132},
            {16: 0, 8: 15, 4: 30, 2: 60, 1: 120}, {16: 1, 8: 1, 4: 1, 2: 1,
                                                   1: 1}]
BS = [1, 2, 5, 31, 32, 33, 97, 130, 1000]
HS = [32, 64, 128, 160, 256]


def _resident_for(H, res):
    return {C: n for C, n in res.items() if C in (H // 16, H // 32)}


@pytest.mark.parametrize("res", RESIDENT)
@pytest.mark.parametrize("H", HS)
@pytest.mark.parametrize("B", BS)
def test_plan_covers_every_row_once_within_the_card(B, H, res):
    resident = _resident_for(H, res)
    if not any(resident.values()):
        with pytest.raises(ValueError, match="fits on the card"):
            ops.seq_plan(B, H, resident)
        return
    plan = ops.seq_plan(B, H, resident)
    assert plan.units in ops.MAX_ROWS
    assert 1 <= plan.rows <= ops.MAX_ROWS[plan.units]
    assert plan.cluster * plan.units == H
    assert 1 <= plan.clusters <= resident[plan.cluster]
    assert plan.cluster <= ops.MAX_CLUSTER
    rows = [b for tile in plan.tile_rows(B) for b in tile]
    assert sorted(rows) == list(range(B))
    assert all(plan.tile_rows(B))          # no cluster without a row


@pytest.mark.parametrize("H", [384, 512, 1024])
def test_plan_respects_the_cluster_size_limit(H):
    """Clusters past 16 CTAs are never planned, even where the card
    reports room for them: 512 takes 16 CTAs of 32 units, 1024 none."""
    res = {64: 2, 32: 4, 24: 5, 16: 7, 12: 10}
    if H // 32 > ops.MAX_CLUSTER:
        with pytest.raises(ValueError, match="fits on the card"):
            ops.seq_plan(32, H, res)
        return
    plan = ops.seq_plan(32, H, res)
    assert plan.cluster <= ops.MAX_CLUSTER
    assert plan.cluster * plan.units == H
    assert plan.clusters <= res[plan.cluster]


def test_plan_at_the_serving_shape_fits_one_wave():
    """B = 32 rows at H = 256 on an H100 (7 clusters of 16, 15 of 8):
    all tiles in one wave, on most of the card's 132 SMs."""
    plan = ops.seq_plan(32, 256, {16: 7, 8: 15})
    tiles = -(-32 // plan.rows)
    assert tiles <= plan.clusters
    assert plan.clusters * plan.cluster >= 88


def test_plan_depends_on_shapes_only():
    """The same arguments give the same plan (no state, no mask)."""
    res = {16: 7, 8: 15}
    assert ops.seq_plan(32, 256, res) == ops.seq_plan(32, 256, dict(res))
    assert ops.seq_plan(0, 256, res) == ops.seq_plan(1, 256, res)
