"""The work counts against counts made by hand on tiny shapes."""

import pytest

import work

HIDDEN = dict(net_width=4, defor_depth=2, temporal_embedding_dim=3, gaussian_embedding_dim=2,
              max_embeddings=5, max_cameras=7)


def test_mlp_flops_by_hand():
    # a tower: (3+2)x4 + 4x4 feature, five heads 4x4 + 4xd, d = 3,3,4,1,48
    tower = 5 * 4 + 4 * 4 + 5 * 16 + 4 * (3 + 3 + 4 + 1 + 48)
    assert work.mlp_flops(10, HIDDEN, backward=False) == 2 * 2 * 10 * tower
    assert work.mlp_flops(10, HIDDEN, backward=True) == 3 * 2 * 2 * 10 * tower


def test_published_mlp_is_half_a_megaflop_a_gaussian():
    h = dict(net_width=128, defor_depth=1, temporal_embedding_dim=256,
             gaussian_embedding_dim=32)
    # 288 -> 128, five 128 -> 128, 128 -> 3+3+4+1+48, both towers
    assert work.mlp_flops(1, h, backward=False) == 2 * 2 * (288 * 128 + 5 * 128 * 128 + 128 * 59)


def test_mlp_params_by_hand():
    layers = [(5, 4), (4, 4)] + [(4, 4)] * 5 + [(4, d) for d in (3, 3, 4, 1, 48)]
    tower = sum(i * o + o for i, o in layers)
    assert work.mlp_params(HIDDEN) == 5 * 3 + 7 + 2 * tower


def test_blend_counts_by_hand():
    k1 = work.k1_work(tiles=2, rows_read=10, evals=100, includes=7)
    assert k1["nbytes"] == 10 * 26 * 4 + 2 * 4 * 2 + 2 * 24 * 256 * 4
    assert k1["fp32_ops"] == 14 * 100 + 45 * 7
    k2 = work.k2_work(tiles=2, rows=12, live_rows=10, evals=100, includes=7)
    assert k2["nbytes"] == (10 + 12) * 26 * 4 + 27 * 2 * 256 * 4 + 2 * 4 * 2 + 4 * 2
    assert k2["fp32_ops"] == 28 * 100 + 120 * 7


@pytest.mark.parametrize("args,expect", [
    (dict(nbytes=3.35e12), 1.0), (dict(fp32_ops=67e12), 1.0), (dict(bf16_flops=989e12), 1.0),
    (dict(nbytes=3.35e12, fp32_ops=134e12), 2.0)])
def test_least_time_is_the_largest_bound(args, expect):
    assert work.least_s(**args) == pytest.approx(expect)


def test_rest_bytes_by_hand():
    # 2 Gaussians of 59 + 3 floats, 10 network floats: 8 passes; a 4 x 2 image
    assert work.step_rest_bytes(2, 3, 10, 4, 2) == 8 * (2 * 62 + 10) * 4 + 21 * 8 * 4
    assert work.frame_rest_bytes(2, 3, 10, 4, 2) == (2 * 62 + 10) * 4 + 3 * 8 * 4
    assert work.knn_loss_bytes(2, 3, 5) == 2 * (2 * 3 * 4 + 5 * 8)
