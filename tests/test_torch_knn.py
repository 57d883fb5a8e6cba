"""Exact k-NN, the 3-NN mean distance, construction from points and the 3D
filter of ed3dgs_torch against ed3dgs_tpu, both on the CPU, on numpy-seeded
clouds.

Bounds: neighbour indices equal on every row and squared distances equal
bit for bit (the port forms the same fused multiply-add chains as XLA's CPU
dot and reduction); with dead slots parked on the far shell, equal too
(ties among shell points resolve to the lower index in both), and on
duplicated points, on points whose |a|^2 + |b|^2 - 2ab cancels below zero,
at N = k + 1 and at k = 1. On a CPU tensor `knn` is `knn_plain` (the
kernel's plain version) bit for bit. The 3-NN
mean, the initial scales and the 3D filter at rtol 1e-5 (the mean of three
and the camera transform are summed in another order); masks exactly.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.data.cameras import look_at_camera
from ed3dgs_tpu.models import gaussians as jgm
from ed3dgs_tpu.ops import knn as jknn

from ed3dgs_torch.models import gaussians as tgm
from ed3dgs_torch.ops import knn as tknn

REL = 1e-5


def uniform_cloud(n, seed, dead=0):
    """n points in a box around z = 2; the last `dead` rows masked out."""
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-1, 1, (n, 3)) * [1.0, 0.7, 1.5] + [0, 0, 2]).astype(np.float32)
    return pts, np.arange(n) < n - dead


def duplicated_cloud(n, seed):
    """n points that are n // 3 points three times over, shuffled: every
    point has two others at distance exactly 0 (the lower index first)."""
    rng = np.random.default_rng(seed)
    base, _ = uniform_cloud(n // 3, seed)
    return base[rng.permutation(np.repeat(np.arange(n // 3), 3))]


def cancelling_cloud(n, seed):
    """n points within ~1e-3 of (60, -40, 90): |a|^2 ~ 1.3e4, whose float32
    spacing (~1e-3) dwarfs the true squared distances (~1e-6), so
    |a|^2 + |b|^2 - 2ab cancels to rounding noise, often below zero."""
    rng = np.random.default_rng(seed)
    return (np.float32([60.0, -40.0, 90.0])
            + rng.uniform(-1e-3, 1e-3, (n, 3)).astype(np.float32))


CLOUDS = {"uniform": lambda n, seed: uniform_cloud(n, seed)[0],
          "duplicated": duplicated_cloud, "cancelling": cancelling_cloud}


@pytest.mark.parametrize("n,k,dead,block,cloud", [
    pytest.param(2200, 20, 0, 1024, "uniform", id="2200-20-0-1024"),
    pytest.param(700, 3, 0, 256, "uniform", id="700-3-0-256"),
    pytest.param(1500, 20, 300, 1024, "uniform", id="1500-20-300-1024"),
    pytest.param(1200, 20, 0, 256, "duplicated", id="duplicated-ties"),
    pytest.param(600, 20, 0, 256, "cancelling", id="cancelling-below-zero"),
    pytest.param(21, 20, 0, 1024, "uniform", id="n-equals-k-plus-1"),
    pytest.param(500, 1, 0, 256, "uniform", id="k-1"),
])
def test_knn_matches_jax(n, k, dead, block, cloud):
    pts = CLOUDS[cloud](n, n)
    mask = np.arange(n) < n - dead
    if dead:   # the trainer's parking of dead slots (update_knn_cache)
        shell = np.asarray(1e3 + 1e-3 * jnp.arange(n, dtype=jnp.float32)[:, None])
        np.testing.assert_array_equal(tknn.far_shell(n, "cpu").numpy(), shell)
        pts = np.where(mask[:, None], pts, shell)
    jd2, jidx = jknn.knn(jnp.asarray(pts), k=k, block_size=block)
    td2, tidx = tknn.knn(torch.as_tensor(pts), k=k, block_size=block)
    assert tidx.shape == (n, k) and td2.dtype == torch.float32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(td2.numpy(), np.asarray(jd2))
    assert not (tidx.numpy() == np.arange(n)[:, None]).any()      # self dropped
    if cloud == "duplicated":   # each point's two copies first, lower index first
        same = (pts[tidx.numpy()[:, :2]] == pts[:, None]).all(-1)
        assert same.all() and (td2.numpy()[:, :2] == 0).all()
        assert (tidx.numpy()[:, 0] < tidx.numpy()[:, 1]).all()
    if cloud == "cancelling":
        assert (td2.numpy() < 0).mean() > 0.1


def test_knn_on_the_cpu_is_the_plain_version():
    """On a CPU tensor `knn` is `knn_plain`, bit for bit, and launches
    nothing."""
    pts = torch.as_tensor(cancelling_cloud(300, 3))
    before = tknn.knn.launches
    for k, block in ((20, 128), (3, 1024)):
        d2, idx = tknn.knn(pts, k=k, block_size=block)
        pd2, pidx = tknn.knn_plain(pts, k=k, block_size=block)
        assert torch.equal(idx, pidx)
        assert torch.equal(d2.view(torch.int32), pd2.view(torch.int32))
    assert tknn.knn.launches == before


@pytest.mark.parametrize("masked", [False, True])
def test_mean_sqdist_3nn_matches_jax(masked):
    pts, mask = uniform_cloud(900, seed=5, dead=150 if masked else 0)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.as_tensor(mask) if masked else None
    want = np.asarray(jknn.mean_sqdist_3nn(jnp.asarray(pts), jm))
    got = tknn.mean_sqdist_3nn(torch.as_tensor(pts), tm).numpy()
    np.testing.assert_allclose(got, want, rtol=REL)
    if masked:
        assert np.all(got[~mask] == 0) and np.all(got[mask] > 0)


@pytest.mark.parametrize("tongue", [False, True])
def test_create_from_points_matches_jax(tongue):
    rng = np.random.default_rng(11)
    n, cap = 400, 512
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    colors[::7] = (1.0, 0.0, 0.0)                    # pure red: tongue class
    jp, ja = jgm.create_from_points(pts, colors, capacity=cap, embedding_dim=32,
                                    tongue_mask_loss_enabled=tongue)
    tp, ta = tgm.create_from_points(pts, colors, capacity=cap, embedding_dim=32,
                                    tongue_mask_loss_enabled=tongue, device="cpu")
    for name in jp._fields:
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   rtol=REL, atol=1e-7, err_msg=name)
    for name in ja._fields:
        np.testing.assert_array_equal(getattr(ta, name).numpy(), np.asarray(getattr(ja, name)),
                                      err_msg=name)
    assert int(tgm.num_alive(ta)) == int(jgm.num_alive(ja)) == n
    assert float(ta.tongue_class.sum()) == (len(range(0, n, 7)) if tongue else 0)


def test_compute_3d_filter_matches_jax():
    rng = np.random.default_rng(2)
    C = 600
    xyz = np.stack([rng.uniform(-2, 2, C), rng.uniform(-1.5, 1.5, C),
                    rng.uniform(-1, 5, C)], 1).astype(np.float32)     # some behind, some off-screen
    alive = rng.uniform(size=C) > 0.2
    cams = [look_at_camera((0.3 * i - 0.3, 0.1 * i, 0), (0, 0, 2.5), (0, -1, 0),
                           math.radians(50 + 5 * i), math.radians(40), 64 + 16 * i, 48)
            .matrices() for i in range(3)]
    args = [np.stack([c.world_view for c in cams]).astype(np.float32),
            np.array([c.focal_x for c in cams], np.float32),
            np.array([c.focal_y for c in cams], np.float32),
            np.array([c.width for c in cams], np.float32),
            np.array([c.height for c in cams], np.float32)]
    want = np.asarray(jgm.compute_3d_filter(jnp.asarray(xyz), jnp.asarray(alive),
                                            *map(jnp.asarray, args)))
    got = tgm.compute_3d_filter(torch.as_tensor(xyz), torch.as_tensor(alive),
                                *map(torch.as_tensor, args)).numpy()
    assert got.shape == (C, 1)
    np.testing.assert_allclose(got, want, rtol=REL)
    # unseen slots (dead, behind or off-screen) take the farthest seen distance
    assert (got == got.max()).sum() > C * 0.2
