"""Exact k-NN, the 3-NN mean distance, construction from points and the 3D
filter of ed3dgs_torch against ed3dgs_tpu, both on the CPU, on numpy-seeded
clouds.

Bounds: neighbour indices equal on every row and squared distances equal
bit for bit (the port forms the same fused multiply-add chains as XLA's CPU
dot and reduction); with dead slots parked on the far shell, equal too
(ties among shell points resolve to the lower index in both). The 3-NN
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


@pytest.mark.parametrize("n,k,dead,block", [(2200, 20, 0, 1024), (700, 3, 0, 256),
                                            (1500, 20, 300, 1024)])
def test_knn_matches_jax(n, k, dead, block):
    pts, mask = uniform_cloud(n, seed=n, dead=dead)
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
