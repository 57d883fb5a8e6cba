"""Opacity integration at query points (ops/integrate.py) and the ray-space
inverse covariance it reads (core/projection.py `compute_invraycov`),
against the JAX package on the CPU.

A 300-Gaussian cloud with a dense clump (one tile holds more pairs than
`max_per_tile`, so both packages cut its walk), a tenth of the Gaussians
flattened to a zero scale (ill-conditioned covariances), and query points
on screen, off screen and behind the camera. The float outputs are held at
1e-5 (the raster bound of tests/test_rasterize_pallas.py), the pixel
coordinates, depths and validity exactly."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from ed3dgs_tpu.core.projection import project_gaussians as j_project
from ed3dgs_tpu.data.cameras import look_at_camera
from ed3dgs_tpu.ops.integrate import integrate_points as j_integrate
from ed3dgs_tpu.ops.integrate import sample_mask_bilinear as j_sample

from ed3dgs_torch.core.projection import project_gaussians
from ed3dgs_torch.ops.integrate import integrate_points, sample_mask_bilinear

W, H, N, L = 64, 48, 300, 48
TOL = 1e-5


def scene(seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-0.5, 0.5, N), rng.uniform(-0.4, 0.4, N),
                    rng.uniform(1.8, 2.8, N)], 1)
    xyz[:80] = [0.05, 0.02, 2.2] + rng.normal(0, 0.02, (80, 3))   # one dense tile
    scales = np.exp(rng.normal(-3.2, 0.4, (N, 3)))
    scales[::10, 2] = 0.0                                          # ill-conditioned
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, N)
    rgb = rng.uniform(0, 1, (N, 3))
    pts = np.concatenate([
        np.stack([rng.uniform(-0.5, 0.5, 400), rng.uniform(-0.4, 0.4, 400),
                  rng.uniform(1.5, 3.0, 400)], 1),
        xyz[:60] + rng.normal(0, 0.01, (60, 3)),                  # inside the clump
        np.stack([rng.uniform(2.0, 4.0, 20), rng.uniform(-0.4, 0.4, 20),
                  rng.uniform(1.5, 3.0, 20)], 1),                 # off screen
        np.stack([rng.uniform(-0.3, 0.3, 20), rng.uniform(-0.3, 0.3, 20),
                  rng.uniform(-1.0, 0.1, 20)], 1),                # behind the camera
    ])
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    cam = look_at_camera((0, 0, 0), (0, 0, 1), (0, -1, 0), math.radians(50),
                         2 * math.atan(math.tan(math.radians(25)) * H / W), W, H).matrices()
    return dict(xyz=f(xyz), scales=f(scales), q=f(q), opac=f(opac), rgb=f(rgb), pts=f(pts)), cam


def _kw(cam):
    return dict(width=W, height=H, tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
                focal_x=cam.focal_x, focal_y=cam.focal_y, kernel_size=0.1, sh_degree=0,
                compute_invraycov=True)


def both_projections(s, cam):
    pj = j_project(jnp.asarray(s["xyz"]), jnp.asarray(s["scales"]), jnp.asarray(s["q"]),
                   jnp.asarray(s["opac"]), jnp.zeros((N, 16, 3)),
                   viewmatrix=jnp.asarray(cam.world_view), projmatrix=jnp.asarray(cam.full_proj),
                   campos=jnp.asarray(cam.campos), colors_precomp=jnp.asarray(s["rgb"]),
                   **_kw(cam))
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    pt = project_gaussians(t(s["xyz"]), t(s["scales"]), t(s["q"]), t(s["opac"]),
                           torch.zeros(N, 16, 3), viewmatrix=t(cam.world_view),
                           projmatrix=t(cam.full_proj), campos=t(cam.campos),
                           colors_precomp=t(s["rgb"]), **_kw(cam))
    return pj, pt


@pytest.fixture(scope="module")
def case():
    s, cam = scene()
    pj, pt = both_projections(s, cam)
    kw = dict(width=W, height=H, focal_x=cam.focal_x, focal_y=cam.focal_y,
              pair_capacity=1 << 13, max_per_tile=L)
    # op by op: the jitted projection fuses the depth's sum differently
    jo = j_integrate(pj, jnp.asarray(s["pts"]), viewmatrix=jnp.asarray(cam.world_view),
                     point_chunk=128, **kw)
    to = integrate_points(pt, torch.as_tensor(s["pts"]),
                          viewmatrix=torch.as_tensor(cam.world_view), **kw)
    return s, cam, pj, pt, jo, to


def test_invraycov_matches_jax(case):
    _, _, pj, pt, _, _ = case
    assert np.array_equal(np.asarray(pj.well_conditioned), pt.well_conditioned.numpy())
    assert (~pt.well_conditioned).sum() >= N // 10        # the flattened tenth
    a, b = np.asarray(pj.invraycov), pt.invraycov.numpy()
    scale = np.abs(a).max(axis=1, keepdims=True)
    assert np.all(np.isfinite(b))
    worst = float((np.abs(a - b) / scale).max())
    assert worst <= TOL, worst


def test_integrate_points_matches_jax(case):
    _, _, _, pt, jo, to = case
    np.testing.assert_array_equal(np.asarray(jo.point_valid), to.point_valid.numpy())
    np.testing.assert_array_equal(np.asarray(jo.point_coordinate), to.point_coordinate.numpy())
    np.testing.assert_array_equal(np.asarray(jo.point_depth), to.point_depth.numpy())
    valid = to.point_valid.numpy()
    assert 0 < valid.sum() < len(valid)                   # both kinds present
    for k in ("alpha_integrated", "color_integrated", "point_sdf"):
        np.testing.assert_allclose(getattr(to, k).numpy(), np.asarray(getattr(jo, k)),
                                   rtol=0, atol=TOL, err_msg=k)
    assert float(to.alpha_integrated.max()) > 0.5


def test_a_tile_past_its_slot_count_is_cut_in_both(case):
    """The clump's tile holds more pairs than max_per_tile: both packages
    walk its first L slots only, and the points inside it still agree."""
    s, cam, pj, pt, jo, to = case
    from ed3dgs_torch.ops.binning import bin_gaussians
    bins = bin_gaussians(pt, width=W, height=H, pair_capacity=1 << 13)
    assert int(bins.tile_count.max()) > L
    inside = slice(400, 460)
    np.testing.assert_allclose(to.alpha_integrated.numpy()[inside],
                               np.asarray(jo.alpha_integrated)[inside], rtol=0, atol=TOL)


def test_sample_mask_bilinear_matches_jax_and_grid_sample():
    rng = np.random.default_rng(3)
    mask = rng.uniform(0, 1, (1, 23, 31)).astype(np.float32)
    xy = np.stack([rng.uniform(-3, 34, 500), rng.uniform(-3, 26, 500)], 1).astype(np.float32)
    got = sample_mask_bilinear(torch.as_tensor(mask), torch.as_tensor(xy)).numpy()
    want = np.asarray(j_sample(jnp.asarray(mask), jnp.asarray(xy)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the reference's own test: grid_sample at the normalized coordinates
    g = torch.stack([(torch.as_tensor(xy[:, 0]) * 2 + 1) / (31 - 1) - 1,
                     (torch.as_tensor(xy[:, 1]) * 2 + 1) / (23 - 1) - 1], -1)
    ref = F.grid_sample(torch.as_tensor(mask)[None], g[None, None], mode="bilinear",
                        padding_mode="zeros", align_corners=False)[0, 0, 0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
