"""ed3dgs_torch core/config/data modules against ed3dgs_tpu on the CPU.

Inputs come from numpy seeds and go through both packages; outputs are
compared at atol 1e-5 (float32 arithmetic in a different op order)."""

import dataclasses
import glob
import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.config.loader import load_full_config as j_load_full_config
from ed3dgs_tpu.core import camera_math as j_cm
from ed3dgs_tpu.core import sh as j_sh
from ed3dgs_tpu.core import sym3 as j_sym3
from ed3dgs_tpu.core.projection import project_gaussians as j_project
from ed3dgs_tpu.data import ply as j_ply
from ed3dgs_tpu.data.cameras import look_at_camera as j_look_at
from ed3dgs_tpu.models import gaussians as j_gm
from ed3dgs_tpu.ops.common import safe_div as j_safe_div

from ed3dgs_torch.config.loader import load_full_config
from ed3dgs_torch.core import camera_math as t_cm
from ed3dgs_torch.core import sh as t_sh
from ed3dgs_torch.core import sym3 as t_sym3
from ed3dgs_torch.core.projection import project_gaussians as t_project
from ed3dgs_torch.data import ply as t_ply
from ed3dgs_torch.data.cameras import look_at_camera
from ed3dgs_torch.models import gaussians as t_gm
from ed3dgs_torch.ops.common import safe_div

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(x):
    return torch.as_tensor(np.asarray(x))


def close(a, b, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                               rtol=0, atol=atol, err_msg=msg)


def cloud(n, seed):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(1.2, 4.0, n)], 1).astype(np.float32)
    scales = np.exp(rng.normal(-2.5, 0.6, (n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    shs = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    # a Gaussian exactly at the camera centre (a dead slot's position), one
    # behind the camera, and two flat (rank-2) covariances, which take the
    # ill-conditioned eigenvector branch. (A needle, with two equal tiny
    # eigenvalues, has no unique min-eigenvector, so both packages may pick
    # different ones; it is left out.)
    means[0] = 0.0
    means[1, 2] = -1.0
    scales[2] = (0.05, 0.04, 1e-7)
    scales[3] = (1e-7, 0.03, 0.05)
    q[4] = (1.0, 0.0, 0.0, 0.0)
    scales[4] = 0.03   # isotropic: repeated eigenvalues
    return means, scales, q, opac, shs


@pytest.mark.parametrize("sh_degree,kernel_size,w,h", [
    (3, 0.1, 48, 40), (1, 0.0, 64, 33), (0, 0.3, 30, 50)])
def test_project_gaussians_matches_jax(sh_degree, kernel_size, w, h):
    means, scales, q, opac, shs = cloud(300, seed=sh_degree)
    fov = math.radians(55.0)
    cam = j_look_at((0.1, -0.05, 0), (0, 0, 2.0), (0, -1, 0), fov,
                    2 * math.atan(math.tan(fov / 2) * h / w), w, h).matrices()
    mask = np.random.default_rng(9).uniform(size=300) > 0.1
    kw = dict(width=w, height=h, tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
              focal_x=cam.focal_x, focal_y=cam.focal_y, kernel_size=kernel_size,
              sh_degree=sh_degree)
    pj = j_project(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(q),
                   jnp.asarray(opac), jnp.asarray(shs),
                   viewmatrix=jnp.asarray(cam.world_view),
                   projmatrix=jnp.asarray(cam.full_proj),
                   campos=jnp.asarray(cam.campos), mask=jnp.asarray(mask), **kw)
    pt = t_project(T(means), T(scales), T(q), T(opac), T(shs),
                   viewmatrix=T(cam.world_view), projmatrix=T(cam.full_proj),
                   campos=T(cam.campos), mask=T(mask), **kw)
    assert bool(pt.valid[0]) is False and bool(pt.valid[1]) is False
    for name in pt._fields:
        a, b = np.asarray(getattr(pj, name)), getattr(pt, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.all(np.isfinite(b)), name
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            close(a, b, msg=name)


def test_project_gaussians_colors_precomp_and_offset():
    means, scales, q, opac, _ = cloud(64, seed=5)
    rgb = np.random.default_rng(1).uniform(size=(64, 3)).astype(np.float32)
    off = np.random.default_rng(2).normal(size=(64, 2)).astype(np.float32)
    cam = j_look_at((0, 0, 0), (0, 0, 1), (0, -1, 0), 1.0, 1.0, 32, 32).matrices()
    kw = dict(width=32, height=32, tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
              focal_x=cam.focal_x, focal_y=cam.focal_y)
    pj = j_project(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(q),
                   jnp.asarray(opac), None, viewmatrix=jnp.asarray(cam.world_view),
                   projmatrix=jnp.asarray(cam.full_proj),
                   campos=jnp.asarray(cam.campos), colors_precomp=jnp.asarray(rgb),
                   mean2d_offset=jnp.asarray(off), **kw)
    pt = t_project(T(means), T(scales), T(q), T(opac), None,
                   viewmatrix=T(cam.world_view), projmatrix=T(cam.full_proj),
                   campos=T(cam.campos), colors_precomp=T(rgb), mean2d_offset=T(off),
                   **kw)
    for name in ("rgb", "mean2d", "rect_min", "rect_max", "tiles_touched"):
        close(np.asarray(getattr(pj, name)), getattr(pt, name).numpy(), msg=name)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(50, 16, 3)).astype(np.float32)
    means = rng.normal(size=(50, 3)).astype(np.float32)
    means[0] = (0.5, 0.5, 0.5)             # at the camera centre
    campos = np.array([0.5, 0.5, 0.5], np.float32)
    a = j_sh.sh_to_rgb(deg, jnp.asarray(sh), jnp.asarray(means), jnp.asarray(campos))
    b = t_sh.sh_to_rgb(deg, T(sh), T(means), T(campos))
    close(a, b.numpy())
    close(j_sh.rgb_to_sh(jnp.asarray(means)), t_sh.rgb_to_sh(T(means)).numpy())


def test_sym3_matches_jax():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(200, 3, 3)).astype(np.float32)
    S = A @ A.transpose(0, 2, 1)
    S[:20] = np.diag([1e-9, 0.5, 0.2]).astype(np.float32)   # ill-conditioned
    S[20:30] = np.eye(3, dtype=np.float32) * 0.3            # repeated eigenvalues
    p = np.stack([S[:, 0, 0], S[:, 0, 1], S[:, 0, 2], S[:, 1, 1], S[:, 1, 2],
                  S[:, 2, 2]], -1)
    close(j_sym3.sym3_eigenvalues(jnp.asarray(p)),
          t_sym3.sym3_eigenvalues(T(p)).numpy(), atol=1e-4)
    inv_j, well_j = j_sym3.sym3_pseudo_inverse_min(jnp.asarray(p))
    inv_t, well_t = t_sym3.sym3_pseudo_inverse_min(T(p))
    np.testing.assert_array_equal(well_t.numpy(), np.asarray(well_j))
    w = np.asarray(well_j)
    np.testing.assert_allclose(inv_t.numpy()[w], np.asarray(inv_j)[w], rtol=1e-4)
    close(np.asarray(inv_j)[~w], inv_t.numpy()[~w])


def test_camera_math_matches_jax():
    rng = np.random.default_rng(6)
    depth = rng.uniform(1.0, 3.0, (21, 34)).astype(np.float32)
    close(j_cm.depth_to_normal(jnp.asarray(depth), 34, 21, 30.0, 28.0),
          t_cm.depth_to_normal(T(depth), 34, 21, 30.0, 28.0).numpy())
    close(j_cm.camera_rays_z(34, 21, 30.0, 28.0),
          t_cm.camera_rays_z(34, 21, 30.0, 28.0, device="cpu").numpy())
    close(j_cm.projection_matrix_cv(0.01, 100.0, 0.9, 0.7, 0.1, -0.05),
          t_cm.projection_matrix_cv(0.01, 100.0, 0.9, 0.7, 0.1, -0.05))
    cj = j_look_at((0.3, 0.1, -0.2), (0, 0, 2), (0, -1, 0), 0.9, 0.7, 40, 30).matrices()
    ct = look_at_camera((0.3, 0.1, -0.2), (0, 0, 2), (0, -1, 0), 0.9, 0.7, 40, 30).matrices()
    for name in cj._fields:
        close(getattr(cj, name), getattr(ct, name), atol=0, msg=name)


CONFIGS = sorted(os.path.relpath(p, os.path.join(REPO, "configs")) for p in glob.glob(
    os.path.join(REPO, "configs", "**", "*.py"), recursive=True))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_loader_matches_jax(name):
    """Every config file of the repo loads to the JAX loader's values."""
    path = os.path.join(REPO, "configs", name)
    a = dataclasses.asdict(j_load_full_config(path, {"net_width": 16}))
    b = dataclasses.asdict(load_full_config(path, {"net_width": 16}))
    assert a == b


def test_ply_roundtrip_across_packages(tmp_path):
    rng = np.random.default_rng(8)
    cols = [rng.normal(size=(17,)), rng.normal(size=(17, 3)), rng.normal(size=(17, 45))]
    j_ply.write_ply(str(tmp_path / "a.ply"), ["x", "f_dc", "f_rest"], cols)
    t_ply.write_ply(str(tmp_path / "b.ply"), ["x", "f_dc", "f_rest"], cols)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    a = j_ply.read_ply(str(tmp_path / "b.ply"))["vertex"]
    b = t_ply.read_ply(str(tmp_path / "a.ply"))["vertex"]
    assert a.dtype == b.dtype
    for f in a.dtype.names:
        np.testing.assert_array_equal(a[f], b[f])


def test_gaussian_activations_and_3d_filter_match_jax():
    rng = np.random.default_rng(9)
    n = 64
    f = {"xyz": rng.normal(size=(n, 3)), "features_dc": rng.normal(size=(n, 1, 3)),
         "features_rest": rng.normal(size=(n, 15, 3)), "scaling": rng.normal(-3, 1, (n, 3)),
         "rotation": rng.normal(size=(n, 4)), "opacity": rng.normal(size=(n, 1)),
         "embedding": rng.normal(size=(n, 32))}
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["rotation"][0] = 0.0                  # a dead slot's zero quaternion
    tp, _ = t_gm.from_numpy(f, device="cpu")
    jp = j_gm.GaussianParams(**{k: jnp.asarray(v) for k, v in f.items()})
    for name in ("get_scaling", "get_opacity", "get_rotation", "get_features"):
        close(getattr(j_gm, name)(jp), getattr(t_gm, name)(tp), msg=name)
    x = rng.uniform(0.01, 0.99, (n, 1)).astype(np.float32)
    close(j_gm.inverse_sigmoid(jnp.asarray(x)), t_gm.inverse_sigmoid(T(x)), atol=1e-4)
    filt = rng.uniform(1e-4, 1e-2, (n, 1)).astype(np.float32)
    js, jo = j_gm.apply_3d_filter(jnp.asarray(f["opacity"]), jnp.asarray(f["scaling"]),
                                  jnp.asarray(filt))
    ts, to = t_gm.apply_3d_filter(T(f["opacity"]), T(f["scaling"]), T(filt))
    close(js, ts, atol=1e-6)
    close(jo, to, atol=1e-6)
    num, den = rng.normal(size=(2, n)).astype(np.float32)
    den[:8] = 0.0
    mask = den != 0.0
    close(j_safe_div(jnp.asarray(num), jnp.asarray(den), jnp.asarray(mask)),
          safe_div(T(num), T(den), T(mask)), atol=0)


PROJ_FLOAT_OUT = ("mean2d", "depth", "view_point", "conic", "opacity", "camera_planes",
                  "ray_plane", "normal", "ts", "rgb", "cov3d")


def test_project_gaussians_vjp_matches_jax():
    """The projection's gradient under autograd against jax.vjp, on the
    cloud above: a Gaussian at the camera centre, one behind the camera, two
    flat covariances and an isotropic one. The double-where guards keep every
    gradient finite, and each input's gradient agrees at 1e-5 of its largest
    value (the screen-space offset's too: it is densification's statistic),
    except at the Gaussian on the camera centre: there the guarded depth is
    1e-8 and its terms scale by 1e8, so its finite gradient is float noise
    in both packages (measured 3% apart) and is held to finiteness only."""
    w, h = 48, 40
    means, scales, q, opac, shs = cloud(300, seed=3)
    off = np.zeros((300, 2), np.float32)
    fov = math.radians(55.0)
    # the camera sits exactly on Gaussian 0
    cam = j_look_at((0.0, 0.0, 0.0), (0, 0, 2.0), (0, -1, 0), fov,
                    2 * math.atan(math.tan(fov / 2) * h / w), w, h).matrices()
    kw = dict(width=w, height=h, tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
              focal_x=cam.focal_x, focal_y=cam.focal_y, kernel_size=0.1, sh_degree=3)
    rng = np.random.default_rng(11)

    def jf(*xs):
        p = j_project(*xs[:5], viewmatrix=jnp.asarray(cam.world_view),
                      projmatrix=jnp.asarray(cam.full_proj), campos=jnp.asarray(cam.campos),
                      mean2d_offset=xs[5], **kw)
        return [getattr(p, k) for k in PROJ_FLOAT_OUT]

    inputs = (means, scales, q, opac, shs, off)
    outs, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in inputs))
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in outs]
    want = vjp([jnp.asarray(c) for c in cots])

    leaves = [T(x).requires_grad_(True) for x in inputs]
    pt = t_project(*leaves[:5], viewmatrix=T(cam.world_view), projmatrix=T(cam.full_proj),
                   campos=T(cam.campos), mean2d_offset=leaves[5], **kw)
    got = torch.autograd.grad([getattr(pt, k) for k in PROJ_FLOAT_OUT], leaves,
                              [T(c) for c in cots])
    for name, a, b in zip(("means", "scales", "quats", "opac", "shs", "offset"), want, got):
        a, b = np.asarray(a), b.numpy()
        assert np.all(np.isfinite(b)), name
        assert np.all(np.isfinite(a)), name
        a, b = a[1:], b[1:]
        assert np.abs(b - a).max() <= 1e-5 * np.abs(a).max(), (
            name, float(np.abs(b - a).max()), float(np.abs(a).max()))
    assert np.abs(np.asarray(want[5])).max() > 0


def test_points_to_normal_vjp_is_finite_on_flat_regions():
    """A flat region has a zero cross product: the safe normalisation's
    gradient there is zero in both packages, not NaN."""
    pts = np.zeros((3, 12, 10), np.float32)
    pts[:, 6:, :] = np.random.default_rng(4).normal(size=(3, 6, 10))
    cot = np.random.default_rng(5).normal(size=(3, 12, 10)).astype(np.float32)
    _, vjp = jax.vjp(j_cm.points_to_normal, jnp.asarray(pts))
    (want,) = vjp(jnp.asarray(cot))
    x = T(pts).requires_grad_(True)
    (got,) = torch.autograd.grad(t_cm.points_to_normal(x), x, T(cot))
    assert np.all(np.isfinite(got.numpy()))
    assert np.all(got.numpy()[:, :5] == 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
