"""Tetrahedra mesh extraction and evaluation of the port (mesh/*,
tools/mesh_extract.py, tools/evaluate_mesh.py) against the JAX package on
the CPU.

The building blocks are held exactly (marching tetrahedra, the outlier
mask, the tetra points). The pipeline runs on the dense ball of
tests/test_mesh_extract.py with four views and two binary steps in both
packages: the SDF at the tetra points at 1e-5 (the integration's bound,
tests/test_torch_integrate.py), the port's marching on the JAX package's
SDF gives its faces exactly, and the vertex sets lie within a Chamfer
distance of 1e-4 of the ball's radius. The tools run on a hermetic scene:
the port's recon.ply reads back in the JAX package, and both evaluation
tools write the same mesh_eval.json at 1e-6. Last, the one place where the
packages differ by design: a tile with more than 1024 pairs."""

import json
import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.config.params import DeformHiddenConfig as JHidden
from ed3dgs_tpu.core.projection import project_gaussians as j_project
from ed3dgs_tpu.data.cameras import look_at_camera as j_look_at
from ed3dgs_tpu.data.ply import read_mesh_ply as j_read_mesh_ply
from ed3dgs_tpu.mesh import extract as jx
from ed3dgs_tpu.mesh import marching_tets as jmt
from ed3dgs_tpu.mesh import tetra as jtetra
from ed3dgs_tpu.models import gaussians as jgm
from ed3dgs_tpu.models.deformation import init_deform_params as j_init_deform
from ed3dgs_tpu.ops import integrate as ji
from ed3dgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ed3dgs_tpu.ops.rasterize import rasterize as j_rasterize
from ed3dgs_tpu.tools import evaluate_mesh as j_evaluate_mesh

from ed3dgs_torch.config.params import DeformHiddenConfig
from ed3dgs_torch.core.projection import project_gaussians
from ed3dgs_torch.data.cameras import look_at_camera
from ed3dgs_torch.data.scene import save_deformation
from ed3dgs_torch.data.synthetic import generate_scene
from ed3dgs_torch.mesh import extract as tx
from ed3dgs_torch.mesh import marching_tets as tmt
from ed3dgs_torch.mesh import tetra as ttetra
from ed3dgs_torch.models import gaussians as tgm
from ed3dgs_torch.models.deformation import init_deform_params
from ed3dgs_torch.ops.rasterize import RasterConfig, rasterize
from ed3dgs_torch.tools import evaluate_mesh as t_evaluate_mesh
from ed3dgs_torch.tools import mesh_extract as t_mesh_extract
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CENTER = np.array([0.0, 0.0, 2.2])
R_BALL = 0.25
RES, VIEWS, STEPS, L = 96, 4, 2, 512


def make_ball(n=400, seed=0):
    """tests/test_mesh_extract.py's dense ball."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = R_BALL * rng.uniform(0, 1, (n, 1)) ** (1 / 3)
    return (CENTER + d * r).astype(np.float32), np.full((n, 3), 0.6, np.float32)


def eyes(k=VIEWS):
    for i in range(k):
        a = 2 * np.pi * i / k
        yield CENTER + np.array([1.6 * np.sin(a), 0.2, -1.6 * np.cos(a)])


def test_marching_tetrahedra_matches_jax():
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(300, 3)).astype(np.float32)
    tets = ttetra.delaunay_tets(verts)
    sdf = (0.8 - np.linalg.norm(verts, axis=1)).astype(np.float32)
    for a, b in zip(tmt.marching_tetrahedra(verts, tets, sdf),
                    jmt.marching_tetrahedra(verts, tets, sdf)):
        np.testing.assert_array_equal(a, b)
    assert len(tmt.marching_tetrahedra(verts, tets, sdf)[1]) > 50


def test_tetra_points_and_outlier_mask_match_jax():
    rng = np.random.default_rng(1)
    xyz = rng.normal(0, 0.3, (400, 3)).astype(np.float32)
    xyz[:8] += 3.0                                           # outliers
    rot = rng.normal(size=(400, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-3, 0.5, (400, 3))).astype(np.float32)
    keep = ttetra.statistical_outlier_mask(xyz)
    np.testing.assert_array_equal(keep, jtetra.statistical_outlier_mask(xyz))
    assert not keep[:8].any() and keep.mean() > 0.7
    for a, b in zip(ttetra.get_tetra_points(xyz, rot, scales),
                    jtetra.get_tetra_points(xyz, rot, scales)):
        np.testing.assert_array_equal(a, b)


def _capture_marching(monkeypatch, module, store):
    orig = module.marching_tetrahedra

    def rec(points, tets, sdf):
        out = orig(points, tets, sdf)
        store.update(points=points, tets=tets, sdf=sdf, out=out)
        return out
    monkeypatch.setattr(module, "marching_tetrahedra", rec)


@pytest.fixture(scope="module")
def ball():
    pts, cols = make_ball()
    mp = pytest.MonkeyPatch()
    got, want = {}, {}
    try:
        _capture_marching(mp, jx, want)
        _capture_marching(mp, tx, got)
        # the JAX integration compiled once per shape (op by op it recompiles
        # its scan every call); the depths it fuses differ in the last bit
        mp.setattr(jx, "integrate_points", jax.jit(ji.integrate_points, static_argnames=(
            "width", "height", "focal_x", "focal_y", "pair_capacity", "max_per_tile")))
        fov = math.radians(55.0)
        jparams, jaux = jgm.create_from_points(pts, cols, capacity=512)
        jparams = jparams._replace(
            opacity=jnp.where(jaux.alive[:, None], 3.0, -10.0),
            scaling=jnp.where(jaux.alive[:, None], np.log(0.05), -10.0))
        jhidden = JHidden(no_coarse_deform=True, no_fine_deform=True, net_width=16)
        jviews = [j_look_at(e, CENTER, (0, -1, 0), fov, fov, RES, RES) for e in eyes()]
        m = jviews[0].matrices()
        kw = dict(timestep=0.0, width=RES, height=RES, focal_x=m.focal_x, focal_y=m.focal_y,
                  n_binary_steps=STEPS, pair_capacity=1 << 15, max_per_tile=L)
        want["mesh"] = jx.extract_mesh_at_timestep(
            jparams, jaux, j_init_deform(jax.random.PRNGKey(0), jhidden), jhidden, jviews, **kw)

        params, aux = tgm.create_from_points(pts, cols, capacity=512, device="cpu")
        alive = aux.alive[:, None]
        params = params._replace(
            opacity=torch.where(alive, torch.tensor(3.0), torch.tensor(-10.0)),
            scaling=torch.where(alive, torch.tensor(float(np.log(np.float32(0.05)))),
                                torch.tensor(-10.0)).expand(-1, 3).contiguous())
        hidden = DeformHiddenConfig(no_coarse_deform=True, no_fine_deform=True, net_width=16)
        views = [look_at_camera(e, CENTER, (0, -1, 0), fov, fov, RES, RES) for e in eyes()]
        stats = {}
        got["mesh"] = tx.extract_mesh_at_timestep(
            params, aux, init_deform_params(hidden, seed=0, device="cpu"), hidden, views,
            stats=stats, **kw)
        got["stats"] = stats
    finally:
        mp.undo()
    return got, want


def test_ball_sdf_matches_jax(ball):
    got, want = ball
    np.testing.assert_array_equal(got["points"], want["points"])
    np.testing.assert_array_equal(got["tets"], want["tets"])
    sdf_t, sdf_j = got["sdf"], want["sdf"]
    assert (sdf_j > 0).sum() > 100 and (sdf_j == -100).sum() < len(sdf_j)
    np.testing.assert_allclose(sdf_t, sdf_j, rtol=0, atol=1e-5)
    s = got["stats"]
    assert s["tetra_points"] == len(got["points"]) and s["tets"] == len(got["tets"])
    assert 0 < s["delaunay_s"] < s["total_s"] and 0 < s["sdf_s"] < s["total_s"]


def test_marching_on_the_jax_sdf_gives_its_faces(ball):
    _, want = ball
    edges, faces = tmt.marching_tetrahedra(want["points"], want["tets"], want["sdf"])
    np.testing.assert_array_equal(edges, want["out"][0])
    np.testing.assert_array_equal(faces, want["out"][1])


def test_ball_meshes_agree(ball):
    got, want = ball
    (vt, ft), (vj, fj) = got["mesh"], want["mesh"]
    assert len(vt) > 50 and len(ft) > 50 and np.all(np.isfinite(vt))
    assert ft.max() < len(vt)
    from scipy.spatial import cKDTree
    chamfer = 0.5 * (cKDTree(vj).query(vt)[0].mean() + cKDTree(vt).query(vj)[0].mean())
    assert chamfer <= 1e-4 * R_BALL, chamfer
    d = np.linalg.norm(vt - CENTER, axis=1)
    assert np.median(d) < R_BALL * 2.5 and d.max() < 1.0


@pytest.fixture(scope="module")
def tool_model(tmp_path_factory):
    """A hermetic scene and a model of its own points, saved by the port."""
    root = tmp_path_factory.mktemp("mesh_tools")
    scene = generate_scene(str(root / "scene"), n_cams=3, n_frames=2, width=48, height=40,
                           n_points=150, device="cpu")
    from ed3dgs_torch.data.ply import fetch_point_cloud
    pts, cols, _ = fetch_point_cloud(os.path.join(scene, "points3D_downsample.ply"))
    params, aux = tgm.create_from_points(pts, cols, capacity=192, device="cpu")
    params = params._replace(opacity=torch.full_like(params.opacity, 2.0),
                             scaling=torch.full_like(params.scaling, math.log(0.03)))
    it_dir = root / "model" / "point_cloud" / "iteration_10"
    tgm.save_ply(str(it_dir / "point_cloud.ply"), params, aux)
    save_deformation(str(it_dir), init_deform_params(
        DeformHiddenConfig(net_width=32, min_embeddings=5, max_embeddings=10), seed=1,
        device="cpu"))
    gt = root / "gt"
    gt.mkdir()
    os.link(os.path.join(scene, "points3D_downsample.ply"), gt / "00000.ply")
    return scene, root / "model", gt


def test_mesh_tools_write_what_jax_reads(tool_model):
    scene, model, gt = tool_model
    done = t_mesh_extract.main([
        "-m", str(model), "-s", scene, "--loader", "dynerf", "--duration", "2",
        "--device", "cpu", "--binary_steps", "2", "--set", "max_number_gaussians=192",
        "pair_capacity=16384", "net_width=32", "min_embeddings=5", "max_embeddings=10"])
    nv, nf, stats = done[0]
    assert nv > 10 and nf > 10 and stats["tetra_points"] > 0
    verts, faces = j_read_mesh_ply(str(model / "meshes" / "00000" / "recon.ply"))
    assert verts.shape == (nv, 3) and faces.shape == (nf, 3)
    assert np.all(np.isfinite(verts)) and faces.max() < nv

    # both evaluation tools on the same mesh and cloud
    j_evaluate_mesh.main(["-m", str(model), "--gt_dir", str(gt), "--max_points", "300"])
    with open(model / "mesh_eval.json") as f:
        want = json.load(f)
    got = t_evaluate_mesh.main(["-m", str(model), "--gt_dir", str(gt), "--max_points", "300",
                                "--device", "cpu"])
    with open(model / "mesh_eval.json") as f:
        assert json.load(f) == got
    assert list(got) == list(want) == ["00000"]
    for k in ("mean_distance_mm", "normal_similarity"):
        np.testing.assert_allclose(got["00000"][k], want["00000"][k], rtol=1e-6, atol=1e-6)
    assert got["00000"]["mean_distance_mm"] > 0


def test_a_tile_past_1024_pairs_keeps_them_all_in_the_port():
    """By design: the JAX package renders the extraction's masks with its
    "xla" backend at max_per_tile=1024, which drops a tile's pairs past
    1024; the port has one backend, whose tiles hold chunk * 512 pairs
    (ROADMAP.md, Queue 3). Below 1024 the two agree (the ball above)."""
    rng = np.random.default_rng(5)
    n, front, res = 1400, 1100, 32
    # a stack on one tile: 1100 faint splats in front, 300 opaque behind
    depth = np.concatenate([rng.uniform(2.0, 2.2, front), rng.uniform(2.3, 2.4, n - front)])
    xyz = np.concatenate([rng.normal(0, 0.004, (n, 2)) + [0.01, 0.01], depth[:, None]],
                         1).astype(np.float32)
    scales = np.full((n, 3), 0.05, np.float32)
    q = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1))
    opac = np.where(np.arange(n) < front, 0.0045, 0.9).astype(np.float32)
    cam = look_at_camera((0, 0, 0), (0, 0, 1), (0, -1, 0), 0.6, 0.6, res, res).matrices()
    kw = dict(width=res, height=res, tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
              focal_x=cam.focal_x, focal_y=cam.focal_y, sh_degree=0)
    rgb = np.full((n, 3), 0.5, np.float32)
    pj = j_project(jnp.asarray(xyz), jnp.asarray(scales), jnp.asarray(q), jnp.asarray(opac),
                   jnp.zeros((n, 16, 3)), viewmatrix=jnp.asarray(cam.world_view),
                   projmatrix=jnp.asarray(cam.full_proj), campos=jnp.asarray(cam.campos),
                   colors_precomp=jnp.asarray(rgb), **kw)
    t = torch.as_tensor
    pt = project_gaussians(t(xyz), t(scales), t(q), t(opac), torch.zeros(n, 16, 3),
                           viewmatrix=t(cam.world_view), projmatrix=t(cam.full_proj),
                           campos=t(cam.campos), colors_precomp=t(rgb), **kw)
    from ed3dgs_torch.ops.binning import bin_gaussians
    counts = bin_gaussians(pt, width=res, height=res, pair_capacity=1 << 14).tile_count
    assert int(counts.max()) > 1024
    a_j = np.asarray(j_rasterize(pj, jnp.zeros(n), jnp.zeros(3), JRasterConfig(
        width=res, height=res, focal_x=cam.focal_x, focal_y=cam.focal_y,
        pair_capacity=1 << 14, max_per_tile=1024, backend="xla")).alpha)
    a_t = rasterize(pt, torch.zeros(n), torch.zeros(3), RasterConfig(
        width=res, height=res, focal_x=cam.focal_x, focal_y=cam.focal_y,
        pair_capacity=1 << 14)).alpha.numpy()
    # the JAX package stops at the 1024 faint splats in front; the port
    # also blends the opaque ones behind them
    assert (a_t - a_j).max() > 5e-3
    # elsewhere nothing is lost: a pixel saturates (the blend stops once
    # T < 1e-4) at most that much lower
    assert np.all(a_t >= a_j - 1e-4)
