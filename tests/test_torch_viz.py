"""The visualisers of the port (mesh/gaussians_viz.py,
tools/gaussians_to_mesh.py, tools/mesh_video.py) against the JAX package on
the CPU.

`gaussians_to_mesh`: vertices within 1e-6 (the port forms the ellipsoids
elementwise in float64, numpy by einsum), faces and colours equal, also
with `random_colors` (the same numpy draws). The export tool on a hermetic
model, timesteps 0 and 1: the plys' faces and colours equal, vertices
within 1e-5 (the deformation's float32 sums). `render_points`: the image
equal to the JAX package's for coloured clouds without equal depths; the
shaded mesh within 1e-6 (numpy's float32 `x ** 16` and PyTorch's differ
in the last bit). A later offset pass overwrites a nearer point as in the
numpy original; at equal depths the port keeps the input order (a stable
sort) where `np.argsort` leaves it unspecified, the one place the two may
differ.
"""

import os
import sys

import numpy as np
import pytest
import torch

from ed3dgs_tpu.data.ply import read_mesh_ply as j_read_mesh_ply
from ed3dgs_tpu.data.ply import read_ply as j_read_ply
from ed3dgs_tpu.data.ply import write_mesh_ply as j_write_mesh_ply
from ed3dgs_tpu.mesh import gaussians_viz as jgv
from ed3dgs_tpu.tools import gaussians_to_mesh as jg2m
from ed3dgs_tpu.tools import mesh_video as jmv

from ed3dgs_torch.data.ply import read_mesh_ply, read_ply, store_point_cloud, write_mesh_ply
from ed3dgs_torch.mesh import gaussians_viz as tgv
from ed3dgs_torch.tools import gaussians_to_mesh as tg2m
from ed3dgs_torch.tools import mesh_video as tmv
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_offline_model import SET, make_model


def cloud(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(0.01, 0.1, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32),
            rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32))


@pytest.mark.parametrize("random_colors,subdiv,cap", [(False, 1, None), (True, 1, None),
                                                      (False, 2, 30)])
def test_gaussians_to_mesh_matches_jax(random_colors, subdiv, cap):
    args = cloud()
    kw = dict(opacity_threshold=0.3, random_colors=random_colors, seed=4, subdiv=subdiv,
              max_n_gaussians=cap)
    want = jgv.gaussians_to_mesh(*args, **kw)
    got = tgv.gaussians_to_mesh(*(torch.as_tensor(a) for a in args), **kw)
    assert len(want[0]) > 100 and got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    empty = tgv.gaussians_to_mesh(*args, opacity_threshold=2.0)
    assert [e.shape for e in empty] == [(0, 3)] * 3


@pytest.fixture(scope="module")
def offline_model(tmp_path_factory):
    return make_model(str(tmp_path_factory.mktemp("viz_tool")), n_points=150)


def test_gaussians_to_mesh_tool_matches_jax(offline_model):
    scene, model, flags = offline_model
    argv = flags + ["--end_timestep_index", "2", "--random_colors", "--set", *SET]
    jg2m.main(argv)
    def path(ts):
        return os.path.join(model, "gaussian_meshes", f"{ts:05d}.ply")
    want = {ts: j_read_ply(path(ts)) for ts in (0, 1)}
    want_faces = {ts: j_read_mesh_ply(path(ts))[1] for ts in (0, 1)}
    done = tg2m.main(argv + ["--device", "cpu"])
    assert sorted(done) == [0, 1]
    for ts in (0, 1):
        got = read_ply(path(ts))
        v, wv = got["vertex"], want[ts]["vertex"]
        assert len(v) == done[ts][0] == len(wv) > 1000
        for k in ("red", "green", "blue"):
            np.testing.assert_array_equal(v[k], wv[k])
        for k in ("x", "y", "z"):
            np.testing.assert_allclose(v[k], wv[k], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(read_mesh_ply(path(ts))[1], want_faces[ts])


def focus_cloud(n, seed, spread=0.03):
    rng = np.random.default_rng(seed)
    focus = jmv.VIEWS["central"][1]
    return ((focus + rng.normal(0, spread, (n, 3))).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


@pytest.mark.parametrize("view", list(jmv.VIEWS))
@pytest.mark.parametrize("size", [(96, 128), (61, 45)])
def test_render_points_matches_jax_on_clouds(view, size):
    pts, cols = focus_cloud(3000, seed=len(view))
    assert len(np.unique(pts[:, 2])) == len(pts)
    want = jmv.render_points(pts, cols, *jmv.VIEWS[view], *size)
    got = tmv.render_points(pts, cols, *jmv.VIEWS[view], *size, device="cpu")
    assert got.shape == (3, size[1], size[0]) and (want > 0).any(0).sum() > 50
    np.testing.assert_array_equal(got, want)


def test_render_points_shades_meshes_as_jax(tmp_path):
    rng = np.random.default_rng(1)
    focus = jmv.VIEWS["central"][1]
    v = (focus + rng.normal(0, 0.05, (300, 3))).astype(np.float32)
    j_write_mesh_ply(str(tmp_path / "m.ply"), v, rng.integers(0, 300, (500, 3)))
    jp, jn, jsh = jmv._load_colored_points(str(tmp_path / "m.ply"))
    tp, tn, tsh = tmv._load_colored_points(str(tmp_path / "m.ply"))
    assert jsh and tsh
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tn, jn)
    for view in jmv.VIEWS.values():
        want = jmv.render_points(jp, jn, *view, 96, 128, shaded=True)
        got = tmv.render_points(tp, tn, *view, 96, 128, shaded=True, device="cpu")
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_a_later_pass_overwrites_a_nearer_point():
    """A near red point at pixel x = 22 and a far green one at x = 20: on
    pixel 21 red writes in the dx = -1 pass and green in the later dx = +1
    pass, which overwrites it whatever the depths, as the numpy original's
    writes do."""
    eye, target, up, zoom = jmv.VIEWS["central"]
    w, h = 64, 48
    m = tmv.look_at_camera(eye, target, up, *fovs(zoom, w, h), w, h).matrices()
    c2w = np.linalg.inv(np.asarray(m.world_view, np.float64))
    pts = []
    for px, py, depth in ((22.5, 20.5, 0.40), (20.5, 20.5, 0.55)):   # unproject
        cam = np.array([(px - w / 2.0) / m.focal_x * depth,
                        (py - h / 2.0) / m.focal_y * depth, depth])
        pts.append(c2w[:3, :3] @ cam + c2w[:3, 3])
    pts = np.asarray(pts, np.float32)
    cols = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
    want = jmv.render_points(pts, cols, eye, target, up, zoom, w, h)
    got = tmv.render_points(pts, cols, eye, target, up, zoom, w, h, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 20, 21], [0, 1, 0])     # the far point's pass
    np.testing.assert_array_equal(got[:, 20, 22], [1, 0, 0])


def fovs(zoom, w, h):
    fovy = 2 * np.arctan(np.tan(np.radians(30.0) / 2.0) / zoom)
    return 2 * np.arctan(np.tan(fovy / 2.0) * w / h), fovy


def test_equal_depths_keep_the_input_order():
    """Points at one depth on one pixel: the port's stable sort lets the
    last of them in input order win, every run; this is the only case in
    which it may differ from the JAX package's image."""
    eye, target, up, zoom = jmv.VIEWS["central"]
    pts = np.repeat(focus_cloud(1, 0, spread=0.0)[0], 4, axis=0)
    cols = np.eye(4, 3, dtype=np.float32)[[0, 1, 2, 0]] + np.float32(0.25)
    got = tmv.render_points(pts, cols, eye, target, up, zoom, 32, 32, point_size=1,
                            device="cpu")
    hit = np.nonzero(got.any(0))
    assert len(hit[0]) == 1
    np.testing.assert_array_equal(got[:, hit[0][0], hit[1][0]], cols[-1])


def test_mesh_video_tool_without_imageio_or_pillow(tmp_path, monkeypatch, capsys):
    focus = jmv.VIEWS["central"][1]
    for t in range(2):
        d = tmp_path / f"timestep_{t}"
        d.mkdir()
        v = (focus + np.random.default_rng(t).normal(0, 0.05, (40, 3))).astype(np.float32)
        write_mesh_ply(str(d / "recon.ply"), v, np.random.default_rng(t).integers(0, 40, (60, 3)))
        p, c = focus_cloud(200, t)
        store_point_cloud(str(d / "pointcloud_distance_2_mesh_colored.ply"), p, c)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    made = tmv.main([str(tmp_path), "--width", "48", "--height", "64", "--device", "cpu"])
    assert len(made) == 6                   # 3 views x the two plys present
    out = capsys.readouterr().out
    assert out.count("no video written") == 6
    assert not any(os.path.exists(m) for m in made)
