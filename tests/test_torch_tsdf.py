"""TSDF fusion of the port (mesh/tsdf.py, mesh/tsdf_sparse.py,
tools/mesh_extract_tsdf.py) against the JAX package on the CPU.

On the analytic sphere of tests/test_tsdf_and_viz.py, one view and two,
with colours and without: the volumes' fields within 1e-6 of the JAX
package's (both integrate in the numpy original's dtypes; the projection's
float64 sums may differ in the last bit), the sparse block coordinates
equal in the same row order, faces equal, vertices and colours within
1e-5. The sparse band stays far below the dense box. The tools on a
hermetic scene (64x64, 300 points), both engines: vertex and face counts
and faces equal, vertices within 1e-4 (the renders' depths agree at the
raster bound of 1e-5). The JAX tool's "xla" backend caps a tile at 2048
pairs; the scene's tiles hold far fewer, so the cap does not bind here.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from ed3dgs_tpu.data.ply import read_mesh_ply as j_read_mesh_ply
from ed3dgs_tpu.mesh import tsdf as jt
from ed3dgs_tpu.mesh import tsdf_sparse as js
from ed3dgs_tpu.tools import mesh_extract_tsdf as jtool

from ed3dgs_torch.data.ply import read_mesh_ply
from ed3dgs_torch.mesh import tsdf as tt
from ed3dgs_torch.mesh import tsdf_sparse as ts
from ed3dgs_torch.tools import mesh_extract_tsdf as ttool
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_offline_model import SET, make_model


def synthetic_depth_sphere(w=64, h=64, fov=math.radians(60.0),
                           center=(0, 0, 2.0), radius=0.5):
    """Analytic z-depth of a sphere from a camera at the origin (+z fwd)."""
    f = w / (2 * math.tan(fov / 2))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dx = (xs + 0.5 - w / 2) / f
    dy = (ys + 0.5 - h / 2) / f
    d = np.stack([dx, dy, np.ones_like(dx)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = np.asarray(center, float)
    b = d @ c
    disc = b ** 2 - (c @ c - radius ** 2)
    hit = disc > 0
    t = b - np.sqrt(np.maximum(disc, 0))
    depth = np.where(hit & (t > 0), t * d[..., 2], 0.0)  # z-depth
    return depth.astype(np.float32), f


def views(two, colored):
    depth, f = synthetic_depth_sphere()
    rng = np.random.default_rng(4)
    color = rng.uniform(0, 1, depth.shape + (3,)).astype(np.float32) if colored else None
    if not two:
        return [depth], [color], [np.eye(4)], [(f, f)]
    wv2 = np.eye(4)
    wv2[0, 3] = -0.1                    # camera at x = +0.1
    depth2, _ = synthetic_depth_sphere(center=(-0.1, 0, 2.0))
    color2 = None if color is None else color[:, ::-1].copy()
    return [depth, depth2], [color, color2], [np.eye(4), wv2], [(f, f), (f, f)]


def assert_mesh_close(got, want, atol=1e-5):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=atol)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=atol)


@pytest.mark.parametrize("two,colored", [(False, True), (True, True), (True, False)])
def test_dense_fusion_matches_jax(two, colored):
    d, c, w, f = views(two, colored)
    want = jt.fuse_depths(d, c, w, f, voxel_size=0.03)
    got = tt.fuse_depths(d, c, w, f, voxel_size=0.03)
    assert len(want[1]) > 100
    assert_mesh_close(got, want)
    # the volume, view by view
    jv = jt.create_volume(*jt_bounds(d, w, f), 0.03)
    tv = tt.create_volume(*jt_bounds(d, w, f), 0.03)
    for args in zip(d, c, w, f):
        jv = jt.integrate(jv, *args[:3], *args[3])
        tv = tt.integrate(tv, *args[:3], *args[3])
        for k in ("tsdf", "weight", "color"):
            np.testing.assert_allclose(getattr(tv, k).numpy(), getattr(jv, k), rtol=0,
                                       atol=1e-6, err_msg=k)
    assert tv.dims == jv.dims == tt.fuse_volume(d, c, w, f, voxel_size=0.03).dims


def jt_bounds(depths, wvs, focals):
    """The JAX package's own automatic bounds (tsdf.fuse_depths)."""
    pts = []
    for depth, wv, (fx, fy) in zip(depths, wvs, focals):
        h, w = depth.shape
        ys, xs = np.nonzero(depth > 0)
        z = depth[ys, xs]
        cam = np.stack([(xs + 0.5 - w / 2.0) / fx * z, (ys + 0.5 - h / 2.0) / fy * z, z], 1)
        c2w = np.linalg.inv(wv)
        pts.append(cam @ c2w[:3, :3].T + c2w[:3, 3])
    pts = np.concatenate(pts)
    return pts.min(0) - 0.06, pts.max(0) + 0.06


@pytest.mark.parametrize("two,colored", [(False, True), (True, True), (True, False)])
def test_sparse_fusion_matches_jax(two, colored):
    d, c, w, f = views(two, colored)
    want = js.fuse_depths_sparse(d, c, w, f, voxel_size=0.03)
    got = ts.fuse_depths_sparse(d, c, w, f, voxel_size=0.03)
    assert len(want[1]) > 100
    assert_mesh_close(got, want)
    jv, tv = js.SparseTsdfVolume(0.03), ts.SparseTsdfVolume(0.03)
    for depth, color, wv, (fx, fy) in zip(d, c, w, f):
        jv.integrate(depth, color, wv, fx, fy)
        tv.integrate(depth, color, wv, fx, fy)
        # the same blocks in the same rows: np.unique's order, frame by frame
        np.testing.assert_array_equal(tv.block_coords.numpy(), jv._block_coords)
        for k in ("tsdf", "weight", "color"):
            np.testing.assert_allclose(getattr(tv, k).numpy(), getattr(jv, k), rtol=0,
                                       atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tv.voxel_coords().numpy(), jv.voxel_coords())
    assert torch.equal(ts.fuse_volume_sparse(d, c, w, f, voxel_size=0.03).block_keys,
                       tv.block_keys)


def test_sparse_band_stays_far_below_the_dense_box():
    depth, f = synthetic_depth_sphere()
    color = np.full(depth.shape + (3,), 0.5, np.float32)
    verts, faces, cols = ts.fuse_depths_sparse([depth], [color], [np.eye(4)], [(f, f)],
                                               voxel_size=0.03)
    r = np.linalg.norm(verts - np.array([0, 0, 2.0]), axis=1)
    assert len(faces) > 100 and abs(np.median(r) - 0.5) < 0.08
    assert cols.shape == (len(verts), 3)
    vol = ts.SparseTsdfVolume(0.01)
    vol.integrate(depth, color, np.eye(4), f, f)
    vox = vol.voxel_coords().numpy()
    assert vol.n_blocks * 512 < 0.6 * np.prod(np.ptp(vox, axis=0) + 1)


def test_encode_orders_keys_as_the_coordinates():
    ijk = torch.as_tensor(np.random.default_rng(0).integers(-50, 50, (500, 3)))
    keys = ts.encode(ijk)
    torch.testing.assert_close(ts.decode(keys), ijk)
    lex = np.lexsort(ijk.numpy().T[::-1])
    np.testing.assert_array_equal(np.argsort(keys.numpy(), kind="stable"), lex)


def test_encode_at_the_key_range_boundary():
    """Coordinates up to 2^20 - 1 either way round-trip, in order, with the
    keys the JAX package's `_encode` gives them; at 2^20 either way (where
    the JAX encoder's keys collide, as `(0, 2^20, 0)` and `(1, -2^20, 0)`
    do) the port raises, naming the coordinate."""
    edge = (1 << 20) - 1
    ijk = torch.tensor([[-edge, -edge, -edge], [-edge, 0, edge], [0, 0, 0], [0, edge, -edge],
                        [edge, -edge, 0], [edge, edge, edge]])
    keys = ts.encode(ijk)
    torch.testing.assert_close(ts.decode(keys), ijk)
    assert bool((keys[1:] > keys[:-1]).all())
    np.testing.assert_array_equal(keys.numpy(), js._encode(ijk.numpy()))
    for bad in ([0, 1 << 20, 0], [1, -(1 << 20), 0], [0, 0, -(1 << 20)], [1 << 20, 0, 0]):
        with pytest.raises(ValueError, match=re.escape(str(tuple(bad)))):
            ts.encode(torch.cat([ijk, torch.tensor([bad])]))
    assert js._encode(np.array([[0, 1 << 20, 0]]))[0] == js._encode(
        np.array([[1, -(1 << 20), 0]]))[0]


@pytest.fixture(scope="module")
def offline_model(tmp_path_factory):
    return make_model(str(tmp_path_factory.mktemp("tsdf_tool")))


@pytest.mark.parametrize("engine,voxel", [("sparse", "0.01"), ("dense", "0.02")])
def test_tsdf_tool_matches_jax(offline_model, engine, voxel):
    scene, model, flags = offline_model
    argv = flags + ["--engine", engine, "--voxel_size", voxel, "--set", *SET]
    jtool.main(argv)
    jv, jf = j_read_mesh_ply(os.path.join(model, "recon_tsdf.ply"))
    done = ttool.main(argv + ["--device", "cpu"])
    tv, tf = read_mesh_ply(done["path"])
    assert done["views"] == 2 and done["vertices"] == len(tv) > 1000
    assert tv.shape == jv.shape and tf.shape == jf.shape
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)
    assert (done["blocks"] is None) == (engine == "dense")
