"""The port's dataset layer (ed3dgs_torch/data: colmap, readers, pcd, ply,
trajectories, synthetic) against ed3dgs_tpu's, both on the CPU.

Bounds: COLMAP files, point clouds and generated camera binaries round-trip
bit for bit in both directions; the scene readers give the JAX package's
cameras exactly (rotations, translations, fields of view, sizes, times,
ids, names, paths, principal-point ratios), its matrices, split,
normalisation, video cameras and point cloud exactly, and its images
exactly at the native size (the port's PNG decoder is bit-exact) and, when
the reader resizes, within 1/255 on >= 99% of values and 2/255 everywhere;
the port's generated scene has the JAX package's camera binaries and init
ply bit for bit and its PNGs within 1/255 on >= 99.9% of pixels (the
port renders through its tile rasterizer, the JAX package through its
per-pixel oracle, and both truncate to 8 bits)."""

import os

import numpy as np
import pytest
from PIL import Image

from ed3dgs_tpu.data import colmap as jcolmap
from ed3dgs_tpu.data import pcd as jpcd
from ed3dgs_tpu.data import ply as jply
from ed3dgs_tpu.data import readers as jreaders
from ed3dgs_tpu.data.synthetic import generate_scene as jgenerate

from ed3dgs_torch.data import colmap, image_io, pcd, ply, readers
from ed3dgs_torch.data.synthetic import generate_scene
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 32, 24


@pytest.fixture(scope="module")
def jax_scenes(tmp_path_factory):
    """Two JAX-generated scenes: cam00.. with a tongue blob, and a
    Technicolor-style one (cam10.., off-centre principal point)."""
    root = tmp_path_factory.mktemp("scenes")
    plain = jgenerate(str(root / "plain"), n_cams=3, n_frames=3, width=W, height=H,
                      n_points=80, seed=1, tongue_frac=0.2)
    techni = jgenerate(str(root / "techni"), n_cams=3, n_frames=2, width=W, height=H,
                       n_points=60, seed=2, cam_start=10, principal_point=0.06)
    return plain, techni


def rand_model(rng):
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 640, 480, rng.uniform(100, 700, 4)),
            2: colmap.ColmapCamera(2, "SIMPLE_PINHOLE", 320, 200, rng.uniform(100, 700, 3)),
            3: colmap.ColmapCamera(3, "OPENCV", 800, 600, rng.normal(size=8))}
    images = {}
    for i in range(1, 5):
        q = rng.normal(size=4)
        images[i] = colmap.ColmapImage(i, q / np.linalg.norm(q), rng.normal(size=3),
                                       1 + i % 3, f"cam{i:02d}.png")
    return cams, images


def assert_models_equal(a, b):
    (ca, ia), (cb, ib) = a, b
    assert set(ca) == set(cb) and set(ia) == set(ib)
    for k in ca:
        assert (ca[k].id, ca[k].model, ca[k].width, ca[k].height) == \
            (cb[k].id, cb[k].model, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
    for k in ia:
        assert (ia[k].id, ia[k].camera_id, ia[k].name) == (ib[k].id, ib[k].camera_id, ib[k].name)
        np.testing.assert_array_equal(ia[k].qvec, ib[k].qvec)
        np.testing.assert_array_equal(ia[k].tvec, ib[k].tvec)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_binary_round_trip(tmp_path, writer):
    """Cameras, images and points written by one package read the same in
    both, and the files are byte-identical."""
    rng = np.random.default_rng(0)
    cams, images = rand_model(rng)
    w = colmap if writer == "port" else jcolmap
    w.write_cameras_binary(str(tmp_path / "cameras.bin"), cams)
    w.write_images_binary(str(tmp_path / "images.bin"), images)
    xyz, rgb = rng.normal(size=(50, 3)), rng.integers(0, 256, (50, 3), dtype=np.uint8)
    w.write_points3d_binary(str(tmp_path / "points3D.bin"), xyz, rgb)
    assert_models_equal(colmap.read_model(str(tmp_path)), jcolmap.read_model(str(tmp_path)))
    assert_models_equal(colmap.read_model(str(tmp_path)), (cams, images))
    for (px, pr), (qx, qr) in [(colmap.read_points3d_binary(str(tmp_path / "points3D.bin")),
                                jcolmap.read_points3d_binary(str(tmp_path / "points3D.bin")))]:
        np.testing.assert_array_equal(px, qx)
        np.testing.assert_array_equal(pr, qr)
    other = tmp_path / "other"
    other.mkdir()
    (jcolmap if writer == "port" else colmap).write_cameras_binary(str(other / "c.bin"), cams)
    assert (other / "c.bin").read_bytes() == (tmp_path / "cameras.bin").read_bytes()


def test_colmap_text_and_rotations(tmp_path):
    """The text readers (with an empty 2D-point line) and the qvec <->
    rotation conversions give the JAX package's values exactly."""
    (tmp_path / "cameras.txt").write_text(
        "# comment\n1 PINHOLE 640 480 500.5 501.25 320 240\n2 SIMPLE_PINHOLE 100 80 90 50 40\n")
    (tmp_path / "images.txt").write_text(
        "# header\n1 0.9 0.1 0.2 0.3 0.5 -0.25 1.5 1 cam00.png\n\n"
        "2 0.5 0.5 0.5 0.5 0 0 0 2 cam01.png\n1.0 2.0 -1\n")
    assert_models_equal(colmap.read_model(str(tmp_path)), jcolmap.read_model(str(tmp_path)))
    rng = np.random.default_rng(1)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = colmap.qvec_to_rotmat(q)
        np.testing.assert_array_equal(R, jcolmap.qvec_to_rotmat(q))
        np.testing.assert_array_equal(colmap.rotmat_to_qvec(R), jcolmap.rotmat_to_qvec(R))
    for R in (np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0])):   # trace < 0 branch
        np.testing.assert_array_equal(colmap.rotmat_to_qvec(R), jcolmap.rotmat_to_qvec(R))


def assert_cameras_equal(tc, jc):
    assert len(tc) == len(jc)
    for a, b in zip(tc, jc):
        for f in ("fovx", "fovy", "width", "height", "time", "cam_no", "frame_no",
                  "image_name", "image_path", "cx_ratio", "cy_ratio", "znear", "zfar"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.T, b.T)
        for x, y in zip(a.matrices(), b.matrices()):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("loader,resolution", [("dynerf", 1), ("nersemble", -1),
                                               ("technicolor", -1), ("colmap", 2)])
def test_scene_readers_match_jax(jax_scenes, loader, resolution):
    plain, techni = jax_scenes
    path = techni if loader == "technicolor" else plain
    duration = 2 if loader == "technicolor" else 3
    tongue = loader == "nersemble"
    kw = dict(duration=duration, resolution=resolution)
    tinfo = readers.SCENE_READERS[loader](
        path, image_loader=readers.make_image_loader(load_tongue=tongue), **kw)
    jinfo = jreaders.SCENE_READERS[loader](
        path, image_loader=jreaders.make_image_loader(load_tongue=tongue), **kw)
    assert tinfo.train_cameras and tinfo.test_cameras
    assert_cameras_equal(tinfo.train_cameras, jinfo.train_cameras)
    assert_cameras_equal(tinfo.test_cameras, jinfo.test_cameras)
    assert_cameras_equal(tinfo.video_cameras, jinfo.video_cameras)
    assert len(tinfo.video_cameras) == {"dynerf": 300, "nersemble": 3, "technicolor": 0,
                                        "colmap": 300}[loader]
    assert tinfo.maxtime == jinfo.maxtime == duration and tinfo.ply_path == jinfo.ply_path
    np.testing.assert_array_equal(tinfo.nerf_normalization["translate"],
                                  jinfo.nerf_normalization["translate"])
    assert tinfo.nerf_normalization["radius"] == jinfo.nerf_normalization["radius"]
    for a, b in zip(tinfo.point_cloud, jinfo.point_cloud):
        np.testing.assert_array_equal(a, b)
    # the images, masks and tongue masks of a few cameras
    for tc, jc in list(zip(tinfo.train_cameras, jinfo.train_cameras))[::2]:
        got, want = tc.image, jc.image
        assert got.shape == want.shape == (3, tc.height, tc.width)
        if resolution == 2:       # resized by the Lanczos filter
            d = np.abs(got - want) * 255
            assert (d <= 1 + 1e-3).mean() >= 0.99 and d.max() <= 2 + 1e-3
        else:
            np.testing.assert_array_equal(got, want)
        if tongue:
            np.testing.assert_array_equal(tc.tongue_mask, jc.tongue_mask)
            assert float(tc.tongue_mask.max()) > 0
        tc.release_image()
        assert tc._image is None


def test_nerfies_readers_name_the_next_slice(tmp_path):
    """The nerfies/HyperNeRF readers are ported: both names
    read a HyperNeRF-layout scene (tests/test_torch_hyper.py holds them to
    the JAX package's)."""
    from ed3dgs_torch.data.synthetic import generate_hyper_scene
    root = generate_hyper_scene(str(tmp_path / "hyper"), n_frames=8, width=24, height=16,
                                n_points=40, device="cpu")
    for name in ("nerfies", "hypernerf"):
        info = readers.SCENE_READERS[name](root)
        assert (len(info.train_cameras), len(info.test_cameras), info.maxtime) == (2, 1, 4)
        assert info.train_cameras[0].image.shape == (3, 16, 24)


def test_rgba_images_load_with_their_alpha(tmp_path):
    """A 4-channel image: the colour premultiplied by the alpha mask, which
    comes back as the mask, as the JAX loader gives them."""
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    path = str(tmp_path / "images" / "cam00" / "0000.png")
    os.makedirs(os.path.dirname(path))
    Image.fromarray(arr).save(path)
    from ed3dgs_tpu.data.cameras import Camera as JCamera
    from ed3dgs_torch.data.cameras import Camera
    kw = dict(R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.8, image_path=path)
    for w, h, exact in ((W, H, True), (20, 15, False)):
        got = readers.make_image_loader()(Camera(width=w, height=h, **kw))
        want = jreaders.make_image_loader()(JCamera(width=w, height=h, **kw))
        for a, b in zip(got[:2], want[:2]):
            if exact:
                np.testing.assert_array_equal(a, b)
            else:
                d = np.abs(a - b) * 255
                assert (d <= 1 + 1e-3).mean() >= 0.99 and d.max() <= 2 + 1e-3


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_round_trip_with_jax(tmp_path, binary):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(77, 3)).astype(np.float32)
    nrm = rng.normal(size=(77, 3)).astype(np.float32)
    pcd.write_pcd(str(tmp_path / "a.pcd"), pts, nrm, binary=binary)
    jpcd.write_pcd(str(tmp_path / "b.pcd"), pts, nrm, binary=binary)
    assert (tmp_path / "a.pcd").read_bytes() == (tmp_path / "b.pcd").read_bytes()
    for name in ("a.pcd", "b.pcd"):
        for got, want in zip(pcd.read_pcd(str(tmp_path / name)),
                             jpcd.read_pcd(str(tmp_path / name))):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(pcd.load_pointcloud_any(str(tmp_path / name)),
                             jpcd.load_pointcloud_any(str(tmp_path / name))):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(pcd.read_pcd(str(tmp_path / "a.pcd"))[0], pts, rtol=1e-6)


def test_input_ply_round_trip_with_jax(tmp_path):
    """store_point_cloud / fetch_point_cloud (the init cloud's uchar-colour
    ply) and load_pointcloud_any on a ply, in both directions."""
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    ply.store_point_cloud(str(tmp_path / "a.ply"), pts, cols)
    jply.store_point_cloud(str(tmp_path / "b.ply"), pts, cols)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    for got, want in zip(ply.fetch_point_cloud(str(tmp_path / "a.ply")),
                         jply.fetch_point_cloud(str(tmp_path / "a.ply"))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(pcd.load_pointcloud_any(str(tmp_path / "a.ply")),
                         jpcd.load_pointcloud_any(str(tmp_path / "a.ply"))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(tongue_frac=0.2), dict(cam_start=10, principal_point=0.06)])
def test_generate_scene_matches_jax(tmp_path, kw):
    """The port's scene generator (rendered through its own projection and
    rasterizer on the CPU) against the JAX package's (its oracle)."""
    jroot = jgenerate(str(tmp_path / "j"), n_cams=3, n_frames=2, width=W, height=H,
                      n_points=90, seed=3, **kw)
    troot = generate_scene(str(tmp_path / "t"), n_cams=3, n_frames=2, width=W, height=H,
                           n_points=90, seed=3, device="cpu", **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), troot)
                           for d, _, fs in os.walk(troot) for f in fs)
    assert sum(f.endswith(".png") for f in files) == 6 * (2 if "tongue_frac" in kw else 1)
    for f in files:
        a, b = os.path.join(jroot, f), os.path.join(troot, f)
        if not f.endswith(".png"):
            assert open(a, "rb").read() == open(b, "rb").read(), f
            continue
        want = np.asarray(Image.open(a)).astype(np.int64)
        got = image_io.read_png(b).astype(np.int64)
        assert got.shape == want.shape, f
        px = np.abs(got - want).reshape(got.shape[0], got.shape[1], -1).max(axis=2)
        assert (px <= 1).mean() >= 0.999, f
        assert want.std() > 0, f
