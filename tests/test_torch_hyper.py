"""The Nerfies/HyperNeRF loaders of the port (data/hyper.py,
data/nerfies_camera.py, the `nerfies` / `hypernerf` scene readers, and
data/synthetic.py `generate_hyper_scene`) against the JAX package's on the
CPU.

The camera model is held exactly on seeded float64 inputs. A scene that the
port generates is read by both packages' readers: the same splits, poses,
fields of view, times and video poses, and images and covisible masks equal
byte for byte to the JAX package's Pillow loader (one frame is stored at an
odd size, so the Lanczos replay runs; the masks are stored at odd sizes, so
the bilinear replay runs)."""

import json
import os

import numpy as np
import jax
import pytest
from PIL import Image

from ed3dgs_tpu.data import nerfies_camera as JN
from ed3dgs_tpu.data import readers as jreaders

from ed3dgs_torch.data import image_io
from ed3dgs_torch.data import nerfies_camera as TN
from ed3dgs_torch.data import readers as treaders
from ed3dgs_torch.data.synthetic import generate_hyper_scene
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 40, 32


def _camera_json(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return {"orientation": q.tolist(), "position": rng.normal(size=3).tolist(),
            "focal_length": 120.0 + rng.uniform(0, 30), "principal_point": [63.3, 47.9],
            "image_size": [128, 96], "skew": 0.01, "pixel_aspect_ratio": 1.02,
            "radial_distortion": [0.05, -0.01, 0.002], "tangential": [0.001, -0.002]}


def test_nerfies_camera_matches_jax():
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-0.6, 0.6, 500), rng.uniform(-0.5, 0.5, 500)
    coeffs = (0.05, -0.01, 0.002, 0.001, -0.002)
    for a, b in zip(TN.distort(x, y, *coeffs), JN.distort(x, y, *coeffs)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TN.undistort(x, y, *coeffs), JN.undistort(x, y, *coeffs)):
        np.testing.assert_array_equal(a, b)
    cj = _camera_json(rng)
    tc, jc = TN.NerfiesCamera.from_json_dict(cj), JN.NerfiesCamera.from_json_dict(cj)
    pix = np.stack([rng.uniform(0, 128, 300), rng.uniform(0, 96, 300)], 1)
    pts = rng.normal(size=(300, 3)) + jc.position + 3.0 * jc.orientation[2]
    np.testing.assert_array_equal(tc.pixels_to_rays(pix), jc.pixels_to_rays(pix))
    np.testing.assert_array_equal(tc.pixels_to_points(pix, np.full(300, 2.5)),
                                  jc.pixels_to_points(pix, np.full(300, 2.5)))
    np.testing.assert_array_equal(tc.project(pts), jc.project(pts))
    ts, js = tc.scale(0.5), jc.scale(0.5)
    assert ts.focal_length == js.focal_length
    np.testing.assert_array_equal(ts.image_size, js.image_size)
    img = rng.uniform(0, 1, (96, 128, 3)).astype(np.float32)
    np.testing.assert_array_equal(tc.undistort_image(img), jc.undistort_image(img))


@pytest.mark.parametrize("shape,size", [((37, 53), (19, 27)), ((29, 31), (40, 32)),
                                        ((33, 21, 3), (17, 40)), ((25, 27, 4), (40, 32))])
def test_bilinear_replay_matches_pillow(shape, size):
    a = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(Image.fromarray(a).resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(image_io.resize_bilinear(a, *size), want)


@pytest.fixture(scope="module")
def hyper_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hyper") / "scene")
    generate_hyper_scene(root, n_frames=8, width=W, height=H, n_points=80, device="cpu")
    rng = np.random.default_rng(1)
    with open(os.path.join(root, "dataset.json")) as f:
        ids = json.load(f)["ids"]
    # one frame stored at an odd size: both loaders resize it with Lanczos
    odd = rng.integers(0, 256, (45, 57, 3), dtype=np.uint8)
    image_io.write_png(os.path.join(root, "rgb", "2x", f"{ids[2]}.png"), odd)
    # covisible masks of the test frames at odd sizes (gray and RGB)
    covis = os.path.join(root, "covisible", "2x", "val")
    os.makedirs(covis)
    for i, cid in enumerate(ids):
        shape = (27, 35) if i % 2 else (23, 19, 3)
        image_io.write_png(os.path.join(covis, f"{cid}.png"),
                           rng.integers(0, 256, shape, dtype=np.uint8))
    return root


def test_scene_readers_match_jax(hyper_scene):
    a = treaders.SCENE_READERS["nerfies"](hyper_scene)
    b = jreaders.SCENE_READERS["hypernerf"](hyper_scene)
    assert a.maxtime == b.maxtime == 4
    assert a.ply_path == b.ply_path
    for x, y in zip(a.point_cloud, b.point_cloud):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.nerf_normalization["translate"],
                                  b.nerf_normalization["translate"])
    assert a.nerf_normalization["radius"] == b.nerf_normalization["radius"]
    masks = 0
    for split in ("train_cameras", "test_cameras", "video_cameras"):
        cams_t, cams_j = getattr(a, split), getattr(b, split)
        assert len(cams_t) == len(cams_j) > 0, split
        for ct, cj in zip(cams_t, cams_j):
            for k in ("R", "T"):
                np.testing.assert_array_equal(getattr(ct, k), getattr(cj, k))
            for k in ("fovx", "fovy", "width", "height", "time", "cam_no", "frame_no",
                      "image_name", "image_path", "cx_ratio", "cy_ratio", "znear", "zfar"):
                assert getattr(ct, k) == getattr(cj, k), (split, k)
            if split == "video_cameras":
                continue
            img_t, img_j = ct.image, cj.image
            assert img_t.shape == (3, H, W) and img_t.dtype == img_j.dtype
            np.testing.assert_array_equal(img_t, img_j)
            if cj.alpha_mask is None:
                assert ct.alpha_mask is None
            else:
                masks += 1
                np.testing.assert_array_equal(ct.alpha_mask, cj.alpha_mask)
    assert masks == len(a.test_cameras) == 1


def test_port_trains_on_the_hyper_scene(hyper_scene, tmp_path):
    from ed3dgs_torch.tools import train
    _, state, aux, log = train.main([
        "-s", hyper_scene, "-m", str(tmp_path / "model"), "--loader", "nerfies",
        "--iterations", "6", "--capacity", "128", "--device", "cpu", "--quiet",
        "--no_tensorboard", "--save_iterations", "6",
        "--set", "max_number_gaussians=128", "pair_capacity=8192",
        "densify_from_iter=1000000", "radegs_regularization_from_iter=1000000",
        "random_until=1000000", "min_embeddings=5", "max_embeddings=10",
        "net_width=16", "raster_chunk=32"])
    assert len(log["loss"]) == 6 and all(np.isfinite(log["loss"]))
    assert os.path.exists(tmp_path / "model" / "point_cloud" / "iteration_6" / "point_cloud.ply")
