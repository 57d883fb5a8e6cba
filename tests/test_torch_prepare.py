"""Data preparation of the port (tools/prepare_data.py, prepare_colmap.py,
prepare_radegs.py, nersemble_utils.py) against the JAX package's tools on
the same synthetic captures, on the CPU.

Each subcommand runs in both packages into two output trees: decoded PNG
pixels equal (the port writes them with its own codec, the JAX tools with
Pillow; alpha maps through the port's replay of PIL's `convert("L")` and
`BILINEAR`), poses_bounds.npy equal, the COLMAP sqlite rows and manual
model equal, COLMAP binaries and plys byte-equal, the printed reports
equal, the headless mesh views within 1 LSB (the shading's `x ** 16`
differs in the last float bit). JPEG frames go through Pillow and mp4
through OpenCV in both; with those packages blocked the port raises an
ImportError that names the file.
"""

import json
import os
import sqlite3
import sys

import numpy as np
import pytest
from PIL import Image

from ed3dgs_tpu.tools import nersemble_utils as jnu
from ed3dgs_tpu.tools import prepare_colmap as jpc
from ed3dgs_tpu.tools import prepare_data as jpd
from ed3dgs_tpu.tools import prepare_radegs as jpr

from ed3dgs_torch.data.image_io import read_png
from ed3dgs_torch.data.ply import store_point_cloud, write_mesh_ply
from ed3dgs_torch.tools import nersemble_utils as tnu
from ed3dgs_torch.tools import prepare_colmap as tpc
from ed3dgs_torch.tools import prepare_data as tpd
from ed3dgs_torch.tools import prepare_radegs as tpr

CAMS = ("AAA", "BBB")
TIMESTEPS = ("frame_00000", "frame_00003")


def pcd_bytes(pts, rgb):
    packed = ((rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]).astype(np.uint32)
    header = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\n"
              "COUNT 1 1 1 1\nWIDTH %d\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS %d\n"
              "DATA binary\n" % (len(pts), len(pts)))
    return header.encode() + np.concatenate(
        [pts, packed[:, None].view(np.float32)], axis=1).astype("<f4").tobytes()


@pytest.fixture
def capture(tmp_path):
    """A raw NerSemble capture: calibration, a CCM json, 2 cameras x 2
    timesteps of frames (PNG and JPEG), alpha maps (gray at half size for
    one camera, RGB for the other), facer colour masks and a coloured
    pointcloud_16.pcd."""
    root = tmp_path / "raw"
    rng = np.random.default_rng(5)
    w2c = {}
    for i, c in enumerate(CAMS):
        m = np.eye(4)
        a = 0.3 * (i + 1)
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = [0.1 * i, -0.05, 2.0]
        w2c[c] = m.tolist()
    (root / "calibration").mkdir(parents=True)
    with open(root / "calibration" / "camera_params.json", "w") as f:
        json.dump({"intrinsics": [[100, 0, 16], [0, 102, 12], [0, 0, 1]],
                   "world_2_cam": w2c}, f)
    ccm = {c: (np.eye(3, 8) + rng.normal(0, 0.05, (3, 8))).tolist() for c in CAMS}
    with open(tmp_path / "ccm.json", "w") as f:
        json.dump(ccm, f)
    for ts in TIMESTEPS:
        base = root / "sequences" / "EXP-1" / "timesteps" / ts
        for sub in ("images-2x", "alpha_map", "facer_segmentation_masks",
                    "colmap/pointclouds"):
            (base / sub).mkdir(parents=True)
        for i, c in enumerate(CAMS):
            img = (rng.uniform(0, 1, (24, 32, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(base / "images-2x" / f"cam_{c}.png")
            a = np.zeros((24, 32), np.uint8)
            a[6:18, 8:24] = 255
            a[5:19, 7] = 128
            if i == 0:
                Image.fromarray(a[::2, ::2]).save(base / "alpha_map" / f"cam_{c}.png")
            else:
                Image.fromarray(np.stack([a, a // 2, 255 - a], -1)).save(
                    base / "alpha_map" / f"cam_{c}.png")
            seg = np.zeros((24, 32, 3), np.uint8)
            seg[10:14, 10:14] = jpd.TONGUE_COLOR
            seg[2:4, 2:4] = (168, 91, 74)
            Image.fromarray(seg).save(base / "facer_segmentation_masks"
                                      / f"color_segmentation_cam_{c}.png")
        pts = rng.normal(size=(50, 3)).astype(np.float32)
        rgb = rng.integers(0, 256, (50, 3)).astype(np.uint32)
        (base / "colmap" / "pointclouds" / "pointcloud_16.pcd").write_bytes(pcd_bytes(pts, rgb))
    return tmp_path, str(root)


def as_jpeg(root):
    """Replace every PNG frame of the capture by a JPEG (Pillow's default
    quality), as raw captures ship them."""
    for ts in TIMESTEPS:
        d = os.path.join(root, "sequences", "EXP-1", "timesteps", ts, "images-2x")
        for name in os.listdir(d):
            Image.open(os.path.join(d, name)).save(os.path.join(d, name[:-4] + ".jpg"))
            os.remove(os.path.join(d, name))


def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_trees_equal(got, want):
    """Every file of both trees: PNGs decoded pixel for pixel, .npy arrays
    equal (NaN included), everything else byte for byte."""
    assert files(got) == files(want) and files(got)
    for rel in files(got):
        g, w = os.path.join(got, rel), os.path.join(want, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(read_png(g), np.asarray(Image.open(w)), err_msg=rel)
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(g), np.load(w), err_msg=rel)
        else:
            with open(g, "rb") as a, open(w, "rb") as b:
                assert a.read() == b.read(), rel


@pytest.mark.parametrize("frames", ["png", "jpeg"])
def test_nersemble_matches_jax(capture, frames):
    tmp, root = capture
    if frames == "jpeg":
        as_jpeg(root)
    args = ["nersemble", root, "EXP-1", None, "--alpha_mask", "--ccm_json", str(tmp / "ccm.json"),
            "--width", "32", "--height", "24", "--number_of_frames", "2"]
    jpd.main([a if a else str(tmp / "jax") for a in args])
    tpd.main([a if a else str(tmp / "port") for a in args])
    assert_trees_equal(str(tmp / "port"), str(tmp / "jax"))
    seg = read_png(str(tmp / "port" / "segmentations" / "cam00" / "0001.png"))
    assert seg[12, 12] == 255 and seg[2, 2] == 0 and seg[0, 0] == 0
    mask = read_png(str(tmp / "port" / "alpha_masks" / "cam01" / "0000.png"))
    assert mask.shape == (24, 32) and 0 < mask[10, 7] < 255


def test_jpeg_and_mp4_need_their_packages(capture, monkeypatch):
    tmp, root = capture
    as_jpeg(root)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"cam_AAA\.jpg.*Pillow"):
        tpd.main(["nersemble", root, "EXP-1", str(tmp / "port")])
    # radegs copies the JPEG frames without Pillow; compositing needs it
    tpr.main(["single", root, "EXP-1", str(tmp / "copied"), TIMESTEPS[0]])
    assert sorted(os.listdir(tmp / "copied" / "images")) == ["cam_AAA.jpg", "cam_BBB.jpg"]
    with pytest.raises(ImportError, match="Pillow"):
        tpr.main(["single", root, "EXP-1", str(tmp / "x"), TIMESTEPS[0], "--apply_alpha_mask"])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"cam00\.mp4.*OpenCV"):
        tpc.extract_frames(str(tmp / "cam00.mp4"), 3)


@pytest.mark.parametrize("alpha", [False, True])
def test_prepare_radegs_matches_jax(capture, alpha):
    tmp, root = capture
    as_jpeg(root)
    flags = ["--apply_alpha_mask", "--ccm_json", str(tmp / "ccm.json")] if alpha else []
    jpr.main(["all", root, "EXP-1", str(tmp / "jax")] + flags)
    tpr.main(["all", root, "EXP-1", str(tmp / "port")] + flags)
    assert_trees_equal(str(tmp / "port"), str(tmp / "jax"))
    assert len(files(str(tmp / "port"))) == 2 * (2 + 3)
    tpr.main(["single", root, "EXP-1", str(tmp / "one"), TIMESTEPS[1]] + flags)
    assert_trees_equal(str(tmp / "one"), str(tmp / "jax" / TIMESTEPS[1]))


def test_downsample_and_tongue_points_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    src = str(tmp_path / "in.ply")
    store_point_cloud(src, rng.uniform(0, 0.05, (5000, 3)).astype(np.float32),
                      rng.uniform(0, 1, (5000, 3)).astype(np.float32))
    outs = {}
    for name, tool in (("jax", jpd), ("port", tpd)):
        out = str(tmp_path / f"{name}.ply")
        tool.main(["downsample", src, out, "--max_points", "1000"])
        tool.main(["add-tongue-points", out, "--num_points", "100", "--seed", "3"])
        outs[name] = [open(p, "rb").read() for p in (out, out[:-4] + "_original.ply")]
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][0]) > len(outs["port"][1])


def llff_capture(path, rng, n=4):
    poses = []
    for i in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        c2w = np.concatenate([R.T, (-R.T @ rng.normal(size=3))[:, None]], 1)
        poses.append(np.concatenate([c2w[:, 1:2], c2w[:, 0:1], -c2w[:, 2:3], c2w[:, 3:4],
                                     [[100], [160 + i], [120.5]]], 1).reshape(-1))
    np.save(os.path.join(path, "poses_bounds.npy"),
            np.concatenate([np.stack(poses), np.tile([[0.1, 10.0]], (n, 1))], 1))


def db_rows(path):
    con = sqlite3.connect(path)
    try:
        return {t: con.execute(f"SELECT * FROM {t}").fetchall()
                for (t,) in con.execute("SELECT name FROM sqlite_master WHERE type='table'")}
    finally:
        con.close()


def test_colmap_database_matches_jax(tmp_path):
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
        llff_capture(str(tmp_path / name), np.random.default_rng(2))
    want = jpc.convert_poses_to_colmap_db(str(tmp_path / "jax"))
    got = tpc.convert_poses_to_colmap_db(str(tmp_path / "port"))
    assert list(got) == list(want) == [f"cam{i:02d}.png" for i in range(4)]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    rows = db_rows(str(tmp_path / "port" / "colmap" / "input.db"))
    assert rows == db_rows(str(tmp_path / "jax" / "colmap" / "input.db"))
    assert len(rows["cameras"]) == len(rows["images"]) == 4
    for f in ("images.txt", "cameras.txt", "points3D.txt"):
        assert ((tmp_path / "port" / "colmap" / "manual" / f).read_text()
                == (tmp_path / "jax" / "colmap" / "manual" / f).read_text())
    with pytest.raises(RuntimeError, match="binary not found"):
        tpc.run_colmap_pipeline(str(tmp_path), colmap_bin="definitely-not-colmap")


def test_extract_frames_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    w, h, nf = 32, 24, 5
    rng = np.random.default_rng(0)
    frames = [(rng.random((h, w, 3)) * 255).astype(np.uint8) for _ in range(nf)]
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
        vw = cv2.VideoWriter(str(tmp_path / name / "cam00.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
        for fr in frames:
            vw.write(fr)
        vw.release()
    assert jpc.extract_frames(str(tmp_path / "jax" / "cam00.mp4"), nf) == nf
    assert tpc.extract_frames(str(tmp_path / "port" / "cam00.mp4"), nf) == nf
    assert tpc.extract_frames(str(tmp_path / "port" / "cam00.mp4"), nf) == nf   # idempotent
    jpc.prepare_input_images(str(tmp_path / "jax"))
    tpc.prepare_input_images(str(tmp_path / "port"))
    for name in ("cam00.mp4",):
        os.remove(tmp_path / "jax" / name)
        os.remove(tmp_path / "port" / name)
    assert_trees_equal(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_nersemble_utils_match_jax(capture, capsys):
    tmp, root = capture
    jpd.main(["nersemble", root, "EXP-1", str(tmp / "prep"), "--width", "32", "--height", "24"])
    capsys.readouterr()
    outs = []
    for tool in (jnu, tnu):
        assert tool.main(["pose-bounds", str(tmp / "prep")]) == 0
        seg = os.path.join(root, "sequences", "EXP-1", "timesteps", TIMESTEPS[0],
                           "facer_segmentation_masks", "color_segmentation_cam_AAA.png")
        assert tool.main(["seg-color", seg, "11", "12"]) == 0
        assert tool.main(["seg-color", seg]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "Camera: 1" in outs[1] and "[168, 91, 73]: 16 px" in outs[1]

    rng = np.random.default_rng(4)
    target = jnu.INTERACTIVE_VIEWS["central"][1]
    mesh = str(tmp / "recon.ply")
    write_mesh_ply(mesh, (target + rng.normal(0, 0.1, (200, 3))).astype(np.float32),
                   rng.integers(0, 200, (300, 3)))
    jnu.main(["render-mesh", mesh, str(tmp / "jax_views"), "--width", "40", "--height", "56"])
    tnu.main(["render-mesh", mesh, str(tmp / "port_views"), "--width", "40", "--height", "56",
              "--device", "cpu"])
    assert files(str(tmp / "port_views")) == files(str(tmp / "jax_views"))
    for rel in files(str(tmp / "port_views")):
        got = read_png(str(tmp / "port_views" / rel)).astype(int)
        want = np.asarray(Image.open(tmp / "jax_views" / rel)).astype(int)
        assert np.abs(got - want).max() <= 1 and (want > 0).sum() > 50, rel

    for name in ("with", "without_jax", "without_port"):
        for ts in TIMESTEPS:
            (tmp / name / ts / "colmap").mkdir(parents=True)
            if name == "with":
                (tmp / name / ts / "colmap" / "x.txt").write_text(ts)
    for tool, dst in ((jnu, "without_jax"), (tnu, "without_port")):
        assert tool.main(["copy-colmap-pcd", "--timesteps_w_colmap_path", str(tmp / "with"),
                          "--timesteps_wo_colmap_path", str(tmp / dst)]) == 0
    assert_trees_equal(str(tmp / "without_port"), str(tmp / "without_jax"))
