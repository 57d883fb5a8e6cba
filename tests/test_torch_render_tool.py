"""The serving tools: `python -m ed3dgs_torch.tools.render` and
`.metrics` against the JAX package's on the CPU.

One hermetic scene (the port's generator: 3 cameras, 2 frames, 48x40, a red
tongue blob) and one model: random Gaussians with tongue classes and random
deformation weights, saved by the port's writers. The JAX package loads that
model and saves it again with its own writers, so each tool renders the
model the other package saved. The JAX tool renders with its "xla" backend,
the port's on the CPU (the kernels' plain versions), the train, test and
video splits with the tongue sub-renders, two frames each, in float32
activations (`bf16_activations=false`, the repo's parity pin for the whole
render: the JAX tool's jitted bf16 MLP rounds other intermediates than the
eager one; tests/test_torch_deformation.py holds the bf16 MLP itself).

Bounds: the float images the tools quantise agree at 1e-5 (the raster
bound of tests/test_rasterize_pallas.py); the PNGs, truncated to 8 bits,
within 1 LSB on every value and equal on at least 99% of them. PSNR and
SSIM of the two metrics tools on the same PNG directories at 1e-5; LPIPS
with random weights of the pretrained layout at rtol 2e-4 (the bound of
tests/test_lpips.py), null in both without weights."""

import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from ed3dgs_tpu.config.params import DeformHiddenConfig as JHidden
from ed3dgs_tpu.data.scene import load_deformation as j_load_deformation
from ed3dgs_tpu.data.scene import save_deformation as j_save_deformation
from ed3dgs_tpu.models import gaussians as jgm
from ed3dgs_tpu.models.deformation import init_deform_params as j_init_deform
from ed3dgs_tpu.tools import metrics as jmetrics
from ed3dgs_tpu.tools import render as jrender
from ed3dgs_tpu.utils.lpips_jax import random_params

from ed3dgs_torch.config.params import DeformHiddenConfig
from ed3dgs_torch.data.image_io import read_png
from ed3dgs_torch.data.scene import save_deformation
from ed3dgs_torch.data.synthetic import generate_scene
from ed3dgs_torch.models import gaussians as tgm
from ed3dgs_torch.models.deformation import init_deform_params
from ed3dgs_torch.tools import metrics as tmetrics
from ed3dgs_torch.tools import render as trender
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, CAP, W, H, IT = 160, 192, 48, 40, 7000
SET = ["max_number_gaussians=%d" % CAP, "pair_capacity=16384", "min_embeddings=5",
       "max_embeddings=10", "net_width=32", "raster_chunk=32", "bf16_activations=false"]
SPLITS = ("train", "test", "video")
KINDS = ("renders", "depth", "normal", "tongue", "tongue_render", "wo_tongue_render")


def fields():
    rng = np.random.default_rng(0)
    f = {
        "xyz": np.stack([rng.uniform(-0.6, 0.6, CAP), rng.uniform(-0.6, 0.6, CAP),
                         rng.uniform(1.9, 2.5, CAP)], 1),
        "features_dc": rng.normal(0, 0.8, (CAP, 1, 3)),
        "features_rest": rng.normal(0, 0.1, (CAP, 15, 3)),
        "scaling": rng.normal(-3.0, 0.4, (CAP, 3)), "rotation": rng.normal(size=(CAP, 4)),
        "opacity": rng.normal(0.8, 1.0, (CAP, 1)), "embedding": rng.normal(0, 0.3, (CAP, 32)),
        "tongue_class": (rng.uniform(size=(CAP, 1)) > 0.6),
        "filter_3d": rng.uniform(0.001, 0.01, (CAP, 1)),
        "alive": np.arange(CAP) < N,
    }
    return {k: np.asarray(v, bool if k == "alive" else np.float32) for k, v in f.items()}


def argv(model, scene, *extra):
    return ["-m", model, "-s", scene, "--loader", "dynerf", "--duration", "2",
            "--iteration", str(IT), "--max_frames", "2", "--tongue_renders", *extra,
            "--set", *SET]


def capture(monkeypatch, module, store):
    """Record the float image each save_img call quantises, by path."""
    orig = module.save_img

    def rec(path, chw, clip=True):
        store[path] = np.asarray(chw, np.float32).copy()
        return orig(path, chw, clip)
    monkeypatch.setattr(module, "save_img", rec)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    root = tmp_path_factory.mktemp("render_tool")
    scene = generate_scene(str(root / "scene"), n_cams=3, n_frames=2, width=W, height=H,
                           n_points=120, tongue_frac=0.2, device="cpu")
    hidden = DeformHiddenConfig(net_width=32, min_embeddings=5, max_embeddings=10)
    # the port saves model A ...
    model_a = root / "model_port_saved"
    it_dir = model_a / "point_cloud" / f"iteration_{IT}"
    params, aux = tgm.from_numpy(fields(), device="cpu")
    tgm.save_ply(str(it_dir / "point_cloud.ply"), params, aux)
    save_deformation(str(it_dir), init_deform_params(hidden, seed=3, device="cpu"))
    # ... the JAX package reads it and saves model B
    model_b = root / "model_jax_saved"
    jdir = model_b / "point_cloud" / f"iteration_{IT}"
    jp, ja = jgm.load_ply(str(it_dir / "point_cloud.ply"), capacity=CAP)
    jhidden = JHidden(net_width=32, min_embeddings=5, max_embeddings=10)
    jd = j_load_deformation(str(it_dir), j_init_deform(jax.random.PRNGKey(0), jhidden))
    jgm.save_ply(str(jdir / "point_cloud.ply"), jp, ja)
    j_save_deformation(str(jdir), jd)

    floats_j, floats_t = {}, {}
    mp = pytest.MonkeyPatch()
    try:
        capture(mp, jrender, floats_j)
        capture(mp, trender, floats_t)
        jrender.main(argv(str(model_a), scene, "--backend", "xla"))
        stats = trender.main(argv(str(model_b), scene, "--device", "cpu"))
    finally:
        mp.undo()
    return root, scene, model_a, model_b, floats_j, floats_t, stats


def _pairs(model_a, model_b):
    for split in SPLITS:
        for kind in KINDS:
            d = model_a / split / f"ours_{IT}" / kind
            if not d.is_dir():
                continue
            for name in sorted(os.listdir(d)):
                yield (f"{split}/{kind}/{name}", d / name,
                       model_b / split / f"ours_{IT}" / kind / name)


def test_pngs_agree_within_one_lsb(rendered):
    _, _, model_a, model_b, _, _, stats = rendered
    pairs = list(_pairs(model_a, model_b))
    kinds = {p[0].split("/")[1] for p in pairs if p[0].startswith("train/")}
    assert kinds == set(KINDS)
    assert {p[0].split("/")[0] for p in pairs} == set(SPLITS)
    assert all(stats[s]["frames"] == 2 for s in SPLITS)
    total = equal = 0
    for rel, a, b in pairs:
        x = np.asarray(Image.open(a)).astype(np.int64)
        y = read_png(str(b)).astype(np.int64)
        assert x.shape == y.shape, rel
        assert np.abs(x - y).max() <= 1, rel
        total += x.size
        equal += int((x == y).sum())
    assert equal >= 0.99 * total, equal / total
    # the renders are not blank
    img = read_png(str(model_b / "test" / f"ours_{IT}" / "renders" / "00000.png"))
    assert img.std() > 5


def test_float_images_agree_before_quantisation(rendered):
    _, _, model_a, model_b, floats_j, floats_t, _ = rendered
    assert len(floats_j) == len(floats_t) > 0
    for path, want in floats_j.items():
        got = floats_t[path.replace(str(model_a), str(model_b))]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=path)


def test_png_codecs_read_each_other(rendered):
    _, _, model_a, model_b, _, _, _ = rendered
    for rel, a, b in list(_pairs(model_a, model_b))[:12]:
        np.testing.assert_array_equal(read_png(str(a)), np.asarray(Image.open(a)))
        np.testing.assert_array_equal(np.asarray(Image.open(b)), read_png(str(b)))


def _results(model):
    with open(os.path.join(model, "results.json")) as f:
        res = json.load(f)
    with open(os.path.join(model, "per_view.json")) as f:
        return res, json.load(f)


def _both_metrics(model):
    jmetrics.evaluate([str(model)])
    want = _results(model)
    tmetrics.evaluate([str(model)], device="cpu")
    return want, _results(model)


def test_metrics_agree_on_the_same_pngs(rendered, tmp_path, monkeypatch):
    _, _, model_a, _, _, _, _ = rendered
    monkeypatch.setenv("HOME", str(tmp_path))           # no cached LPIPS weights
    monkeypatch.delenv("ED3DGS_LPIPS_WEIGHTS_VGG", raising=False)
    monkeypatch.delenv("ED3DGS_LPIPS_WEIGHTS_ALEX", raising=False)
    monkeypatch.delenv("TORCH_HOME", raising=False)
    model = tmp_path / "scored"
    shutil.copytree(model_a / "test", model / "test")
    (want, want_pv), (got, got_pv) = _both_metrics(model)
    assert list(got) == list(want) == [f"ours_{IT}"]
    for method, entry in want.items():
        assert list(got[method]) == list(entry)
        for k in ("PSNR", "SSIM"):
            assert abs(got[method][k] - entry[k]) <= 1e-5, k
        assert entry["LPIPS-vgg"] is None and got[method]["LPIPS-vgg"] is None
        assert entry["LPIPS-alex"] is None and got[method]["LPIPS-alex"] is None
        assert list(got_pv[method]) == list(want_pv[method])
        for k in ("PSNR", "SSIM"):
            assert list(got_pv[method][k]) == list(want_pv[method][k])
            np.testing.assert_allclose(list(got_pv[method][k].values()),
                                       list(want_pv[method][k].values()), rtol=0, atol=1e-5)
        assert got_pv[method]["LPIPS-vgg"] == {} == want_pv[method]["LPIPS-vgg"]
    assert 5 < got[f"ours_{IT}"]["PSNR"] < 40


def test_metrics_lpips_with_weights_agree(rendered, tmp_path, monkeypatch):
    _, _, model_a, _, _, _, _ = rendered
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("ED3DGS_LPIPS_WEIGHTS_ALEX", raising=False)
    monkeypatch.delenv("TORCH_HOME", raising=False)
    weights = tmp_path / "lpips_vgg.npz"
    np.savez(weights, **random_params("vgg", seed=0))
    monkeypatch.setenv("ED3DGS_LPIPS_WEIGHTS_VGG", str(weights))
    model = tmp_path / "scored"
    shutil.copytree(model_a / "test", model / "test")
    (want, want_pv), (got, got_pv) = _both_metrics(model)
    entry, mine = want[f"ours_{IT}"], got[f"ours_{IT}"]
    assert entry["LPIPS-alex"] is None and mine["LPIPS-alex"] is None
    assert entry["LPIPS-vgg"] > 0
    np.testing.assert_allclose(mine["LPIPS-vgg"], entry["LPIPS-vgg"], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(list(got_pv[f"ours_{IT}"]["LPIPS-vgg"].values()),
                               list(want_pv[f"ours_{IT}"]["LPIPS-vgg"].values()),
                               rtol=2e-4, atol=1e-6)


def test_video_is_skipped_without_imageio_and_pillow(tmp_path, monkeypatch, capsys):
    frames = tmp_path / "frames"
    frames.mkdir()
    trender.save_img(str(frames / "00000.png"), np.full((3, 8, 8), 0.5, np.float32))
    monkeypatch.setitem(__import__("sys").modules, "imageio", None)
    monkeypatch.setitem(__import__("sys").modules, "imageio.v2", None)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    trender.export_video(str(frames), str(tmp_path / "video.mp4"))
    assert "no video written" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["frames"]
