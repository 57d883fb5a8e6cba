"""The port's training CLI with the tongue configuration
(configs/nersemble/tongue.py) on the CPU, on a tiny tongue scene from the
port's `generate_scene(tongue_frac=0.1)` (3 cameras, cam00 held out, 2
frames, 48x32; red seeds and segmentations):

* the port's `stage_batch` stages the tongue masks bit for bit as the JAX
  tool's `stage_batch` does, each package reading the scene with its own
  reader;
* a few `tools.train` iterations (no densify) report the tongue scalars in
  the tfevents file (read by the JAX package's reader) and in the returned
  log, every one finite, and count the alive tongue Gaussians as the red
  seeds at every iteration;
* the saved point_cloud.ply carries the tongue class: the JAX package's
  `Scene` reads it back, row for row.

No JAX step is run (a jitted one costs about a minute here)."""

import glob
import os

import numpy as np
import pytest

from ed3dgs_tpu.config.loader import load_full_config as j_load_full_config
from ed3dgs_tpu.data import readers as jreaders
from ed3dgs_tpu.data.scene import Scene as JScene
from ed3dgs_tpu.tools import train as jtrain
from ed3dgs_tpu.utils.tb_writer import read_events

from ed3dgs_torch.data import readers
from ed3dgs_torch.data.ply import fetch_point_cloud
from ed3dgs_torch.data.synthetic import generate_scene
from ed3dgs_torch.tools import train as ttrain
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "nersemble", "tongue.py")
W, H, FRAMES, N_POINTS, ITERS = 48, 32, 2, 150, 6
SET = ["max_number_gaussians=256", "pair_capacity=16384", "densify_from_iter=1000",
       "radegs_regularization_from_iter=0", "min_embeddings=2", "max_embeddings=4",
       "net_width=32", "raster_chunk=32", "deform_from_iter=2"]
TONGUE_TAGS = ("train_loss_patches/tongue_loss", "train_loss_patches/tongue_embedding_loss",
               "train_loss_patches/tongue_rgb_loss", "train_loss_patches/wo_tongue_rgb_loss")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = generate_scene(str(tmp_path_factory.mktemp("cli_tongue") / "scene"), n_cams=3,
                          n_frames=FRAMES, width=W, height=H, n_points=N_POINTS, seed=2,
                          tongue_frac=0.1, device="cpu")
    _, cols, _ = fetch_point_cloud(os.path.join(root, "points3D_downsample.ply"))
    red = int(np.all(np.asarray(cols) == np.array([1.0, 0.0, 0.0]), axis=1).sum())
    return root, red


@pytest.fixture(scope="module")
def trained(scene, tmp_path_factory):
    root, _ = scene
    model = str(tmp_path_factory.mktemp("cli_tongue_model") / "model")
    run = ttrain.main(["-s", root, "-m", model, "--configs", CONFIG, "--duration", str(FRAMES),
                       "--capacity", "256", "--device", "cpu", "--quiet", "--test_every", "0",
                       "--iterations", str(ITERS), "--set", *SET])
    return model, run


def test_stage_batch_stages_the_tongue_masks_as_the_jax_tool(scene):
    root, _ = scene
    tcams = readers.read_nersemble_scene(
        root, duration=FRAMES, image_loader=readers.make_image_loader(load_tongue=True)
    ).train_cameras
    jcams = jreaders.read_nersemble_scene(
        root, duration=FRAMES, image_loader=jreaders.make_image_loader(load_tongue=True)
    ).train_cameras
    key = lambda c: (c.cam_no, c.frame_no)  # noqa: E731
    tcams, jcams = sorted(tcams, key=key), sorted(jcams, key=key)
    assert [key(c) for c in tcams] == [key(c) for c in jcams]
    for i in range(0, len(tcams), 2):
        got = ttrain.stage_batch(tcams[i:i + 2], False, True, "cpu")["tongue_gt"].numpy()
        want = np.asarray(jtrain.stage_batch(jcams[i:i + 2], FRAMES, False, True)["tongue_gt"])
        assert got.dtype == want.dtype and got.shape == want.shape == (2, 1, H, W)
        np.testing.assert_array_equal(got, want)
        assert want.max() > 0


def test_cli_reports_the_tongue_terms_and_count(scene, trained):
    _, red = scene
    model, (_, _, aux, log) = trained
    assert red == round(N_POINTS * 0.1)
    (events,) = glob.glob(os.path.join(model, "events.out.tfevents.*"))
    rows = read_events(events)
    for tag in TONGUE_TAGS:
        values = [v for _, t, v in rows if t == tag]
        assert len(values) == ITERS and all(np.isfinite(values)), tag
    assert max(v for _, t, v in rows if t == "train_loss_patches/tongue_rgb_loss") > 0
    assert [v for _, t, v in rows if t == "total_tongue_gaussians"] == [red] * ITERS
    assert log["total_tongue"] == [red] * ITERS
    for k in ttrain.TONGUE_TERMS:
        assert len(log[k]) == ITERS and all(np.isfinite(log[k])), k
    assert min(log["tongue_emb"]) > 0 and min(log["wo_tongue_rgb"]) > 0
    assert int((aux.alive & (aux.tongue_class[:, 0] > 0.5)).sum()) == red


def test_jax_scene_reads_the_saved_tongue_class(scene, trained):
    root, red = scene
    model, (_, _, aux, _) = trained
    cfg = j_load_full_config(CONFIG, {"source_path": root, "model_path": model,
                                      "net_width": 32})
    jscene = JScene(cfg.model, cfg.hidden, capacity=256, duration=FRAMES, load_iteration=-1,
                    shuffle=False)
    assert jscene.loaded_iter == ITERS
    alive = aux.alive.numpy()
    jalive = np.asarray(jscene.aux.alive)
    n = int(alive.sum())
    assert int(jalive.sum()) == n
    got = np.asarray(jscene.aux.tongue_class)[:n]
    np.testing.assert_array_equal(got, aux.tongue_class.numpy()[alive])
    assert int(got.sum()) == red
