"""The port's training CLI, `python -m ed3dgs_torch.tools.train`, end to end
on the CPU (`--device cpu`) on a tiny scene from the port's own
`generate_scene`: the files it writes (the JAX tool's layout), its resume
from a `chkpnt<N>.npz`, and the JAX package reading its model.

Bounds: a resumed state is the checkpoint's arrays bit for bit and its Adam
counts continue from the file's; the JAX package's `Scene` (load_iteration)
and `load_deformation` read the port's saved model bit for bit; every loss
is finite and the train PSNR of the last ten iterations is above the first
ten's. The JAX CLI itself is not run here (it costs a jit)."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from ed3dgs_tpu.config.loader import load_full_config as j_load_full_config
from ed3dgs_tpu.data.scene import Scene as JScene
from ed3dgs_tpu.data.scene import flatten_pytree, load_deformation
from ed3dgs_tpu.models.deformation import init_deform_params as j_init_deform
from ed3dgs_tpu.utils.tb_writer import read_events

from ed3dgs_torch import convert
from ed3dgs_torch.data.synthetic import generate_scene
from ed3dgs_torch.tools import train as ttrain
from ed3dgs_torch.train import optim
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, CKPT = 60, 30
SET = ["max_number_gaussians=256", "pair_capacity=16384", "densify_from_iter=10",
       "densify_until_iter=50", "densification_interval=20",
       "densify_grad_threshold_fine_init=0.00002", "densify_grad_threshold_after=0.00002",
       "radegs_regularization_from_iter=0", "random_until=1000000", "min_embeddings=5",
       "max_embeddings=10", "net_width=32", "raster_chunk=32", "deform_from_iter=5"]


def argv(scene, model, *extra):
    return ["-s", scene, "-m", model, "--loader", "dynerf", "--duration", "4",
            "--capacity", "256", "--device", "cpu", "--quiet", "--backend", "pallas",
            "--test_every", "20", *extra, "--set", *SET]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    scene = generate_scene(str(root / "scene"), n_cams=3, n_frames=4, width=48, height=40,
                           n_points=150, seed=0, device="cpu")
    model = str(root / "model")
    run = ttrain.main(argv(scene, model, "--iterations", str(ITERS), "--save_iterations",
                           str(CKPT), str(ITERS), "--checkpoint_iterations", str(CKPT),
                           str(ITERS)))
    return scene, model, run


def test_cli_writes_the_jax_tools_layout(trained):
    scene, model, (_, state, aux, log) = trained
    for rel in ("cfg_args", "training_time.txt", "input.ply", "cameras.json",
                f"chkpnt{CKPT}.npz", f"chkpnt{ITERS}.npz",
                f"point_cloud/iteration_{CKPT}/point_cloud.ply",
                f"point_cloud/iteration_{ITERS}/point_cloud.ply",
                f"point_cloud/iteration_{CKPT}/deformation.npz",
                f"point_cloud/iteration_{ITERS}/deformation.npz"):
        assert os.path.isfile(os.path.join(model, rel)), rel
    lines = open(os.path.join(model, "training_time.txt")).read().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [f"Iteration {CKPT}", f"Iteration {ITERS}"]
    (events,) = glob.glob(os.path.join(model, "events.out.tfevents.*"))
    rows = read_events(events)
    assert {t for _, t, _ in rows} >= {"train_loss_patches/total_loss", "test/psnr",
                                       "total_points", "iter_time"}
    assert sum(t == "train_loss_patches/psnr" for _, t, _ in rows) == ITERS
    assert len(log["loss"]) == ITERS and all(np.isfinite(log["loss"]))
    assert np.mean(log["psnr"][-10:]) > np.mean(log["psnr"][:10])
    assert len(log["densify"]) == 2 and log["points_end"] > log["points_start"]
    assert len(log["test_psnr"]) == 3 and log["decode_ms"] and log["wait_ms"]
    assert state.iteration == ITERS and all(st.count == ITERS for st in state.opt_state.values())


def test_cli_resumes_from_its_checkpoint(trained, monkeypatch):
    """Resume from chkpnt{CKPT} for 5 iterations: the loaded state is the
    file's, and the Adam counts run on from it."""
    scene, model, _ = trained
    ckpt = os.path.join(model, f"chkpnt{CKPT}.npz")
    seen = {}
    orig = ttrain.load_checkpoint

    def keep(*a, **kw):
        res = orig(*a, **kw)
        seen["flat"] = convert.checkpoint_arrays(res[0], res[1])
        return res
    monkeypatch.setattr(ttrain, "load_checkpoint", keep)
    _, state, _, log = ttrain.main(argv(scene, model + "_resume", "--iterations", str(CKPT + 5),
                                        "--start_checkpoint", ckpt, "--no_tensorboard"))
    with np.load(ckpt) as data:
        assert sorted(data.files) == sorted(seen["flat"])
        for k in data.files:
            assert data[k].dtype == seen["flat"][k].dtype, k
            np.testing.assert_array_equal(data[k], seen["flat"][k], err_msg=k)
        assert int(data["iteration"]) == CKPT
    assert log["first_iter"] == CKPT + 1 and len(log["loss"]) == 5
    assert state.iteration == CKPT + 5
    assert all(st.count == CKPT + 5 for st in state.opt_state.values())
    assert not glob.glob(os.path.join(model + "_resume", "events.out.tfevents.*"))


def test_jax_scene_reads_the_ports_model(trained):
    scene, model, (_, state, aux, _) = trained
    cfg = j_load_full_config(None, {"source_path": scene, "model_path": model,
                                    "loader": "dynerf", "net_width": 32})
    jscene = JScene(cfg.model, cfg.hidden, capacity=256, duration=4, load_iteration=-1,
                    shuffle=False)
    assert jscene.loaded_iter == ITERS
    alive = aux.alive.numpy()
    n = int(alive.sum())
    assert int(np.asarray(jscene.aux.alive).sum()) == n
    for name, t in state.params["gaussians"]._asdict().items():
        np.testing.assert_array_equal(np.asarray(getattr(jscene.params, name))[:n],
                                      t.numpy()[alive], err_msg=name)
    import jax
    template = j_init_deform(jax.random.PRNGKey(0), cfg.hidden)
    jdef = jscene.load_deformation(template)
    flat = optim.flatten_params(state.params["deform"])
    for k, v in flatten_pytree(jdef).items():
        np.testing.assert_array_equal(v, flat[k].numpy(), err_msg=k)


def test_cli_entry_point_and_unported_flags(tmp_path):
    """`python -m ed3dgs_torch.tools.train --help` runs without JAX and names
    --device and --backend; a mesh the world cannot hold and --comms strip
    without a mesh raise ValueError (both raised NotImplementedError before
    the multi-device path was ported); the default device needs a GPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys; sys.modules['jax'] = None; import runpy; "
            "sys.argv = ['train', '--help']; "
            "runpy.run_module('ed3dgs_torch.tools.train', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "ignored" in out.stdout
    for extra, what in ((["--mesh", "data=2", "--device", "cpu"], "needs 2 ranks"),
                        (["--comms", "strip"], "--mesh")):
        args = ttrain.parse_args(["-s", str(tmp_path), "-m", str(tmp_path / "m"), *extra])
        with pytest.raises(ValueError, match=what):
            ttrain.run_training(ttrain.build_config(args), args)
    import torch
    if not torch.cuda.is_available():
        args = ttrain.parse_args(["-s", str(tmp_path), "-m", str(tmp_path / "m")])
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.run_training(ttrain.build_config(args), args)
