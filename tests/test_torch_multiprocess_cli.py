"""`ed3dgs_torch.tools.train` on two gloo ranks of the CPU (`--device
cpu`): at `--mesh data=2` (the default comms) and at `--mesh gauss=2
--comms strip`, 10 iterations with one densify, each against one process
on the same scene and flags (tests/test_train_cli_mesh.py's bounds: xyz
atol 2e-4, the deformation `weight` atol 2e-5, the alive mask equal). The
ranks' checkpoints are the single-process format, whole, written by rank 0,
and the JAX package's `load_checkpoint` reads them. One world runs both
meshes (tests/torch_parallel_ranks.py) and must finish within 120 s.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from ed3dgs_tpu.config.loader import load_full_config as j_load_full_config
from ed3dgs_tpu.models import gaussians as jgm
from ed3dgs_tpu.tools.train import load_checkpoint as j_load_checkpoint
from ed3dgs_tpu.train.trainer import init_train_state as j_init_train_state

from ed3dgs_torch import convert
from ed3dgs_torch.data.synthetic import generate_scene
from ed3dgs_torch.parallel.multihost import spawn_world
from ed3dgs_torch.tools import train as ttrain
import torch_parallel_ranks as ranks
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ITERS = 10
SET = ["max_number_gaussians=256", "pair_capacity=16384", "batch_size=2",
       "radegs_regularization_from_iter=1000000", "random_until=1000000",
       "min_embeddings=4", "max_embeddings=8", "net_width=32", "raster_chunk=32",
       "densify_from_iter=3", "densify_until_iter=9", "densification_interval=5",
       "densify_grad_threshold_fine_init=0.00002", "densify_grad_threshold_after=0.00002"]
MESHES = {"data2": ["--mesh", "data=2"], "gauss2_strip": ["--mesh", "gauss=2", "--comms", "strip"]}


def argv(scene, model, *extra):
    return ["-s", scene, "-m", model, "--loader", "dynerf", "--duration", "3",
            "--capacity", "256", "--device", "cpu", "--quiet", "--no_tensorboard",
            "--iterations", str(ITERS), "--checkpoint_iterations", str(ITERS),
            "--save_iterations", str(ITERS), "--test_every", "5", *extra, "--set", *SET]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mpcli")
    scene = generate_scene(str(root / "scene"), n_cams=3, n_frames=3, width=48, height=48,
                           n_points=100, seed=0, device="cpu")
    argvs = [argv(scene, str(root / name), *flags) for name, flags in MESHES.items()]
    # the two ranks run while this process trains alone
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn_world, ranks.cli_rank, 2, args=(argvs,), deadline_s=120)
        _, state, aux, log = ttrain.main(argv(scene, str(root / "single")))
        single = (convert.checkpoint_arrays(state, aux), log)
        meshed = dict(zip(MESHES, world.result()[0]))
    return scene, root, single, meshed


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_cli_matches_one_process(runs, mesh):
    scene, root, (want, wlog), meshed = runs
    got, log = meshed[mesh]
    assert len(wlog["densify"]) == len(log["densify"]) == 1
    assert log["densify"] == wlog["densify"]
    assert (log["points_start"], log["points_end"]) == (wlog["points_start"],
                                                        wlog["points_end"])
    np.testing.assert_array_equal(got["aux/alive"], want["aux/alive"])
    np.testing.assert_allclose(got["params/gaussians/xyz"], want["params/gaussians/xyz"],
                               atol=2e-4)
    np.testing.assert_allclose(got["params/deform/weight"], want["params/deform/weight"],
                               atol=2e-5)
    assert len(log["test_psnr"]) == 2 and np.isfinite(log["loss"]).all()
    np.testing.assert_allclose(log["loss"], wlog["loss"], rtol=2e-4)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_cli_checkpoint_is_whole_and_loads_in_jax(runs, mesh):
    """Rank 0 wrote the whole checkpoint (capacity rows, single-process
    keys); the JAX package's load_checkpoint restores it."""
    scene, root, (want, _), meshed = runs
    path = os.path.join(root, mesh, f"chkpnt{ITERS}.npz")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    assert sorted(flat) == sorted(want)
    assert flat["params/gaussians/xyz"].shape == (256, 3)
    np.testing.assert_array_equal(flat["params/gaussians/xyz"],
                                  meshed[mesh][0]["params/gaussians/xyz"])
    cfg = j_load_full_config(None, {"source_path": scene, "model_path": str(root / mesh),
                                    "loader": "dynerf",
                                    **{k: json.loads(v) for k, v in
                                       (kv.split("=") for kv in SET)}})
    params, aux = jgm.create_from_points(np.zeros((4, 3), np.float32),
                                         np.zeros((4, 3), np.float32), capacity=256)
    template, _ = j_init_train_state(params, cfg.hidden, cfg.opt, 1.0)
    state, jaux, next_iter = j_load_checkpoint(path, template, aux)
    assert next_iter == ITERS + 1
    np.testing.assert_array_equal(np.asarray(state.params["gaussians"].xyz),
                                  flat["params/gaussians/xyz"])
    np.testing.assert_array_equal(np.asarray(state.params["deform"]["weight"]),
                                  flat["params/deform/weight"])
    np.testing.assert_array_equal(np.asarray(jaux.alive), flat["aux/alive"])
