"""Six library-level training steps of ed3dgs_torch against ed3dgs_tpu's,
both on the CPU, on a tiny synthetic scene on disk (the port's
`generate_scene`: 3 cameras, cam00 held out, 2 frames, 40x32), each package
reading it with its own readers (images through PIL and through the port's
PNG codec) and starting from the JAX package's `create_from_points` of its
init ply and its deformation weights, at reg_coef = 1 from iteration 20,000
(deformation, SH 3 and depth-normal live). Steps 0-2, one densification
(the JAX draws normal(ka/kb) handed to the port as `noise`, as
tests/test_torch_densify.py does) followed by both refreshes (the 3D filter
and the KNN graph cache, each package its own), then steps 3-5. The JAX
step is jitted, as its trainer runs it.

Bounds: the loss at every step at rtol 5e-5 (a single step is held at 1e-5,
tests/test_torch_train.py; after the densify the split children sit
apart by the packages' rounding, ~1e-5 of the loss). Each optimizer group
after the last step, in units of its learning rate: the RMS difference at
most 0.1 and no entry further than 2 x steps. Adam moves an entry by about
lr a step whatever its gradient's size, so an entry whose gradient is zero
up to rounding may move the other way in one package (~2 lr apart); the
RMS bounds how many do. The densification clones and splits the same
Gaussians. A control run of the port whose batch at step 2 sees one
camera moved by 5 cm must miss the loss bound from step 2 on and the
parameter bound."""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.config.params import OptimizationConfig as JOpt
from ed3dgs_tpu.data import readers as jreaders
from ed3dgs_tpu.data.cameras import look_at_camera
from ed3dgs_tpu.data.scene import flatten_pytree
from ed3dgs_tpu.models import gaussians as jgm
from ed3dgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ed3dgs_tpu.train import trainer as jtrainer

from ed3dgs_torch import convert
from ed3dgs_torch.config.params import DeformHiddenConfig, OptimizationConfig
from ed3dgs_torch.data import readers
from ed3dgs_torch.data.synthetic import generate_scene
from ed3dgs_torch.models import gaussians as tgm
from ed3dgs_torch.ops.rasterize import RasterConfig
from ed3dgs_torch.train import optim, trainer

from test_torch_densify import jax_noise
from test_torch_train import ITERATION, hidden_config, setup_kw, torch_batch
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H, CAP, FRAMES = 40, 32, 320, 2
STEPS, DENSIFY_AFTER, CONTROL_STEP = 6, 2, 2
LOSS_REL = 5e-5
RMS_LR = 0.1
PERCENT_DENSE, EXTENT = 0.01, 2.5


def schedule(cams):
    """Step s's batch: the two training cameras in turn, at frame s % 2."""
    by_key = {(c.cam_no, c.frame_no): c for c in cams}
    ids = sorted({c.cam_no for c in cams})
    return [[by_key[(ids[(s + i) % len(ids)], s % FRAMES)] for i in range(2)]
            for s in range(STEPS)]


def batch_of(cams, use_ssim):
    mats = [c.matrices() for c in cams]
    return {"gt_image": np.stack([c.image for c in cams]).astype(np.float32),
            "viewmatrix": np.stack([m.world_view for m in mats]),
            "projmatrix": np.stack([m.full_proj for m in mats]),
            "campos": np.stack([m.campos for m in mats]),
            "time": np.array([c.time for c in cams], np.float32),
            "cam_no": np.array([c.cam_no for c in cams], np.int32),
            "use_ssim": use_ssim}


def moved_camera_batch(batch, cam):
    """The batch with camera 0 moved 5 cm along its own x axis."""
    c2w = np.linalg.inv(cam.matrices().world_view)
    eye = c2w[:3, 3] + 0.05 * c2w[:3, 0]
    moved = look_at_camera(eye, eye + c2w[:3, 2], -c2w[:3, 1], cam.fovx, cam.fovy, W,
                           H).matrices()
    out = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in batch.items()}
    out["viewmatrix"][0], out["projmatrix"][0] = moved.world_view, moved.full_proj
    out["campos"][0] = moved.campos
    return out


def filter_args(cams, xp):
    mats = [c.matrices() for c in cams if c.frame_no == 0]
    return (xp(np.stack([m.world_view for m in mats])),
            xp(np.array([m.focal_x for m in mats], np.float32)),
            xp(np.array([m.focal_y for m in mats], np.float32)),
            xp(np.array([float(m.width) for m in mats], np.float32)),
            xp(np.array([float(m.height) for m in mats], np.float32)))


def raster_kw(cams):
    m = cams[0].matrices()
    return dict(width=W, height=H, focal_x=m.focal_x, focal_y=m.focal_y,
                pair_capacity=1 << 13, chunk=32)


def densify_threshold(jaux):
    """The midpoint of the widest gap between neighbouring densification
    statistics in their middle third, so that no Gaussian sits near it."""
    alive = np.asarray(jaux.alive) & (np.asarray(jaux.denom) > 0)
    g = np.sort((np.asarray(jaux.xyz_grad_accum) / np.maximum(np.asarray(jaux.denom), 1))[alive])
    lo, hi = len(g) // 3, 2 * len(g) // 3
    i = lo + int(np.argmax(g[lo + 1:hi] / g[lo:hi - 1]))
    return float((g[i] + g[i + 1]) / 2)


def jax_run(info):
    cams = info.train_cameras
    pts, cols, _ = info.point_cloud
    params, aux = jgm.create_from_points(pts, cols, capacity=CAP)
    aux = aux._replace(filter_3d=jgm.compute_3d_filter(params.xyz, aux.alive,
                                                       *filter_args(cams, jnp.asarray)))
    state, optimizer = jtrainer.init_train_state(params, hidden_config(), JOpt(), 1.0, seed=3)
    state = state._replace(iteration=jnp.int32(ITERATION))
    start = (state, aux)
    setup = jtrainer.TrainSetup(
        raster=JRasterConfig(backend="pallas", interpret=True, **raster_kw(cams)),
        hidden=hidden_config(), **setup_kw(reg_coef=1.0))
    step = jtrainer.make_train_step(setup, JOpt(), optimizer, jit=True)
    densify = jtrainer.make_densify_step(JOpt(), PERCENT_DENSE, EXTENT)
    cache = jtrainer.update_knn_cache(state.params["gaussians"], aux)
    losses, extra = [], {}
    for s, batch_cams in enumerate(schedule(cams)):
        b = batch_of(batch_cams, s % 2 == 0)
        state, aux, m = step(state, aux, {k: jnp.asarray(v) for k, v in b.items()}, cache)
        losses.append(float(m["loss"]))
        if s == DENSIFY_AFTER:
            key = jax.random.PRNGKey(7)
            thr = densify_threshold(aux)
            state, aux, n_c, n_s = densify(state, aux, key, thr)
            aux = aux._replace(filter_3d=jgm.compute_3d_filter(
                state.params["gaussians"].xyz, aux.alive, *filter_args(cams, jnp.asarray)))
            cache = jtrainer.update_knn_cache(state.params["gaussians"], aux)
            extra = dict(thr=thr, noise=jax_noise(key, CAP), counts=(int(n_c), int(n_s)),
                         alive=np.asarray(aux.alive))
    return start, losses, flatten_pytree(state.params), extra


def port_run(info, start, extra, control=False):
    """The port's run from the JAX run's starting state, on the port's own
    reading of the scene."""
    jstate, jaux = start
    cams = info.train_cameras
    fields = {k: np.asarray(v) for k, v in {**jstate.params["gaussians"]._asdict(),
                                            **jaux._asdict()}.items()}
    params, aux = tgm.from_numpy(fields, device="cpu")
    deform = convert.deform_from_flat(flatten_pytree(jstate.params["deform"]), device="cpu")
    optimizer = optim.build_optimizer(OptimizationConfig(), 1.0)
    state = optim.TrainState({"gaussians": params, "deform": deform}, None, ITERATION)
    state = state._replace(opt_state=optimizer.init(state.params))
    setup = trainer.TrainSetup(raster=RasterConfig(**raster_kw(cams)),
                               hidden=DeformHiddenConfig(**dataclasses.asdict(hidden_config())),
                               **setup_kw(reg_coef=1.0))
    step = trainer.make_train_step(setup, optimizer)
    densify = trainer.make_densify_step(OptimizationConfig(), PERCENT_DENSE, EXTENT)
    cache = trainer.update_knn_cache(state.params["gaussians"], aux)
    losses, counts, alive = [], None, None
    for s, batch_cams in enumerate(schedule(cams)):
        b = batch_of(batch_cams, s % 2 == 0)
        if control and s == CONTROL_STEP:
            b = moved_camera_batch(b, batch_cams[0])
        state, aux, m = step(state, aux, torch_batch(b), cache)
        losses.append(float(m["loss"]))
        if s == DENSIFY_AFTER:
            state, aux, n_c, n_s = densify(state, aux, None, extra["thr"],
                                           noise=torch.as_tensor(extra["noise"]))
            counts, alive = (int(n_c), int(n_s)), aux.alive.numpy().copy()
            aux = aux._replace(filter_3d=tgm.compute_3d_filter(
                state.params["gaussians"].xyz, aux.alive, *filter_args(cams, torch.as_tensor)))
            cache = trainer.update_knn_cache(state.params["gaussians"], aux)
    flat = {k: v.numpy() for k, v in optim.flatten_params(state.params).items()}
    return losses, flat, counts, alive


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    root = generate_scene(str(tmp_path_factory.mktemp("traj") / "scene"), n_cams=3,
                          n_frames=FRAMES, width=W, height=H, n_points=200, seed=4, device="cpu")
    jinfo = jreaders.read_dynerf_scene(root, duration=FRAMES,
                                       image_loader=jreaders.make_image_loader())
    tinfo = readers.read_dynerf_scene(root, duration=FRAMES,
                                      image_loader=readers.make_image_loader())
    start, jlosses, jparams, extra = jax_run(jinfo)
    faithful = port_run(tinfo, start, extra)
    control = port_run(tinfo, start, extra, control=True)
    return jlosses, jparams, extra, faithful, control


def learning_rates():
    """Each group's learning rate at the run's last count (the schedules
    barely move over six updates)."""
    sched = optim.build_optimizer(OptimizationConfig(), 1.0).schedules
    return {g: float(sched[g](STEPS)) for g in optim.GROUPS}


def group_report(jparams, tparams):
    """{optimizer group: (RMS, largest) |diff| / the group's learning rate}."""
    labels = optim.flatten_params(optim.param_labels(
        optim.unflatten_params({k: torch.zeros(1) for k in jparams})))
    lrs = learning_rates()
    out = {}
    for g in optim.GROUPS:
        d = np.concatenate([(tparams[k] - jparams[k]).ravel()
                            for k in jparams if labels[k] == g]) / lrs[g]
        out[g] = (float(np.sqrt(np.mean(d * d))), float(np.abs(d).max()))
    return out


def test_losses_stay_within_bound_every_step(trajectories):
    jlosses, _, _, (tlosses, *_), _ = trajectories
    assert len(tlosses) == len(jlosses) == STEPS
    for s, (a, b) in enumerate(zip(tlosses, jlosses)):
        assert math.isfinite(a) and abs(a - b) <= LOSS_REL * abs(b), (s, a, b)


def test_densify_and_parameters_stay_within_bound(trajectories):
    _, jparams, extra, (_, tparams, counts, alive), _ = trajectories
    assert counts == extra["counts"] and counts[0] + counts[1] > 0
    np.testing.assert_array_equal(alive, extra["alive"])
    for g, (rms, worst) in group_report(jparams, tparams).items():
        assert rms <= RMS_LR and worst <= 2 * STEPS, (g, rms, worst)


def test_control_with_a_moved_camera_misses_the_bounds(trajectories):
    jlosses, jparams, _, _, (closses, cparams, _, _) = trajectories
    assert all(abs(a - b) <= LOSS_REL * abs(b)
               for a, b in zip(closses[:CONTROL_STEP], jlosses[:CONTROL_STEP]))
    for s in range(CONTROL_STEP, STEPS):
        assert abs(closses[s] - jlosses[s]) > LOSS_REL * abs(jlosses[s]), s
    assert max(rms for rms, _ in group_report(jparams, cparams).values()) > RMS_LR
