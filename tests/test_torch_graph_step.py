"""The capture-ready train step (`trainer.GraphedTrainStep`), run eagerly on
the CPU, against the port's eager step and ed3dgs_tpu's jitted step.

On the card `make_train_step` replays a CUDA graph captured per key; the
CPU has no graphs, so on a CPU state it runs the same path without
capturing it: the inputs copied into static buffers, the update's
schedule and bias corrections and the iteration read from a device table,
the results written back into the static buffers. On the tiny scene of
tests/test_torch_trajectory.py (3 cameras, cam00 held out, 2 frames, 40x32)
six steps from iteration 997 cross the SH degree 0 -> 1 (iteration 1000),
the depth-normal term (on from 1001 here) and SSIM on and off (even steps),
with a densify after step 2 (eager for the eager run, the graphed densify
step's path for the other) followed by both refreshes (the 3D filter and a
new KNN cache, copied in). Each step's metrics, parameters, Adam moments
and aux statistics must equal the eager step's bit for bit; the losses and
parameters must stay within test_torch_trajectory.py's bounds of the JAX
step (loss rtol 5e-5 at every step; per optimizer group, in units of its
learning rate, RMS at most 0.1 and no entry past 2 x steps). While the path
runs, a host read of a tensor (`item`, `__bool__`, `__int__`, `__float__`,
`__index__`, `tolist`) raises, except inside the blend kernels' plain
versions, whose loops stand in for the kernels. The key's branches must be
the ones the eager step takes; a NerSemble run meets 7 keys."""

import dataclasses
import math
import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.config.params import OptimizationConfig as JOpt
from ed3dgs_tpu.data import readers as jreaders
from ed3dgs_tpu.data.scene import flatten_pytree
from ed3dgs_tpu.models import gaussians as jgm
from ed3dgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ed3dgs_tpu.train import trainer as jtrainer

from ed3dgs_torch import convert
from ed3dgs_torch.config.loader import load_full_config
from ed3dgs_torch.config.params import DeformHiddenConfig, OptimizationConfig
from ed3dgs_torch.data import readers
from ed3dgs_torch.data.synthetic import generate_scene
from ed3dgs_torch.models import gaussians as tgm
from ed3dgs_torch.ops.rasterize import RasterConfig
from ed3dgs_torch.train import losses as L
from ed3dgs_torch.train import optim, trainer
from ed3dgs_torch.train.sampling import CameraSampler

from test_torch_densify import jax_noise
from test_torch_train import hidden_config, setup_kw, torch_batch
from test_torch_trajectory import (CAP, EXTENT, FRAMES, H, LOSS_REL, PERCENT_DENSE, RMS_LR,
                                   STEPS, W, batch_of, densify_threshold, filter_args,
                                   group_report, raster_kw, schedule)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

START, DEPTH_NORMAL_FROM, DENSIFY_AFTER = 997, 1001, 2
NERSEMBLE_KEYS = 7


def ssim_on(s):
    return s % 2 == 0


def batch_at(cams, s):
    """Step s's batch (test_torch_trajectory.py's): the scene's frames sit
    at t = 0, the temporal table's first row, and t = 0.5, a whole row of
    the 41-row table before iteration 1000."""
    return batch_of(cams, ssim_on(s))


def jax_run(info):
    cams = info.train_cameras
    pts, cols, _ = info.point_cloud
    params, aux = jgm.create_from_points(pts, cols, capacity=CAP)
    # anisotropic scales: create_from_points makes every Gaussian a sphere,
    # and below deform_from_iter + 1000 the deformation's scale term is
    # (partly) off, so a rotation's gradient would be zero up to rounding,
    # which Adam turns into a step of +-lr in either package
    stretch = np.random.default_rng(11).normal(0.0, 0.4, params.scaling.shape)
    params = params._replace(scaling=params.scaling + jnp.asarray(stretch, jnp.float32))
    aux = aux._replace(filter_3d=jgm.compute_3d_filter(params.xyz, aux.alive,
                                                       *filter_args(cams, jnp.asarray)))
    state, optimizer = jtrainer.init_train_state(params, hidden_config(), JOpt(), 1.0, seed=3)
    state = state._replace(iteration=jnp.int32(START))
    start = (state, aux)
    setup = jtrainer.TrainSetup(
        raster=JRasterConfig(backend="pallas", interpret=True, **raster_kw(cams)),
        hidden=hidden_config(), **setup_kw(reg_coef=1.0, radegs_from_iter=DEPTH_NORMAL_FROM))
    step = jtrainer.make_train_step(setup, JOpt(), optimizer, jit=True)
    densify = jtrainer.make_densify_step(JOpt(), PERCENT_DENSE, EXTENT)
    cache = jtrainer.update_knn_cache(state.params["gaussians"], aux)
    losses, extra = [], {}
    for s, batch_cams in enumerate(schedule(cams)):
        b = batch_at(batch_cams, s)
        state, aux, m = step(state, aux, {k: jnp.asarray(v) for k, v in b.items()}, cache)
        losses.append(float(m["loss"]))
        if s == DENSIFY_AFTER:
            key = jax.random.PRNGKey(7)
            thr = densify_threshold(aux)
            state, aux, n_c, n_s = densify(state, aux, key, thr)
            aux = aux._replace(filter_3d=jgm.compute_3d_filter(
                state.params["gaussians"].xyz, aux.alive, *filter_args(cams, jnp.asarray)))
            cache = jtrainer.update_knn_cache(state.params["gaussians"], aux)
            extra = dict(thr=thr, noise=jax_noise(key, CAP), counts=(int(n_c), int(n_s)))
    return start, losses, flatten_pytree(state.params), extra


_PLAIN = frozenset({"rasterize_forward_plain", "rasterize_backward_plain"})
_READS = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist")


class HostReadGuard:
    """While active, a host read of a tensor raises, unless a blend
    kernel's plain version (its loops stand in for the kernel) made it."""

    def __init__(self):
        self.orig = {name: getattr(torch.Tensor, name) for name in _READS}
        self.active = False

    def _guarded(self, name):
        orig = self.orig[name]

        def read(t, *a, **k):
            if self.active:
                f = sys._getframe(1)
                while f is not None and f.f_code.co_name not in _PLAIN:
                    f = f.f_back
                if f is None:
                    raise AssertionError(f"host read Tensor.{name} in the capture-ready step")
            return orig(t, *a, **k)
        return read

    def __enter__(self):
        for name in _READS:
            setattr(torch.Tensor, name, self._guarded(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(torch.Tensor, name, fn)


class BranchRecorder:
    """The branches an eager step takes, read off the functions it calls."""

    def __init__(self, monkeypatch):
        self.seen = {}
        for mod, name, what in ((L, "ssim", "ssim"), (L, "depth_normal_loss", "depth_normal"),
                                (L, "colmap_pcd_loss", "colmap")):
            orig = getattr(mod, name)
            monkeypatch.setattr(mod, name, self._mark(orig, what))
        orig_render = trainer.render

        def render(*a, active_sh_degree=None, **k):
            self.seen["sh"] = active_sh_degree
            return orig_render(*a, active_sh_degree=active_sh_degree, **k)
        monkeypatch.setattr(trainer, "render", render)

    def _mark(self, fn, what):
        def call(*a, **k):
            self.seen[what] = True
            return fn(*a, **k)
        return call

    def take(self):
        seen, self.seen = self.seen, {}
        return trainer.StepBranches(active_sh_degree=seen["sh"], use_ssim="ssim" in seen,
                                    depth_normal="depth_normal" in seen, colmap="colmap" in seen)


def assert_trees_equal(a: dict, b: dict, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (what, k)


def state_tensors(state, aux) -> dict:
    out = {f"params/{k}": v for k, v in optim.flatten_params(state.params).items()}
    for g, st in state.opt_state.items():
        out.update({f"mu/{g}/{k}": v for k, v in st.mu.items()})
        out.update({f"nu/{g}/{k}": v for k, v in st.nu.items()})
    out.update({f"aux/{k}": v for k, v in aux._asdict().items()})
    return out


def port_runs(info, start, extra, monkeypatch):
    """The eager step and the capture-ready path side by side from the JAX
    run's starting state; checks them equal after every step and returns
    the capture-ready run's losses, final parameters, densify counts, keys
    and the eager step's branches."""
    jstate, jaux = start
    cams = info.train_cameras
    fields = {k: np.asarray(v) for k, v in {**jstate.params["gaussians"]._asdict(),
                                            **jaux._asdict()}.items()}
    params, aux = tgm.from_numpy(fields, device="cpu")
    deform = convert.deform_from_flat(flatten_pytree(jstate.params["deform"]), device="cpu")
    optimizer = optim.build_optimizer(OptimizationConfig(), 1.0)
    state = optim.TrainState({"gaussians": params, "deform": deform}, None, START)
    state = state._replace(opt_state=optimizer.init(state.params))
    setup = trainer.TrainSetup(raster=RasterConfig(**raster_kw(cams)),
                               hidden=DeformHiddenConfig(**dataclasses.asdict(hidden_config())),
                               **setup_kw(reg_coef=1.0, radegs_from_iter=DEPTH_NORMAL_FROM))
    eager = trainer.make_train_step(setup, optimizer, graph=False)
    graphed = trainer.make_train_step(setup, optimizer)
    assert isinstance(graphed, trainer.GraphedTrainStep)
    e_densify = trainer.make_densify_step(OptimizationConfig(), PERCENT_DENSE, EXTENT,
                                          graph=False)
    g_densify = trainer.make_densify_step(OptimizationConfig(), PERCENT_DENSE, EXTENT)
    cache = trainer.update_knn_cache(state.params["gaussians"], aux)
    branches = BranchRecorder(monkeypatch)
    guard = HostReadGuard()
    e_state, e_aux, g_state, g_aux = state, aux, state, aux
    e_cache = g_cache = cache
    losses, keys, taken, counts = [], [], [], None
    with guard:
        for s, batch_cams in enumerate(schedule(cams)):
            b = torch_batch(batch_at(batch_cams, s))
            branches.seen = {}
            e_state, e_aux, em = eager(e_state, e_aux, b, e_cache)
            taken.append(branches.take())
            keys.append(graphed.key(g_state, g_aux, b, g_cache))
            guard.active = True
            try:
                g_state, g_aux, gm_ = graphed(g_state, g_aux, b, g_cache)
            finally:
                guard.active = False
            assert e_state.iteration == g_state.iteration == START + s + 1
            assert_trees_equal(em, gm_, f"metrics of step {s}")
            assert_trees_equal(state_tensors(e_state, e_aux), state_tensors(g_state, g_aux),
                               f"state after step {s}")
            losses.append(float(gm_["loss"]))
            if s == DENSIFY_AFTER:
                noise = torch.as_tensor(extra["noise"])
                e_state, e_aux, n_c, n_s = e_densify(e_state, e_aux, None, extra["thr"],
                                                     noise=noise)
                guard.active = True      # the graphed densify reads nothing either
                try:
                    g_state, g_aux, _, _ = g_densify(g_state, g_aux, None, extra["thr"],
                                                     noise=noise)
                finally:
                    guard.active = False
                counts = (int(n_c), int(n_s))
                fa = filter_args(cams, torch.as_tensor)
                e_aux = e_aux._replace(filter_3d=tgm.compute_3d_filter(
                    e_state.params["gaussians"].xyz, e_aux.alive, *fa))
                g_aux = g_aux._replace(filter_3d=tgm.compute_3d_filter(
                    g_state.params["gaussians"].xyz, g_aux.alive, *fa))
                e_cache = trainer.update_knn_cache(e_state.params["gaussians"], e_aux)
                g_cache = trainer.update_knn_cache(g_state.params["gaussians"], g_aux)
                assert g_cache.graph.rev_pair.shape[0] < g_cache.graph.nbr.numel()
    flat = {k: v.numpy() for k, v in optim.flatten_params(g_state.params).items()}
    return losses, flat, counts, keys, taken


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = generate_scene(str(tmp_path_factory.mktemp("graph") / "scene"), n_cams=3,
                          n_frames=FRAMES, width=W, height=H, n_points=200, seed=4, device="cpu")
    jinfo = jreaders.read_dynerf_scene(root, duration=FRAMES,
                                       image_loader=jreaders.make_image_loader())
    tinfo = readers.read_dynerf_scene(root, duration=FRAMES,
                                      image_loader=readers.make_image_loader())
    start, jlosses, jparams, extra = jax_run(jinfo)
    with pytest.MonkeyPatch.context() as mp:
        port = port_runs(tinfo, start, extra, mp)
    return jlosses, jparams, extra, port


def test_capture_ready_path_equals_the_eager_step(runs):
    """(checked step by step inside the run) and reaches every branch."""
    *_, (losses, _, counts, keys, _) = runs
    assert len(losses) == STEPS and counts[0] + counts[1] > 0
    branches = [k[0] for k in keys]
    assert {b.active_sh_degree for b in branches} == {0, 1}
    assert {b.use_ssim for b in branches} == {False, True}
    assert {b.depth_normal for b in branches} == {False, True}


def test_capture_ready_path_stays_within_the_jax_bounds(runs):
    jlosses, jparams, extra, (tlosses, tparams, counts, _, _) = runs
    assert counts == extra["counts"]
    for s, (a, b) in enumerate(zip(tlosses, jlosses)):
        assert math.isfinite(a) and abs(a - b) <= LOSS_REL * abs(b), (s, a, b)
    for g, (rms, worst) in group_report(jparams, tparams).items():
        assert rms <= RMS_LR and worst <= 2 * STEPS, (g, rms, worst)


def test_key_is_the_branches_the_eager_step_takes(runs):
    *_, (_, _, _, keys, taken) = runs
    assert [k[0] for k in keys] == taken
    # one input signature until the densify, one after (the new KNN graph
    # keeps Cp and K: the padded reverse list keeps the shapes)
    assert len({k[1] for k in keys}) == 1
    assert len(set(keys)) == len(set(taken))


def test_nersemble_run_meets_seven_keys():
    """The branches of every iteration of configs/nersemble/default.py
    (80,000 iterations, SH 3, SSIM from 10,000 on five of every 50,
    depth-normal from 15,000, no COLMAP supervision), as tools/train.py
    samples them: SH 0, 1 and 2 without SSIM, then SH 3 with each SSIM
    gate before and after the depth-normal term."""
    cfg = load_full_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "nersemble", "default.py"))
    opt, model = cfg.opt, cfg.model
    setup = trainer.TrainSetup(raster=None, hidden=cfg.hidden, batch_size=opt.batch_size,
                               radegs_from_iter=opt.radegs_regularization_from_iter,
                               sh_degree=model.sh_degree,
                               colmap_supervision=model.colmap_supervision_enabled,
                               deform_from_iter=cfg.hidden.deform_from_iter)
    centers = np.stack([np.cos(np.arange(16) * 0.4), np.sin(np.arange(16) * 0.4),
                        np.zeros(16)], 1)
    sampler = CameraSampler(num_cams=16, maxtime=opt.maxtime, camera_centers=centers,
                            batch_size=opt.batch_size, random_until=opt.random_until,
                            num_multiview_ssim=opt.num_multiview_ssim, seed=0)
    keys = set()
    for iteration in range(1, opt.iterations + 1):   # the tool's loop; the state's count
        _, _, use_ssim = sampler.sample(iteration, opt.iterations)   # is iteration - 1
        keys.add(trainer.step_branches(setup, iteration - 1,
                                       {"use_ssim": use_ssim, "pcd_valid": True}))
    assert len(keys) == NERSEMBLE_KEYS, sorted(keys)
    assert {(k.active_sh_degree, k.use_ssim, k.depth_normal) for k in keys} == {
        (0, False, False), (1, False, False), (2, False, False), (3, False, False),
        (3, True, False), (3, False, True), (3, True, True)}


@pytest.mark.parametrize("count", [1, 2, 999, 1000, 79_999])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_update_table_is_the_schedule_bit_for_bit(count, device):
    """The table the captured update reads: minus each group's learning
    rate and the two bias corrections at this count (their float32
    reciprocals for the card, where the eager update multiplies by them)."""
    optimizer = optim.build_optimizer(OptimizationConfig(), 2.5)
    opt_state = {g: optim.AdamState(count, {}, {}) for g in optim.GROUPS}
    table = optimizer.update_table(opt_state, device)
    assert table.dtype == torch.float32 and table.shape == (len(optim.GROUPS), 3)
    for i, g in enumerate(optim.GROUPS):
        want = [-optimizer.schedules[g](count), optim._bias_correction(optim.B1, count + 1),
                optim._bias_correction(optim.B2, count + 1)]
        if device == "cuda":
            want[1:] = [torch.tensor(np.float32(1) / np.float32(x.item())) for x in want[1:]]
        got = table[i].numpy().view(np.int32)
        assert list(got) == [int(np.float32(w.item()).view(np.int32)) for w in want], (g, count)


def test_update_with_the_table_equals_the_update():
    rng = np.random.default_rng(0)
    params = {"gaussians": tgm.GaussianParams(*(torch.as_tensor(
        rng.normal(size=s).astype(np.float32)) for s in
        ((5, 3), (5, 1, 3), (5, 15, 3), (5, 3), (5, 4), (5, 1), (5, 8)))),
        "deform": {"weight": torch.as_tensor(rng.normal(size=(4, 6)).astype(np.float32)),
                   "offsets": torch.zeros(3, 1)}}
    optimizer = optim.build_optimizer(OptimizationConfig(), 1.0)
    opt_state = optimizer.init(params)
    opt_state = {g: st._replace(count=998) for g, st in opt_state.items()}
    grads = {k: torch.as_tensor(rng.normal(size=v.shape).astype(np.float32))
             for k, v in optim.flatten_params(params).items()}
    p1, s1 = optimizer.update(grads, opt_state, params)
    p2, s2 = optimizer.update(grads, opt_state, params,
                              table=optimizer.update_table(opt_state, "cpu"))
    assert_trees_equal(optim.flatten_params(p1), optim.flatten_params(p2), "params")
    for g in optim.GROUPS:
        assert s1[g].count == s2[g].count == 999
        assert_trees_equal(s1[g].mu, s2[g].mu, g)
        assert_trees_equal(s1[g].nu, s2[g].nu, g)


def test_graph_on_a_gloo_mesh_on_the_card_raises():
    """A mesh's graphed step is made on any backend; on the card over gloo
    (which runs its collectives on the host, so a graph cannot hold them)
    its first call raises before it copies, runs or captures anything,
    naming graph=False. The CPU runs the path eagerly, and NCCL captures:
    neither raises. Checked from the setup and the backend alone (no card
    here): the call's aux says the card."""
    gloo = types.SimpleNamespace(shape={"data": 2, "gauss": 1}, d=0, g=0, backend="gloo")
    setup = trainer.TrainSetup(raster=None, hidden=DeformHiddenConfig(), batch_size=2,
                               mesh=gloo)
    step = trainer.make_train_step(setup, None)
    assert isinstance(step, trainer.GraphedTrainStep)
    on_card = types.SimpleNamespace(
        alive=types.SimpleNamespace(is_cuda=True, device=torch.device("cuda", 0)))
    with pytest.raises(ValueError, match=r"gloo.*pass graph=False"):
        step(None, on_card, None, None)
    assert step.graphs is None and step.static is None
    with pytest.raises(ValueError, match="graph=False"):
        trainer.check_capturable(setup, "cuda")
    trainer.check_capturable(setup, "cpu")
    nccl = dataclasses.replace(setup, mesh=types.SimpleNamespace(**{**vars(gloo),
                                                                    "backend": "nccl"}))
    trainer.check_capturable(nccl, "cuda")
    trainer.check_capturable(dataclasses.replace(setup, mesh=None), "cuda")
