"""Rank bodies of the port's multi-process tests (a helper module: it holds
no test of its own).

`ed3dgs_torch.parallel.multihost.spawn_world` starts them in gloo worlds of
spawned processes on the CPU; each returns numpy arrays to the test process,
which holds them against the port's single-process results and the JAX
package's. This module imports neither JAX nor the JAX package, so a rank
starts in the time torch takes to import. Every rank runs on one torch
thread: the suite's workers already share the machine's cores.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ed3dgs_torch.core.projection import project_gaussians
from ed3dgs_torch.data.cameras import look_at_camera
from ed3dgs_torch.ops.binning import build_gaussian_payload
from ed3dgs_torch.ops.rasterize import RasterConfig, rasterize
from ed3dgs_torch.parallel import comm
from ed3dgs_torch.parallel.mesh import Mesh

# --- the scene of tests/test_tile_sharded.py ----------------------------------

TS_W, TS_H = 64, 48      # a 4 x 3 tile grid: with 4 strips the last is padding only


def strip_scene(n=120, cap=128, seed=0):
    """numpy arrays of tests/test_tile_sharded.py's `build`: the cloud, its
    tongue classes and validity mask, and the camera's matrices."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(1.5, 3.0, n)], 1).astype(np.float32)
    means = np.pad(means, ((0, cap - n), (0, 0)))
    scales = np.exp(rng.normal(-2.2, 0.4, (cap, 3))).astype(np.float32)
    q = rng.normal(size=(cap, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.2, 0.9, cap).astype(np.float32)
    shs = (rng.normal(0, 0.3, (cap, 16, 3))
           * np.array([2.0] + [0.2] * 15)[None, :, None]).astype(np.float32)
    tongue = (rng.uniform(0, 1, cap) > 0.7).astype(np.float32)
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return dict(means=means, scales=scales, q=q, opac=opac, shs=shs, tongue=tongue,
                mask=mask)


def strip_camera(eye=(0, 0, 0)):
    fov = math.radians(60.0)
    return look_at_camera(eye, (0, 0, 2.0), (0, -1, 0), fov,
                          2 * math.atan(math.tan(fov / 2) * TS_H / TS_W), TS_W, TS_H).matrices()


def strip_config(cam, pair_capacity=1 << 11):
    return RasterConfig(width=TS_W, height=TS_H, focal_x=cam.focal_x, focal_y=cam.focal_y,
                        pair_capacity=pair_capacity, chunk=32)


def project_rows(sc, rows, cam, means=None, opac=None, shs=None):
    """The port's projection of the scene's rows `rows` (a slice)."""
    t = {k: torch.as_tensor(v[rows]) for k, v in sc.items()}
    f32 = dict(dtype=torch.float32)
    return project_gaussians(
        t["means"] if means is None else means, t["scales"], t["q"],
        t["opac"] if opac is None else opac, t["shs"] if shs is None else shs,
        viewmatrix=torch.as_tensor(cam.world_view, **f32),
        projmatrix=torch.as_tensor(cam.full_proj, **f32),
        campos=torch.as_tensor(cam.campos, **f32), width=TS_W, height=TS_H,
        tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, focal_x=cam.focal_x,
        focal_y=cam.focal_y, kernel_size=0.1, sh_degree=3, mask=t["mask"])


def image_loss(out, tgt):
    """tests/test_tile_sharded.py's gradient loss."""
    return (torch.mean(torch.abs(out.color - tgt)) + 0.1 * torch.mean(out.expected_depth)
            + 0.1 * torch.mean(out.normal))


def _outputs(out) -> dict:
    return {f: getattr(out, f).detach().numpy() for f in out._fields if f != "tile_overflow"}


def _shard(cap, mesh):
    per = cap // mesh.size("gauss")
    return slice(mesh.g * per, (mesh.g + 1) * per)


def tile_sharded_rank(rank, world):
    """4 ranks: the strip render at gauss=4 (outputs, its gradients, the
    ledger of a forward-only render), the overflow past send_capacity=4,
    and the batched exchange at data=2 x gauss=2."""
    from ed3dgs_torch.parallel.tile_sharded import (batched_strip_rasterize,
                                                    tile_sharded_rasterize)

    torch.set_num_threads(1)
    res = {}
    mesh = Mesh(1, 4)
    sc, cam = strip_scene(), strip_camera()
    cfg = strip_config(cam)
    rows = _shard(128, mesh)
    tongue = torch.as_tensor(sc["tongue"][rows])

    comm.ledger.reset()
    with torch.no_grad():
        out, ovf = tile_sharded_rasterize(project_rows(sc, rows, cam), tongue,
                                          torch.ones(3), cfg, mesh)
    res["ledger"] = [r.__dict__ for r in comm.ledger.records]
    res["out"], res["overflow"] = _outputs(out), int(ovf)
    res["tile_overflow"] = bool(out.tile_overflow)

    # gradients of the test's loss with respect to this rank's rows
    sc3 = strip_scene(seed=3)
    tgt = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (3, TS_H, TS_W))
                          .astype(np.float32))
    leaves = [torch.as_tensor(sc3[k][rows]).requires_grad_(True)
              for k in ("means", "opac", "shs")]
    proj = project_rows(sc3, rows, cam, *leaves)
    out, _ = tile_sharded_rasterize(proj, torch.as_tensor(sc3["tongue"][rows]), torch.zeros(3),
                                    cfg, mesh)
    grads = torch.autograd.grad(image_loss(out, tgt), leaves)
    res["grads"] = [g.numpy() for g in grads]

    # demand honestly reported past a 4-row capacity
    sc48 = strip_scene(n=48, cap=64)
    with torch.no_grad():
        _, ovf = tile_sharded_rasterize(project_rows(sc48, _shard(64, mesh), cam),
                                        torch.as_tensor(sc48["tongue"][_shard(64, mesh)]),
                                        torch.ones(3), strip_config(cam, 1 << 10), mesh,
                                        send_capacity=4)
    res["overflow_cap4"] = int(ovf)

    # two cameras over data=2 x gauss=2: this rank renders camera d
    mesh2 = Mesh(2, 2)
    sc7 = strip_scene(n=100, seed=7)
    cams = [cam, strip_camera((0.15, 0.1, 0))]
    rows2 = _shard(128, mesh2)
    with torch.no_grad():
        proj = project_rows(sc7, rows2, cams[mesh2.d])
        tg = torch.as_tensor(sc7["tongue"][rows2])
        out, ovf = batched_strip_rasterize(
            build_gaussian_payload(proj, tg)[None], proj.depth[None],
            (proj.valid & (proj.tiles_touched > 0))[None], proj.rect_min[None],
            proj.rect_max[None], torch.tensor([0.3, 0.2, 0.1]), cfg, mesh2)
    res["batched"] = {k: v[0] for k, v in _outputs(out).items()}
    res["batched_overflow"] = int(ovf)
    return res


def single_strip_reference():
    """The port's single-process rasterize of the same scenes, and the
    gradients of the same loss (rank bodies and the test share this)."""
    sc, cam = strip_scene(), strip_camera()
    cfg = strip_config(cam)
    with torch.no_grad():
        ref = rasterize(project_rows(sc, slice(None), cam), torch.as_tensor(sc["tongue"]),
                        torch.ones(3), cfg)
    sc3 = strip_scene(seed=3)
    tgt = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (3, TS_H, TS_W))
                          .astype(np.float32))
    leaves = [torch.as_tensor(sc3[k]).requires_grad_(True) for k in ("means", "opac", "shs")]
    out = rasterize(project_rows(sc3, slice(None), cam, *leaves), torch.as_tensor(sc3["tongue"]),
                    torch.zeros(3), cfg)
    grads = torch.autograd.grad(image_loss(out, tgt), leaves)
    sc7 = strip_scene(n=100, seed=7)
    batched = []
    with torch.no_grad():
        for c in (cam, strip_camera((0.15, 0.1, 0))):
            batched.append(_outputs(rasterize(project_rows(sc7, slice(None), c),
                                              torch.as_tensor(sc7["tongue"]),
                                              torch.tensor([0.3, 0.2, 0.1]), cfg)))
    return _outputs(ref), [g.numpy() for g in grads], batched


# --- the training step of tests/test_parallel.py ------------------------------

def port_problem(problem: dict, device="cpu"):
    """The port's (state, aux, setup, optimizer, batch, cache) from the numpy
    problem the test process builds (the JAX package's cloud and deformation
    weights, carried across with convert.py)."""
    from ed3dgs_torch import convert
    from ed3dgs_torch.config.params import DeformHiddenConfig, OptimizationConfig
    from ed3dgs_torch.train import trainer
    from ed3dgs_torch.train.optim import TrainState

    params, aux = convert.gaussians_from_numpy(problem["fields"], device=device)
    hidden = DeformHiddenConfig(**problem["hidden"])
    opt = OptimizationConfig()
    optimizer = trainer.build_optimizer(opt, 1.0)
    all_params = {"gaussians": params,
                  "deform": convert.deform_from_flat(problem["deform"], device=device)}
    state = TrainState(all_params, optimizer.init(all_params), problem["iteration"])
    setup = trainer.TrainSetup(raster=RasterConfig(**problem["raster"]), hidden=hidden,
                               **problem["setup"])
    batch = {k: (torch.as_tensor(v, device=device) if isinstance(v, np.ndarray) else v)
             for k, v in problem["batch"].items()}
    cache = trainer.update_knn_cache(params, aux)
    return state, aux, setup, optimizer, batch, cache


def _state_numbers(state, aux, metrics) -> dict:
    """Copies: a graphed step's next call overwrites what it returned."""
    return {"xyz": state.params["gaussians"].xyz.detach().numpy().copy(),
            "terms": {k: float(v) for k, v in metrics.items() if v.dim() == 0},
            "weight": state.params["deform"]["weight"].detach().numpy().copy(),
            "denom": aux.denom.numpy().copy(),
            "loss": float(metrics["loss"]), "psnr": float(metrics["psnr"]),
            "l1_items": metrics["l1_items"].numpy().copy()}


def _step_tensors(state, aux, metrics) -> dict:
    """Every tensor of a step's state, aux and metrics, cloned (a graphed
    step's returns are its static buffers, which its next call overwrites)."""
    from ed3dgs_torch.train.optim import flatten_params

    out = {f"params/{k}": v for k, v in flatten_params(state.params).items()}
    for g, st in state.opt_state.items():
        out.update({f"mu/{g}/{k}": v for k, v in st.mu.items()})
        out.update({f"nu/{g}/{k}": v for k, v in st.nu.items()})
        out[f"count/{g}"] = torch.tensor(st.count)
    out.update({f"aux/{k}": v for k, v in aux._asdict().items()})
    out.update({f"metrics/{k}": v for k, v in metrics.items()})
    out["iteration"] = torch.tensor(state.iteration)
    return {k: v.detach().clone() for k, v in out.items()}


FULL_ITERATION = 20_000     # the iteration of the every-term problem


def full_extras(problem: dict) -> dict:
    """numpy arrays of the every-term problem beside the test problem: the
    tongue class of every third slot, the batch's tongue masks and a GT
    cloud of 64 points (the test process hands the same to JAX)."""
    C = problem["fields"]["alive"].shape[0]
    B, _, H, W = problem["batch"]["gt_image"].shape
    rng = np.random.default_rng(5)
    tongue_gt = (rng.uniform(size=(B, 1, H, W)) > 0.6).astype(np.float32)
    pcd = (rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
           + np.array([0, 0, 2.2], np.float32))
    return dict(tongue_class=(np.arange(C) % 3 == 0).astype(np.float32)[:, None],
                tongue_gt=tongue_gt, pcd_points=pcd)


def full_problem(problem, state, aux, setup, batch):
    """(setup, state, aux, batch, KNN cache) of the every-term problem:
    SSIM, temporal TV, the depth-normal, COLMAP and tongue terms live, at
    FULL_ITERATION, the cache with its tongue graph."""
    from dataclasses import replace

    from ed3dgs_torch.train.trainer import update_knn_cache

    ex = full_extras(problem)
    full = replace(setup, tongue_enabled=True, colmap_supervision=True, lambda_dssim=0.2,
                   coef_tv_temporal=0.01, radegs_from_iter=0)
    aux_f = aux._replace(tongue_class=torch.as_tensor(ex["tongue_class"]))
    batch_f = dict(batch, use_ssim=True, pcd_valid=True,
                   tongue_gt=torch.as_tensor(ex["tongue_gt"]),
                   pcd_points=torch.as_tensor(ex["pcd_points"]))
    cache_f = update_knn_cache(state.params["gaussians"], aux_f, tongue_enabled=True)
    return full, state._replace(iteration=FULL_ITERATION), aux_f, batch_f, cache_f


def parallel_step_rank(rank, world, problem):
    """4 ranks at data=2 x gauss=2: with each comms, three eager sharded
    steps (graph=False) and three through the graphed step's path (the
    default, run eagerly on the CPU) from the same state, each step's
    tensors compared bit for bit and its collectives recorded; the first
    step's state whole again (gathered) for the test; the demand the last
    graphed step reports and the key of a step rebuilt on larger
    capacities (its first run agreed across the ranks); batch_mode "vmap"
    against "scan". Rank 0 also takes the port's single-process step from
    the same state."""
    from dataclasses import replace

    from ed3dgs_torch.parallel import sharded
    from ed3dgs_torch.train.trainer import GraphedTrainStep, make_train_step
    from ed3dgs_torch.utils.graphs import key_hash

    torch.set_num_threads(1)
    state, aux, setup, optimizer, batch, cache = port_problem(problem)
    res = {}
    if rank == 0:
        s1, a1, m1 = make_train_step(setup, optimizer)(state, aux, batch, cache)
        res["single"] = _state_numbers(s1, a1, m1)
    mesh = Mesh(2, 2)
    state_l, aux_l = sharded.shard_train_state(mesh, state, aux)
    batch_l = sharded.shard_batch(mesh, batch)
    for comms in ("gspmd", "strip"):
        steps, ledgers = {}, {}
        for graph in (False, True):
            step = sharded.make_sharded_train_step(replace(setup, comms=comms), optimizer, mesh,
                                                   graph=graph)
            assert isinstance(step, GraphedTrainStep) == graph
            s2, a2 = state_l, aux_l
            steps[graph], ledgers[graph] = [], []
            for i in range(3):
                comm.ledger.reset()
                s2, a2, m2 = step(s2, a2, batch_l, cache)
                ledgers[graph].append([r.__dict__ for r in comm.ledger.records])
                steps[graph].append(_step_tensors(s2, a2, m2))
                if i == 0:
                    name = comms if not graph else f"graph_{comms}"
                    res[name] = _state_numbers(*sharded.gather_train_state(mesh, s2, a2), m2)
                    if not graph:
                        res[f"{comms}_metrics"] = {k: v.numpy() for k, v in m2.items()}
            if graph and comms == "gspmd":
                res["three"] = {"rows": int(s2.params["gaussians"].xyz.shape[0]),
                                "aux_rows": int(a2.alive.shape[0]), "loss": float(m2["loss"])}
        # a capacity change as tools.train makes it, from the last graphed
        # step's metrics: a new step on doubled pair (and send) buffers,
        # whose first run makes the ranks agree on its key
        seen = (int(m2["num_pairs"]), int(m2["send_overflow"]))
        grown = replace(setup, comms=comms, send_capacity=None if setup.send_capacity is None
                        else 2 * setup.send_capacity,
                        raster=replace(setup.raster, pair_capacity=2 * setup.raster.pair_capacity))
        step = sharded.make_sharded_train_step(grown, optimizer, mesh)
        key = key_hash(step.key(s2, a2, batch_l, cache))
        step(s2, a2, batch_l, cache)
        res[f"capacity_{comms}"] = {"seen": seen, "key": key}
        res[f"ledger_{comms}"] = ledgers[False][0]
        res[f"graph_differ_{comms}"] = [
            [k for k in e if not torch.equal(e[k], g[k])] + sorted(set(e) ^ set(g))
            for e, g in zip(steps[False], steps[True])]
        res[f"graph_ledgers_{comms}"] = ledgers
    # every global and last-camera term live: SSIM, temporal TV, the
    # depth-normal, COLMAP and tongue terms, against the single step
    full, state_f, aux_f, batch_f, cache_f = full_problem(problem, state, aux, setup, batch)
    if rank == 0:
        res["full_single"] = _state_numbers(*make_train_step(full, optimizer)(
            state_f, aux_f, batch_f, cache_f))
    st_f, ax_f = sharded.shard_train_state(mesh, state_f, aux_f)
    for comms in ("gspmd", "strip"):
        step = sharded.make_sharded_train_step(replace(full, comms=comms), optimizer, mesh)
        s2, a2, m2 = step(st_f, ax_f, sharded.shard_batch(mesh, batch_f), cache_f)
        res[f"full_{comms}"] = _state_numbers(*sharded.gather_train_state(mesh, s2, a2), m2)
        res[f"full_{comms}_terms"] = {k: float(m2[k]) for k in (
            "ssim", "tv_loss", "depth_normal", "pcd_loss", "tongue_l1", "tongue_emb",
            "tongue_rgb", "wo_tongue_rgb")}

    scan = make_train_step(replace(setup, mesh=mesh, batch_mode="scan"), optimizer, graph=False)
    vmap = make_train_step(replace(setup, mesh=mesh, batch_mode="vmap"), optimizer, graph=False)
    (sa, aa, ma), (sb, ab, mb) = (f(state_l, aux_l, batch_l, cache) for f in (scan, vmap))
    res["vmap_equals_scan"] = (
        all(torch.equal(x, y) for x, y in zip(sa.params["gaussians"], sb.params["gaussians"]))
        and torch.equal(sa.params["deform"]["weight"], sb.params["deform"]["weight"])
        and all(torch.equal(x, y) for x, y in zip(aa, ab))
        and all(torch.equal(ma[k], mb[k]) for k in ma))
    return res


def _tongue_densify(state, aux, graph: bool):
    """The densify step on a whole every-term state at the smallest mean
    screen-space gradient of a seen tongue Gaussian (so that tongue
    parents take the free slots), with a generator of one seed; returns
    (state, aux, the step's tensors)."""
    from ed3dgs_torch.train.trainer import make_densify_step
    from ed3dgs_torch.config.params import OptimizationConfig

    seen = aux.alive & (aux.denom > 0) & (aux.tongue_class[:, 0] > 0.5)
    thr = float((aux.xyz_grad_accum / aux.denom.clamp_min(1.0))[seen].min())
    opt = OptimizationConfig()
    step = make_densify_step(opt, opt.percent_dense, 1.0, graph=graph)
    state, aux, n_c, n_s = step(state, aux, torch.Generator().manual_seed(0), thr)
    tensors = _step_tensors(state, aux, {"n_cloned": n_c, "n_split": n_s})
    return state, aux, tensors


def parallel_tongue_rank(rank, world, problem):
    """4 ranks at data=2 x gauss=2 on the every-term problem (tongue and
    COLMAP terms live; `full_problem`):
      * with each comms, the graphed step's path (run eagerly on the CPU)
        against graph=False from the same shards: 2 steps (SSIM on, off),
        tools.train's densify event on the mesh (the whole cloud gathered,
        the densify step of the same kind, the KNN cache rebuilt with its
        tongue graph, the shards again), then 2 steps with pcd_valid on,
        off: every step's tensors and collectives, and the tongue graph's
        in-edges before and after;
      * under strip, the send demand of the last camera's main render and
        of its tongue-only and tongue-free sub-renders (the step's own
        `_render_one`), and the demand the step reports.
    The first eager step of each comms, its state gathered, is the one the
    test holds to JAX's sharded step."""
    from dataclasses import replace

    from ed3dgs_torch.parallel import sharded
    from ed3dgs_torch.train import trainer
    from ed3dgs_torch.train.trainer import update_knn_cache

    torch.set_num_threads(1)
    state, aux, setup, optimizer, batch, _ = port_problem(problem)
    full, state_f, aux_f, batch_f, cache_f = full_problem(problem, state, aux, setup, batch)
    mesh = Mesh(2, 2)
    st_f, ax_f = sharded.shard_train_state(mesh, state_f, aux_f)
    batch_l = sharded.shard_batch(mesh, batch_f)
    res = {}
    batches = [dict(batch_l, use_ssim=True), dict(batch_l, use_ssim=False)]
    after = [dict(batch_l, use_ssim=False, pcd_valid=True),
             dict(batch_l, use_ssim=False, pcd_valid=False)]
    for comms in ("gspmd", "strip"):
        runs = {}
        for graph in (False, True):
            step = sharded.make_sharded_train_step(replace(full, comms=comms), optimizer, mesh,
                                                   graph=graph)
            s, a, cache = st_f, ax_f, cache_f
            run = {"tensors": [], "ledgers": [], "metrics": []}

            def one(b):
                nonlocal s, a
                comm.ledger.reset()
                s, a, m = step(s, a, b, cache)
                run["ledgers"].append([r.__dict__ for r in comm.ledger.records])
                run["tensors"].append(_step_tensors(s, a, m))
                run["metrics"].append({k: float(v) for k, v in m.items() if v.dim() == 0})
                return m
            for i, b in enumerate(batches):
                m = one(b)
                if i == 0 and not graph:
                    res[f"full_{comms}"] = _state_numbers(
                        *sharded.gather_train_state(mesh, s, a), m)
                    res[f"full_{comms}_overflow"] = int(m["send_overflow"])
            whole_s, whole_a = sharded.gather_train_state(mesh, s, a)
            alive0 = whole_a.alive.clone()
            whole_s, whole_a, dens = _tongue_densify(whole_s, whole_a, graph)
            new = update_knn_cache(whole_s.params["gaussians"], whole_a, tongue_enabled=True)
            run["densify"] = dens
            run["born_tongue"] = int(((whole_a.alive & ~alive0)
                                      & (whole_a.tongue_class[:, 0] > 0.5)).sum())
            run["in_edges"] = (int(cache.t_graph.rev_pair.shape[0]),
                               int(new.t_graph.rev_pair.shape[0]))
            cache = new
            s, a = sharded.shard_train_state(mesh, whole_s, whole_a)
            for b in after:
                one(b)
            runs[graph] = run
        e, g = runs[False], runs[True]
        res[f"graph_differ_{comms}"] = [
            [k for k in x if not torch.equal(x[k], y[k])] + sorted(set(x) ^ set(y))
            for x, y in zip(e["tensors"] + [e["densify"]], g["tensors"] + [g["densify"]])]
        res[f"graph_ledgers_{comms}"] = (e["ledgers"], g["ledgers"])
        res[f"graph_metrics_{comms}"] = g["metrics"]
        res[f"refresh_{comms}"] = dict(in_edges=g["in_edges"], born_tongue=g["born_tongue"])

    # the strip sub-renders' send demand against the main render's
    strip = replace(full, comms="strip", mesh=mesh)
    gp, dp = st_f.params["gaussians"], st_f.params["deform"]
    settings = trainer._settings(batch_f, batch_f["gt_image"].shape[0] - 1)
    br = trainer.step_branches(strip, FULL_ITERATION, batch_f)
    demand = {}
    with torch.no_grad():
        for name, filt, offset in (("main", None, torch.zeros((ax_f.alive.shape[0], 2))),
                                   ("only", "only", None), ("without", "without", None)):
            r = trainer._render_one(gp, ax_f, dp, strip, settings, FULL_ITERATION,
                                    br.active_sh_degree, offset, filt)
            demand[name] = int(r["send_overflow"])
    res["send_demand"] = demand
    return res


def key_mismatch_rank(rank, world, problem):
    """2 ranks at gauss=2 whose batches differ in the SSIM gate, so that
    their graphed steps' keys differ: each rank's first call must raise
    `GraphKeyMismatch` before the step runs (no collective of the step in
    the ledger). Returns (the message, the ledger's records)."""
    from ed3dgs_torch.parallel import sharded
    from ed3dgs_torch.utils.graphs import GraphKeyMismatch

    torch.set_num_threads(1)
    state, aux, setup, optimizer, batch, cache = port_problem(problem)
    mesh = Mesh(1, 2)
    state_l, aux_l = sharded.shard_train_state(mesh, state, aux)
    step = sharded.make_sharded_train_step(setup, optimizer, mesh)
    comm.ledger.reset()
    try:
        step(state_l, aux_l, dict(sharded.shard_batch(mesh, batch), use_ssim=rank == 1), cache)
    except GraphKeyMismatch as e:
        return str(e), list(comm.ledger.records)
    return None, list(comm.ledger.records)


# --- the training CLI ---------------------------------------------------------

def cli_rank(rank, world, runs):
    """`tools.train.main(argv)` on this rank for each argv of `runs` in
    turn (each with its own --mesh), in one world; rank 0 returns each
    run's whole state, aux and log as numpy."""
    from ed3dgs_torch import convert
    from ed3dgs_torch.tools import train

    torch.set_num_threads(1)
    out = []
    for argv in runs:
        _, state, aux, log = train.main(argv)
        out.append((convert.checkpoint_arrays(state, aux), log) if rank == 0 else None)
    return out


# --- the mesh -----------------------------------------------------------------

MESH_SPECS = ("data=2,gauss=2", "data=0,gauss=2", "gauss=4", "data=4", "auto")


def mesh_rank(rank, world):
    """Each spec's mesh as this rank sees it: its position, the members of
    its groups, its slices of a batch and of a camera list, and a gather
    and a reduction over each axis."""
    import torch.distributed as dist

    from ed3dgs_torch.parallel import multihost

    torch.set_num_threads(1)
    out = {}
    for spec in MESH_SPECS:
        mesh = multihost.parse_mesh_spec(spec)

        def members(axis):
            grp = mesh.group(axis)
            return [rank] if grp is None else dist.get_process_group_ranks(grp)

        row = comm.all_gather_rows(torch.tensor([[rank]]), mesh, "gauss", "metric")
        total = comm.all_reduce_(torch.tensor([rank]), mesh, "data", "sum", "metric")
        out[spec] = dict(shape=dict(mesh.shape), d=mesh.d, g=mesh.g,
                         gauss_members=members("gauss"), data_members=members("data"),
                         batch=multihost.host_batch_slice(8, mesh),
                         cams=multihost.host_camera_shard(list(range(10)), mesh),
                         cams_block=multihost.host_camera_shard(list(range(10)), mesh,
                                                                round_robin=False),
                         gathered=row[:, 0].tolist(), data_sum=int(total[0]))
    return out


def failing_rank(rank, world, seconds):
    """Rank 1 raises at once; the others wait `seconds` (a rank stuck
    beside a failed one)."""
    import time

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(seconds)
    return rank
