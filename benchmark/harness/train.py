"""The train cells: a closed loop of training iterations driven as
ed3dgs_torch/tools/train.py's `run_training` drives them (the camera
sampler, the batch staged, the graphed step, one read of the step's
`l1_items`, `record_loss`, the pair-capacity policy, the densify cadence),
with its targets held in pinned host memory instead of decoded from PNGs.

Set-up builds the program's state once from the seed, at the config's
iteration `start`, captures every graph key the loop meets, and drives the
state through `warm` iterations of the loop; the window then continues it. The first three of those iterations,
all graph replays, are what the reference follows.

The loop drives batch 1 without the tongue and COLMAP terms, which is what
the reference and the work counts cover: a configuration that asks for
more is refused.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from reference import step as ref
from reference.gaussians import GaussianAux, GaussianParams
from reference.optim import B1, flatten_params

from . import common, scene

FOLLOWED = 3        # set-up steps the reference follows


class TrainCell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev = torch.device(device)
        self.first = []           # the followed steps: batch, loss, program numbers

    # --- the inputs ---------------------------------------------------------------
    def make_inputs(self):
        """The seeded cloud and network, the targets (the plain reference's
        renders of a second network and moved colours), and the program's
        pair capacity: the CapacityPolicy bucket of the rig's largest demand
        on the starting cloud, the capacity the policy settles on there."""
        from ed3dgs_torch.train.capacity import CapacityPolicy
        cfg, dev = self.cfg, self.dev
        unsupported = {k: v for k, v in (("opt.batch_size", cfg["opt"]["batch_size"] != 1),
                                         ("model.tongue_mask_loss_enabled",
                                          cfg["model"]["tongue_mask_loss_enabled"]),
                                         ("model.colmap_supervision_enabled",
                                          cfg["model"]["colmap_supervision_enabled"])) if v}
        if unsupported:
            raise ValueError(f"{cfg['name']}: the train loop drives batch 1 without the tongue "
                             f"and COLMAP terms; refused: {sorted(unsupported)}")
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.noise_gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        self.cams = scene.rig(cfg)
        self.params0, self.aux0 = scene.cloud(cfg, gen, dev)
        self.deform0 = scene.deform_weights(cfg, gen, dev)
        self.fargs = common.filter_args(self.cams, dev)
        self.frames = scene.frame_times(cfg)
        big = common.step_config(cfg, self.cams, 1 << 24)
        gt_params = self.params0._replace(
            features_dc=self.params0.features_dc
            + 0.1 * torch.randn(self.params0.features_dc.shape, generator=gen, device=dev))
        gt_deform = scene.deform_weights(cfg, gen, dev)
        aux = self.aux0._replace(filter_3d=ref.filter_3d(self.params0.xyz, self.aux0.alive,
                                                         *self.fargs))
        views = [common.settings(c, t, dev) for c in self.cams for _, t in self.frames]
        it = self.traffic["start_iteration"]
        need = common.demand(gt_params, aux, gt_deform, big, views, it)
        tcfg = common.step_config(cfg, self.cams, CapacityPolicy(capacity=0)._bucket_for(need))
        self.targets = []
        for c in self.cams:
            for _, t in self.frames:
                img = ref.frame(gt_params, aux, gt_deform, tcfg, *common.settings(c, t, dev)[:3],
                                t)
                self.targets.append(img.cpu().pin_memory() if dev.type == "cuda" else img.cpu())
        self.demand = common.demand(self.params0, aux, self.deform0, big, views, it)
        self.pair_capacity = CapacityPolicy(capacity=0)._bucket_for(self.demand)
        self.ref_capacity = max(self.pair_capacity, 1 << 17)
        del gt_params, gt_deform, aux

    # --- the program ----------------------------------------------------------------
    def setup(self):
        from ed3dgs_torch.models import gaussians as gm
        from ed3dgs_torch.ops.rasterize import RasterConfig
        from ed3dgs_torch.train import trainer
        from ed3dgs_torch.train.capacity import CapacityPolicy
        from ed3dgs_torch.train.optim import flatten_params as port_flatten
        from ed3dgs_torch.train.sampling import CameraSampler
        from ed3dgs_torch.train.trainer import (TrainSetup, init_train_state,
                                                make_densify_step, make_train_step)
        cfg, dev = self.cfg, self.dev
        full = common.program_config(cfg)
        model, opt, hidden = full.model, full.opt, full.hidden
        self.opt = opt
        c0 = self.cams[0]
        self.rcfg = RasterConfig(width=cfg["width"], height=cfg["height"],
                                 focal_x=c0["focal_x"], focal_y=c0["focal_y"],
                                 pair_capacity=self.pair_capacity, chunk=opt.raster_chunk)
        self.tsetup = TrainSetup(
            raster=self.rcfg, hidden=hidden, batch_size=opt.batch_size,
            white_background=model.white_background, kernel_size=model.kernel_size,
            disable_filter3d=model.disable_filter3D, use_coord_map=model.use_coord_map,
            tongue_enabled=model.tongue_mask_loss_enabled, lambda_dssim=opt.lambda_dssim,
            opacity_l1_coef=opt.opacity_l1_coef_fine, reg_coef=opt.reg_coef,
            coef_tv_temporal=opt.coef_tv_temporal_embedding,
            lambda_depth_normal=opt.lambda_depth_normal,
            radegs_from_iter=opt.radegs_regularization_from_iter,
            num_down_emb=hidden.min_embeddings, sh_degree=model.sh_degree,
            colmap_supervision=model.colmap_supervision_enabled,
            deform_from_iter=hidden.deform_from_iter)
        self.extent = common.extent(self.cams)
        params = gm.GaussianParams(*(t.clone() for t in self.params0))
        aux = gm.GaussianAux(*(t.clone() for t in self.aux0))
        state, self.optimizer = init_train_state(params, hidden, opt, self.extent)
        state = state._replace(iteration=self.traffic["start_iteration"])
        mine = flatten_params({"deform": self.deform0})
        for path, t in port_flatten({"deform": state.params["deform"]}).items():
            t.copy_(mine[path])
        self.step_fn = make_train_step(self.tsetup, self.optimizer, graph=True)
        self.densify_fn = make_densify_step(opt, opt.percent_dense, self.extent)
        self.gm, self.trainer = gm, trainer
        self.aux = self.refresh_filter(state.params["gaussians"], aux)
        self.knn_caps = dict(trainer.KNN_CAPS_DEFAULT)
        self.knn_cache = self.refresh_knn(state.params["gaussians"], self.aux)
        self.state = state
        self.sampler = CameraSampler(
            num_cams=len(self.cams), maxtime=opt.maxtime,
            camera_centers=np.stack([c["campos"] for c in self.cams]),
            batch_size=opt.batch_size, random_until=opt.random_until,
            num_multiview_ssim=opt.num_multiview_ssim, seed=self.seed)
        self.iteration = self.traffic["start_iteration"]
        self.policy = CapacityPolicy(capacity=self.rcfg.pair_capacity)
        self.policy.start(self.iteration)
        self.pending = self.sampler.sample(self.iteration, opt.iterations)
        self.capture_keys()
        self.captures = 0
        self.demand_peak = 0
        self.demand_trace = []

    def capture_keys(self):
        """Run each key the loop meets (the SSIM gate on and off) and the
        densify step once on the state, discarding what they return: each
        first call runs eagerly and captures its graph, so that the followed
        steps and the window replay. Both steps copy their inputs into
        buffers of their own, so the state is left as it was."""
        for use_ssim in (True, False):
            self.step_fn(self.state, self.aux, self.batch(0, 0, use_ssim), self.knn_cache)
        C = self.aux.alive.shape[0]
        self.densify_fn(self.state, self.aux, None, self.opt.densify_grad_threshold_fine_init,
                        noise=torch.zeros((2, C, 3), device=self.dev))

    def refresh_filter(self, params, aux):
        return aux._replace(filter_3d=self.gm.compute_3d_filter(params.xyz, aux.alive,
                                                                *self.fargs))

    def refresh_knn(self, params, aux):
        return self.trainer.refresh_knn_cache(params, aux, self.knn_caps,
                                              coverage_target=self.opt.knn_coverage_target)

    def target_of(self, cam: int, frame: int) -> int:
        """The target nearest to the drawn frame (the training tool's pick of
        the nearest frame for sparse frame ids)."""
        k = int(np.argmin([abs(f - frame) for f, _ in self.frames]))
        return cam * len(self.frames) + k

    def batch(self, cam: int, target: int, use_ssim: bool) -> dict:
        """stage_batch's batch from the pinned target and the rig's arrays."""
        c, dev = self.cams[cam], self.dev

        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x)).to(dev)
        return {"gt_image": self.targets[target].to(dev, non_blocking=True)[None],
                "viewmatrix": put(c["world_view"][None]), "projmatrix": put(c["full_proj"][None]),
                "campos": put(c["campos"][None]),
                "time": put(np.float32([self.frames[target % len(self.frames)][1]])),
                "cam_no": put(np.int64([cam])), "use_ssim": bool(use_ssim)}

    def iterate(self, log: dict):
        """One iteration of the loop; appends its wall ms, the ms its read of
        l1_items waited and any densify event's wall ms to `log`."""
        from torch.profiler import record_function
        opt = self.opt
        t_loop = time.perf_counter()
        it = self.iteration
        with record_function("bench.sample"):
            cams, frames, use_ssim = self.pending
            self.pending = self.sampler.sample(it + 1, opt.iterations)
        with record_function("bench.stage"):
            cam = int(cams[0])
            target = self.target_of(cam, int(frames[0]))
            batch = self.batch(cam, target, use_ssim)
        followed = len(self.first) < FOLLOWED
        if followed and not self.first:
            self.p0 = {p: t.clone() for p, t in
                       _flat(self.state.params).items()}
        if followed:
            replay = self.replays(batch)
        with record_function("bench.step"):
            self.state, self.aux, metrics = self.step_fn(self.state, self.aux, batch,
                                                         self.knn_cache)
        t_read = time.perf_counter()
        with record_function("bench.read"):
            l1_items = metrics["l1_items"].cpu().numpy()
        log["read_wait_ms"].append((time.perf_counter() - t_read) * 1e3)
        self.sampler.record_loss([cam], [self.frames[target % len(self.frames)][0]], l1_items)
        loss = float(metrics["loss"])
        num_pairs = int(metrics["num_pairs"])
        self.demand_peak = max(self.demand_peak, num_pairs)
        if it % opt.densification_interval == 0:
            self.demand_trace.append(num_pairs)
        want = self.policy.observe(it, num_pairs)
        if want is not None:
            self.grow(want)
        if followed:
            rec = dict(iteration=it, cam=cam, target=target, use_ssim=bool(use_ssim), loss=loss,
                       replay=replay, overflow=bool(metrics["tile_overflow"])
                       or num_pairs > self.rcfg.pair_capacity)
            if not self.first:
                rec["grad_norms"] = {p: float(torch.linalg.vector_norm(m.double()) / (1 - B1))
                                     for g in self.state.opt_state.values()
                                     for p, m in g.mu.items()}
            self.first.append(rec)
        if (opt.densify_from_iter < it < opt.densify_until_iter
                and it % opt.densification_interval == 0):
            t_d = time.perf_counter()
            with record_function("bench.densify"):
                thr = (opt.densify_grad_threshold_fine_init
                       - it * (opt.densify_grad_threshold_fine_init
                               - opt.densify_grad_threshold_after) / opt.densify_until_iter)
                C = self.aux.alive.shape[0]
                noise = torch.randn((2, C, 3), generator=self.noise_gen, device=self.dev)
                self.state, self.aux, n_c, n_s = self.densify_fn(self.state, self.aux, None,
                                                                 thr, noise=noise)
                self.aux = self.refresh_filter(self.state.params["gaussians"], self.aux)
                self.knn_cache = self.refresh_knn(self.state.params["gaussians"], self.aux)
                log.setdefault("densified", []).append((int(n_c), int(n_s), self.alive()))
                if self.dev.type == "cuda":
                    torch.cuda.synchronize()
            log["densify_ms"].append((time.perf_counter() - t_d) * 1e3)
            if followed:
                self.first[-1].update(densify=dict(threshold=thr, noise=noise))
        if followed and len(self.first) == FOLLOWED:
            now = _flat(self.state.params)
            self.change_norms = {p: float(torch.linalg.vector_norm((now[p] - self.p0[p]).double()))
                                 for p in now}
            del self.p0
        self.iteration = it + 1
        log["iter_ms"].append((time.perf_counter() - t_loop) * 1e3)

    def replays(self, batch) -> bool:
        """Whether the step replays a captured graph for this call."""
        step = self.step_fn
        graphs = getattr(step, "graphs", None)
        return graphs is not None and step.key(self.state, self.aux, batch,
                                               self.knn_cache) in graphs

    def grow(self, want: int):
        """The pair capacity grown (or shrunk) by the policy: a new step on
        new buffers, as the training tool makes one."""
        from dataclasses import replace
        from ed3dgs_torch.train.trainer import make_train_step
        self.step_fn = None
        self.rcfg = replace(self.rcfg, pair_capacity=want)
        self.tsetup = replace(self.tsetup, raster=self.rcfg)
        self.step_fn = make_train_step(self.tsetup, self.optimizer, graph=True)
        self.captures += 1

    def warm(self):
        log = new_log()
        for _ in range(self.traffic["warm_iterations"]):
            self.iterate(log)
        return log

    def window(self, seconds: float) -> dict:
        log = new_log()
        before = self.captures
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.iterate(log)
        log["seconds"] = time.perf_counter() - t0
        self.window_captures = self.captures - before
        self.window_densified = log.get("densified", [])
        return log

    def traced(self, steps: int) -> list:
        """`steps` iterations for the profiler; returns their (cam, target,
        iteration)."""
        out = []
        log = new_log()
        for _ in range(steps):
            cams, frames, _ = self.pending
            out.append((int(cams[0]), self.target_of(int(cams[0]), int(frames[0])),
                        self.iteration))
            self.iterate(log)
        return out

    def sample_work(self, traced: list, k: int) -> list:
        """The blend work of k of the traced steps' views (evenly spaced),
        with their indices, on the program's current cloud."""
        st = self.state.params
        params = GaussianParams(*(t.detach() for t in st["gaussians"]))
        aux = GaussianAux(*self.aux)
        scfg = common.step_config(self.cfg, self.cams, self.rcfg.pair_capacity)
        pick = sorted({int(i * len(traced) / k) for i in range(k)})
        out = []
        for i in pick:
            cam, target, it = traced[i]
            s = common.settings(self.cams[cam], self.frames[target % len(self.frames)][1],
                                self.dev, cam_no=cam)
            out.append((i, common.view_work(params, aux, st["deform"], scfg, s, it)))
        return out

    def alive(self) -> int:
        return int(self.aux.alive.sum())

    def release(self):
        """Free the program's state before the reference runs."""
        for name in ("state", "aux", "knn_cache", "step_fn", "densify_fn", "optimizer"):
            self.__dict__.pop(name, None)

    # --- the reference ------------------------------------------------------------
    def reference_readings(self, lower: bool = False) -> dict:
        """The reference's followed steps from the seed's inputs, in the
        configuration's precision or (lower) one step below it: each step's
        loss, the first step's gradient norm and the three steps' change
        norm of every leaf."""
        scfg = common.step_config(self.cfg, self.cams, self.ref_capacity)
        scfg = ref.lower_precision(scfg) if lower else scfg
        params0 = {"gaussians": self.params0, "deform": self.deform0}
        with ref.tf32(lower):
            aux = self.aux0._replace(filter_3d=ref.filter_3d(self.params0.xyz, self.aux0.alive,
                                                             *self.fargs))
            caps, cover = dict(ref.KNN_CAPS_DEFAULT), self.cfg["opt"]["knn_coverage_target"]
            graph = ref.knn_graph(self.params0.xyz, self.aux0.alive, caps, cover)
            tr = ref.Trainer(params0, aux, scfg)
            losses, grads = [], None
            for rec in self.first:
                out = tr.step(self.batch(rec["cam"], rec["target"], rec["use_ssim"]), graph,
                              rec["iteration"])
                losses.append(float(out["loss"]))
                if grads is None:
                    grads = {p: float(torch.linalg.vector_norm(g.double()))
                             for p, g in out["grads"].items()}
                del out
                if "densify" in rec:
                    tr.densify(rec["densify"]["threshold"], rec["densify"]["noise"])
                    xyz = tr.params["gaussians"].xyz
                    tr.aux = tr.aux._replace(filter_3d=ref.filter_3d(xyz, tr.aux.alive,
                                                                     *self.fargs))
                    graph = ref.knn_graph(xyz, tr.aux.alive, caps, cover)
            now, before = flatten_params(tr.params), flatten_params(params0)
            change = {p: float(torch.linalg.vector_norm((now[p] - before[p]).double()))
                      for p in now}
        return dict(loss=losses, grad_norms=grads, change_norms=change)

    def program_readings(self) -> dict:
        return dict(loss=[r["loss"] for r in self.first], grad_norms=self.first[0]["grad_norms"],
                    change_norms=self.change_norms)

    def check(self, lower: bool = False) -> tuple:
        """(the numbers compared and notes, whether a followed step dropped
        pairs): the program's followed steps (`lower`: the reference one
        precision step down in its place) against the reference's."""
        from .cell import compare
        want = self.reference_readings()
        got = self.reference_readings(lower=True) if lower else self.program_readings()
        return compare(got, want), any(r["overflow"] for r in self.first)

    def notes(self) -> dict:
        return {"_followed_replays": [r["replay"] for r in self.first],
                "_pair_capacity": [self.pair_capacity, self.policy.capacity],
                "_demand": [self.demand, self.demand_peak],
                "_demand_every_100": self.demand_trace,
                "_captures_in_window": getattr(self, "window_captures", 0),
                "_window_cloned_split_alive": _densify_summary(getattr(self, "window_densified",
                                                                       []))}


def _densify_summary(events: list) -> list:
    """[clones, splits, alive after the first event, alive after the last]
    of a window's densify events."""
    if not events:
        return []
    return [sum(e[0] for e in events), sum(e[1] for e in events), events[0][2], events[-1][2]]


def _flat(params) -> dict:
    from ed3dgs_torch.train.optim import flatten_params as port_flatten
    return port_flatten(params)


def new_log() -> dict:
    return {"iter_ms": [], "read_wait_ms": [], "densify_ms": []}


Cell = TrainCell
