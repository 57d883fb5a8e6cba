"""The render cells: one client in a closed loop, the viewer's pattern
(ed3dgs_torch/tools/viewer.py): each request is a camera pose on the rig's
ring and a time, rendered by `ed3dgs_torch.tools.FrameRenderer` (graphed,
one key for the resolution, the model copied in at each call), and ends
when its `render` image is cloned and on the host.

The poses and times are a fixed grid (`poses` yaws across the rig's arc at
its middle pitch, `times` in [0, 1)); the seed draws their order, so every
seed serves the same set of frames.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from reference import step as ref

from . import common, scene


class RenderCell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev = torch.device(device)

    def make_inputs(self):
        from ed3dgs_torch.train.capacity import CapacityPolicy
        cfg, tr, dev = self.cfg, self.traffic, self.dev
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.cams = scene.rig(cfg)
        self.params0, self.aux0 = scene.cloud(cfg, gen, dev)
        self.deform0 = scene.deform_weights(cfg, gen, dev)
        self.fargs = common.filter_args(self.cams, dev)
        yaw = cfg["rig"]["yaw_deg"]
        n = tr["poses"]
        self.poses = scene.rig(cfg, yaws=[yaw * (2 * i / max(n - 1, 1) - 1) for i in range(n)],
                               pitches=[0.0] * n)
        self.times = [(i + 0.5) / tr["times"] for i in range(tr["times"])]
        rng = np.random.default_rng(self.seed)
        self.order = rng.permutation(n * tr["times"])
        self.sample_rng = np.random.default_rng(self.seed + 1)
        big = common.step_config(cfg, self.cams, 1 << 24)
        aux = self.aux0._replace(filter_3d=ref.filter_3d(self.params0.xyz, self.aux0.alive,
                                                         *self.fargs))
        views = [common.settings(p, t, dev) for p in self.poses for t in self.times[::4]]
        peak = common.demand(self.params0, aux, self.deform0, big, views, 10 ** 9)
        self.pair_capacity = CapacityPolicy(capacity=0)._bucket_for(peak)
        del aux

    def setup(self):
        from ed3dgs_torch.models import gaussians as gm
        from ed3dgs_torch.ops.rasterize import RasterConfig
        from ed3dgs_torch.tools import FrameRenderer
        cfg = self.cfg
        full = common.program_config(cfg)
        model, hidden = full.model, full.hidden
        c0 = self.cams[0]
        self.rcfg = RasterConfig(width=cfg["width"], height=cfg["height"],
                                 focal_x=c0["focal_x"], focal_y=c0["focal_y"],
                                 pair_capacity=self.pair_capacity, chunk=full.opt.raster_chunk)
        params = gm.GaussianParams(*(t.clone() for t in self.params0))
        aux = gm.GaussianAux(*(t.clone() for t in self.aux0))
        aux = aux._replace(filter_3d=gm.compute_3d_filter(params.xyz, aux.alive, *self.fargs))
        from reference.optim import flatten_params, unflatten
        deform = unflatten({p: t.clone() for p, t in flatten_params(self.deform0).items()})
        self.model = (params, aux, deform)
        bg = torch.full((3,), 1.0 if model.white_background else 0.0, device=self.dev)
        self.renderer = FrameRenderer(hidden, bg, sh_degree=model.sh_degree,
                                      kernel_size=model.kernel_size,
                                      disable_filter3d=model.disable_filter3D,
                                      num_down_emb=hidden.min_embeddings, graph=True)
        self.served = 0
        self.kept = []          # (request index, pose, time, image) sampled from the seed

    def request(self, i: int):
        """(pose, time) of request i."""
        j = int(self.order[i % len(self.order)])
        return j // len(self.times), self.times[j % len(self.times)]

    def serve(self, log: dict):
        """One request; appends its latency and the host ms outside its wait
        for the image."""
        from torch.profiler import record_function
        i = self.served
        pose, t = self.request(i)
        c = self.poses[pose]
        t0 = time.perf_counter()
        with record_function("bench.request"):
            out = self.renderer(self.cfg["width"], self.model, self.rcfg, c["world_view"],
                                c["full_proj"], c["campos"], t)["render"].clone()
        t1 = time.perf_counter()
        with record_function("bench.fetch"):
            img = out.cpu()
        t2 = time.perf_counter()
        log["latency_ms"].append((t2 - t0) * 1e3)
        log["host_ms"].append((t1 - t0) * 1e3)
        self.keep(i, pose, t, img)
        self.served += 1

    def keep(self, i, pose, t, img):
        """A seeded reservoir sample of the served requests."""
        k = self.traffic["checked"]
        if len(self.kept) < k:
            self.kept.append((i, pose, t, img))
        else:
            j = int(self.sample_rng.integers(0, i + 1))
            if j < k:
                self.kept[j] = (i, pose, t, img)

    def warm(self):
        log = new_log()
        for _ in range(self.traffic["warm_requests"]):
            self.serve(log)
        self.kept = []
        return log

    def window(self, seconds: float) -> dict:
        log = new_log()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.serve(log)
        log["seconds"] = time.perf_counter() - t0
        return log

    def traced(self, requests: int) -> list:
        out, log = [], new_log()
        for _ in range(requests):
            out.append(self.request(self.served))
            self.serve(log)
        return out

    def sample_work(self, traced: list, k: int) -> list:
        scfg = common.step_config(self.cfg, self.cams, self.pair_capacity)
        aux = self.aux0._replace(filter_3d=self.model[1].filter_3d)
        pick = sorted({int(i * len(traced) / k) for i in range(k)})
        out = []
        for i in pick:
            pose, t = traced[i]
            s = common.settings(self.poses[pose], t, self.dev)
            out.append((i, common.view_work(self.params0, aux, self.deform0, scfg, s, 10 ** 9)))
        return out

    def alive(self) -> int:
        return int(self.aux0.alive.sum())

    def release(self):
        self.__dict__.pop("renderer", None)
        self.__dict__.pop("model", None)

    def readings(self, lower: bool = False) -> dict:
        """The widest gap of a kept request's image from the reference's
        render of its pose and time (`lower`: the reference one precision step
        down, put in the program's place, against the reference)."""
        scfg = common.step_config(self.cfg, self.cams, self.pair_capacity)

        def reference(c):
            aux = self.aux0._replace(filter_3d=ref.filter_3d(self.params0.xyz, self.aux0.alive,
                                                             *self.fargs))
            return lambda s, t: ref.frame(self.params0, aux, self.deform0, c, *s[:3], t)
        plain = reference(scfg)
        if lower:
            with ref.tf32():
                control = reference(ref.lower_precision(scfg))
        worst = 0.0
        for _, pose, t, img in self.kept:
            s = common.settings(self.poses[pose], t, self.dev)
            want = plain(s, t)
            if lower:
                with ref.tf32():
                    img = control(s, t)
            gap = float((img.to(want.device) - want).abs().max())
            worst = max(worst, gap if math.isfinite(gap) else math.inf)
        return dict(image_gap=worst, checked=len(self.kept))

    def check(self, lower: bool = False) -> tuple:
        """(the numbers compared and notes, False: a frame drops no pair at
        the poses' capacity)."""
        r = self.readings(lower)
        return {"image_gap": r["image_gap"], "_checked": r["checked"]}, False

    def notes(self) -> dict:
        return {"_pair_capacity": self.pair_capacity, "_captures_in_window": 0}


def new_log() -> dict:
    return {"latency_ms": [], "host_ms": []}


Cell = RenderCell
