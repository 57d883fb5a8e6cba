"""The tongue train cell: train.py's closed loop with the fork's tongue
objective on (`tongue_mask_loss_enabled`): every step renders the camera
and, for the tongue terms, the same camera twice more (tongue-only and
tongue-free), and runs the KNN loss on the main and the tongue graph.

Over `train.TrainCell` it places the config's tongue blob in the seeded
cloud (tongue class 1), renders each target's blended tongue channel as its
tongue mask (pinned beside the target, staged as `tongue_gt`), samples
frames with the config's preference (`CameraSampler`'s
`preference_frames`, as tools/train.py builds it), refreshes both graphs
(`refresh_knn_cache(tongue_enabled=True)`) at set-up and at every densify
event, counts three renders a sampled step, and holds the program's tongue
terms on the followed steps to the reference's (reference/tongue.py):
`tongue_gap`, the worst relative gap of any term over those steps. The
followed steps are graph replays, as in the base loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import step as ref
from reference import tongue as tref
from reference.gaussians import GaussianAux, GaussianParams
from reference.optim import flatten_params

from . import common, scene, train

TERMS = tref.TERMS


def place_blob(cfg: dict, params, aux, gen: torch.Generator) -> tuple:
    """(params, aux) with the first `tongue.gaussians` rows moved to
    N(centre, diag(sd)^2) and given tongue class 1."""
    t = cfg["tongue"]
    n, dev = t["gaussians"], params.xyz.device
    f32 = dict(dtype=torch.float32, device=dev)
    xyz = params.xyz.clone()
    xyz[:n] = (torch.tensor(t["centre"], **f32)
               + torch.tensor(t["sd"], **f32) * torch.randn((n, 3), generator=gen, **f32))
    tongue = aux.tongue_class.clone()
    tongue[:n] = 1.0
    return params._replace(xyz=xyz), aux._replace(tongue_class=tongue)


def tongue_gap(got: list, want: list) -> tuple:
    """(the worst relative gap of any tongue term over the followed steps,
    [step, term] where it is): |program - reference| over |reference|; a
    term both read as exactly 0 (the gated colour term) has no gap."""
    worst, where = 0.0, None
    for i, (g, w) in enumerate(zip(got, want)):
        for k in TERMS:
            d = abs(g[k] - w[k])
            d = d / abs(w[k]) if w[k] else (math.inf if d else 0.0)
            d = d if math.isfinite(d) else math.inf
            if where is None or d > worst:
                worst, where = d, [i, k]
    return worst, where


class _Recording:
    """The step, keeping the metrics of its last call on the cell (the
    followed steps' tongue terms are read from them); every other attribute
    is the step's."""

    def __init__(self, step, cell):
        self._step, self._cell = step, cell

    def __call__(self, *args):
        state, aux, metrics = self._step(*args)
        self._cell.last_metrics = metrics
        return state, aux, metrics

    def __getattr__(self, name):
        return getattr(self._step, name)


class TongueCell(train.TrainCell):
    # --- the inputs ---------------------------------------------------------------
    def make_inputs(self):
        """The base loop's inputs with the tongue blob placed after the
        cloud is made, and a tongue mask beside each target: its blended
        tongue channel, rendered by the plain reference from the target
        cloud."""
        from ed3dgs_torch.train.capacity import CapacityPolicy
        cfg, dev = self.cfg, self.dev
        m = cfg["model"]
        if (cfg["opt"]["batch_size"] != 1 or m["colmap_supervision_enabled"]
                or not m["tongue_mask_loss_enabled"]):
            raise ValueError(f"{cfg['name']}: the tongue loop drives batch 1 with the tongue "
                             "terms on and the COLMAP term off")
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.noise_gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        self.cams = scene.rig(cfg)
        self.params0, self.aux0 = place_blob(cfg, *scene.cloud(cfg, gen, dev), gen)
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
        self.targets, self.masks = [], []
        for c in self.cams:
            for _, t in self.frames:
                s = common.settings(c, t, dev)
                for out, img in zip((self.targets, self.masks), tref.frame_and_tongue(
                        gt_params, aux, gt_deform, tcfg, *s[:3], t)):
                    out.append(img.cpu().pin_memory() if dev.type == "cuda" else img.cpu())
        self.demand = common.demand(self.params0, aux, self.deform0, big, views, it)
        self.pair_capacity = CapacityPolicy(capacity=0)._bucket_for(self.demand)
        self.ref_capacity = max(self.pair_capacity, 1 << 17)
        del gt_params, gt_deform, aux

    # --- the program ----------------------------------------------------------------
    def setup(self):
        """The base set-up (its graph keys captured on batches with a tongue
        mask, both graphs built), then the config's preference sampler."""
        from ed3dgs_torch.train.sampling import CameraSampler
        super().setup()
        m, opt = self.cfg["model"], self.opt
        self.sampler = CameraSampler(
            num_cams=len(self.cams), maxtime=opt.maxtime,
            camera_centers=np.stack([c["campos"] for c in self.cams]),
            batch_size=opt.batch_size, random_until=opt.random_until,
            num_multiview_ssim=opt.num_multiview_ssim,
            preference_frames=tuple(m["frame_indices_higher_preference"]),
            preference_probability=m["frame_preference_probability"], seed=self.seed)
        self.pending = self.sampler.sample(self.iteration, opt.iterations)
        self.step_fn = _Recording(self.step_fn, self)

    def refresh_knn(self, params, aux):
        return self.trainer.refresh_knn_cache(params, aux, self.knn_caps, tongue_enabled=True,
                                              coverage_target=self.opt.knn_coverage_target)

    def batch(self, cam: int, target: int, use_ssim: bool) -> dict:
        b = super().batch(cam, target, use_ssim)
        b["tongue_gt"] = self.masks[target].to(self.dev, non_blocking=True)[None]
        return b

    def grow(self, want: int):
        super().grow(want)
        self.step_fn = _Recording(self.step_fn, self)

    def iterate(self, log: dict):
        """The base iteration; a followed step also keeps its tongue terms
        and the two sub-renders' pairs."""
        followed = len(self.first)
        super().iterate(log)
        if len(self.first) > followed:
            m = self.last_metrics
            pairs = m.get("tongue_pairs")       # None on a program without the count
            self.first[-1].update(tongue={k: float(m[k]) for k in TERMS},
                                  tongue_pairs=None if pairs is None else pairs.tolist())

    def sample_work(self, traced: list, k: int) -> list:
        """For k of the traced steps (evenly spaced): (index, {"views": the
        blend work of the camera, tongue-only and tongue-free renders,
        "tongue_alive": the alive tongue rows}), on the program's current
        cloud; a sub-render's filter is applied by masking `alive`."""
        st = self.state.params
        params = GaussianParams(*(t.detach() for t in st["gaussians"]))
        aux = GaussianAux(*self.aux)
        tongue = tref.tongue_rows(aux)
        subsets = [aux, aux._replace(alive=aux.alive & tongue),
                   aux._replace(alive=aux.alive & ~tongue)]
        n_tongue = int((aux.alive & tongue).sum())
        scfg = common.step_config(self.cfg, self.cams, self.rcfg.pair_capacity)
        out = []
        for i in sorted({int(j * len(traced) / k) for j in range(k)}):
            cam, target, it = traced[i]
            s = common.settings(self.cams[cam], self.frames[target % len(self.frames)][1],
                                self.dev, cam_no=cam)
            views = [common.view_work(params, a, st["deform"], scfg, s, it) for a in subsets]
            out.append((i, {"views": views, "tongue_alive": n_tongue}))
        return out

    # --- the reference ------------------------------------------------------------
    def reference_readings(self, lower: bool = False) -> dict:
        """The base loop's readings (reference/tongue.py's trainer on both
        graphs) and each followed step's tongue terms."""
        scfg = common.step_config(self.cfg, self.cams, self.ref_capacity)
        scfg = ref.lower_precision(scfg) if lower else scfg
        params0 = {"gaussians": self.params0, "deform": self.deform0}
        with ref.tf32(lower):
            aux = self.aux0._replace(filter_3d=ref.filter_3d(self.params0.xyz, self.aux0.alive,
                                                             *self.fargs))
            caps, cover = dict(ref.KNN_CAPS_DEFAULT), self.cfg["opt"]["knn_coverage_target"]
            graphs = tref.knn_graphs(self.params0.xyz, aux, caps, cover)
            tr = tref.Trainer(params0, aux, scfg)
            losses, grads, terms = [], None, []
            for rec in self.first:
                out = tr.step(self.batch(rec["cam"], rec["target"], rec["use_ssim"]), graphs,
                              rec["iteration"])
                losses.append(float(out["loss"]))
                terms.append({k: float(v) for k, v in out["tongue"].items()})
                if grads is None:
                    grads = {p: float(torch.linalg.vector_norm(g.double()))
                             for p, g in out["grads"].items()}
                del out
                if "densify" in rec:
                    tr.densify(rec["densify"]["threshold"], rec["densify"]["noise"])
                    xyz = tr.params["gaussians"].xyz
                    tr.aux = tr.aux._replace(filter_3d=ref.filter_3d(xyz, tr.aux.alive,
                                                                     *self.fargs))
                    graphs = tref.knn_graphs(xyz, tr.aux, caps, cover)
            now, before = flatten_params(tr.params), flatten_params(params0)
            change = {p: float(torch.linalg.vector_norm((now[p] - before[p]).double()))
                      for p in now}
        return dict(loss=losses, grad_norms=grads, change_norms=change, tongue=terms)

    def program_readings(self) -> dict:
        return dict(super().program_readings(), tongue=[r["tongue"] for r in self.first])

    def check(self, lower: bool = False) -> tuple:
        """The base loop's numbers, and `tongue_gap`."""
        from .cell import compare
        want = self.reference_readings()
        got = self.reference_readings(lower=True) if lower else self.program_readings()
        out = compare(got, want)
        out["tongue_gap"], out["_tongue_worst"] = tongue_gap(got["tongue"], want["tongue"])
        out["_tongue_terms"] = [got["tongue"], want["tongue"]]
        return out, any(r["overflow"] for r in self.first)

    def notes(self) -> dict:
        means = [float(m.mean()) for m in self.masks]
        return dict(super().notes(), _tongue_pairs=[r["tongue_pairs"] for r in self.first],
                    _tongue_mask_mean=[min(means), max(means)])


Cell = TongueCell
