"""The plain reference of the fork's tongue objective (E-D3DGS fork,
`train.py:298-343`, `tongue_mask_loss_enabled`): `step.py`'s training step
plus four terms on the last camera of the batch, with the program's weights:

  * tongue_l1 x 5: L1 of the camera render's blended tongue channel against
    the tongue mask;
  * tongue_emb x reg_coef: the KNN embedding regulariser on the tongue graph;
  * tongue_rgb x 1: the tongue-only render's colour inside the mask, over
    the mask's mean, where that mean exceeds 0.005 (0 elsewhere);
  * wo_tongue_rgb x 0.5: the tongue-free render's colour outside the mask,
    over the mean of its complement.

The two sub-renders deform the whole cloud again and blend only its tongue
(or non-tongue) rows, as the fork's `render_tongue` and
`render_without_tongue` do. Both graphs are built as the program's
`trainer._cache_inputs` builds them: the main graph over the alive
non-tongue rows, the rest parked on the far shell; the tongue graph over the
alive tongue rows, the rest on the mirrored shell; each with the edges that
the capacity buckets the two settle on together cannot hold weighted 0
(`knn_graph.effective_weights`, the drops of both graphs counted against
one budget of alive x K edges, as `refresh_knn_cache` counts them).

The step is `step.py`'s loss with the four terms added before its one
backward (`loss_and_grads`, a copy of `step.loss_and_grads`; with the
tongue off the two are the same bit for bit), and `step.Trainer`'s update
and densify event. The three plain renders' graphs are held at once: at the
cell's size (802x550, 150,000 slots) they fit the card, so no blocks are
needed; a backward per render would also round differently from the
program's, whose deformation backward in bf16 rounds the sum of a render's
cotangents.

Departures from the fork's train.py:298-343, which the program shares:
  * the tongue graph is the program's k-NN over all slots with the
    non-tongue and dead rows on a far shell, its weights exp(-2000 d^2)
    flushed below float32's smallest normal and its coefficient
    1 / (tongue rows x K), with the bucket drops above; the fork runs
    o3d_knn over the tongue points alone when their count changes;
  * the sub-renders take no screen-space offset: their gradient feeds no
    densification statistic (the fork's sub-renders' `viewspace_points`
    are not read by `add_densification_stats`);
  * the masks are the blended tongue channel of the targets' cloud, not a
    segmentation read from disk.
"""

from __future__ import annotations

import torch

from . import losses as L
from . import step as S
from .densify import add_densification_stats
from .knn import far_shell, knn_plain
from .knn_graph import KNN_CAPS_MAX, _snug_far, prepare_knn_graph
from .optim import flatten_params, unflatten_params
from .render import RenderSettings, render

TERMS = ("tongue_l1", "tongue_emb", "tongue_rgb", "wo_tongue_rgb")
MASK_GATE = 0.005       # the tongue colour term's least mask mean


def tongue_rows(aux) -> torch.Tensor:
    return torch.round(aux.tongue_class[:, 0]) > 0.5


def _graph_inputs(xyz, mask, shell, k):
    """(idx, w, coef, pts) of the masked rows' graph, the rest on `shell`."""
    pts = torch.where(mask[:, None], xyz, shell)
    d2, idx = knn_plain(pts, k=k)
    w = torch.exp(-2000.0 * torch.clamp_min(d2, 0.0))
    w = torch.where(mask[:, None] & (w >= torch.finfo(torch.float32).tiny), w,
                    torch.zeros_like(w))
    m = mask.to(torch.float32)
    return idx, w, m / torch.clamp_min(torch.sum(m) * k, 1.0), pts


def knn_graphs(xyz, aux, caps: dict, coverage_target: float, k: int = S.KNN_K) -> tuple:
    """((idx, w, coef) of the main graph, the same of the tongue graph) at
    the buckets a refresh of both settles on; `caps` is mutated across
    refreshes, as the program's is."""
    t = tongue_rows(aux)
    shell = far_shell(aux.alive.shape[0], aux.alive.device)
    masks = (aux.alive & ~t, aux.alive & t)
    inputs = [_graph_inputs(xyz, m, s, k) for m, s in zip(masks, (shell, -shell))]
    weights = _pair_weights(inputs, masks, int(aux.alive.sum()), caps, coverage_target)
    return tuple((idx, w, coef) for (idx, _, coef, _), w in zip(inputs, weights))


def _pair_weights(inputs, masks, alive: int, caps: dict, coverage_target: float) -> list:
    """The [C, K] effective weights of both graphs: `effective_weights`'
    bucket growth and far-bucket shrink, with the two graphs' drops and far
    demands taken together (trainer.refresh_knn_cache)."""
    caps.setdefault("_far_quiet", 0)
    K = inputs[0][0].shape[1]
    budget = (1.0 - coverage_target) * max(alive * K, 1)

    def prepare():
        return [prepare_knn_graph(idx, w, coef, pts, pts_valid=m, spill_a=caps["spill_a"],
                                  spill_b=caps["spill_b"], far_capacity=caps["far"])
                for (idx, w, coef, pts), m in zip(inputs, masks)]

    def demand(gs):
        return max(int(g.n_far) for g in gs)
    while True:
        gs = prepare()
        ovf = (gs[0].overflow + gs[1].overflow).tolist()
        if sum(ovf) <= budget:
            break
        grew = False
        for i, name in enumerate(("spill_a", "spill_b")):
            if ovf[i] > budget / 3 and caps[name] < KNN_CAPS_MAX[name]:
                caps[name] *= 2
                grew = True
        if ovf[2] > budget / 3 and caps["far"] < KNN_CAPS_MAX["far"]:
            caps["far"] = min(max(_snug_far(demand(gs)), caps["far"] + (1 << 17)),
                              KNN_CAPS_MAX["far"])
            grew = True
        if not grew:
            break
    want = max(1 << 15, _snug_far(max(demand(gs), 1)))
    if want < caps["far"]:
        caps["_far_quiet"] += 1
        if caps["_far_quiet"] >= 3:
            caps["far"], caps["_far_quiet"] = want, 0
            gs = prepare()
    else:
        caps["_far_quiet"] = 0
    out = []
    for g, (idx, *_) in zip(gs, inputs):
        w_id = torch.zeros((g.pi.shape[0], K), dtype=torch.float32, device=idx.device)
        w_id[g.pi] = g.w
        out.append(w_id[:idx.shape[0]])
    return out


def frame_and_tongue(params, aux, dparams, cfg: S.StepConfig, view, proj, campos, time):
    """One served frame's image [3, H, W] and its blended tongue channel
    [1, H, W] (no camera id: eval mode), as `step.frame`."""
    dev = params.xyz.device
    s = RenderSettings(view, proj, campos, torch.tensor(float(time), device=dev), None)
    with torch.no_grad():
        out = render(params, aux, dparams, cfg.hidden, s, cfg.raster, _bg(cfg, dev),
                     **S._render_kw(cfg, 10 ** 9))
    return out["render"], out["tongue_mask"]


def _bg(cfg: S.StepConfig, device):
    return torch.full((3,), 1.0 if cfg.white_background else 0.0, device=device)


def _tongue_terms(gp, aux, dp, batch: dict, t_graph, r_last: dict, kw: dict,
                  cfg: S.StepConfig) -> dict:
    """{term: value} of the tongue terms of the batch's last camera, whose
    render is `r_last`: its two sub-renders are made here."""
    dev = aux.alive.device
    b = batch["gt_image"].shape[0] - 1
    s = RenderSettings(batch["viewmatrix"][b], batch["projmatrix"][b], batch["campos"][b],
                       batch["time"][b], batch["cam_no"][b])
    gt, mask = batch["gt_image"][b], batch["tongue_gt"][b]
    terms = {"tongue_l1": L.l1_loss(mask[None], r_last["tongue_mask"][None],
                                    keepdim=True).mean(),
             "tongue_emb": S.knn_loss(gp.embedding, t_graph)}
    gate = torch.mean(mask)
    r = render(gp, aux, dp, cfg.hidden, s, cfg.raster, _bg(cfg, dev), tongue_filter="only",
               **kw)
    t_rgb = torch.mean(torch.abs(gt * mask - r["render"] * mask))
    terms["tongue_rgb"] = torch.where(gate > MASK_GATE, t_rgb / torch.clamp_min(gate, 1e-8),
                                      torch.zeros_like(t_rgb))
    inv = 1.0 - mask
    r = render(gp, aux, dp, cfg.hidden, s, cfg.raster, _bg(cfg, dev), tongue_filter="without",
               **kw)
    terms["wo_tongue_rgb"] = (torch.mean(torch.abs(gt * inv - r["render"] * inv))
                              / torch.clamp_min(torch.mean(inv), 1e-8))
    return terms


def loss_and_grads(params: dict, aux, batch: dict, graphs, iteration: int, cfg: S.StepConfig,
                   tongue: bool = True):
    """(loss, {term: value}, {path: gradient}, viewspace gradient [C, 2],
    radii, visible) of one step on the graphs (main, tongue): a copy of
    `step.loss_and_grads` with the tongue terms (`tongue`) added to the loss
    before its one backward, as the program adds them (the deformation's
    bf16 backward rounds the sum of a render's cotangents, so a backward a
    term would round apart)."""
    opt = cfg.opt
    flat = flatten_params(params)
    leaves = {p: t.detach().requires_grad_(True) for p, t in flat.items()}
    tree = unflatten_params(leaves)
    gp, dp = tree["gaussians"], tree["deform"]
    C = aux.alive.shape[0]
    B = batch["gt_image"].shape[0]
    dev = aux.alive.device
    offsets = torch.zeros((B, C, 2), device=dev, requires_grad=True)
    kw = dict(S._render_kw(cfg, iteration),
              active_sh_degree=min(iteration // 1000, cfg.sh_degree))
    renders = []
    for b in range(B):
        s = RenderSettings(batch["viewmatrix"][b], batch["projmatrix"][b], batch["campos"][b],
                           batch["time"][b], batch["cam_no"][b])
        renders.append(render(gp, aux, dp, cfg.hidden, s, cfg.raster, _bg(cfg, dev),
                              mean2d_offset=offsets[b], **kw))
    image = torch.stack([r["render"] for r in renders])
    gt = batch["gt_image"]
    loss = torch.mean(L.l1_loss(image, gt, keepdim=True))
    if batch["use_ssim"]:
        loss = loss + opt.lambda_dssim * ((1.0 - L.ssim(image, gt)) / 2.0)
    if opt.opacity_l1_coef_fine > 0:
        loss = loss + opt.opacity_l1_coef_fine * L.opacity_mean_loss(gp.opacity, aux.alive)
    loss = loss + opt.reg_coef * S.knn_loss(gp.embedding, graphs[0])
    if opt.coef_tv_temporal_embedding > 0:
        loss = loss + opt.coef_tv_temporal_embedding * L.temporal_tv_loss(dp["weight"])
    if iteration >= opt.radegs_regularization_from_iter:
        r, rc = renders[-1], cfg.raster
        loss = loss + opt.lambda_depth_normal * L.depth_normal_loss(
            r["normal"], r["expected_depth"], r["median_depth"], rc.width, rc.height,
            rc.focal_x, rc.focal_y)
    terms = {}
    if tongue:
        terms = _tongue_terms(gp, aux, dp, batch, graphs[1], renders[-1], kw, cfg)
        for name, weight in zip(TERMS, (5.0, opt.reg_coef, 1.0, 0.5)):
            loss = loss + weight * terms[name]
    grads = torch.autograd.grad(loss, [*leaves.values(), offsets], allow_unused=True)
    g = {p: torch.zeros_like(leaves[p]) if d is None else d for p, d in zip(leaves, grads)}
    radii = torch.stack([r["radii"] for r in renders]).amax(dim=0)
    visible = torch.stack([r["visibility_filter"] for r in renders]).any(dim=0)
    return (loss.detach(), {k: v.detach() for k, v in terms.items()}, g, grads[-1].sum(dim=0),
            radii, visible)


class Trainer(S.Trainer):
    """`step.Trainer` (its update and densify event) on the graphs (main,
    tongue) of `knn_graphs`, its step with the tongue terms (`tongue`)."""

    def __init__(self, params: dict, aux, cfg: S.StepConfig, tongue: bool = True):
        super().__init__(params, aux, cfg)
        self.tongue = tongue

    def step(self, batch: dict, graphs, iteration: int) -> dict:
        loss, terms, grads, vs_grad, radii, visible = loss_and_grads(
            self.params, self.aux, batch, graphs, iteration, self.cfg, self.tongue)
        self.params, self.opt_state = self.optimizer.update(grads, self.opt_state, self.params)
        self.aux = add_densification_stats(self.aux, vs_grad, visible, radii)
        return {"loss": loss, "grads": grads, "tongue": terms}
