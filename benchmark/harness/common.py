"""What the train and render cells share: the configuration held to the
program's, the reference's view of it, the scene extent and the 3D filter's
cameras, the pair demand and the work of one view by the benchmark's own
frozen projection, binning and blend."""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import torch

from reference.binning import bin_rows, build_gaussian_payload, tile_grid
from reference.rasterize import RasterConfig
from reference.rasterize_plain import MAX_CHUNKS, rasterize_forward_plain
from reference.render import RenderSettings, project_for_render
from reference.step import StepConfig


def program_config(cfg: dict):
    """The program's configuration of the cell (the repo's config file read
    by the program's loader), held to the cell's file: every key the file
    gives under "model", "hidden" and "opt" must read the same, and every
    published width the same."""
    from ed3dgs_torch.config.loader import load_full_config
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    full = load_full_config(os.path.join(root, cfg["repo_config"]))
    differ = []
    for group in ("model", "hidden", "opt"):
        have = dataclasses.asdict(getattr(full, group))
        for k, v in cfg[group].items():
            got = list(have[k]) if isinstance(have.get(k), tuple) else have.get(k)
            if got != v:
                differ.append(f"{group}.{k}: file {v!r}, program {got!r}")
    for k, v in cfg["widths"].items():
        group = "model" if k in ("sh_degree", "disable_filter3D") else "hidden"
        if getattr(getattr(full, group), k) != v:
            differ.append(f"width {k}: file {v!r}, program {getattr(getattr(full, group), k)!r}")
    if differ:
        raise RuntimeError(f"{cfg['repo_config']} no longer states the cell's configuration: "
                           + "; ".join(differ))
    return full


def step_config(cfg: dict, cams: list, pair_capacity: int) -> StepConfig:
    c0 = cams[0]
    return StepConfig(
        raster=RasterConfig(width=cfg["width"], height=cfg["height"], focal_x=c0["focal_x"],
                            focal_y=c0["focal_y"], pair_capacity=pair_capacity,
                            chunk=cfg["opt"]["raster_chunk"]),
        hidden=SimpleNamespace(**cfg["hidden"]), opt=SimpleNamespace(**cfg["opt"]),
        white_background=cfg["model"]["white_background"],
        kernel_size=cfg["model"]["kernel_size"], sh_degree=cfg["model"]["sh_degree"],
        extent=extent(cams))


def extent(cams: list) -> float:
    """The scene extent the reference's getNerfppNorm gives: 1.1 x the
    largest distance of a camera centre from their mean."""
    c = np.stack([cam["campos"] for cam in cams]).astype(np.float64)
    return 1.1 * float(np.linalg.norm(c - c.mean(0), axis=1).max())


def filter_args(cams: list, device) -> tuple:
    """compute_3d_filter's camera arguments (view matrices, focals, sizes)."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(np.stack([c["world_view"] for c in cams]), **f32),
            torch.tensor([c["focal_x"] for c in cams], **f32),
            torch.tensor([c["focal_y"] for c in cams], **f32),
            torch.full((len(cams),), float(cams[0]["width"]), **f32),
            torch.full((len(cams),), float(cams[0]["height"]), **f32))


def settings(cam: dict, time: float, device, cam_no=None) -> RenderSettings:
    f32 = dict(dtype=torch.float32, device=device)
    return RenderSettings(torch.as_tensor(cam["world_view"], **f32),
                          torch.as_tensor(cam["full_proj"], **f32),
                          torch.as_tensor(cam["campos"], **f32), torch.tensor(time, **f32),
                          None if cam_no is None else torch.tensor(cam_no, device=device))


def _project(params, aux, dparams, scfg: StepConfig, s, iteration):
    h = scfg.hidden
    return project_for_render(
        params, aux, dparams, h, s, scfg.raster, iteration=iteration, sh_degree=scfg.sh_degree,
        kernel_size=scfg.kernel_size, disable_filter3d=False, num_down_emb_c=h.min_embeddings,
        num_down_emb_f=h.min_embeddings)[0]


def demand(params, aux, dparams, scfg: StepConfig, views, iteration) -> int:
    """The largest pair demand of the views [(settings)]: the tiles each
    visible Gaussian touches, summed (the program's `num_pairs`)."""
    most = 0
    with torch.no_grad():
        for s in views:
            p = _project(params, aux, dparams, scfg, s, iteration)
            most = max(most, int(torch.where(p.valid, p.tiles_touched, 0).sum()))
    return most


def view_work(params, aux, dparams, scfg: StepConfig, s, iteration) -> dict:
    """The blend work of one view from the benchmark's frozen projection,
    binning and blend: tiles, pair rows (all, read by the forward, live for
    the backward), needed pair-pixel evaluations and blended splats."""
    rc = scfg.raster
    gx, gy = tile_grid(rc.width, rc.height)
    with torch.no_grad():
        p = _project(params, aux, dparams, scfg, s, iteration)
        bins = bin_rows(p.depth, p.valid, p.tiles_touched, p.rect_min, p.rect_max,
                        grid_x=gx, grid_y=gy, pair_capacity=rc.pair_capacity)
        rows = build_gaussian_payload(p, aux.tongue_class[:, 0])[bins.order.long()]
        pair_payload = rows[bins.pair_gauss.long()]
        stats = {}
        rasterize_forward_plain(pair_payload, bins.tile_start, bins.tile_count, grid_x=gx,
                                grid_y=gy, width=rc.width, height=rc.height,
                                focal_x=rc.focal_x, focal_y=rc.focal_y, chunk=rc.chunk,
                                stats=stats)
        tc = bins.tile_count
        return dict(tiles=gx * gy, rows=int(tc.sum()),
                    rows_read=int(torch.clamp_max(tc, rc.chunk * MAX_CHUNKS).sum()),
                    live_rows=stats.get("live_rows", 0), evals=stats.get("evals", 0),
                    includes=stats.get("includes", 0), pairs=int(bins.num_pairs))
