"""The arithmetic of the per-layer shares from a traced run's context: a
kernel's share of its roofline over the sampled views' launches, and the
whole step's or frame's share of the chip's peak."""

from __future__ import annotations

import work


def kernel_share(ctx: dict, kid: str):
    """100 x the sampled launches' least time over their device time, or
    None where the trace holds no launch of the kernel for a sampled view.
    Launch i of the window is view i's (one launch of K1 and K2 a step or a
    frame)."""
    launches = sorted(ctx.get("trace", {}).get("launches", {}).get(kid, []))
    least = spent = 0.0
    for i, w in ctx.get("work", []):
        if i >= len(launches):
            return None
        if kid == "K1":
            least += work.least_s(**work.k1_work(w["tiles"], w["rows_read"], w["evals"],
                                                 w["includes"]))
        else:
            least += work.least_s(**work.k2_work(w["tiles"], w["rows"], w["live_rows"],
                                                 w["evals"], w["includes"]))
        spent += launches[i][1] * 1e-6
    return 100.0 * least / spent if spent > 0 else None


def least_s(ctx: dict, train: bool) -> float:
    """The least time a step (train) or a frame needs, averaged over the
    sampled views: the MLP's matmul flops at the bf16 peak, K1's (and K2's)
    bound, and (train) the KNN regulariser's and the rest's bytes at the
    HBM rate."""
    cfg, h = ctx["cfg"], ctx["cfg"]["hidden"]
    n, E = ctx["alive"], h["gaussian_embedding_dim"]
    W, H = cfg["width"], cfg["height"]
    P = work.mlp_params(h)
    fixed = work.least_s(bf16_flops=work.mlp_flops(n, h, backward=train))
    if train:
        fixed += work.least_s(nbytes=work.knn_loss_bytes(n, E, 20)
                              + work.step_rest_bytes(n, E, P, W, H))
    else:
        fixed += work.least_s(nbytes=work.frame_rest_bytes(n, E, P, W, H))
    views = ctx["work"]
    blend = 0.0
    for _, w in views:
        blend += work.least_s(**work.k1_work(w["tiles"], w["rows_read"], w["evals"],
                                             w["includes"]))
        if train:
            blend += work.least_s(**work.k2_work(w["tiles"], w["rows"], w["live_rows"],
                                                 w["evals"], w["includes"]))
    return fixed + blend / len(views)
