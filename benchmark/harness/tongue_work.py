"""The arithmetic of the tongue cell's shares (harness/train_tongue.py):
three renders a step (the camera, tongue-only, tongue-free), so three
launches of K1 and of K2 a step, and two KNN losses.

Each sampled step's work is {"views": [camera, tongue-only, tongue-free]
blend work (common.view_work), "tongue_alive": n}."""

from __future__ import annotations

import work

RENDERS = 3         # renders, and launches of K1 and of K2, a tongue step
KNN_K = 20


def _k1(w) -> float:
    return work.least_s(**work.k1_work(w["tiles"], w["rows_read"], w["evals"], w["includes"]))


def _k2(w) -> float:
    return work.least_s(**work.k2_work(w["tiles"], w["rows"], w["live_rows"], w["evals"],
                                       w["includes"]))


BOUND = {"K1": _k1, "K2": _k2}


def kernel_share(ctx: dict, kid: str):
    """100 x the sampled steps' three renders' least time over the device
    time of their launches, or None where the trace lacks a sampled step's
    launches. Launches 3i..3i+2 of the window are step i's (summed, so the
    order of the three within a step does not matter)."""
    launches = sorted(ctx.get("trace", {}).get("launches", {}).get(kid, []))
    least = spent = 0.0
    for i, w in ctx.get("work", []):
        if RENDERS * i + RENDERS > len(launches):
            return None
        least += sum(BOUND[kid](v) for v in w["views"])
        spent += sum(d for _, d in launches[RENDERS * i:RENDERS * i + RENDERS]) * 1e-6
    return 100.0 * least / spent if spent > 0 else None


def least_s(ctx: dict) -> float:
    """The least time the tongue objective's step needs, averaged over the
    sampled steps: the deformation MLP once, forward and backward (all three
    renders deform at one time), at the bf16 peak; K1's and K2's bounds for
    the three renders; and the two KNN losses' bytes (over the non-tongue
    and over the tongue rows) and the rest of the step's at the HBM rate."""
    cfg, h = ctx["cfg"], ctx["cfg"]["hidden"]
    n, E = ctx["alive"], h["gaussian_embedding_dim"]
    samples = ctx["work"]
    n_t = sum(w["tongue_alive"] for _, w in samples) / len(samples)
    fixed = work.least_s(bf16_flops=work.mlp_flops(n, h, backward=True))
    fixed += work.least_s(nbytes=work.knn_loss_bytes(n - n_t, E, KNN_K)
                          + work.knn_loss_bytes(n_t, E, KNN_K)
                          + work.step_rest_bytes(n, E, work.mlp_params(h), cfg["width"],
                                                 cfg["height"]))
    blend = sum(_k1(v) + _k2(v) for _, w in samples for v in w["views"])
    return fixed + blend / len(samples)
