"""Device ms of the densify event's "knn_refresh" stage: ed3dgs_torch's own
stage stamps (ed3dgs_torch/utils/trace.py `summary()`), averaged over the
knn_refresh region's last 16 calls. None where the program has no stamps or
no such call."""


def read(ctx):
    if not ctx.get("trace"):        # a run without --trace 1: nothing read
        return None
    try:
        from ed3dgs_torch.utils import trace
    except ImportError:
        return None
    r = trace.summary()["regions"].get("knn_refresh")
    return r["stage_ms"]["knn_refresh"] if r and r.get("rows") else None
