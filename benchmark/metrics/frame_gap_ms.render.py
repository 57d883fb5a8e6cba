"""Device ms between two served frames: from the last stage stamp of one call
of the frame region to the first of the next (ed3dgs_torch/utils/trace.py
`summary()`), averaged over the last 16 calls' gaps that hold no other
region's call. None where the program has no stamps."""


def read(ctx):
    if not ctx.get("trace"):        # a run without --trace 1: nothing read
        return None
    try:
        from ed3dgs_torch.utils import trace
    except ImportError:
        return None
    r = trace.summary()["regions"].get("frame")
    return r.get("gap_ms") if r else None
