"""Device ms of the train step's "backward" stage: ed3dgs_torch's own stage
stamps (ed3dgs_torch/utils/trace.py `summary()`), averaged over the step
region's last 16 graph replays. None where the program has no stamps or no
such call."""


def read(ctx):
    if not ctx.get("trace"):        # a run without --trace 1: nothing read
        return None
    try:
        from ed3dgs_torch.utils import trace
    except ImportError:
        return None
    r = trace.summary()["regions"].get("step")
    return r["stage_ms"]["backward"] if r and r.get("rows") else None
