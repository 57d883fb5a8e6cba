"""Device ms of the train step's "tongue" stage (the tongue terms: the
last camera's tongue-only and tongue-free renders, each deforming the whole
cloud, and the KNN loss on the tongue graph; their backward stays in
"backward"): ed3dgs_torch's own stage stamps (ed3dgs_torch/utils/trace.py
`summary()`), averaged over the step region's last 16 graph replays. None
where the program has no stamps, no such stage or no such call."""


def read(ctx):
    if not ctx.get("trace"):        # a run without --trace 1: nothing read
        return None
    try:
        from ed3dgs_torch.utils import trace
    except ImportError:
        return None
    r = trace.summary()["regions"].get("step")
    return r["stage_ms"].get("tongue") if r and r.get("rows") else None
