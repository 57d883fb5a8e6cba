"""The least time a served frame's work needs (harness/shares.py) over the
run's measured seconds a request, in %."""

from harness import shares


def read(ctx):
    w = ctx["window"]
    if not w["latency_ms"] or not ctx.get("work"):
        return None
    return 100.0 * shares.least_s(ctx, train=False) / (w["seconds"] / len(w["latency_ms"]))
