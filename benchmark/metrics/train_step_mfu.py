"""The least time a training step's work needs (harness/shares.py) over the
run's measured ms a step, in %."""

from harness import shares


def read(ctx):
    w = ctx["window"]
    if not w["iter_ms"] or not ctx.get("work"):
        return None
    return 100.0 * shares.least_s(ctx, train=True) / (w["seconds"] / len(w["iter_ms"]))
