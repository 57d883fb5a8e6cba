"""The least time a step of the tongue objective needs
(harness/tongue_work.py: the deformation once, three renders' blends, two
KNN losses) over the run's measured ms a step, in %."""

from harness import tongue_work


def read(ctx):
    w = ctx["window"]
    if not w["iter_ms"] or not ctx.get("work"):
        return None
    return 100.0 * tongue_work.least_s(ctx) / (w["seconds"] / len(w["iter_ms"]))
