"""1 - the union of the device's operation intervals over the traced
window's length, in %."""


def read(ctx):
    t = ctx.get("trace")
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t["window_s"] > 0 else None
