"""The window's wall ms over the training iterations it completed."""


def read(ctx):
    w = ctx["window"]
    return 1e3 * w["seconds"] / len(w["iter_ms"]) if w["iter_ms"] else None
