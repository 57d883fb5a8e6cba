"""Requests completed over the window's seconds."""


def read(ctx):
    w = ctx["window"]
    return len(w["latency_ms"]) / w["seconds"] if w["latency_ms"] else None
