"""The harness's clock an iteration, less the time its read of l1_items
waited for the card, averaged over the window."""


def read(ctx):
    w = ctx["window"]
    d = [a - b for a, b in zip(w["iter_ms"], w["read_wait_ms"])]
    return sum(d) / len(d) if d else None
