"""The host ms a request outside its wait for the image, averaged over the
window."""


def read(ctx):
    h = ctx["window"]["host_ms"]
    return sum(h) / len(h) if h else None
