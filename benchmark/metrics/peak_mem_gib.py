"""torch.cuda.max_memory_allocated over the program's set-up and window
(graph pools included), in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / float(1 << 30) if ctx["peak_bytes"] else None
