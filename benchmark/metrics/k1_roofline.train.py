"""K1's share of its roofline over the sampled views' launches in the
traced window (harness/shares.py), in %."""

from harness import shares


def read(ctx):
    return shares.kernel_share(ctx, "K1")
