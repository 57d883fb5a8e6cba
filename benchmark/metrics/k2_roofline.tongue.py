"""K2's share of its roofline over the sampled tongue steps' three
launches each in the traced window (harness/tongue_work.py), in %."""

from harness import tongue_work


def read(ctx):
    return tongue_work.kernel_share(ctx, "K2")
