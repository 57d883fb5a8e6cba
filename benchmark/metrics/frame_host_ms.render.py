"""Host ms of the program's "frame" span (FrameRenderer.__call__: scalars,
copy_in, launch), averaged over its last 16 calls that replayed a graph
outside the profiler (ed3dgs_torch/utils/trace.py `summary()`). None where
the program has no such span."""


def read(ctx):
    if not ctx.get("trace"):        # a run without --trace 1: nothing read
        return None
    try:
        from ed3dgs_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("frame")
    return s.get("ms") if s else None
