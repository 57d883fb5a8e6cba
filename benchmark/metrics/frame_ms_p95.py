"""The 95th percentile of all the window's request latencies (its start to
image on the host), linearly interpolated between order statistics."""

import numpy as np


def read(ctx):
    lat = ctx["window"]["latency_ms"]
    return float(np.percentile(np.asarray(lat), 95)) if lat else None
