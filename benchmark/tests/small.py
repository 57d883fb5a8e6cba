"""A cell's files at a size a CPU test holds: the published widths, a small
image, cloud and rig."""

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_spec(workload: str) -> dict:
    from harness import cell
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        spec = cell.cell_spec(json.load(f), workload)
    cfg = copy.deepcopy(spec["config"])
    cfg.update(width=64, height=48, gaussians=1500, capacity=2048, cameras=4,
               frames_per_camera=1)
    cfg["rig"]["rows"] = 1
    spec["config"] = cfg
    spec["traffic"] = dict(spec["traffic"], traced=2, poses=4, times=4, checked=3)
    return spec
