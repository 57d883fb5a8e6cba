"""The kernels' launch counters (csrc/launch_count.cuh, read by
ops/cuda_lib.py `DeviceLaunches`), checked where the CPU can check them: the
header's slots in the order of `cuda_lib.LAUNCH_SLOTS`, each naming the
wrapper it counts for; every kernel of every CUDA source counting into its
wrapper's slot (X1's Morton-code and staging kernels, which every X1 call
also launches, count nothing); every CUDA library exporting the setter; and
`DeviceLaunches` with no counters on any device measuring nothing. What the
counters count on the card is held in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import importlib
import re

import pytest
import torch

from ed3dgs_torch.ops import cuda_lib

HEADER = cuda_lib.CSRC / "launch_count.cuh"

# each kernel (csrc/*.cu) -> the slot it counts into
KERNEL_SLOT = {
    "forward_blend": "SLOT_FORWARD_BLEND", "backward_blend": "SLOT_BACKWARD_BLEND",
    "segment_sum": "GATHER ? SLOT_SEGMENT_SUM : SLOT_SEGMENT_SUM_ROWS",
    "scan_decode": "SLOT_BIN_SCANS", "unpack": "SLOT_UNPACK", "pack": "SLOT_PACK",
    "knn_rows": "SLOT_KNN_ROWS", "knn_rows_wide": "SLOT_KNN_ROWS",
    "knn_reverse": "SLOT_KNN_REVERSE", "knn_select": "SLOT_KNN", "knn_codes": None,
    "knn_stage": None,
}


def header_slots():
    """[(slot name, value, the wrapper its comment names)] of LaunchSlot."""
    body = re.search(r"enum LaunchSlot \{(.*?)\};", HEADER.read_text(), re.S).group(1)
    return [(m.group(1), int(m.group(2)), m.group(3)) for m in
            re.finditer(r"(SLOT_\w+) = (\d+),\s*// \S+\s+(\S+)", body)]


def test_header_slots_are_the_launch_slots_in_order():
    slots = header_slots()
    assert [v for _, v, _ in slots] == list(range(len(cuda_lib.LAUNCH_SLOTS)))
    assert [w for _, _, w in slots] == list(cuda_lib.LAUNCH_SLOTS)
    for wrapper in cuda_lib.LAUNCH_SLOTS:      # each names a wrapper that counts
        mod, fn = wrapper.split(".")
        assert isinstance(getattr(importlib.import_module(f"ed3dgs_torch.ops.{mod}"), fn)
                          .launches, int)


@pytest.mark.parametrize("source", sorted(p.name for p in cuda_lib.CSRC.glob("*.cu")))
def test_every_kernel_counts_its_launches(source):
    text = (cuda_lib.CSRC / source).read_text()
    assert '#include "launch_count.cuh"' in text
    names = {n for n, _, _ in header_slots()}
    kernels = list(re.finditer(
        r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", text))
    assert kernels
    for m in kernels:
        k = m.group(1)
        body = text[text.index("{", m.end()) + 1:]
        body = body[:body.index("\n}")]
        if KERNEL_SLOT[k] is None:
            assert "count_launch" not in body, k
        else:
            first = next(line.strip() for line in body.splitlines()
                         if line.strip() and not line.strip().startswith("//"))
            assert first == f"count_launch({KERNEL_SLOT[k]});", (k, first)
            assert set(re.findall(r"SLOT_\w+", KERNEL_SLOT[k])) <= names


def test_every_cuda_library_exports_the_setter():
    for name, fns in cuda_lib.SIGNATURES.items():
        is_cuda = (cuda_lib.CSRC / f"{name}.cu").exists()
        assert ("ed3dgs_set_launch_counters" in fns) == is_cuda, name


def test_device_launches_without_counters_measure_nothing(monkeypatch):
    monkeypatch.setattr(cuda_lib, "_COUNTERS", {})
    with cuda_lib.DeviceLaunches() as d:
        torch.zeros(3).add_(1)
    assert not d.armed
    assert d.counts == dict.fromkeys(cuda_lib.LAUNCH_SLOTS, 0)
