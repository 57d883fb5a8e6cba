"""The control of the comparison: the reference one precision step below
the configuration's (fp8 operands in the deformation MLP, TF32 float32
matmuls) put in the program's place must come out not correct. On the CPU
at the small size (fp8 alone: the CPU has no TF32), and on the card at each
cell's own size on three seeds."""

import json
import os

import pytest

from harness import cell
from small import small_spec

ROOT = os.path.dirname(cell.HERE)
WORKLOADS = ["nersemble_default.train", "nersemble_default.render",
             "dynerf_cook_spinach.train"]


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", ["nersemble_default.train", "nersemble_default.render"])
def test_control_is_not_correct_at_the_small_size(workload):
    r = cell.run_cell(bench(), workload, 2 ** 31 + 3, 0.5, False, device="cpu",
                      spec=small_spec(workload), control=True)["result"]
    assert not r["correct"], r["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_on_the_card(card, workload, seed):
    names = {w["name"] for w in bench()["workloads"]}
    if workload not in names:
        pytest.skip(f"{workload} is not a cell of BENCHMARK.json")
    r = cell.run_cell(bench(), workload, seed, 2.0, False, device=card, control=True)["result"]
    assert not r["correct"], r["check"]
