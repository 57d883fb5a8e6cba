"""Every cell, configuration, traffic mix, limit file and metric that
BENCHMARK.json names is found by its name, and keeps to the allowed
characters."""

import json
import os
import re

import pytest

from harness import cell

ROOT = os.path.dirname(cell.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_keep_to_the_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["traffic"] for w in b["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    for group in (b["configs"], b["workloads"], b["end_to_end"] + b["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_each_cell_is_found_by_name(workload):
    spec = cell.cell_spec(bench(), workload)
    assert spec["config"]["name"] == spec["workload"]["config"]
    assert spec["traffic"]["loop"] in ("train", "render")
    assert spec["limits"]
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(cell.reader(m["name"]))


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    bench()["end_to_end"] + bench()["per_layer"]])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    ctx = dict(kind="train", cfg={}, window={"iter_ms": [], "read_wait_ms": [], "densify_ms": [],
                                             "latency_ms": [], "host_ms": [], "seconds": 1.0},
               setup_s=1.0, peak_bytes=0)
    v = cell.reader(metric)(ctx)
    assert v is None or metric == "setup_s"


def test_each_config_file_is_its_own_and_names_its_sources():
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert os.path.isfile(os.path.join(ROOT, cfg["repo_config"]))
        assert cfg["assumed"]


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_each_loop_is_the_cell_of_its_module(workload):
    spec = cell.cell_spec(bench(), workload)
    c = cell.make_cell(spec, 1, "cpu")
    assert type(c).__module__ == "harness." + spec["traffic"]["loop"]
