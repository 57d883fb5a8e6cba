"""A whole run of a small cell on the CPU (the harness's look for a chip
skipped), correct as it stands, and not correct with the timed path broken
underneath: a step that returns its state unchanged, a step whose answer is
altered where it is produced, a frame whose image is altered. (One chip
and batch 1: no exchange between chips, no half batch to leave out.)"""

import json
import os

import pytest
import torch

from harness import cell
from small import small_spec

ROOT = os.path.dirname(cell.HERE)
SEED = 2 ** 31 + 11


def run(workload, fault=None):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return cell.run_cell(bench, workload, SEED, 0.5, False, device="cpu",
                         spec=small_spec(workload), fault=fault)["result"]


def unchanged(c):
    step = c.step_fn

    def same(state, aux, batch, cache):
        keep = type(state)(*(_clone(x) for x in state))
        _, aux2, metrics = step(state, aux, batch, cache)
        return keep, aux2, metrics
    c.step_fn = same


def altered(c):
    step = c.step_fn

    def moved(state, aux, batch, cache):
        state, aux, metrics = step(state, aux, batch, cache)
        state.params["gaussians"].xyz.add_(1e-3)
        return state, aux, metrics
    c.step_fn = moved


def image_altered(c):
    renderer = c.renderer

    def moved(*args, **kw):
        out = dict(renderer(*args, **kw))
        img = out["render"].clone()
        img[:, 0, 0] += 0.05
        out["render"] = img
        return out
    c.renderer = moved


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_clone(v) for v in x)
    if hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    return x


@pytest.mark.parametrize("workload", ["nersemble_default.train", "nersemble_default.render"])
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"], r["check"]
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("workload,fault", [("nersemble_default.train", unchanged),
                                            ("nersemble_default.train", altered),
                                            ("nersemble_default.render", image_altered)])
def test_broken_timed_path_is_not_correct(workload, fault):
    r = run(workload, fault)
    assert not r["correct"], r["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203])
@pytest.mark.parametrize("workload,fault", [
    ("nersemble_default.train", unchanged), ("nersemble_default.train", altered),
    ("nersemble_default.render", image_altered), ("dynerf_cook_spinach.train", unchanged),
    ("dynerf_cook_spinach.train", altered)])
def test_broken_timed_path_is_not_correct_on_the_card(card, workload, fault, seed):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    out = cell.run_cell(bench, workload, seed, 2.0, False, device=card, fault=fault)
    print(workload, fault.__name__, seed, out["result"]["check"])
    assert not out["result"]["correct"], out["result"]["check"]


def test_gradient_is_held_at_the_worst_leaf():
    """One leaf's gradient off by 10% fails the gradient gap, though the
    median leaf agrees."""
    ref = {"loss": [1.0], "grad_norms": {f"l{i}": 1.0 for i in range(9)},
           "change_norms": {f"l{i}": 1.0 for i in range(9)}}
    got = {"loss": [1.0], "grad_norms": dict(ref["grad_norms"], l3=1.1),
           "change_norms": dict(ref["change_norms"])}
    checks = cell.compare(got, ref)
    assert checks["grad_gap"] == pytest.approx(0.1)
    assert checks["_grad_worst_leaf"] == "l3" and checks["_grad_median_gap"] == 0.0


@pytest.mark.parametrize("group,key,value", [("opt", "batch_size", 2),
                                             ("model", "tongue_mask_loss_enabled", True),
                                             ("model", "colmap_supervision_enabled", True)])
def test_train_loop_refuses_what_it_does_not_drive(group, key, value):
    spec = small_spec("nersemble_default.train")
    spec["config"][group] = dict(spec["config"][group], **{key: value})
    c = cell.make_cell(spec, SEED, "cpu")
    with pytest.raises(ValueError, match=key):
        c.make_inputs()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["nersemble_default.train", "dynerf_cook_spinach.train"])
def test_followed_steps_are_graph_replays_on_the_card(card, workload):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    out = cell.run_cell(bench, workload, 2 ** 31 + 301, 2.0, False, device=card)
    assert out["notes"]["_followed_replays"] == [True, True, True]
    assert out["result"]["correct"], out["result"]["check"]
