"""The tongue train cell (harness/train_tongue.py) at a small size on the
CPU: a sound run is correct with every tongue term live on the followed
steps; the control, a tongue-free render given the tongue-only filter, and
a step that returns its state unchanged are not. Its shares
(harness/tongue_work.py) against counts made by hand. On the card, at the
cell's own size: the followed steps are graph replays and correct, and the
control and the broken steps are not."""

import json
import os

import pytest

import work
from harness import cell, tongue_work, train_tongue
from small import small_spec
from test_bench_faults import altered, unchanged

ROOT = os.path.dirname(cell.HERE)
WORKLOAD = "nersemble_tongue.train"
SEED = 2 ** 31 + 13


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def small():
    spec = small_spec(WORKLOAD)
    spec["config"]["tongue"] = dict(spec["config"]["tongue"], gaussians=150)
    return spec


def run(fault=None, control=False, spec=None):
    return cell.run_cell(bench(), WORKLOAD, SEED, 0.5, False, device="cpu",
                         spec=spec or small(), fault=fault, control=control)


def test_sound_run_is_correct_with_every_tongue_term_live():
    out = run()
    r = out["result"]
    assert r["correct"], r["check"]
    assert list(r["check"]) == ["loss_gap", "grad_gap", "change_gap", "tongue_gap"]
    program, reference = out["notes"]["_tongue_terms"]
    assert len(program) == 3
    assert all(step[k] > 0 for step in program + reference for k in train_tongue.TERMS)
    assert all(p[0] > 0 and p[1] > 0 for p in out["notes"]["_tongue_pairs"])


def test_control_is_not_correct():
    r = run(control=True)["result"]
    assert not r["correct"], r["check"]


def test_a_tongue_free_render_given_the_tongue_only_filter_is_not_correct(monkeypatch):
    from ed3dgs_torch.train import trainer
    render_one = trainer._render_one

    def planted(*args, **kw):
        return render_one(*(("only" if isinstance(a, str) and a == "without" else a)
                            for a in args), **kw)
    monkeypatch.setattr(trainer, "_render_one", planted)
    r = run()["result"]
    assert not r["correct"]
    assert r["check"]["tongue_gap"]["value"] > r["check"]["tongue_gap"]["limit"], r["check"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct():
    r = run(fault=unchanged)["result"]
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("group,key,value", [("opt", "batch_size", 2),
                                             ("model", "tongue_mask_loss_enabled", False),
                                             ("model", "colmap_supervision_enabled", True)])
def test_tongue_loop_refuses_what_it_does_not_drive(group, key, value):
    spec = small()
    spec["config"][group] = dict(spec["config"][group], **{key: value})
    c = cell.make_cell(spec, SEED, "cpu")
    with pytest.raises(ValueError, match="tongue loop"):
        c.make_inputs()


def test_tongue_gap_is_the_worst_term_of_any_step():
    want = [dict.fromkeys(train_tongue.TERMS, 1.0), dict(dict.fromkeys(train_tongue.TERMS, 1.0),
                                                         tongue_rgb=0.0)]
    got = [dict(want[0], tongue_emb=1.02), dict(want[1], wo_tongue_rgb=1.05)]
    assert train_tongue.tongue_gap(got, want) == (pytest.approx(0.05), [1, "wo_tongue_rgb"])
    got[1]["tongue_rgb"] = 1e-9                    # a gated term read as live
    assert train_tongue.tongue_gap(got, want)[0] == float("inf")


W = dict(tiles=1000, rows=10_000, rows_read=10_000, live_rows=8000, evals=10 ** 8,
         includes=10 ** 7)


def test_kernel_share_sums_each_steps_three_launches():
    least = (14 * 10 ** 8 + 45 * 10 ** 7) / 67e12        # K1's ops bound a view
    # step 0's three launches take 1, 2, 3 x least; step 1's are not read
    launches = [(0.0, 1e6 * least), (1.0, 2e6 * least), (2.0, 3e6 * least),
                (3.0, 5.0), (4.0, 5.0), (5.0, 5.0)]
    sample = {"views": [W, W, W], "tongue_alive": 10}
    c = dict(trace={"launches": {"K1": launches}}, work=[(0, sample)])
    assert tongue_work.kernel_share(c, "K1") == pytest.approx(50.0)
    c["work"] = [(2, sample)]                      # launches 6..8 are missing
    assert tongue_work.kernel_share(c, "K1") is None


def test_least_time_counts_the_deformation_once():
    h = dict(net_width=128, defor_depth=1, temporal_embedding_dim=256,
             gaussian_embedding_dim=32, max_embeddings=150, max_cameras=30)
    cfg = {"hidden": h, "width": 802, "height": 550}
    sample = {"views": [W, dict(W, evals=10 ** 7), dict(W, includes=0)], "tongue_alive": 3000}
    ctx = dict(cfg=cfg, alive=100_000, work=[(0, sample), (5, sample)])
    blend = sum(work.least_s(**work.k1_work(v["tiles"], v["rows_read"], v["evals"],
                                            v["includes"]))
                + work.least_s(**work.k2_work(v["tiles"], v["rows"], v["live_rows"], v["evals"],
                                              v["includes"])) for v in sample["views"])
    fixed = (work.least_s(bf16_flops=work.mlp_flops(100_000, h, backward=True))
             + work.least_s(nbytes=work.knn_loss_bytes(97_000, 32, 20)
                            + work.knn_loss_bytes(3000, 32, 20)
                            + work.step_rest_bytes(100_000, 32, work.mlp_params(h), 802, 550)))
    assert tongue_work.least_s(ctx) == pytest.approx(fixed + blend)


@pytest.mark.cuda
def test_followed_steps_are_graph_replays_and_correct_on_the_card(card):
    out = cell.run_cell(bench(), WORKLOAD, 2 ** 31 + 301, 2.0, False, device=card)
    assert out["notes"]["_followed_replays"] == [True, True, True]
    assert out["result"]["correct"], out["result"]["check"]
    program, _ = out["notes"]["_tongue_terms"]
    assert all(step[k] > 0 for step in program for k in train_tongue.TERMS)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103])
@pytest.mark.parametrize("fault", [None, unchanged, altered])
def test_control_and_broken_steps_are_not_correct_on_the_card(card, fault, seed):
    out = cell.run_cell(bench(), WORKLOAD, seed, 2.0, False, device=card, fault=fault,
                        control=fault is None)
    print(WORKLOAD, getattr(fault, "__name__", "control"), seed, out["result"]["check"])
    assert not out["result"]["correct"], out["result"]["check"]
