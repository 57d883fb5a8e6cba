"""The KNN regulariser of ed3dgs_torch against ed3dgs_tpu's where capacity
buckets drop edges, both on the CPU: graph preparation and the fused loss on
undersized buckets (each of the three lists overflowing, alone and
together), and the trainer's adaptive `refresh_knn_cache`.

Bounds as in tests/test_torch_knn_loss.py: the graph exactly, the loss at
rel 1e-5, the gradient at rtol 1e-4 / atol 1e-6 against JAX in interpret
mode. Past the far list's capacity the JAX graph keeps an edge's weight, so
its loss and dL/de_i count the edge while dL/de_j does not; the port
matches that, not the oracle. `refresh_knn_cache` ends on the same bucket
sizes, overflow counts and far demand, refresh after refresh.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.models import gaussians as jgm
from ed3dgs_tpu.train import trainer as jtrainer

from ed3dgs_torch.models import gaussians as tgm
from ed3dgs_torch.ops import knn_loss as tkl
from ed3dgs_torch.train import trainer as ttrainer

from test_torch_knn_loss import (OVERFLOW_CASES, check_graph, check_loss, jax_case,
                                 jitted_prepare, problem, torch_graph)


@pytest.mark.parametrize("name", OVERFLOW_CASES)
def test_prepare_knn_graph_matches_jax(name):
    check_graph(name)


@pytest.mark.parametrize("name", OVERFLOW_CASES)
def test_knn_loss_fused_matches_jax(name):
    check_loss(name)


def test_overflow_cases_overflow_as_named():
    assert (jax_case("overflow-256")["overflow"] > 0).all()
    assert jax_case("spill-b-drops")["overflow"][1] > 0
    ovf = jax_case("spill-b-only")["overflow"]
    assert ovf[0] == 0 and ovf[1] > 0 and ovf[2] == 0
    for name in ("oracle-1200-spatial", "spill-2048"):
        assert jax_case(name)["overflow"].sum() == 0 and jax_case(name)["n_far"] > 0


def test_knn_loss_is_deterministic_with_drops():
    K, emb, *_ = problem("overflow-256")
    e = torch.as_tensor(np.asarray(emb))
    a = tkl._run(e, torch_graph("overflow-256"), K)
    b = tkl._run(e, torch_graph("overflow-256"), K)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def refresh_cloud(n=2200, seed=4, tongue=False):
    """An all-alive cloud (the bench cloud's kind: uniform in a box) in
    both packages' GaussianParams/GaussianAux."""
    rng = np.random.default_rng(seed)
    xyz = (rng.uniform(-1, 1, (n, 3)) * [1.0, 0.7, 1.2] + [0, 0, 2.3]).astype(np.float32)
    tclass = ((rng.uniform(size=(n, 1)) > 0.7) if tongue else np.zeros((n, 1))).astype(
        np.float32)
    fields = {"xyz": xyz, "features_dc": np.zeros((n, 1, 3)), "features_rest": np.zeros((n, 15, 3)),
              "scaling": np.zeros((n, 3)), "rotation": np.tile([1.0, 0, 0, 0], (n, 1)),
              "opacity": np.zeros((n, 1)), "embedding": np.zeros((n, 32)),
              "tongue_class": tclass}
    tp, ta = tgm.from_numpy(fields, device="cpu")
    jp = jgm.GaussianParams(**{k: jnp.asarray(np.asarray(fields[k], np.float32))
                               for k in jgm.GaussianParams._fields})
    ja = jgm.GaussianAux(alive=jnp.ones(n, bool), tongue_class=jnp.asarray(tclass),
                         filter_3d=jnp.zeros((n, 1)), max_radii2d=jnp.zeros(n),
                         xyz_grad_accum=jnp.zeros(n), denom=jnp.zeros(n))
    return (jp, ja), (tp, ta)


@pytest.mark.parametrize("tongue,coverage", [(False, 0.95), (True, 0.95), (False, 1.0)])
def test_refresh_knn_cache_matches_jax(tongue, coverage, monkeypatch):
    """From small buckets: the same growth to the same caps, then the far
    bucket's shrink on the third refresh in a row that does not need it
    (the caps start one such refresh in). JAX's graph preparation runs
    compiled (the same graph, faster)."""
    monkeypatch.setattr(jtrainer.knn_loss, "prepare_knn_graph",
                        lambda *a, pts_valid=None, **caps:
                        jitted_prepare(**caps)(*a, pts_valid=pts_valid))
    (jp, ja), (tp, ta) = refresh_cloud(tongue=tongue)
    start = {"spill_a": 256, "spill_b": 256, "far": 1 << 19, "_far_quiet": 1}
    jcaps, tcaps = dict(start), dict(start)
    for _ in range(2):
        jc = jtrainer.refresh_knn_cache(jp, ja, jcaps, tongue_enabled=tongue,
                                        coverage_target=coverage)
        tc = ttrainer.refresh_knn_cache(tp, ta, tcaps, tongue_enabled=tongue,
                                        coverage_target=coverage)
        assert tcaps == jcaps
        for jg, tg in ((jc.graph, tc.graph), (jc.t_graph, tc.t_graph)):
            np.testing.assert_array_equal(tg.overflow.numpy(), np.asarray(jg.overflow))
            assert int(tg.n_far) == int(jg.n_far)
            np.testing.assert_array_equal(tg.pi.numpy(), np.asarray(jg.pi))
    assert tcaps != start                    # the buckets moved
    assert tcaps["far"] < start["far"]       # and the far bucket shrank
    if coverage == 1.0:
        assert int(tc.graph.overflow.sum()) == 0
    assert (tc.t_graph is tc.graph) == (not tongue)
