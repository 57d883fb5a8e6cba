"""One training step of ed3dgs_torch with the tongue terms on (the tongue
mask L1, the KNN regulariser on the tongue graph, and the tongue-only and
tongue-free renders' colour terms) at reg_coef = 1, against ed3dgs_tpu's
`make_train_step`, both on the CPU. The bounds and the cache check are
tests/test_torch_train_knn.py's, applied to both graphs of the cache.

The JAX step is jitted, as the JAX trainer runs it: with its two extra
interpret-mode renders the eager step takes ~150 s on a CPU, the jitted one
~65 s, and the two agree to 3e-7 in the loss.
"""

import numpy as np
import pytest

from test_torch_train import ITERATION, REL, assert_grads_match
from test_torch_train_knn import check_aux, check_metrics, run_steps

TONGUE_METRICS = ("tongue_l1", "tongue_emb", "tongue_rgb", "wo_tongue_rgb")


@pytest.fixture(scope="module")
def tongue_steps():
    mp = pytest.MonkeyPatch()
    try:
        return run_steps(mp, jit=True, reg_coef=1.0, tongue_enabled=True)
    finally:
        mp.undo()


def test_tongue_step_loss_and_metrics_match_jax(tongue_steps):
    (_, _, jmetrics, _, _), (loss, metrics, *_), (_, _, step_metrics) = tongue_steps
    check_metrics(jmetrics, metrics, step_metrics, loss)
    for k in TONGUE_METRICS:
        assert float(metrics[k]) > 0, k


def test_tongue_step_gradients_match_jax(tongue_steps):
    (_, _, _, jgrads, jvs), (_, _, tgrads, tvs, *_), _ = tongue_steps
    assert_grads_match(jgrads, tgrads)
    assert np.abs(tvs.numpy() - jvs).max() <= REL * np.abs(jvs).max()


def test_tongue_step_aux_update_matches_jax(tongue_steps):
    (_, jaux, _, _, _), _, (tstate, taux, _) = tongue_steps
    check_aux(jaux, taux)
    assert tstate.iteration == ITERATION + 1
