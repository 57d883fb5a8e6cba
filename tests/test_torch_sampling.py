"""Camera sampling and the pair-capacity policy of ed3dgs_torch against
ed3dgs_tpu's (train/sampling.py, train/capacity.py): pure numpy / Python in
both, so the bound is equality. Each strategy switch of `CameraSampler`
runs ~500 iterations in both packages from the same seed, both recording
the same losses, and must give the same cameras, frames and SSIM gates at
every iteration; `CapacityPolicy` must make the same decisions on the same
pair-demand trace."""

import numpy as np
import pytest

from ed3dgs_tpu.train.capacity import CapacityPolicy as JPolicy
from ed3dgs_tpu.train.sampling import CameraSampler as JSampler

from ed3dgs_torch.train.capacity import CapacityPolicy
from ed3dgs_torch.train.sampling import CameraSampler

ITERS = 500

STRATEGIES = {
    "default": dict(random_until=200),
    "multiview_ssim": dict(random_until=150, num_multiview_ssim=5, batch_size=2),
    "sequential": dict(sequential=True),
    "sequential_past": dict(sequential=True, is_sample_from_past=True),
    "first_frame_then_sequential": dict(first_frame_then_sequential=True,
                                        first_frame_change=120),
    "preference": dict(preference_frames=(1, 4, 7), preference_probability=0.4,
                       batch_size=3),
}


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_camera_sampler_draws_match_jax(name):
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(6, 3))
    kw = dict(num_cams=6, maxtime=9, camera_centers=centers, seed=11, **STRATEGIES[name])
    ours, theirs = CameraSampler(**kw), JSampler(**kw)
    loss_rng = np.random.default_rng(1)
    gates = 0
    for it in range(1, ITERS + 1):
        c1, f1, s1 = ours.sample(it, ITERS)
        c2, f2, s2 = theirs.sample(it, ITERS)
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2), err_msg=f"{name} {it}")
        np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2), err_msg=f"{name} {it}")
        assert s1 == s2, (name, it)
        gates += bool(s1)
        losses = loss_rng.uniform(0, 1, len(c1))
        ours.record_loss(c1, f1, losses)
        theirs.record_loss(c2, f2, losses)
    np.testing.assert_array_equal(ours.loss_list, theirs.loss_list)
    if name in ("default", "multiview_ssim"):
        assert gates > 0          # the by-error branch and its SSIM gate were reached


def test_capacity_policy_decisions_match_jax():
    """A demand trace that climbs past the capacity, plateaus, then falls
    (so both growing and the patient shrink happen)."""
    rng = np.random.default_rng(2)
    demand = np.concatenate([np.linspace(2e5, 9e5, 800), np.full(1200, 9.2e5),
                             np.linspace(9e5, 2e5, 600), np.full(2500, 1.5e5)])
    demand = (demand * rng.uniform(0.97, 1.03, demand.size)).astype(np.int64)
    ours, theirs = CapacityPolicy(capacity=1 << 19), JPolicy(capacity=1 << 19)
    ours.start(1)
    theirs.start(1)
    changes = []
    for it, d in enumerate(demand, start=1):
        a, b = ours.observe(it, int(d)), theirs.observe(it, int(d))
        assert a == b, it
        if a is not None:
            changes.append(a)
    assert ours.capacity == theirs.capacity
    assert any(x > 1 << 19 for x in changes) and changes[-1] < max(changes)
