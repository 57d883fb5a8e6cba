"""The graph keys of the upstream dataset families' training schedules.

A graphed step captures one CUDA graph per `StepBranches` key (the active
SH degree, the SSIM gate, the depth-normal term, the COLMAP gate), as
tests/test_torch_graph_step.py's `test_nersemble_run_meets_seven_keys`
counts them for configs/nersemble/default.py. Here each per-scene file of
chip_smoke.py's 5c runs its whole schedule through `CameraSampler` as
tools/train.py samples it; the set of keys it meets, and the first
iteration (the state's count) that meets each, are pinned. chip_smoke.py
5c replays every one of them on the card (`schedule_keys`).

DyNeRF: SH 0-3, SSIM from `random_until` (10,000) on the five multiview
iterations of every 50, depth-normal from 15,000: seven keys. Technicolor:
`random_until` 60,000, after the depth-normal term starts, so SSIM never
meets SH 3 without it: six keys. HyperNeRF: `num_multiview_ssim` 0, so the
SSIM gate opens on every tenth error-sampled iteration from 10,000 (its
weight `lambda_dssim` is 0, but the key and the SSIM computation are
there, as in the JAX tool): seven keys."""

import os

import numpy as np
import pytest

from ed3dgs_torch.config.loader import load_full_config
from ed3dgs_torch.train import trainer
from ed3dgs_torch.train.sampling import CameraSampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (sh, ssim, depth-normal) -> the first iteration that meets it
BASE = {(0, False, False): 0, (1, False, False): 1000, (2, False, False): 2000,
        (3, False, False): 3000}
KEYS = {
    "configs/dynerf/cook_spinach.py": {**BASE, (3, True, False): 9999,
                                       (3, True, True): 15000, (3, False, True): 15004},
    "configs/technicolor/Birthday.py": {**BASE, (3, False, True): 15000,
                                        (3, True, True): 59999},
    "configs/hypernerf/vrig-chicken.py": {**BASE, (3, True, False): 9999,
                                          (3, False, True): 15000, (3, True, True): 15009},
}


@pytest.mark.parametrize("path", list(KEYS))
def test_family_schedule_meets_its_keys(path):
    cfg = load_full_config(os.path.join(REPO, path))
    opt, model = cfg.opt, cfg.model
    setup = trainer.TrainSetup(raster=None, hidden=cfg.hidden, batch_size=opt.batch_size,
                               radegs_from_iter=opt.radegs_regularization_from_iter,
                               sh_degree=model.sh_degree,
                               colmap_supervision=model.colmap_supervision_enabled,
                               deform_from_iter=cfg.hidden.deform_from_iter)
    centers = np.stack([np.cos(np.arange(16) * 0.4), np.sin(np.arange(16) * 0.4),
                        np.zeros(16)], 1)
    sampler = CameraSampler(
        num_cams=16, maxtime=opt.maxtime, camera_centers=centers, batch_size=opt.batch_size,
        random_until=opt.random_until, num_multiview_ssim=opt.num_multiview_ssim,
        sequential=model.sampling_sequential_frame_enabled,
        first_frame_then_sequential=model.sampling_first_frame_then_sequential_enabled,
        first_frame_change=model.sampling_first_frame_change,
        is_sample_from_past=model.is_sample_from_past,
        preference_frames=tuple(model.frame_indices_higher_preference),
        preference_probability=model.frame_preference_probability, seed=0)
    first = {}
    for iteration in range(1, opt.iterations + 1):   # the tool's loop; the state's count
        _, _, use_ssim = sampler.sample(iteration, opt.iterations)   # is iteration - 1
        key = trainer.step_branches(setup, iteration - 1,
                                    {"use_ssim": use_ssim, "pcd_valid": True})
        assert not key.colmap
        first.setdefault((key.active_sh_degree, key.use_ssim, key.depth_normal), iteration - 1)
    assert first == KEYS[path]
