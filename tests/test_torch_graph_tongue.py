"""The capture-ready train step (`trainer.GraphedTrainStep`) with the tongue
terms and with COLMAP supervision, run eagerly on the CPU against the
port's eager step (the eager step is held to the JAX package's by
tests/test_torch_train_tongue.py and tests/test_torch_train_pcd.py).

On a tiny scene from the port's `generate_scene(tongue_frac=0.2)` (3
cameras, cam00 held out, 2 frames, 40x32; red seeds and segmentations),
read back with its tongue masks, the cloud's tongue class taken from the
red seeds, and the batches staged by `tools.train.stage_batch`:

* tongue: one step, a densify (graphed on the graphed run, eager on the
  eager one) and both refreshes with the tongue graph, then a second step.
  The refresh changes the tongue graph's reverse adjacency (its length),
  and the second step has the first's key, so on the card it replays the
  same graph: here it must read the new graph and equal the eager step;
* COLMAP: three steps with a GT cloud near the Gaussians, pcd_valid True,
  False, True: two keys, the third step the first's again.

After every step every metric, parameter, Adam moment and aux statistic
must equal the eager step's bit for bit, and a host read of a tensor
raises while the capture-ready path runs (test_torch_graph_step.py's
guard)."""

import numpy as np
import pytest
import torch

from ed3dgs_torch.config.params import DeformHiddenConfig, OptimizationConfig
from ed3dgs_torch.data import readers
from ed3dgs_torch.data.synthetic import generate_scene
from ed3dgs_torch.models import gaussians as tgm
from ed3dgs_torch.ops.rasterize import RasterConfig
from ed3dgs_torch.tools.train import stage_batch
from ed3dgs_torch.train import trainer

from test_torch_graph_step import HostReadGuard, assert_trees_equal, state_tensors
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_trajectory import filter_args

W, H, CAP, FRAMES, N_POINTS = 40, 32, 256, 2, 160
ITERATION = 20_000          # deformation, SH 3, depth-normal and the COLMAP term live
PERCENT_DENSE, EXTENT = 0.01, 2.5


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """(cameras, params, aux, hidden config, raster config) of the tongue
    scene: the cloud from its red-seeded ply, embeddings and anisotropic
    scales from a numpy seed, the 3D filter of the train cameras."""
    root = generate_scene(str(tmp_path_factory.mktemp("tongue") / "scene"), n_cams=3,
                          n_frames=FRAMES, width=W, height=H, n_points=N_POINTS, seed=5,
                          tongue_frac=0.2, device="cpu")
    info = readers.read_dynerf_scene(root, duration=FRAMES,
                                     image_loader=readers.make_image_loader(load_tongue=True))
    pts, cols, _ = info.point_cloud
    params, aux = tgm.create_from_points(pts, cols, capacity=CAP, tongue_mask_loss_enabled=True,
                                         device="cpu")
    rng = np.random.default_rng(9)
    params = params._replace(
        embedding=torch.as_tensor(rng.normal(0, 0.3, tuple(params.embedding.shape))
                                  .astype(np.float32)),
        scaling=params.scaling + torch.as_tensor(
            rng.normal(0, 0.4, tuple(params.scaling.shape)).astype(np.float32)))
    cams = sorted(info.train_cameras, key=lambda c: (c.cam_no, c.frame_no))
    aux = aux._replace(filter_3d=tgm.compute_3d_filter(params.xyz, aux.alive,
                                                       *filter_args(cams, torch.as_tensor)))
    m = cams[0].matrices()
    rcfg = RasterConfig(width=W, height=H, focal_x=m.focal_x, focal_y=m.focal_y,
                        pair_capacity=1 << 13, chunk=32)
    hidden = DeformHiddenConfig(net_width=32, defor_depth=1, bf16_activations=False,
                                no_do=False, use_coarse_temporal_embedding=True,
                                c2f_temporal_iter=10000, deform_from_iter=5000)
    return cams, params, aux, hidden, rcfg


def make_setup(problem, **over):
    _, _, _, hidden, rcfg = problem
    return trainer.TrainSetup(raster=rcfg, hidden=hidden, batch_size=1, kernel_size=0.1,
                              lambda_dssim=1.0, reg_coef=1.0, coef_tv_temporal=1e-3,
                              radegs_from_iter=0, **over)


def start(problem, setup):
    _, params, aux, hidden, _ = problem
    state, optimizer = trainer.init_train_state(params, hidden, OptimizationConfig(), EXTENT,
                                                seed=3)
    return state._replace(iteration=ITERATION), aux, optimizer


def step_both(eager, graphed, e, g, batch, cache):
    """One step each way, the graphed one under the host-read guard; checks
    them equal and returns ((eager state, aux), (graphed state, aux),
    metrics, the graphed step's key)."""
    key = graphed.key(*g, batch, cache)
    e_state, e_aux, em = eager(*e, batch, cache)
    with HostReadGuard() as guard:
        guard.active = True
        g_state, g_aux, gm = graphed(*g, batch, cache)
    assert e_state.iteration == g_state.iteration
    assert_trees_equal(em, gm, "metrics")
    assert_trees_equal(state_tensors(e_state, e_aux), state_tensors(g_state, g_aux), "state")
    return (e_state, e_aux), (g_state, g_aux), {k: v.clone() for k, v in gm.items()}, key


def test_tongue_scene_keeps_its_red_seeds_as_tongue_class(problem):
    cams, params, aux, _, _ = problem
    n_tongue = int((aux.alive & (aux.tongue_class[:, 0] > 0.5)).sum())
    assert n_tongue == round(N_POINTS * 0.2)
    batch = stage_batch(cams[:1], False, True, "cpu")
    assert batch["tongue_gt"].shape == (1, 1, H, W)
    assert float(batch["tongue_gt"].mean()) > 0.005       # the colour term's gate


def test_graphed_tongue_step_reads_the_refreshed_tongue_graph(problem):
    cams = problem[0]
    setup = make_setup(problem, tongue_enabled=True)
    state, aux, optimizer = start(problem, setup)
    eager = trainer.make_train_step(setup, optimizer, graph=False)
    graphed = trainer.make_train_step(setup, optimizer)
    cache = trainer.refresh_knn_cache(state.params["gaussians"], aux, tongue_enabled=True)
    assert cache.t_graph is not cache.graph
    b1 = stage_batch(cams[:1], False, True, "cpu")
    e, g, m1, key1 = step_both(eager, graphed, (state, aux), (state, aux), b1, cache)
    for k in ("tongue_l1", "tongue_emb", "tongue_rgb", "wo_tongue_rgb"):
        assert float(m1[k]) > 0, k

    # densify both runs from their own state (equal), then both refreshes
    e_aux = e[1]
    grads = (e_aux.xyz_grad_accum / e_aux.denom.clamp_min(1))[e_aux.alive & (e_aux.denom > 0)]
    thr = float(torch.quantile(grads, 0.75))
    noise = torch.as_tensor(np.random.default_rng(4).normal(size=(2, CAP, 3))
                            .astype(np.float32))
    opt = OptimizationConfig()
    e_state, e_aux, n_c, n_s = trainer.make_densify_step(
        opt, PERCENT_DENSE, EXTENT, graph=False)(*e, None, thr, noise=noise)
    g_state, g_aux, _, _ = trainer.make_densify_step(opt, PERCENT_DENSE, EXTENT)(
        *g, None, thr, noise=noise)
    assert int(n_c) + int(n_s) > 0
    fa = filter_args(cams, torch.as_tensor)
    caches = []
    for st, a in ((e_state, e_aux), (g_state, g_aux)):
        a = a._replace(filter_3d=tgm.compute_3d_filter(st.params["gaussians"].xyz, a.alive, *fa))
        caches.append((st, a, trainer.refresh_knn_cache(st.params["gaussians"], a,
                                                        tongue_enabled=True)))
    (e_state, e_aux, e_cache), (g_state, g_aux, g_cache) = caches
    for f in trainer._KNN_FIELDS:
        assert torch.equal(getattr(e_cache.t_graph, f), getattr(g_cache.t_graph, f)), f
    assert g_cache.t_graph.rev_pair.shape != cache.t_graph.rev_pair.shape

    # the second step: the first's key (the card replays its graph), the new graph read
    b2 = stage_batch(cams[1:2], False, True, "cpu")
    key2 = graphed.key(g_state, g_aux, b2, g_cache)
    assert key2 == key1
    e_out = eager(e_state, e_aux, b2, e_cache)
    with HostReadGuard() as guard:
        guard.active = True
        g_out = graphed(g_state, g_aux, b2, g_cache)
    assert_trees_equal(e_out[2], g_out[2], "metrics after the refresh")
    assert_trees_equal(state_tensors(*e_out[:2]), state_tensors(*g_out[:2]),
                       "state after the refresh")
    n_rev = g_cache.t_graph.rev_pair.shape[0]
    static = graphed.static["cache"].t_graph
    assert torch.equal(static.rev_pair[:n_rev], g_cache.t_graph.rev_pair)
    assert static.rev_pair.shape[0] == static.nbr.numel()
    # against the step on the stale graph: the tongue term differs
    stale = eager(e_state, e_aux, b2, e_cache._replace(t_graph=cache.t_graph))
    assert float(stale[2]["tongue_emb"]) != float(g_out[2]["tongue_emb"])


def test_graphed_colmap_step_has_a_key_for_each_pcd_valid(problem):
    cams, params, aux, _, _ = problem
    setup = make_setup(problem, colmap_supervision=True, deform_from_iter=5000)
    state, aux, optimizer = start(problem, setup)
    eager = trainer.make_train_step(setup, optimizer, graph=False)
    graphed = trainer.make_train_step(setup, optimizer)
    cache = trainer.refresh_knn_cache(state.params["gaussians"], aux)
    rng = np.random.default_rng(8)
    xyz = params.xyz[aux.alive].numpy()
    pts = torch.as_tensor((xyz[rng.integers(0, len(xyz), 300)]
                           + rng.normal(0, 0.01, (300, 3))).astype(np.float32))
    e = g = (state, aux)
    keys = []
    for i, valid in enumerate((True, False, True)):
        b = dict(stage_batch(cams[i % 2:i % 2 + 1], False, False, "cpu"), pcd_points=pts,
                 pcd_valid=valid)
        e, g, m, key = step_both(eager, graphed, e, g, b, cache)
        keys.append(key)
        assert key[0].colmap == valid
        assert (float(m["pcd_loss"]) > 0) == valid and float(m["pcd_loss"]) >= 0
    assert keys[0] != keys[1] and keys[2] == keys[0]
    assert keys[0][1] == keys[1][1]                  # one signature: the same static buffers
    assert keys[0][0]._replace(colmap=False) == keys[1][0]
