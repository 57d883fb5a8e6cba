"""The port's tongue step (the tongue mask L1, the KNN term on the tongue
graph, the tongue-only and tongue-free renders' colour terms) against the
benchmark's plain tongue reference (benchmark/reference/tongue.py), at a
small size of the nersemble_tongue cell on the CPU, seeded, in float32:
the loss, each tongue term and each leaf's gradient, of the eager step and
of the graphed one (which runs eagerly here; its first Adam moment is
(1 - beta1) x the gradient). The reference with the tongue off is
reference/step.py's trainer, and a planted fault in the port's tongue terms
fails the cell's `tongue_gap`."""

import copy
import json
import os
import sys

import pytest
import torch

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import common, scene, train_tongue  # noqa: E402
from reference import step as ref  # noqa: E402
from reference import tongue as tref  # noqa: E402
from reference.optim import B1  # noqa: E402

ITERATION = 20000
SEED = 2 ** 31 + 17


def small_cfg() -> dict:
    with open(os.path.join(BENCH, "configs", "nersemble_tongue.json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg.update(width=64, height=48, gaussians=1500, capacity=2048, cameras=4,
               frames_per_camera=1)
    cfg["rig"]["rows"] = 1
    cfg["tongue"] = dict(cfg["tongue"], gaussians=150)
    return cfg


@pytest.fixture(scope="module")
def problem():
    """The cell's inputs at the small size: the cloud with its blob, the
    network, a target (moved colours) with its tongue mask, the reference's
    step config and both graphs, and the port's setup, state and cache."""
    from ed3dgs_torch.models import gaussians as gm
    from ed3dgs_torch.ops.rasterize import RasterConfig
    from ed3dgs_torch.train import trainer

    cfg = small_cfg()
    gen = torch.Generator().manual_seed(SEED)
    cams = scene.rig(cfg)
    params, aux = train_tongue.place_blob(cfg, *scene.cloud(cfg, gen, "cpu"), gen)
    deform = scene.deform_weights(cfg, gen, "cpu")
    aux = aux._replace(filter_3d=ref.filter_3d(params.xyz, aux.alive,
                                               *common.filter_args(cams, "cpu")))
    scfg = common.step_config(cfg, cams, 1 << 17)
    cam = 1
    s = common.settings(cams[cam], 0.4, "cpu")
    moved = params._replace(features_dc=params.features_dc + 0.1 * torch.randn(
        params.features_dc.shape, generator=gen))
    gt, mask = tref.frame_and_tongue(moved, aux, scene.deform_weights(cfg, gen, "cpu"), scfg,
                                     *s[:3], 0.4)
    c = cams[cam]
    batch = {"gt_image": gt[None], "tongue_gt": mask[None],
             "viewmatrix": torch.as_tensor(c["world_view"][None]),
             "projmatrix": torch.as_tensor(c["full_proj"][None]),
             "campos": torch.as_tensor(c["campos"][None]), "time": torch.tensor([0.4]),
             "cam_no": torch.tensor([cam]), "use_ssim": False}
    cover = cfg["opt"]["knn_coverage_target"]
    graphs = tref.knn_graphs(params.xyz, aux, dict(ref.KNN_CAPS_DEFAULT), cover)
    full = common.program_config(cfg)
    opt, hidden, model = full.opt, full.hidden, full.model
    setup = trainer.TrainSetup(
        raster=RasterConfig(**scfg.raster.__dict__), hidden=hidden, batch_size=1,
        white_background=model.white_background, kernel_size=model.kernel_size,
        disable_filter3d=model.disable_filter3D, tongue_enabled=True,
        lambda_dssim=opt.lambda_dssim, opacity_l1_coef=opt.opacity_l1_coef_fine,
        reg_coef=opt.reg_coef, lambda_depth_normal=opt.lambda_depth_normal,
        radegs_from_iter=opt.radegs_regularization_from_iter,
        num_down_emb=hidden.min_embeddings, sh_degree=model.sh_degree)
    p, a = gm.GaussianParams(*params), gm.GaussianAux(*aux)
    cache = trainer.refresh_knn_cache(p, a, dict(trainer.KNN_CAPS_DEFAULT),
                                      tongue_enabled=True, coverage_target=cover)
    return dict(cfg=cfg, params=params, aux=aux, deform=deform, scfg=scfg, batch=batch,
                graphs=graphs, setup=setup, opt=opt, p=p, a=a, cache=cache)


@pytest.fixture(scope="module")
def reference(problem):
    pr = problem
    return tref.loss_and_grads({"gaussians": pr["params"], "deform": pr["deform"]}, pr["aux"],
                               pr["batch"], pr["graphs"], ITERATION, pr["scfg"])


def port_loss_and_grads(pr):
    from ed3dgs_torch.train import trainer
    return trainer.make_loss_and_grads(pr["setup"])(
        {"gaussians": pr["p"], "deform": pr["deform"]}, pr["a"], pr["batch"], pr["cache"],
        ITERATION)


def check_terms(metrics, loss, want):
    w_loss, w_terms = want[0], want[1]
    assert abs(float(loss) - float(w_loss)) <= 1e-6 * abs(float(w_loss))
    for k in tref.TERMS:
        assert float(w_terms[k]) > 0, k
        assert float(metrics[k]) == pytest.approx(float(w_terms[k]), rel=1e-5), k


def check_grads(grads, want):
    for path, g in want[2].items():
        torch.testing.assert_close(grads[path], g, rtol=1e-4, atol=1e-6 * float(g.abs().max()),
                                   msg=path)


def test_eager_tongue_loss_terms_and_gradients_equal_the_reference(problem, reference):
    loss, metrics, grads, vs_grad, _, _ = port_loss_and_grads(problem)
    check_terms(metrics, loss, reference)
    check_grads(grads, reference)
    torch.testing.assert_close(vs_grad, reference[3], rtol=1e-4, atol=1e-9)
    pairs = metrics["tongue_pairs"]
    assert pairs.dtype == torch.int32 and pairs.shape == (2,)
    assert int(pairs[0]) > 0 and int(pairs.sum()) == int(metrics["num_pairs"])


@pytest.mark.parametrize("graphed", [False, True])
def test_step_tongue_terms_and_first_moments_equal_the_reference(problem, reference, graphed):
    """One step of the train step (the eager one, and the graphed one run
    eagerly on the CPU) from a state with zero moments: its metrics, and its
    first moments over (1 - beta1), against the reference's gradient."""
    from ed3dgs_torch.models import gaussians as gm
    from ed3dgs_torch.train import trainer
    from ed3dgs_torch.train.optim import flatten_params

    pr = problem
    params = gm.GaussianParams(*(t.clone() for t in pr["p"]))
    state, optimizer = trainer.init_train_state(params, pr["setup"].hidden, pr["opt"],
                                                pr["scfg"].extent)
    mine = {k: v.clone() for k, v in flatten_params({"deform": pr["deform"]}).items()}
    for path, t in flatten_params({"deform": state.params["deform"]}).items():
        t.copy_(mine[path])
    state = state._replace(iteration=ITERATION)
    step = trainer.make_train_step(pr["setup"], optimizer, graph=graphed)
    assert isinstance(step, trainer.GraphedTrainStep) == graphed
    state, _, metrics = step(state, gm.GaussianAux(*(t.clone() for t in pr["a"])),
                             pr["batch"], pr["cache"])
    check_terms(metrics, metrics["loss"], reference)
    grads = {p: m / (1 - B1) for g in state.opt_state.values() for p, m in g.mu.items()}
    check_grads(grads, reference)


def test_reference_with_the_tongue_off_is_the_step_reference(problem):
    pr = problem
    params = {"gaussians": pr["params"], "deform": pr["deform"]}
    batch = dict(pr["batch"], use_ssim=True)
    plain = ref.Trainer(params, pr["aux"], pr["scfg"])
    off = tref.Trainer(params, pr["aux"], pr["scfg"], tongue=False)
    a = plain.step(batch, pr["graphs"][0], ITERATION)
    b = off.step(batch, pr["graphs"], ITERATION)
    assert torch.equal(a["loss"], b["loss"]) and b["tongue"] == {}
    for path, g in a["grads"].items():
        assert torch.equal(g, b["grads"][path]), path
    for x, y in zip(ref.flatten_params(plain.params).values(),
                    ref.flatten_params(off.params).values()):
        assert torch.equal(x, y)


def test_a_tongue_free_render_given_the_tongue_only_filter_fails_the_tongue_gap(
        problem, reference, monkeypatch):
    from ed3dgs_torch.train import trainer

    with open(os.path.join(BENCH, "limits", "nersemble_tongue.train.json")) as f:
        limit = json.load(f)["tongue_gap"]
    want = [{k: float(v) for k, v in reference[1].items()}]
    _, metrics, *_ = port_loss_and_grads(problem)
    sound = train_tongue.tongue_gap([{k: float(metrics[k]) for k in tref.TERMS}], want)
    assert sound[0] <= limit, sound
    render_one = trainer._render_one

    def planted(*args, **kw):
        args = tuple("only" if isinstance(a, str) and a == "without" else a for a in args)
        return render_one(*args, **kw)
    monkeypatch.setattr(trainer, "_render_one", planted)
    _, metrics, *_ = port_loss_and_grads(problem)
    gap, where = train_tongue.tongue_gap([{k: float(metrics[k]) for k in tref.TERMS}], want)
    assert gap > limit and where == [0, "wo_tongue_rgb"], (gap, where)
