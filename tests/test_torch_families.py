"""Training steps of ed3dgs_torch against ed3dgs_tpu's jitted
`make_train_step` for each upstream E-D3DGS dataset family, on the CPU:
DyNeRF (`configs/dynerf/cook_spinach.py`), Technicolor
(`configs/technicolor/Birthday.py`) and HyperNeRF
(`configs/hypernerf/vrig-chicken.py`).

Each family runs its per-scene config's structural keys, loaded by each
package's own loader: the deformation's depth (0 for Technicolor and
HyperNeRF), its switched-off heads (`no_dc`; HyperNeRF also `no_do`),
`zero_temporal`, `use_anneal`, `no_c2f_temporal_embedding`, the batch (2 for
HyperNeRF), `lambda_dssim` (0 for HyperNeRF, whose SSIM gate still opens
and computes SSIM at weight 0), `coef_tv_temporal_embedding`, `reg_coef`
and the optimizer's groups and learning rates (`offsets_lr = 0`,
`deformation_lr_init`). Widths are cut (net_width 32, a 16-d temporal and
an 8-d Gaussian embedding, float32 activations) and the frames are 64x48,
Technicolor's with the principal point off centre. Both packages start
from the same numpy cloud and the JAX package's deformation weights
(carried across by convert.py) at iteration 20,000 (every term live) and
take two steps from that state, one on each of two batches (SSIM on, then
off), and one step from the JAX state after the first (its
`chkpnt<N>.npz` read by `convert.load_checkpoint`): the second step of a
run.

Bounds (tests/test_torch_train.py's) for the two steps from the shared
state: the loss and metrics at rtol 1e-5; every gradient leaf at max|dg|
<= 1e-5 * max|g_jax| of that leaf (a leaf the loss does not reach, such as
a switched-off head, is zero in both); vs_grad at the same bound; the aux
update at rtol 1e-5 (integers and counts exactly); the first update of each
optimizer group in units of its learning rate, as
tests/test_torch_trajectory.py holds a trajectory: the RMS difference at
most 0.1 and no entry further than 2 (Adam moves an entry by about lr
whatever its gradient's size; one whose gradient is zero up to rounding
may move the other way). The run's second step starts from a state one
update away, where a splat's alpha may sit within an ulp of the blend's
1/255 threshold at a pixel (DyNeRF's second batch: alpha 0.0039215600
against 0.0039215689; `exp2` of the same power differs by one ulp between
XLA and PyTorch), pass in one package and not in the other, and move that
pixel's depth-normal term and its splat's gradients: its loss and metrics
are held at the trajectory test's per-step bound, rtol 5e-5, and its
visibility statistics (radii, visible counts) exactly."""

import dataclasses
import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.config.loader import load_full_config as j_load_full_config
from ed3dgs_tpu.data.cameras import look_at_camera
from ed3dgs_tpu.data.scene import flatten_pytree
from ed3dgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ed3dgs_tpu.tools.train import save_checkpoint
from ed3dgs_tpu.train import trainer as jtrainer
from ed3dgs_tpu.train.densify import add_densification_stats as stats
from ed3dgs_tpu.train.optim import build_optimizer as j_build_optimizer

from ed3dgs_torch import convert
from ed3dgs_torch.config.loader import load_full_config
from ed3dgs_torch.ops.rasterize import RasterConfig
from ed3dgs_torch.train import optim, trainer

from test_torch_train import Recorder, assert_grads_match, cloud, jax_model, read_out
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"dynerf": "configs/dynerf/cook_spinach.py",
            "technicolor": "configs/technicolor/Birthday.py",
            "hypernerf": "configs/hypernerf/vrig-chicken.py"}
NARROW = dict(net_width=32, temporal_embedding_dim=16, gaussian_embedding_dim=8,
              bf16_activations=False)
W, H, N, CAP = 64, 48, 192, 256
PRINCIPAL = 0.05           # Technicolor's principal point, off centre (cx, -cy ratio)
ITERATION = 20_000
EXTENT = 1.0
REL = 1e-5
RUN_REL = 5e-5             # a run's later step (tests/test_torch_trajectory.py LOSS_REL)
RMS_LR, WORST_LR = 0.1, 2.0


def configs(family):
    """(JAX config, port config), each package's loader on the per-scene
    file, with the widths cut."""
    path = os.path.join(REPO, FAMILIES[family])
    jcfg, tcfg = j_load_full_config(path), load_full_config(path)
    jcfg = dataclasses.replace(jcfg, hidden=dataclasses.replace(jcfg.hidden, **NARROW))
    tcfg = dataclasses.replace(tcfg, hidden=dataclasses.replace(tcfg.hidden, **NARROW))
    return jcfg, tcfg


def setup_kw(cfg):
    """TrainSetup's loss keys as tools/train.py takes them from a config."""
    model, opt, hidden = cfg.model, cfg.opt, cfg.hidden
    return dict(batch_size=opt.batch_size, white_background=model.white_background,
                kernel_size=model.kernel_size, disable_filter3d=model.disable_filter3D,
                use_coord_map=model.use_coord_map, lambda_dssim=opt.lambda_dssim,
                opacity_l1_coef=opt.opacity_l1_coef_fine, reg_coef=opt.reg_coef,
                coef_tv_temporal=opt.coef_tv_temporal_embedding,
                lambda_depth_normal=opt.lambda_depth_normal,
                radegs_from_iter=opt.radegs_regularization_from_iter,
                num_down_emb=hidden.min_embeddings, sh_degree=model.sh_degree)


def cameras(family, B):
    fov = math.radians(55.0)
    fovy = 2 * math.atan(math.tan(fov / 2) * H / W)
    kw = (dict(cx_ratio=PRINCIPAL, cy_ratio=-PRINCIPAL) if family == "technicolor" else {})
    return [look_at_camera((0.15 * i - 0.05, -0.05, 0), (0, 0, 2.2), (0, -1, 0), fov, fovy,
                           W, H, **kw).matrices() for i in range(B)]


def raster_kw(cam):
    return dict(width=W, height=H, focal_x=cam.focal_x, focal_y=cam.focal_y,
                pair_capacity=1 << 12, chunk=32)


def batch_np(cams, seed, use_ssim):
    B = len(cams)
    rng = np.random.default_rng(seed)
    return {"gt_image": rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32),
            "viewmatrix": np.stack([c.world_view for c in cams]).astype(np.float32),
            "projmatrix": np.stack([c.full_proj for c in cams]).astype(np.float32),
            "campos": np.stack([c.campos for c in cams]).astype(np.float32),
            "time": rng.uniform(0, 1, B).astype(np.float32),
            "cam_no": np.arange(B, dtype=np.int32) + 1,
            "use_ssim": use_ssim}


def jax_stepper(family, jcfg, monkeypatch):
    """A jitted JAX step for the family, compiled once: (state, aux, batch)
    -> (state, aux, metrics, grads, vs_grad)."""
    cams = cameras(family, jcfg.opt.batch_size)
    rcfg = JRasterConfig(backend="pallas", interpret=True, **raster_kw(cams[0]))
    setup = jtrainer.TrainSetup(raster=rcfg, hidden=jcfg.hidden, **setup_kw(jcfg))
    rec = Recorder(j_build_optimizer(jcfg.opt, EXTENT))
    seen = {}

    def spy(aux_, vs, visible, radii):
        read_out(seen, "vs", vs)
        return stats(aux_, vs, visible, radii)
    monkeypatch.setattr(jtrainer, "add_densification_stats", spy)
    step = jtrainer.make_train_step(setup, jcfg.opt, rec, jit=True)

    def run(state, aux, batch):
        knn = jtrainer.update_knn_cache(state.params["gaussians"], aux)
        out = step(state, aux, {k: jnp.asarray(v) for k, v in batch.items()}, knn)
        jax.effects_barrier()
        return (*out, flatten_pytree(rec.seen["grads"]), np.array(seen["vs"]))
    return run


def torch_step(family, tcfg, state, aux, batch):
    """The port's step: (loss, metrics, grads, vs_grad) of
    make_loss_and_grads and (state, aux, metrics) of make_train_step."""
    cams = cameras(family, tcfg.opt.batch_size)
    setup = trainer.TrainSetup(raster=RasterConfig(**raster_kw(cams[0])), hidden=tcfg.hidden,
                               **setup_kw(tcfg))
    optimizer = optim.build_optimizer(tcfg.opt, EXTENT)
    cache = trainer.update_knn_cache(state.params["gaussians"], aux)
    tb = {k: (v if isinstance(v, bool) else torch.as_tensor(v)) for k, v in batch.items()}
    loss, metrics, grads, vs, _, _ = trainer.make_loss_and_grads(setup)(
        state.params, aux, tb, cache, state.iteration)
    return (loss, metrics, grads, vs), trainer.make_train_step(setup, optimizer)(
        state, aux, tb, cache), optimizer


def assert_step_matches(jout, tout, tstep):
    _, jaux, jmetrics, jgrads, jvs = jout
    loss, metrics, tgrads, tvs = tout
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(v), rtol=REL, atol=1e-7,
                                   err_msg=k)
        np.testing.assert_array_equal(tstep[2][k].numpy(), metrics[k].numpy())
    assert float(loss) == float(metrics["loss"])
    assert_grads_match(jgrads, tgrads)
    assert np.abs(jvs).max() > 0
    assert np.abs(tvs.numpy() - jvs).max() <= REL * np.abs(jvs).max()
    taux = tstep[1]
    for name in jaux._fields:
        a, b = np.asarray(getattr(jaux, name)), getattr(taux, name).numpy()
        if a.dtype.kind in "bi" or name in ("denom", "max_radii2d"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=REL, atol=1e-9, err_msg=name)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family_steps(request, tmp_path_factory):
    family = request.param
    jcfg, tcfg = configs(family)
    B = jcfg.opt.batch_size
    fields = {k: v for k, v in cloud().items()}
    fields["embedding"] = fields["embedding"][:, :NARROW["gaussian_embedding_dim"]]
    params, aux = jax_model(fields)
    # dead slots as the trainer holds them (the identity quaternion, the
    # largest alive 3D-filter scale: tests/test_torch_train.py)
    rot = np.array(params.rotation)
    rot[N:] = (1.0, 0.0, 0.0, 0.0)
    filt = np.array(aux.filter_3d)
    filt[N:] = filt[:N].max()
    params = params._replace(rotation=jnp.asarray(rot))
    aux = aux._replace(filter_3d=jnp.asarray(filt))
    jstate, _ = jtrainer.init_train_state(params, jcfg.hidden, jcfg.opt, EXTENT, seed=1)
    jstate = jstate._replace(iteration=jnp.int32(ITERATION))
    # the port's start: the same cloud and the JAX deformation weights
    tparams, taux = convert.gaussians_from_numpy({**fields, "alive": np.ones(N, bool)},
                                                 capacity=CAP, device="cpu")
    tparams = tparams._replace(rotation=torch.as_tensor(rot))
    taux = taux._replace(filter_3d=torch.as_tensor(filt))
    tdef = convert.deform_from_flat(flatten_pytree(jstate.params["deform"]), device="cpu")
    topt = optim.build_optimizer(tcfg.opt, EXTENT)
    tparams_all = {"gaussians": tparams, "deform": tdef}
    tstate = optim.TrainState(tparams_all, topt.init(tparams_all), ITERATION)

    mp = pytest.MonkeyPatch()
    try:
        jax_step = jax_stepper(family, jcfg, mp)
        batches = [batch_np(cameras(family, B), 3, True), batch_np(cameras(family, B), 4, False)]
        j = [jax_step(jstate, aux, b) for b in batches]
        t = [torch_step(family, tcfg, tstate, taux, b) for b in batches]
        # the run's second step, from the JAX state after the first, in both
        path = tmp_path_factory.mktemp(family)
        save_checkpoint(str(path), ITERATION + 1, j[0][0], j[0][1])
        s1, a1 = convert.load_checkpoint(str(path / f"chkpnt{ITERATION + 1}.npz"),
                                         device="cpu")
        j.append(jax_step(j[0][0], j[0][1], batches[1]))
        t.append(torch_step(family, tcfg, s1, a1, batches[1]))
    finally:
        mp.undo()
    return dict(family=family, cfg=tcfg, j=j, t=[x[0] for x in t], t_step=[x[1] for x in t],
                optimizer=t[0][2])


@pytest.mark.parametrize("step", [0, 1])
def test_family_step_matches_jax(family_steps, step):
    """Loss, metrics, gradients, the screen-space gradient and the aux
    update of a step from the shared state within the bounds above; every
    term the family configures is live, and what it switches off is
    zero."""
    r = family_steps
    assert_step_matches(r["j"][step], r["t"][step], r["t_step"][step])
    metrics, grads = r["t"][step][1], r["t"][step][2]
    cfg = r["cfg"]
    assert float(metrics["emb_loss"]) > 0 and float(metrics["depth_normal"]) > 0
    # the SSIM gate opens in every family (HyperNeRF weighs the term 0)
    assert (float(metrics["ssim"]) < 1) == (step == 0)
    # the zero temporal table of Technicolor and HyperNeRF has no variation
    # to penalise before its first update
    assert (float(metrics["tv_loss"]) > 0) == (cfg.opt.coef_tv_temporal_embedding > 0
                                               and not cfg.hidden.zero_temporal)
    for head, off in (("opacity", cfg.hidden.no_do), ("sh", cfg.hidden.no_dc)):
        for tower in ("coarse", "fine"):
            g = grads[f"deform/{tower}/heads/{head}/1/w"]
            assert (float(g.abs().max()) == 0.0) == off, (head, tower)
    assert len([k for k in grads if k.startswith("deform/fine/feature/")]) == 2 * max(
        1, cfg.hidden.defor_depth)


def test_family_second_step_of_a_run_matches_jax(family_steps):
    """The run's second step (from the JAX state after the first): the
    loss and metrics at rtol 5e-5, the visibility statistics exactly, and
    the temporal TV term live once the zero table has moved (HyperNeRF)."""
    r = family_steps
    (_, jaux, jmetrics, _, _), (loss, metrics, _, _) = r["j"][2], r["t"][2]
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(v), rtol=RUN_REL, atol=1e-7,
                                   err_msg=k)
    taux = r["t_step"][2][1]
    for name in ("alive", "max_radii2d", "denom"):
        np.testing.assert_array_equal(getattr(taux, name).numpy(),
                                      np.asarray(getattr(jaux, name)), err_msg=name)
    assert (float(metrics["tv_loss"]) > 0) == (r["cfg"].opt.coef_tv_temporal_embedding > 0)


def test_family_first_update_matches_jax(family_steps):
    """The parameters after the first update, each optimizer group in units
    of its learning rate (a group at learning rate 0, the time offsets of
    Technicolor and HyperNeRF, does not move in either package); the Adam
    moments at the gradients' bound."""
    r = family_steps
    jstate = r["j"][0][0]
    tstate = r["t_step"][0][0]
    jflat = flatten_pytree(jstate.params)
    tflat = {k: v.numpy() for k, v in optim.flatten_params(tstate.params).items()}
    labels = optim.flatten_params(optim.param_labels(
        optim.unflatten_params({k: torch.zeros(1) for k in jflat})))
    optimizer = r["optimizer"]
    for g in optim.GROUPS:
        keys = [k for k in jflat if labels[k] == g]
        d = np.concatenate([(tflat[k] - np.asarray(jflat[k])).ravel() for k in keys])
        lr = abs(float(optimizer.schedules[g](0)))
        if lr == 0:
            assert np.abs(d).max() == 0, g
            continue
        d = d / lr
        assert np.sqrt(np.mean(d * d)) <= RMS_LR and np.abs(d).max() <= WORST_LR, g
    jmu = flatten_pytree(jstate.opt_state)
    for g, st in tstate.opt_state.items():
        assert st.count == 1
        for k, v in st.mu.items():
            want = np.asarray(jmu[f"inner_states/{g}/inner_state/0/mu/{k}"])
            assert np.abs(v.numpy() - want).max() <= REL * max(np.abs(want).max(), 1e-30), k


def test_inverse_gradient_keeps_a_zero_cotangent_zero_at_a_dynerf_filter():
    """The world covariance of a dead slot as the trainer holds it at a
    1600x1200 DyNeRF frame (log-scale -10 and the largest alive 3D filter,
    here 3.8e-4: 1.44e-7 on the diagonal, determinant 3e-21) is inverted
    (its smallest eigenvalue passes the 1e-8 threshold), and its cotangent
    is 0 (it renders nothing). 1/det**2 overflows float32: JAX's gradient
    is NaN there (0 * inf), and a step spreads it to every parameter (the
    first DyNeRF tools.train run on the card went NaN at iteration 2); the
    port's is 0. Elsewhere the port's gradient is JAX's within 1e-6 of the
    row's largest value (ROADMAP.md, Queue 3)."""
    from ed3dgs_tpu.core import sym3 as jsym3
    from ed3dgs_torch.core import sym3 as tsym3
    rng = np.random.default_rng(7)
    q = rng.normal(size=(64, 3, 3))
    covs = q @ np.transpose(q, (0, 2, 1)) * 1e-3 + np.eye(3) * 1e-4
    iu = np.triu_indices(3)
    p = np.concatenate([covs[:, iu[0], iu[1]],
                        np.tile([1.44e-7, 0, 0, 1.44e-7, 0, 1.44e-7], (4, 1))]).astype(np.float32)
    w = rng.normal(size=p.shape).astype(np.float32)
    w[64:] = 0.0
    jg = np.asarray(jax.grad(lambda x: jnp.sum(jsym3.sym3_pseudo_inverse_min(x)[0] * w))(
        jnp.asarray(p)))
    x = torch.as_tensor(p).requires_grad_(True)
    out, well = tsym3.sym3_pseudo_inverse_min(x)
    (out * torch.as_tensor(w)).sum().backward()
    tg = x.grad.numpy()
    assert bool(well.all())
    assert np.isnan(jg[64:]).all() and np.isfinite(jg[:64]).all()
    np.testing.assert_array_equal(tg[64:], 0.0)
    scale = np.abs(jg[:64]).max(axis=1, keepdims=True)
    assert (np.abs(tg[:64] - jg[:64]) <= 1e-6 * scale).all()
