"""One training step of ed3dgs_torch against ed3dgs_tpu's `make_train_step`,
both on the CPU, on the same numpy-seeded cloud, cameras, targets and
deformation weights (the JAX model's, carried across by convert.py).

The JAX step runs with reg_coef=0 here (the KNN regulariser at the config's
reg_coef=1 is in tests/test_torch_train_knn.py, the tongue terms in
tests/test_torch_train_tongue.py), float32 activations, and the "pallas"
backend in interpret mode; the port's step runs the plain versions of its
kernels. Both compute the KNN loss every step whatever reg_coef is, each on
the graph cache its own `update_knn_cache` built. Its gradients are
read through the optimizer it is handed and its screen-space gradient
through `add_densification_stats`, both wrapped here (the JAX package is not
changed).

Bounds: loss and metrics at rtol 1e-5; every gradient leaf at
max|dg| <= 1e-5 * max|g_jax| of that leaf (no leaf needs more); vs_grad at the
same bound; the aux update at rtol 1e-5 (integers and counts exactly).

The optimizer on its own against optax, and a JAX checkpoint resumed in the
port, are in tests/test_torch_train_state.py, which imports the helpers here.
"""

import dataclasses
import math
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.config.params import DeformHiddenConfig as JHidden
from ed3dgs_tpu.config.params import OptimizationConfig as JOpt
from ed3dgs_tpu.data.cameras import look_at_camera
from ed3dgs_tpu.data.scene import flatten_pytree
from ed3dgs_tpu.models import gaussians as jgm
from ed3dgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ed3dgs_tpu.train import trainer as jtrainer
from ed3dgs_tpu.train.densify import add_densification_stats as stats
from ed3dgs_tpu.train.optim import build_optimizer as j_build_optimizer

from ed3dgs_torch import convert
from ed3dgs_torch.config.params import DeformHiddenConfig, OptimizationConfig
from ed3dgs_torch.models.deformation import init_deform_params
from ed3dgs_torch.ops.rasterize import RasterConfig
from ed3dgs_torch.train import optim, trainer

N, CAP, W, H = 192, 256, 40, 32
REL = 1e-5
ITERATION = 20_000       # deformation, coarse-to-fine, SH 3 and depth-normal live
B = 2


def cloud():
    rng = np.random.default_rng(0)
    f = {
        "xyz": np.stack([rng.uniform(-0.7, 0.7, N), rng.uniform(-0.5, 0.5, N),
                         rng.uniform(1.6, 3.0, N)], 1),
        "features_dc": rng.normal(0, 0.8, (N, 1, 3)),
        "features_rest": rng.normal(0, 0.1, (N, 15, 3)),
        "scaling": rng.normal(-3.0, 0.4, (N, 3)),
        "rotation": rng.normal(size=(N, 4)),
        "opacity": rng.normal(0.5, 1.0, (N, 1)),
        "embedding": rng.normal(0, 0.3, (N, 32)),
        "tongue_class": (rng.uniform(size=(N, 1)) > 0.6),
        "filter_3d": rng.uniform(0.001, 0.01, (N, 1)),
    }
    return {k: np.asarray(v, np.float32) for k, v in f.items()}


def jax_model(fields):
    """The cloud in the JAX package's GaussianParams/GaussianAux, padded to
    CAP as convert.gaussians_from_numpy pads it."""
    def pad(x, fill=0.0):
        return jnp.asarray(np.pad(x, [(0, CAP - N)] + [(0, 0)] * (x.ndim - 1),
                                  constant_values=fill))
    params = jgm.GaussianParams(
        xyz=pad(fields["xyz"]), features_dc=pad(fields["features_dc"]),
        features_rest=pad(fields["features_rest"]),
        scaling=pad(fields["scaling"], -10.0), rotation=pad(fields["rotation"]),
        opacity=pad(fields["opacity"]), embedding=pad(fields["embedding"]))
    aux = jgm.GaussianAux(
        alive=jnp.asarray(np.arange(CAP) < N), tongue_class=pad(fields["tongue_class"]),
        filter_3d=pad(fields["filter_3d"]), max_radii2d=jnp.zeros(CAP),
        xyz_grad_accum=jnp.zeros(CAP), denom=jnp.zeros(CAP))
    return params, aux


def hidden_config():
    """float32 activations: the bf16 deformation gradient is held to the JAX
    package's in tests/test_torch_deformation.py."""
    return JHidden(net_width=32, defor_depth=1, bf16_activations=False, no_do=False,
                   use_coarse_temporal_embedding=True, c2f_temporal_iter=10000,
                   deform_from_iter=5000)


def cameras():
    fov = math.radians(55.0)
    fovy = 2 * math.atan(math.tan(fov / 2) * H / W)
    return [look_at_camera((0.15 * i - 0.05, -0.05, 0), (0, 0, 2.2), (0, -1, 0), fov, fovy,
                           W, H).matrices() for i in range(B)]


def setup_kw(**over):
    return {**dict(batch_size=B, white_background=True, kernel_size=0.1,
                   disable_filter3d=False, lambda_dssim=1.0, opacity_l1_coef=1e-4,
                   reg_coef=0.0, coef_tv_temporal=1e-3, lambda_depth_normal=0.05,
                   radegs_from_iter=15_000, num_down_emb=30, sh_degree=3), **over}


def raster_kw(cam):
    return dict(width=W, height=H, focal_x=cam.focal_x, focal_y=cam.focal_y,
                pair_capacity=1 << 12, chunk=32)


def batch_np(cams, use_ssim=True, seed=3, tongue=False):
    """The batch; with `tongue`, a tongue mask target over part of each view."""
    rng = np.random.default_rng(seed)
    extra = ({"tongue_gt": (rng.uniform(0, 1, (B, 1, H, W)) > 0.6).astype(np.float32)}
             if tongue else {})
    return {**extra,
        "gt_image": rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32),
        "viewmatrix": np.stack([c.world_view for c in cams]).astype(np.float32),
        "projmatrix": np.stack([c.full_proj for c in cams]).astype(np.float32),
        "campos": np.stack([c.campos for c in cams]).astype(np.float32),
        "time": np.array([0.31, 0.77], np.float32),
        "cam_no": np.array([2, 5], np.int32),
        "use_ssim": use_ssim,
    }


def read_out(seen, key, tree):
    """Store `tree` as numpy in seen[key], also from inside a jitted step."""
    jax.debug.callback(lambda t: seen.__setitem__(key, jax.tree_util.tree_map(np.asarray, t)),
                       tree)


class Recorder:
    """An optax optimizer that remembers the gradients it was handed."""

    def __init__(self, inner):
        self.inner, self.seen = inner, {}

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params=None):
        read_out(self.seen, "grads", grads)
        return self.inner.update(grads, state, params)


def jax_step(state, aux, batch, monkeypatch, knn=None, jit=False, **over):
    """One JAX step, returning (new_state, new_aux, metrics, grads, vs_grad);
    `over` overrides TrainSetup fields, `knn` the cache (default: built by
    update_knn_cache), `jit` compiles the step as the JAX trainer runs it."""
    cams = cameras()
    hidden = hidden_config()
    rcfg = JRasterConfig(backend="pallas", interpret=True, **raster_kw(cams[0]))
    setup = jtrainer.TrainSetup(raster=rcfg, hidden=hidden, **setup_kw(**over))
    rec = Recorder(j_build_optimizer(JOpt(), 1.0))
    seen = {}

    def spy(aux_, vs, visible, radii):
        read_out(seen, "vs", vs)
        return stats(aux_, vs, visible, radii)
    monkeypatch.setattr(jtrainer, "add_densification_stats", spy)
    if knn is None:
        knn = jtrainer.update_knn_cache(state.params["gaussians"], aux,
                                        tongue_enabled=setup.tongue_enabled)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jtrainer.make_train_step(setup, JOpt(), rec, jit=jit)
    new_state, new_aux, metrics = step(state, aux, jb, knn)
    jax.effects_barrier()
    return new_state, new_aux, metrics, flatten_pytree(rec.seen["grads"]), seen["vs"]


def dead_slots_as_trained(rotation, filter_3d):
    """Dead capacity slots as the JAX package's trainer holds them: the
    identity quaternion (create_from_points) and the largest alive 3D-filter
    scale (compute_3d_filter gives unseen slots the farthest distance). With
    a zero filter there, the JAX step's gradient through the -10 log-scale of
    a dead slot is inf/NaN; the port's stays finite (ROADMAP.md, Queue 3;
    test_step_gradients_finite_on_degenerate_dead_slots)."""
    rot, filt = np.array(rotation), np.array(filter_3d)
    rot[N:] = (1.0, 0.0, 0.0, 0.0)
    filt[N:] = filt[:N].max()
    return rot, filt


def jax_problem():
    fields = cloud()
    params, aux = jax_model(fields)
    rot, filt = dead_slots_as_trained(params.rotation, aux.filter_3d)
    params = params._replace(rotation=jnp.asarray(rot))
    aux = aux._replace(filter_3d=jnp.asarray(filt))
    hidden = hidden_config()
    state, _ = jtrainer.init_train_state(params, hidden, JOpt(), 1.0, seed=1)
    state = state._replace(iteration=jnp.int32(ITERATION))
    return fields, state, aux


def torch_side(fields, jstate, **over):
    cams = cameras()
    hidden = DeformHiddenConfig(**dataclasses.asdict(hidden_config()))
    tparams, taux = convert.gaussians_from_numpy(
        {**fields, "alive": np.ones(N, bool)}, capacity=CAP, device="cpu")
    rot, filt = dead_slots_as_trained(tparams.rotation, taux.filter_3d)
    tparams = tparams._replace(rotation=torch.as_tensor(rot))
    taux = taux._replace(filter_3d=torch.as_tensor(filt))
    tdef = convert.deform_from_flat(flatten_pytree(jstate.params["deform"]), device="cpu")
    optimizer = optim.build_optimizer(OptimizationConfig(), 1.0)
    params = {"gaussians": tparams, "deform": tdef}
    state = optim.TrainState(params, optimizer.init(params), ITERATION)
    setup = trainer.TrainSetup(raster=RasterConfig(**raster_kw(cams[0])), hidden=hidden,
                               **setup_kw(**over))
    return state, taux, setup, optimizer


def torch_cache(state, aux, setup):
    return trainer.update_knn_cache(state.params["gaussians"], aux,
                                    tongue_enabled=setup.tongue_enabled)


def torch_batch(batch):
    return {k: (v if isinstance(v, bool) else torch.as_tensor(v)) for k, v in batch.items()}


def assert_grads_match(jgrads, tgrads):
    assert set(jgrads) == set(tgrads)
    for k, want in jgrads.items():
        got = tgrads[k].numpy()
        assert got.shape == want.shape, k
        assert np.all(np.isfinite(got)), k
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= REL * scale, (k, float(err), float(scale))


@pytest.fixture(scope="module")
def f32_steps():
    mp = pytest.MonkeyPatch()
    try:
        fields, jstate, jaux = jax_problem()
        batch = batch_np(cameras())
        jout = jax_step(jstate, jaux, batch, mp)
    finally:
        mp.undo()
    tstate, taux, setup, optimizer = torch_side(fields, jstate)
    cache = torch_cache(tstate, taux, setup)
    loss_and_grads = trainer.make_loss_and_grads(setup)
    tout = loss_and_grads(tstate.params, taux, torch_batch(batch), cache, ITERATION)
    step = trainer.make_train_step(setup, optimizer)
    tstep = step(tstate, taux, torch_batch(batch), cache)
    return jout, tout, tstep


def test_step_loss_and_metrics_match_jax(f32_steps):
    (_, _, jmetrics, _, _), (loss, metrics, *_), (_, _, step_metrics) = f32_steps
    assert set(metrics) == set(jmetrics)
    # the KNN loss is computed at reg_coef=0 too, as JAX computes it
    assert float(metrics["emb_loss"]) > 0
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(v), rtol=REL, atol=1e-7,
                                   err_msg=k)
        np.testing.assert_array_equal(step_metrics[k].numpy(), metrics[k].numpy())
    assert float(loss) == float(metrics["loss"])
    assert float(metrics["depth_normal"]) > 0 and float(metrics["ssim"]) < 1
    assert float(metrics["tv_loss"]) > 0


def test_step_gradients_match_jax(f32_steps):
    (_, _, _, jgrads, jvs), (_, _, tgrads, tvs, *_), _ = f32_steps
    assert_grads_match(jgrads, tgrads)
    assert np.abs(jvs).max() > 0
    assert np.abs(tvs.numpy() - jvs).max() <= REL * np.abs(jvs).max()
    # every parameter group gets a gradient, the deformation heads included
    for k in ("gaussians/xyz", "gaussians/embedding", "deform/offsets", "deform/weight",
              "deform/fine/heads/sh/1/w", "deform/coarse/feature/0/w"):
        assert np.abs(jgrads[k]).max() > 0, k


def test_step_aux_update_matches_jax(f32_steps):
    (_, jaux, _, _, _), _, (tstate, taux, _) = f32_steps
    for name in jaux._fields:
        a, b = np.asarray(getattr(jaux, name)), getattr(taux, name).numpy()
        if a.dtype.kind in "bi" or name in ("denom", "max_radii2d"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=REL, atol=1e-9, err_msg=name)
    assert float(taux.denom.sum()) > 0
    assert tstate.iteration == ITERATION + 1
    assert all(st.count == 1 for st in tstate.opt_state.values())


@pytest.mark.parametrize("kw,what", [
    (dict(comms="strip"), "strip"),
    # a stand-in for a 3 x 1 mesh: B = 2 does not split over its data axis
    (dict(batch_mode="vmap", mesh=types.SimpleNamespace(shape={"data": 3, "gauss": 1})),
     "vmap"),
])
def test_unported_features_raise(kw, what):
    """What the step cannot run raises before it starts: the strip exchange
    without a mesh, and a batch (here vmapped) that the mesh's data axis
    does not divide. Both once raised NotImplementedError, before the
    multi-device step was ported."""
    cam = cameras()[0]
    base = {**setup_kw(), **kw}
    setup = trainer.TrainSetup(raster=RasterConfig(**raster_kw(cam)),
                               hidden=DeformHiddenConfig(), **base)
    with pytest.raises(ValueError, match=what):
        trainer.make_train_step(setup, None)


def test_step_gradients_finite_on_degenerate_dead_slots():
    """Dead slots padded with a zero quaternion, a zero 3D filter and a -10
    log-scale (convert.gaussians_from_numpy's padding): the port's step
    keeps every gradient finite. The JAX step's gradient through such a
    slot's scale is inf or NaN and reaches the whole deformation network
    (ROADMAP.md, Queue 3)."""
    fields = cloud()
    cams = cameras()
    hidden = DeformHiddenConfig(**dataclasses.asdict(hidden_config()))
    tparams, taux = convert.gaussians_from_numpy(
        {**fields, "alive": np.ones(N, bool)}, capacity=CAP, device="cpu")
    assert float(tparams.rotation[N:].abs().max()) == 0.0
    assert float(taux.filter_3d[N:].abs().max()) == 0.0
    tdef = init_deform_params(hidden, seed=2, device="cpu")
    setup = trainer.TrainSetup(raster=RasterConfig(**raster_kw(cams[0])), hidden=hidden,
                               **setup_kw(reg_coef=1.0))
    cache = trainer.update_knn_cache(tparams, taux)
    loss, _, grads, vs, _, _ = trainer.make_loss_and_grads(setup)(
        {"gaussians": tparams, "deform": tdef}, taux, torch_batch(batch_np(cams)), cache,
        ITERATION)
    assert bool(torch.isfinite(loss))
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
    assert bool(torch.isfinite(vs).all()) and float(vs.abs().max()) > 0
