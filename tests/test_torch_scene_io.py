"""The files the port writes, read by the JAX package, and the reverse, both
on the CPU: a model (`Scene.save`: point_cloud.ply + deformation.npz) and a
training checkpoint (`tools.train.save_checkpoint`: chkpnt<N>.npz).

Bounds: every array the JAX package loads from the port's files equals the
port's in-memory one bit for bit; the JAX render of the loaded model is
held to the port's render of its in-memory state at
tests/test_torch_render.py's bounds (images at atol 1e-5); a JAX
checkpoint resumed in the port and saved again has the same keys, dtypes
and bit-identical arrays."""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.config.params import DeformHiddenConfig as JHidden
from ed3dgs_tpu.config.params import OptimizationConfig as JOpt
from ed3dgs_tpu.data.cameras import look_at_camera
from ed3dgs_tpu.data.scene import flatten_pytree, load_deformation, unflatten_into
from ed3dgs_tpu.models import gaussians as jgm
from ed3dgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ed3dgs_tpu.render import render as j_render
from ed3dgs_tpu.render import settings_from_camera as j_settings
from ed3dgs_tpu.tools import train as jtrain
from ed3dgs_tpu.train import trainer as jtrainer
from ed3dgs_tpu.train.optim import build_optimizer as j_build_optimizer

from ed3dgs_torch import convert
from ed3dgs_torch.config.params import DeformHiddenConfig, OptimizationConfig
from ed3dgs_torch.data.scene import save_deformation
from ed3dgs_torch.models import gaussians as tgm
from ed3dgs_torch.models.deformation import init_deform_params
from ed3dgs_torch.ops.rasterize import RasterConfig
from ed3dgs_torch.render import render, settings_from_camera
from ed3dgs_torch.tools import train as ttrain
from ed3dgs_torch.train import optim
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, CAP, W, H = 300, 384, 48, 36
ITERATION = 1234
IMAGE_KEYS = ("render", "mask", "expected_coord", "median_coord", "expected_depth",
              "median_depth", "normal", "tongue_mask")
RENDER_KW = dict(iteration=10 ** 9, sh_degree=3, kernel_size=0.1, disable_filter3d=False,
                 num_down_emb_c=30, num_down_emb_f=30)
BG = (0.2, 0.3, 0.9)


def hidden():
    return JHidden(net_width=32, defor_depth=1, bf16_activations=False)


def camera():
    fov = math.radians(55.0)
    return look_at_camera((0.1, -0.05, 0), (0, 0, 2.2), (0, -1, 0), fov,
                          2 * math.atan(math.tan(fov / 2) * H / W), W, H).matrices()


def port_state():
    """A port training state two Adam updates in, with dead slots scattered
    through the cloud (as densification leaves them) and aux statistics."""
    rng = np.random.default_rng(0)
    fields = {
        "xyz": np.stack([rng.uniform(-0.8, 0.8, CAP), rng.uniform(-0.6, 0.6, CAP),
                         rng.uniform(1.6, 3.0, CAP)], 1),
        "features_dc": rng.normal(0, 0.8, (CAP, 1, 3)),
        "features_rest": rng.normal(0, 0.1, (CAP, 15, 3)),
        "scaling": rng.normal(-3.3, 0.4, (CAP, 3)), "rotation": rng.normal(size=(CAP, 4)),
        "opacity": rng.normal(0.5, 1.0, (CAP, 1)), "embedding": rng.normal(0, 0.3, (CAP, 32)),
        "tongue_class": (rng.uniform(size=(CAP, 1)) > 0.6),
        "filter_3d": rng.uniform(0.001, 0.01, (CAP, 1)),
        "alive": rng.permutation(np.arange(CAP) < N),
        "max_radii2d": rng.integers(0, 9, CAP), "xyz_grad_accum": rng.uniform(0, 1e-3, CAP),
        "denom": rng.integers(0, 5, CAP),
    }
    fields = {k: np.asarray(v, bool if k == "alive" else np.float32) for k, v in fields.items()}
    params, aux = tgm.from_numpy(fields, device="cpu")
    cfg = DeformHiddenConfig(**dataclasses.asdict(hidden()))
    all_params = {"gaussians": params, "deform": init_deform_params(cfg, seed=3, device="cpu")}
    opt = optim.build_optimizer(OptimizationConfig(), 1.7)
    opt_state = opt.init(all_params)
    for _ in range(2):
        grads = {k: torch.as_tensor(rng.normal(0, 1e-3, v.shape).astype(np.float32))
                 for k, v in optim.flatten_params(all_params).items()}
        all_params, opt_state = opt.update(grads, opt_state, all_params)
    return optim.TrainState(all_params, opt_state, ITERATION), aux


def port_render(params, aux, dparams):
    cam = camera()
    rcfg = RasterConfig(width=W, height=H, focal_x=cam.focal_x, focal_y=cam.focal_y,
                        pair_capacity=1 << 13, chunk=32)
    return render(params, aux, dparams, DeformHiddenConfig(**dataclasses.asdict(hidden())),
                  settings_from_camera(cam, time=0.43, device="cpu"), rcfg,
                  torch.tensor(BG), **RENDER_KW)


def jax_render(params, aux, dparams):
    cam = camera()
    rcfg = JRasterConfig(width=W, height=H, focal_x=cam.focal_x, focal_y=cam.focal_y,
                         pair_capacity=1 << 13, chunk=32, backend="pallas", interpret=True)
    return j_render(params, aux, dparams, hidden(), j_settings(cam, time=0.43), rcfg,
                    jnp.asarray(BG, jnp.float32), **RENDER_KW)


def assert_images_match(want, got):
    for key in IMAGE_KEYS:
        b = got[key].numpy()
        assert np.all(np.isfinite(b)), key
        np.testing.assert_allclose(b, np.asarray(want[key]), rtol=0, atol=1e-5, err_msg=key)
    assert float(np.asarray(want["mask"]).max()) > 0.5


def jax_templates(state):
    """A fresh JAX training state of the same shapes (the template the JAX
    tool's load_checkpoint restores into)."""
    flat = optim.flatten_params(state.params)
    C = flat["gaussians/xyz"].shape[0]
    pts = np.random.default_rng(9).uniform(-1, 1, (C, 3)).astype(np.float32)
    params, aux = jgm.create_from_points(pts, np.full((C, 3), 0.5, np.float32), capacity=C)
    jstate, _ = jtrainer.init_train_state(params, hidden(), JOpt(), 1.7, seed=5)
    return jstate, aux


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The port's model and checkpoint on disk, and its render."""
    root = tmp_path_factory.mktemp("port_model")
    state, aux = port_state()
    g, d = state.params["gaussians"], state.params["deform"]
    it_dir = root / "point_cloud" / f"iteration_{ITERATION}"
    tgm.save_ply(str(it_dir / "point_cloud.ply"), g, aux)
    save_deformation(str(it_dir), d)
    ttrain.save_checkpoint(str(root), ITERATION, state, aux)
    return root, state, aux, port_render(g, aux, d)


def test_port_model_loads_in_jax_and_renders_the_same(written):
    root, state, aux, got = written
    it_dir = root / "point_cloud" / f"iteration_{ITERATION}"
    jparams, jaux = jgm.load_ply(str(it_dir / "point_cloud.ply"), capacity=CAP)
    jstate, _ = jax_templates(state)
    jdef = load_deformation(str(it_dir), jstate.params["deform"])
    # the alive rows, compacted in slot order, bit for bit
    alive = aux.alive.numpy()
    assert int(np.asarray(jaux.alive).sum()) == N
    for name, t in state.params["gaussians"]._asdict().items():
        np.testing.assert_array_equal(np.asarray(getattr(jparams, name))[:N], t.numpy()[alive],
                                      err_msg=name)
    for name in ("tongue_class", "filter_3d"):
        np.testing.assert_array_equal(np.asarray(getattr(jaux, name))[:N],
                                      getattr(aux, name).numpy()[alive], err_msg=name)
    for k, v in flatten_pytree(jdef).items():
        np.testing.assert_array_equal(v, optim.flatten_params(state.params["deform"])[k].numpy())
    assert_images_match(jax_render(jparams, jaux, jdef), got)


def test_port_checkpoint_resumes_in_jax(written):
    """The JAX tool's load_checkpoint restores every parameter, moment,
    count and aux array of the port's chkpnt<N>.npz, and the restored model
    renders as the port's."""
    root, state, aux, got = written
    jstate0, jaux0 = jax_templates(state)
    jstate, jaux, nxt = jtrain.load_checkpoint(str(root / f"chkpnt{ITERATION}.npz"), jstate0,
                                               jaux0)
    assert nxt == ITERATION + 1 and int(jstate.iteration) == ITERATION
    flat_p = optim.flatten_params(state.params)
    jflat = flatten_pytree(jstate.params)
    assert set(jflat) == set(flat_p)
    for k, v in jflat.items():
        np.testing.assert_array_equal(v, flat_p[k].numpy(), err_msg=k)
    jopt = flatten_pytree(jstate.opt_state)
    for g, st in state.opt_state.items():
        pre = f"inner_states/{g}/inner_state/"
        assert int(jopt[pre + "0/count"]) == st.count == 2
        if g in ("xyz", "deformation"):
            assert int(jopt[pre + "1/count"]) == 2
        for part in ("mu", "nu"):
            for k, v in getattr(st, part).items():
                np.testing.assert_array_equal(jopt[f"{pre}0/{part}/{k}"], v.numpy())
    for name in jaux._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jaux, name)),
                                      getattr(aux, name).numpy(), err_msg=name)
    assert_images_match(jax_render(jstate.params["gaussians"], jaux, jstate.params["deform"]),
                        got)


def test_jax_checkpoint_round_trips_through_the_port(tmp_path):
    """A JAX chkpnt<N>.npz (optax state one update in) loaded by the port's
    tool and saved again: the same keys, dtypes and bit-identical arrays."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    params, aux = jgm.create_from_points(pts, rng.uniform(0, 1, (200, 3)).astype(np.float32),
                                         capacity=256)
    jstate, _ = jtrainer.init_train_state(params, hidden(), JOpt(), 1.3, seed=2)
    jopt = j_build_optimizer(JOpt(), 1.3)
    grads = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
             for k, v in flatten_pytree(jstate.params).items()}
    upd, opt_state = jopt.update(unflatten_into(jstate.params, grads), jstate.opt_state,
                                 jstate.params)
    jstate = jstate._replace(params=jax.tree_util.tree_map(lambda p, u: p + u, jstate.params, upd),
                             opt_state=opt_state, iteration=jnp.int32(77))
    aux = aux._replace(denom=jnp.asarray(rng.integers(0, 4, 256).astype(np.float32)))
    jtrain.save_checkpoint(str(tmp_path), 77, jstate, aux)
    src = str(tmp_path / "chkpnt77.npz")

    tstate, taux = convert.load_checkpoint(src, device="cpu")
    state, aux2, nxt = ttrain.load_checkpoint(src, tstate, taux, device="cpu")
    assert nxt == 78
    out = tmp_path / "again"
    out.mkdir()
    ttrain.save_checkpoint(str(out), 77, state, aux2)
    with np.load(src) as a, np.load(str(out / "chkpnt77.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
