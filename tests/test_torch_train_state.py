"""The training state of ed3dgs_torch against ed3dgs_tpu's, both on the CPU:
the 9-group Adam on its own against optax, and a JAX `chkpnt<N>.npz` resumed
in the port.

The optimizer is held to optax at rtol 1e-6 over 3 updates of identical
gradients: after a whole step an Adam update is about lr*sign(g), which
magnifies a sign flip of a gradient that is zero up to rounding, so the
optimizer is compared on its own. The resumed step is held at the bounds of
tests/test_torch_train.py (loss at rtol 1e-5, every gradient leaf and the
screen-space gradient at 1e-5 of the leaf's largest value)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ed3dgs_tpu.config.params import OptimizationConfig as JOpt
from ed3dgs_tpu.data.scene import flatten_pytree, unflatten_into
from ed3dgs_tpu.tools.train import save_checkpoint
from ed3dgs_tpu.train import trainer as jtrainer
from ed3dgs_tpu.train.optim import build_optimizer as j_build_optimizer
from ed3dgs_tpu.train.optim import reset_moments_at as j_reset_moments_at

from ed3dgs_torch import convert
from ed3dgs_torch.config.params import OptimizationConfig
from ed3dgs_torch.train import optim, trainer

from test_torch_train import (CAP, ITERATION, N, REL, assert_grads_match, batch_np, cameras,
                              cloud, hidden_config, jax_model, jax_problem, jax_step,
                              torch_batch, torch_cache, torch_side)


def test_optimizer_matches_optax():
    """Three updates of the same numpy gradients through optax's 9-group
    Adam and the port's: parameters, moments and counts at rtol 1e-6; then
    both zero the moments of the same densified slots (reset_moments_at)."""
    fields = cloud()
    params, aux = jax_model(fields)
    jstate, _ = jtrainer.init_train_state(params, hidden_config(), JOpt(), 2.5, seed=4)
    jopt = j_build_optimizer(JOpt(), 2.5)
    jflat = flatten_pytree(jstate.params)
    tparams = optim.unflatten_params({k: torch.as_tensor(np.array(v))
                                      for k, v in jflat.items()})
    topt = optim.build_optimizer(OptimizationConfig(), 2.5)
    tstate = topt.init(tparams)
    jp, js = jstate.params, jstate.opt_state
    rng = np.random.default_rng(9)
    for _ in range(3):
        g = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32) for k, v in jflat.items()}
        jg = unflatten_into(jp, g)
        upd, js = jopt.update(jg, js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        tparams, tstate = topt.update({k: torch.as_tensor(v) for k, v in g.items()},
                                      tstate, tparams)
    got = optim.flatten_params(tparams)
    for k, want in flatten_pytree(jp).items():
        # atol: four float32 ulps of the ~1.2e-3 summed updates, for a parameter
        # that the updates carry through zero
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-6, atol=5e-10, err_msg=k)
    mask = rng.uniform(size=CAP) < 0.3
    js = j_reset_moments_at(js, jnp.asarray(mask))
    tstate = optim.reset_moments_at(tstate, torch.as_tensor(mask))
    assert float(tstate["xyz"].mu["gaussians/xyz"][torch.as_tensor(mask)].abs().max()) == 0
    assert float(tstate["deformation"].nu["deform/weight"].abs().min()) > 0
    jflat_state = flatten_pytree(js)
    for g_name, st in tstate.items():
        prefix = f"inner_states/{g_name}/inner_state/0/"
        assert st.count == int(jflat_state[prefix + "count"]) == 3
        for part in ("mu", "nu"):
            for k, v in getattr(st, part).items():
                np.testing.assert_allclose(v.numpy(), jflat_state[f"{prefix}{part}/{k}"],
                                           rtol=1e-6, atol=0, err_msg=f"{g_name} {part} {k}")


def jax_state_one_update_on():
    """The JAX training state one update past `jax_problem`'s: optax's
    9-group Adam applied to numpy-seeded gradients (zero on the dead slots,
    which therefore stay where the trainer keeps them), the iteration
    advanced, and densification statistics from a numpy seed on the alive
    slots. Returns (fields, state, aux)."""
    fields, state, aux = jax_problem()
    jopt = j_build_optimizer(JOpt(), 1.0)
    rng = np.random.default_rng(21)
    grads = {}
    for k, v in flatten_pytree(state.params).items():
        g = rng.normal(0, 1e-3, v.shape).astype(np.float32)
        if k.startswith("gaussians/"):
            g[N:] = 0.0
        grads[k] = g
    upd, opt_state = jopt.update(unflatten_into(state.params, grads), state.opt_state,
                                 state.params)
    state = state._replace(params=optax.apply_updates(state.params, upd),
                           opt_state=opt_state, iteration=state.iteration + 1)
    alive = np.arange(CAP) < N
    stat = lambda x: jnp.asarray(np.where(alive, x, 0.0).astype(np.float32))  # noqa: E731
    aux = aux._replace(max_radii2d=stat(rng.integers(0, 9, CAP)),
                       xyz_grad_accum=stat(rng.uniform(0, 1e-3, CAP)),
                       denom=stat(rng.integers(0, 4, CAP)))
    return fields, state, aux


def test_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """A JAX `chkpnt<N>.npz`, written by ed3dgs_tpu's `save_checkpoint` one
    update into training, loads through `convert.load_checkpoint` into the
    port's TrainState and GaussianAux, and the port's next step from it
    gives the JAX next step's loss, gradients, screen-space gradient and aux
    update at the bounds above."""
    fields, s1, a1 = jax_state_one_update_on()
    it = int(s1.iteration)
    assert it == ITERATION + 1
    save_checkpoint(str(tmp_path), it, s1, a1)
    tstate, taux = convert.load_checkpoint(str(tmp_path / f"chkpnt{it}.npz"), device="cpu")

    # the whole state carries across: parameters, both moments, the counts
    assert tstate.iteration == it
    want = flatten_pytree(s1.params)
    got = optim.flatten_params(tstate.params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    jopt = flatten_pytree(s1.opt_state)
    for g, st in tstate.opt_state.items():
        prefix = f"inner_states/{g}/inner_state/0/"
        assert st.count == int(jopt[prefix + "count"]) == 1
        for part in ("mu", "nu"):
            moments = getattr(st, part)
            assert moments and all(
                np.array_equal(v.numpy(), jopt[f"{prefix}{part}/{k}"])
                for k, v in moments.items())
    for name in a1._fields:
        np.testing.assert_array_equal(getattr(taux, name).numpy(),
                                      np.asarray(getattr(a1, name)), err_msg=name)

    # the next step, in both packages
    batch = batch_np(cameras(), use_ssim=False, seed=4)
    s2, a2, m2, jgrads, jvs = jax_step(s1, a1, batch, monkeypatch)
    _, _, setup, optimizer = torch_side(fields, s1)
    cache = torch_cache(tstate, taux, setup)
    loss, metrics, tgrads, tvs, _, _ = trainer.make_loss_and_grads(setup)(
        tstate.params, taux, torch_batch(batch), cache, tstate.iteration)
    np.testing.assert_allclose(float(loss), float(m2["loss"]), rtol=REL)
    assert float(metrics["ssim"]) == 1.0
    assert_grads_match(jgrads, tgrads)
    assert np.abs(tvs.numpy() - jvs).max() <= REL * np.abs(jvs).max()
    t2, taux2, _ = trainer.make_train_step(setup, optimizer)(
        tstate, taux, torch_batch(batch), cache)
    assert t2.iteration == it + 1 and all(st.count == 2 for st in t2.opt_state.values())
    np.testing.assert_array_equal(taux2.denom.numpy(), np.asarray(a2.denom))
    np.testing.assert_array_equal(taux2.max_radii2d.numpy(), np.asarray(a2.max_radii2d))
    np.testing.assert_allclose(taux2.xyz_grad_accum.numpy(), np.asarray(a2.xyz_grad_accum),
                               rtol=REL, atol=1e-9)


def test_checkpoint_load_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.load_checkpoint(str(tmp_path / "chkpnt1.npz"))
