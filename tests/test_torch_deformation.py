"""The deformation network of ed3dgs_torch against ed3dgs_tpu on the CPU.

Weights are drawn by the JAX package's `init_deform_params` and carried
across with `convert.deform_from_flat` under the checkpoint key scheme, so
both packages run the same network on the same numpy inputs."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.config.params import DeformHiddenConfig as JHidden
from ed3dgs_tpu.data.scene import flatten_pytree
from ed3dgs_tpu.models import deformation as jd

from ed3dgs_torch import convert
from ed3dgs_torch.config.params import DeformHiddenConfig
from ed3dgs_torch.models import deformation as td

# float32: the same products in another summation order. bf16 activations
# are held to the same bound: both packages round the same operands and each
# layer's f32-accumulated output to bf16, and the roundings agree, while one
# bf16 step of a ~0.1 delta is ~5e-4 (so float32 activations fail it; see
# test_deform_forward_bf16_is_not_f32).
RTOL, ATOL = 1e-5, 1e-6


def inputs(cfg, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(-3, 0.5, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32),
            rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32),
            rng.normal(0, 0.5, (n, cfg.gaussian_embedding_dim)).astype(np.float32))


def networks(bf16, **kw):
    jcfg = JHidden(net_width=32, defor_depth=2, bf16_activations=bf16, no_do=False, **kw)
    tcfg = DeformHiddenConfig(**dataclasses.asdict(jcfg))
    jp = jd.init_deform_params(jax.random.PRNGKey(3), jcfg)
    # nonzero per-camera time offsets (learned during training)
    offs = np.zeros((jcfg.max_cameras, 1), np.float32)
    offs[[1, 4, 7], 0] = (0.02, -0.05, 0.01)
    jp["offsets"] = jnp.asarray(offs)
    tp = convert.deform_from_flat(flatten_pytree(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def run_both(bf16, iteration, cam_no, time=0.37, **kw):
    jcfg, tcfg, jp, tp = networks(bf16, **kw)
    xs = inputs(jcfg)
    jout = jd.deform_forward(jp, jcfg, *(jnp.asarray(x) for x in xs), jnp.float32(time),
                             iteration, cam_no=None if cam_no is None else jnp.int32(cam_no),
                             num_down_emb_c=jcfg.min_embeddings,
                             num_down_emb_f=jcfg.min_embeddings)
    tout = td.deform_forward(tp, tcfg, *(torch.as_tensor(x) for x in xs), time, iteration,
                             cam_no=None if cam_no is None else torch.tensor(cam_no),
                             num_down_emb_c=tcfg.min_embeddings,
                             num_down_emb_f=tcfg.min_embeddings)
    final, (sub, orig) = tout
    return jax.tree_util.tree_leaves(jout), [*final, *sub, *orig]


@pytest.mark.parametrize("iteration,cam_no", [
    (10 ** 9, None),    # serving: anneal saturated, eval-mode offset
    (5600, 4),          # anneal ramp of the scale/opacity/SH heads
    (300, None),        # position ramp, coarse-to-fine count growing
])
def test_deform_forward_f32_matches_jax(iteration, cam_no):
    jl, tl = run_both(False, iteration, cam_no)
    assert len(jl) == len(tl) == 15
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_deform_forward_variants_match_jax():
    """Config switches: coarse tower off, fixed full embedding count."""
    jl, tl = run_both(False, 2500, 1, no_coarse_deform=True,
                      no_c2f_temporal_embedding=True)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("iteration,cam_no", [(10 ** 9, None), (5600, 4)])
def test_deform_forward_bf16_matches_jax(iteration, cam_no):
    jl, tl = run_both(True, iteration, cam_no)
    for a, b in zip(jl, tl):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_deform_forward_bf16_is_not_f32():
    """The control for the bound above: float32 activations against the
    JAX package's bf16 ones miss it on every deformed output."""
    jl, _ = run_both(True, 10 ** 9, None)
    _, tl = run_both(False, 10 ** 9, None)
    for a, b in zip(jl[:10], tl[:10]):
        assert not np.allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_eval_offset_is_mean_of_nonzero_offsets():
    """cam_no=None renders at time + mean(nonzero offsets): the same result
    as a camera whose own offset equals that mean."""
    jcfg, tcfg, _, tp = networks(False)
    xs = [torch.as_tensor(x) for x in inputs(tcfg)]
    ev, _ = td.deform_forward(tp, tcfg, *xs, 0.5, 10 ** 9, cam_no=None)
    tp["offsets"][0, 0] = (0.02 - 0.05 + 0.01) / 3
    cam, _ = td.deform_forward(tp, tcfg, *xs, 0.5, 10 ** 9, cam_no=torch.tensor(0))
    for a, b in zip(ev, cam):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("cur", [30, 47, 150])
@pytest.mark.parametrize("t", [0.0, 0.5034, 1.0, -0.07, 1.12])
def test_temporal_embedding_matches_jax(cur, t):
    weight = np.random.default_rng(0).normal(0, 0.01, (150, 256)).astype(np.float32)
    want = np.asarray(jd.temporal_embedding(jnp.asarray(weight), jnp.float32(t), cur))
    got = td.temporal_embedding(torch.as_tensor(weight), torch.tensor(t), cur)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("cur", [41, 150])
@pytest.mark.parametrize("t", [0.0, 0.5, 1.0, 0.5034])
def test_temporal_embedding_time_gradient_matches_jax(cur, t):
    """d(embedding . v)/dt, also where the reflection folds (t = 0: JAX's
    |x| has gradient +1 at 0, as the reference's grid_sample reflection,
    where `torch.abs` would give 0), on a whole row (t = 0.5) and at the
    last row (t = 1, where the interpolation's weight is 0 in both)."""
    rng = np.random.default_rng(1)
    weight = rng.normal(0, 0.01, (150, 256)).astype(np.float32)
    v = rng.normal(0, 1, 256).astype(np.float32)
    want = float(jax.grad(lambda x: jnp.dot(jd.temporal_embedding(
        jnp.asarray(weight), x, cur), jnp.asarray(v)))(jnp.float32(t)))
    x = torch.tensor(t, requires_grad=True)
    torch.dot(td.temporal_embedding(torch.as_tensor(weight), x, cur), torch.as_tensor(v)).backward()
    assert (want != 0.0) == (t < 1.0)
    np.testing.assert_allclose(float(x.grad), want, rtol=1e-5, atol=0)


def test_c2f_num_embeddings_and_anneal_start():
    jcfg = JHidden(min_embeddings=30, max_embeddings=150, c2f_temporal_iter=20000)
    tcfg = DeformHiddenConfig(**dataclasses.asdict(jcfg))
    for it in [0, 1, 500, 9999, 20000, 25000, 10 ** 9]:
        assert int(td.c2f_num_embeddings(tcfg, it, 30)) == int(
            jd.c2f_num_embeddings(jcfg, it, 30)), it
    # iteration 0 under the anneal: no deformation at all
    jl, tl = run_both(False, 0, 2)
    final, orig = tl[:5], tl[10:]
    for a, b in zip(final, orig):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


# The deformation network's gradient at the train step's bf16 activations:
# the weight matrices' gradients and the embedding's are products of bf16
# cotangents and activations accumulated in float32 and rounded to bf16 once,
# in both packages; at most BF16_GRAD_OFF of an array's elements may differ
# from the JAX package's by more than one bf16 ulp (2^-7 relative; measured:
# at most 0.2%). float32 activations miss that bound on every such array
# (measured: 6% to 80% of the elements). The biases, the temporal table and
# the camera offsets sum bf16 cotangents over the Gaussians, which XLA and
# PyTorch round at other points (up to 2.6e-2 of a leaf's largest value
# apart); the float32 step holds them to 1e-5 (tests/test_torch_train.py).
BF16_ULP, BF16_GRAD_OFF = 2.0 ** -7, 1e-2


def vjp_both(bf16_torch, iteration=20_000, cam_no=4, n=256):
    jcfg, tcfg, jp, tp = networks(True)
    tcfg = dataclasses.replace(tcfg, bf16_activations=bf16_torch)
    xs = inputs(jcfg, n=n)
    kw = dict(num_down_emb_c=jcfg.min_embeddings, num_down_emb_f=jcfg.min_embeddings)

    def jf(p, x):
        return jd.deform_forward(p, jcfg, *x, jnp.float32(0.37), iteration,
                                 cam_no=jnp.int32(cam_no), **kw)[0]
    jx = tuple(jnp.asarray(x) for x in xs)
    outs, vjp = jax.vjp(jf, jp, jx)
    rng = np.random.default_rng(7)
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in outs]
    jg, jgx = vjp(tuple(jnp.asarray(c) for c in cots))
    want = {**flatten_pytree(jg), "embedding": np.asarray(jgx[-1])}

    flat = {k: torch.as_tensor(np.array(v)).requires_grad_(True)
            for k, v in flatten_pytree(jp).items()}
    emb = torch.as_tensor(xs[-1]).requires_grad_(True)
    touts = td.deform_forward(convert.unflatten(flat), tcfg,
                              *(torch.as_tensor(x) for x in xs[:-1]), emb, 0.37, iteration,
                              cam_no=torch.tensor(cam_no), **kw)[0]
    g = torch.autograd.grad(touts, [*flat.values(), emb], [torch.as_tensor(c) for c in cots])
    got = {**dict(zip(flat, (x.numpy() for x in g[:-1]))), "embedding": g[-1].numpy()}
    keys = [k for k in want if k.endswith("/w")] + ["embedding"]
    return {k: float((np.abs(got[k] - want[k])
                      > BF16_ULP * np.abs(want[k]) + 1e-7 * np.abs(want[k]).max()).mean())
            for k in keys}


def test_deform_gradient_bf16_matches_jax():
    off = vjp_both(True)
    assert len(off) == 25
    assert max(off.values()) <= BF16_GRAD_OFF, off


def test_deform_gradient_bf16_is_not_f32():
    off = vjp_both(False)
    assert min(off.values()) > BF16_GRAD_OFF, off
