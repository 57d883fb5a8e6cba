"""The port's rasterizer gradient against ed3dgs_tpu's "pallas" backend, both
on the CPU: `rasterize()` differentiated with respect to every float field
of ProjectedGaussians and the tongue channel (the custom Functions: K5b,
K2, the un-permute, K3 and the depth-order permute)
against `jax.grad` of `rasterize(backend="pallas", interpret=True)` under the
loss of tests/test_rasterize_pallas.py:94-113, at max|dg| <= 1e-5 *
max|g_jax| per field. That loss's normal term is |n|^2 of a unit normal,
constant, so the exact gradient with respect to the splat normal is zero and
both packages return rounding noise (3e-11); the normal is held to atol 1e-9
there, and to the relative bound under a second loss that weights the normal
map."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ed3dgs_tpu.ops.rasterize import rasterize as j_rasterize

from ed3dgs_torch.core.projection import ProjectedGaussians
from ed3dgs_torch.ops.rasterize import RasterConfig, rasterize

from test_torch_rasterize import CASES, H, W, camera, project_jax, scene

REL = 1e-5
NOISE = 1e-9     # the normal's gradient under the |n|^2 loss (exactly zero)
FLOAT_FIELDS = [f for f in ProjectedGaussians._fields
                if f not in ("valid", "radius", "rect_min", "rect_max", "tiles_touched")]


def _to_torch_proj(proj):
    return {f: torch.as_tensor(np.array(getattr(proj, f))) for f in ProjectedGaussians._fields}


def _loss_terms(out, target, normal_weight=None):
    """tests/test_rasterize_pallas.py:108-113, over any RasterOutputs; with
    `normal_weight`, the normal term weights the normal map instead."""
    mean, absf = (jnp.mean, jnp.abs) if isinstance(out.color, jax.Array) else (
        torch.mean, torch.abs)
    nterm = out.normal ** 2 if normal_weight is None else out.normal * normal_weight
    return (mean(absf(out.color - target)) + 0.2 * mean(out.expected_depth)
            + 0.1 * mean(nterm) + 0.1 * mean(out.median_depth)
            + 0.05 * mean(out.expected_coord) + 0.02 * mean(out.alpha)
            + 0.02 * mean(out.tongue))


@pytest.mark.parametrize("case,weighted", [("open", False), ("stack16", True)])
def test_rasterize_gradients_match_jax_pallas(case, weighted):
    case = CASES[case]
    cam = camera()
    means, scales, q, opac, shs, tongue = scene(case["n"], case["seed"], case["stack"])
    proj = project_jax(cam, means, scales, q, opac, shs)
    rng = np.random.default_rng(1)
    target = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    nweight = rng.normal(size=(3, H, W)).astype(np.float32) if weighted else None
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    kw = dict(width=W, height=H, focal_x=cam.focal_x, focal_y=cam.focal_y,
              pair_capacity=1 << 12, chunk=case["chunk"])
    jcfg = JRasterConfig(backend="pallas", interpret=True, **kw)

    def jloss(fields, tng):
        p = proj._replace(**fields)
        return _loss_terms(j_rasterize(p, tng, jnp.asarray(bg), jcfg), jnp.asarray(target),
                           None if nweight is None else jnp.asarray(nweight))

    jfields = {f: getattr(proj, f) for f in FLOAT_FIELDS}
    jg, jg_tongue = jax.grad(jloss, argnums=(0, 1))(jfields, jnp.asarray(tongue))

    tp = _to_torch_proj(proj)
    leaves = {f: tp[f].clone().requires_grad_(True) for f in FLOAT_FIELDS}
    t_tongue = torch.as_tensor(tongue).clone().requires_grad_(True)
    out = rasterize(ProjectedGaussians(**{**tp, **leaves}), t_tongue, torch.as_tensor(bg),
                    RasterConfig(**kw))
    loss = _loss_terms(out, torch.as_tensor(target),
                       None if nweight is None else torch.as_tensor(nweight))
    grads = torch.autograd.grad(loss, [*leaves.values(), t_tongue], allow_unused=True)
    checked = 0
    for name, g in zip([*FLOAT_FIELDS, "tongue"], grads):
        want = np.asarray(jg_tongue if name == "tongue" else jg[name])
        got = np.zeros_like(want) if g is None else g.numpy()
        assert np.all(np.isfinite(got)), name
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        if scale == 0:        # fields the blend does not read: depth, cov3d
            assert err == 0, name
        elif name == "normal" and not weighted:
            assert scale < NOISE and err < NOISE, (float(err), float(scale))
        else:
            checked += 1
            assert err <= REL * scale, (name, float(err), float(scale))
    assert checked == (10 if weighted else 9)     # all but depth, cov3d (, normal)
