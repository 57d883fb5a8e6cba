"""The plain version of kernel K5a (ed3dgs_torch.ops.relayout.unpack_image on
CPU tensors) against the Pallas unpack kernel in interpret mode: a pure
permutation, so the match is exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.ops import relayout as j_relayout

from ed3dgs_torch.ops import relayout


@pytest.mark.parametrize("gy,gx,C", [(3, 11, 24), (2, 8, 5), (1, 1, 24)])
def test_unpack_matches_pallas_interpret(gy, gx, C):
    gxp = relayout.pad_grid_x(gx)
    assert gxp == j_relayout.pad_grid_x(gx)
    packed = np.random.default_rng(gy * gx).normal(
        size=(gy, gxp, C, 256)).astype(np.float32)
    want = np.asarray(j_relayout.unpack_image(jnp.asarray(packed), True))
    got = relayout.unpack_image(torch.as_tensor(packed))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gy,gx,C", [(3, 11, 24), (2, 8, 5), (1, 1, 24)])
def test_pack_matches_pallas_interpret(gy, gx, C):
    """K5b, the cotangent path of unpack_image: exact, and unpack's inverse."""
    gxp = relayout.pad_grid_x(gx)
    img = np.random.default_rng(gy + gx + C).normal(
        size=(C, gy * 16, gxp * 16)).astype(np.float32)
    want = np.asarray(j_relayout._pack_impl(jnp.asarray(img), gy, gxp, C, True))
    got = relayout.pack_image(torch.as_tensor(img))
    assert got.is_contiguous() and got.shape == (gy, gxp, C, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(relayout.unpack_image(got).numpy(), img)


def test_unpack_backward_is_pack():
    """The differentiable relayout's gradient is the packed cotangent, as
    the JAX package's unpack_image custom_vjp gives it."""
    packed = np.random.default_rng(5).normal(size=(2, 8, 24, 256)).astype(np.float32)
    cot = np.random.default_rng(6).normal(size=(24, 32, 128)).astype(np.float32)
    x = torch.as_tensor(packed).requires_grad_(True)
    (g,) = torch.autograd.grad(relayout.unpack(x), x, torch.as_tensor(cot))
    _, vjp = jax.vjp(lambda p: j_relayout.unpack_image(p, True), jnp.asarray(packed))
    np.testing.assert_array_equal(g.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))
