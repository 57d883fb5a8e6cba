"""The plain versions of kernels K3 and K8 (ed3dgs_torch.ops.segment_sum on
CPU tensors) against the Pallas segment-sum kernels in interpret mode, on CSR
bounds with empty segments, gaps and a long segment. Bound: 1e-6 of the
largest output value (the TPU kernels sum float32 rows by HIGHEST-precision
matmuls, the port differences float64 prefix sums)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.ops.segment_sum import segment_sum_rows as j_segment_sum
from ed3dgs_tpu.ops.segment_sum import segment_sum_rows_packed as j_segment_sum_packed

from ed3dgs_torch.ops import segment_sum

REL = 1e-6


def csr(seed, S, R, empty_frac):
    """Monotone bounds: random lengths (some zero), gaps between segments."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 40, S) * (rng.uniform(size=S) > empty_frac)
    lengths[S // 2] = 700                      # one Gaussian over many tiles
    gaps = rng.integers(0, 3, S)
    starts = np.cumsum(gaps + np.concatenate([[0], lengths[:-1]]))
    ends = starts + lengths
    assert ends[-1] <= R
    return starts.astype(np.int32), ends.astype(np.int32)


@pytest.mark.parametrize("S,F,empty_frac", [(300, 26, 0.3), (129, 26, 0.0), (64, 32, 0.9)])
def test_segment_sum_matches_pallas_interpret(S, F, empty_frac):
    R = 16384
    starts, ends = csr(S, S, R, empty_frac)
    rows = np.random.default_rng(F).normal(size=(R, F)).astype(np.float32)
    # the TPU kernel takes 128-lane rows
    padded = jnp.pad(jnp.asarray(rows), ((0, 0), (0, 128 - F)))
    want = np.asarray(j_segment_sum(padded, jnp.asarray(starts), jnp.asarray(ends),
                                    interpret=True))[:, :F]
    got = segment_sum.segment_sum_rows(torch.as_tensor(rows), torch.as_tensor(starts),
                                       torch.as_tensor(ends))
    assert got.dtype == torch.float32 and got.shape == (S, F)
    empty = starts == ends
    assert np.all(got.numpy()[empty] == 0) and np.all(want[empty] == 0)
    assert np.abs(got.numpy() - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("S,F,empty_frac", [(300, 26, 0.3), (64, 7, 0.5), (129, 32, 0.0)])
def test_packed_segment_sum_matches_pallas_interpret(S, F, empty_frac):
    """K8, the TPU's narrow-row variant (four rows packed per 128-lane row),
    on its own narrow rows; the port's K8 is K3's function."""
    R = 16384
    starts, ends = csr(S + 1, S, R, empty_frac)
    rows = np.random.default_rng(F + 1).normal(size=(R, F)).astype(np.float32)
    want = np.asarray(j_segment_sum_packed(jnp.asarray(rows), jnp.asarray(starts),
                                           jnp.asarray(ends), chunk=64, interpret=True))
    got = segment_sum.segment_sum_rows_packed(torch.as_tensor(rows), torch.as_tensor(starts),
                                              torch.as_tensor(ends))
    assert got.shape == (S, F)
    assert np.abs(got.numpy() - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("fn", ["segment_sum_rows", "segment_sum_rows_packed"])
def test_segment_sum_refuses_wide_rows(fn):
    with pytest.raises(ValueError, match="F <= 32"):
        getattr(segment_sum, fn)(torch.zeros(4, 33), torch.zeros(1, dtype=torch.int32),
                                 torch.ones(1, dtype=torch.int32))
