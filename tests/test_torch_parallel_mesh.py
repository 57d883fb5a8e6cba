"""The port's mesh (ed3dgs_torch.parallel.mesh, .multihost, .comm) on four
gloo ranks of the CPU: --mesh spec parsing, the data-major rank layout
against the JAX package's `make_mesh` device layout (the 8 virtual devices
of tests/conftest.py), each axis's groups, the batch and camera slices of
each data row, and the collectives' identity on a lone process. One world
runs every spec (tests/torch_parallel_ranks.py) within 120 s.
"""

import time

import numpy as np
import jax
import pytest
import torch

from ed3dgs_tpu.parallel import make_mesh as j_make_mesh

from ed3dgs_torch import convert
from ed3dgs_torch.parallel import comm, multihost
from ed3dgs_torch.parallel.mesh import Mesh, make_mesh
import torch_parallel_ranks as ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

SHAPES = {"data=2,gauss=2": (2, 2), "data=0,gauss=2": (2, 2), "gauss=4": (1, 4),
          "data=4": (4, 1), "auto": (1, 4)}     # auto: one host, gauss spans its ranks


@pytest.fixture(scope="module")
def world():
    return multihost.spawn_world(ranks.mesh_rank, 4, deadline_s=120)


@pytest.mark.parametrize("spec", ranks.MESH_SPECS)
def test_mesh_layout_matches_jax_make_mesh(world, spec):
    """Rank r sits where JAX's make_mesh puts device r: (r // G, r % G)."""
    D, G = SHAPES[spec]
    devices = np.asarray(j_make_mesh(data=D, gauss=G).devices)
    where = {dev.id: (d, g) for (d, g), dev in np.ndenumerate(devices)}
    for rank, res in enumerate(world):
        m = res[spec]
        assert m["shape"] == {"data": D, "gauss": G}
        assert (m["d"], m["g"]) == where[jax.devices()[rank].id] == divmod(rank, G)
        assert m["gauss_members"] == [m["d"] * G + g for g in range(G)]
        assert m["data_members"] == [d * G + m["g"] for d in range(D)]
        assert m["gathered"] == m["gauss_members"]                 # rank order
        assert m["data_sum"] == sum(m["data_members"])


@pytest.mark.parametrize("spec", ranks.MESH_SPECS)
def test_batch_and_camera_slices(world, spec):
    """Each data row takes its contiguous 8 / D of a batch of 8, and its
    round-robin or block share of 10 cameras; the gauss ranks of a row take
    the same."""
    D, _ = SHAPES[spec]
    per = 8 // D
    for res in world:
        m = res[spec]
        assert m["batch"] == slice(m["d"] * per, (m["d"] + 1) * per)
        assert m["cams"] == list(range(10))[m["d"]::D]
        assert m["cams_block"] == list(range(10))[m["d"] * 10 // D:(m["d"] + 1) * 10 // D]
    rows = {}
    for res in world:
        rows.setdefault(res[spec]["d"], set()).add(tuple(res[spec]["cams"]))
    assert all(len(v) == 1 for v in rows.values())


def test_a_failed_or_late_world_raises_and_is_killed():
    """spawn_world reports a rank's exception at once and kills the rank
    still waiting; a world past its deadline is killed and reported. No
    test that starts a world can hang the suite."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        multihost.spawn_world(ranks.failing_rank, 2, args=(600,), deadline_s=60)
    with pytest.raises(RuntimeError, match="did not finish within 1"):
        multihost.spawn_world(ranks.failing_rank, 1, args=(600,), deadline_s=1)
    assert time.monotonic() - t0 < 45


def test_lone_process_mesh_is_the_identity():
    """Without a world: Mesh(1, 1) is legal and every collective is the
    identity and records nothing; a larger mesh raises; a spec with an
    unknown axis raises; no spec gives no mesh."""
    mesh = Mesh(1, 1)
    assert (mesh.d, mesh.g, mesh.shape) == (0, 0, {"data": 1, "gauss": 1})
    comm.ledger.reset()
    x = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
    assert comm.all_gather_rows(x, mesh, "gauss", "payload") is x
    assert comm.all_to_all(x, mesh, "gauss", "payload") is x
    t = torch.ones(2)
    assert comm.all_reduce_(t, mesh, "world", "sum", "grad") is t and t.tolist() == [1, 1]
    assert comm.ledger.records == []
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(2, 2)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        multihost.parse_mesh_spec("model=2")
    assert multihost.parse_mesh_spec(None) is None
    assert multihost.initialize_multihost("gloo") == 0       # no torchrun environment


def test_shard_and_unshard_a_whole_state():
    """convert.shard_state's shards, concatenated by unshard_state, are the
    whole state again, bit for bit; the deformation network stays whole in
    every shard."""
    state, aux, *_ = ranks.port_problem(_small_problem())
    shards = [convert.shard_state(state, aux, i, 4) for i in range(4)]
    assert all(s.params["gaussians"].xyz.shape[0] == 32 for s, _ in shards)
    assert all(s.params["deform"]["weight"] is state.params["deform"]["weight"]
               for s, _ in shards)
    whole_state, whole_aux = convert.unshard_state(shards)
    a = convert.checkpoint_arrays(state, aux)
    b = convert.checkpoint_arrays(whole_state, whole_aux)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="equal shards"):
        convert.shard_state(state, aux, 0, 3)


def _small_problem():
    from ed3dgs_torch.config.params import DeformHiddenConfig
    from ed3dgs_torch.models.deformation import init_deform_params
    from ed3dgs_torch.train.optim import flatten_params

    rng = np.random.default_rng(0)
    n = 128
    fields = {"xyz": rng.normal(size=(n, 3)), "features_dc": rng.normal(size=(n, 1, 3)),
              "features_rest": rng.normal(size=(n, 15, 3)), "scaling": rng.normal(size=(n, 3)),
              "rotation": rng.normal(size=(n, 4)), "opacity": rng.normal(size=(n, 1)),
              "embedding": rng.normal(size=(n, 32)), "alive": rng.uniform(size=n) > 0.3,
              "denom": rng.uniform(size=n)}
    fields = {k: v if v.dtype == bool else v.astype(np.float32) for k, v in fields.items()}
    hidden = dict(net_width=32, defor_depth=1)
    deform = {k: v.numpy() for k, v in flatten_params(
        init_deform_params(DeformHiddenConfig(**hidden), seed=0, device="cpu")).items()}
    return dict(fields=fields, hidden=hidden, deform=deform, iteration=3,
                raster=dict(width=32, height=32, focal_x=30.0, focal_y=30.0),
                setup=dict(batch_size=1), batch={})
