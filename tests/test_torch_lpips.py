"""LPIPS in PyTorch (utils/lpips.py) against the JAX package's
(utils/lpips_jax.py) on the CPU.

The pretrained weights are not in the repository, so both run random
weights of the pretrained layout (`random_params`), at the bound of
tests/test_lpips.py (rtol 2e-4, atol 1e-6). The weight resolution and the
converter are held to the JAX package's: one converted npz serves both."""

import os

import numpy as np
import jax
import pytest
import torch

from ed3dgs_tpu.utils import lpips_jax as J

from ed3dgs_torch.utils import lpips as T
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("net_type", ["alex", "vgg"])
def test_lpips_matches_jax(net_type):
    params = T.random_params(net_type, seed=0)
    jparams = J.random_params(net_type, seed=0)
    assert params.keys() == jparams.keys()
    assert all(np.array_equal(params[k], jparams[k]) for k in params)
    rng = np.random.default_rng(1)
    # alexnet needs >= 67 px input for 5 taps through stride-4 + 3 pools
    x = rng.random((2, 3, 96, 80)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape).astype(np.float32), 0, 1)
    want = np.asarray(J.LPIPS(jparams, net_type)(x, y))
    got = T.LPIPS(params, net_type)(x, y).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
    # a tensor input gives the same as the array
    got_t = T.LPIPS(params, net_type)(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    np.testing.assert_array_equal(got_t, got)


def test_lpips_identity_is_zero():
    model = T.LPIPS(T.random_params("alex", seed=0), "alex")
    x = np.random.default_rng(2).random((1, 3, 96, 96)).astype(np.float32)
    assert abs(float(model(x, x)[0])) < 1e-8


def test_load_lpips_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv("ED3DGS_LPIPS_WEIGHTS_ALEX", raising=False)
    monkeypatch.delenv("TORCH_HOME", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert T.weights_path("alex") is None and T.load_lpips("alex") is None
    # the JAX package's cache file serves the port
    cache = tmp_path / ".cache" / "ed3dgs_tpu"
    cache.mkdir(parents=True)
    np.savez(cache / "lpips_alex.npz", **J.random_params("alex", seed=4))
    assert T.weights_path("alex") == J.weights_path("alex") == str(cache / "lpips_alex.npz")
    # the environment variable takes precedence
    p = tmp_path / "w.npz"
    np.savez(p, **J.random_params("alex", seed=5))
    monkeypatch.setenv("ED3DGS_LPIPS_WEIGHTS_ALEX", str(p))
    assert T.weights_path("alex") == J.weights_path("alex") == str(p)
    model = T.load_lpips("alex", device="cpu")
    x = np.random.default_rng(6).random((1, 3, 72, 72)).astype(np.float32)
    y = np.random.default_rng(7).random((1, 3, 72, 72)).astype(np.float32)
    np.testing.assert_allclose(model(x, y).numpy(), np.asarray(J.load_lpips("alex")(x, y)),
                               rtol=2e-4, atol=1e-6)


def _fake_torch_checkpoints(net):
    spec, taps, channels = T._SPECS[net]
    rng = np.random.default_rng(9)
    bstate, hstate = {}, {}
    for idx0, layer in enumerate(spec):
        if layer[0] != "conv":
            continue
        _, cin, cout, k, s, p = layer
        bstate[f"features.{idx0}.weight"] = torch.tensor(
            rng.normal(0, 0.1, (cout, cin, k, k)).astype(np.float32))
        bstate[f"features.{idx0}.bias"] = torch.tensor(
            rng.normal(0, 0.1, cout).astype(np.float32))
    for i, c in enumerate(channels):
        hstate[f"lin{i}.model.1.weight"] = torch.tensor(
            np.abs(rng.normal(0, 0.1, (1, c, 1, 1))).astype(np.float32))
    return bstate, hstate


@pytest.mark.parametrize("net_type", ["alex", "vgg"])
def test_convert_torch_checkpoints_matches_jax(tmp_path, net_type):
    bstate, hstate = _fake_torch_checkpoints(net_type)
    torch.save(bstate, tmp_path / "backbone.pth")
    torch.save(hstate, tmp_path / "heads.pth")
    T.convert_torch_checkpoints(net_type, str(tmp_path / "backbone.pth"),
                                str(tmp_path / "heads.pth"), str(tmp_path / "port.npz"))
    J.convert_torch_checkpoints(net_type, str(tmp_path / "backbone.pth"),
                                str(tmp_path / "heads.pth"), str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_autoconvert_from_torch_hub_cache(tmp_path, monkeypatch):
    monkeypatch.delenv("ED3DGS_LPIPS_WEIGHTS_ALEX", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch"))
    hub = tmp_path / "torch" / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    cache = tmp_path / ".cache" / "ed3dgs_tpu"
    cache.mkdir(parents=True)
    bstate, hstate = _fake_torch_checkpoints("alex")
    torch.save(bstate, hub / "alexnet-owt-7be5be79.pth")
    torch.save(hstate, cache / "lpips_heads_alex.pth")
    assert T.find_backbone_checkpoint("alex") == str(hub / "alexnet-owt-7be5be79.pth")
    assert T.find_heads_checkpoint("alex") == str(cache / "lpips_heads_alex.pth")
    model = T.load_lpips("alex")
    assert model is not None
    assert os.path.exists(cache / "lpips_alex.npz")
    x = np.zeros((1, 3, 64, 64), np.float32)
    assert float(model(x, x)[0]) == pytest.approx(0.0, abs=1e-6)


def test_lpips_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("TORCH_HOME", raising=False)
    bstate, hstate = _fake_torch_checkpoints("alex")
    torch.save(bstate, tmp_path / "b.pth")
    torch.save(hstate, tmp_path / "h.pth")
    out = tmp_path / "out.npz"
    assert T._main(["convert", "--net", "alex", "--backbone", str(tmp_path / "b.pth"),
                    "--heads", str(tmp_path / "h.pth"), "--out", str(out)]) == 0
    assert out.exists()
    assert T._main(["status"]) == 0
    assert "alex:" in capsys.readouterr().out
