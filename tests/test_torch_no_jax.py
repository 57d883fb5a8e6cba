"""The port stands alone: it imports neither JAX nor the JAX package (nor
Pillow, imageio or OpenCV, which the card machine lacks), its
kernel wrappers launch nothing on CPU tensors, and its entry points refuse to
fall back to the CPU when CUDA is asked for and absent."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["PIL"] = None          # the card machine has no Pillow either
sys.modules["imageio"] = None      # nor imageio
sys.modules["cv2"] = None          # nor OpenCV
import ed3dgs_torch
names = [m.name for m in pkgutil.walk_packages(ed3dgs_torch.__path__, "ed3dgs_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("ed3dgs_tpu", "jaxlib"))
assert not bad, bad
assert sys.modules["jax"] is None
for name in ("ed3dgs_torch.train.trainer", "ed3dgs_torch.train.optim",
             "ed3dgs_torch.train.losses", "ed3dgs_torch.train.densify",
             "ed3dgs_torch.ops.segment_sum", "ed3dgs_torch.ops.knn",
             "ed3dgs_torch.ops.knn_loss", "ed3dgs_torch.tools.train",
             "ed3dgs_torch.data.image_io", "ed3dgs_torch.data.readers",
             "ed3dgs_torch.data.scene", "ed3dgs_torch.data.synthetic",
             "ed3dgs_torch.data.native_staging", "ed3dgs_torch.train.sampling",
             "ed3dgs_torch.train.capacity", "ed3dgs_torch.utils.tb_writer",
             "ed3dgs_torch.tools.render", "ed3dgs_torch.tools.metrics",
             "ed3dgs_torch.tools.mesh_extract", "ed3dgs_torch.tools.evaluate_mesh",
             "ed3dgs_torch.utils.lpips", "ed3dgs_torch.data.hyper",
             "ed3dgs_torch.data.nerfies_camera", "ed3dgs_torch.ops.integrate",
             "ed3dgs_torch.mesh.extract", "ed3dgs_torch.mesh.tetra",
             "ed3dgs_torch.mesh.marching_tets", "ed3dgs_torch.mesh.mesh_eval",
             "ed3dgs_torch.mesh.tsdf", "ed3dgs_torch.mesh.tsdf_sparse",
             "ed3dgs_torch.mesh.gaussians_viz", "ed3dgs_torch.render.network_gui",
             "ed3dgs_torch.tools.mesh_extract_tsdf", "ed3dgs_torch.tools.gaussians_to_mesh",
             "ed3dgs_torch.tools.mesh_video", "ed3dgs_torch.tools.viewer",
             "ed3dgs_torch.tools.prepare_data", "ed3dgs_torch.tools.prepare_colmap",
             "ed3dgs_torch.tools.prepare_radegs", "ed3dgs_torch.tools.nersemble_utils",
             "ed3dgs_torch.parallel", "ed3dgs_torch.parallel.mesh",
             "ed3dgs_torch.parallel.comm", "ed3dgs_torch.parallel.multihost",
             "ed3dgs_torch.parallel.tile_sharded", "ed3dgs_torch.parallel.sharded",
             "ed3dgs_torch.utils.graphs", "ed3dgs_torch.utils.trace"):
    assert name in names, name
print(len(names))
"""


def test_every_module_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 79   # every module of the ten slices was imported


def test_chip_smoke_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.argv = ['chip_smoke.py'];"
            "import runpy; runpy.run_path('chip_smoke.py', run_name='imported')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_multi_gpu_script_imports_without_jax():
    """scripts/torch_multi_gpu.py, whose check part holds the NCCL graph of
    the sharded step, with chip_smoke.py, which its ranks import."""
    code = ("import sys; sys.modules['jax'] = None; sys.path.insert(0, '.');"
            "import runpy; runpy.run_path('scripts/torch_multi_gpu.py', run_name='imported');"
            "import chip_smoke; assert 'ed3dgs_tpu' not in sys.modules")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_cpu_tensors_launch_no_kernel():
    """A forward and backward pass on CPU tensors runs the plain versions:
    no kernel counter moves."""
    from ed3dgs_torch.ops import binning_scan, knn_loss, rasterize_cuda, relayout, segment_sum
    from ed3dgs_torch.ops.rasterize import RasterConfig, rasterize
    from ed3dgs_torch.core.projection import project_gaussians
    from ed3dgs_torch.data.cameras import look_at_camera

    counters = (binning_scan.fused_bin_scans, binning_scan.boundary_deltas,
                rasterize_cuda.rasterize_forward,
                relayout.unpack_image, rasterize_cuda.rasterize_backward,
                segment_sum.segment_sum_rows, relayout.pack_image, knn_loss.knn_rows,
                knn_loss.knn_reverse, segment_sum.segment_sum_rows_packed)
    before = [f.launches for f in counters]
    rng = np.random.default_rng(0)
    n = 60
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                      rng.uniform(2, 3, n)], 1).astype(np.float32)
    cam = look_at_camera((0, 0, 0), (0, 0, 1), (0, -1, 0), 1.0, 0.8, 40, 32).matrices()
    xyz = torch.as_tensor(means).requires_grad_(True)
    proj = project_gaussians(
        xyz, torch.full((n, 3), 0.05), torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
        torch.full((n,), 0.7), torch.zeros(n, 16, 3),
        viewmatrix=torch.as_tensor(cam.world_view), projmatrix=torch.as_tensor(cam.full_proj),
        campos=torch.as_tensor(cam.campos), width=40, height=32, tan_fovx=cam.tan_fovx,
        tan_fovy=cam.tan_fovy, focal_x=cam.focal_x, focal_y=cam.focal_y)
    out = rasterize(proj, torch.zeros(n), torch.ones(3),
                    RasterConfig(width=40, height=32, focal_x=cam.focal_x,
                                 focal_y=cam.focal_y, pair_capacity=1 << 10))
    assert float(out.alpha.max()) > 0.5
    (grad,) = torch.autograd.grad(out.color.sum() + out.expected_depth.sum(), xyz)
    assert float(grad.abs().max()) > 0
    emb = torch.randn(n, 8, requires_grad=True)
    idx = torch.randint(0, n, (n, 5))
    graph = knn_loss.prepare_knn_graph(idx, torch.rand(n, 5), torch.full((n,), 0.01), xyz.detach())
    (gemb,) = torch.autograd.grad(knn_loss.knn_loss_fused(emb, graph, 5), emb)
    assert float(gemb.abs().max()) > 0
    segment_sum.segment_sum_rows_packed(torch.ones(6, 4), torch.tensor([0, 2], dtype=torch.int32),
                                        torch.tensor([2, 6], dtype=torch.int32))
    assert [f.launches for f in counters] == before


def test_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from ed3dgs_torch import convert
    from ed3dgs_torch.config.params import DeformHiddenConfig
    from ed3dgs_torch.device import resolve_device
    from ed3dgs_torch.models import deformation, gaussians
    from ed3dgs_torch.render import settings_from_camera
    from ed3dgs_torch.data.cameras import look_at_camera

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        deformation.init_deform_params(DeformHiddenConfig(net_width=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.load_model(str(tmp_path), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        gaussians.from_numpy({k: np.zeros((2, 3)) for k in ("xyz", "scaling")}
                             | {"features_dc": np.zeros((2, 1, 3)),
                                "features_rest": np.zeros((2, 15, 3)),
                                "rotation": np.zeros((2, 4)), "opacity": np.zeros((2, 1)),
                                "embedding": np.zeros((2, 32))})
    cam = look_at_camera((0, 0, 0), (0, 0, 1), (0, -1, 0), 1.0, 1.0, 8, 8).matrices()
    with pytest.raises(RuntimeError, match="CUDA"):
        settings_from_camera(cam)
    assert resolve_device("cpu") == torch.device("cpu")


def test_serving_tools_refuse_the_cpu_unless_asked(tmp_path):
    """tools.render, .metrics, .mesh_extract and .evaluate_mesh run on the
    card by default and raise without one; `--device cpu` is the only way
    onto the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from ed3dgs_torch.data.synthetic import generate_hyper_scene
    from ed3dgs_torch.tools import evaluate_mesh, mesh_extract, metrics, render

    model = str(tmp_path)
    for run in (lambda: render.main(["-m", model]),
                lambda: metrics.main(["-m", model]),
                lambda: mesh_extract.main(["-m", model]),
                lambda: evaluate_mesh.main(["-m", model, "--gt_dir", model]),
                lambda: generate_hyper_scene(str(tmp_path / "hyper"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
    assert metrics.main(["-m", model, "--device", "cpu"]) == {}
    assert evaluate_mesh.main(["-m", model, "--gt_dir", model, "--device", "cpu"]) == {}


def test_offline_tools_refuse_the_cpu_unless_asked(tmp_path):
    """The TSDF, Gaussian-mesh, mesh-video, viewer and render-mesh tools run
    on the card by default and raise without one; `--device cpu` is the
    only way onto the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from ed3dgs_torch.tools import (gaussians_to_mesh, mesh_extract_tsdf, mesh_video,
                                    nersemble_utils, viewer)

    model = str(tmp_path)
    (tmp_path / "timestep_0").mkdir()
    from ed3dgs_torch.data.ply import store_point_cloud
    store_point_cloud(str(tmp_path / "mesh.ply"), np.zeros((3, 3)), np.zeros((3, 3)))
    for run in (lambda: mesh_extract_tsdf.main(["-m", model]),
                lambda: gaussians_to_mesh.main(["-m", model]),
                lambda: viewer.main(["-m", model, "--port", "0"]),
                lambda: mesh_video.main([model]),
                lambda: nersemble_utils.main(["render-mesh", str(tmp_path / "mesh.ply")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
    assert mesh_video.main([model, "--device", "cpu"]) == []


def test_multi_device_path_refuses_the_cpu_unless_asked():
    """A rank's device is the card unless the CPU is asked for; NCCL is
    refused where it cannot run (the CPU, ranks sharing a card) instead of
    being swapped for gloo; tools.train --mesh needs a GPU by default."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from ed3dgs_torch.parallel import multihost
    from ed3dgs_torch.tools import train

    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.rank_device("cuda", share=True)
    assert multihost.rank_device("cpu") == torch.device("cpu")
    for device, share in ((torch.device("cpu"), False), (torch.device("cuda", 0), True)):
        with pytest.raises(ValueError, match="nccl"):
            multihost.check_backend("nccl", device, share)
    multihost.check_backend("gloo", torch.device("cuda", 0), True)
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize_multihost("mpi")
    args = train.parse_args(["-s", "x", "-m", "y", "--mesh", "data=1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run_training(train.build_config(args), args)
