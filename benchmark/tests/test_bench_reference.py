"""The frozen reference against the port's plain path at a tiny size on
the CPU, and its independence from the program."""

import glob
import json
import os
import subprocess
import sys

import torch

from harness import common, scene
from reference import step as ref
from small import small_spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_reference_imports_nothing_of_the_program():
    mods = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(HERE, "reference",
                                                                          "*.py")))
    code = ("import sys; sys.path.insert(0, %r)\n" % HERE
            + "".join(f"import reference.{m}\n" for m in mods if m != "__init__")
            + "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    top = set(json.loads(out.strip().replace("'", '"')))
    assert not top & {"ed3dgs_torch", "ed3dgs_tpu", "jax", "jaxlib", "flax"}


def inputs(workload):
    cfg = small_spec(workload)["config"]
    gen = torch.Generator().manual_seed(5)
    cams = scene.rig(cfg)
    params, aux = scene.cloud(cfg, gen, "cpu")
    deform = scene.deform_weights(cfg, gen, "cpu")
    aux = aux._replace(filter_3d=ref.filter_3d(params.xyz, aux.alive,
                                               *common.filter_args(cams, "cpu")))
    return cfg, cams, params, aux, deform


def port(params, aux):
    from ed3dgs_torch.models import gaussians as gm
    return gm.GaussianParams(*params), gm.GaussianAux(*aux)


def test_frame_equals_the_port_plain_render():
    from ed3dgs_torch.render import render
    cfg, cams, params, aux, deform = inputs("nersemble_default.render")
    scfg = common.step_config(cfg, cams, 1 << 17)
    s = common.settings(cams[1], 0.3, "cpu")
    want = ref.frame(params, aux, deform, scfg, *s[:3], 0.3)
    p, a = port(params, aux)
    from ed3dgs_torch.ops.rasterize import RasterConfig
    rc = RasterConfig(**scfg.raster.__dict__)
    h = scfg.hidden
    with torch.no_grad():
        got = render(p, a, deform, h, s, rc, torch.ones(3), iteration=10 ** 9, sh_degree=3,
                     kernel_size=0.0, disable_filter3d=False, num_down_emb_c=h.min_embeddings,
                     num_down_emb_f=h.min_embeddings)["render"]
    assert torch.equal(got, want)


def test_step_equals_the_port_plain_step():
    from ed3dgs_torch.config.loader import load_full_config
    from ed3dgs_torch.ops.rasterize import RasterConfig
    from ed3dgs_torch.train.trainer import TrainSetup, make_loss_and_grads, update_knn_cache
    cfg, cams, params, aux, deform = inputs("nersemble_default.train")
    scfg = common.step_config(cfg, cams, 1 << 17)
    full = load_full_config(os.path.join(os.path.dirname(HERE), cfg["repo_config"]))
    opt, hidden = full.opt, full.hidden
    setup = TrainSetup(raster=RasterConfig(**scfg.raster.__dict__), hidden=hidden, batch_size=1,
                       lambda_dssim=opt.lambda_dssim, opacity_l1_coef=opt.opacity_l1_coef_fine,
                       reg_coef=opt.reg_coef, lambda_depth_normal=opt.lambda_depth_normal,
                       radegs_from_iter=opt.radegs_regularization_from_iter,
                       num_down_emb=hidden.min_embeddings)
    c = cams[2]
    gt = torch.rand((1, 3, cfg["height"], cfg["width"]), generator=torch.Generator().manual_seed(1))
    batch = {"gt_image": gt, "viewmatrix": torch.as_tensor(c["world_view"][None]),
             "projmatrix": torch.as_tensor(c["full_proj"][None]),
             "campos": torch.as_tensor(c["campos"][None]), "time": torch.tensor([0.4]),
             "cam_no": torch.tensor([2]), "use_ssim": True}
    p, a = port(params, aux)
    graph = ref.knn_graph(params.xyz, aux.alive, dict(ref.KNN_CAPS_DEFAULT), 1.0)
    want = ref.loss_and_grads({"gaussians": params, "deform": deform}, aux, batch, graph, 20000,
                              scfg)
    cache = update_knn_cache(p, a, spill_a=4096, spill_b=8192, far_capacity=1 << 17)
    got = make_loss_and_grads(setup)({"gaussians": p, "deform": deform}, a, batch, cache, 20000)
    assert abs(float(got[0]) - float(want[0])) <= 1e-6 * abs(float(want[0]))
    for path, g in want[2].items():
        torch.testing.assert_close(got[2][path], g, rtol=1e-4, atol=1e-6 * float(g.abs().max()))
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=1e-9)
