"""ed3dgs_torch — the PyTorch + CUDA port of ed3dgs_tpu for NVIDIA Hopper.

Deformable 3D Gaussian splatting with per-Gaussian embeddings (E-D3DGS) and
rasterized depth/normal geometry (RaDe-GS). The JAX package `ed3dgs_tpu` is
the reference; this package imports neither it nor JAX, and every Pallas TPU
kernel on a ported path becomes a hand-written CUDA kernel under `csrc/`
(built with nvcc for sm_90a at first use, bound with ctypes).

Ported so far: the forward render, the training step with the KNN
embedding regulariser (K6, K7) and COLMAP supervision, and the training CLI
on a dataset on disk —
  config/    dataclass configs + python config-file loader
  core/      SH, quaternions, sym3 eigen-analysis, camera math, projection
  data/      cameras (lazy images), PLY and PCD I/O, COLMAP models, the
             DyNeRF/NerSemble/Technicolor readers, trajectories, Scene,
             the synthetic scene generator, the port's own PNG codec
             (image_io, with a host C++ unfilter) and the image prefetch
  models/    Gaussian parameters (+ 3D filter, ply load/save) and the deformation MLP
  ops/       tile binning (kernel K4), forward and backward blend (K1, K2),
             relayout and its inverse (K5a, K5b), segment sum (K3), the KNN
             loss (K6, K7), and the rasterizer's autograd wiring
  render/    render() with the reference's output dict
  train/     losses, 9-group Adam, densification, the train step, camera
             sampling and the pair-capacity policy
  tools/     train.py: `python -m ed3dgs_torch.tools.train`
  utils/     the tfevents writer
  convert    JAX-package parameters / checkpoints <-> the port's tensors

Entry points run on the GPU unless the caller asks for the CPU
(`device="cpu"`); on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""

__version__ = "0.1.0"
