"""ed3dgs_torch — the PyTorch + CUDA port of ed3dgs_tpu for NVIDIA Hopper.

Deformable 3D Gaussian splatting with per-Gaussian embeddings (E-D3DGS) and
rasterized depth/normal geometry (RaDe-GS). The JAX package `ed3dgs_tpu` is
the reference; this package imports neither it nor JAX, and every Pallas TPU
kernel on a ported path becomes a hand-written CUDA kernel under `csrc/`
(built with nvcc for sm_90a at first use, bound with ctypes).

Ported so far: the forward render of one frame and one training step
(without the KNN embedding regulariser) —
  config/    dataclass configs + python config-file loader
  core/      SH, quaternions, sym3 eigen-analysis, camera math, projection
  data/      cameras and the PLY reader/writer
  models/    Gaussian parameters (+ 3D filter, ply load) and the deformation MLP
  ops/       tile binning (kernel K4), forward and backward blend (K1, K2),
             relayout and its inverse (K5a, K5b), segment sum (K3), and the
             rasterizer's autograd wiring
  render/    render() with the reference's output dict
  train/     losses, 9-group Adam, densification statistics, the train step
  convert    JAX-package parameters / checkpoints -> the port's tensors

Entry points run on the GPU unless the caller asks for the CPU
(`device="cpu"`); on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""

__version__ = "0.1.0"
