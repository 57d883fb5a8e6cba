#!/usr/bin/env python3
"""Smoke run of ed3dgs_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Builds the CUDA kernels from ed3dgs_torch/csrc (nvcc, sm_90a, one process per
source, all at once), then, at the width of configs/nersemble/default.py
(net_width 128, defor_depth 1, 256-d temporal and 32-d Gaussian embedding,
max_embeddings 150, SH degree 3, 3D filter on, bf16 activations) on the
bench scene (100k Gaussians, capacity 100,352, 802x550, pair capacity 2^20,
chunk 128):

1. renders one warm-up frame and records the inputs the render hands K1, X2,
   K4 and K5a; holds each of them against its plain PyTorch version on those
   inputs (X2, K4 and K5a bit-exact; K1 within the tolerances below) and
   times kernel, plain version and library yardstick with CUDA events, L2
   flushed before every launch (K1 and K2 also report their registers, shared
   memory and resident CTAs per SM);
2. drives the forward main path: `ed3dgs_torch.render.render` on three
   frames. Every launch count is set to 0 just before and read just after;
   K1, X2, K4 and K5a must each have risen by one per frame. Profiles one
   frame and counts K4's kernels in it (one: its single pass). X2 writes the
   delta streams K4 scans: in every window of this run where K4 is counted,
   X2 must have launched as often;
3. drives the training loop of the JAX package's tools/train.py at the
   config's reg_coef (1.0) and knn_coverage_target (0.95): the 3D filter
   from `compute_3d_filter` over the bench camera and four around it;
   X1 (`ops/knn.py` `knn` on the card, csrc/knn.cu) against `knn_plain` on
   the refresh's own input (the main graph's 100,352 points, dead slots
   parked on the far shell, k = 20), distances and indices equal by
   torch.equal, then on X1_EDGES (ties, distances below zero, N = k + 1,
   ragged N, k = 1, 3, 20, 31, clusters, collinear points, an offset
   cloud), k = 32 refused; both timed as in 1, with X1's registers, CTAs
   per SM, tiles visited a warp (mean, max) and pairs evaluated; its bound
   from the inputs (bytes, and the N (k + 1) pairs of the answer), and
   beside it the bound over the pairs evaluated and over all N^2; X1 timed
   again on X1_BIG points;
   `refresh_knn_cache` (its wall time, final buckets, overflow, far demand
   and the trainer's coverage measure) and its two halves timed apart (the
   neighbour search `_cache_inputs`, the graph preparation `_prepare_cache`),
   and its cache held tensor for tensor to one built through `knn_plain`;
   `init_train_state` ->
   `make_train_step(..., graph=False)` (the eager step) and
   `make_train_step` (the default: a CUDA graph captured per key and
   replayed), one eager warm-up step that records the inputs the step
   hands K2, K3, K5b, K6 and K7; (a) one eager step with SSIM off and one
   with SSIM on under `torch.cuda.set_sync_debug_mode("warn")`, printing
   each host-device wait and where it is; (b) six steps of each from one
   state with the same batches, from three iterations before the
   depth-normal term to three after, SSIM on and off (four keys): after
   every step every metric, parameter, Adam moment and aux statistic must
   be bit-identical, each replay runs under sync debug mode "error" and
   every graphed step must launch K1-K7 on the card as an eager step does.
   A replay calls no kernel wrapper, so the graphed paths' launches are
   counted on the card by the kernels themselves (each adds one to its
   wrapper's counter when it runs: csrc/launch_count.cuh, read by
   ops/cuda_lib.py `DeviceLaunches`), and the wrappers count only eager
   launches (a capture launches nothing); (c)
   five steps at iteration 20,000 (deformation, coarse-to-fine, SH 3, the
   KNN regulariser and the depth-normal term live; SSIM on two of them),
   eager and graphed (the main path, its launches read from the device
   counters), from the same state (the metrics
   bit-identical). Every count is set to 0 just before each five: K1-K5b
   must have risen by steps x batch, K6 and K7 by exactly one per step, K8
   (no production caller) not at all.
   Prints each step's loss, the step time by CUDA events, the host time to
   return from each step and the device allocations (cudaMalloc) it made,
   one profiled graphed step's device busy time and idle share (against
   the profiler's wall and against the steps' time by events) and top
   device items, and the captures (keys, seconds each, pool bytes); (d)
   `tools.FrameRenderer`'s graphed frame against the eager one at the
   three frame times, bit for bit, both timed by events. Then one profiled
   eager step's device busy time, idle share and top device items, and
   K6's and K7's device time inside it (warm L2), then profiles the eager
   step four times in turns with K3 reading the pair-gradient rows through
   the inverse pair permutation (as shipped) and with the gather before K3
   (the unfolded path) and reports the backward stage of each. Then
   `make_densify_step` at the config's gradient threshold (n_cloned,
   n_split, the alive count) or, where nothing reaches it, at the 99.9th
   percentile of the same statistics: eager (graph=False), then graphed
   (the default, a CUDA graph per input signature) twice, each from the
   same state with a generator of the same seed, the graphed results
   bit-identical to the eager ones (parameters, aux, every Adam moment,
   n_cloned, n_split), each timed by CUDA events; the filter and KNN refreshes
   (every count set to 0 before the densify step: X1 must launch once),
   and two more steps eager and graphed from the densified state (copied
   into the graphed step's static buffers with the new KNN cache), counted
   as the five were and bit-identical;
4. holds K2, K3, K5b, K6, K7 and K8 against their plain versions on the
   recorded inputs (K5b bit-exact; K2's live-chunk counts exactly and every
   row of every tile within K2_REL of its column's largest value; K3, as
   the step calls it (through the index) and on the gathered rows, and K8
   within K3_REL of the largest output; the KNN loss within KNN_LOSS_REL
   and every row of dL/demb within KNN_ROW_REL of its largest value), runs
   the payload gradient (K2 -> K3 through the index) and the KNN gradient (K6 ->
   K7) twice each and requires bit-identical results, and times them as in
   1 (K6 and K7 also report registers, shared memory, spilled bytes,
   resident CTAs per SM and their wrappers' host microseconds a call, and
   the graph's in-degree distribution);
5. compares a 4096-Gaussian cut on the card with the CPU: its bf16
   deformation, its render at 160x110 (float32 activations), one train
   step's loss and gradients at reg_coef 1 (float32 activations, each
   device building its own KNN cache) at the config's 32-d Gaussian
   embedding and again at 16-d (the KNN kernels run it zero-padded), one
   `densify` with the same injected draws, and `create_from_points`;
5b. the tongue phase: configs/nersemble/tongue.py (the tongue terms on) on
   the bench cloud with its first TONGUE_N Gaussians in a compact blob of
   tongue class 1 (`tongue_cloud`): `refresh_knn_cache(tongue_enabled=
   True)`, whose two searches (the main graph's input, then the tongue
   graph's, every other slot parked on the mirrored far shell) are each held
   to `knn_plain` by torch.equal and timed, with both graphs' dropped edges
   by bucket (spill_a, spill_b, far); K6 and K7 on the tongue graph against
   their plain chain and timed; then the steps of TONGUE_SSIM from
   iteration 20,000 (depth-normal live, SSIM off and on: two keys) eager
   and graphed from one state, each batch with a tongue target (the
   tongue-only alpha of the state with the blob jittered), bit for bit
   after every step (params, aux, every moment, every metric, the four
   tongue terms included), each graphed step launching K1-K5b 3 times
   (the camera and the last camera's tongue-only and tongue-free renders)
   and K6 and K7 twice on the card, every tongue term non-zero, both ways
   timed by CUDA events, the captures' pool bytes; `make_densify_step`
   eager and graphed twice on that state at the phase's threshold rule
   lowered to the hottest clone-sized and the hottest larger tongue
   Gaussian, bit for bit, tongue parents among those cloned and split and
   every child of class 1; both refreshes (X1 twice again) and TONGUE_MORE
   steps that must replay the known keys on the new tongue graph, bit for
   bit. Then the COLMAP step (configs/nersemble/407_tongue_colmap_
   supervision.py, the cloud in a capacity of 150,000: 4000 GT points near
   it, a numpy seed) graphed against eager bit for bit for both pcd_valid
   keys, pcd_loss non-zero exactly when valid, timed, with its pool bytes;
5c. the families phase: the upstream E-D3DGS dataset families, each
   through one per-scene config at full width (FAMILIES: DyNeRF's
   cook_spinach at 1600x1200, Technicolor's Birthday at 1600x850 with the
   principal point off centre, HyperNeRF's vrig-chicken at 536x960, batch
   2): (a) FAM_N Gaussians in FAM_CAPACITY slots over the camera's frustum,
   the 3D filter and the KNN refresh (X1 once), one eager step at the
   config's pair capacity whose demand CapacityPolicy turns into the
   capacity the rest runs at, which binning path that capacity and grid
   take (K4's packed key: 18 + 13 = 31 bits at 1600x1200), X2, K4, K1, K5a,
   K2, K3 and K5b held to their plain versions on one step's inputs at the
   bounds of 1 and 4 and timed, then the eager and graphed steps over every
   key the config's schedule meets (each key at the first iteration that
   meets it, then again: captures, then replays), bit for bit, launching
   K1-K5b once a camera and K6/K7 once a step, with the temporal TV term
   live exactly where configured; a densify (eager against graphed twice,
   bit for bit), the filter and KNN refreshes (X1 once) and FAM_MORE steps
   that must replay known keys; (b) `tools.train.main` on a scene
   generated on the card at the family's raw frame size, FAM_CLI_ITERS
   iterations with FAM_CLI_SET's one densify event: K1-K7 and X1 launched
   as the steps, batch and refreshes need, the losses finite; its ms an
   iteration against (a)'s graphed step, the PNG decode and resize ms a
   frame, the capacity log and each graph's captures and pool bytes; (c)
   `tools.render.main` of the saved model (FAM_SERVE_FRAMES a split,
   DyNeRF's spiral video cameras too): a PNG a frame, K1, X2, K4 and K5a
   once a frame, render and PNG ms a frame;
6. the `cli` phase: `ed3dgs_torch.data.synthetic.generate_scene` on the card
   (802x550, 4 cameras with cam00 held out, 8 frames, 20,000 points; K1
   renders the frames) into a temporary directory, then
   `ed3dgs_torch.tools.train.main` in-process at the full width of
   configs/nersemble/default.py for 300 iterations (CLI_SET overrides only
   schedule keys), with a checkpoint at 150, the model saved at 300, a test
   PSNR every 100 and densify events at 150, 200, 250 (the tool's default:
   the step and the test render as CUDA graphs; the line gives the
   captures and the ms each iteration's first read of the step's results
   waited); every count is set to 0 just before and K1-K7 must each have
   launched on the card (device counters), K6
   and K7 once a step, X1 once for the initial scales, once for the first
   KNN refresh and once a densify event. Then it resumes
   from the checkpoint for 20 iterations (the state it loads must equal
   the file's arrays bit for bit) and reloads the saved model through
   `convert.load_model` (its render must equal the in-memory state's bit
   for bit). It prints a `cli` JSON line: iterations, wall seconds, median
   wall ms per iteration against the bare step's ms of phase 3, image
   decode ms per frame and the stager's wait ms per iteration, the loss
   and train PSNR of the first and last 100-iteration windows, the test
   PSNRs, alive points at start and end, densify events, pair-capacity
   changes and the phase's launches. It fails on a kernel that did not
   launch, a loss that is not finite, a last window whose train PSNR is
   not above the first's, or a resumed or reloaded state that differs;
7. the `serve` phase, on the `cli` phase's scene and trained model (the
   saved iteration 300): `ed3dgs_torch.tools.render.main` on the train,
   test and video splits at 802x550 (the train and video splits cut to
   SERVE_FRAMES frames, the test split's 8 whole), once for its times and
   once more inside the counted window, then `tools.metrics.main` on the
   test renders, `tools.mesh_extract.main` at timestep 0 (the three train
   views, eight binary steps) and `tools.evaluate_mesh.main` against the
   scene's own point cloud. Every count is set to 0 just before the
   window: K1 and K5a must have launched on the card (device counters) once
   per frame and mask rendered, K4 also once per integration, X1 once (the
   tetra points' outlier filter). It prints a `serve` JSON line: frames per split, the
   tool's FPS, the median render ms (after a synchronise) and PNG-save ms
   a frame, the launches, PSNR/SSIM/LPIPS from results.json, the tetra
   point count, the Delaunay, SDF and whole extraction seconds, the mesh's
   vertex and face counts and its distance to the cloud. Then it renders
   the same test frames through `render()` and scores them in float
   (`float_test_psnr`), and runs `ops.integrate.integrate_points` on the
   card and on the CPU on the tetra points of 4096 of the model's
   Gaussians. It fails on a launch count that differs, a metrics PSNR more
   than SERVE_PSNR_TOL dB from the float PSNR of the same frames (the tool
   reads 8-bit PNGs), an empty mesh or one with a vertex that is not
   finite, or a card integration further than INTEGRATE_TOL from the CPU's.
   The `cli` phase's last test PSNR is printed beside them, but it scores
   another function: the trainer renders at its iteration (300: the
   deformation's annealing at 0.25-0.3 and 4 of 8 temporal embeddings),
   the tools, as the JAX package's, at iteration 10**9 (all schedules
   done);
   After it, the tongue cli run: `generate_scene(tongue_frac=0.1)` (the
   cli phase's cameras, frames and points; segmentations and red seeds)
   trained through `tools.train.main` with configs/nersemble/tongue.py for
   TONGUE_CLI_ITERS iterations across one densify event and its refresh:
   K1-K7 launched, K6 and K7 twice a step, X1 once for the scales and twice
   a refresh, every loss and tongue term finite, each tongue term non-zero,
   the tongue count at the start the red seeds and above 0 at the end, the
   train PSNR rising; then `tools.render --tongue_renders` on its model
   (TONGUE_SERVE_FRAMES a split, no video): the tongue, tongue_render and
   wo_tongue_render PNGs of every view, K1, X2, K4 and K5a three times a
   frame, the render ms a frame of each filter;
8. the `offline` phase, on the same scene and model:
   `tools.mesh_extract_tsdf.main` at timestep 0 (the three train views),
   sparse at the default voxel of 0.002 with its views rendered through
   `tools.FrameRenderer`'s graph (the default) and dense at
   OFFLINE_DENSE_VOXEL with them rendered eagerly (`FrameRenderer(graph=
   False)`, render() op by op): the two runs' masked depths and colours
   equal bit for bit, their render ms a view printed side by side; each
   view's masked depth and colour fused again on the CPU and compared
   (block keys and rows, the fields, the (voxel, view) projections the two
   devices put on another pixel, the faces); `tools.gaussians_to_mesh.main`
   at timesteps 0-1 as configured, then at float32 activations on the card
   and on the CPU; `tools.mesh_video.render_points` on the serve phase's
   recon.ply and on recon_tsdf.ply from SPLAT_EYES, card against CPU; the
   viewer server (`render/network_gui.py` with `tools.viewer.make_handler`)
   in a thread with a loopback client sending a train camera at 802x550,
   the same at 1000x562 and an empty request, each reply against
   `render()` quantised the same way; and the preparation tools
   (`prepare_data nersemble`, `downsample`, `add-tongue-points`,
   `prepare_colmap.convert_poses_to_colmap_db`, `nersemble_utils
   pose-bounds`, `seg-color`, `render-mesh`) on a 2-camera, 2-timestep
   raw capture of PNG frames it writes. Every count is set to 0 before
   each TSDF run and again before the viewer's requests: K1, X2, K4 and K5a
   must each have launched once in the graphed TSDF run (its capture's
   eager run; a replay calls no wrapper), once per view in the eager one
   and (on the card, device counters) once per request rendered. It
   prints an `offline` JSON line; it fails on a launch count that
   differs, or a comparison past the bounds below;
9. the `multi` phase (ed3dgs_torch/parallel/): two ranks that share
   cuda:0 in one gloo world (`spawn_world`), from the train phase's state
   after its densify: (a) `render(mesh=...)` of one frame over a gauss
   pair (the strip exchange) against `render()` in one process; (b) three
   steps at data=1 x gauss=2 with the strip exchange, batch 1; (c) three
   steps at data=2 x gauss=1, gspmd, batch 2, both eager (graph=False:
   gloo's collectives cannot be captured; the NCCL graph needs a card a
   rank, scripts/torch_multi_gpu.py --check): each rank's gathered state
   after the first step held to the single-process step from the same
   state, and every step's loss and PSNR to the single-process run's;
   (d) `python -m torch.distributed.run --nproc_per_node 2 -m
   ed3dgs_torch.tools.train --mesh data=1,gauss=2 --comms strip
   --share_device --dist_backend gloo` for MULTI_CLI_ITERS iterations on
   the cli phase's scene, its checkpoint reloaded and rendered in one
   process (a test PSNR); (e) the sharded step graphed in a world of one
   on this card (a Mesh(1, 1): the gspmd and strip code captured without a
   collective), gspmd and strip, against graph=False over (b)'s batches,
   bit for bit, each step timed. Each of (a)-(c) sets every count to 0 just before
   it and reads it just after: each rank must launch exactly the kernels a
   step needs (K1-K7). It prints each rank's launches, the collectives'
   bytes a step by kind, the steps' host ms on the shared card (a cost,
   not a scaling measurement) and a `multi` JSON line; the kernels line's
   launches add the ranks' and 5b's graphed steps' to the train path's.

Weights are random, from numpy seeds; so are the training targets. Results go
to DIR/chip_smoke.json (default smoke_out/ in the checkout), with the
profiles and nvcc's register report beside it. The last nine lines of
standard output are the `families`, `tongue`, `cli`, `serve`, `offline` and
`multi` JSON lines, the card as nvidia-smi names it, the kernels' JSON line
and the result line. The kernels line lists K1-K8, X1 and X2 (X2's launches
counted as K4's); X1's launches are
those of the densify step and refreshes in 3, of 5b's two tongue refreshes
and of 5c's refreshes (its own path: the search runs at a refresh, not in a
step), and it also carries its `cli` and `serve` counts; each row carries
5b's launches (`tongue_launches`) and 5c's (`families_launches`, within
`launches`) with its ms at each family's shapes (`families_ms`), K6 and K7
their ms on the tongue graph, X1 its ms on the tongue graph's input.
Any failure exits non-zero before the result line.
Needs one CUDA device; refuses to run without one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

N_GAUSS, CAPACITY = 100_000, 100_352
WIDTH, HEIGHT = 802, 550
PAIR_CAPACITY = 1 << 20
FRAME_TIMES = (0.0, 0.5, 1.0)
TRAIN_STEPS = 5
TRAIN_ITERATION = 20_000
SSIM_STEPS = (1, 3)          # steps (of the five) with the periodic SSIM term on
SMALL_N, SMALL_W, SMALL_H = 4096, 160, 110
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit). Integer work
# is counted against the fp32 CUDA-core rate: the table has no int32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per pair-pixel evaluation of K1 (offsets, exponent, exp2,
# opacity, clamp, the two pass tests) and per blended splat (transmittance,
# weight, 12 channel and 8 plane-term accumulations, include test)
K1_OPS_PER_EVAL = 14
K1_OPS_PER_INCLUDE = 45
# The function K2 computes needs two alpha evaluations per needed
# pair-pixel (the front-to-back pass and the back-to-front one that forms
# the gradient) and, per blended splat, one cotangent dot (~50 flops), the
# alpha gradient (~10) and 26 gradient terms with their sums (~60). It reads
# 10 channels of the forward output and 17 of its cotangent.
K2_OPS_PER_EVAL = 2 * K1_OPS_PER_EVAL
K2_OPS_PER_INCLUDE = 120
K2_CHANNELS_READ = 10 + 17

# K1 against its plain version: the two sum the same rows in another order
# (a sequential product and sum against torch.cumprod and einsum), so values
# differ by float rounding scaled by 1/weight where a pixel has little
# coverage. Every channel is held to K1_ATOL + K1_RTOL*|value| on every
# pixel, except the median ones (mcoord, mdepth): a pixel whose
# transmittance sits at the 0.5 crossing may select the neighbouring splat,
# and at most K1_MAX_FLIPPED of the pixels may do so.
K1_ATOL, K1_RTOL = 1e-4, 1e-4
K1_MAX_FLIPPED = 1e-3          # fraction of pixels per median channel
# The small render, card against CPU, under the same rule: float32
# activations on both (bf16 rounding of the MLP would differ with the
# accumulation order; the bf16 path is held to the JAX package's on the CPU
# by tests/test_torch_deformation.py).
SMALL_ATOL, SMALL_RTOL, SMALL_MAX_FLIPPED = 1e-4, 1e-4, 1e-3
MEDIAN_KEYS = ("median_coord", "median_depth")
# The bf16 deformation of the small cut, card against CPU: both round each
# layer's f32-accumulated product to bf16, and only a value whose sum lands
# at a rounding midpoint in one summation order and not the other rounds the
# other way. At most BF16_MAX_DIFFERING of each output's values may differ by
# more than BF16_ATOL; float32 activations differ in nearly all of them.
BF16_ATOL, BF16_MAX_DIFFERING = 1e-6, 1e-3
# K2 against its plain version: every row of every tile within K2_REL of
# its column's largest value (sequential sums against cumprod/cumsum/einsum).
# K3 (and K8, the same kernel) against its plain version: both round a
# float64-exact sum once.
K2_REL, K3_REL = 1e-4, 1e-6
# X1 (the k-NN) against knn_plain: distances and indices equal by
# torch.equal, no tolerance (both round every operation once in float32 and
# order by the same integer key), on the refresh's input and on X1_EDGES:
# (cloud, N, k) with ties, distances below zero, N = k + 1, N not a multiple
# of a warp's 32 queries or a tile's 128 points, k = 1, 3, 20, 31, clusters of very different
# density, collinear points (flat tile boxes) and a cloud far from the
# origin; k = X1_REFUSED must raise.
X1_EDGES = (("duplicated", 1200, 20), ("cancelling", 600, 20), ("uniform", 21, 20),
            ("uniform", 1000, 3), ("uniform", 500, 1), ("uniform", 1000, 31),
            ("clusters", 2200, 20), ("collinear", 1500, 20), ("offset", 2200, 20))
X1_REFUSED = 32
# flops a pair as the fp32 peak counts them: fmul 1, two fma 4, add 1,
# doubling 1, subtract 1 (the compare none)
X1_FLOPS_PER_PAIR = 8
# X1 is also timed on a cloud 4x the refresh's: uniform in the bench box,
# 4 x 352 rows on the far shell
X1_BIG = 401_408
# K6 -> K7 against the plain chain: the kernel reduces d2 by a shuffle
# butterfly and the loss by CTA partials, torch.sum in another order; every
# other operation is the same. The loss within KNN_LOSS_REL, every row of
# dL/demb within KNN_ROW_REL of that row's largest value.
KNN_LOSS_REL, KNN_ROW_REL = 1e-5, 1e-5
# the 3D filter's cameras: the bench camera and four around it
FILTER_EYES = ((0.0, 0.0, 0.0), (0.3, 0.0, 0.0), (-0.3, 0.0, 0.0), (0.0, 0.2, 0.0),
               (0.0, -0.2, 0.0))
MORE_STEPS = 2               # steps after the densify step and the refreshes
# the graphed step against the eager one: the SSIM gate of each step, from
# three iterations before the depth-normal term to three after
GRAPH_SSIM = (True, False, True, True, False, False)
FRAME_REPS = 10              # frames timed each way
# the small cut's densify: free capacity beside the cloud, hot statistics
SMALL_CAP = 5120
# One train step of the small cut, card against CPU (float32 activations):
# the loss within SMALL_LOSS_REL, and every gradient leaf within
# SMALL_GRAD_REL of that leaf's largest value.
SMALL_LOSS_REL, SMALL_GRAD_REL = 1e-5, 1e-3
# The cli phase: `python -m ed3dgs_torch.tools.train` in-process on a
# generated 802x550 scene (4 cameras, cam00 held out, 8 frames) at the full
# width of configs/nersemble/default.py. Only schedule keys are overridden:
# the deformation from iteration 50 (not 5000), densification every 50
# iterations from 100 to 260 (events at 150, 200, 250), the depth-normal
# term from iteration 0, and 4..8 temporal embeddings for 8 frames.
CLI_POINTS, CLI_CAMS, CLI_FRAMES = 20_000, 4, 8
CLI_ITERS, CLI_CKPT, CLI_RESUME, CLI_TEST_EVERY = 300, 150, 20, 100
CLI_SET = ["deform_from_iter=50", "densify_from_iter=100", "densify_until_iter=260",
           "densification_interval=50", "radegs_regularization_from_iter=0",
           "min_embeddings=4", "max_embeddings=8"]
CLI_WINDOW = 100             # iterations a loss / PSNR window averages
# The serve phase: the tools on the cli phase's model. The train (24 views)
# and video splits are cut to SERVE_FRAMES frames; the test split has 8.
SERVE_FRAMES = 16
SERVE_PSNR_TOL = 0.5         # dB between the metrics tool and the cli test PSNR
# integrate_points on the card against the CPU, on the tetra points of
# INTEGRATE_N Gaussians of the trained model: every output within
# INTEGRATE_TOL
INTEGRATE_N, INTEGRATE_TOL = 4096, 1e-5
# The offline phase, on the cli phase's model: TSDF at the tool's default
# voxel (sparse) and the dense engine at OFFLINE_DENSE_VOXEL, each card
# against the CPU on the same masked depths: the fields within
# TSDF_FIELD_TOL on every voxel whose projected pixel the two devices agree
# on, at most TSDF_MAX_MOVED of the (voxel, view) projections on another
# pixel. The Gaussian meshes (float32 activations on both) within
# GAUSS_MESH_TOL. render_points' frames (the tool's 550x802) differing on at
# most SPLAT_MAX_DIFFERING of the pixels beyond SPLAT_TOL (the shading's
# last float bit), from SPLAT_EYES around the scene's centre. The viewer
# answers VIEWER_SIZES and an empty request.
OFFLINE_DENSE_VOXEL = 0.01
TSDF_FIELD_TOL, TSDF_MAX_MOVED = 1e-6, 1e-4
GAUSS_MESH_TOL = 1e-5
SPLAT_TOL, SPLAT_MAX_DIFFERING = 1e-6, 1e-3
SPLAT_EYES = ((0.0, 0.0, 1.2), (0.7, -0.1, 1.6), (-0.7, -0.1, 1.6))
SPLAT_TARGET, SPLAT_UP, SPLAT_ZOOM = (0.0, 0.0, 2.2), (0.0, -1.0, 0.0), 0.4
VIEWER_SIZES = ((802, 550), (1000, 562))
PREP_W, PREP_H = 550, 802    # a NerSemble images-2x frame

# The multi phase: two ranks on cuda:0 in one gloo world (NCCL refuses two
# ranks on one card) at the train phase's width and state: (a) one frame of
# render(mesh=gauss 2) against render() on one process, every channel within
# MULTI_ATOL + MULTI_RTOL*|value| (tests/test_tile_sharded.py:74); (b)
# MULTI_STEPS steps at data=1 x gauss=2 with the strip exchange, batch 1,
# and (c) MULTI_STEPS steps at data=2 x gauss=1, gspmd, batch 2: the state
# after the first step held to the single-process step from the same state
# at tests/test_parallel.py:70-79's bounds (that test holds one step), and
# every step's loss and PSNR to the single-process run's; (d) tools.train under
# torch.distributed.run on two ranks (--mesh data=1,gauss=2 --comms strip
# --share_device) for MULTI_CLI_ITERS iterations on the cli phase's scene,
# its checkpoint reloaded and rendered in one process; (e) the sharded step
# graphed in a world of one on this card against graph=False, gspmd and
# strip, bit for bit: the train phase's step, and from 5b's states its tongue
# step (MULTI_E_STEPS batches) and COLMAP step (both pcd_valid keys), whose
# graphed launches on the card join the phase's. The world must finish
# within MULTI_DEADLINE s, the torchrun within MULTI_CLI_DEADLINE s.
MULTI_ATOL, MULTI_RTOL = 2e-5, 1e-4
MULTI_STEPS = 3
MULTI_LOSS_REL, MULTI_PSNR_REL = 2e-4, 2e-3
MULTI_XYZ_ATOL, MULTI_WEIGHT_ATOL, MULTI_DENOM_ATOL = 5e-5, 5e-6, 1e-6
MULTI_DEADLINE, MULTI_CLI_DEADLINE = 240.0, 300.0
MULTI_CLI_ITERS = 30
MULTI_EYE2 = (0.15, 0.05, 0.0)   # the second view of (c)'s batch of two
MULTI_E_STEPS = 3             # (e)'s tongue steps from 5b's state: SSIM off, on, off

# The tongue phase (5b): configs/nersemble/tongue.py on the bench cloud,
# whose first TONGUE_N Gaussians are moved into a compact blob of tongue
# class 1 (normal around TONGUE_CENTRE, TONGUE_SD an axis), the first
# TONGUE_SMALL of them at scales below percent_dense x extent (clone
# candidates; the rest split). Its target is the tongue-only alpha of the
# state with the blob jittered by TONGUE_JITTER: it must cover more than
# the 0.005 mean that gates the tongue colour term. The steps run from
# TRAIN_ITERATION with the SSIM gate of TONGUE_SSIM, graphed against eager
# bit for bit; after a densify and both refreshes TONGUE_MORE more.
TONGUE_CFG = os.path.join("configs", "nersemble", "tongue.py")
TONGUE_N, TONGUE_SMALL = 3000, 64
TONGUE_CENTRE, TONGUE_SD, TONGUE_JITTER = (0.05, 0.05, 2.0), 0.05, 0.01
TONGUE_SSIM = (False, True, False, True, False, True)
TONGUE_MORE = 2
# The COLMAP step on the same cloud at the settings of
# configs/nersemble/407_tongue_colmap_supervision.py, in a capacity of
# COLMAP_CAPACITY (the tongue config's max_number_gaussians: the loss's
# distance blocks are [500, C]): its GT cloud is colmap_pcd_samples points
# drawn from a numpy seed within COLMAP_JITTER of alive Gaussians;
# pcd_valid as COLMAP_VALID, SSIM off (two keys)
COLMAP_CFG = os.path.join("configs", "nersemble", "407_tongue_colmap_supervision.py")
COLMAP_CAPACITY = 150_000
COLMAP_JITTER = 0.01
COLMAP_VALID = (True, False, True, False)
# The tongue cli run: tools.train with TONGUE_CFG on a generated scene with
# a 10% tongue (segmentations and red seeds), the cli phase's cameras,
# frames and points, TONGUE_CLI_ITERS iterations with one densify event
# (150) and its KNN refresh; then tools.render --tongue_renders on its
# model, each split cut to TONGUE_SERVE_FRAMES frames. The tongue terms pull
# the render away from the images at first (the scene's masks are the
# tongue-only alpha, which ignores what occludes the tongue): the train PSNR
# dips over the first ~100 iterations, so the run is as long as the cli
# phase's, and its windows are CLI_WINDOW long as there
TONGUE_FRAC = 0.1
TONGUE_CLI_ITERS = 300
TONGUE_CLI_SET = ["deform_from_iter=50", "densify_from_iter=100", "densify_until_iter=160",
                  "densification_interval=50", "radegs_regularization_from_iter=0",
                  "min_embeddings=4", "max_embeddings=8"]
TONGUE_SERVE_FRAMES = 8

# The families phase (5c): the upstream E-D3DGS paper's dataset families,
# each through one per-scene config at its full width and at the frame size
# its reader gives (data/readers.py: frames wider than 1600 shrink to 1600;
# HyperNeRF reads rgb/2x). (a) The step on FAM_N Gaussians in FAM_CAPACITY
# slots (the configs' max_number_gaussians of 200,000 rounded up to 1024 as
# CAPACITY is: an 18-bit rank, so K4's key takes 18 + 13 = 31 bits at
# 1600x1200; FAM_N leaves the densify 3,392 slots under the cap) spread over
# the frustum at log-scales about FAM_LOG_SCALE; the pair capacity sized by
# CapacityPolicy from one eager step; K1-K5b held to their plain versions
# (timed FAM_REPS times); the graphed step against eager over every key of
# the config's schedule, then a densify, both refreshes and FAM_MORE
# replays. (b) tools.train on a generated scene at the family's raw frame
# size (`raw`: N3V's 2704x2028, Technicolor's 2048x1088 from cam10 with the
# principal point FAM_PP off centre, HyperNeRF's rgb/2x 536x960), only
# schedule keys cut (FAM_CLI_SET: one densify event at 60), then (c)
# tools.render of the model, FAM_SERVE_FRAMES a split (DyNeRF's spiral video
# cameras too).
FAM_PP = 0.05
FAMILIES = (
    dict(name="dynerf", cfg=os.path.join("configs", "dynerf", "cook_spinach.py"),
         size=(1600, 1200), raw=(2704, 2028), pp=0.0, cam_start=0, video=True),
    dict(name="technicolor", cfg=os.path.join("configs", "technicolor", "Birthday.py"),
         size=(1600, 850), raw=(2048, 1088), pp=FAM_PP, cam_start=10, video=False),
    dict(name="hypernerf", cfg=os.path.join("configs", "hypernerf", "vrig-chicken.py"),
         size=(536, 960), raw=(536, 960), pp=0.0, cam_start=0, video=False),
)
FAM_N, FAM_CAPACITY = 196_608, 200_704
FAM_LOG_SCALE = -5.0
FAM_REPS = 10
FAM_MORE = 2
FAM_SWEEPS = 3               # sweeps over the keys, each after a capacity growth
FAM_CLI_CAMS, FAM_CLI_FRAMES, FAM_HYPER_FRAMES, FAM_CLI_POINTS = 5, 3, 16, 20_000
FAM_CLI_ITERS = 80
FAM_CLI_SET = ["deform_from_iter=20", "densify_from_iter=40", "densify_until_iter=70",
               "densification_interval=20", "radegs_regularization_from_iter=0"]
FAM_SERVE_FRAMES = 3

KERNELS = {
    "K1": dict(name="forward_blend", route="cuda",
               source="ed3dgs_torch/csrc/rasterize_forward.cu",
               replaces="ed3dgs_tpu/ops/rasterize_pallas.py:711"),
    "K4": dict(name="fused_bin_scans", route="cuda",
               source="ed3dgs_torch/csrc/binning_scan.cu",
               replaces="ed3dgs_tpu/ops/binning_scan.py:148"),
    "K5a": dict(name="unpack_image", route="cuda",
                source="ed3dgs_torch/csrc/relayout.cu",
                replaces="ed3dgs_tpu/ops/relayout.py:68"),
    "K2": dict(name="backward_blend", route="cuda",
               source="ed3dgs_torch/csrc/rasterize_backward.cu",
               replaces="ed3dgs_tpu/ops/rasterize_pallas.py:654"),
    "K3": dict(name="segment_sum_rows", route="cuda",
               source="ed3dgs_torch/csrc/segment_sum.cu",
               replaces="ed3dgs_tpu/ops/segment_sum.py:122"),
    "K5b": dict(name="pack_image", route="cuda",
                source="ed3dgs_torch/csrc/relayout.cu",
                replaces="ed3dgs_tpu/ops/relayout.py:83"),
    "K6": dict(name="knn_rows", route="cuda", source="ed3dgs_torch/csrc/knn_loss.cu",
               replaces="ed3dgs_tpu/ops/knn_loss.py:504"),
    "K7": dict(name="knn_reverse", route="cuda", source="ed3dgs_torch/csrc/knn_loss.cu",
               replaces="ed3dgs_tpu/ops/knn_loss.py:545"),
    "K8": dict(name="segment_sum_rows_packed", route="cuda",
               source="ed3dgs_torch/csrc/segment_sum.cu",
               replaces="ed3dgs_tpu/ops/segment_sum.py:228"),
    # no pallas_call: the counterpart of the jitted XLA function knn
    "X1": dict(name="knn", route="cuda", source="ed3dgs_torch/csrc/knn.cu",
               replaces="ed3dgs_tpu/ops/knn.py:39"),
    # no pallas_call: the counterpart of bin_rows' three jax.lax.cummax
    "X2": dict(name="boundary_deltas", route="cuda",
               source="ed3dgs_torch/csrc/binning_scan.cu",
               replaces="ed3dgs_tpu/ops/binning.py:153"),
}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bench_cloud(n: int, seed: int = 0) -> dict:
    """The bench scene's cloud (bench.py `_scene`) as raw model parameters,
    plus per-Gaussian embeddings and 3D-filter scales from a second seed."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.7, 0.7, n),
                      rng.uniform(1.2, 3.5, n)], 1)
    scales = np.exp(rng.normal(-4.5, 0.5, (n, 3)))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, n)
    shs = rng.normal(0, 0.3, (n, 16, 3)) * np.array([3.0] + [0.3] * 15)[None, :, None]
    extra = np.random.default_rng(seed + 1)
    fields = {
        "xyz": means, "features_dc": shs[:, :1], "features_rest": shs[:, 1:],
        "scaling": np.log(scales), "rotation": q,
        "opacity": np.log(opac / (1.0 - opac))[:, None],
        "embedding": extra.normal(0, 0.1, (n, 32)),
        # RaDe-GS 3D filter: sqrt(0.2) * depth / focal, about 1e-3 here
        "filter_3d": extra.uniform(5e-4, 1.5e-3, (n, 1)),
        "tongue_class": np.zeros((n, 1)),
    }
    return {k: np.asarray(v, np.float32) for k, v in fields.items()}


def x1_cloud(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """An X1 edge case's cloud, made by tests/torch_knn_clouds.py (loaded by
    path), so that the card tests and this run check the same clouds."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_knn_clouds", os.path.join(REPO, "tests", "torch_knn_clouds.py"))
    clouds = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(clouds)
    return clouds.knn_cloud(kind, n, seed)


def x1_big_cloud(torch, knn, seed: int = 5):
    """X1_BIG points uniform in the bench box (bench_cloud's means), the
    last 4 x 352 rows parked on the far shell, on the card."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.0, 1.0, X1_BIG), rng.uniform(-0.7, 0.7, X1_BIG),
                    rng.uniform(1.2, 3.5, X1_BIG)], 1).astype(np.float32)
    pts = torch.as_tensor(pts, device=DEVICE)
    dead = 4 * 352
    pts[-dead:] = knn.far_shell(X1_BIG, DEVICE)[-dead:]
    return pts


def x1_visits(torch, knn, pts, k: int) -> dict:
    """X1's tile skip on `pts` (one extra launch through `knn.tile_visits`):
    tiles scanned by a warp for its 32 queries (mean, max) and their share
    of all tiles, and the pairs evaluated for the live rows."""
    v = knn.tile_visits(pts, k).cpu().double()
    n = pts.shape[0]
    tiles = knn.layout()
    nt = -(-n // tiles["tile"])
    rows = torch.clamp(n - tiles["group"] * torch.arange(v.shape[0], dtype=torch.float64),
                       max=tiles["group"])
    return dict(tiles=nt, tiles_mean=float(v[:, 0].mean()), tiles_max=int(v[:, 0].max()),
                share_mean=float(v[:, 0].mean()) / nt, share_max=float(v[:, 0].max()) / nt,
                pairs=int((rows * v[:, 1]).sum()), pairs_share=float((rows * v[:, 1]).sum())
                / (n * n))


def x1_against_plain(torch, pts, k: int) -> tuple:
    """X1 (`knn` on the card) and `knn_plain` on the same points: (equal by
    torch.equal, distances and indices; largest |d2 difference| where the
    indices agree, else inf)."""
    from ed3dgs_torch.ops import knn
    d2, idx = knn.knn(pts, k=k)
    pd2, pidx = knn.knn_plain(pts, k=k)
    same_idx = torch.equal(idx, pidx)
    same = same_idx and torch.equal(d2.view(torch.int32), pd2.view(torch.int32))
    err = float((d2 - pd2).abs().max()) if same_idx else float("inf")
    return same, err


def caches_equal(torch, a, b) -> list:
    """The fields (path names) in which two KNN caches differ, tensor for
    tensor (dtype, shape and every bit)."""
    differ = []
    for gname in a._fields:
        ga, gb = getattr(a, gname), getattr(b, gname)
        for f in ga._fields:
            x, y = getattr(ga, f), getattr(gb, f)
            if isinstance(x, torch.Tensor):
                same = (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                        and x.shape == y.shape
                        and torch.equal(x.reshape(-1).view(torch.uint8),
                                        y.reshape(-1).view(torch.uint8)))
            else:
                same = x == y
            if not same:
                differ.append(f"{gname}.{f}")
    return differ


def bench_camera(width: int, height: int, eye=(0.0, 0.0, 0.0), **cam_kw):
    """The bench camera (50 degrees across, looking down +z at (0, 0, 2));
    `cam_kw` passes a principal point (cx_ratio, cy_ratio) to the Camera."""
    from ed3dgs_torch.data.cameras import look_at_camera
    fov = math.radians(50.0)
    return look_at_camera(eye, (0, 0, 2.0), (0, -1, 0), fov,
                          2 * math.atan(math.tan(fov / 2) * height / width),
                          width, height, **cam_kw).matrices()


def filter_cameras(torch, device, width=None, height=None, **cam_kw):
    """compute_3d_filter's camera arguments for FILTER_EYES (bench cameras
    of WIDTH x HEIGHT, or of the size and principal point given), and the
    scene extent those cameras give (1.1 x the largest distance of a centre
    from their mean, the reference's getNerfppNorm)."""
    cams = [bench_camera(width or WIDTH, height or HEIGHT, eye, **cam_kw)
            for eye in FILTER_EYES]
    f32 = dict(dtype=torch.float32, device=device)
    args = (torch.as_tensor(np.stack([c.world_view for c in cams]), **f32),
            torch.tensor([c.focal_x for c in cams], **f32),
            torch.tensor([c.focal_y for c in cams], **f32),
            torch.tensor([float(c.width) for c in cams], **f32),
            torch.tensor([float(c.height) for c in cams], **f32))
    centers = np.stack([c.campos for c in cams])
    extent = 1.1 * float(np.linalg.norm(centers - centers.mean(0), axis=1).max())
    return args, extent


def time_ms(torch, fn, iters: int, flush, spin: bool = True) -> float:
    """Mean device time of `fn` over `iters` launches, each after an L2
    flush (the main path finds these inputs cold). With `spin` (the kernels
    line's method) the card then spins for ~1 ms before the start event, so
    that the host has queued `fn` before the card reaches it and the events
    time the card's work alone; without it, a wrapper's host work between
    the start event and its launch is timed too wherever it outlasts the
    flush (see `host_us`)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush()
        if spin:
            torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def host_us(torch, fn, calls: int = 100) -> float:
    """Host microseconds per call of `fn` (a wrapper's checks, allocations
    and launches), with the card held busy by a ~0.1 s spin so that no call
    waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def recorder(seen, module, attr, key):
    """Wrap module.attr so that its last call's arguments land in seen[key];
    returns the function that restores it."""
    orig = getattr(module, attr)

    def rec(*args, **kwargs):
        seen[key] = (args, kwargs)
        return orig(*args, **kwargs)
    # a kernel wrapper counts its launches on the module-level name, which
    # now resolves to this stand-in
    rec.launches = getattr(orig, "launches", 0)
    setattr(module, attr, rec)
    return lambda: setattr(module, attr, orig)


# each counter's kernel wrapper, as ops/cuda_lib.py LAUNCH_SLOTS names it
WRAPPER_OF = {"K1": "rasterize_cuda.rasterize_forward", "K2": "rasterize_cuda.rasterize_backward",
              "K3": "segment_sum.segment_sum_rows", "K4": "binning_scan.fused_bin_scans",
              "K5a": "relayout.unpack_image", "K5b": "relayout.pack_image",
              "K6": "knn_loss.knn_rows", "K7": "knn_loss.knn_reverse",
              "K8": "segment_sum.segment_sum_rows_packed", "X1": "knn.knn",
              "X2": "binning_scan.boundary_deltas"}


def x2_as_k4(launches: dict, what: str):
    """X2 writes the delta streams K4 scans, once before each of K4's
    launches: fails unless `launches` counts them alike."""
    if launches["X2"] != launches["K4"]:
        fail(f"{what}: X2 launched {launches['X2']} times and K4 {launches['K4']}")


def card_launches(trace, keys) -> dict:
    """{K: launches that ran on the card} from a closed
    cuda_lib.DeviceLaunches window (a replayed graph calls no wrapper, so
    only the kernels' own counters see its launches); fails where no device
    had counters, since then nothing was measured, and, where K4 is among
    `keys`, unless X2 launched as often."""
    if not trace.armed:
        fail("no launch counters on the card: launches were not measured")
    if "K4" in keys:
        x2_as_k4({k: trace.counts[WRAPPER_OF[k]] for k in ("K4", "X2")},
                 f"the card's counters over {sorted(keys)}")
    return {k: trace.counts[WRAPPER_OF[k]] for k in keys}


def profile_window(torch, fn, out_path):
    """Profile one call of fn: (wall ms, device busy ms, top device items,
    stages). Device-side events only (kernels, copies); the record_function
    spans "ed3dgs.*" appear on the device as their extent and are reported
    by stage: kernel time inside / device extent / host ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_host = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t_host) * 1e6
    averages = prof.key_averages()
    items = sorted(((e.key, e.self_device_time_total, e.count) for e in averages
                    if e.device_type == DeviceType.CUDA and not e.key.startswith("ed3dgs.")
                    and e.self_device_time_total > 0), key=lambda x: -x[1])
    busy_us = sum(x[1] for x in items)
    with open(out_path, "w") as f:
        f.write(averages.table(sort_by="self_device_time_total", row_limit=60))
    stages = {}
    for e in averages:
        if e.key.startswith("ed3dgs."):
            st = stages.setdefault(e.key[len("ed3dgs."):], {})
            if e.device_type == DeviceType.CUDA:
                st["extent_ms"] = e.self_device_time_total / 1e3
            else:
                st.update(kernel_ms=e.device_time_total / 1e3, host_ms=e.cpu_time_total / 1e3)
    return wall_us / 1e3, busy_us / 1e3, items, stages


def print_profile(what, wall_ms, busy_ms, items, stages):
    idle = f"{1 - busy_ms / wall_ms:.3f}" if busy_ms else "not measured (no device time traced)"
    print(f"profiled {what}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {idle}); top device time:", flush=True)
    for name, us, n in items[:12]:
        print(f"  {us / 1e3:8.3f} ms  x{n:<4d} {name[:90]}")
    print("  by stage (kernel / device extent / host ms): " + ", ".join(
        f"{k} {v.get('kernel_ms', 0):.3f}/{v.get('extent_ms', 0):.3f}/{v.get('host_ms', 0):.3f}"
        for k, v in stages.items()), flush=True)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, stages=stages,
                top=[(k, us / 1e3, n) for k, us, n in items[:25]])


def train_setup(cfg, rcfg):
    """A config's TrainSetup, as ed3dgs_torch/tools/train.py builds it: the
    tongue terms and COLMAP supervision as the config sets them, the
    latter from the config's deform_from_iter."""
    from ed3dgs_torch.train.trainer import TrainSetup
    model, hidden, opt = cfg.model, cfg.hidden, cfg.opt
    return TrainSetup(
        raster=rcfg, hidden=hidden, batch_size=opt.batch_size,
        white_background=model.white_background, kernel_size=model.kernel_size,
        disable_filter3d=model.disable_filter3D, use_coord_map=model.use_coord_map,
        tongue_enabled=model.tongue_mask_loss_enabled,
        lambda_dssim=opt.lambda_dssim, opacity_l1_coef=opt.opacity_l1_coef_fine,
        reg_coef=opt.reg_coef, coef_tv_temporal=opt.coef_tv_temporal_embedding,
        lambda_depth_normal=opt.lambda_depth_normal,
        radegs_from_iter=opt.radegs_regularization_from_iter,
        num_down_emb=hidden.min_embeddings, sh_degree=model.sh_degree,
        colmap_supervision=model.colmap_supervision_enabled,
        deform_from_iter=hidden.deform_from_iter)


def per_step_launches(setup, keys) -> dict:
    """{K: launches one train step of `setup` makes}: one per camera of the
    blend path (K1-K5b) and with the tongue terms two more on the last
    camera (its tongue-only and tongue-free renders), X2 with K4; one KNN loss (K6,
    K7), two with the tongue graph; none of K8 (no production caller) and
    none of X1 (the search runs at a refresh, between steps)."""
    blend = setup.batch_size + (2 if setup.tongue_enabled else 0)
    knn = 2 if setup.tongue_enabled else 1
    return {k: (blend if k in ("K1", "K2", "K3", "K4", "K5a", "K5b", "X2") else
                knn if k in ("K6", "K7") else 0) for k in keys}


def make_batch(torch, cam, B, t, use_ssim, seed, device):
    """A batch of B views of `cam` at time t, with a numpy-seeded target."""
    rng = np.random.default_rng(seed)
    rep = lambda a: torch.as_tensor(np.repeat(np.asarray(a, np.float32)[None], B, 0),  # noqa: E731
                                    device=device)
    return {"gt_image": torch.as_tensor(
                rng.uniform(0, 1, (B, 3, cam.height, cam.width)).astype(np.float32),
                device=device),
            "viewmatrix": rep(cam.world_view), "projmatrix": rep(cam.full_proj),
            "campos": rep(cam.campos),
            "time": torch.full((B,), t, dtype=torch.float32, device=device),
            "cam_no": torch.zeros((B,), dtype=torch.int64, device=device),
            "use_ssim": use_ssim}


def cli_phase(torch, counters, bare_step_ms, tmp):
    """The `cli` phase, in the directory `tmp`: generate the scene on the card, train through
    `ed3dgs_torch.tools.train.main` (CLI_ITERS iterations, a checkpoint at
    CLI_CKPT, the model saved at the end, a test PSNR every
    CLI_TEST_EVERY), resume from the checkpoint for CLI_RESUME iterations,
    and reload the saved model and render it against the in-memory state.
    Returns the phase's numbers; fails the run on a kernel of K1-K7 that
    did not launch, a loss that is not finite, a last window whose train
    PSNR is not above the first's, a resumed state that is not the
    checkpoint it read, or a reloaded render that is not bit-identical.
    The scene and the model stay in `tmp` for the serve phase."""
    from ed3dgs_torch import convert
    from ed3dgs_torch.data.synthetic import generate_scene
    from ed3dgs_torch.ops import cuda_lib
    from ed3dgs_torch.ops.rasterize import RasterConfig
    from ed3dgs_torch.render import RenderSettings, render
    from ed3dgs_torch.tools import train as train_tool
    from ed3dgs_torch.train import trainer

    out = {}
    t_phase = time.perf_counter()
    scene_dir, model_dir = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
    t0 = time.perf_counter()
    generate_scene(scene_dir, n_cams=CLI_CAMS, n_frames=CLI_FRAMES, width=WIDTH,
                   height=HEIGHT, n_points=CLI_POINTS, seed=0, device=DEVICE)
    out["scene_s"] = time.perf_counter() - t0
    argv = ["-s", scene_dir, "-m", model_dir,
            "--configs", os.path.join(REPO, "configs", "nersemble", "default.py"),
            "--duration", str(CLI_FRAMES), "--test_every", str(CLI_TEST_EVERY),
            "--quiet", "--seed", "0", "--device", DEVICE]
    # the run's launches on the card from the device counters (the tool
    # replays graphs, which call no wrapper)
    keys = ("K1", "K2", "K3", "K4", "K5a", "K5b", "K6", "K7", "X1", "X2")
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with cuda_lib.DeviceLaunches() as trace:
        scene, state, aux, log = train_tool.main(
            argv + ["--iterations", str(CLI_ITERS), "--checkpoint_iterations",
                    str(CLI_CKPT), "--set", *CLI_SET])
    out["train_s"] = time.perf_counter() - t0
    launches = card_launches(trace, keys)
    wrapped = {k: counters[k].launches for k in keys}

    # resume from the checkpoint: the state it loads is the file's
    ckpt = os.path.join(model_dir, f"chkpnt{CLI_CKPT}.npz")
    loaded = {}
    orig_load = train_tool.load_checkpoint

    def load_and_keep(*a, **kw):
        res = orig_load(*a, **kw)
        loaded["flat"] = convert.checkpoint_arrays(res[0], res[1])
        loaded["next"] = res[2]
        return res
    train_tool.load_checkpoint = load_and_keep
    try:
        t0 = time.perf_counter()
        _, _, _, rlog = train_tool.main(
            [a.replace(model_dir, model_dir + "_resume") for a in argv]
            + ["--iterations", str(CLI_CKPT + CLI_RESUME), "--start_checkpoint", ckpt,
               "--no_tensorboard", "--set", *CLI_SET])
        out["resume_s"] = time.perf_counter() - t0
    finally:
        train_tool.load_checkpoint = orig_load
    with np.load(ckpt) as data:
        saved = {k: data[k] for k in data.files}
    resume_same = (loaded.get("next") == CLI_CKPT + 1 and set(saved) == set(loaded["flat"])
                   and all(np.array_equal(saved[k], loaded["flat"][k])
                           and saved[k].dtype == loaded["flat"][k].dtype for k in saved))

    # reload the saved model with the port's loader; render both
    cap = state.params["gaussians"].xyz.shape[0]
    cfg = train_tool.build_config(train_tool.parse_args(
        argv + ["--iterations", str(CLI_ITERS), "--set", *CLI_SET]))
    params2, aux2, deform2 = convert.load_model(model_dir, CLI_ITERS, capacity=cap,
                                                sh_degree=cfg.model.sh_degree, device=DEVICE)
    test_cam = scene.test_cameras[0]
    m = test_cam.matrices()
    rcfg = RasterConfig(width=m.width, height=m.height, focal_x=m.focal_x, focal_y=m.focal_y,
                        pair_capacity=PAIR_CAPACITY, chunk=cfg.opt.raster_chunk)
    f32 = dict(dtype=torch.float32, device=DEVICE)
    s = RenderSettings(torch.as_tensor(m.world_view, **f32),
                       torch.as_tensor(m.full_proj, **f32), torch.as_tensor(m.campos, **f32),
                       torch.tensor(0.5, **f32), torch.zeros((), dtype=torch.int64,
                                                               device=DEVICE))
    bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0, **f32)
    kw = dict(iteration=CLI_ITERS, sh_degree=cfg.model.sh_degree,
              kernel_size=cfg.model.kernel_size, disable_filter3d=cfg.model.disable_filter3D,
              num_down_emb_c=cfg.hidden.min_embeddings,
              num_down_emb_f=cfg.hidden.min_embeddings)
    with torch.no_grad():
        r_mem = render(state.params["gaussians"], aux, state.params["deform"], cfg.hidden, s,
                       rcfg, bg, **kw)
        r_disk = render(params2, aux2, deform2, cfg.hidden, s, rcfg, bg, **kw)
    reload_same = all(torch.equal(r_mem[k], r_disk[k])
                      for k in ("render", "mask", "expected_depth", "median_depth",
                                "expected_coord", "median_coord", "normal"))
    alive_same = int(aux2.alive.sum()) == int(aux.alive.sum())
    out["wall_s"] = time.perf_counter() - t_phase

    n = len(log["iter_ms"])
    first = slice(0, CLI_WINDOW)
    last = slice(n - CLI_WINDOW, n)
    mean = lambda xs: float(np.mean(xs))  # noqa: E731
    decode = log["decode_ms"] + rlog["decode_ms"]
    waits = log["wait_ms"]
    out.update(
        iterations=n, resumed_iterations=len(rlog["iter_ms"]),
        loop_s=float(np.sum(log["iter_ms"]) / 1e3),
        median_iter_ms=float(np.median(log["iter_ms"])),
        bare_step_ms=float(np.median(bare_step_ms)),
        read_wait_ms=float(np.median(log["read_wait_ms"])),
        decode_ms_per_frame=float(np.median(decode)) if decode else None,
        stager_wait_ms_per_iter=float(np.sum(waits) / n),
        loss_first=mean(log["loss"][first]), loss_last=mean(log["loss"][last]),
        psnr_first=mean(log["psnr"][first]), psnr_last=mean(log["psnr"][last]),
        test_psnr=[(int(i), float(v)) for i, v in log["test_psnr"]],
        points_start=log["points_start"], points_end=log["points_end"],
        densify_events=len(log["densify"]), densify=log["densify"],
        capacity_changes=len(log["capacity"]), capacity=log["capacity"],
        resume_loss_last=float(rlog["loss"][-1]) if rlog["loss"] else None,
        graph_captures=log["graph_captures"],
        resume_same=bool(resume_same), reload_render_identical=bool(reload_same),
        launches=launches, wrapper_counts=wrapped,
        scene_dir=scene_dir, model_dir=model_dir, argv=argv)
    print("cli: " + ", ".join(f"{k}={v}" for k, v in out.items()
                              if k not in ("densify", "argv")), flush=True)
    bad = [k for k, v in launches.items() if v == 0]
    if bad:
        fail(f"cli: kernels {bad} did not launch during the phase")
    # one KNN loss and B cameras' gradient kernels a step
    if not (launches["K6"] == launches["K7"] == n and launches["K2"] % n == 0
            and launches["K2"] == launches["K3"] == launches["K5b"]):
        fail(f"cli: {n} steps launched {launches} on the card (device counters)")
    # X1: the initial scales (create_from_points' 3-NN), the first KNN
    # refresh and one refresh a densify event
    if launches["X1"] != 2 + len(log["densify"]):
        fail(f"cli: X1 launched {launches['X1']} times, not once for the initial scales, the "
             f"first refresh and each of {len(log['densify'])} densify events")
    if not all(math.isfinite(x) for x in log["loss"] + rlog["loss"]):
        fail("cli: a loss is not finite")
    if not out["psnr_last"] > out["psnr_first"]:
        fail(f"cli: train PSNR did not rise ({out['psnr_first']:.3f} -> {out['psnr_last']:.3f})")
    if len(log["densify"]) < 2 or not log["test_psnr"]:
        fail("cli: the run needs two densify events and a test PSNR")
    if not resume_same:
        fail("cli: the resumed state differs from the checkpoint it read")
    if not (reload_same and alive_same):
        fail("cli: the reloaded model does not render bit-identically to the in-memory state")
    return out


def serve_phase(torch, counters, cli):
    """The `serve` phase on the `cli` phase's scene and model: the render,
    metrics, mesh-extraction and mesh-evaluation tools, then
    integrate_points on the card against the CPU. Returns the phase's
    numbers; fails the run on a launch count that differs from the frames,
    masks and integrations, a metrics PSNR off the cli phase's last test
    PSNR, an empty or non-finite mesh, or an integration that disagrees."""
    from ed3dgs_torch.convert import deform_from_flat
    from ed3dgs_torch.core.projection import project_gaussians
    from ed3dgs_torch.data.ply import read_mesh_ply
    from ed3dgs_torch.data.scene import Scene, read_deformation
    from ed3dgs_torch.mesh.extract import deformed_gaussians
    from ed3dgs_torch.mesh.tetra import get_tetra_points
    from ed3dgs_torch.ops import cuda_lib
    from ed3dgs_torch.ops.integrate import integrate_points
    from ed3dgs_torch.ops.rasterize import RasterConfig
    from ed3dgs_torch.render import RenderSettings, render
    from ed3dgs_torch.tools import evaluate_mesh, mesh_extract, metrics
    from ed3dgs_torch.train.losses import psnr
    from ed3dgs_torch.tools import render as render_tool
    from ed3dgs_torch.tools import train as train_tool

    scene_dir, model_dir = cli["scene_dir"], cli["model_dir"]
    config = os.path.join(REPO, "configs", "nersemble", "default.py")
    argv = ["-m", model_dir, "-s", scene_dir, "--configs", config,
            "--duration", str(CLI_FRAMES), "--iteration", str(CLI_ITERS), "--device", DEVICE]
    sets = ["--set", *CLI_SET]
    out = {}
    # the render tool for its times; then again inside the window whose
    # launches on the card the device counters count (the tool replays a
    # graph per frame, which calls no wrapper)
    t0 = time.perf_counter()
    stats = render_tool.main(argv + ["--max_frames", str(SERVE_FRAMES)] + sets)
    out["render_s"] = time.perf_counter() - t0
    frames = {k: v["frames"] for k, v in stats.items()}
    render_ms = [ms for v in stats.values() for ms in v["render_ms"]]
    save_ms = [ms for v in stats.values() for ms in v["save_ms"]]
    out.update(frames=frames, fps={k: v["fps"] for k, v in stats.items()},
               render_ms_median=float(np.median(render_ms)),
               save_ms_median=float(np.median(save_ms)))
    for fn in counters.values():
        fn.launches = 0
    trace = cuda_lib.DeviceLaunches().__enter__()
    stats = render_tool.main(argv + ["--max_frames", str(SERVE_FRAMES)] + sets)
    out["render_ms_median_counted"] = float(np.median(
        [ms for v in stats.values() for ms in v["render_ms"]]))
    if {k: v["frames"] for k, v in stats.items()} != frames:
        fail("serve: the traced render run rendered other frames")

    t0 = time.perf_counter()
    scores = metrics.main(["-m", model_dir, "--device", DEVICE])[model_dir]
    out["metrics_s"] = time.perf_counter() - t0
    entry = scores[f"ours_{CLI_ITERS}"]
    cli_psnr = cli["test_psnr"][-1][1]
    out.update(psnr=entry["PSNR"], ssim=entry["SSIM"], lpips_vgg=entry["LPIPS-vgg"],
               lpips_alex=entry["LPIPS-alex"], cli_test_psnr=cli_psnr)

    t0 = time.perf_counter()
    done = mesh_extract.main(argv + ["--start_timestep_index", "0",
                                     "--end_timestep_index", "1"] + sets)
    out["mesh_extract_s"] = time.perf_counter() - t0
    n_verts, n_faces, mstats = done[0]
    masks = mstats["views"] * mstats["sdf_evaluations"]
    out.update(tetra_points=mstats["tetra_points"], tets=mstats["tets"],
               delaunay_s=mstats["delaunay_s"], sdf_s=mstats["sdf_s"],
               extract_s=mstats["total_s"], vertices=n_verts, faces=n_faces,
               sdf_evaluations=mstats["sdf_evaluations"], masks=masks)
    trace.__exit__(None, None, None)
    launches = card_launches(trace, ("K1", "K4", "K5a", "X1", "X2"))
    n_frames = sum(frames.values())
    # X1 once: the tetra points' outlier filter at the one timestep
    expected = {"K1": n_frames + masks, "K4": n_frames + 2 * masks, "K5a": n_frames + masks,
                "X1": 1, "X2": n_frames + 2 * masks}
    out.update(launches=launches, expected_launches=expected,
               wrapper_counts={k: counters[k].launches
                               for k in ("K1", "K4", "K5a", "X1", "X2")})

    verts, faces = read_mesh_ply(os.path.join(model_dir, "meshes", "00000", "recon.ply"))
    gt_dir = os.path.join(os.path.dirname(model_dir), "gt")
    os.makedirs(gt_dir, exist_ok=True)
    os.link(os.path.join(scene_dir, "points3D_downsample.ply"),
            os.path.join(gt_dir, "00000.ply"))
    t0 = time.perf_counter()
    evaluation = evaluate_mesh.main(["-m", model_dir, "--gt_dir", gt_dir, "--device", DEVICE])
    out["evaluate_s"] = time.perf_counter() - t0
    out.update(mesh_distance_mm=evaluation["00000"]["mean_distance_mm"],
               normal_similarity=evaluation["00000"]["normal_similarity"])

    # the float PSNR of the same test frames: render() with the tool's
    # arguments on the card, scored before any quantisation
    cfg = train_tool.build_config(train_tool.parse_args(
        cli["argv"] + ["--iterations", str(CLI_ITERS), "--set", *CLI_SET]))
    scene = Scene(cfg.model, cfg.hidden, capacity=cfg.opt.max_number_gaussians,
                  duration=CLI_FRAMES, load_iteration=CLI_ITERS, shuffle=False, device=DEVICE)
    params, aux = scene.params, scene.aux
    dparams = deform_from_flat(read_deformation(os.path.join(
        model_dir, "point_cloud", f"iteration_{CLI_ITERS}")), device=DEVICE)
    f32 = dict(dtype=torch.float32, device=DEVICE)
    bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0, **f32)
    test_cams = sorted(scene.test_cameras, key=lambda c: (c.cam_no, c.frame_no))[:SERVE_FRAMES]
    m = test_cams[0].matrices()
    rcfg = RasterConfig(width=m.width, height=m.height, focal_x=m.focal_x, focal_y=m.focal_y,
                        pair_capacity=cfg.opt.pair_capacity, chunk=cfg.opt.raster_chunk)
    psnrs = []
    for cam in test_cams:
        m = cam.matrices()
        s_ = RenderSettings(torch.as_tensor(m.world_view, **f32),
                            torch.as_tensor(m.full_proj, **f32), torch.as_tensor(m.campos, **f32),
                            torch.tensor(cam.time, **f32), None)
        with torch.no_grad():
            img = render(params, aux, dparams, cfg.hidden, s_, rcfg, bg, iteration=10 ** 9,
                         sh_degree=cfg.model.sh_degree, kernel_size=cfg.model.kernel_size,
                         disable_filter3d=cfg.model.disable_filter3D,
                         num_down_emb_c=cfg.hidden.min_embeddings,
                         num_down_emb_f=cfg.hidden.min_embeddings)["render"]
        gt = torch.as_tensor(cam.image, **f32)
        cam.release_image()
        psnrs.append(float(psnr(img[None], gt[None])[0]))
    float_psnr = float(np.mean(psnrs))
    out["float_test_psnr"] = float_psnr

    # integrate_points on the card and on the CPU: the tetra points of
    # INTEGRATE_N of the model's Gaussians, deformed at t = 0 on the card
    with torch.no_grad():
        xyz, scales_f, rot_raw, opac_f, shs_f = deformed_gaussians(
            params, aux, dparams, cfg.hidden, 0.0, cfg.hidden.min_embeddings, CLI_ITERS)
    keep = torch.nonzero(aux.alive)[:INTEGRATE_N, 0]
    cut = [t[keep] for t in (xyz, scales_f, rot_raw, opac_f, shs_f)]
    pts, _ = get_tetra_points(*(t.cpu().numpy() for t in (cut[0], cut[2], cut[1])),
                              device=DEVICE)
    m = sorted(scene.train_cameras, key=lambda c: (c.cam_no, c.frame_no))[0].matrices()
    got = {}
    for dev in (DEVICE, "cpu"):
        xyz_d, sc_d, rot_d, op_d, sh_d = (t.to(dev) for t in cut)
        rot_sq = torch.sum(rot_d * rot_d, dim=-1, keepdim=True)
        rot_act = rot_d / torch.sqrt(torch.where(rot_sq < 1e-24, torch.ones_like(rot_sq), rot_sq))
        f32 = dict(dtype=torch.float32, device=dev)
        with torch.no_grad():
            proj = project_gaussians(
                xyz_d, sc_d, rot_act, op_d[:, 0], sh_d,
                viewmatrix=torch.as_tensor(m.world_view, **f32),
                projmatrix=torch.as_tensor(m.full_proj, **f32),
                campos=torch.as_tensor(m.campos, **f32), width=m.width, height=m.height,
                tan_fovx=m.tan_fovx, tan_fovy=m.tan_fovy, focal_x=m.focal_x,
                focal_y=m.focal_y, kernel_size=cfg.model.kernel_size,
                sh_degree=cfg.model.sh_degree, compute_invraycov=True)
            t0 = time.perf_counter()
            got[dev] = integrate_points(
                proj, torch.as_tensor(pts, **f32),
                viewmatrix=torch.as_tensor(m.world_view, **f32), width=m.width,
                height=m.height, focal_x=m.focal_x, focal_y=m.focal_y,
                pair_capacity=cfg.opt.pair_capacity)
            if dev == DEVICE:
                torch.cuda.synchronize()
            out[f"integrate_{'card' if dev == DEVICE else 'cpu'}_s"] = time.perf_counter() - t0
    diffs = {k: float((getattr(got[DEVICE], k).cpu().float()
                       - getattr(got["cpu"], k).float()).abs().max())
             for k in got["cpu"]._fields}
    beyond = {k: int(((getattr(got[DEVICE], k).cpu().float()
                       - getattr(got["cpu"], k).float()).abs() > INTEGRATE_TOL).sum())
              for k in got["cpu"]._fields}
    out.update(integrate_points=len(pts), integrate_valid=int(got["cpu"].point_valid.sum()),
               integrate_max_diff=diffs, integrate_beyond_tol=beyond)
    print("serve: " + ", ".join(f"{k}={v}" for k, v in out.items()), flush=True)

    if launches != expected:
        fail(f"serve: launches {launches} differ from the frames and masks rendered {expected}")
    if not abs(entry["PSNR"] - float_psnr) <= SERVE_PSNR_TOL:
        fail(f"serve: metrics PSNR {entry['PSNR']:.3f} is more than {SERVE_PSNR_TOL} dB from "
             f"the float PSNR of the same frames, {float_psnr:.3f}")
    if n_verts == 0 or n_faces == 0 or len(verts) != n_verts or not np.all(np.isfinite(verts)):
        fail("serve: the mesh is empty or has a vertex that is not finite")
    if max(diffs.values()) > INTEGRATE_TOL:
        fail(f"serve: integrate_points on the card differs from the CPU's: {diffs}")
    return out


def gl_request(world_view, full_proj, w, h, fovx, fovy) -> dict:
    """The SIBR viewer's request for a camera: the matrices transposed to
    its column-major GL layout, view columns 1-2 and projection column 1
    negated (render/network_gui.py undoes both)."""
    view = np.asarray(world_view, np.float32).T.copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    proj = np.asarray(full_proj, np.float32).T.copy()
    proj[:, 1] *= -1
    return {"resolution_x": w, "resolution_y": h, "fov_x": fovx, "fov_y": fovy,
            "z_near": 0.01, "z_far": 100.0, "train": False, "keep_alive": True,
            "scaling_modifier": 1.0, "view_matrix": [float(x) for x in view.reshape(-1)],
            "view_projection_matrix": [float(x) for x in proj.reshape(-1)]}


def write_raw_capture(root, scene_dir):
    """A raw NerSemble capture in `root`: calibration, 2 cameras x 2
    timesteps of PREP_W x PREP_H PNG frames (the scene's first images),
    alpha maps and facer colour masks, written by the port's codec."""
    from ed3dgs_torch.data.image_io import read_png, resize_bilinear, write_png

    rng = np.random.default_rng(0)
    cams = ("220700191", "222200037")
    w2c = {}
    for i, c in enumerate(cams):
        m = np.eye(4)
        m[:3, 3] = [0.1 * i, 0.0, 1.0]
        w2c[c] = m.tolist()
    os.makedirs(os.path.join(root, "calibration"))
    with open(os.path.join(root, "calibration", "camera_params.json"), "w") as f:
        json.dump({"intrinsics": [[2000.0, 0, 275], [0, 2000.0, 401], [0, 0, 1]],
                   "world_2_cam": w2c}, f)
    frames = sorted(os.path.join(d, n) for d, _, ns in os.walk(scene_dir) for n in ns
                    if n.endswith(".png"))[:4]
    for ti, ts in enumerate(("frame_00000", "frame_00001")):
        base = os.path.join(root, "sequences", "EXP-1", "timesteps", ts)
        for sub in ("images-2x", "alpha_map", "facer_segmentation_masks"):
            os.makedirs(os.path.join(base, sub))
        for ci, c in enumerate(cams):
            img = resize_bilinear(read_png(frames[(2 * ti + ci) % len(frames)])[..., :3],
                                  PREP_W, PREP_H)
            write_png(os.path.join(base, "images-2x", f"cam_{c}.png"), img)
            a = np.zeros((PREP_H, PREP_W), np.uint8)
            a[PREP_H // 8:PREP_H * 7 // 8, PREP_W // 8:PREP_W * 7 // 8] = 255
            write_png(os.path.join(base, "alpha_map", f"cam_{c}.png"), a)
            seg = np.zeros((PREP_H, PREP_W, 3), np.uint8)
            seg[PREP_H * 5 // 8:PREP_H * 11 // 16, PREP_W * 3 // 8:PREP_W // 2] = (168, 91, 73)
            seg[rng.integers(0, PREP_H, 50), rng.integers(0, PREP_W, 50)] = (30, 60, 90)
            write_png(os.path.join(base, "facer_segmentation_masks",
                                   f"color_segmentation_cam_{c}.png"), seg)
    return cams


def offline_phase(torch, counters, cli):
    """The `offline` phase on the `cli` phase's scene and model: TSDF mesh
    extraction (sparse at the default voxel, dense at OFFLINE_DENSE_VOXEL),
    each fused again on the CPU from the same masked depths and compared;
    the Gaussian-ellipsoid meshes of timesteps 0-1; the mesh-video
    splatter on the serve phase's recon.ply and on recon_tsdf.ply, card
    against CPU; the viewer server answering a loopback client, each reply
    against `render()`; and the data preparation tools on a raw capture
    written here. Returns the phase's numbers; fails the run on a launch
    count that differs from the views and requests rendered, or on any
    comparison past its bound."""
    import argparse
    import contextlib
    import functools
    import io
    import sqlite3
    import threading
    import socket

    from ed3dgs_torch.data.image_io import read_png
    from ed3dgs_torch.data.ply import fetch_point_cloud, read_ply
    from ed3dgs_torch.mesh import tsdf
    from ed3dgs_torch.mesh.tsdf_sparse import fuse_volume_sparse
    from ed3dgs_torch.ops import cuda_lib
    from ed3dgs_torch.ops.rasterize import RasterConfig
    from ed3dgs_torch.render.network_gui import ViewerServer
    from ed3dgs_torch.tools import (FrameRenderer, add_model_flags, gaussians_to_mesh,
                                    load_trained, mesh_extract_tsdf, mesh_video,
                                    nersemble_utils, prepare_colmap, prepare_data, viewer)

    t_phase = time.perf_counter()
    scene_dir, model_dir = cli["scene_dir"], cli["model_dir"]
    tmp = os.path.dirname(model_dir)
    config = os.path.join(REPO, "configs", "nersemble", "default.py")

    def argv(dev, *extra):
        return (["-m", model_dir, "-s", scene_dir, "--configs", config, "--duration",
                 str(CLI_FRAMES), "--iteration", str(CLI_ITERS), "--device", dev]
                + list(extra) + ["--set", *CLI_SET])
    sync = torch.cuda.synchronize
    out, bad = {}, []
    for fn in counters.values():
        fn.launches = 0

    # ---- TSDF: the tool on the card, its views rendered through
    # FrameRenderer's graph (sparse); then again with the views rendered
    # eagerly, render() op by op as the tool did before (dense): the same
    # views' masked depths and colours must be equal bit for bit. Then the
    # same inputs fused on the CPU
    t0 = time.perf_counter()
    sp = mesh_extract_tsdf.main(argv(DEVICE, "--engine", "sparse"))
    out["tsdf_s"] = time.perf_counter() - t0
    sync()
    graphed_counts = {k: counters[k].launches for k in ("K1", "K4", "K5a", "X2")}
    for fn in counters.values():
        fn.launches = 0
    mesh_extract_tsdf.FrameRenderer = functools.partial(FrameRenderer, graph=False)
    try:
        dn = mesh_extract_tsdf.main(argv(DEVICE, "--engine", "dense", "--voxel_size",
                                         str(OFFLINE_DENSE_VOXEL)))
    finally:
        mesh_extract_tsdf.FrameRenderer = FrameRenderer
    sync()
    eager_counts = {k: counters[k].launches for k in ("K1", "K4", "K5a", "X2")}
    # the graphed run's wrappers count its key's first, eager run (a replay
    # calls none): the replays' own work shows in the views it returns
    views_equal = (sp["views"] == dn["views"] and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for xs, ys in zip(sp["inputs"][:2], dn["inputs"][:2]) for a, b in zip(xs, ys)))
    print(f"offline: TSDF on the card: sparse {sp['blocks']} blocks, {sp['faces']} faces, "
          f"fuse {sp['fuse_s']:.2f} s, extract {sp['extract_s']:.2f} s; dense "
          f"{dn['voxels']} voxels, {dn['faces']} faces; render ms a view graphed "
          f"{[round(x, 3) for x in sp['render_ms']]} (the first captures), eager "
          f"{[round(x, 3) for x in dn['render_ms']]}; graphed views' masked depths and colours "
          f"equal to the eager ones bit for bit={views_equal}; wrapper counts graphed "
          f"{graphed_counts}, eager {eager_counts}", flush=True)
    if not views_equal:
        bad.append("TSDF: the graphed views' depths or colours differ from the eager ones")
    if graphed_counts != {k: 1 for k in graphed_counts} or \
            eager_counts != {k: dn["views"] for k in eager_counts}:
        bad.append(f"TSDF launches: graphed run {graphed_counts} (want 1 each: the capture's "
                   f"eager run), eager run {eager_counts} ({dn['views']} views)")

    def to_cpu(inputs):
        depths, colors, wvs, focals = inputs
        return [d.cpu() for d in depths], [c.cpu() for c in colors], wvs, focals

    cpu_in = to_cpu(sp["inputs"])
    vol = sp["volume"]
    t0 = time.perf_counter()
    cvol = fuse_volume_sparse(*cpu_in, voxel_size=vol.voxel_size)
    cpu_fuse_s = time.perf_counter() - t0
    cmesh = cvol.extract_surface()
    same_blocks = torch.equal(vol.block_keys.cpu(), cvol.block_keys)
    moved, max_diff = -1, float("inf")
    if same_blocks:
        # each (voxel, view) projection on both devices: a voxel that one
        # device projects to another pixel (or another validity) is left out
        # of the field comparison and counted
        trunc = 8.0 * vol.voxel_size
        pts = {"card": vol.voxel_coords().double() * vol.voxel_size,
               "cpu": cvol.voxel_coords().double() * cvol.voxel_size}
        agree = torch.ones(pts["cpu"].shape[0], dtype=torch.bool)
        for d, wv, (fx, fy) in zip(cpu_in[0], cpu_in[2], cpu_in[3]):
            a = tsdf.project_voxels(pts["card"], d.to(DEVICE), wv, fx, fy, 8.0, trunc)
            b = tsdf.project_voxels(pts["cpu"], d, wv, fx, fy, 8.0, trunc)
            differ = (a[0].cpu() != b[0]) | (a[2].cpu() != b[2]) | (a[3].cpu() != b[3])
            agree &= ~differ
            moved = max(moved, 0) + int(differ.sum())
        max_diff = max(float((getattr(vol, k).cpu().reshape(agree.shape[0], -1)[agree]
                              - getattr(cvol, k).reshape(agree.shape[0], -1)[agree])
                             .abs().max()) for k in ("tsdf", "weight", "color"))
    sparse_faces_equal = bool(np.array_equal(sp["mesh"][1], cmesh[1]))
    print(f"offline: TSDF on the CPU: fuse {cpu_fuse_s:.2f} s, compared in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    projections = len(cpu_in[0]) * vol.n_blocks * vol.block ** 3
    dcpu = to_cpu(dn["inputs"])
    dvol = tsdf.fuse_volume(*dcpu, voxel_size=OFFLINE_DENSE_VOXEL)
    df = tsdf.extract_surface(dvol)[1]
    dense_diff = (max(float((getattr(dn["volume"], k).cpu() - getattr(dvol, k)).abs().max())
                      for k in ("tsdf", "weight", "color"))
                  if dvol.dims == dn["volume"].dims else float("inf"))
    dense_faces_equal = bool(np.array_equal(dn["mesh"][1], df))
    out["tsdf"] = dict(
        views=sp["views"], render_ms_per_view=float(np.median(sp["render_ms"])),
        eager_render_ms_per_view=float(np.median(dn["render_ms"])),
        render_ms=sp["render_ms"], eager_render_ms=dn["render_ms"],
        graphed_equals_eager=bool(views_equal),
        fuse_s=sp["fuse_s"], extract_s=sp["extract_s"], cpu_fuse_s=cpu_fuse_s,
        blocks=sp["blocks"], voxels=sp["voxels"], vertices=sp["vertices"], faces=sp["faces"],
        same_blocks=bool(same_blocks), moved_projections=moved, projections=projections,
        field_max_diff=max_diff, faces_equal=sparse_faces_equal,
        dense=dict(voxel_size=OFFLINE_DENSE_VOXEL, voxels=dn["voxels"],
                   vertices=dn["vertices"], faces=dn["faces"], fuse_s=dn["fuse_s"],
                   extract_s=dn["extract_s"], field_max_diff=dense_diff,
                   faces_equal=dense_faces_equal),
        wrapper_counts=dict(graphed=graphed_counts, eager=eager_counts))
    if not same_blocks:
        bad.append("TSDF: the card's blocks differ from the CPU's (keys or row order)")
    elif moved > TSDF_MAX_MOVED * projections:
        bad.append(f"TSDF: {moved} of {projections} voxel projections on another pixel")
    if max_diff > TSDF_FIELD_TOL or dense_diff > TSDF_FIELD_TOL:
        bad.append(f"TSDF fields differ: sparse {max_diff:.3g}, dense {dense_diff:.3g}")
    if (moved == 0 and not sparse_faces_equal) or not dense_faces_equal:
        bad.append("TSDF: the card's faces differ from the CPU's")
    if sp["faces"] == 0 or dn["faces"] == 0:
        bad.append("TSDF: an empty mesh")

    # ---- Gaussian-ellipsoid meshes: the tool as configured (bf16), then
    # card against CPU at float32 activations
    gdir = os.path.join(model_dir, "gaussian_meshes")
    t0 = time.perf_counter()
    g = gaussians_to_mesh.main(argv(DEVICE, "--end_timestep_index", "2"))
    g_s = time.perf_counter() - t0
    f32 = ["bf16_activations=false"]
    verts = {}
    for dev in (DEVICE, "cpu"):
        gaussians_to_mesh.main(argv(dev, "--end_timestep_index", "2") + f32)
        verts[dev] = [np.stack([read_ply(os.path.join(gdir, f"{ts:05d}.ply"))["vertex"][k]
                                for k in "xyz"], 1) for ts in (0, 1)]
    same_counts = all(len(a) == len(b) for a, b in zip(verts[DEVICE], verts["cpu"]))
    g_diff = (max(float(np.abs(a - b).max()) for a, b in zip(verts[DEVICE], verts["cpu"]))
              if same_counts else float("inf"))
    out["gaussians_mesh"] = dict(vertices=[g[0][0], g[1][0]], s=[g[0][1], g[1][1]],
                                 wall_s=g_s, f32_vertex_max_diff=g_diff)
    if g_diff > GAUSS_MESH_TOL or g[0][0] == 0:
        bad.append(f"Gaussian meshes: the card's vertices differ from the CPU's by {g_diff:.3g}")

    # ---- the mesh-video splatter, card against CPU
    frames, differing, pixels, lit, card_ms, cpu_ms = 0, 0, 0, 0, [], []
    for ply in (os.path.join(model_dir, "meshes", "00000", "recon.ply"), sp["path"]):
        pts, cn, is_normals = mesh_video._load_colored_points(ply)
        for eye in SPLAT_EYES:
            view = (eye, SPLAT_TARGET, SPLAT_UP, SPLAT_ZOOM)
            sync()
            t0 = time.perf_counter()
            a = mesh_video.render_points(pts, cn, *view, shaded=is_normals, device=DEVICE)
            card_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            b = mesh_video.render_points(pts, cn, *view, shaded=is_normals, device="cpu")
            cpu_ms.append((time.perf_counter() - t0) * 1e3)
            frames += 1
            pixels += a.shape[1] * a.shape[2]
            differing += int((np.abs(a - b) > SPLAT_TOL).any(0).sum())
            lit += int((a > 0).any(0).sum())
    out["mesh_video"] = dict(frames=frames, pixels=pixels, lit_pixels=lit,
                             differing_pixels=differing,
                             card_ms_per_frame=float(np.median(card_ms)),
                             cpu_ms_per_frame=float(np.median(cpu_ms)))
    if differing > SPLAT_MAX_DIFFERING * pixels or lit == 0:
        bad.append(f"mesh video: {differing} of {pixels} pixels differ ({lit} lit)")

    # ---- the viewer: a loopback client, replies against render()
    p = argparse.ArgumentParser()
    add_model_flags(p)
    args = p.parse_args(argv(DEVICE))
    cfg, scene, dparams = load_trained(args, torch.device(DEVICE))
    cam = sorted(scene.train_cameras, key=lambda c: (c.cam_no, c.frame_no))[0]
    m = cam.matrices()
    msgs = [gl_request(m.world_view, m.full_proj, w, h, cam.fovx, cam.fovy)
            for w, h in VIEWER_SIZES] + [gl_request(m.world_view, m.full_proj, 0, 0, 1.0, 1.0)]
    handle = viewer.make_handler(cfg, scene, dparams, 0.0)
    server = ViewerServer("127.0.0.1", 0)
    port = server.listener.getsockname()[1]
    for fn in counters.values():
        fn.launches = 0
    # the requests' launches on the card from the device counters: the
    # handler replays a graph per size, which calls no wrapper
    trace = cuda_lib.DeviceLaunches().__enter__()
    thread = threading.Thread(target=server.serve_forever, args=(handle,),
                              kwargs={"verify": "offline", "max_requests": len(msgs)},
                              daemon=True)
    thread.start()
    replies, request_ms = [], []
    try:
        client = socket.create_connection(("127.0.0.1", port), timeout=120)

        def recv(n):
            buf = b""
            while len(buf) < n:
                chunk = client.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("the viewer server closed the connection")
                buf += chunk
            return buf
        for msg in msgs:
            payload = json.dumps(msg).encode()
            t0 = time.perf_counter()
            client.sendall(len(payload).to_bytes(4, "little") + payload)
            img = recv(msg["resolution_x"] * msg["resolution_y"] * 3)
            verify = recv(int.from_bytes(recv(4), "little"))
            request_ms.append((time.perf_counter() - t0) * 1e3)
            replies.append((img, verify))
        client.close()
    finally:
        thread.join(timeout=120)
        server.close()
        trace.__exit__(None, None, None)
    viewer_launches = card_launches(trace, ("K1", "K4", "K5a", "X2"))
    rendered = len(VIEWER_SIZES)
    if viewer_launches != {k: rendered for k in viewer_launches}:
        bad.append(f"viewer launches {viewer_launches}, {rendered} requests rendered")
    eager = FrameRenderer(cfg.hidden, torch.ones(3, dtype=torch.float32, device=DEVICE),
                          sh_degree=cfg.model.sh_degree, kernel_size=cfg.model.kernel_size,
                          disable_filter3d=cfg.model.disable_filter3D,
                          num_down_emb=cfg.hidden.min_embeddings, graph=False)
    equal = []
    for (w, h), (img, verify) in zip(VIEWER_SIZES, replies):
        rcfg = RasterConfig(width=w, height=h, focal_x=w / (2 * np.tan(cam.fovx / 2)),
                            focal_y=h / (2 * np.tan(cam.fovy / 2)),
                            pair_capacity=cfg.opt.pair_capacity, chunk=cfg.opt.raster_chunk)
        want = eager("check", (scene.params, scene.aux, dparams), rcfg, m.world_view,
                     m.full_proj, np.linalg.inv(m.world_view)[:3, 3], 0.0)["render"]
        want = (torch.clamp(want, 0, 1).permute(1, 2, 0) * 255).to(torch.uint8)
        equal.append(img == want.cpu().numpy().tobytes() and verify == b"offline")
    empty_ok = len(replies) == len(msgs) and replies[-1] == (b"", b"offline")
    out["viewer"] = dict(requests=len(replies), sizes=VIEWER_SIZES,
                         ms_per_request=[float(x) for x in request_ms],
                         replies_equal=equal, empty_reply_ok=empty_ok,
                         launches=viewer_launches)
    if not (all(equal) and len(equal) == rendered and empty_ok):
        bad.append(f"viewer: replies equal to render() {equal}, empty request ok {empty_ok}")

    # ---- data preparation on a raw capture written here (host)
    raw, prep = os.path.join(tmp, "raw"), os.path.join(tmp, "prep")
    t0 = time.perf_counter()
    cams = write_raw_capture(raw, scene_dir)
    prep_in_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        prepare_data.main(["nersemble", raw, "EXP-1", prep, "--alpha_mask",
                           "--width", str(PREP_W), "--height", str(PREP_H)])
        cloud = os.path.join(prep, "points3D_downsample.ply")
        prepare_data.main(["downsample", os.path.join(scene_dir, "points3D_downsample.ply"),
                           cloud, "--max_points", "5000"])
        n_down = len(fetch_point_cloud(cloud)[0])
        prepare_data.main(["add-tongue-points", cloud, "--num_points", "500"])
        colmap = prepare_colmap.convert_poses_to_colmap_db(prep)
        nersemble_utils.main(["pose-bounds", prep])
        seg = os.path.join(raw, "sequences", "EXP-1", "timesteps", "frame_00000",
                           "facer_segmentation_masks", f"color_segmentation_cam_{cams[0]}.png")
        nersemble_utils.main(["seg-color", seg])
        nersemble_utils.main(["render-mesh", sp["path"], os.path.join(prep, "views"),
                              "--device", DEVICE])
    prep_s = time.perf_counter() - t0
    pngs = sorted(os.path.join(d, n) for d, _, ns in os.walk(prep) for n in ns
                  if n.endswith(".png"))
    decoded = [read_png(f).shape for f in pngs]
    con = sqlite3.connect(os.path.join(prep, "colmap", "input.db"))
    rows = {t: con.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
            for t in ("cameras", "images")}
    con.close()
    n_cloud = len(fetch_point_cloud(cloud)[0])
    printed = said.getvalue()
    out["prep"] = dict(host_s=prep_s, capture_write_s=prep_in_s, pngs=len(pngs),
                       db_rows=rows, colmap_images=len(colmap), cloud_points=n_cloud,
                       poses_bounds=list(np.load(os.path.join(prep, "poses_bounds.npy")).shape))
    want_pngs = 3 * 2 * len(cams) + 3          # images, masks, segmentations; 3 views
    if (len(pngs) != want_pngs or any(len(sh) < 2 for sh in decoded)
            or rows != {"cameras": 2, "images": 2} or not n_down <= 5000
            or n_cloud != n_down + 500
            or "Camera: 1" not in printed or "[168, 91, 73]" not in printed):
        bad.append(f"prep: {len(pngs)} PNGs (want {want_pngs}), rows {rows}, "
                   f"cloud {n_cloud} points")

    out["wall_s"] = time.perf_counter() - t_phase
    print("offline: " + json.dumps(out), flush=True)
    if bad:
        fail("offline: " + "; ".join(bad))
    return out


def multi_batches(torch, cam, cam2, device):
    """(b)'s batches of one view and (c)'s of two, numpy-seeded targets; SSIM
    on the first step of each."""
    one = [make_batch(torch, cam, 1, 0.2 + 0.1 * i, i == 0, 700 + i, device)
           for i in range(MULTI_STEPS)]
    two = []
    for i in range(MULTI_STEPS):
        a = make_batch(torch, cam, 1, 0.25 + 0.1 * i, i == 0, 800 + i, device)
        b = make_batch(torch, cam2, 1, 0.3 + 0.1 * i, i == 0, 900 + i, device)
        two.append({k: a[k] if k == "use_ssim" else torch.cat([a[k], b[k]]) for k in a})
    return one, two


def multi_numbers(torch, state, aux, metrics) -> dict:
    """The state after the first step (xyz, the temporal table, denom) and
    every step's loss and PSNR."""
    return {"xyz": state.params["gaussians"].xyz.detach().cpu().numpy(),
            "weight": state.params["deform"]["weight"].detach().cpu().numpy(),
            "denom": aux.denom.cpu().numpy(),
            "loss": [float(m["loss"]) for m in metrics],
            "psnr": [float(m["psnr"]) for m in metrics]}


def multi_rank(rank, world, path):
    """One rank of the multi phase's world (every rank on cuda:0): (a) the
    strip render of one frame and the single-process render of it; (b) the
    strip-exchange steps at data=1 x gauss=2; (c) the gspmd steps at data=2
    x gauss=1. Returns, per sub-phase, its kernel launches (every count set
    to 0 just before it), its collectives by kind, its host ms a step (on
    the shared card) and its numbers."""
    import torch

    sys.path.insert(0, REPO)
    from dataclasses import replace

    from ed3dgs_torch.ops import binning_scan, knn_loss, rasterize_cuda, relayout, segment_sum
    from ed3dgs_torch.parallel import comm
    from ed3dgs_torch.parallel.mesh import Mesh
    from ed3dgs_torch.parallel.sharded import (gather_train_state, make_sharded_train_step,
                                               shard_batch, shard_train_state)
    from ed3dgs_torch.render import render, settings_from_camera
    from ed3dgs_torch.train.optim import build_optimizer

    blob = torch.load(path, map_location="cpu", weights_only=False)
    device, (width, height) = blob["device"], blob["size"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    blob = torch.load(path, map_location=device, weights_only=False)
    state, aux, cache, setup = blob["state"], blob["aux"], blob["cache"], blob["setup"]
    optimizer = build_optimizer(blob["opt"], blob["extent"])
    counters = {"K1": rasterize_cuda.rasterize_forward, "K2": rasterize_cuda.rasterize_backward,
                "K3": segment_sum.segment_sum_rows, "K4": binning_scan.fused_bin_scans,
                "K5a": relayout.unpack_image, "K5b": relayout.pack_image,
                "K6": knn_loss.knn_rows, "K7": knn_loss.knn_reverse,
                "K8": segment_sum.segment_sum_rows_packed, "X2": binning_scan.boundary_deltas}

    def reset():
        for fn in counters.values():
            fn.launches = 0
        comm.ledger.reset()

    def read():
        return ({k: fn.launches for k, fn in counters.items()}, comm.ledger.summary())

    out = {}
    cam = bench_camera(width, height)
    cam2 = bench_camera(width, height, eye=MULTI_EYE2)
    one, two = multi_batches(torch, cam, cam2, device)
    # (a) one frame, the gauss pair together
    mesh = Mesh(1, 2)
    gparams, deform = state.params["gaussians"], state.params["deform"]
    local, laux = shard_train_state(mesh, state, aux)
    bg = torch.full((3,), 1.0 if setup.white_background else 0.0, device=device)
    kw = dict(iteration=10 ** 9, sh_degree=setup.sh_degree, kernel_size=setup.kernel_size,
              disable_filter3d=setup.disable_filter3d, num_down_emb_c=setup.num_down_emb,
              num_down_emb_f=setup.num_down_emb)
    frame = settings_from_camera(cam, time=0.3, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    with torch.no_grad():
        reset()
        strip = render(local.params["gaussians"], laux, deform, setup.hidden, frame, setup.raster,
                       bg, mesh=mesh, **kw)
        sync()
        launches, ledger = read()
        single = render(gparams, aux, deform, setup.hidden, frame, setup.raster, bg, **kw)
    keys = ("render", "mask", "expected_coord", "median_coord", "expected_depth",
            "median_depth", "normal", "tongue_mask")
    worst = {k: float(((strip[k] - single[k]).abs()
                       - MULTI_RTOL * single[k].abs()).max()) for k in keys}
    out["a"] = dict(launches=launches, ledger=ledger, excess=worst,
                    send_overflow=int(strip["send_overflow"]),
                    capacity=max(64, 2 * laux.alive.shape[0]),
                    num_pairs=(int(strip["num_pairs"]), int(single["num_pairs"])))
    del strip, single

    def run(mesh, setup_m, batches):
        st, ax = shard_train_state(mesh, state, aux)
        # eager: gloo's collectives cannot be captured in a CUDA graph
        step = make_sharded_train_step(setup_m, optimizer, mesh, graph=False)
        reset()
        metrics, ms, first = [], [], None
        for b in batches:
            sync()
            t0 = time.perf_counter()
            st, ax, m = step(st, ax, shard_batch(mesh, b), cache)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
            if first is None:
                first = (st, ax)
        launches, ledger = read()
        nums = multi_numbers(torch, *gather_train_state(mesh, *first), metrics)
        return dict(launches=launches, ledger=ledger, step_ms=ms,
                    send_overflow=[int(m["send_overflow"]) for m in metrics], **nums)

    out["b"] = run(Mesh(1, 2), replace(setup, comms="strip"), one)
    out["c"] = run(Mesh(2, 1), replace(setup, batch_size=2), two)
    return out


def run_group(cmd, env, cwd, deadline):
    """Run cmd in its own process group; kill the whole group past
    `deadline` s. Returns (exit code or None on the deadline, stdout+stderr)."""
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=deadline)
        return proc.returncode, text
    except subprocess.TimeoutExpired:
        import signal
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        return None, text


def multi_phase(torch, snap, cli, tmp):
    """The `multi` phase (see MULTI_*): two ranks sharing cuda:0 in one gloo
    world, at the train phase's width, from the state `snap` holds; then
    tools.train on two ranks under torch.distributed.run on the cli phase's
    scene. Returns the phase's numbers; fails on a rank that fails or misses
    its deadline, a comparison past its bound, or a rank that launched none
    of K1-K7."""
    from dataclasses import replace

    from ed3dgs_torch import convert
    from ed3dgs_torch.ops.rasterize import RasterConfig
    from ed3dgs_torch.parallel.multihost import spawn_world
    from ed3dgs_torch.render import RenderSettings, render
    from ed3dgs_torch.tools import train as train_tool
    from ed3dgs_torch.train import losses as L
    from ed3dgs_torch.train.trainer import make_train_step

    t_phase = time.perf_counter()
    out = {}
    state, aux, cache, setup = snap["state"], snap["aux"], snap["cache"], snap["setup"]
    path = os.path.join(tmp, "multi_state.pt")
    torch.save(dict({k: snap[k] for k in ("state", "aux", "cache", "setup", "opt", "extent")},
                    device=DEVICE, size=(WIDTH, HEIGHT)), path)
    # the single-process references from the same state
    cam = bench_camera(WIDTH, HEIGHT)
    one, two = multi_batches(torch, cam, bench_camera(WIDTH, HEIGHT, eye=MULTI_EYE2), DEVICE)
    refs = {}
    with torch.enable_grad():
        for key, setup_r, batches in (("b", setup, one), ("c", replace(setup, batch_size=2),
                                                          two)):
            step = make_train_step(setup_r, snap["optimizer"], graph=False)
            st, ax, metrics, first = state, aux, [], None
            for b in batches:
                st, ax, m = step(st, ax, b, cache)
                metrics.append(m)
                first = first or (st, ax)
            refs[key] = multi_numbers(torch, *first, metrics)
    del st, ax, metrics, first
    if DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = spawn_world(multi_rank, 2, backend="gloo", args=(path,),
                            deadline_s=MULTI_DEADLINE, timeout_s=120.0)
    except RuntimeError as e:
        fail(f"multi: {e}")
    out["world_s"] = time.perf_counter() - t0
    os.remove(path)

    core = ("K1", "K2", "K3", "K4", "K5a", "K5b", "K6", "K7", "X2")
    # launches a step: (b) one camera a rank, K4 and X2 twice (the strip bin
    # and the pack's bin) and K3 twice (the blend's and the pack's backward),
    # K6/K7 on both ranks (data rank 0); (c) one camera a rank, K6/K7 on
    # data rank 0 only
    want_b = {k: MULTI_STEPS * (2 if k in ("K3", "K4", "X2") else 1) for k in core}
    totals = {k: 0 for k in KERNELS}
    for r, res in enumerate(ranks):
        for sub in ("a", "b", "c"):
            for k, n in res[sub]["launches"].items():
                totals[k] += n
        print(f"multi: rank {r} launches (a) {res['a']['launches']} (b) "
              f"{res['b']['launches']} (c) {res['c']['launches']}", flush=True)
        want_c = {k: MULTI_STEPS * (1 if k not in ("K6", "K7") or r == 0 else 0) for k in core}
        if any(res["a"]["launches"][k] != 1 for k in ("K1", "K5a")) or \
                any(res["a"]["launches"][k] != 2 for k in ("K4", "X2")):
            fail(f"multi (a): rank {r} launches {res['a']['launches']}")
        if {k: res["b"]["launches"][k] for k in core} != want_b:
            fail(f"multi (b): rank {r} launches {res['b']['launches']}, want {want_b}")
        if {k: res["c"]["launches"][k] for k in core} != want_c:
            fail(f"multi (c): rank {r} launches {res['c']['launches']}, want {want_c}")
        if any(sum(res[s]["launches"][k] for s in "abc") == 0 for k in core):
            fail(f"multi: rank {r} launched none of some kernel of K1-K7 and X2")
    out["launches"] = totals

    # (a) the strip render against one process
    for r, res in enumerate(ranks):
        a = res["a"]
        print(f"multi (a): rank {r} render(mesh=gauss 2) vs render(): worst |diff| - "
              f"rtol*|value| by output {a['excess']} (limit {MULTI_ATOL}); send_overflow "
              f"{a['send_overflow']} of capacity {a['capacity']}; num_pairs "
              f"{a['num_pairs']}; collectives {a['ledger']}", flush=True)
        if max(a["excess"].values()) > MULTI_ATOL or a["send_overflow"] > a["capacity"]:
            fail(f"multi (a): rank {r}'s strip render misses the single-process render")
        if a["num_pairs"][0] != a["num_pairs"][1]:
            fail(f"multi (a): rank {r} reports another pair demand {a['num_pairs']}")
    out["a"] = {r: dict(excess=res["a"]["excess"], send_overflow=res["a"]["send_overflow"])
                for r, res in enumerate(ranks)}

    # (b), (c): each rank's gathered state against the single-process steps
    for sub, what in (("b", "data=1 x gauss=2, strip, batch 1"),
                      ("c", "data=2 x gauss=1, gspmd, batch 2")):
        ref = refs[sub]
        rows = []
        for r, res in enumerate(ranks):
            x = res[sub]
            err = dict(
                loss=max(abs(a - b) / abs(b) for a, b in zip(x["loss"], ref["loss"])),
                psnr=max(abs(a - b) / abs(b) for a, b in zip(x["psnr"], ref["psnr"])),
                xyz=float(np.abs(x["xyz"] - ref["xyz"]).max()),
                weight=float(np.abs(x["weight"] - ref["weight"]).max()),
                denom=float(np.abs(x["denom"] - ref["denom"]).max()))
            per_step = {kind: {tag: e["bytes"] / MULTI_STEPS for tag, e in tags.items()}
                        for kind, tags in x["ledger"].items()}
            print(f"multi ({sub}) {what}: rank {r} losses {x['loss']} (single "
                  f"{ref['loss']}); errors {err} (limits loss {MULTI_LOSS_REL} psnr "
                  f"{MULTI_PSNR_REL} xyz {MULTI_XYZ_ATOL} weight {MULTI_WEIGHT_ATOL} denom "
                  f"{MULTI_DENOM_ATOL}); step ms on the shared card (host clock, both ranks "
                  f"on one H100; cost, not scaling) {[round(v, 3) for v in x['step_ms']]}; "
                  f"collective bytes a step by kind and tag {per_step}", flush=True)
            if (err["loss"] > MULTI_LOSS_REL or err["psnr"] > MULTI_PSNR_REL
                    or err["xyz"] > MULTI_XYZ_ATOL or err["weight"] > MULTI_WEIGHT_ATOL
                    or err["denom"] > MULTI_DENOM_ATOL
                    or not all(math.isfinite(v) for v in x["loss"])):
                fail(f"multi ({sub}): rank {r} misses the single-process steps")
            rows.append(dict(errors=err, step_ms=x["step_ms"], bytes_per_step=per_step,
                             send_overflow=x["send_overflow"]))
        out[sub] = rows

    # (d) the training tool on two ranks sharing the card
    scene_dir = cli["scene_dir"]
    model_dir = os.path.join(tmp, "model_multi")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "ed3dgs_torch.tools.train", "-s", scene_dir, "-m", model_dir,
           "--configs", os.path.join(REPO, "configs", "nersemble", "default.py"),
           "--duration", str(CLI_FRAMES), "--iterations", str(MULTI_CLI_ITERS),
           "--test_every", str(MULTI_CLI_ITERS), "--checkpoint_iterations",
           str(MULTI_CLI_ITERS), "--seed", "0", "--device", DEVICE, "--mesh",
           "data=1,gauss=2", "--comms", "strip", "--dist_backend", "gloo",
           *(["--share_device"] if DEVICE == "cuda" else []), "--set", *CLI_SET]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    code, text = run_group(cmd, env, REPO, MULTI_CLI_DEADLINE)
    out["cli_s"] = time.perf_counter() - t0
    with open(os.path.join(tmp, "multi_cli.log"), "w") as f:
        f.write(text)
    tail = "\n".join(text.splitlines()[-12:])
    print(f"multi (d): torch.distributed.run of tools.train, 2 ranks on cuda:0, "
          f"{MULTI_CLI_ITERS} iterations: exit {code} in {out['cli_s']:.1f} s; its last "
          f"lines:\n{tail}", flush=True)
    if code != 0:
        fail("multi (d): the two-rank training run failed or missed its deadline")
    ckpt = os.path.join(model_dir, f"chkpnt{MULTI_CLI_ITERS}.npz")
    cstate, caux = convert.load_checkpoint(ckpt, device=DEVICE)
    cfg = train_tool.build_config(train_tool.parse_args(
        ["-s", scene_dir, "-m", model_dir, "--configs",
         os.path.join(REPO, "configs", "nersemble", "default.py"), "--set", *CLI_SET]))
    rows = caux.alive.shape[0]
    test_cam = [c for c in _scene_cameras(scene_dir, cfg, rows) if c.image is not None][0]
    m = test_cam.matrices()
    rcfg = RasterConfig(width=m.width, height=m.height, focal_x=m.focal_x, focal_y=m.focal_y,
                        pair_capacity=PAIR_CAPACITY, chunk=cfg.opt.raster_chunk)
    f32 = dict(dtype=torch.float32, device=DEVICE)
    s = RenderSettings(torch.as_tensor(m.world_view, **f32), torch.as_tensor(m.full_proj, **f32),
                       torch.as_tensor(m.campos, **f32), torch.tensor(test_cam.time, **f32),
                       torch.zeros((), dtype=torch.int64, device=DEVICE))
    bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0, **f32)
    with torch.no_grad():
        img = render(cstate.params["gaussians"], caux, cstate.params["deform"], cfg.hidden, s,
                     rcfg, bg, iteration=MULTI_CLI_ITERS, sh_degree=cfg.model.sh_degree,
                     kernel_size=cfg.model.kernel_size,
                     disable_filter3d=cfg.model.disable_filter3D,
                     num_down_emb_c=cfg.hidden.min_embeddings,
                     num_down_emb_f=cfg.hidden.min_embeddings)["render"]
        psnr = float(torch.mean(L.psnr(img[None], torch.as_tensor(test_cam.image,
                                                                  device=DEVICE)[None])))
    print(f"multi (d): checkpoint {os.path.basename(ckpt)} reloaded in one process ({rows} rows, "
          f"{int(caux.alive.sum())} alive, iteration {int(cstate.iteration)}); test PSNR "
          f"{psnr:.3f} dB on {os.path.basename(str(test_cam.image_path))}", flush=True)
    if not math.isfinite(psnr) or int(cstate.iteration) != MULTI_CLI_ITERS:
        fail("multi (d): the reloaded checkpoint does not render")
    out["cli"] = dict(seconds=out["cli_s"], test_psnr=psnr, alive=int(caux.alive.sum()),
                      rows=rows)
    out["e"] = {"default": mesh_graph_check(torch, snap, one)}
    # the tongue and COLMAP steps of 5b, from its states
    core = ("K1", "K2", "K3", "K4", "K5a", "K5b", "K6", "K7", "X2")
    for name, what in (("tongue", "tongue step"), ("colmap", "COLMAP step")):
        if name in snap:
            e = mesh_graph_check(torch, snap[name], snap[name]["batches"], what, core)
            out["e"][name] = e
            for r in e.values():
                for k, n in r["launches"].items():
                    out["launches"][k] += n
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"multi: phase {out['wall_s']:.1f} s (world {out['world_s']:.1f} s, torchrun "
          f"{out['cli_s']:.1f} s)", flush=True)
    return out


def mesh_graph_check(torch, snap, batches, what="sharded step", keys=()) -> dict:
    """(e) of the multi phase: the sharded step's graph on this one card, in
    a world of one (a Mesh(1, 1): no collective runs, so gloo's limits do
    not apply, and the NCCL graph itself needs a card a rank:
    scripts/torch_multi_gpu.py). For gspmd and strip, the graphed sharded
    step (the default) against the eager one (graph=False) from the state
    `snap` holds (its setup, optimizer, state, aux and KNN cache) over
    `batches` (two keys or more: a later step replays), every state tensor
    and metric bit for bit, each step timed by CUDA events, and the graphed
    run's launches of `keys` on the card (the kernels' counters), which
    must be `per_step_launches` a step (K3, K4 and X2 twice as many under
    strip: the pack's bin and its backward). Fails on a capture that fails,
    a tensor that differs or launches off that count."""
    from dataclasses import replace

    from ed3dgs_torch.ops import cuda_lib
    from ed3dgs_torch.parallel.mesh import Mesh
    from ed3dgs_torch.parallel.sharded import make_sharded_train_step

    mesh = Mesh(1, 1)
    out = {}
    for comms in ("gspmd", "strip"):
        runs = {}
        for graph in (False, True):
            step = make_sharded_train_step(replace(snap["setup"], comms=comms),
                                           snap["optimizer"], mesh, graph=graph)
            s, a = snap["state"], snap["aux"]
            tensors, events = [], []
            with cuda_lib.DeviceLaunches() as trace:
                for b in batches:
                    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    e0.record()
                    s, a, m = step(s, a, b, snap["cache"])
                    e1.record()
                    events.append((e0, e1))
                    tensors.append({k: v.detach().clone()
                                    for k, v in state_tensors(s, a, m).items()})
            torch.cuda.synchronize()
            runs[graph] = dict(tensors=tensors, ms=[e0.elapsed_time(e1) for e0, e1 in events],
                               captures=len(step.graphs.captures) if graph and step.graphs
                               else 0,
                               pool_bytes=step.graphs.pool_bytes if graph and step.graphs
                               else 0,
                               launches=card_launches(trace, keys) if keys else {})
            del step, s, a, m
        differ = [sorted(k for k in e if not torch.equal(e[k], g[k]))
                  for e, g in zip(runs[False]["tensors"], runs[True]["tensors"])]
        g = runs[True]
        want = {k: n * len(batches) * (2 if comms == "strip" and k in ("K3", "K4", "X2")
                                       else 1)
                for k, n in per_step_launches(snap["setup"], keys).items()}
        out[comms] = dict(bit_for_bit=[not d for d in differ], graphed_ms=g["ms"],
                          eager_ms=runs[False]["ms"], captures=g["captures"],
                          pool_bytes=g["pool_bytes"], launches=g["launches"])
        print(f"multi (e) the {what} graphed in a world of one, {comms}: bit-identical to "
              f"eager a step {out[comms]['bit_for_bit']}, ms a step (CUDA events) graphed "
              f"{[round(x, 3) for x in g['ms']]} eager "
              f"{[round(x, 3) for x in runs[False]['ms']]}, captures {g['captures']}, pool "
              f"{g['pool_bytes']} bytes"
              + (f", graphed launches on the card {g['launches']}" if keys else ""), flush=True)
        if any(differ):
            fail(f"multi (e): the graphed {what} ({comms}) differs from the eager one: "
                 f"{[d[:6] for d in differ]}")
        if g["launches"] != want:
            fail(f"multi (e): the graphed {what} ({comms}) launched {g['launches']} on the "
                 f"card, not {want}")
        del runs, g
    return out


def count_waits(torch, fn) -> list:
    """Run fn under sync debug mode "warn": one entry a host-device wait,
    the innermost ed3dgs_torch frame that made it and that frame's caller."""
    import traceback
    import warnings
    pkg = os.path.join(REPO, "ed3dgs_torch")
    waits = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "prototype feature" in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(pkg)]
        waits.append(" <- ".join(f"{os.path.relpath(f.filename, REPO)}:{f.lineno} ({f.name})"
                                 for f in frames[::-1][:2]) or f"{filename}:{lineno}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return waits


def densify_tensors(torch, state, aux, n_cloned, n_split) -> dict:
    """Clones of what a densify step returns: the cloud, its aux, every
    Adam moment and count, and the clone and split counts."""
    out = {f"params/{k}": v for k, v in state.params["gaussians"]._asdict().items()}
    for g, st in state.opt_state.items():
        out.update({f"mu/{g}/{k}": v for k, v in st.mu.items()})
        out.update({f"nu/{g}/{k}": v for k, v in st.nu.items()})
        out[f"count/{g}"] = torch.tensor(st.count)
    out.update({f"aux/{k}": v for k, v in aux._asdict().items()})
    out.update(n_cloned=n_cloned, n_split=n_split)
    return {k: v.detach().clone() for k, v in out.items()}


def state_tensors(state, aux, metrics) -> dict:
    """Every tensor a step returns, by name."""
    from ed3dgs_torch.train.optim import flatten_params
    out = {f"params/{k}": v for k, v in flatten_params(state.params).items()}
    for g, st in state.opt_state.items():
        out.update({f"mu/{g}/{k}": v for k, v in st.mu.items()})
        out.update({f"nu/{g}/{k}": v for k, v in st.nu.items()})
    out.update({f"aux/{k}": v for k, v in aux._asdict().items()})
    out.update({f"metrics/{k}": v for k, v in metrics.items()})
    return out


def graph_against_eager(torch, eager, step, state, aux, cache, cam, B, setup, counters,
                        per_step):
    """`steps_against_eager` over one batch for each of GRAPH_SSIM, from 3
    iterations before the depth-normal term through 3 after, SSIM on and
    off: the batches must cross a key change and replay known keys.
    Returns the steps' records and the counts of replays and captures."""
    state = state._replace(iteration=setup.radegs_from_iter - 3)
    batches = [make_batch(torch, cam, B, 0.15 + 0.1 * i, ssim, 700 + i, DEVICE)
               for i, ssim in enumerate(GRAPH_SSIM)]
    _, _, steps = steps_against_eager(torch, eager, step, state, aux, cache, batches, counters,
                                      per_step, "graphed against eager")
    out = dict(steps=steps, replays=sum(s["replay"] for s in steps))
    out["captures"] = len(steps) - out["replays"]
    if out["replays"] < 2 or out["captures"] < 2:
        fail(f"graphed against eager: {out['replays']} replays and {out['captures']} captures; "
             "the batches must cross a key change and replay known keys")
    return out


def frame_against_eager(torch, params, aux, dparams, hidden, model, rcfg, bg, cam):
    """tools.FrameRenderer's graph against render() op by op on the bench
    frame at FRAME_TIMES: every output bit-identical; both timed by CUDA
    events (FRAME_REPS frames each, after one of each). Each graphed frame
    of the comparison must launch K1, X2, K4 and K5a once on the card (the
    device counters)."""
    from ed3dgs_torch.ops import cuda_lib
    from ed3dgs_torch.tools import FRAME_OUTPUTS, FrameRenderer
    kw = dict(sh_degree=model.sh_degree, kernel_size=model.kernel_size,
              disable_filter3d=model.disable_filter3D, num_down_emb=hidden.min_embeddings)
    graphed = FrameRenderer(hidden, bg, **kw)
    eager = FrameRenderer(hidden, bg, graph=False, **kw)
    trained = (params, aux, dparams)

    def frame(fr, t):
        return fr("bench", trained, rcfg, cam.world_view, cam.full_proj, cam.campos, t)
    differ, launches = [], []
    for t in FRAME_TIMES:
        want = frame(eager, t)
        with cuda_lib.DeviceLaunches() as trace:
            got = frame(graphed, t)
        launches.append(card_launches(trace, ("K1", "K4", "K5a", "X2")))
        differ += [(t, k) for k in FRAME_OUTPUTS if not torch.equal(want[k], got[k])]
    times = {}
    for name, fr in (("eager", eager), ("graphed", graphed)):
        frame(fr, FRAME_TIMES[1])
        torch.cuda.synchronize()
        ms, host = [], []
        for i in range(FRAME_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            frame(fr, FRAME_TIMES[i % len(FRAME_TIMES)])
            end.record()
            host.append((time.perf_counter() - t0) * 1e3)
            end.synchronize()
            ms.append(start.elapsed_time(end))
        times[name] = dict(ms=ms, host_ms=host)
    caps = graphed.graphs.captures
    out = dict(differing=differ, launches=launches, captures=len(caps),
               capture_s=[c[1] for c in caps],
               pool_bytes=graphed.graphs.pool_bytes,
               eager_ms_median=float(np.median(times["eager"]["ms"])),
               graphed_ms_median=float(np.median(times["graphed"]["ms"])),
               eager_host_ms_median=float(np.median(times["eager"]["host_ms"])),
               graphed_host_ms_median=float(np.median(times["graphed"]["host_ms"])))
    print("frame graph against render() op by op: " + ", ".join(
        f"{k}={v}" for k, v in out.items()), flush=True)
    if differ:
        fail(f"the graphed frame differs from render(): {differ[:8]}")
    if any(n != 1 for per in launches for n in per.values()):
        fail(f"a graphed frame did not launch K1, X2, K4 and K5a once each: {launches}")
    return out


def tongue_cloud(n: int, seed: int = 0) -> dict:
    """bench_cloud with its first TONGUE_N Gaussians moved into the tongue
    blob (tongue class 1), the first TONGUE_SMALL of them at scales below
    percent_dense x extent (3.3e-3 for the filter cameras) and above the
    3D filter's ~1e-3 (which would fade a smaller one out of sight): clone
    candidates, and the lowest slots, which densify serves first."""
    fields = bench_cloud(n, seed)
    rng = np.random.default_rng(seed + 2)
    fields["xyz"][:TONGUE_N] = (np.asarray(TONGUE_CENTRE, np.float32)
                                + rng.normal(0, TONGUE_SD, (TONGUE_N, 3)))
    fields["scaling"][:TONGUE_SMALL] = np.log(rng.uniform(1.5e-3, 3e-3, (TONGUE_SMALL, 3)))
    fields["tongue_class"][:TONGUE_N] = 1.0
    return {k: np.asarray(v, np.float32) for k, v in fields.items()}


def tongue_batch(torch, setup, state, aux, cam, t, use_ssim, seed):
    """make_batch's views of `cam` at time t with a tongue target: the
    tongue-only alpha [B, 1, H, W] of `state` at TRAIN_ITERATION with the
    tongue rows jittered by TONGUE_JITTER (numpy seed), as generate_scene
    writes a segmentation (the tongue-only alpha on black)."""
    from ed3dgs_torch.render import render, settings_from_camera
    B = setup.batch_size
    b = make_batch(torch, cam, B, t, use_ssim, seed, DEVICE)
    params = state.params["gaussians"]
    rng = np.random.default_rng(seed)
    jitter = torch.as_tensor(rng.normal(0, TONGUE_JITTER, tuple(params.xyz.shape))
                             .astype(np.float32), device=DEVICE)
    moved = params._replace(xyz=params.xyz + jitter * aux.tongue_class)
    bg = torch.full((3,), 1.0 if setup.white_background else 0.0, device=DEVICE)
    with torch.no_grad():
        alpha = render(moved, aux, state.params["deform"], setup.hidden,
                       settings_from_camera(cam, time=t, device=DEVICE), setup.raster, bg,
                       iteration=TRAIN_ITERATION, sh_degree=setup.sh_degree,
                       kernel_size=setup.kernel_size, disable_filter3d=setup.disable_filter3d,
                       num_down_emb_c=setup.num_down_emb, num_down_emb_f=setup.num_down_emb,
                       tongue_filter="only")["mask"]
    b["tongue_gt"] = alpha[None].repeat(B, 1, 1, 1).contiguous()
    return b


def steps_against_eager(torch, eager, step, state, aux, cache, batches, counters, per_step,
                        what, iterations=None):
    """The eager step and the graphed one (a CUDA graph per key) from one
    state over `batches`: after every step every metric, parameter, Adam
    moment and aux statistic must be bit-identical, each replay runs under
    sync debug mode "error", and each graphed step must launch `per_step`
    on the card (the device counters), while the wrappers count only a
    key's first, eager run (a replay calls none, a capture launches
    nothing). Each step is timed by CUDA events, eager and graphed. With
    `iterations`, both states take the i-th as their count before the i-th
    step (a sweep over a schedule's keys). Returns (the graphed state and
    aux after the last step, one record a step: replay or capture, ms each
    way, launches, the wrappers' counts, the graphed step's scalar
    metrics)."""
    from ed3dgs_torch.ops import cuda_lib
    e_state, e_aux, g_state, g_aux = state, aux, state, aux
    steps = []
    for i, b in enumerate(batches):
        if iterations is not None:
            e_state = e_state._replace(iteration=iterations[i])
            g_state = g_state._replace(iteration=iterations[i])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        e_state, e_aux, em = eager(e_state, e_aux, b, cache)
        ev[1].record()
        replay = step.graphs is not None and step.key(g_state, g_aux, b, cache) in step.graphs
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        with cuda_lib.DeviceLaunches() as trace:
            ev[2].record()
            if replay:
                torch.cuda.set_sync_debug_mode("error")
            try:
                g_state, g_aux, gm = step(g_state, g_aux, b, cache)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            ev[3].record()
        launches = card_launches(trace, counters)
        wrapped = {k: fn.launches for k, fn in counters.items()}
        want, got = state_tensors(e_state, e_aux, em), state_tensors(g_state, g_aux, gm)
        differ = [k for k in want if not (want[k].dtype == got[k].dtype
                                          and torch.equal(want[k], got[k]))]
        rec = dict(iteration=int(e_state.iteration) - 1, ssim=bool(b["use_ssim"]),
                   replay=replay, eager_ms=ev[0].elapsed_time(ev[1]),
                   graphed_ms=ev[2].elapsed_time(ev[3]), differing=differ, launches=launches,
                   wrapper_counts=wrapped,
                   metrics={k: float(v) for k, v in gm.items() if v.numel() == 1})
        steps.append(rec)
        print(f"{what}, iteration {rec['iteration']} SSIM {rec['ssim']}: "
              f"{'replay' if replay else 'capture'}, {len(want)} tensors, differing "
              f"{len(differ)} {differ[:6]}; ms (CUDA events) eager {rec['eager_ms']:.3f}, "
              f"graphed {rec['graphed_ms']:.3f}; launches on the card {launches}, counted "
              f"by the wrappers {wrapped}; "
              + " ".join(f"{k}={v:.6g}" for k, v in rec["metrics"].items()), flush=True)
        if differ:
            fail(f"{what}: the graphed step differs from the eager step at iteration "
                 f"{rec['iteration']}: {differ[:8]}")
        if int(e_state.iteration) != int(g_state.iteration):
            fail(f"{what}: the graphed step's iteration count differs from the eager step's")
        if launches != per_step:
            fail(f"{what}: the graphed step launched {launches}, not {per_step}")
        if wrapped != ({k: 0 for k in per_step} if replay else per_step):
            fail(f"{what}: the wrappers counted {wrapped} in a {'replay' if replay else 'capture'}")
        if not all(math.isfinite(v) for v in rec["metrics"].values()):
            fail(f"{what}: a metric is not finite at iteration {rec['iteration']}")
    return g_state, g_aux, steps


def step_summary(step, steps) -> dict:
    """The median ms of the replayed steps and of every eager step (CUDA
    events), and the graph cache's captures and pool bytes."""
    caps = step.graphs.captures
    return dict(graphed_ms=float(np.median([s["graphed_ms"] for s in steps if s["replay"]])),
                eager_ms=float(np.median([s["eager_ms"] for s in steps])),
                captures=len(caps), capture_s=[c[1] for c in caps],
                pool_bytes=step.graphs.pool_bytes)


def knn_kernels_on(torch, emb, graph, flush) -> dict:
    """K6 -> K7 on `graph` (rank table of emb, as the step hands them)
    against the plain chain, at KNN_LOSS_REL and KNN_ROW_REL as in 4; both
    timed as in 1. Returns the numbers; fails on a disagreement."""
    from ed3dgs_torch.ops import knn_loss
    emb_r = knn_loss.rank_table(emb, graph, knn_loss.kernel_width(emb.shape[1]))
    args6 = (emb_r, graph.nbr, graph.w, graph.coef)
    loss, de, s_ = knn_loss.knn_rows(*args6)
    out7 = knn_loss.knn_reverse(emb_r, s_, de, graph.rev_ptr, graph.rev_pair)
    loss_p, de_p, s_p = knn_loss.knn_rows_plain(*args6)
    out_p = knn_loss.knn_reverse_plain(emb_r, s_p, de_p, graph.rev_ptr, graph.rev_pair)
    loss_rel = abs(float(loss) - float(loss_p)) / max(abs(float(loss_p)), 1e-30)
    row_max = out_p.abs().amax(dim=1)
    row_err = (out7 - out_p).abs().amax(dim=1)
    worst_row = float((row_err / torch.clamp_min(row_max, 1e-30)).max())
    if (loss_rel > KNN_LOSS_REL or not bool(torch.isfinite(out7).all())
            or not bool((row_err <= KNN_ROW_REL * row_max).all()) or float(loss_p) <= 0):
        fail(f"K6/K7 disagree with their plain versions on the tongue graph (loss rel "
             f"{loss_rel:.2e}, worst row {worst_row:.2e})")
    ms6 = time_ms(torch, lambda: knn_loss.knn_rows(*args6), 50, flush)
    ms7 = time_ms(torch, lambda: knn_loss.knn_reverse(emb_r, s_, de, graph.rev_ptr,
                                                      graph.rev_pair), 50, flush)
    return dict(live_rows=int((graph.w > 0).any(dim=1).sum()), ranks=int(emb_r.shape[0]),
                in_edges=int(graph.rev_pair.shape[0]), loss=float(loss), loss_rel=loss_rel,
                worst_row=worst_row, k6_ms=ms6, k7_ms=ms7)


def graph_buckets(cache) -> dict:
    """Each graph's dropped edges by bucket, far demand and in-edges."""
    out = {}
    for name, g in (("main", cache.graph), ("tongue", cache.t_graph)):
        spill_a, spill_b, far = g.overflow.tolist()
        out[name] = dict(spill_a=spill_a, spill_b=spill_b, far=far, n_far=int(g.n_far),
                         in_edges=int(g.rev_pair.shape[0]))
    return out


def tongue_refresh(torch, params, aux, caps, coverage_target):
    """refresh_knn_cache with tongue_enabled, wall-timed between two
    synchronises, recording each search's input; returns (cache, wall ms,
    [(points, k)] searched, X1's launches by its wrapper)."""
    from ed3dgs_torch.ops import knn
    from ed3dgs_torch.train import trainer as trainer_mod
    searched = []
    orig = trainer_mod.knn_op

    def recording(pts, k):
        searched.append((pts, k))
        return orig(pts, k=k)
    knn.knn.launches = 0
    trainer_mod.knn_op = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = trainer_mod.refresh_knn_cache(params, aux, caps, tongue_enabled=True,
                                              coverage_target=coverage_target)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        trainer_mod.knn_op = orig
    return cache, wall_ms, searched, knn.knn.launches


def tongue_threshold(torch, state, aux, opt, extent):
    """The densify threshold of a tongue state: the config's rule at
    TRAIN_ITERATION, lowered to the 99.9th percentile of the seen
    Gaussians' mean screen-space gradient and to the hottest clone-sized and
    the hottest larger tongue Gaussian, so that both clone and split take
    tongue parents. Returns (threshold, the mean gradients, the clone-sized
    mask, the alive tongue mask, {config, q999, tongue_small,
    tongue_large}); fails where the steps saw no clone-sized or no larger
    tongue Gaussian."""
    grads = torch.where(aux.denom > 0, aux.xyz_grad_accum / aux.denom,
                        torch.zeros_like(aux.denom))
    scales = torch.exp(state.params["gaussians"].scaling).amax(dim=1)
    small = scales <= opt.percent_dense * extent
    tongue = aux.alive & (aux.tongue_class[:, 0] > 0.5)
    thr_cfg = (opt.densify_grad_threshold_fine_init
               - TRAIN_ITERATION * (opt.densify_grad_threshold_fine_init
                                    - opt.densify_grad_threshold_after) / opt.densify_until_iter)
    seen_rows = aux.alive & (aux.denom > 0)
    q999 = float(torch.quantile(grads[seen_rows], 0.999))
    if not (bool((seen_rows & tongue & small).any())
            and bool((seen_rows & tongue & ~small).any())):
        fail("the tongue steps saw no clone-sized or no larger tongue Gaussian")
    t_small = float(grads[seen_rows & tongue & small].max())
    t_large = float(grads[seen_rows & tongue & ~small].max())
    if min(t_small, t_large) <= 0:
        fail(f"the tongue Gaussians' densify statistics are 0 (clone-sized {t_small}, larger "
             f"{t_large})")
    return (min(thr_cfg, q999, t_small, t_large), grads, small, tongue,
            dict(config=thr_cfg, q999=q999, tongue_small=t_small, tongue_large=t_large))


def tongue_phase(torch, cam, rcfg, fargs, extent, counters) -> dict:
    """5b: the tongue configuration (TONGUE_CFG) on the bench cloud with a
    tongue blob (`tongue_cloud`), then the COLMAP step (`colmap_phase`).
    Returns the phase's numbers; fails on any check below."""
    from ed3dgs_torch.config.loader import load_full_config
    from ed3dgs_torch.convert import gaussians_from_numpy
    from ed3dgs_torch.models.gaussians import compute_3d_filter
    from ed3dgs_torch.ops import knn
    from ed3dgs_torch.train.trainer import (KNN_CAPS_DEFAULT, KNN_K, _cache_inputs,
                                            _prepare_cache, init_train_state,
                                            make_densify_step, make_train_step)

    cfg = load_full_config(os.path.join(REPO, TONGUE_CFG))
    setup = train_setup(cfg, rcfg)
    hidden, opt = cfg.hidden, cfg.opt
    if not setup.tongue_enabled or setup.colmap_supervision:
        fail(f"{TONGUE_CFG}: the tongue terms are not on, or COLMAP supervision is")
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    flush = flush_buf.zero_
    out = {}
    params, aux = gaussians_from_numpy(tongue_cloud(N_GAUSS), capacity=CAPACITY, device=DEVICE)
    aux = aux._replace(filter_3d=compute_3d_filter(params.xyz, aux.alive, *fargs))
    n_tongue = int((aux.alive & (aux.tongue_class[:, 0] > 0.5)).sum())
    print(f"tongue phase ({TONGUE_CFG}: tongue terms on, reg_coef {setup.reg_coef}, "
          f"batch {setup.batch_size}, max_number_gaussians {opt.max_number_gaussians}): "
          f"{N_GAUSS} Gaussians, {n_tongue} of tongue class 1 in a blob at {TONGUE_CENTRE} "
          f"(sd {TONGUE_SD}), capacity {CAPACITY}", flush=True)

    # the refresh with the tongue graph: X1 twice (the main graph's input,
    # then the tongue graph's: every other slot parked on the mirrored far
    # shell), each input against knn_plain by torch.equal and timed
    caps = dict(KNN_CAPS_DEFAULT)
    cache, refresh_ms, searched, x1_calls = tongue_refresh(torch, params, aux, caps,
                                                           opt.knn_coverage_target)
    if len(searched) != 2 or x1_calls != 2:
        fail(f"the tongue refresh searched {len(searched)} times and launched X1 "
             f"{x1_calls} times, not twice")
    x1 = []
    for name, (pts, k) in zip(("main", "tongue"), searched):
        same, err = x1_against_plain(torch, pts, k)
        n = pts.shape[0]
        ms = time_ms(torch, lambda: knn.knn(pts, k=k), 10, flush)
        visits = x1_visits(torch, knn, pts, k)
        b_x1, by_x1 = bound(n * 3 * 4 + n * k * (4 + 8), n * (k + 1) * X1_FLOPS_PER_PAIR)
        parked = int((pts.abs().amax(dim=1) > 100.0).sum())
        x1.append(dict(graph=name, n=n, k=k, parked=parked, equal=same, max_abs_err=err,
                       ms=ms, bound_ms=b_x1, bound_by=by_x1, visits=visits))
        print(f"  X1 on the {name} graph's input: {n} points ({parked} parked on the far "
              f"shell), k={k}: equal to knn_plain by torch.equal={same}; {ms:.4f} ms (bound "
              f"{b_x1:.4f}, {by_x1}); tiles visited a warp mean {visits['tiles_mean']:.2f} "
              f"max {visits['tiles_max']} of {visits['tiles']}, pairs {visits['pairs']}",
              flush=True)
        if not same:
            fail(f"X1 disagrees with knn_plain on the {name} graph's input of the tongue "
                 "refresh")
    del searched
    inputs, search_ms = wall_ms_of(torch, lambda: _cache_inputs(params, aux, True, KNN_K))
    _, prepare_ms = wall_ms_of(torch, lambda: _prepare_cache(
        inputs, caps["spill_a"], caps["spill_b"], caps["far"]))
    del inputs
    buckets = graph_buckets(cache)
    print(f"  refresh_knn_cache (tongue): {refresh_ms:.1f} ms wall (searches "
          f"{search_ms:.1f}, preparation {prepare_ms:.1f}), buckets "
          f"{ {k: v for k, v in caps.items() if not k.startswith('_')} }, per graph {buckets}",
          flush=True)
    knn6 = knn_kernels_on(torch, params.embedding, cache.t_graph, flush)
    print(f"  K6/K7 on the tongue graph: {knn6}", flush=True)
    out.update(x1=x1, refresh_ms=refresh_ms, search_ms=search_ms, prepare_ms=prepare_ms,
               buckets=buckets, knn_kernels=knn6)

    state, optimizer = init_train_state(params, hidden, opt, extent, seed=0)
    state = state._replace(iteration=TRAIN_ITERATION)
    eager = make_train_step(setup, optimizer, graph=False)
    step = make_train_step(setup, optimizer)
    batches = [tongue_batch(torch, setup, state, aux, cam, 0.15 + 0.1 * i, ssim, 800 + i)
               for i, ssim in enumerate(TONGUE_SSIM)]
    gt_means = [float(b["tongue_gt"][-1].mean()) for b in batches]
    print(f"  tongue targets' means {[round(x, 5) for x in gt_means]} (the colour term "
          f"needs > 0.005)", flush=True)
    if min(gt_means) <= 0.005:
        fail("a tongue target covers too little of the image for the tongue colour term")
    per_step = per_step_launches(setup, counters)
    # the multi phase's (e) captures the sharded tongue step from here
    snaps = {"tongue": dict(state=state, aux=aux, cache=cache, setup=setup,
                            optimizer=optimizer, batches=batches[:MULTI_E_STEPS])}
    state, aux, steps = steps_against_eager(torch, eager, step, state, aux, cache, batches,
                                            counters, per_step, "tongue step")
    for s in steps:
        m = s["metrics"]
        if min(m[k] for k in ("tongue_l1", "tongue_emb", "tongue_rgb", "wo_tongue_rgb",
                              "emb_loss", "depth_normal")) <= 0:
            fail(f"tongue step at iteration {s['iteration']}: a tongue term, the KNN term or "
                 f"the depth-normal term is not live: {m}")
        if s["ssim"] == (m["ssim"] == 1.0):
            fail(f"tongue step at iteration {s['iteration']}: the SSIM term is not as gated")
    if sum(s["replay"] for s in steps) < 2:
        fail("tongue step: fewer than two replays")
    out["steps"] = step_summary(step, steps)
    print(f"  tongue step: {out['steps']}", flush=True)
    launches = {k: sum(s["launches"][k] for s in steps) for k in counters}

    # densify on the tongue state, eager against graphed
    thr, grads, small, tongue, parts = tongue_threshold(torch, state, aux, opt, extent)
    thr_cfg, q999, t_small, t_large = (parts[k] for k in ("config", "q999", "tongue_small",
                                                          "tongue_large"))
    hot = (grads >= thr) & aux.alive
    n_alive = int(aux.alive.sum())
    budget = max(min(opt.max_number_gaussians, CAPACITY) - n_alive, 0)
    clone_m, split_m = hot & small, hot & ~small
    n_clone = min(int(clone_m.sum()), budget)
    n_split = min(int(split_m.sum()), budget - n_clone)
    clone_sel = clone_m & (torch.cumsum(clone_m.to(torch.int64), 0) <= n_clone)
    split_sel = split_m & (torch.cumsum(split_m.to(torch.int64), 0) <= n_split)
    tongue_cloned, tongue_split = int((clone_sel & tongue).sum()), int((split_sel & tongue).sum())
    print(f"  tongue densify threshold {thr:.4e} (config {thr_cfg:.4e}, 99.9th percentile "
          f"{q999:.4e}, hottest clone-sized tongue {t_small:.4e}, hottest larger tongue "
          f"{t_large:.4e}): {n_clone} to clone ({tongue_cloned} tongue), {n_split} to split "
          f"({tongue_split} tongue), {budget} free slots", flush=True)
    if tongue_cloned == 0 or tongue_split == 0:
        fail("the tongue densify clones or splits no tongue Gaussian")
    densify_step = make_densify_step(opt, opt.percent_dense, extent)
    densify_eager = make_densify_step(opt, opt.percent_dense, extent, graph=False)
    state0, aux0 = state, aux

    def timed(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        res = fn(state0, aux0, torch.Generator(device=DEVICE).manual_seed(0), thr)
        ev[1].record()
        torch.cuda.synchronize()
        return res, ev[0].elapsed_time(ev[1])
    (e_state, e_aux, e_c, e_s), e_ms = timed(densify_eager)
    want = densify_tensors(torch, e_state, e_aux, e_c, e_s)
    del e_state, e_aux
    densify_ms, differ = [], []
    for _ in range(2):
        (state, aux, n_c, n_s), ms = timed(densify_step)
        got = densify_tensors(torch, state, aux, n_c, n_s)
        differ += [k for k in want if not torch.equal(want[k], got[k])]
        densify_ms.append(ms)
        del got
    del want
    born = aux.alive & ~aux0.alive
    born_tongue = int((born & (aux.tongue_class[:, 0] > 0.5)).sum())
    parents_kept = bool((aux.tongue_class[split_sel & tongue, 0] == 1.0).all())
    out["densify"] = dict(threshold=thr, n_cloned=int(n_c), n_split=int(n_s),
                          tongue_cloned=tongue_cloned, tongue_split=tongue_split,
                          born_tongue=born_tongue, eager_ms=e_ms, graphed_ms=densify_ms,
                          differing=differ)
    print(f"  tongue densify: n_cloned {int(n_c)}, n_split {int(n_s)}; new slots of tongue "
          f"class 1 {born_tongue} (want {tongue_cloned} clones + {tongue_split} split "
          f"children), split tongue parents kept class 1={parents_kept}; eager {e_ms:.3f} "
          f"ms, graphed {[round(x, 3) for x in densify_ms]} ms (CUDA events); graphed "
          f"differing from eager {differ[:6]}", flush=True)
    if differ:
        fail(f"the graphed densify differs from the eager one on the tongue state: {differ[:8]}")
    if (int(n_c), int(n_s)) != (n_clone, n_split) or born_tongue != tongue_cloned + tongue_split \
            or not parents_kept:
        fail("the tongue densify's children do not keep their parents' tongue class")
    del state0, aux0

    # both refreshes, then steps that must replay the known keys on the new
    # tongue graph (its reverse adjacency copied into the static buffers)
    rev_before = out["buckets"]["tongue"]["in_edges"]
    aux = aux._replace(filter_3d=compute_3d_filter(state.params["gaussians"].xyz, aux.alive,
                                                   *fargs))
    cache, refresh2_ms, searched, x1_calls2 = tongue_refresh(
        torch, state.params["gaussians"], aux, caps, opt.knn_coverage_target)
    del searched
    buckets2 = graph_buckets(cache)
    n_caps = len(step.graphs.captures)
    more = [tongue_batch(torch, setup, state, aux, cam, 0.45 + 0.1 * i, ssim, 850 + i)
            for i, ssim in enumerate((False, True)[:TONGUE_MORE])]
    state, aux, steps2 = steps_against_eager(torch, eager, step, state, aux, cache, more,
                                             counters, per_step, "tongue step after densify")
    print(f"  after densify: refresh {refresh2_ms:.1f} ms, X1 {x1_calls2} launches, tongue "
          f"graph in-edges {rev_before} -> {buckets2['tongue']['in_edges']}, per graph "
          f"{buckets2}; captures {n_caps} -> {len(step.graphs.captures)}", flush=True)
    if x1_calls2 != 2 or not all(s["replay"] for s in steps2) \
            or len(step.graphs.captures) != n_caps:
        fail("after the tongue refresh the graphed step did not replay its known keys")
    out.update(refresh_after_ms=refresh2_ms, buckets_after=buckets2,
               steps_after=[dict(eager_ms=s["eager_ms"], graphed_ms=s["graphed_ms"])
                            for s in steps2])
    for s in steps2:
        for k in counters:
            launches[k] += s["launches"][k]
    x1_launches = x1_calls + x1_calls2
    del step, eager, densify_step, densify_eager, state, aux, cache, batches, more

    colmap = colmap_phase(torch, cam, rcfg, fargs, extent, counters)
    for k, v in colmap.pop("launches").items():
        launches[k] += v
    snaps["colmap"] = colmap.pop("snap")
    out["colmap"] = colmap
    out["snaps"] = snaps
    out["launches"] = launches
    out["x1_launches"] = x1_launches
    del flush_buf
    return out


def colmap_phase(torch, cam, rcfg, fargs, extent, counters) -> dict:
    """The COLMAP-supervised step (COLMAP_CFG) on the tongue phase's cloud
    in a capacity of COLMAP_CAPACITY:
    a GT cloud of colmap_pcd_samples points drawn from a numpy seed within
    COLMAP_JITTER of alive Gaussians, pcd_valid as COLMAP_VALID (two keys),
    graphed against eager bit for bit; pcd_loss must be non-zero when the
    cloud is valid and 0 when not."""
    from ed3dgs_torch.config.loader import load_full_config
    from ed3dgs_torch.convert import gaussians_from_numpy
    from ed3dgs_torch.models.gaussians import compute_3d_filter
    from ed3dgs_torch.train.trainer import (KNN_CAPS_DEFAULT, init_train_state,
                                            make_train_step, refresh_knn_cache)
    cfg = load_full_config(os.path.join(REPO, COLMAP_CFG))
    setup = train_setup(cfg, rcfg)
    if not setup.colmap_supervision or setup.tongue_enabled:
        fail(f"{COLMAP_CFG}: COLMAP supervision is not on, or the tongue terms are")
    gparams, aux = gaussians_from_numpy(tongue_cloud(N_GAUSS), capacity=COLMAP_CAPACITY,
                                        device=DEVICE)
    aux = aux._replace(filter_3d=compute_3d_filter(gparams.xyz, aux.alive, *fargs))
    cache = refresh_knn_cache(gparams, aux, dict(KNN_CAPS_DEFAULT),
                              coverage_target=cfg.opt.knn_coverage_target)
    state, optimizer = init_train_state(gparams, cfg.hidden, cfg.opt, extent, seed=0)
    state = state._replace(iteration=TRAIN_ITERATION)
    n = cfg.model.colmap_pcd_samples
    rng = np.random.default_rng(900)
    xyz = gparams.xyz[aux.alive].cpu().numpy()
    pts = xyz[rng.integers(0, len(xyz), n)] + rng.normal(0, COLMAP_JITTER, (n, 3))
    pts = torch.as_tensor(pts.astype(np.float32), device=DEVICE)
    batches = []
    for i, valid in enumerate(COLMAP_VALID):
        b = make_batch(torch, cam, setup.batch_size, 0.2 + 0.1 * i, False, 900 + i, DEVICE)
        b.update(pcd_points=pts, pcd_valid=valid)
        batches.append(b)
    print(f"colmap step ({COLMAP_CFG}: colmap_supervision, {n} GT points within "
          f"{COLMAP_JITTER} of alive Gaussians, capacity {COLMAP_CAPACITY}, deform_from_iter "
          f"{setup.deform_from_iter}, pcd_valid {list(COLMAP_VALID)})", flush=True)
    eager = make_train_step(setup, optimizer, graph=False)
    step = make_train_step(setup, optimizer)
    _, _, steps = steps_against_eager(torch, eager, step, state, aux, cache, batches, counters,
                                      per_step_launches(setup, counters), "colmap step")
    for valid, s in zip(COLMAP_VALID, steps):
        if (s["metrics"]["pcd_loss"] > 0) != valid or s["metrics"]["pcd_loss"] < 0:
            fail(f"colmap step: pcd_loss {s['metrics']['pcd_loss']} with pcd_valid {valid}")
    out = dict(step_summary(step, steps), samples=n,
               pcd_loss=[s["metrics"]["pcd_loss"] for s in steps],
               steps=[dict(valid=v, eager_ms=s["eager_ms"], graphed_ms=s["graphed_ms"],
                           replay=s["replay"]) for v, s in zip(COLMAP_VALID, steps)],
               launches={k: sum(s["launches"][k] for s in steps) for k in counters})
    print(f"  colmap step: {out}", flush=True)
    out["snap"] = dict(state=state, aux=aux, cache=cache, setup=setup, optimizer=optimizer,
                       batches=batches)
    if out["captures"] != 2:
        fail(f"colmap step: {out['captures']} captures, not one for each pcd_valid")
    return out


def wall_ms_of(torch, fn):
    """(fn(), its wall ms between two synchronises)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def tongue_cli_phase(torch, counters, tmp) -> dict:
    """The tongue cli run, in `tmp`: generate_scene with TONGUE_FRAC on the
    card (segmentations and red seeds), then tools.train.main with
    TONGUE_CFG for TONGUE_CLI_ITERS iterations, crossing one densify event
    and its KNN refresh. Fails on a kernel of K1-K7 that did not launch, a
    count of launches off the steps and refreshes, a loss or tongue term
    that is not finite, a tongue term that stays 0, a tongue count at the
    start other than the red seeds or at the end of 0, or a last window
    whose train PSNR is not above the first's."""
    from ed3dgs_torch.data.ply import fetch_point_cloud
    from ed3dgs_torch.data.synthetic import generate_scene
    from ed3dgs_torch.ops import cuda_lib
    from ed3dgs_torch.tools import train as train_tool
    from ed3dgs_torch.tools.train import TONGUE_TERMS

    out = {}
    scene_dir, model_dir = os.path.join(tmp, "tongue_scene"), os.path.join(tmp, "tongue_model")
    t0 = time.perf_counter()
    generate_scene(scene_dir, n_cams=CLI_CAMS, n_frames=CLI_FRAMES, width=WIDTH, height=HEIGHT,
                   n_points=CLI_POINTS, seed=1, tongue_frac=TONGUE_FRAC, device=DEVICE)
    out["scene_s"] = time.perf_counter() - t0
    _, cols, _ = fetch_point_cloud(os.path.join(scene_dir, "points3D_downsample.ply"))
    red_seeds = int(np.all(np.asarray(cols) == np.array([1.0, 0.0, 0.0]), axis=1).sum())
    argv = ["-s", scene_dir, "-m", model_dir, "--configs", os.path.join(REPO, TONGUE_CFG),
            "--duration", str(CLI_FRAMES), "--test_every", str(CLI_TEST_EVERY), "--quiet",
            "--seed", "0", "--device", DEVICE, "--iterations", str(TONGUE_CLI_ITERS),
            "--set", *TONGUE_CLI_SET]
    keys = ("K1", "K2", "K3", "K4", "K5a", "K5b", "K6", "K7", "X1", "X2")
    t0 = time.perf_counter()
    with cuda_lib.DeviceLaunches() as trace:
        _, _, _, log = train_tool.main(argv)
    out["train_s"] = time.perf_counter() - t0
    launches = card_launches(trace, keys)
    n = len(log["iter_ms"])
    first, last = slice(0, CLI_WINDOW), slice(n - CLI_WINDOW, n)
    mean = lambda xs: float(np.mean(xs))  # noqa: E731
    out.update(
        iterations=n, median_iter_ms=float(np.median(log["iter_ms"])),
        loss_first=mean(log["loss"][first]), loss_last=mean(log["loss"][last]),
        psnr_first=mean(log["psnr"][first]), psnr_last=mean(log["psnr"][last]),
        psnr_by_50=[mean(log["psnr"][i:i + 50]) for i in range(0, n, 50)],
        tongue_terms_last={k: mean(log[k][last]) for k in TONGUE_TERMS},
        red_seeds=red_seeds, total_tongue_start=log["total_tongue"][0],
        total_tongue_end=log["total_tongue"][-1], densify=log["densify"],
        points_start=log["points_start"], points_end=log["points_end"],
        test_psnr=[(int(i), float(v)) for i, v in log["test_psnr"]],
        graph_captures=log["graph_captures"], launches=launches,
        scene_dir=scene_dir, model_dir=model_dir)
    print("tongue cli: " + ", ".join(f"{k}={v}" for k, v in out.items()), flush=True)
    if any(v == 0 for v in launches.values()):
        fail(f"tongue cli: a kernel did not launch: {launches}")
    # two KNN losses and the last camera's two sub-renders a step; X1 once for
    # the initial scales and twice (two graphs) a refresh: the first and one
    # a densify event
    blend = launches["K2"]
    if not (launches["K6"] == launches["K7"] == 2 * n and blend % n == 0 and blend // n >= 3
            and blend == launches["K3"] == launches["K5b"]):
        fail(f"tongue cli: {n} steps launched {launches} on the card")
    if launches["X1"] != 1 + 2 * (1 + len(log["densify"])):
        fail(f"tongue cli: X1 launched {launches['X1']} times, not 1 + 2 a refresh")
    terms = [log[k] for k in TONGUE_TERMS]
    if not all(math.isfinite(x) for xs in [log["loss"], *terms] for x in xs):
        fail("tongue cli: a loss or tongue term is not finite")
    if any(max(xs) <= 0 for xs in terms):
        fail(f"tongue cli: a tongue term stayed 0: {out['tongue_terms_last']}")
    if len(log["densify"]) != 1:
        fail(f"tongue cli: {len(log['densify'])} densify events, not one")
    if log["total_tongue"][0] != red_seeds or log["total_tongue"][-1] <= 0:
        fail(f"tongue cli: tongue Gaussians {log['total_tongue'][0]} at the start (red seeds "
             f"{red_seeds}), {log['total_tongue'][-1]} at the end")
    if not out["psnr_last"] > out["psnr_first"]:
        fail(f"tongue cli: train PSNR did not rise ({out['psnr_first']:.3f} -> "
             f"{out['psnr_last']:.3f})")
    return out


def tongue_serve_phase(torch, counters, tcli) -> dict:
    """tools.render --tongue_renders on the tongue cli run's model (each
    split cut to TONGUE_SERVE_FRAMES, no video): each split's tongue,
    tongue_render and wo_tongue_render directories must hold one PNG a
    view, and each frame must launch K1, X2, K4 and K5a three times on the card
    (the full render and the two filters). Returns the render ms a frame
    for each filter."""
    from ed3dgs_torch.models.gaussians import load_ply
    from ed3dgs_torch.ops import cuda_lib
    from ed3dgs_torch.tools import render as render_tool

    model_dir = tcli["model_dir"]
    _, saved = load_ply(os.path.join(model_dir, "point_cloud", f"iteration_{TONGUE_CLI_ITERS}",
                                     "point_cloud.ply"), device="cpu")
    saved_tongue = int((saved.alive & (saved.tongue_class[:, 0] > 0.5)).sum())
    argv = ["-m", model_dir, "-s", tcli["scene_dir"], "--configs",
            os.path.join(REPO, TONGUE_CFG), "--duration", str(CLI_FRAMES), "--iteration",
            str(TONGUE_CLI_ITERS), "--device", DEVICE, "--tongue_renders", "--skip_video",
            "--max_frames", str(TONGUE_SERVE_FRAMES), "--set", *TONGUE_CLI_SET]
    t0 = time.perf_counter()
    with cuda_lib.DeviceLaunches() as trace:
        stats = render_tool.main(argv)
    render_s = time.perf_counter() - t0
    launches = card_launches(trace, ("K1", "K4", "K5a", "X2"))
    frames = sum(v["frames"] for v in stats.values())
    missing = []
    for split, v in stats.items():
        for sub in ("tongue", "tongue_render", "wo_tongue_render"):
            d = os.path.join(model_dir, split, f"ours_{TONGUE_CLI_ITERS}", sub)
            pngs = (sorted(f for f in os.listdir(d) if f.endswith(".png"))
                    if os.path.isdir(d) else [])
            if pngs != [f"{i:05d}.png" for i in range(v["frames"])]:
                missing.append((split, sub, len(pngs), v["frames"]))
    ms = lambda xs: float(np.median(xs))  # noqa: E731
    out = dict(frames={k: v["frames"] for k, v in stats.items()}, render_s=render_s,
               saved_tongue=saved_tongue,
               render_ms_full=ms([x for v in stats.values() for x in v["render_ms"]]),
               render_ms_only=ms([x for v in stats.values()
                                  for x in v["tongue_render_ms"]["only"]]),
               render_ms_without=ms([x for v in stats.values()
                                     for x in v["tongue_render_ms"]["without"]]),
               save_ms=ms([x for v in stats.values() for x in v["save_ms"]]),
               launches=launches, missing=missing)
    print("tongue serve: " + ", ".join(f"{k}={v}" for k, v in out.items()), flush=True)
    if missing:
        fail(f"tongue serve: PNGs missing: {missing}")
    if saved_tongue == 0:
        fail("tongue serve: the saved model has no tongue Gaussian")
    if launches != {k: 3 * frames for k in launches}:
        fail(f"tongue serve: {frames} frames with two tongue filters launched {launches}")
    return out


def hold_k4(torch, args, kw, flush, reps: int = 50) -> dict:
    """K4 on the recorded binning inputs against its plain version, bit for
    bit (the packed keys), and timed as in 1. Returns its kernels-line row."""
    from ed3dgs_torch.ops import binning_scan
    dv, dpk, total = args
    key = binning_scan.fused_bin_scans(dv, dpk, total, **kw)
    key_plain = binning_scan.fused_bin_scans_plain(dv, dpk, total, **kw)
    err = int((key.to(torch.int64) - key_plain.to(torch.int64)).abs().max())
    K = dv.shape[0]
    print(f"K4 fused_bin_scans: K={K} total={int(total)} key {kw['rank_bits']} + {kw['b']} "
          f"bits max_abs_err={err} (must be 0)", flush=True)
    if err != 0:
        fail("K4 disagrees with its plain version")
    ms = time_ms(torch, lambda: binning_scan.fused_bin_scans(dv, dpk, total, **kw), reps, flush)
    plain = time_ms(torch, lambda: binning_scan.fused_bin_scans_plain(dv, dpk, total, **kw),
                    max(1, reps * 2 // 5), flush)
    b, by = bound(4 * (3 * K + 1), 25 * K)
    return dict(KERNELS["K4"], max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=None, key_bits=kw["rank_bits"] + kw["b"])


def hold_x2(torch, args, kw, flush, reps: int = 50) -> dict:
    """X2 on the recorded binning inputs (the depth-ranked rows and their
    offsets) against its plain version, bit for bit (both delta streams),
    and timed as in 1, beside the library yardstick: torch.cummax three
    times over the rows' words, as the plain version scans them. Returns its
    kernels-line row."""
    from ed3dgs_torch.ops import binning_scan
    rows, offsets = args
    got = binning_scan.boundary_deltas(rows, offsets, **kw)
    want = binning_scan.boundary_deltas_plain(rows, offsets, **kw)
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    N, K = rows.shape[0], kw["pair_capacity"]
    first = offsets - rows[:, 0]
    kept = int(((rows[:, 0] > 0) & (first < K)).sum())
    print(f"X2 boundary_deltas: N={N} K={K} rows with a slot {kept}, offset bits {kw['b']} "
          f"max_abs_err={err} (must be 0)", flush=True)
    if err != 0:
        fail("X2 disagrees with its plain version")
    ms = time_ms(torch, lambda: binning_scan.boundary_deltas(rows, offsets, **kw), reps, flush)
    slow = max(1, reps * 2 // 5)
    plain = time_ms(torch, lambda: binning_scan.boundary_deltas_plain(rows, offsets, **kw),
                    slow, flush)
    word = torch.where(rows[:, 0] > 0, torch.arange(N, dtype=torch.int32, device=rows.device),
                       torch.full_like(rows[:, 0], -1))
    library = time_ms(torch, lambda: [torch.cummax(word, 0) for _ in range(3)], slow, flush)
    # each row's five int32 and its offset read, every slot of both [K]
    # streams written; its integer work, a few operations a row, is far
    # below the bytes' time
    b, by = bound(24 * N + 8 * K, 0)
    return dict(KERNELS["X2"], max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=library, n=N, rows_with_slot=kept)


def hold_k1(torch, args, kw, flush, reps: int = 30) -> tuple:
    """K1 on the recorded blend inputs against its plain version: every
    channel within K1_ATOL + K1_RTOL*|value| on every pixel, the median
    channels flipped on at most K1_MAX_FLIPPED of the pixels; timed as in 1.
    Returns (its kernels-line row, the flipped fraction of each channel,
    the work its bound counts)."""
    from ed3dgs_torch.ops import rasterize_cuda
    pair_payload, tile_start, tile_count = args
    gx, gy, chunk = kw["grid_x"], kw["grid_y"], kw["chunk"]
    packed = rasterize_cuda.rasterize_forward(pair_payload, tile_start, tile_count, **kw)
    stats = {}
    packed_plain = rasterize_cuda.rasterize_forward_plain(
        pair_payload, tile_start, tile_count, stats=stats, **kw)
    a = packed[:, :gx, :rasterize_cuda.OUT_DIM].permute(2, 0, 1, 3).reshape(
        rasterize_cuda.OUT_DIM, -1)
    b = packed_plain[:, :gx, :rasterize_cuda.OUT_DIM].permute(2, 0, 1, 3).reshape(
        rasterize_cuda.OUT_DIM, -1)
    if not bool(torch.isfinite(a).all()):
        fail("K1 wrote non-finite values")
    diff = (a - b).abs()
    off = diff > K1_ATOL + K1_RTOL * b.abs()
    flipped = off.float().mean(1)
    err = float(diff.max())
    names = [n for n, s in rasterize_cuda.OUT_CHANNELS.items() for _ in range(s.start, s.stop)]
    median_ch = [ch for ch, n in enumerate(names) if n in ("mcoord", "mdepth")]
    for ch in range(rasterize_cuda.OUT_DIM):
        print(f"  K1 ch{ch:2d} {names[ch]:10s} max|diff|={float(diff[ch].max()):.3e} "
              f"outside tol: {float(flipped[ch]):.2e}")
    worst_median = float(flipped[median_ch].max())
    off_other = int(sum(int(off[ch].sum()) for ch in range(rasterize_cuda.OUT_DIM)
                        if ch not in median_ch))
    print(f"K1 forward_blend: tiles={gx * gy} pairs={int(tile_count.sum())} chunk={chunk} "
          f"max_abs_err={err:.3e}; outside {K1_ATOL}+{K1_RTOL}*|v|: {off_other} values "
          f"of the non-median channels (must be 0), worst median-channel fraction "
          f"{worst_median:.2e} (limit {K1_MAX_FLIPPED})", flush=True)
    if off_other or worst_median > K1_MAX_FLIPPED:
        fail("K1 disagrees with its plain version")
    del packed, packed_plain, a, b, diff, off
    ms = time_ms(torch, lambda: rasterize_cuda.rasterize_forward(
        pair_payload, tile_start, tile_count, **kw), reps, flush)
    plain = time_ms(torch, lambda: rasterize_cuda.rasterize_forward_plain(
        pair_payload, tile_start, tile_count, **kw), 3, flush)
    rows_read = int(torch.clamp_max(tile_count, chunk * rasterize_cuda.MAX_CHUNKS).sum())
    nbytes = (rows_read * pair_payload.shape[1] * 4 + 2 * 4 * gx * gy
              + gx * gy * rasterize_cuda.OUT_PAD * 256 * 4)
    ops = K1_OPS_PER_EVAL * stats["evals"] + K1_OPS_PER_INCLUDE * stats["includes"]
    b1, by1 = bound(nbytes, ops)
    print(f"  K1 work: rows read {rows_read}, pair-pixel evaluations {stats['evals']}, "
          f"blended {stats['includes']}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP")
    info = rasterize_cuda.kernel_info("rasterize_forward", chunk)
    print(f"  K1 {ms:.4f} ms; {info}", flush=True)
    row = dict(KERNELS["K1"], max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b1,
               bound_by=by1, library_ms=None, **info)
    return (row, {names[c]: float(flipped[c]) for c in range(len(names))},
            dict(rows_read=rows_read, bytes=nbytes, ops=ops, **stats))


def hold_k5a(torch, packed, flush, reps: int = 50) -> dict:
    """K5a on the recorded tiles against its plain version, bit for bit;
    timed as in 1 beside `permute`. Returns its kernels-line row."""
    from ed3dgs_torch.ops import relayout
    img = relayout.unpack_image(packed)
    img_plain = relayout.unpack_image_plain(packed)
    same = torch.equal(img.view(torch.int32), img_plain.view(torch.int32))
    print(f"K5a unpack_image: {tuple(packed.shape)} -> {tuple(img.shape)} bit-exact={same}",
          flush=True)
    if not same:
        fail("K5a disagrees with its plain version")
    gy, gxp, C, _ = packed.shape

    def library():
        return (packed.reshape(gy, gxp, C, 16, 16).permute(2, 0, 3, 1, 4)
                .reshape(C, gy * 16, gxp * 16).contiguous())
    ms = time_ms(torch, lambda: relayout.unpack_image(packed), reps, flush)
    plain = time_ms(torch, lambda: relayout.unpack_image_plain(packed), reps, flush)
    lib = time_ms(torch, library, reps, flush)
    b, by = bound(2 * packed.numel() * 4, 0)
    return dict(KERNELS["K5a"], max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)


def hold_k5b(torch, img_cot, flush, reps: int = 50) -> dict:
    """K5b on the recorded image cotangent against its plain version, bit
    for bit; timed as in 1 beside `permute`. Returns its kernels-line row."""
    from ed3dgs_torch.ops import relayout
    pk = relayout.pack_image(img_cot)
    pk_plain = relayout.pack_image_plain(img_cot)
    same = torch.equal(pk.view(torch.int32), pk_plain.view(torch.int32))
    print(f"K5b pack_image: {tuple(img_cot.shape)} -> {tuple(pk.shape)} bit-exact={same}",
          flush=True)
    if not same:
        fail("K5b disagrees with its plain version")
    C, H, W = img_cot.shape

    def library():
        return (img_cot.reshape(C, H // 16, 16, W // 16, 16).permute(1, 3, 0, 2, 4)
                .reshape(H // 16, W // 16, C, 256).contiguous())
    ms = time_ms(torch, lambda: relayout.pack_image(img_cot), reps, flush)
    plain = time_ms(torch, lambda: relayout.pack_image_plain(img_cot), reps, flush)
    lib = time_ms(torch, library, reps, flush)
    b, by = bound(2 * img_cot.numel() * 4, 0)
    return dict(KERNELS["K5b"], max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)


def hold_k2(torch, args, kw, flush, reps: int = 20) -> tuple:
    """K2 on the recorded backward inputs against its plain version: the
    live-chunk counts exactly and every row of every tile within K2_REL of
    its column's largest value; timed as in 1. Returns (its kernels-line
    row, the work its bound counts)."""
    from ed3dgs_torch.ops import rasterize_cuda
    pp, ts, tc, packed, cot = args
    chunk = kw["chunk"]
    dpay, live = rasterize_cuda.rasterize_backward(pp, ts, tc, packed, cot, **kw)
    dpay_plain, live_plain = rasterize_cuda.rasterize_backward_plain(
        pp, ts, tc, packed, cot, **kw)
    total = int(tc.sum())     # K2 writes every row of every tile
    got, want = dpay[:total], dpay_plain[:total]
    col_max = want.abs().amax(dim=0)
    col_err = (got - want).abs().amax(dim=0)
    live_same = torch.equal(live, live_plain)
    err = float(col_err.max())
    worst = float((col_err / torch.clamp_min(col_max, 1e-30)).max())
    print(f"K2 backward_blend: tiles={ts.numel()} pair rows={total} live_chunks "
          f"equal={live_same} max_abs_err={err:.3e} worst column error / column max "
          f"{worst:.3e} (limit {K2_REL})", flush=True)
    if not live_same or not bool(torch.isfinite(got).all()) or not bool(
            (col_err <= K2_REL * col_max).all()):
        fail("K2 disagrees with its plain version")
    del dpay, dpay_plain, got, want
    ms = time_ms(torch, lambda: rasterize_cuda.rasterize_backward(
        pp, ts, tc, packed, cot, **kw), reps, flush)
    plain = time_ms(torch, lambda: rasterize_cuda.rasterize_backward_plain(
        pp, ts, tc, packed, cot, **kw), 2, flush)
    stats = {}
    rasterize_cuda.rasterize_forward_plain(pp, ts, tc, stats=stats, **kw)
    # the live rows read, the gradient rows written, the channels read, the
    # tile bounds read and the live-chunk counts written
    rows_live = int(torch.minimum(torch.clamp_max(tc, chunk * rasterize_cuda.MAX_CHUNKS),
                                  live * chunk).sum())
    ntiles = ts.numel()
    nbytes = ((rows_live + total) * pp.shape[1] * 4 + K2_CHANNELS_READ * ntiles * 256 * 4
              + 2 * 4 * ntiles + 4 * ntiles)
    ops = K2_OPS_PER_EVAL * stats["evals"] + K2_OPS_PER_INCLUDE * stats["includes"]
    b2, by2 = bound(nbytes, ops)
    print(f"  K2 work: live rows {rows_live}, pair-pixel evaluations {stats['evals']}, "
          f"blended {stats['includes']}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP",
          flush=True)
    info = rasterize_cuda.kernel_info("rasterize_backward", chunk)
    print(f"  K2 {ms:.4f} ms; {info}", flush=True)
    row = dict(KERNELS["K2"], max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b2,
               bound_by=by2, library_ms=None, **info)
    return row, dict(rows_live=rows_live, rows=total, bytes=nbytes, ops=ops, **stats)


def hold_k3(torch, args, flush, reps: int = 50) -> dict:
    """K3 as the main path calls it (the pair-gradient rows read through
    the inverse of the pair permutation) and on the gathered rows, each
    against its plain version within K3_REL of the largest output; timed as
    in 1 beside the gather then K3, and `torch.segment_reduce` on the same
    contiguous segments. Returns {"row": its kernels-line row, "work",
    and for K8 (the same kernel on K3's own function): "rows" (the
    gathered rows), "starts", "ends", "want" (the plain output), "scale",
    "rows_plain_ms", "rows_bound" (ms, by), "library_ms"}."""
    from ed3dgs_torch.ops import segment_sum
    src, idx, st, en = args
    out = segment_sum.segment_sum_rows_gathered(src, idx, st, en)
    want = segment_sum.segment_sum_rows_gathered_plain(src, idx, st, en)
    err = float((out - want).abs().max())
    scale = float(want.abs().max())
    print(f"K3 segment_sum_rows_gathered: rows {tuple(src.shape)} through idx "
          f"{tuple(idx.shape)}, segments {st.numel()} max_abs_err={err:.3e} "
          f"(limit {K3_REL} x {scale:.3e})", flush=True)
    if not err <= K3_REL * scale or not bool(torch.isfinite(out).all()):
        fail("K3 (gathered) disagrees with its plain version")
    # and K3's own function on the gathered rows, as the unfolded path ran it
    rows = src[idx.long()]
    out_r = segment_sum.segment_sum_rows(rows, st, en)
    err_r = float((out_r - want).abs().max())
    print(f"K3 segment_sum_rows: rows {tuple(rows.shape)} max_abs_err={err_r:.3e} "
          f"(limit {K3_REL} x {scale:.3e})", flush=True)
    if not err_r <= K3_REL * scale or not bool(torch.isfinite(out_r).all()):
        fail("K3 disagrees with its plain version")
    ms = time_ms(torch, lambda: segment_sum.segment_sum_rows_gathered(src, idx, st, en),
                 reps, flush)
    plain = time_ms(torch, lambda: segment_sum.segment_sum_rows_gathered_plain(
        src, idx, st, en), max(1, reps * 2 // 5), flush)
    ms_r = time_ms(torch, lambda: segment_sum.segment_sum_rows(rows, st, en), reps, flush)
    plain_r = time_ms(torch, lambda: segment_sum.segment_sum_rows_plain(rows, st, en),
                      max(1, reps * 2 // 5), flush)
    unfolded = time_ms(torch, lambda: segment_sum.segment_sum_rows(src[idx.long()], st, en),
                       reps, flush)
    summed = int((en - st).sum())
    # the library yardstick: one segment_reduce over the same contiguous
    # segments of the gathered rows (the binning's CSR bounds tile the rows
    # from 0 without gaps)
    contiguous = bool((st[1:] == en[:-1]).all()) and int(st[0]) == 0
    lib = None
    if contiguous:
        lengths = (en - st).long()
        data = rows[:summed]
        lib_out = torch.segment_reduce(data, "sum", lengths=lengths, axis=0)
        print(f"  K3 library segment_reduce max|diff| {float((lib_out - out).abs().max()):.3e}",
              flush=True)
        lib = time_ms(torch, lambda: torch.segment_reduce(data, "sum", lengths=lengths,
                                                           axis=0), reps, flush)
        del lib_out, data
    F = src.shape[1]
    out_bytes = 2 * 4 * st.numel() + out.numel() * 4
    b_r, by_r = bound(summed * F * 4 + out_bytes, summed * F)
    # the gathered call reads the index of every summed row and the whole
    # 32-byte sectors its rows cover in src
    used = idx[int(st[0]):int(en[-1])].long()
    first_sec = used * (F * 4) // 32
    last_sec = (used * (F * 4) + F * 4 - 1) // 32
    covered = torch.zeros(int(last_sec.max()) + 1, dtype=torch.bool, device=src.device)
    for k in range(int((last_sec - first_sec).max()) + 1):   # a sector counts once
        sec = first_sec + k
        covered[sec[sec <= last_sec]] = True
    n_sec = int(covered.sum())
    del used, first_sec, last_sec, covered, out, out_r
    b3, by3 = bound(summed * 4 + n_sec * 32 + out_bytes, summed * F)
    print(f"  K3 gathered {ms:.5f} ms (bound {b3:.5f}, {n_sec} sectors), K3 on the rows "
          f"{ms_r:.5f} ms (bound {b_r:.5f}), gather + K3 {unfolded:.5f} ms; plain "
          f"{plain:.4f} / {plain_r:.4f} ms; segment_reduce {lib}", flush=True)
    row = dict(KERNELS["K3"], max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b3,
               bound_by=by3, library_ms=lib, rows_ms=ms_r, rows_plain_ms=plain_r,
               rows_bound_ms=b_r, rows_max_abs_err=err_r, gather_then_rows_ms=unfolded)
    return dict(row=row, work=dict(rows=summed, sectors=n_sec, segments=st.numel()),
                rows=rows, starts=st, ends=en, want=want, scale=scale,
                rows_plain_ms=plain_r, rows_bound=(b_r, by_r), library_ms=lib)


def family_cloud(n: int, cam, seed: int = 0) -> dict:
    """bench_cloud's fields with its means spread over the frustum of `cam`
    (depth 1.2-3.5 in front of it, across its whole width and height) and
    its log-scales about FAM_LOG_SCALE."""
    fields = bench_cloud(n, seed)
    rng = np.random.default_rng(seed + 3)
    z = rng.uniform(1.2, 3.5, n)
    fields["xyz"] = np.stack([rng.uniform(-1, 1, n) * z * cam.tan_fovx,
                              rng.uniform(-1, 1, n) * z * cam.tan_fovy, z], 1).astype(np.float32)
    fields["scaling"] = rng.normal(FAM_LOG_SCALE, 0.5, (n, 3)).astype(np.float32)
    return fields


def schedule_keys(cfg, setup) -> dict:
    """{StepBranches: the first iteration (the state's count) that meets
    it} over the config's whole schedule, the SSIM gate drawn by
    CameraSampler as tools/train.py draws it (tests/test_torch_families.py
    pins each family's set)."""
    from ed3dgs_torch.train import sampling
    from ed3dgs_torch.train.trainer import step_branches
    opt = cfg.opt
    sampler = sampling.CameraSampler(
        num_cams=1, maxtime=opt.maxtime, camera_centers=np.zeros((1, 3)),
        batch_size=opt.batch_size, random_until=opt.random_until,
        num_multiview_ssim=opt.num_multiview_ssim, seed=0)
    keys = {}
    # the cameras and frames drawn do not enter the gate: cheap stand-ins
    # for the walk and the error-CDF draw (its percentiles are most of a
    # sample's time) keep the scan to seconds
    walk, by_error = sampling.sample_camera_walk, sampling.sample_frames_by_error
    sampling.sample_camera_walk = lambda *a: 0
    sampling.sample_frames_by_error = lambda batch, *a: np.zeros(batch, np.int64)
    try:
        for iteration in range(1, opt.iterations + 1):
            _, _, use_ssim = sampler.sample(iteration, opt.iterations)
            keys.setdefault(step_branches(setup, iteration - 1,
                                          {"use_ssim": use_ssim, "pcd_valid": True}),
                            iteration - 1)
    finally:
        sampling.sample_camera_walk, sampling.sample_frames_by_error = walk, by_error
    return keys


def densify_against_eager(torch, state, aux, opt, extent, thresholds, what):
    """make_densify_step eager, then graphed twice (its first call runs
    eagerly and captures, the second replays), each from one state with a
    generator of one seed, at each of `thresholds` in turn until one clones
    or splits: bit for bit (parameters, aux, every Adam moment, the
    counts), each timed by CUDA events and on the host. Returns (state,
    aux, one record a threshold, the graphed densify step); fails where
    none clones or splits."""
    from ed3dgs_torch.train.trainer import make_densify_step
    graphed = make_densify_step(opt, opt.percent_dense, extent)
    eager = make_densify_step(opt, opt.percent_dense, extent, graph=False)
    n_before = int(aux.alive.sum())

    def timed(fn, thr):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        res = fn(state, aux, torch.Generator(device=DEVICE).manual_seed(0), thr)
        end.record()
        torch.cuda.synchronize()
        return res, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3
    records = []
    for thr in thresholds:
        (e_state, e_aux, e_c, e_s), e_ms, e_host = timed(eager, thr)
        want = densify_tensors(torch, e_state, e_aux, e_c, e_s)
        del e_state, e_aux
        runs = []
        for _ in range(2):
            (g_state, g_aux, n_c, n_s), ms, host_ms = timed(graphed, thr)
            got = densify_tensors(torch, g_state, g_aux, n_c, n_s)
            runs.append(dict(ms=ms, host_ms=host_ms,
                             differ=sorted(k for k in want if not torch.equal(want[k], got[k]))))
            del got
        del want
        n_after = int(g_aux.alive.sum())
        same = not any(r["differ"] for r in runs)
        records.append(dict(threshold=thr, n_cloned=int(n_c), n_split=int(n_s),
                            alive_before=n_before, alive_after=n_after, ms=runs[1]["ms"],
                            host_ms=runs[1]["host_ms"], eager_ms=e_ms, eager_host_ms=e_host,
                            first_call_ms=runs[0]["ms"], first_call_host_ms=runs[0]["host_ms"],
                            graphed_equals_eager=same))
        print(f"{what} densify step at the threshold {thr:.3e} (percent_dense "
              f"{opt.percent_dense}, extent {extent:.4f}): n_cloned {int(n_c)}, n_split "
              f"{int(n_s)}, alive {n_before} -> {n_after} of {aux.alive.shape[0]}; eager "
              f"{e_ms:.3f} ms (CUDA events), host wall {e_host:.3f} ms; graphed: "
              + "; ".join(f"{run} {r['ms']:.3f} ms (events), host wall {r['host_ms']:.3f} ms"
                          for run, r in zip(("first call", "again"), runs))
              + f"; graphed bit-identical to eager (params, aux, moments, counts)={same}"
              + "".join(f"; differs in {r['differ'][:6]}" for r in runs if r["differ"]),
              flush=True)
        if not same:
            fail(f"{what}: the graphed densify step differs from the eager one")
        if n_after != n_before + int(n_c) + int(n_s):
            fail(f"{what}: the densify step lost count of the Gaussians it added")
        if n_after > n_before:
            return g_state, g_aux, records, graphed
    fail(f"{what}: no densify step cloned or split")


def family_step_phase(torch, fam, counters) -> dict:
    """5c (a): one family's per-scene config at full width on FAM_N
    Gaussians in FAM_CAPACITY slots spread over its camera's frustum, at its
    reader's frame size (and principal point): the pair capacity sized as
    tools.train sizes it, K1-K5b held to their plain versions on a step's
    inputs, the graphed step against the eager one over every key of the
    config's schedule, a densify, both refreshes and FAM_MORE replays."""
    from ed3dgs_torch.config.loader import load_full_config
    from ed3dgs_torch.convert import gaussians_from_numpy
    from ed3dgs_torch.models.gaussians import compute_3d_filter
    from ed3dgs_torch.ops import binning, cuda_lib, knn, rasterize, relayout
    from ed3dgs_torch.render import raster_config_from_camera
    from ed3dgs_torch.train import trainer as trainer_mod
    from ed3dgs_torch.train.capacity import CapacityPolicy
    from ed3dgs_torch.train.trainer import (KNN_CAPS_DEFAULT, init_train_state,
                                            make_train_step, refresh_knn_cache)

    name = fam["name"]
    cfg = load_full_config(os.path.join(REPO, fam["cfg"]))
    hidden, opt = cfg.hidden, cfg.opt
    W, H = fam["size"]
    cam_kw = dict(cx_ratio=fam["pp"], cy_ratio=-fam["pp"]) if fam["pp"] else {}
    cam = bench_camera(W, H, **cam_kw)
    rcfg = raster_config_from_camera(cam, pair_capacity=opt.pair_capacity,
                                     chunk=opt.raster_chunk)
    setup = train_setup(cfg, rcfg)
    B = setup.batch_size
    out = dict(config=fam["cfg"], size=[W, H], batch=B, n=FAM_N, capacity=FAM_CAPACITY,
               structure=dict(defor_depth=hidden.defor_depth, no_do=hidden.no_do,
                              no_dc=hidden.no_dc, zero_temporal=hidden.zero_temporal,
                              use_anneal=hidden.use_anneal,
                              no_c2f=hidden.no_c2f_temporal_embedding,
                              lambda_dssim=opt.lambda_dssim,
                              tv_temporal=opt.coef_tv_temporal_embedding,
                              reg_coef=opt.reg_coef, principal_point=fam["pp"]))
    print(f"families, {name} ({fam['cfg']}): {W}x{H}, batch {B}, net_width "
          f"{hidden.net_width}, temporal {hidden.temporal_embedding_dim}, embedding "
          f"{hidden.gaussian_embedding_dim}, bf16 {hidden.bf16_activations}, SH "
          f"{cfg.model.sh_degree}; {out['structure']}", flush=True)
    t_phase = time.perf_counter()
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    flush = flush_buf.zero_
    params, aux = gaussians_from_numpy(family_cloud(FAM_N, cam), capacity=FAM_CAPACITY,
                                       device=DEVICE)
    fargs, extent = filter_cameras(torch, DEVICE, W, H, **cam_kw)
    aux = aux._replace(filter_3d=compute_3d_filter(params.xyz, aux.alive, *fargs))
    caps = dict(KNN_CAPS_DEFAULT)
    knn.knn.launches = 0
    cache = refresh_knn_cache(params, aux, caps, coverage_target=opt.knn_coverage_target)
    if knn.knn.launches != 1:
        fail(f"{name}: the KNN refresh launched X1 {knn.knn.launches} times, not once")
    state, optimizer = init_train_state(params, hidden, opt, extent, seed=0)
    keys = schedule_keys(cfg, setup)
    it_all = max(keys.values()) + 3       # every term live, as at TRAIN_ITERATION
    state = state._replace(iteration=it_all)

    # the pair capacity as tools.train moves it: one eager step at the
    # config's, its demand handed to CapacityPolicy window after window
    # until the policy settles (a grow at once, a shrink after its patience)
    sizing = make_train_step(setup, optimizer, graph=False)
    _, _, m0 = sizing(state, aux, make_batch(torch, cam, B, 0.3, False, 1000, DEVICE), cache)
    demand = int(m0["num_pairs"])
    policy = CapacityPolicy(capacity=rcfg.pair_capacity)
    policy.start(0)
    moves = []
    for w in range(policy.shrink_patience + 1):
        want = policy.observe(policy._next_check, demand)
        if want is not None:
            moves.append(want)
    del sizing, m0
    out["pairs"] = dict(demand=demand, config=rcfg.pair_capacity, moves=moves,
                        capacity=policy.capacity)
    rcfg = dataclasses.replace(rcfg, pair_capacity=policy.capacity)
    setup = dataclasses.replace(setup, raster=rcfg)
    print(f"  pairs a step {demand} at the config's capacity {out['pairs']['config']}: "
          f"CapacityPolicy moves {moves} -> {policy.capacity}", flush=True)

    # K1-K5b and X2 on the inputs of one eager step at the settled capacity
    seen = {}
    restore = [recorder(seen, binning, "boundary_deltas", "X2"),
               recorder(seen, binning, "fused_bin_scans", "K4"),
               recorder(seen, rasterize, "rasterize_forward", "K1"),
               recorder(seen, relayout, "unpack_image", "K5a"),
               recorder(seen, rasterize, "rasterize_backward", "K2"),
               recorder(seen, rasterize, "segment_sum_rows_gathered", "K3"),
               recorder(seen, relayout, "pack_image", "K5b")]
    try:
        make_train_step(setup, optimizer, graph=False)(
            state, aux, make_batch(torch, cam, B, 0.35, True, 1001, DEVICE), cache)
        torch.cuda.synchronize()
    finally:
        for r in restore:
            r()
    # bin_rows launches X2 and K4 only on its packed-key path; the cummax
    # fill takes the shapes whose (tile, rank) key would pass 31 bits
    if set(seen) != {"K1", "K2", "K3", "K4", "K5a", "K5b", "X2"}:
        fail(f"{name}: the step did not reach every blend kernel (no K4: the cummax-fill "
             f"binning): {sorted(seen)}")
    kw4 = seen["K4"][1]
    out["binning"] = dict(path="K4", rank_bits=kw4["rank_bits"], tile_bits=kw4["b"],
                          tiles=kw4["num_tiles"])
    print(f"  binning: {out['binning']}", flush=True)
    torch.set_grad_enabled(False)
    kernels = {"X2": hold_x2(torch, *seen["X2"], flush, FAM_REPS),
               "K4": hold_k4(torch, *seen["K4"], flush, FAM_REPS)}
    kernels["K1"], _, _ = hold_k1(torch, *seen["K1"], flush, FAM_REPS)
    kernels["K5a"] = hold_k5a(torch, seen["K5a"][0][0], flush, FAM_REPS)
    kernels["K5b"] = hold_k5b(torch, seen["K5b"][0][0], flush, FAM_REPS)
    kernels["K2"], _ = hold_k2(torch, *seen["K2"], flush, FAM_REPS)
    kernels["K3"] = hold_k3(torch, seen["K3"][0], flush, FAM_REPS)["row"]
    torch.set_grad_enabled(True)
    del seen
    out["kernels"] = {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "max_abs_err")}
                      for k, v in kernels.items()}
    out["kernels"]["K4"]["key_bits"] = kernels["K4"]["key_bits"]

    # the graphed step against the eager one over every key of the schedule:
    # each key at its first iteration (captures), then again (replays). A
    # step whose pairs pass the capacity grows it at once, as tools.train
    # does (CapacityPolicy), on a new step whose graphs are captured anew,
    # and the sweep starts again from the state it reached
    per_step = per_step_launches(setup, counters)
    order = sorted(keys.items(), key=lambda kv: kv[1])
    plan = [(it, k.use_ssim) for k, it in order] + [(it + 1, k.use_ssim) for k, it in order]
    every, grown = [], []
    for sweep in range(FAM_SWEEPS):
        eager = make_train_step(setup, optimizer, graph=False)
        step = make_train_step(setup, optimizer)
        steps, n_grown = [], len(grown)
        for i, (it, ssim) in enumerate(plan):
            b = make_batch(torch, cam, B, 0.05 + 0.9 * i / len(plan), ssim,
                           1100 + 100 * sweep + i, DEVICE)
            state, aux, rec = steps_against_eager(
                torch, eager, step, state, aux, cache, [b], counters, per_step,
                f"{name} step", iterations=[it])
            steps += rec
            demand = int(rec[0]["metrics"]["num_pairs"])
            if demand > rcfg.pair_capacity:
                want = policy.observe(-1, demand)      # grows at once
                grown.append(dict(iteration=rec[0]["iteration"], pairs=demand,
                                  capacity=rcfg.pair_capacity, to=want,
                                  pool_bytes=step.graphs.pool_bytes))
                print(f"  {name}: pairs {demand} passed the capacity {rcfg.pair_capacity} at "
                      f"iteration {rec[0]['iteration']}: grown to {want}, a new step and "
                      "its captures", flush=True)
                rcfg = dataclasses.replace(rcfg, pair_capacity=want)
                setup = dataclasses.replace(setup, raster=rcfg)
                break
        every += steps
        if len(grown) == n_grown:
            break
        del step, eager
    else:
        fail(f"{name}: the pair demand passed the capacity in each of {FAM_SWEEPS} sweeps")
    out["pairs"]["grown"] = grown
    met = {trainer_mod.step_branches(setup, s["iteration"], {"use_ssim": s["ssim"],
                                                             "pcd_valid": True})
           for s in steps}
    if met != set(keys) or sum(s["replay"] for s in steps) != len(keys):
        fail(f"{name}: the steps met {len(met)} of the schedule's {len(keys)} keys with "
             f"{sum(s['replay'] for s in steps)} replays")
    for s in steps:
        m = s["metrics"]
        if m["num_pairs"] > rcfg.pair_capacity or m["tile_overflow"] or m["emb_loss"] <= 0:
            fail(f"{name} step at iteration {s['iteration']}: pairs {m['num_pairs']} of "
                 f"{rcfg.pair_capacity}, tile overflow {m['tile_overflow']}, emb_loss "
                 f"{m['emb_loss']}")
    # the temporal TV term (HyperNeRF) is live once the zero table has moved
    if (opt.coef_tv_temporal_embedding > 0) != any(s["metrics"]["tv_loss"] > 0 for s in steps):
        fail(f"{name}: the temporal TV term is not live as configured "
             f"(coef {opt.coef_tv_temporal_embedding})")
    out["keys"] = [dict(key=list(k), first_iteration=it) for k, it in order]
    out["steps"] = step_summary(step, steps)
    out["steps"]["launches_per_step"] = steps[-1]["launches"]
    out["steps"]["pairs"] = [int(s["metrics"]["num_pairs"]) for s in every]
    out["steps"]["capacity"] = rcfg.pair_capacity
    print(f"  {name} step: {out['steps']}", flush=True)
    launches = {k: sum(s["launches"][k] for s in every) for k in counters}

    # densify at the config's threshold at this iteration, else at the
    # 99.9th percentile of the statistics; then both refreshes and steps
    # that replay known keys on the new cloud and graph
    it = int(state.iteration)
    thr_cfg = (opt.densify_grad_threshold_fine_init
               - it * (opt.densify_grad_threshold_fine_init - opt.densify_grad_threshold_after)
               / opt.densify_until_iter)
    grads = (aux.xyz_grad_accum / aux.denom.clamp_min(1.0))[aux.alive & (aux.denom > 0)]
    q999 = float(torch.quantile(grads, 0.999))
    for fn in counters.values():
        fn.launches = 0
    state, aux, tried, densify = densify_against_eager(
        torch, state, aux, opt, extent, (thr_cfg, q999), name)
    out["densify"] = dict(tried[-1], pool_bytes=densify.graphs.pool_bytes)
    del densify
    aux = aux._replace(filter_3d=compute_3d_filter(state.params["gaussians"].xyz, aux.alive,
                                                   *fargs))
    cache, refresh_ms = wall_ms_of(torch, lambda: refresh_knn_cache(
        state.params["gaussians"], aux, caps, coverage_target=opt.knn_coverage_target))
    if counters["X1"].launches != 1:
        fail(f"{name}: the refresh after the densify launched X1 {counters['X1'].launches} "
             "times, not once")
    n_caps = len(step.graphs.captures)
    last = order[-2:] if len(order) > 1 else order
    more = [make_batch(torch, cam, B, 0.5 + 0.1 * i, k.use_ssim, 1200 + i, DEVICE)
            for i, (k, _) in enumerate(last[:FAM_MORE])]
    state, aux, steps2 = steps_against_eager(
        torch, eager, step, state, aux, cache, more, counters, per_step,
        f"{name} step after densify", iterations=[it + 10 + i for i, (_, it) in
                                                   enumerate(last[:FAM_MORE])])
    if not all(s["replay"] for s in steps2) or len(step.graphs.captures) != n_caps:
        fail(f"{name}: after the densify and refreshes the graphed step did not replay its "
             "known keys")
    for s in steps2:
        for k in counters:
            launches[k] += s["launches"][k]
    out.update(refresh_after_ms=refresh_ms, x1_launches=2, launches=launches,
               steps_after=[dict(eager_ms=s["eager_ms"], graphed_ms=s["graphed_ms"])
                            for s in steps2],
               wall_s=time.perf_counter() - t_phase)
    print(f"  {name}: densify {out['densify']['n_cloned']} cloned, "
          f"{out['densify']['n_split']} split; refresh {refresh_ms:.1f} ms; "
          f"{len(steps2)} replays after it; launches {launches}; {out['wall_s']:.1f} s",
          flush=True)
    del step, eager, state, aux, cache, params, flush_buf, more
    return out


def family_cli_phase(torch, fam, B, bare_step_ms, tmp) -> dict:
    """5c (b) and (c): tools.train.main with the family's per-scene config
    (FAM_CLI_ITERS iterations, only schedule keys cut by FAM_CLI_SET: one
    densify event) on a scene generated on the card at the family's raw
    frame size (FAM_CLI_CAMS cameras of FAM_CLI_FRAMES frames, Technicolor's
    from cam10 with the principal point off centre; FAM_HYPER_FRAMES
    monocular frames in the HyperNeRF layout), then tools.render.main of the
    saved model (FAM_SERVE_FRAMES a split; DyNeRF's spiral video cameras
    too). Fails on a kernel of K1-K7 that did not launch, launches off the
    steps, refreshes and frames, a loss that is not finite, or a PNG
    missing."""
    from ed3dgs_torch.data.synthetic import generate_hyper_scene, generate_scene
    from ed3dgs_torch.ops import cuda_lib
    from ed3dgs_torch.tools import render as render_tool
    from ed3dgs_torch.tools import train as train_tool

    name = fam["name"]
    scene_dir, model_dir = os.path.join(tmp, name), os.path.join(tmp, name + "_model")
    # the scene, generated on the card at the family's raw frame size
    w, h = fam["raw"]
    t0 = time.perf_counter()
    if name == "hypernerf":
        generate_hyper_scene(scene_dir, n_frames=FAM_HYPER_FRAMES, width=w, height=h,
                             n_points=FAM_CLI_POINTS, seed=0, device=DEVICE)
        flags = []          # the reader takes half the ids as the duration
    else:
        generate_scene(scene_dir, n_cams=FAM_CLI_CAMS, n_frames=FAM_CLI_FRAMES, width=w,
                       height=h, n_points=FAM_CLI_POINTS, seed=0, cam_start=fam["cam_start"],
                       principal_point=fam["pp"], device=DEVICE)
        flags = ["--duration", str(FAM_CLI_FRAMES)]
    scene_s = time.perf_counter() - t0
    argv = ["-s", scene_dir, "-m", model_dir, "--configs", os.path.join(REPO, fam["cfg"]),
            *flags, "--test_every", str(FAM_CLI_ITERS // 2), "--quiet", "--seed", "0",
            "--device", DEVICE, "--iterations", str(FAM_CLI_ITERS), "--set", *FAM_CLI_SET]
    keys = ("K1", "K2", "K3", "K4", "K5a", "K5b", "K6", "K7", "X1", "X2")
    t0 = time.perf_counter()
    with cuda_lib.DeviceLaunches() as trace:
        _, state, aux, log = train_tool.main(argv)
    train_s = time.perf_counter() - t0
    launches = card_launches(trace, keys)
    n = len(log["iter_ms"])
    del state, aux
    med = lambda xs: float(np.median(xs)) if xs else None  # noqa: E731
    out = dict(scene_s=scene_s, train_s=train_s, iterations=n,
               median_iter_ms=med(log["iter_ms"]), bare_step_ms=bare_step_ms,
               read_wait_ms=med(log["read_wait_ms"]),
               decode_ms_per_frame=med(log["decode_ms"]),
               stager_wait_ms_per_iter=float(np.sum(log["wait_ms"]) / n),
               loss_first=float(log["loss"][0]), loss_last=float(log["loss"][-1]),
               test_psnr=[(int(i), float(v)) for i, v in log["test_psnr"]],
               points_start=log["points_start"], points_end=log["points_end"],
               densify=log["densify"], capacity=log["capacity"],
               graph_captures=log["graph_captures"], launches=launches)
    print(f"families, {name} cli: " + ", ".join(f"{k}={v}" for k, v in out.items()),
          flush=True)
    if any(v == 0 for v in launches.values()):
        fail(f"{name} cli: a kernel did not launch on the card: {launches}")
    if not (launches["K6"] == launches["K7"] == n and launches["K2"] == B * n
            and launches["K2"] == launches["K3"] == launches["K5b"]):
        fail(f"{name} cli: {n} steps of batch {B} launched {launches} on the card")
    if launches["X1"] != 2 + len(log["densify"]) or len(log["densify"]) != 1:
        fail(f"{name} cli: X1 launched {launches['X1']} times with {len(log['densify'])} "
             "densify events (want one event, and X1 once for the initial scales, once for "
             "the first refresh and once for the event)")
    if not all(math.isfinite(x) for x in log["loss"]):
        fail(f"{name} cli: a loss is not finite")

    # (c) tools.render of the saved model at the same size
    rargv = ["-m", model_dir, "-s", scene_dir, "--configs", os.path.join(REPO, fam["cfg"]),
             *flags, "--iteration", str(FAM_CLI_ITERS), "--device", DEVICE,
             "--max_frames", str(FAM_SERVE_FRAMES), "--set", *FAM_CLI_SET]
    if not fam["video"]:
        rargv.append("--skip_video")
    t0 = time.perf_counter()
    with cuda_lib.DeviceLaunches() as trace:
        stats = render_tool.main(rargv)
    render_s = time.perf_counter() - t0
    rl = card_launches(trace, ("K1", "K4", "K5a", "X2"))
    frames = sum(v["frames"] for v in stats.values())
    missing = []
    for split, v in stats.items():
        d = os.path.join(model_dir, split, f"ours_{FAM_CLI_ITERS}", "renders")
        pngs = sorted(f for f in os.listdir(d) if f.endswith(".png")) if os.path.isdir(d) else []
        if pngs != [f"{i:05d}.png" for i in range(v["frames"])]:
            missing.append((split, len(pngs), v["frames"]))
    out["render"] = dict(frames={k: v["frames"] for k, v in stats.items()}, render_s=render_s,
                         render_ms=med([x for v in stats.values() for x in v["render_ms"][1:]]),
                         save_ms=med([x for v in stats.values() for x in v["save_ms"]]),
                         launches=rl, missing=missing)
    print(f"families, {name} render: {out['render']}", flush=True)
    if missing or (fam["video"] and not stats.get("video", {}).get("frames")):
        fail(f"{name} render: PNGs missing {missing} or no video frames")
    if rl != {k: frames for k in rl}:
        fail(f"{name} render: {frames} frames launched {rl}")
    return out


def families_phase(torch, counters) -> dict:
    """5c: for each of FAMILIES, the step (a) and then tools.train and
    tools.render (b, c) in a temporary directory; each family's graphs and
    buffers are released before the next."""
    import tempfile
    out = {}
    t0 = time.perf_counter()
    for fam in FAMILIES:
        rec = family_step_phase(torch, fam, counters)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix=f"ed3dgs_{fam['name']}_") as tmp:
            rec["cli"] = family_cli_phase(torch, fam, rec["batch"], rec["steps"]["graphed_ms"],
                                          tmp)
        torch.cuda.empty_cache()
        out[fam["name"]] = rec
    out["wall_s"] = time.perf_counter() - t0
    print(f"families phase: {out['wall_s']:.1f} s", flush=True)
    return out


def _scene_cameras(scene_dir, cfg, capacity):
    """The test cameras of the cli phase's scene, read as tools.train reads them."""
    from ed3dgs_torch.data.scene import Scene
    scene = Scene(cfg.model, cfg.hidden, capacity=capacity, duration=CLI_FRAMES, shuffle=False,
                  seed=0, device=DEVICE)
    return list(scene.test_cameras)


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_out"),
                    help="directory for chip_smoke.json, the profiles and ptxas.txt")
    out_dir = ap.parse_args().out

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(REPO, "ed3dgs_torch", "csrc")):
        fail(f"no ed3dgs_torch package beside {__file__}: run it from a checkout")
    sys.path.insert(0, REPO)
    os.makedirs(out_dir, exist_ok=True)

    from ed3dgs_torch.config.loader import load_full_config
    from ed3dgs_torch.convert import gaussians_from_numpy
    from ed3dgs_torch.models.deformation import deform_forward, init_deform_params
    from ed3dgs_torch.models.gaussians import compute_3d_filter, create_from_points, get_features
    from ed3dgs_torch.ops import (binning, binning_scan, cuda_lib, knn, knn_loss, rasterize,
                                  rasterize_cuda, relayout, segment_sum)
    from ed3dgs_torch.train import trainer as trainer_mod
    from ed3dgs_torch.render import raster_config_from_camera, render, settings_from_camera
    from ed3dgs_torch.train.trainer import (KNN_CAPS_DEFAULT, KNN_K, _cache_inputs,
                                            _prepare_cache, init_train_state,
                                            make_loss_and_grads, make_train_step,
                                            refresh_knn_cache, update_knn_cache)
    from ed3dgs_torch.train.densify import densify
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    result = {"card": card, "kind": torch.cuda.get_device_name(0)}
    t_start = time.perf_counter()

    # ---- build ---------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_lib.build()
    result["build_s"] = time.perf_counter() - t0
    print(f"build: {result['build_s']:.1f} s for {sorted(reports) or 'cached'}", flush=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for name, text in reports.items():
            f.write(f"--- {name}\n{text}\n")
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    # ---- the model: nersemble width, bench cloud -------------------------
    cfg = load_full_config(os.path.join(REPO, "configs", "nersemble", "default.py"))
    model, hidden, opt = cfg.model, cfg.hidden, cfg.opt
    fields = bench_cloud(N_GAUSS)
    params, aux = gaussians_from_numpy(fields, capacity=CAPACITY, device=DEVICE)
    dparams = init_deform_params(hidden, seed=0, device=DEVICE)
    cam = bench_camera(WIDTH, HEIGHT)
    rcfg = raster_config_from_camera(cam, pair_capacity=PAIR_CAPACITY, chunk=opt.raster_chunk)
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, device=DEVICE)
    render_kw = dict(iteration=10 ** 9, sh_degree=model.sh_degree,
                     kernel_size=model.kernel_size, disable_filter3d=model.disable_filter3D,
                     num_down_emb_c=hidden.min_embeddings,
                     num_down_emb_f=hidden.min_embeddings)
    print(f"model: net_width={hidden.net_width} defor_depth={hidden.defor_depth} "
          f"temporal={hidden.temporal_embedding_dim} gaussian_emb={hidden.gaussian_embedding_dim} "
          f"max_embeddings={hidden.max_embeddings} bf16={hidden.bf16_activations} "
          f"sh={model.sh_degree} filter3D={not model.disable_filter3D} "
          f"chunk={rcfg.chunk} N={N_GAUSS} cap={CAPACITY} {WIDTH}x{HEIGHT}", flush=True)

    def frame(t, **kw):
        return render(params, aux, dparams, hidden,
                      settings_from_camera(cam, time=t, device=DEVICE), rcfg, bg,
                      **render_kw, **kw)

    # ---- 1. warm-up frame, recording each kernel's inputs ----------------
    seen = {}
    restore = [recorder(seen, binning, "boundary_deltas", "X2"),
               recorder(seen, binning, "fused_bin_scans", "K4"),
               recorder(seen, rasterize, "rasterize_forward", "K1"),
               recorder(seen, relayout, "unpack_image", "K5a")]
    try:
        warm = frame(FRAME_TIMES[0])
        torch.cuda.synchronize()
    finally:
        for r in restore:
            r()
    if set(seen) != {"K1", "K4", "K5a", "X2"}:
        fail(f"the warm-up frame did not reach every forward kernel: {sorted(seen)}")

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    flush = flush_buf.zero_
    rows = {}

    rows["X2"] = hold_x2(torch, *seen["X2"], flush)
    (dv, dpk, total), kw4 = seen["K4"]
    rows["K4"] = hold_k4(torch, (dv, dpk, total), kw4, flush)
    rows["K1"], result["K1_flipped_fraction"], result["K1_work"] = hold_k1(
        torch, *seen["K1"], flush)
    rows["K5a"] = hold_k5a(torch, seen["K5a"][0][0], flush)
    del seen, warm

    # ---- 2. the forward main path: three frames ------------------------------
    for t in FRAME_TIMES:       # warm-up at the frames' own times
        frame(t)
    torch.cuda.synchronize()
    counters = {"K1": rasterize_cuda.rasterize_forward, "K4": binning_scan.fused_bin_scans,
                "K5a": relayout.unpack_image, "X2": binning_scan.boundary_deltas}
    for fn in counters.values():
        fn.launches = 0
    outs, events = [], []
    t_host = time.perf_counter()
    for t in FRAME_TIMES:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(frame(t))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / len(FRAME_TIMES)
    launches = {k: fn.launches for k, fn in counters.items()}
    frame_ms = [s.elapsed_time(e) for s, e in events]
    print(f"render path: {len(FRAME_TIMES)} frames at t={list(FRAME_TIMES)}: "
          f"launches {launches}", flush=True)
    print("  frame ms (CUDA events): " + ", ".join(f"{x:.3f}" for x in frame_ms)
          + f"; host wall {host_ms:.3f} ms/frame", flush=True)
    for k, n in launches.items():
        if n != len(FRAME_TIMES):
            fail(f"{k} launched {n} times in {len(FRAME_TIMES)} frames")
    image_keys = ("render", "mask", "expected_coord", "median_coord", "expected_depth",
                  "median_depth", "normal", "tongue_mask")
    for t, out in zip(FRAME_TIMES, outs):
        for k in image_keys:
            shape = (3 if k in ("render", "expected_coord", "median_coord", "normal") else 1,
                     HEIGHT, WIDTH)
            if tuple(out[k].shape) != shape or not bool(torch.isfinite(out[k]).all()):
                fail(f"frame t={t}: {k} has shape {tuple(out[k].shape)} or non-finite values")
        npairs = int(out["num_pairs"])
        if bool(out["tile_overflow"]) or not 0 < npairs <= PAIR_CAPACITY:
            fail(f"frame t={t}: tile_overflow={bool(out['tile_overflow'])} num_pairs={npairs}")
        print(f"  t={t}: num_pairs={npairs} visible={int(out['visibility_filter'].sum())} "
              f"mask mean={float(out['mask'].mean()):.4f} "
              f"render mean={float(out['render'].mean()):.4f}", flush=True)
    result.update(frame_ms=frame_ms, host_ms_per_frame=host_ms, render_launches=launches,
                  num_pairs=[int(o["num_pairs"]) for o in outs])
    del outs
    prof_frame = profile_window(torch, lambda: frame(FRAME_TIMES[1]),
                                os.path.join(out_dir, "profile_frame.txt"))
    result["profile"] = print_profile("frame", *prof_frame)
    # K4's kernels in the profiled frame (one call): its single pass, or the
    # reduce, scan and decode of the three-launch design
    k4_kernels = sum(n for name, _, n in prof_frame[2]
                     if any(k in name for k in ("scan_decode", "block_sums")))
    memsets = sum(n for name, _, n in prof_frame[2] if "memset" in name.lower())
    print(f"  K4 kernels per call (profiled frame): {k4_kernels}; memsets in the frame "
          f"{memsets}", flush=True)
    rows["K4"]["kernels_per_call"] = k4_kernels

    # ---- 3. the training loop at the config's reg_coef -----------------------
    setup = train_setup(cfg, rcfg)
    B = setup.batch_size
    fargs, extent = filter_cameras(torch, DEVICE)

    def refresh_filter(p, a):
        return a._replace(filter_3d=compute_3d_filter(p.xyz, a.alive, *fargs))

    knn_caps = dict(KNN_CAPS_DEFAULT)

    def refresh_knn(p, a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = refresh_knn_cache(p, a, knn_caps, coverage_target=opt.knn_coverage_target)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        g = cache.graph
        edges = int(a.alive.sum()) * KNN_K
        coverage = 1.0 - int(g.overflow.sum()) / edges
        caps = {k: v for k, v in knn_caps.items() if not k.startswith("_")}
        print(f"  refresh_knn_cache: {wall_ms:.1f} ms wall, buckets {caps}, overflow "
              f"{g.overflow.tolist()}, n_far {int(g.n_far)}, coverage measure "
              f"1 - sum(overflow)/(alive*K) = {coverage:.5f} (target "
              f"{opt.knn_coverage_target})", flush=True)
        if coverage < opt.knn_coverage_target:
            fail("the KNN graph misses its coverage target")
        return cache, dict(wall_ms=wall_ms, caps=caps, overflow=g.overflow.tolist(),
                           n_far=int(g.n_far), coverage=coverage)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aux = refresh_filter(params, aux)
    torch.cuda.synchronize()
    filter_ms = (time.perf_counter() - t0) * 1e3
    f3d = aux.filter_3d[aux.alive]
    print(f"train loop: compute_3d_filter over {len(FILTER_EYES)} cameras {filter_ms:.1f} ms "
          f"wall, filter {float(f3d.min()):.3e}..{float(f3d.max()):.3e}", flush=True)
    if not bool(torch.isfinite(aux.filter_3d).all()) or float(f3d.min()) <= 0:
        fail("compute_3d_filter gave non-finite or non-positive scales")

    # X1 on the refresh's own input (the main graph's points, dead slots
    # parked on the far shell, as _cache_inputs hands them to the search)
    # against knn_plain, then on the edge cases
    seen = {}
    restore = recorder(seen, trainer_mod, "knn_op", "X1")
    try:
        _cache_inputs(params, aux, False, KNN_K)
    finally:
        restore()
    (x1_pts,), x1_kw = seen["X1"]
    x1_k = x1_kw["k"]
    same_x1, err_x1 = x1_against_plain(torch, x1_pts, x1_k)
    n_x1 = x1_pts.shape[0]
    print(f"X1 knn on the refresh's input: {tuple(x1_pts.shape)} k={x1_k} "
          f"(far shell: {n_x1 - int(aux.alive.sum())} rows); equal to knn_plain by "
          f"torch.equal (distances and indices)={same_x1}, max_abs_err={err_x1}", flush=True)
    if not same_x1:
        fail("X1 disagrees with knn_plain on the refresh's input")
    edges_x1 = []
    for kind, n, k_e in X1_EDGES:
        same, err = x1_against_plain(torch, torch.as_tensor(x1_cloud(kind, n), device=DEVICE),
                                        k_e)
        edges_x1.append(dict(cloud=kind, n=n, k=k_e, equal=same))
        if not same:
            fail(f"X1 disagrees with knn_plain on the {kind} cloud, N={n}, k={k_e} "
                 f"(max_abs_err {err})")
    refused = None
    try:
        knn.knn(x1_pts[:100], k=X1_REFUSED)
    except ValueError as e:
        refused = str(e)
    if refused is None:
        fail(f"X1 took k={X1_REFUSED} (k + 1 > {knn.MAX_K1})")
    print(f"  X1 edge cases equal to knn_plain: "
          f"{[(e['cloud'], e['n'], e['k']) for e in edges_x1]}; k={X1_REFUSED} raises: "
          f"{refused}", flush=True)
    ms_x1 = time_ms(torch, lambda: knn.knn(x1_pts, k=x1_k), 10, flush)
    plain_x1 = time_ms(torch, lambda: knn.knn_plain(x1_pts, k=x1_k), 2, flush)
    # the bound from the inputs alone: the points read once, the k nearest's
    # distances and indices written once, and X1_FLOPS_PER_PAIR for each of
    # the N (k + 1) pairs the answer holds. Beside it, as diagnostics, the
    # same flops over the pairs X1 evaluated (the tiles its skip left in)
    # and over all N^2 pairs (the JAX function's work)
    visits_x1 = x1_visits(torch, knn, x1_pts, x1_k)
    x1_bytes = n_x1 * 3 * 4 + n_x1 * x1_k * (4 + 8)
    b_x1, by_x1 = bound(x1_bytes, n_x1 * (x1_k + 1) * X1_FLOPS_PER_PAIR)
    seen_x1, _ = bound(x1_bytes, visits_x1["pairs"] * X1_FLOPS_PER_PAIR)
    all_x1, _ = bound(x1_bytes, n_x1 * n_x1 * X1_FLOPS_PER_PAIR)
    info_x1 = knn.kernel_info(x1_k)
    print(f"  X1 {ms_x1:.4f} ms (bound {b_x1:.4f} ms, {by_x1}; over the {visits_x1['pairs']} "
          f"pairs evaluated {seen_x1:.4f} ms, over all N^2 pairs {all_x1:.4f} ms), knn_plain "
          f"{plain_x1:.1f} ms; "
          f"tiles visited a warp: mean {visits_x1['tiles_mean']:.2f} "
          f"({visits_x1['share_mean']:.4f} of {visits_x1['tiles']}), max "
          f"{visits_x1['tiles_max']} ({visits_x1['share_max']:.4f}); {info_x1}", flush=True)
    big = x1_big_cloud(torch, knn)
    ms_big = time_ms(torch, lambda: knn.knn(big, k=x1_k), 5, flush)
    visits_big = x1_visits(torch, knn, big, x1_k)
    print(f"  X1 at {X1_BIG} points (bench box, {4 * 352} on the far shell): {ms_big:.4f} ms, "
          f"{ms_big / ms_x1:.2f}x the {n_x1}-point time; tiles visited a warp: mean "
          f"{visits_big['tiles_mean']:.2f} ({visits_big['share_mean']:.4f} of "
          f"{visits_big['tiles']}), max {visits_big['tiles_max']}; pairs "
          f"{visits_big['pairs']}", flush=True)
    del big
    rows["X1"] = dict(KERNELS["X1"], max_abs_err=err_x1, ms=ms_x1, plain_ms=plain_x1,
                      bound_ms=b_x1, bound_by=by_x1, library_ms=None, n=n_x1, k=x1_k,
                      evaluated_pairs_bound_ms=seen_x1, all_pairs_bound_ms=all_x1,
                      visits=visits_x1, big_n=X1_BIG,
                      big_ms=ms_big, big_visits=visits_big, edge_cases=edges_x1, **info_x1)
    del seen

    knn_cache, knn_info = refresh_knn(params, aux)
    # the cache built through X1 against one built through knn_plain at the
    # buckets the refresh settled on, tensor for tensor
    trainer_mod.knn_op = knn.knn_plain
    try:
        plain_inputs = _cache_inputs(params, aux, False, KNN_K)
    finally:
        trainer_mod.knn_op = knn.knn
    differ = caches_equal(torch, knn_cache, _prepare_cache(
        plain_inputs, knn_caps["spill_a"], knn_caps["spill_b"], knn_caps["far"]))
    print(f"  the KNN cache through X1 against one through knn_plain: differing fields "
          f"{differ}", flush=True)
    if differ:
        fail(f"the KNN cache built through X1 differs from knn_plain's: {differ}")
    del plain_inputs
    # the refresh's two halves, each ending in a synchronise: the neighbour
    # search (knn_op, inside _cache_inputs) and the graph preparation at the
    # buckets the refresh settled on
    inputs, search_ms = wall_ms_of(torch, lambda: _cache_inputs(params, aux, False, KNN_K))
    _, prepare_ms = wall_ms_of(torch, lambda: _prepare_cache(
        inputs, knn_caps["spill_a"], knn_caps["spill_b"], knn_caps["far"]))
    print(f"  refresh split: neighbour search (_cache_inputs) {search_ms:.1f} ms, graph "
          f"preparation (_prepare_cache) {prepare_ms:.1f} ms wall, beside "
          f"refresh_knn_cache's {knn_info['wall_ms']:.1f} ms", flush=True)
    result["knn_refresh"] = dict(knn_info, filter_ms=filter_ms, search_ms=search_ms,
                                 prepare_ms=prepare_ms)
    del inputs

    state, optimizer = init_train_state(params, hidden, opt, extent, seed=0)
    state = state._replace(iteration=TRAIN_ITERATION)
    # the eager step (graph=False) and the user's default: a CUDA graph per key
    eager = make_train_step(setup, optimizer, graph=False)
    step = make_train_step(setup, optimizer)
    batches = [make_batch(torch, cam, B, 0.1 + 0.2 * i, i in SSIM_STEPS, 100 + i, DEVICE)
               for i in range(TRAIN_STEPS)]
    print(f"train path: batch {B}, iteration {TRAIN_ITERATION}, reg_coef {setup.reg_coef}, "
          f"lambda_dssim {setup.lambda_dssim} (SSIM on steps {list(SSIM_STEPS)}), "
          f"opacity_l1 {setup.opacity_l1_coef}, depth-normal {setup.lambda_depth_normal} "
          f"from {setup.radegs_from_iter}", flush=True)
    seen = {}
    restore = [recorder(seen, rasterize, "rasterize_backward", "K2"),
               recorder(seen, rasterize, "segment_sum_rows_gathered", "K3"),
               recorder(seen, relayout, "pack_image", "K5b"),
               recorder(seen, rasterize, "sorted_payload_grad", "grad"),
               recorder(seen, knn_loss, "knn_rows", "K6"),
               recorder(seen, knn_loss, "knn_reverse", "K7")]
    try:
        state, taux, metrics = eager(state, aux, make_batch(torch, cam, B, 0.05, True, 99,
                                                            DEVICE), knn_cache)
        torch.cuda.synchronize()
    finally:
        for r in restore:
            r()
    if set(seen) != {"K2", "K3", "K5b", "grad", "K6", "K7"}:
        fail(f"the warm-up step did not reach every gradient kernel: {sorted(seen)}")
    counters = {"K1": rasterize_cuda.rasterize_forward, "K2": rasterize_cuda.rasterize_backward,
                "K3": segment_sum.segment_sum_rows, "K4": binning_scan.fused_bin_scans,
                "K5a": relayout.unpack_image, "K5b": relayout.pack_image,
                "K6": knn_loss.knn_rows, "K7": knn_loss.knn_reverse,
                "K8": segment_sum.segment_sum_rows_packed, "X1": knn.knn,
                "X2": binning_scan.boundary_deltas}
    # launches per step (the nersemble default: no tongue graph, so one
    # KNN loss; 5b counts the tongue step's)
    per_step = per_step_launches(setup, counters)

    # (a) the eager step's host-device waits
    result["eager_waits"] = {}
    for what, ssim in (("ssim_off", False), ("ssim_on", True)):
        wb = make_batch(torch, cam, B, 0.3, ssim, 98, DEVICE)
        waits = count_waits(torch, lambda: eager(state, taux, wb, knn_cache))
        places = {}
        for w in waits:
            places[w] = places.get(w, 0) + 1
        print(f"eager step waits (sync debug mode warn), SSIM {what[5:]}: {len(waits)}"
              + "".join(f"\n  {n} x {w}" for w, n in places.items()), flush=True)
        result["eager_waits"][what] = dict(waits=len(waits), places=places)

    # (b) the graphed step against the eager step, bit for bit
    result["graph_vs_eager"] = graph_against_eager(
        torch, eager, step, state, taux, knn_cache, cam, B, setup, counters, per_step)

    def run_steps(step_fn, state, taux, batches, what, count="wrappers"):
        """The steps of `batches` with every count set to 0 just before;
        fails unless each kernel rose by its per-step launches, as its
        wrapper counts them (count="wrappers": the eager step, whose every
        call launches) or as the device counters see them on the card
        (count="device": the graphed step, whose replays call no wrapper)."""
        for fn in counters.values():
            fn.launches = 0
        out, events, enqueue_ms, mallocs = [], [], [], []
        trace = cuda_lib.DeviceLaunches().__enter__()
        t_host = time.perf_counter()
        for b in batches:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            n_malloc = torch.cuda.memory_stats().get("num_device_alloc", 0)
            t0 = time.perf_counter()
            start.record()
            state, taux, metrics = step_fn(state, taux, b, knn_cache)
            end.record()
            enqueue_ms.append((time.perf_counter() - t0) * 1e3)
            mallocs.append(torch.cuda.memory_stats().get("num_device_alloc", 0) - n_malloc)
            events.append((start, end))
            # the graphed step's metrics are its static buffers: keep a copy
            out.append({k: v.clone() for k, v in metrics.items()})
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3 / len(batches)
        trace.__exit__(None, None, None)
        launches = (card_launches(trace, counters) if count == "device" else
                    {k: fn.launches for k, fn in counters.items()})
        print(f"train path, {what}: {len(batches)} steps: launches {launches}"
              + (" (device counters)" if count == "device" else ""), flush=True)
        for k, n in launches.items():
            if n != per_step[k] * len(batches):
                fail(f"{k} launched {n} times in {len(batches)} steps of batch {B} ({what})")
        for i, m in enumerate(out):
            vals = {k: float(m[k]) for k in ("loss", "l1", "ssim", "psnr", "opacity_mean",
                                             "depth_normal", "emb_loss")}
            print(f"  step {i}: " + " ".join(f"{k}={v:.6f}" for k, v in vals.items())
                  + f" num_pairs={int(m['num_pairs'])}", flush=True)
            if not all(math.isfinite(v) for v in vals.values()) or bool(m["tile_overflow"]):
                fail(f"train step {i} ({what}): non-finite metrics or tile overflow")
            if vals["depth_normal"] <= 0 or vals["emb_loss"] <= 0:
                fail(f"train step {i} ({what}): the depth-normal or KNN term is not live")
        step_ms = [s.elapsed_time(e) for s, e in events]
        print("  train-step ms (CUDA events): " + ", ".join(f"{x:.3f}" for x in step_ms)
              + f"; host wall {host_ms:.3f} ms/step; host ms to return from each step "
              + ", ".join(f"{x:.3f}" for x in enqueue_ms)
              + f"; new device allocations (cudaMalloc) in each step {mallocs}", flush=True)
        return state, taux, out, step_ms, host_ms, launches, enqueue_ms

    # (c) the same five steps from one state: eager, then graphed (the main
    # path: the default the tools run)
    start_state, start_aux = state, taux
    _, _, losses_e, step_ms_e, host_ms_e, _, enqueue_e = run_steps(
        eager, start_state, start_aux, batches, "eager, after the first refresh")
    state, taux, losses, step_ms, step_host_ms, train_launches, enqueue_g = run_steps(
        step, start_state, start_aux, batches, "graphed, after the first refresh (main path)",
        count="device")
    same5 = all(torch.equal(a[k], b[k]) for a, b in zip(losses_e, losses) for k in a)
    print(f"  five steps eager against graphed: every metric bit-identical={same5}; median "
          f"ms by events eager {float(np.median(step_ms_e)):.3f}, graphed "
          f"{float(np.median(step_ms)):.3f}; host ms to return eager "
          f"{float(np.median(enqueue_e)):.3f}, graphed {float(np.median(enqueue_g)):.3f}",
          flush=True)
    if not same5:
        fail("the graphed step's metrics differ from the eager step's")
    del start_state, start_aux
    for i, m in enumerate(losses):
        if (i in SSIM_STEPS) == (float(m["ssim"]) == 1.0):
            fail(f"train step {i}: the SSIM term is not live as configured")
    for name, t in list(state.params["gaussians"]._asdict().items()):
        if not bool(torch.isfinite(t).all()):
            fail(f"parameter {name} is not finite after the steps")
    if float(taux.denom.sum()) <= 0 or not bool(torch.isfinite(taux.xyz_grad_accum).all()):
        fail("the densification statistics did not accumulate")
    pbatch = make_batch(torch, cam, B, 0.6, True, 200, DEVICE)
    gprof = profile_window(torch, lambda: step(state, taux, pbatch, knn_cache),
                           os.path.join(out_dir, "profile_step_graphed.txt"))
    result["train_profile_graphed"] = print_profile("graphed train step", *gprof)
    # the profiler's wall includes its own overhead: the idle share against
    # the graphed steps' time by events as well
    idle_events = 1 - gprof[1] / float(np.median(step_ms))
    print(f"  derived idle share (the profiled step's device busy ms over the untraced "
          f"graphed steps' median ms by events, {float(np.median(step_ms)):.3f}): "
          f"{idle_events:.3f}; the profile's own idle share is the one above", flush=True)
    result["train_profile_graphed"]["idle_share_by_events"] = idle_events
    caps = step.graphs.captures
    print(f"  captures of the train step: {len(caps)} keys, seconds each "
          f"{[round(c[1], 3) for c in caps]}, pool bytes {step.graphs.pool_bytes} "
          f"(each: {[c[2] for c in caps]})", flush=True)
    result.update(train_step_ms=step_ms,
                  train_host_ms_per_step=step_host_ms,
                  train_step_ms_eager=step_ms_e, train_host_ms_per_step_eager=host_ms_e,
                  train_enqueue_ms_graphed=enqueue_g, train_enqueue_ms_eager=enqueue_e,
                  train_launches=train_launches,
                  train_losses=[float(m["loss"]) for m in losses],
                  emb_losses=[float(m["emb_loss"]) for m in losses],
                  train_captures=dict(keys=len(caps), seconds=[c[1] for c in caps],
                                      pool_bytes=step.graphs.pool_bytes))
    del losses, losses_e, batches

    # (d) the frame: FrameRenderer's graph against render() op by op
    result["frame_graph"] = frame_against_eager(torch, params, aux, dparams, hidden, model,
                                                rcfg, bg, cam)

    def profiled_step():
        eager(state, taux, pbatch, knn_cache)
    prof = profile_window(torch, profiled_step, os.path.join(out_dir, "profile_step.txt"))
    result["train_profile"] = print_profile("train step", *prof)
    # K6's and K7's device time inside the step (warm L2: the step has just
    # gathered the table they read), per launch
    knn_step_ms = {}
    for k, fn_name in (("K6", "knn_rows"), ("K7", "knn_reverse")):
        hits = [(us, n) for name, us, n in prof[2] if fn_name in name]
        knn_step_ms[k] = (sum(us for us, _ in hits) / 1e3 / max(1, sum(n for _, n in hits))
                          if hits else None)
    print(f"  K6/K7 device ms per launch inside the profiled step: {knn_step_ms}", flush=True)

    # the un-permute folded into K3 against the unfolded redesign (the
    # gather, then K3 on the gathered rows): the profiled step in turns, and
    # the device extent of its backward stage (autograd's whole backward,
    # which holds the inverse permutation, the gather where unfolded, and K3)
    def unfolded(src, idx, starts, ends):
        return segment_sum.segment_sum_rows(src[idx.long()], starts, ends)
    fold = {"folded": [], "unfolded": []}
    for what in ("folded", "unfolded", "folded", "unfolded"):
        if what == "unfolded":
            rasterize.segment_sum_rows_gathered = unfolded
        try:
            f_wall, f_busy, _, f_stages = profile_window(
                torch, profiled_step, os.path.join(out_dir, f"profile_step_{what}.txt"))
        finally:
            rasterize.segment_sum_rows_gathered = segment_sum.segment_sum_rows_gathered
        stage = f_stages.get("backward", {})
        fold[what].append(dict(extent_ms=stage.get("extent_ms"), kernel_ms=stage.get("kernel_ms"),
                               device_busy_ms=f_busy, wall_ms=f_wall))
    print("  backward stage, device extent / kernel ms / step device busy ms: " + "; ".join(
        f"{k} " + ", ".join(f"{x['extent_ms']}/{x['kernel_ms']}/{x['device_busy_ms']:.3f}"
                            for x in v) for k, v in fold.items()), flush=True)
    result["fold"] = fold

    # densify at the config's threshold (tools/train.py:556-567), then the
    # 3D filter and the KNN cache are rebuilt for the new cloud
    thr = (opt.densify_grad_threshold_fine_init
           - TRAIN_ITERATION * (opt.densify_grad_threshold_fine_init
                                - opt.densify_grad_threshold_after) / opt.densify_until_iter)
    n_before = int(taux.alive.sum())
    mean_grad = (taux.xyz_grad_accum / taux.denom.clamp_min(1.0))[taux.alive & (taux.denom > 0)]
    q = torch.quantile(mean_grad, torch.tensor([0.5, 0.99, 0.999], device=mean_grad.device))
    q = q.tolist()
    print(f"densify statistics: mean screen-space gradient norm over {mean_grad.numel()} "
          f"seen Gaussians: median {q[0]:.3e}, 99th percentile {q[1]:.3e}, max "
          f"{float(mean_grad.max()):.3e}; {int((mean_grad >= thr).sum())} at or above the "
          f"config's threshold {thr}; {CAPACITY - n_before} free slots", flush=True)
    # the densification cadence's launches: every count set to 0 here, read
    # after the KNN refresh (X1 once: one search, as the default config has
    # no tongue graph; 5b's refresh searches twice)
    for fn in counters.values():
        fn.launches = 0
    # the config's threshold; if that finds nothing hot (random targets give
    # small screen-space gradients), the 99.9th percentile of the same
    # statistics instead, so that the full-size step clones or splits
    state, taux, densified, densify_step = densify_against_eager(
        torch, state, taux, opt, extent, (thr, q[2]), "train")
    captures = densify_step.graphs.captures
    print(f"  densify graph: {len(captures)} capture(s), "
          f"{sum(c[1] for c in captures):.3f} s with their eager runs, pool "
          f"{densify_step.graphs.pool_bytes} bytes", flush=True)
    t0 = time.perf_counter()
    taux = refresh_filter(state.params["gaussians"], taux)
    torch.cuda.synchronize()
    filter2_ms = (time.perf_counter() - t0) * 1e3
    knn_cache, knn_info2 = refresh_knn(state.params["gaussians"], taux)
    cadence_launches = {k: fn.launches for k, fn in counters.items()}
    print(f"  densify, filter and KNN refresh: launches {cadence_launches}", flush=True)
    if cadence_launches["X1"] != 1:
        fail(f"the KNN refresh after densify launched X1 {cadence_launches['X1']} times, not once")
    more = [make_batch(torch, cam, B, 0.35 + 0.2 * i, False, 400 + i, DEVICE)
            for i in range(MORE_STEPS)]
    # the densified state and the new KNN cache copied into the graphed
    # step's static buffers, against the eager step from the same state
    e_state, _, losses2e, _, _, _, _ = run_steps(
        eager, state, taux, more, "eager, after densify and the refreshes")
    e_params = {k: v.clone() for k, v in e_state.params["gaussians"]._asdict().items()}
    del e_state
    state, taux, losses2, step_ms2, host_ms2, launches2, _ = run_steps(
        step, state, taux, more, "graphed, after densify and the refreshes", count="device")
    same2 = (all(torch.equal(a[k], b[k]) for a, b in zip(losses2e, losses2) for k in a)
             and all(torch.equal(e_params[k], v)
                     for k, v in state.params["gaussians"]._asdict().items()))
    print(f"  after densify: graphed steps (densified state and new KNN cache copied in) "
          f"bit-identical to eager={same2}; captures now {len(step.graphs.captures)}",
          flush=True)
    if not same2:
        fail("after densify the graphed step differs from the eager step")
    result["densify"] = dict(steps=densified, extent=extent, filter_ms=filter2_ms,
                             knn_refresh=knn_info2, launches=cadence_launches,
                             steps_after_ms=step_ms2,
                             steps_after_host_ms=host_ms2, launches_after=launches2,
                             graphed_equals_eager=same2)
    del losses2, losses2e, more, e_params
    # the multi phase starts from this state (after densify and the refreshes)
    snap = dict(state=state, aux=taux, cache=knn_cache, setup=setup, optimizer=optimizer,
                opt=opt, extent=extent)

    # ---- 4. the gradient kernels against their plain versions --------------
    # (the recorded inputs include the forward's saved output, which carries
    # its autograd history: compare without building a graph)
    torch.set_grad_enabled(False)
    rows["K5b"] = hold_k5b(torch, seen["K5b"][0][0], flush)
    rows["K2"], result["K2_work"] = hold_k2(torch, *seen["K2"], flush)
    # K3 as the main path calls it: the pair-gradient rows read through the
    # inverse of the pair permutation (the un-permute folded into the sum)
    k3 = hold_k3(torch, seen["K3"][0], flush)
    rows["K3"], result["K3_work"] = k3["row"], k3["work"]
    rows3, st3, en3, out3_plain, scale3 = (k3[k] for k in ("rows", "starts", "ends", "want",
                                                           "scale"))
    plain3r, (b3r, by3r), lib3 = k3["rows_plain_ms"], k3["rows_bound"], k3["library_ms"]
    del k3

    # K8 is the K3 kernel under its own counter, on K3's own function: the
    # same inputs, the same bound and the same library yardstick
    out8 = segment_sum.segment_sum_rows_packed(rows3, st3, en3)
    err8 = float((out8 - out3_plain).abs().max())
    print(f"K8 segment_sum_rows_packed (the K3 kernel): max_abs_err={err8:.3e} "
          f"(limit {K3_REL} x {scale3:.3e})", flush=True)
    if not err8 <= K3_REL * scale3:
        fail("K8 disagrees with its plain version")
    ms8 = time_ms(torch, lambda: segment_sum.segment_sum_rows_packed(rows3, st3, en3), 50,
                  flush)
    rows["K8"] = dict(KERNELS["K8"], max_abs_err=err8, ms=ms8, plain_ms=plain3r,
                      bound_ms=b3r, bound_by=by3r, library_ms=lib3)
    del out3_plain, out8, rows3

    # K6 -> K7 on the graph and embedding table the warm-up step handed them
    (emb_r, nbr, w_eff, coef), _ = seen["K6"]
    (_, _, _, rev_ptr, rev_pair), _ = seen["K7"]
    Cp, E = emb_r.shape
    K = nbr.shape[1]

    def knn_chain(rows_fn, reverse_fn):
        loss, de, s = rows_fn(emb_r, nbr, w_eff, coef)
        return loss, de, s, reverse_fn(emb_r, s, de, rev_ptr, rev_pair)
    loss6, de6, s6, out7 = knn_chain(knn_loss.knn_rows, knn_loss.knn_reverse)
    again = knn_chain(knn_loss.knn_rows, knn_loss.knn_reverse)
    det_knn = torch.equal(loss6, again[0]) and torch.equal(out7, again[3])
    loss_p, de_p, s_p, out_p = knn_chain(knn_loss.knn_rows_plain, knn_loss.knn_reverse_plain)
    loss_err = abs(float(loss6) - float(loss_p))
    row_max = out_p.abs().amax(dim=1)
    row_err = (out7 - out_p).abs().amax(dim=1)
    worst_row = float((row_err / torch.clamp_min(row_max, 1e-30)).max())
    err6 = float((de6 - de_p).abs().max())
    err7 = float((out7 - knn_loss.knn_reverse_plain(emb_r, s6, de6, rev_ptr, rev_pair))
                 .abs().max())
    n_rev = rev_pair.shape[0]
    loss_rel = loss_err / abs(float(loss_p))
    indeg = (rev_ptr[1:] - rev_ptr[:-1]).float()
    print(f"  K7 in-degree over {Cp} ranks: max {int(indeg.max())}, p99 "
          f"{float(torch.quantile(indeg, 0.99)):.0f}, mean {float(indeg.mean()):.3f}",
          flush=True)
    print(f"K6 knn_rows + K7 knn_reverse: Cp={Cp} K={K} E={E} in-edges {n_rev}; loss "
          f"{float(loss6):.8f} vs plain {float(loss_p):.8f} (rel {loss_rel:.2e}, "
          f"limit {KNN_LOSS_REL}); worst row of dL/demb / its largest value {worst_row:.2e} "
          f"(limit {KNN_ROW_REL}); K6 de max_abs_err {err6:.3e}, K7 max_abs_err {err7:.3e} "
          f"on K6's output; two runs bit-identical={det_knn}", flush=True)
    if (loss_err > KNN_LOSS_REL * abs(float(loss_p)) or not bool(torch.isfinite(out7).all())
            or not bool((row_err <= KNN_ROW_REL * row_max).all())):
        fail("K6/K7 disagree with their plain versions")
    if not det_knn:
        fail("the KNN loss or its gradient differs from run to run")
    ms6 = time_ms(torch, lambda: knn_loss.knn_rows(emb_r, nbr, w_eff, coef), 50, flush)
    plain6 = time_ms(torch, lambda: knn_loss.knn_rows_plain(emb_r, nbr, w_eff, coef), 10, flush)
    ms7 = time_ms(torch, lambda: knn_loss.knn_reverse(emb_r, s6, de6, rev_ptr, rev_pair), 50,
                  flush)
    plain7 = time_ms(torch, lambda: knn_loss.knn_reverse_plain(emb_r, s6, de6, rev_ptr,
                                                                rev_pair), 10, flush)
    # K6 reads the table, the ranks, weights and coef once and writes de, s
    # and the partials; per edge: difference, square and sum over E, the
    # weight, sqrt, the loss term, s, and s * diff summed over E.
    # K7 reads the table, the in-edges' s and pair ids, the bounds and de,
    # and writes the gradient; per in-edge: difference, product, sum over E.
    bytes6 = 4 * (2 * Cp * E + 3 * Cp * K + Cp + -(-Cp // knn_loss.ROWS_PER_BLOCK))
    b6, by6 = bound(bytes6, Cp * K * (5 * E + 8))
    bytes7 = 4 * (3 * Cp * E + 2 * n_rev + Cp + 1)
    b7, by7 = bound(bytes7, n_rev * 3 * E + Cp * E)
    print(f"  K6 work: {bytes6 / 1e6:.1f} MB, {Cp * K * (5 * E + 8) / 1e9:.3f} GFLOP; "
          f"K7 work: {bytes7 / 1e6:.1f} MB, {(n_rev * 3 * E + Cp * E) / 1e9:.3f} GFLOP",
          flush=True)
    info6, info7 = knn_loss.kernel_info("knn_rows", K), knn_loss.kernel_info("knn_reverse", K)
    host6 = host_us(torch, lambda: knn_loss.knn_rows(emb_r, nbr, w_eff, coef))
    host7 = host_us(torch, lambda: knn_loss.knn_reverse(emb_r, s6, de6, rev_ptr, rev_pair))
    print(f"  K6 {ms6:.4f} ms cold, {knn_step_ms['K6']} ms in the step, {host6:.1f} us of "
          f"host a call; {info6}\n"
          f"  K7 {ms7:.4f} ms cold, {knn_step_ms['K7']} ms in the step, {host7:.1f} us of "
          f"host a call; {info7}", flush=True)
    rows["K6"] = dict(KERNELS["K6"], max_abs_err=err6, ms=ms6, plain_ms=plain6,
                      bound_ms=b6, bound_by=by6, library_ms=None, step_ms=knn_step_ms["K6"],
                      host_us=host6, **info6)
    rows["K7"] = dict(KERNELS["K7"], max_abs_err=err7, ms=ms7, plain_ms=plain7,
                      bound_ms=b7, bound_by=by7, library_ms=None, step_ms=knn_step_ms["K7"],
                      host_us=host7, **info7)
    result["knn_kernels"] = dict(Cp=Cp, K=K, E=E, in_edges=n_rev, loss=float(loss6),
                                 loss_plain=float(loss_p), worst_row=worst_row)
    del again, de_p, s_p, out_p, de6, s6, out7

    (gp, gk, gc, gbins, gkw), _ = seen["grad"]
    d_first = rasterize.sorted_payload_grad(gp, gk, gc, gbins, gkw)
    d_again = rasterize.sorted_payload_grad(gp, gk, gc, gbins, gkw)
    det = torch.equal(d_first.view(torch.int32), d_again.view(torch.int32))
    print(f"payload gradient (K2 -> K3 through the index) {tuple(d_first.shape)} run twice: "
          f"bit-identical={det}", flush=True)
    if not det:
        fail("the payload gradient differs from run to run")
    del seen, d_first, d_again, flush_buf
    torch.set_grad_enabled(True)

    # ---- 5. a small cut, card against CPU ---------------------------------
    small = {k: v[:SMALL_N] for k, v in fields.items()}
    deltas = {}
    for dev in (DEVICE, "cpu"):
        sp, _ = gaussians_from_numpy(small, device=dev)
        sd = init_deform_params(hidden, seed=0, device=dev)
        final, (_, orig) = deform_forward(
            sd, hidden, sp.xyz, sp.scaling, sp.rotation, sp.opacity, get_features(sp),
            sp.embedding, 0.5, 10 ** 9, num_down_emb_c=hidden.min_embeddings,
            num_down_emb_f=hidden.min_embeddings)
        deltas[dev] = [(f - o).cpu() for f, o in zip(final, orig)]
    differing = [float(((x - y).abs() > BF16_ATOL).float().mean())
                 for x, y in zip(deltas[DEVICE], deltas["cpu"])]
    print(f"small deformation, bf16={hidden.bf16_activations}: fraction of values "
          f"differing by more than {BF16_ATOL} (xyz, scale, rot, opacity, sh): "
          + ", ".join(f"{d:.2e}" for d in differing) + f" (limit {BF16_MAX_DIFFERING})",
          flush=True)
    if max(differing) > BF16_MAX_DIFFERING:
        fail("small deformation: the card's bf16 MLP disagrees with the CPU's")
    hidden32 = dataclasses.replace(hidden, bf16_activations=False)
    scam = bench_camera(SMALL_W, SMALL_H)
    scfg = raster_config_from_camera(scam, pair_capacity=1 << 16, chunk=opt.raster_chunk)
    got = {}
    for dev in (DEVICE, "cpu"):
        sp, sa = gaussians_from_numpy(small, device=dev)
        sd = init_deform_params(hidden32, seed=0, device=dev)
        got[dev] = render(sp, sa, sd, hidden32,
                          settings_from_camera(scam, time=0.5, device=dev), scfg,
                          bg.to(dev), **render_kw)
    worst = 0.0
    for k in image_keys:
        x, y = got[DEVICE][k].cpu(), got["cpu"][k]
        d = (x - y).abs()
        frac = float((d > SMALL_ATOL + SMALL_RTOL * y.abs()).float().mean())
        limit = SMALL_MAX_FLIPPED if k in MEDIAN_KEYS else 0.0
        worst = max(worst, float(d.max()))
        print(f"  small {k:15s} max|cuda-cpu|={float(d.max()):.3e} "
              f"outside {SMALL_ATOL}+{SMALL_RTOL}*|v|: {frac:.2e} (limit {limit})")
        if not bool(torch.isfinite(x).all()) or frac > limit:
            fail(f"small render: {k} disagrees between the card and the CPU")
    np_cuda, np_cpu = int(got[DEVICE]["num_pairs"]), int(got["cpu"]["num_pairs"])
    print(f"small render {SMALL_N} Gaussians {SMALL_W}x{SMALL_H}: num_pairs cuda={np_cuda} "
          f"cpu={np_cpu}; max|cuda-cpu| {worst:.3e}", flush=True)
    # a splat's tile rect comes from a rounded radius: one may differ by a tile
    if abs(np_cuda - np_cpu) > 0.005 * np_cpu:
        fail("small render: num_pairs disagrees between the card and the CPU")

    # one train step at the config's embedding width and one at E = 16,
    # which the KNN kernels run zero-padded to their 32 columns
    for emb_dim in (hidden32.gaussian_embedding_dim, 16):
        shidden = dataclasses.replace(hidden32, gaussian_embedding_dim=emb_dim)
        sfields = dict(small, embedding=small["embedding"][:, :emb_dim])
        ssetup = dataclasses.replace(train_setup(cfg, scfg), hidden=shidden)
        sgrads, semb = {}, {}
        for dev in (DEVICE, "cpu"):
            sp, sa = gaussians_from_numpy(sfields, device=dev)
            sd = init_deform_params(shidden, seed=0, device=dev)
            scache = update_knn_cache(sp, sa)
            knn_before = knn_loss.knn_rows.launches
            sgrads[dev] = make_loss_and_grads(ssetup)(
                {"gaussians": sp, "deform": sd}, sa,
                make_batch(torch, scam, B, 0.5, True, 300, dev), scache, TRAIN_ITERATION)
            semb[dev] = float(sgrads[dev][1]["emb_loss"])
            if dev == DEVICE and knn_loss.knn_rows.launches == knn_before:
                fail(f"small train step at E={emb_dim}: the KNN kernels did not run")
        loss_c, loss_h = float(sgrads[DEVICE][0]), float(sgrads["cpu"][0])
        grad_worst = {}
        for k, g_cpu in sgrads["cpu"][2].items():
            g_dev = sgrads[DEVICE][2][k].cpu()
            if not bool(torch.isfinite(g_dev).all()):
                fail(f"small train step at E={emb_dim}: gradient {k} is not finite on the card")
            scale = float(g_cpu.abs().max())
            grad_worst[k] = float((g_dev - g_cpu).abs().max()) / scale if scale else float(
                g_dev.abs().max())
        vs_c, vs_h = sgrads[DEVICE][3].cpu(), sgrads["cpu"][3]
        grad_worst["vs_grad"] = float((vs_c - vs_h).abs().max()) / float(vs_h.abs().max())
        top = sorted(grad_worst.items(), key=lambda kv: -kv[1])[:6]
        print(f"small train step {SMALL_N} Gaussians {SMALL_W}x{SMALL_H} (float32, reg_coef "
              f"{ssetup.reg_coef}, E={emb_dim}): loss cuda={loss_c:.7f} cpu={loss_h:.7f} "
              f"(limit rel {SMALL_LOSS_REL}), emb_loss cuda={semb[DEVICE]:.7e} "
              f"cpu={semb['cpu']:.7e}; worst gradient leaves (max|diff| / max|g|, limit "
              f"{SMALL_GRAD_REL}): " + ", ".join(f"{k} {v:.2e}" for k, v in top), flush=True)
        result[f"small_train_e{emb_dim}"] = dict(loss_cuda=loss_c, loss_cpu=loss_h,
                                                 emb_loss=semb, grad_rel=grad_worst)
        if (abs(loss_c - loss_h) > SMALL_LOSS_REL * abs(loss_h)
                or abs(semb[DEVICE] - semb["cpu"]) > SMALL_LOSS_REL * abs(semb["cpu"])
                or semb["cpu"] <= 0 or max(grad_worst.values()) > SMALL_GRAD_REL):
            fail(f"small train step at E={emb_dim}: the card's loss or gradients disagree "
                 "with the CPU's")

    # one densify of the small cut with free capacity and numpy-seeded
    # statistics, the same draws handed to both devices
    rng = np.random.default_rng(500)
    hot = dict(small, xyz_grad_accum=rng.uniform(0, 1e-3, SMALL_N).astype(np.float32),
               denom=rng.integers(0, 4, SMALL_N).astype(np.float32))
    noise = rng.normal(size=(2, SMALL_CAP, 3)).astype(np.float32)
    dens = {}
    for dev in (DEVICE, "cpu"):
        sp, sa = gaussians_from_numpy(hot, capacity=SMALL_CAP, device=dev)
        dens[dev] = densify(sp, sa, grad_threshold=2e-4, percent_dense=opt.percent_dense,
                            scene_extent=1.0, max_gaussians=SMALL_CAP,
                            noise=torch.as_tensor(noise, device=dev))
    dc, dh = dens[DEVICE], dens["cpu"]
    same_masks = (torch.equal(dc.aux.alive.cpu(), dh.aux.alive)
                  and torch.equal(dc.reset_mask.cpu(), dh.reset_mask)
                  and (int(dc.n_cloned), int(dc.n_split)) == (int(dh.n_cloned), int(dh.n_split)))
    dens_err = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(dc.params, dh.params))
    print(f"small densify: n_cloned {int(dh.n_cloned)} n_split {int(dh.n_split)}, masks and "
          f"counts equal={same_masks}, worst parameter max|diff| / max|v| {dens_err:.2e} "
          f"(limit {SMALL_LOSS_REL})", flush=True)
    if not same_masks or dens_err > SMALL_LOSS_REL or int(dh.n_split) == 0:
        fail("small densify: the card disagrees with the CPU")

    # create_from_points: its 3-NN scales on the card and on the CPU
    colors = np.clip(small["features_dc"][:, 0] * 0.28 + 0.5, 0, 1)
    made = {dev: create_from_points(small["xyz"], colors, capacity=SMALL_CAP, device=dev)
            for dev in (DEVICE, "cpu")}
    made_err = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(made[DEVICE][0], made["cpu"][0]))
    made_alive = torch.equal(made[DEVICE][1].alive.cpu(), made["cpu"][1].alive)
    print(f"small create_from_points: worst parameter max|diff| / max|v| {made_err:.2e} "
          f"(limit {SMALL_LOSS_REL}), alive equal={made_alive}", flush=True)
    if made_err > SMALL_LOSS_REL or not made_alive:
        fail("small create_from_points: the card disagrees with the CPU")
    result["small_densify"] = dict(n_cloned=int(dh.n_cloned), n_split=int(dh.n_split),
                                   param_rel=dens_err, create_rel=made_err)

    # ---- 5b. the tongue configuration and the COLMAP step -------------------
    result["tongue"] = tongue_phase(torch, cam, rcfg, fargs, extent, counters)
    snap.update(result["tongue"].pop("snaps"))

    # ---- 5c. the upstream dataset families --------------------------------
    result["families"] = families_phase(torch, counters)

    # ---- 6. the training CLI on a scene on disk, 7. the serving tools ------
    import tempfile
    with tempfile.TemporaryDirectory(prefix="ed3dgs_cli_") as tmp:
        result["cli"] = cli_phase(torch, counters, result["train_step_ms"], tmp)
        result["serve"] = serve_phase(torch, counters, result["cli"])
        # ---- the tongue configuration through tools.train and tools.render --
        result["tongue_cli"] = tongue_cli_phase(torch, counters, tmp)
        result["tongue_serve"] = tongue_serve_phase(torch, counters, result["tongue_cli"])
        result["offline"] = offline_phase(torch, counters, result["cli"])
        # ---- 9. two ranks sharing the card ---------------------------------
        result["multi"] = multi_phase(torch, snap, result["cli"], tmp)
    del snap

    order = ("K1", "K2", "K3", "K4", "K5a", "K5b", "K6", "K7", "K8")
    # the main path's launches: the train run's, the tongue and COLMAP
    # steps' (5b) and the multi phase's (its ranks' and (e)'s graphed tongue
    # and COLMAP steps'); X1's: the densify step and
    # refreshes of 3 and 5b's two tongue refreshes, beside its cli and serve
    # counts
    tongue = result["tongue"]
    fams = [v for k, v in result["families"].items() if k != "wall_s"]
    fam_launches = {k: sum(f["launches"][k] for f in fams) for k in order + ("X2",)}

    def kernel_row(k):
        return dict(rows[k], launches=train_launches[k] + tongue["launches"][k]
                    + fam_launches[k] + result["multi"]["launches"][k],
                    tongue_launches=tongue["launches"][k], families_launches=fam_launches[k],
                    families_ms={n: f["kernels"][k]["ms"] for n, f in
                                 result["families"].items()
                                 if n != "wall_s" and k in f["kernels"]})
    kernel_rows = [kernel_row(k) for k in order]
    for k, key in (("K6", "k6_ms"), ("K7", "k7_ms")):
        kernel_rows[order.index(k)].update(tongue_graph_ms=tongue["knn_kernels"][key],
                                           tongue_graph_in_edges=tongue["knn_kernels"]["in_edges"])
    x1_tongue = tongue["x1"][1]
    kernel_rows.append(dict(rows["X1"], launches=result["densify"]["launches"]["X1"]
                            + tongue["x1_launches"] + sum(f["x1_launches"] for f in fams),
                            tongue_launches=tongue["x1_launches"],
                            families_launches=sum(f["x1_launches"] for f in fams),
                            tongue_input_ms=x1_tongue["ms"], tongue_input_equal=x1_tongue["equal"],
                            cli_launches=result["cli"]["launches"]["X1"],
                            serve_launches=result["serve"]["launches"]["X1"]))
    # X2 launches with K4, in the same windows
    kernel_rows.append(kernel_row("X2"))
    result["kernels"] = kernel_rows
    result["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"total {result['total_s']:.1f} s", flush=True)
    cli_keys = ("iterations", "wall_s", "median_iter_ms", "bare_step_ms", "read_wait_ms",
                "decode_ms_per_frame",
                "stager_wait_ms_per_iter", "loss_first", "loss_last", "psnr_first", "psnr_last",
                "test_psnr", "points_start", "points_end", "densify_events", "capacity_changes",
                "graph_captures", "launches")
    tongue_line = {k: tongue[k] for k in ("x1", "refresh_ms", "search_ms", "prepare_ms",
                                          "buckets", "knn_kernels", "steps", "densify",
                                          "refresh_after_ms", "buckets_after", "steps_after",
                                          "colmap")}
    tongue_line["cli"] = {k: v for k, v in result["tongue_cli"].items()
                          if k not in ("scene_dir", "model_dir")}
    tongue_line["serve"] = result["tongue_serve"]
    print(json.dumps({"families": {"card": card, **result["families"]}}), flush=True)
    print(json.dumps({"tongue": tongue_line}), flush=True)
    print(json.dumps({"cli": {k: result["cli"][k] for k in cli_keys}}), flush=True)
    serve_keys = ("frames", "fps", "render_ms_median", "render_ms_median_counted",
                  "save_ms_median", "launches", "psnr",
                  "ssim", "lpips_vgg", "lpips_alex", "float_test_psnr", "cli_test_psnr",
                  "tetra_points",
                  "delaunay_s", "sdf_s", "extract_s", "vertices", "faces",
                  "mesh_distance_mm", "integrate_max_diff")
    print(json.dumps({"serve": {k: result["serve"][k] for k in serve_keys}}), flush=True)
    print(json.dumps({"offline": result["offline"]}), flush=True)
    print(json.dumps({"multi": {"card": card, **result["multi"]}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
