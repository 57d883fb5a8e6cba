"""The work counts: operations and bytes of the step's parts, from shapes
and inputs only, never from a counter or a choice of the program. The K1
and K2 counts are chip_smoke.py's (`hold_k1`, `hold_k2`), copied; their
data-dependent parts (pairs, needed pair-pixel evaluations, blended splats,
live rows) come from the benchmark's own frozen binning and blend
(reference/) on the same inputs.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit). Integer work is counted against the fp32 CUDA-core rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

# K1: fp32 operations per pair-pixel evaluation (offsets, exponent, exp2,
# opacity, clamp, the two pass tests) and per blended splat (transmittance,
# weight, 12 channel and 8 plane-term accumulations, include test)
K1_OPS_PER_EVAL = 14
K1_OPS_PER_INCLUDE = 45
# K2: two alpha evaluations per needed pair-pixel (front to back, then back
# to front) and, per blended splat, the cotangent dot (~50), the alpha
# gradient (~10) and 26 gradient terms with their sums (~60); it reads 10
# channels of the forward output and 17 of its cotangent
K2_OPS_PER_EVAL = 2 * K1_OPS_PER_EVAL
K2_OPS_PER_INCLUDE = 120
K2_CHANNELS_READ = 10 + 17
PAYLOAD_WIDTH = 26          # floats a pair row
OUT_PAD = 24                # channels a tile's packed output holds
PIX = 256                   # pixels a 16 x 16 tile
OUT_CHANNELS = 18           # the blend's output channels
HEAD_DIMS = (3, 3, 4, 1, 48)    # the deformation heads: pos, scale, rot, opacity, SH
# floats a Gaussian's parameters: xyz 3, SH 48, log-scale 3, quaternion 4,
# logit-opacity 1, and the embedding (added per configuration)
GAUSSIAN_FLOATS = 3 + 48 + 3 + 4 + 1


def least_s(nbytes: float = 0.0, fp32_ops: float = 0.0, bf16_flops: float = 0.0) -> float:
    """The least time the work needs: the largest of its bytes at the HBM
    rate, its fp32 operations at the CUDA-core rate and its bf16 matmul
    flops at the tensor-core rate."""
    return max(nbytes / HBM_BYTES_PER_S, fp32_ops / FP32_OPS_PER_S,
               bf16_flops / BF16_FLOPS_PER_S)


def mlp_flops(gaussians: int, hidden: dict, backward: bool) -> float:
    """Matmul flops of both deformation towers over `gaussians` rows: the
    feature layers (in -> W, then W -> W), five heads of W -> W -> d; the
    backward takes twice the forward (the input's and the weights'
    gradients)."""
    W = hidden["net_width"]
    feature = (hidden["temporal_embedding_dim"] + hidden["gaussian_embedding_dim"]) * W
    feature += (hidden["defor_depth"] - 1) * W * W
    heads = sum(W * W + W * d for d in HEAD_DIMS)
    forward = 2 * 2 * gaussians * (feature + heads)
    return forward * (3 if backward else 1)


def k1_work(tiles: int, rows_read: int, evals: int, includes: int) -> dict:
    """K1's bytes (pair rows read, tile bounds read, packed output written)
    and operations."""
    return dict(nbytes=rows_read * PAYLOAD_WIDTH * 4 + 2 * 4 * tiles + tiles * OUT_PAD * PIX * 4,
                fp32_ops=K1_OPS_PER_EVAL * evals + K1_OPS_PER_INCLUDE * includes)


def k2_work(tiles: int, rows: int, live_rows: int, evals: int, includes: int) -> dict:
    """K2's bytes (the live rows read, every row's gradient written, the
    channels read, the tile bounds read, the live-chunk counts written) and
    operations."""
    return dict(nbytes=((live_rows + rows) * PAYLOAD_WIDTH * 4 + K2_CHANNELS_READ * tiles * PIX * 4
                        + 2 * 4 * tiles + 4 * tiles),
                fp32_ops=K2_OPS_PER_EVAL * evals + K2_OPS_PER_INCLUDE * includes)


def knn_loss_bytes(gaussians: int, emb_dim: int, k: int) -> float:
    """The KNN regulariser (forward and gradient): each embedding read and
    its gradient written, each edge's neighbour index and weight read."""
    return gaussians * (2 * emb_dim * 4 + k * 8)


def step_rest_bytes(gaussians: int, emb_dim: int, mlp_params: int, width: int,
                    height: int) -> float:
    """Everything else in a training step, each byte read once and written
    once: the parameters (read, written), their gradients (written, read)
    and both Adam moments (read, written), the target read and the blend's
    output channels written."""
    floats = gaussians * (GAUSSIAN_FLOATS + emb_dim) + mlp_params
    return 8 * floats * 4 + (3 + OUT_CHANNELS) * width * height * 4


def frame_rest_bytes(gaussians: int, emb_dim: int, mlp_params: int, width: int,
                     height: int) -> float:
    """Everything else in a served frame: the parameters read once, the
    image written once."""
    return (gaussians * (GAUSSIAN_FLOATS + emb_dim) + mlp_params) * 4 + 3 * width * height * 4


def mlp_params(hidden: dict) -> int:
    """Parameters of the deformation network: the temporal table, the
    per-camera offsets and both towers' layers."""
    W = hidden["net_width"]
    layers = [(hidden["temporal_embedding_dim"] + hidden["gaussian_embedding_dim"], W)]
    layers += [(W, W)] * (hidden["defor_depth"] - 1)
    layers += [(W, W) for _ in HEAD_DIMS] + [(W, d) for d in HEAD_DIMS]
    tower = sum(i * o + o for i, o in layers)
    return (hidden["max_embeddings"] * hidden["temporal_embedding_dim"]
            + hidden["max_cameras"] + 2 * tower)
