"""Multi-device training and rendering on torch.distributed (port of
ed3dgs_tpu/parallel/): the (data, gauss) mesh, the collectives and their
ledger, starting a world, the strip exchange, and the sharded step."""

from .mesh import Mesh, make_mesh  # noqa: F401
from .sharded import make_sharded_train_step, shard_batch, shard_train_state  # noqa: F401
