"""The (data, gauss) device mesh over a torch.distributed world (port of
ed3dgs_tpu/parallel/mesh.py).

JAX runs one process per host with many devices; PyTorch runs one process
per rank, each with one device. A rank is the mesh position (d, g),
data-major, the order of `make_mesh`'s `reshape(data, gauss)` in the JAX
package: rank r has d = r // gauss and g = r % gauss.

  * axis "data": cameras of the batch. Each data row renders its own
    cameras; gradients of the Gaussian rows are summed over the data group
    (the ranks that share g).
  * axis "gauss": the Gaussian capacity. Each rank of a data row holds rows
    [g*C/G, (g+1)*C/G) of every per-Gaussian array and exchanges projected
    splats with the others of its gauss group (the ranks that share d).

Every rank creates every group, in the same order, as `dist.new_group`
requires. A `Mesh(1, 1)` without an initialised world is legal: every
collective of `parallel.comm` is then the identity, so the single-process
paths stay as they are.
"""

from __future__ import annotations

import torch.distributed as dist

AXES = ("data", "gauss")


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A data x gauss mesh over the initialised world (or a lone process).

    `shape` is {"data": D, "gauss": G}; `d` and `g` are this rank's position;
    `group(axis)` is the process group of the ranks that differ from this
    one only along `axis` ("world" for all of them), or None where that
    group is this process alone; `backend` is the world's torch.distributed
    backend ("nccl" or "gloo"), None for a lone process."""

    def __init__(self, data: int = 1, gauss: int = 1):
        rank, world = _world()
        if data < 1 or gauss < 1 or data * gauss != world:
            raise ValueError(f"a data={data} x gauss={gauss} mesh needs {data * gauss} ranks; "
                             f"the world has {world}")
        self.shape = {"data": data, "gauss": gauss}
        self.rank = rank
        self.d, self.g = divmod(rank, gauss)
        self._groups = {"data": None, "gauss": None, "world": None}
        self.backend = None
        if world == 1:
            return
        self.backend = dist.get_backend()
        self._groups["world"] = dist.group.WORLD
        for d in range(data):
            grp = dist.new_group([d * gauss + g for g in range(gauss)])
            if d == self.d and gauss > 1:
                self._groups["gauss"] = grp
        for g in range(gauss):
            grp = dist.new_group([d * gauss + g for d in range(data)])
            if g == self.g and data > 1:
                self._groups["data"] = grp

    def size(self, axis: str) -> int:
        return self.shape["data"] * self.shape["gauss"] if axis == "world" else self.shape[axis]

    def index(self, axis: str) -> int:
        return {"data": self.d, "gauss": self.g, "world": self.rank}[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self):
        return f"Mesh(data={self.shape['data']}, gauss={self.shape['gauss']}, rank={self.rank})"


def make_mesh(data: int = 1, gauss: int = 1) -> Mesh:
    """The mesh over the whole world; raises unless data * gauss ranks make
    it up (the JAX package's `make_mesh` raises for too few devices)."""
    return Mesh(data, gauss)
