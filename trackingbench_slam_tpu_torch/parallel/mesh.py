"""Rank layout for the distributed solvers.

Port of trackingbench_slam_tpu/parallel/mesh.py. The JAX package lays
devices out on a (dp, lm) mesh; here every process drives one device, so the
layout is one of the ranks of the torch.distributed world:

  * 'lm': the landmark-shard axis of windowed BA. The ranks of one row hold
    one window's landmark shards; the reduced (6K, 6K) camera system is
    all-reduced over the row's process group (parallel/dist_ba.py).
  * 'dp': independent rows (sequences or windows); no collective crosses
    them.

Row d holds ranks [d * lm, (d + 1) * lm), so with torchrun's numbering
(ranks of a node are consecutive) an 'lm' row stays on one node, the
counterpart of the JAX mesh keeping 'lm' on ICI-adjacent devices.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """grid[d][j]: the global rank at row d, lm position j; groups[d]: row
    d's process group (None when torch.distributed is not initialized: a
    world of one, no collective)."""

    grid: tuple
    groups: tuple
    rank: int

    @property
    def dp(self) -> int:
        return len(self.grid)

    @property
    def lm(self) -> int:
        return len(self.grid[0])

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "lm": self.lm}

    def coords(self):
        """(row, lm position) of this process, None outside the grid."""
        for d, row in enumerate(self.grid):
            if self.rank in row:
                return d, row.index(self.rank)
        return None

    @property
    def lm_index(self) -> int:
        return self._coords()[1]

    @property
    def lm_group(self):
        """The process group of this process's row."""
        return self.groups[self._coords()[0]]

    def _coords(self):
        c = self.coords()
        if c is None:
            raise RuntimeError(f"rank {self.rank} lies outside the "
                               f"{self.dp} x {self.lm} mesh")
        return c


def world() -> tuple[int, int]:
    """(rank, world size) of torch.distributed, (0, 1) when it is not
    initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


_cache: dict = {}


def mesh_of_grid(grid) -> RankMesh:
    """A RankMesh over the given rows of global ranks. Every process of
    the world must call it with the same grid: creating the row groups is
    a collective. Meshes are cached per grid and world."""
    grid = tuple(tuple(int(r) for r in row) for row in grid)
    rank, size = world()
    if len({len(row) for row in grid}) != 1:
        raise ValueError(f"rows of unequal length: {grid}")
    if any(r < 0 or r >= size for row in grid for r in row):
        raise ValueError(f"mesh {grid} needs ranks beyond the world of "
                         f"{size}: initialize torch.distributed "
                         "(parallel/multihost.py) with enough processes")
    if not (dist.is_available() and dist.is_initialized()):
        return RankMesh(grid=grid, groups=(None,), rank=rank)
    key = (grid, dist.group.WORLD)
    if key not in _cache:
        _cache[key] = RankMesh(
            grid=grid, groups=tuple(dist.new_group(list(row))
                                    for row in grid), rank=rank)
    return _cache[key]


def make_mesh(lm: int | None = None, dp: int = 1) -> RankMesh:
    """(dp, lm) layout of the world's ranks; by default every rank on 'lm'.
    Raises when the world has fewer than dp * lm ranks."""
    _, size = world()
    if lm is None:
        lm = size // dp
    if lm < 1 or dp < 1 or dp * lm > size:
        raise ValueError(f"a {dp} x {lm} mesh needs {dp * lm} ranks; the "
                         f"torch.distributed world has {size}")
    return mesh_of_grid([range(d * lm, (d + 1) * lm) for d in range(dp)])


def replicated(mesh: RankMesh, x):
    """This rank's share of an array replicated over `mesh`: all of it
    (the JAX package's NamedSharding(mesh, P()))."""
    return x


def lm_sharded(mesh: RankMesh, x, *, axis: int = 0):
    """This rank's share of `x` split over the mesh's 'lm' axis along
    `axis` (the JAX package's NamedSharding(mesh, P(..., "lm"))): the
    lm_index-th of mesh.lm equal blocks, the same for every row. The axis
    must divide evenly, as a JAX sharding requires."""
    n = x.shape[axis]
    if n % mesh.lm:
        raise ValueError(f"axis {axis} of {n} does not split into "
                         f"{mesh.lm} equal blocks")
    k = n // mesh.lm
    return x.narrow(axis, mesh.lm_index * k, k)


def lm_mesh(lm: int, dp: int = 1) -> RankMesh:
    """The mesh a pipeline configured with mesh.lm = lm solves on; raises,
    naming mesh.lm, when torch.distributed does not hold that many ranks."""
    _, size = world()
    if dp * lm > size:
        raise RuntimeError(
            f"mesh.lm = {lm} (mesh.dp = {dp}) shards windowed BA over "
            f"{dp * lm} ranks, but the torch.distributed world has {size}: "
            "launch with torchrun and call parallel.multihost.initialize(), "
            "or set mesh.lm = 1")
    return make_mesh(lm=lm, dp=dp)
