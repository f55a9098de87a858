"""Multi-process start-up and the host-aware rank layout.

Port of trackingbench_slam_tpu/parallel/multihost.py. Every process drives
one device; `initialize` joins the processes into one torch.distributed
world from torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE), NCCL on CUDA and gloo on the
CPU. `make_host_mesh` lays the 'lm' (landmark-shard) rows over the ranks of
one node, so the all-reduce of the reduced camera system per LM iteration
stays inside a node (NVLink), and 'dp' over nodes, where only independent
work goes.

Launch, one process per GPU of each node:

    torchrun --nnodes N --nproc-per-node G --rdzv-endpoint HOST:PORT app.py

and in app.py

    from trackingbench_slam_tpu_torch.parallel import multihost
    multihost.initialize()               # False without torchrun's env
    mesh = multihost.make_host_mesh()    # dp = nodes, lm = local ranks

A single process (no such environment) skips initialize() and gets the same
layout over one rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from trackingbench_slam_tpu_torch.parallel import mesh as mesh_mod
from trackingbench_slam_tpu_torch.utils.device import resolve_device


def initialize(device=None) -> bool:
    """Join this process into the torch.distributed world that torchrun's
    environment describes: NCCL with this process on cuda:LOCAL_RANK, or
    gloo when `device` is "cpu". Returns False when the environment names
    no world (no MASTER_ADDR or WORLD_SIZE), True once joined; calling
    again after a successful start is a no-op that returns True."""
    if dist.is_initialized():
        return True
    env = os.environ
    if "MASTER_ADDR" not in env or "WORLD_SIZE" not in env:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://",
                            rank=int(env.get("RANK", "0")),
                            world_size=int(env["WORLD_SIZE"]))
    return True


def local_world_size() -> int:
    """Processes on this node: LOCAL_WORLD_SIZE (torchrun), else the whole
    world."""
    _, size = mesh_mod.world()
    return int(os.environ.get("LOCAL_WORLD_SIZE", size))


def make_host_mesh(lm_per_host: int | None = None) -> mesh_mod.RankMesh:
    """(dp = nodes, lm = ranks of a node) layout with 'lm' node-local.

    Rows are nodes, each the node's consecutive ranks; `lm_per_host` trims
    each row to its first ranks (by default all of the node's). A single
    process gets one row of one rank."""
    _, size = mesh_mod.world()
    local = local_world_size()
    if local < 1 or size % local:
        raise ValueError(f"world of {size} is not whole nodes of {local}")
    width = local if lm_per_host is None else int(lm_per_host)
    if not 1 <= width <= local:
        raise ValueError(f"lm_per_host={width} but a node has {local} "
                         "ranks")
    return mesh_mod.mesh_of_grid(
        [range(h * local, h * local + width) for h in range(size // local)])


def process_info() -> dict:
    """This process's place in the world (for logs)."""
    rank, size = mesh_mod.world()
    return {
        "process_index": rank,
        "process_count": size,
        "local_rank": int(os.environ.get("LOCAL_RANK", "0")),
        "local_process_count": local_world_size(),
        "local_device_count": torch.cuda.device_count(),
    }
