"""Row scatters shared by several arrays.

Port of trackingbench_slam_tpu/ops/packing.py `scatter_rows_set`. The
reference packs every column into one uint32 matrix and runs a single
scatter, so each destination row comes whole from one source row; on the
CPU the last source row of a repeated destination wins. A CUDA
`index_copy_` with repeated targets picks an arbitrary writer per call, so
one indexed write per array could tear a row (its arrays from different
sources) and differ from run to run. Here `last_writer` picks the one
writer per destination first, the last source row as the reference gives
on the CPU, and `take_rows` gathers that writer's row into every array: a
gather, so nothing is written twice and the result does not depend on the
order of writes. Destinations outside [0, rows) are dropped, as the
reference's mode="drop" drops those past the end (it wraps negative ones;
no caller passes one).
"""

from __future__ import annotations

import torch


def last_writer(idx: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows,) int64: per destination row, the position in `idx` of the
    last source row naming it, -1 where none does (entries outside [0,
    rows) name none). One scatter_reduce (amax of positions, exact in any
    order), no host sync."""
    idx = idx.long()
    pos = torch.arange(idx.shape[0], device=idx.device)
    tgt = torch.where((idx >= 0) & (idx < rows), idx,
                      torch.full_like(idx, rows))
    winner = torch.full((rows + 1,), -1, dtype=torch.long, device=idx.device)
    return winner.scatter_reduce(0, tgt, pos, "amax")[:rows]


def take_rows(dst: torch.Tensor, winner: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """dst with row r replaced by src[winner[r]] where winner[r] >= 0."""
    if src.shape[0] == 0:
        return dst
    has = (winner >= 0).reshape((-1,) + (1,) * (dst.dim() - 1))
    rows = src.to(dst.dtype).index_select(0, winner.clamp(min=0))
    return torch.where(has, rows, dst)


def scatter_rows_set(dsts: list, idx: torch.Tensor, srcs: list) -> list:
    """`dst.at[idx].set(src, mode="drop")` for each pair, every array
    taking the same source row per destination; idx entries out of [0,
    rows) write nowhere. Returns new tensors."""
    assert len(dsts) == len(srcs)
    rows = dsts[0].shape[0]
    assert all(d.shape[0] == rows for d in dsts)
    winner = last_writer(idx, rows)
    return [take_rows(d, winner, s) for d, s in zip(dsts, srcs)]
