"""Row scatters shared by several arrays.

Port of trackingbench_slam_tpu/ops/packing.py `scatter_rows_set`. The
reference packs every column into one uint32 matrix so the TPU runs a single
scatter; on the card each array takes its own indexed write. Destinations
equal to the row count are dropped, as the reference's mode="drop".
"""

from __future__ import annotations

import torch


def scatter_rows_set(dsts: list, idx: torch.Tensor, srcs: list) -> list:
    """`dst.at[idx].set(src, mode="drop")` for each pair; idx entries out of
    [0, rows) write nowhere. Returns new tensors."""
    assert len(dsts) == len(srcs)
    out = []
    for d, s in zip(dsts, srcs):
        rows = d.shape[0]
        keep = (idx >= 0) & (idx < rows)
        # dropped rows write into an extra scratch row that is cut off
        ext = torch.cat([d, d[:1]])
        tgt = torch.where(keep, idx, torch.full_like(idx, rows)).long()
        ext.index_copy_(0, tgt, s.to(d.dtype))
        out.append(ext[:rows])
    return out
