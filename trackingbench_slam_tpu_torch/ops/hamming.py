"""Hamming-distance matching primitives.

Port of trackingbench_slam_tpu/ops/hamming.py. Distances come from one
float32 matrix product of +-1 descriptors, d = (256 - A.B^T) / 2, which is
exact: every partial sum is an integer of magnitude <= 256 (TF32 is off,
see the package __init__).
"""

from __future__ import annotations

import torch

from trackingbench_slam_tpu_torch.ops.fast import stable_topk

INF_DIST = 10_000.0


def hamming_matrix_mxu(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """(N1, 256) x (N2, 256) +-1 float -> (N1, N2) float distances."""
    return (256.0 - b1 @ b2.T) * 0.5


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (int64 result)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101 & 0xFFFFFFFF) >> 24


def masked_distance(dist, valid1, valid2, extra_mask=None):
    m = valid1[:, None] & valid2[None, :]
    if extra_mask is not None:
        m = m & extra_mask
    return torch.where(m, dist.float(), torch.full_like(dist, INF_DIST))


def best_two(dist: torch.Tensor):
    """Per row: (best_idx, best_dist, second_dist); the first minimum wins
    ties, as jnp.argmin."""
    best_idx = torch.argmin(dist, dim=1)
    rows = torch.arange(dist.shape[0], device=dist.device)
    best = dist[rows, best_idx]
    masked = dist.clone()
    masked[rows, best_idx] = INF_DIST
    second = masked.min(dim=1).values
    return best_idx, best, second


def mutual_best(dist: torch.Tensor):
    """Cross-check: a row's best column must have that row as its best.
    Returns (idx (N1,), dist (N1,), mutual (N1,) bool); first minima win
    ties both ways."""
    best12 = torch.argmin(dist, dim=1)
    best21 = torch.argmin(dist, dim=0)
    rows = torch.arange(dist.shape[0], device=dist.device)
    return best12, dist[rows, best12], best21[best12] == rows


def ratio_filter(best, second, ratio: float):
    return best < ratio * second


def rotation_histogram_mask(angles1, angles2, match_idx, match_ok,
                            histo_length: int = 30, top_bins: int = 3):
    """Rotation-consistency filter (ComputeThreeMaxima): matches survive in
    the top `top_bins` angle-difference bins holding votes, each above 0.1x
    the largest."""
    two_pi = torch.full((), 6.283185307179586, dtype=angles1.dtype,
                        device=angles1.device)
    diff = angles1 - angles2[match_idx]
    r = torch.fmod(diff, two_pi)
    diff = torch.where((r != 0) & (r < 0), r + two_pi, r)
    bins = (diff * histo_length / two_pi).long().clamp(0, histo_length - 1)
    hist = torch.zeros(histo_length, dtype=torch.int64, device=bins.device)
    hist.index_add_(0, bins, match_ok.long())
    top_vals, top_idx = stable_topk(hist, top_bins)
    max1 = top_vals[0].float()
    keep_bin = torch.zeros(histo_length, dtype=torch.bool, device=bins.device)
    for i in range(top_bins):
        ok = top_vals[i] > 0
        if i > 0:
            ok = ok & (top_vals[i].float() > 0.1 * max1)
        keep_bin[top_idx[i]] = ok
    return match_ok & keep_bin[bins]


def resolve_duplicate_targets(match_idx, match_dist, match_ok,
                              n_targets: int):
    """Keep only the lowest-distance source per target, exact ties going to
    the lowest source index."""
    dev = match_idx.device
    d = torch.where(match_ok, match_dist, torch.full_like(match_dist,
                                                          INF_DIST))
    tgt = torch.where(match_ok, match_idx,
                      torch.full_like(match_idx, n_targets))
    best_per_tgt = torch.full((n_targets + 1,), INF_DIST, dtype=d.dtype,
                              device=dev).scatter_reduce(0, tgt, d, "amin")
    is_best = d <= best_per_tgt[tgt]
    src = torch.arange(match_idx.shape[0], device=dev)
    tie_key = torch.where(is_best & match_ok, src,
                          torch.full_like(src, src.shape[0]))
    first_best = torch.full((n_targets + 1,), src.shape[0], dtype=src.dtype,
                            device=dev).scatter_reduce(0, tgt, tie_key,
                                                       "amin")
    return match_ok & is_best & (first_best[tgt] == src)
