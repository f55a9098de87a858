"""Batched 8-point fundamental-matrix RANSAC.

Port of trackingbench_slam_tpu/ops/ransac.py: S hypotheses at once, samples
drawn by Gumbel top-k over the valid correspondences, null vectors by
inverse iteration on an unrolled-style Cholesky, Sampson-style symmetric
epipolar distance for the vote. The uniform draws come from the caller's
torch.Generator, or are given (`uniform`, (S, N)) so that a test can feed
the reference's own draws.
"""

from __future__ import annotations

import math

import torch

from trackingbench_slam_tpu_torch.ops.fast import stable_topk
from trackingbench_slam_tpu_torch.ops.linalg import cholesky, cholesky_apply


def _normalize_points(pts: torch.Tensor):
    """Hartley normalization: center + mean distance sqrt(2)."""
    mean = pts.mean(0)
    d = torch.linalg.norm(pts - mean, dim=-1).mean() + 1e-9
    s = math.sqrt(2.0) / d
    # built out of place, so that the function also runs under vmap
    z, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([torch.stack([s, z, -s * mean[0]]),
                     torch.stack([z, s, -s * mean[1]]),
                     torch.stack([z, z, one])])
    return (pts - mean) * s, T


def _min_eigvec(M: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Smallest eigenvector of (..., n, n) symmetric PSD matrices by inverse
    iteration on the Cholesky factor of M + eps I."""
    n = M.shape[-1]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    eps = 1e-7 * (tr + 1e-12)
    A = M + eps[..., None, None] * torch.eye(n, dtype=M.dtype,
                                             device=M.device)
    L = cholesky(A, 1e-20)
    v = torch.full_like(M[..., 0], 1.0 / math.sqrt(n))
    for _ in range(iters):
        w = cholesky_apply(L, v)
        v = w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True),
                            min=1e-20)
    return v


def _eight_point(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(S, K, 2) normalized correspondences -> (S, 3, 3) rank-2 F."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     ones], dim=-1)
    AtA = A.transpose(-1, -2) @ A
    F = _min_eigvec(AtA).reshape(-1, 3, 3)
    v3 = _min_eigvec(F.transpose(-1, -2) @ F)
    return F - (F @ v3[..., None]) * v3[..., None, :]


def _sampson_epipolar_dist(F: torch.Tensor, p1: torch.Tensor,
                           p2: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) models, (N, 2) points -> (..., N) symmetric point-to-line
    distance."""
    h1 = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=-1)
    h2 = torch.cat([p2, torch.ones_like(p2[:, :1])], dim=-1)
    l2 = h1 @ F.transpose(-1, -2)
    l1 = h2 @ F
    d2 = torch.abs((h2 * l2).sum(-1)) / torch.clamp(
        torch.linalg.norm(l2[..., :2], dim=-1), min=1e-9)
    d1 = torch.abs((h1 * l1).sum(-1)) / torch.clamp(
        torch.linalg.norm(l1[..., :2], dim=-1), min=1e-9)
    return torch.maximum(d1, d2)


def draw_uniform(num_samples: int, n: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Uniform draws in [1e-9, 1), as jax.random.uniform(minval=1e-9)."""
    u = torch.rand((num_samples, n), generator=generator, device=device)
    return torch.clamp(u * (1.0 - 1e-9) + 1e-9, min=1e-9)


def fundamental_ransac(p1: torch.Tensor, p2: torch.Tensor,
                       valid: torch.Tensor,
                       uniform: torch.Tensor | None = None,
                       generator: torch.Generator | None = None,
                       threshold: float = 3.0, num_samples: int = 256):
    """Returns (inlier_mask (N,), F_best (3, 3)). `uniform` (S, N) are the
    draws; without it they come from `generator`."""
    N = p1.shape[0]
    zero = torch.zeros_like(p1)
    p1n, T1 = _normalize_points(torch.where(valid[:, None], p1, zero))
    p2n, T2 = _normalize_points(torch.where(valid[:, None], p2, zero))
    if uniform is None:
        uniform = draw_uniform(num_samples, N, generator, p1.device)
    logits = torch.where(valid, torch.zeros_like(p1[:, 0]),
                         torch.full_like(p1[:, 0], -1e9))
    gumbel = -torch.log(-torch.log(uniform + 1e-12))
    _, idx = stable_topk(logits[None, :] + gumbel, 8)        # (S, 8)
    Fs = _eight_point(p1n[idx], p2n[idx])
    F_px = T2.T @ Fs @ T1
    d = _sampson_epipolar_dist(F_px, p1, p2)                  # (S, N)
    votes = ((d < threshold) & valid).sum(-1)
    # the winner's rows by index_select: no host read of `best`
    best = torch.argmax(votes).reshape(1)
    F_best = F_px.index_select(0, best)[0]
    inliers = (d.index_select(0, best)[0] < threshold) & valid
    inliers = torch.where(votes.index_select(0, best)[0] >= 8, inliers, valid)
    return inliers, F_best
