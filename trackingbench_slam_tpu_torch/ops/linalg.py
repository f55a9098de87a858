"""Small batched SPD solves written out in elementwise ops.

The reference unrolls its 6x6 and 9x9 Cholesky factorizations into scalar
ops (ops/ransac.py `_chol_unrolled`, solvers/pose_opt.py `_chol6_solve`) so
they fuse on the TPU. Here the same recurrences run column by column over a
batch: every entry is formed by the same sequence of subtractions as the
scalar code, with the pivot clamped at `floor` before its square root.
"""

from __future__ import annotations

import torch


def cholesky(A: torch.Tensor, floor: float) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n) SPD matrices."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[..., j:, j]
        for k in range(j):
            s = s - L[..., j:, k] * L[..., j:j + 1, k]
        d = torch.sqrt(torch.clamp(s[..., 0], min=floor))
        L[..., j, j] = d
        L[..., j + 1:, j] = s[..., 1:] / d[..., None]
    return L


def cholesky_apply(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b for (..., n) right-hand sides."""
    n = L.shape[-1]
    y = b.clone()
    for k in range(n):
        y[..., k] = y[..., k] / L[..., k, k]
        y[..., k + 1:] = y[..., k + 1:] - L[..., k + 1:, k] * y[..., k:k + 1]
    x = y
    for k in reversed(range(n)):
        x[..., k] = x[..., k] / L[..., k, k]
        x[..., :k] = x[..., :k] - L[..., k, :k] * x[..., k:k + 1]
    return x
