"""Small batched SPD solves, products and sums written out in elementwise
ops.

The reference unrolls its 6x6 and 9x9 Cholesky factorizations into scalar
ops (ops/ransac.py `_chol_unrolled`, solvers/pose_opt.py `_chol6_solve`) so
they fuse on the TPU. Here the same recurrences run column by column over a
batch: every entry is formed by the same sequence of subtractions as the
scalar code, with the pivot clamped at `floor` before its square root.

`small_matmul` and `fixed_sum` round every entry the same way whatever the
leading shape: under torch.func.vmap (parallel/dp_eval.py) a matrix
product or a reduction kernel is picked and split by the shape with the
batch folded in, and on the H100 its rounding then changed with the batch,
which moved the pose solve and through it the tracker's decisions. Each is
a fixed sequence of separate elementwise multiplies and adds (no fused
multiply-add op: a CPU kernel may fuse in its vector body and not in its
scalar tail).
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


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """x summed over its last (small) axis in order."""
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out + x[..., k]
    return out


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n) . (..., n) -> (...,), the products summed in order."""
    return sum_last(a * b)


def norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last (small) axis."""
    return torch.sqrt(dot(x, x))


def small_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for small (..., i, k) and (..., k, j) (broadcast over the
    leading dimensions): the products a_ik b_kj, then summed over k in
    order, k = 0 first."""
    p = a[..., :, :, None] * b[..., None, :, :]
    out = p[..., :, 0, :]
    for k in range(1, a.shape[-1]):
        out = out + p[..., :, k, :]
    return out


def fixed_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """x summed over `dim`: the axis zero-padded to a power of two, then
    halved by elementwise adds, x[:n/2] + x[n/2:], until one entry is
    left."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = torch.nn.functional.pad(x, (0, size - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]
