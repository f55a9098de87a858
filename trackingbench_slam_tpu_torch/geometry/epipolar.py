"""Two-view epipolar geometry for the monocular bootstrap.

Port of trackingbench_slam_tpu/geometry/epipolar.py: F from 8-point RANSAC
(ops/ransac.py), E = K^T F K projected onto the essential manifold, its
four (R, t) candidates, and the one that puts the most inlier matches in
front of both cameras. The SVD's column signs are free; the det-sign fix
and the cheirality census make the chosen pose independent of them.
"""

from __future__ import annotations

import torch

from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.geometry.triangulation import \
    triangulate_dlt
from trackingbench_slam_tpu_torch.ops.ransac import fundamental_ransac


def essential_from_fundamental(F: torch.Tensor, K: torch.Tensor):
    """E = K^T F K (same intrinsics in both views)."""
    return K.T @ F @ K


def _enforce_essential(E: torch.Tensor) -> torch.Tensor:
    """The nearest matrix with singular values (1, 1, 0)."""
    U, _, Vt = torch.linalg.svd(E)
    s = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * s) @ Vt


def decompose_essential(E: torch.Tensor):
    """The four (R, t) candidates: (Rs (4, 3, 3), ts (4, 3)), det R = +1,
    |t| = 1."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def recover_pose(E: torch.Tensor, K: torch.Tensor, px1: torch.Tensor,
                 px2: torch.Tensor, valid: torch.Tensor):
    """The candidate with the most valid matches in front of both cameras
    (the first on a tie), and its triangulation. px1 view 1 (the world),
    px2 view 2. Returns (T_21 (4, 4) with |t| = 1, points (N, 3) in view 1,
    good (N,))."""
    Rs, ts = decompose_essential(_enforce_essential(E))
    eye = torch.eye(4, dtype=E.dtype, device=E.device)
    P1 = K @ eye[:3]
    Ts, Xs, goods = [], [], []
    for R, t in zip(Rs, ts):
        T = se3.from_rt(R, t)
        X = triangulate_dlt(P1, K @ T[:3], px1, px2)
        z2 = (X @ R.T + t[None, :])[:, 2]
        goods.append(valid & (X[:, 2] > 1e-3) & (z2 > 1e-3))
        Ts.append(T)
        Xs.append(X)
    goods = torch.stack(goods)
    best = torch.argmax(goods.sum(1))
    return torch.stack(Ts)[best], torch.stack(Xs)[best], goods[best]


def mono_bootstrap(K: torch.Tensor, px1: torch.Tensor, px2: torch.Tensor,
                   valid: torch.Tensor, generator: torch.Generator | None = None,
                   uniform: torch.Tensor | None = None,
                   min_inliers: int = 30):
    """F-RANSAC (draws from `generator`, or the given `uniform`), E, then the
    cheirality pose and structure. Returns (T_21, points (N, 3) in view 1,
    good (N,), ok 0-d bool), scale fixed by |t| = 1."""
    inl, F = fundamental_ransac(px1, px2, valid, uniform=uniform,
                                generator=generator)
    E = essential_from_fundamental(F, K)
    T_21, X, good = recover_pose(E, K, px1, px2, valid & inl)
    return T_21, X, good, good.sum() >= min_inliers
