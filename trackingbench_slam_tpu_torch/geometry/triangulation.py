"""Two-view triangulation, stereo depth and back-projection.

Port of trackingbench_slam_tpu/geometry/triangulation.py. `triangulate_dlt`
takes the smallest eigenvector of A^T A (torch.linalg.eigh, ascending as
jnp.linalg.eigh); its sign cancels in the dehomogenization.
"""

from __future__ import annotations

import torch


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, px1: torch.Tensor,
                    px2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation: P1, P2 (3, 4) projection matrices, px1, px2
    (..., 2) pixels -> (..., 3) points. Rows u P[2] - P[0] and v P[2] - P[1]
    of each view; the solution is the smallest eigenvector of A^T A."""
    def rows(P, px):
        u, v = px[..., 0:1], px[..., 1:2]
        return u * P[2] - P[0], v * P[2] - P[1]

    A = torch.stack([*rows(P1, px1), *rows(P2, px2)], dim=-2)   # (..., 4, 4)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    X = vecs[..., :, 0]
    w = X[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w[..., None]


def triangulate_midpoint(T_w1: torch.Tensor, T_w2: torch.Tensor,
                         f1: torch.Tensor, f2: torch.Tensor):
    """Midpoint of the closest points of two bearing rays (f1, f2 (..., 3)
    unit bearings in cameras with camera-to-world poses T_w1, T_w2).
    Returns (points (..., 3), valid (...,)): both depths positive and the
    rays not parallel."""
    c1, c2 = T_w1[:3, 3], T_w2[:3, 3]
    d1 = f1 @ T_w1[:3, :3].T
    d2 = f2 @ T_w2[:3, :3].T
    b = c2 - c1
    a11 = (d1 * d1).sum(-1)
    a12 = -(d1 * d2).sum(-1)
    a22 = (d2 * d2).sum(-1)
    b1 = (d1 * b).sum(-1)
    b2 = -(d2 * b).sum(-1)
    det = a11 * a22 - a12 * a12
    detsafe = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                          det)
    s = (a22 * b1 - a12 * b2) / detsafe
    t = (a11 * b2 - a12 * b1) / detsafe
    mid = 0.5 * ((c1 + s[..., None] * d1) + (c2 + t[..., None] * d2))
    return mid, (s > 1e-6) & (t > 1e-6) & (torch.abs(det) > 1e-10)


def stereo_depth(cam_bf: torch.Tensor, u_left: torch.Tensor,
                 u_right: torch.Tensor, min_disp: float = 0.5):
    """Rectified-stereo depth bf / (uL - uR). Returns (depth, valid)."""
    disp = u_left - u_right
    valid = disp > min_disp
    dsafe = torch.where(torch.abs(disp) < 1e-6, torch.full_like(disp, 1e-6),
                        disp)
    return cam_bf / dsafe, valid


def backproject(cam_fx, cam_fy, cam_cx, cam_cy, px: torch.Tensor,
                depth: torch.Tensor) -> torch.Tensor:
    """Pixels + depth -> camera-frame 3D points (..., 3)."""
    x = (px[..., 0] - cam_cx) / cam_fx * depth
    y = (px[..., 1] - cam_cy) / cam_fy * depth
    return torch.stack([x, y, depth], dim=-1)
