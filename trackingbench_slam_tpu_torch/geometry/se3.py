"""SE(3) Lie group operations on torch tensors.

Port of trackingbench_slam_tpu/geometry/se3.py. A pose is a (4, 4) float32
tensor; tangent vectors are (6,) = [rho(3), phi(3)], translation first (the
g2o SE3Quat ordering). Every function works on the device of its input.
"""

from __future__ import annotations

import torch


def hat(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (3,) -> (3, 3) skew-symmetric."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([
        torch.stack([zero, -v[2], v[1]]),
        torch.stack([v[2], zero, -v[0]]),
        torch.stack([-v[1], v[0], zero]),
    ])


def vee(m: torch.Tensor) -> torch.Tensor:
    return torch.stack([m[2, 1], m[0, 2], m[1, 0]])


def _sinc_terms(theta2: torch.Tensor):
    """(sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor below 1e-6."""
    small = theta2 < 1e-6
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (t - torch.sin(t)) / (t2 * t))
    return a, b, c


def so3_log(R: torch.Tensor) -> torch.Tensor:
    w = vee(R - R.T) * 0.5
    w2 = torch.dot(w, w)
    small = w2 < 1e-10
    sin_theta = torch.where(small, torch.zeros_like(w2),
                            torch.sqrt(torch.where(small, torch.ones_like(w2),
                                                   w2)))
    cos_theta = torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.atan2(sin_theta, cos_theta)
    sin_safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    scale = torch.where(small, 1.0 + theta * theta / 6.0, theta / sin_safe)
    return scale * w


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: (6,) [rho, phi] -> (4, 4)."""
    rho, phi = xi[:3], xi[3:]
    theta2 = torch.dot(phi, phi)
    a, b, c = _sinc_terms(theta2)
    K = hat(phi)
    KK = K @ K
    eye3 = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye3 + a * K + b * KK
    V = eye3 + b * K + c * KK
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = R
    T[:3, 3] = (V @ rho[:, None])[:, 0]
    return T


def log(T: torch.Tensor) -> torch.Tensor:
    """(4, 4) -> (6,) [rho, phi]."""
    R = T[:3, :3]
    t = T[:3, 3]
    phi = so3_log(R)
    theta2 = torch.dot(phi, phi)
    K = hat(phi)
    small = theta2 < 1e-6
    th2 = torch.where(small, torch.ones_like(theta2), theta2)
    th = torch.sqrt(th2)
    coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - (th * torch.sin(th)) / (2.0 * (1.0 - torch.cos(th)))) / th2)
    Vinv = (torch.eye(3, dtype=T.dtype, device=T.device) - 0.5 * K
            + coef * (K @ K))
    return torch.cat([(Vinv @ t[:, None])[:, 0], phi])


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) rigid transforms."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    Ti = torch.zeros_like(T)
    Ti[..., :3, :3] = Rt
    Ti[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
    Ti[..., 3, 3] = 1.0
    return Ti


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (4, 4) T to (..., 3) points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def normalize(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block with two Newton polar steps,
    R <- R (3I - R^T R) / 2."""
    R = T[:3, :3]
    I3 = torch.eye(3, dtype=T.dtype, device=T.device)
    for _ in range(2):
        RtR = R.T @ R
        R = (R @ (3.0 * I3 - RtR)) * 0.5
    return from_rt(R, T[:3, 3])
