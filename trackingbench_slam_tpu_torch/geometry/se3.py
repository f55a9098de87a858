"""SE(3) Lie group operations on torch tensors.

Port of trackingbench_slam_tpu/geometry/se3.py. A pose is a (4, 4) float32
tensor; tangent vectors are (6,) = [rho(3), phi(3)], translation first (the
g2o SE3Quat ordering). Every function works on the device of its input and
over any leading batch dimensions ((..., 6) tangents, (..., 4, 4) poses).

The functions are pure (no in-place writes) so that torch.func can
differentiate and vmap them: the pose graph takes its edge Jacobians with
torch.func.jacfwd. The small-angle branches are double-where guarded, as in
the reference: the branch not taken is evaluated at a safe argument, so its
derivative stays finite at the identity. Squared norms and traces keep a
trailing axis of 1: forward-mode AD of a 0-d float32 tensor times a Python
float gives a float64 tangent in some torch releases, and under vmap every
per-pose scalar would be 0-d.
"""

from __future__ import annotations

import torch

from trackingbench_slam_tpu_torch.ops.linalg import dot, small_matmul


def hat(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ], -2)


def vee(m: torch.Tensor) -> torch.Tensor:
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], -1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n) x (..., n) -> (..., 1), summed in order."""
    return dot(a, b)[..., None]


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
    w = vee(R - R.transpose(-1, -2)) * 0.5
    w2 = _dot(w, w)
    small = w2 < 1e-10
    sin_theta = torch.where(small, torch.zeros_like(w2),
                            torch.sqrt(torch.where(small, torch.ones_like(w2),
                                                   w2)))
    trace = R[..., 0, 0:1] + R[..., 1, 1:2] + R[..., 2, 2:3]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.atan2(sin_theta, cos_theta)
    sin_safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    scale = torch.where(small, 1.0 + theta * theta / 6.0, theta / sin_safe)
    return scale * w


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation and (..., 3) translation -> (..., 4, 4)."""
    top = torch.cat([R, t[..., None]], -1)
    # filled on the device: a host-built row would be a synchronous copy
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], -2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: (..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    a, b, c = (s[..., None] for s in _sinc_terms(_dot(phi, phi)))
    K = hat(phi)
    KK = small_matmul(K, K)
    eye3 = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye3 + a * K + b * KK
    V = eye3 + b * K + c * KK
    return from_rt(R, small_matmul(V, rho[..., None])[..., 0])


def log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [rho, phi].

    V^-1 = I - K/2 + coef K^2 with coef = (1 - (t/2) cot(t/2)) / t^2. The
    reference writes the cotangent as t sin t / (2 (1 - cos t)), whose
    1 - cos t cancels in float32 for small angles (at t = 1e-3 coef is off
    by ~6e4, the residual by ~6% of its translation); the half-angle form
    keeps the error at one rounding of 1."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta2 = _dot(phi, phi)
    K = hat(phi)
    small = theta2 < 1e-6
    th2 = torch.where(small, torch.ones_like(theta2), theta2)
    half = 0.5 * torch.sqrt(th2)
    coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / th2)
    Vinv = (torch.eye(3, dtype=T.dtype, device=T.device) - 0.5 * K
            + coef[..., None] * small_matmul(K, K))
    return torch.cat([small_matmul(Vinv, t[..., None])[..., 0], phi], -1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) rigid transforms."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return from_rt(Rt, -small_matmul(Rt, T[..., :3, 3:])[..., 0])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return small_matmul(A, B)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (4, 4) T to (..., 3) points. A plain product: unlike the
    (4, 4) and (3, 3) ones above, it gave the same bits under a batch on
    the H100 (parallel/batch_check.py)."""
    return pts @ T[:3, :3].T + T[:3, 3]


def normalize(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block of (..., 4, 4) poses with two
    Newton polar steps, R <- R (3I - R^T R) / 2."""
    R = T[..., :3, :3]
    I3 = torch.eye(3, dtype=T.dtype, device=T.device)
    for _ in range(2):
        RtR = small_matmul(R.transpose(-1, -2), R)
        R = small_matmul(R, 3.0 * I3 - RtR) * 0.5
    return from_rt(R, T[..., :3, 3])
