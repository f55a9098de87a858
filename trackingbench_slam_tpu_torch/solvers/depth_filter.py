"""Recursive Bayesian depth filter (SVO's), batched over seeds.

Port of trackingbench_slam_tpu/solvers/depth_filter.py: the Vogiatzis-
Hernandez Gaussian x Uniform posterior over inverse depth, updated in
closed form per observation, over a fixed-capacity seed table. A seed is
(mu, sigma2) of the Gaussian, (a, b) Beta pseudo-counts of inlier and
outlier observations, and z_range, the inverse-depth search range; it
converges when sigma < z_range / 200 with an inlier ratio above 0.5 and
diverges below 0.1.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SeedState(NamedTuple):
    mu: torch.Tensor       # (S,) inverse-depth mean
    sigma2: torch.Tensor   # (S,) inverse-depth variance
    a: torch.Tensor        # (S,) inlier pseudo-count
    b: torch.Tensor        # (S,) outlier pseudo-count
    z_range: torch.Tensor  # (S,) inverse-depth search range (1/z_min)
    valid: torch.Tensor    # (S,)

    @classmethod
    def init(cls, depth_mean: torch.Tensor, depth_min: torch.Tensor,
             valid: torch.Tensor) -> "SeedState":
        """Seeds around a coarse depth guess (SVO: the scene mean depth)."""
        z = 1.0 / torch.clamp(depth_mean, min=1e-6)
        zr = 1.0 / torch.clamp(depth_min, min=1e-6)
        return cls(mu=z, sigma2=(zr / 6.0) ** 2,
                   a=torch.full_like(z, 10.0), b=torch.full_like(z, 10.0),
                   z_range=zr, valid=valid)


def _angle(cos: torch.Tensor) -> torch.Tensor:
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def compute_tau(T_ref_cur_t: torch.Tensor, f: torch.Tensor, z: torch.Tensor,
                px_error_angle) -> torch.Tensor:
    """Depth standard deviation of one pixel of disparity: the triangle of
    the bearing f, the baseline t and a ray perturbed by px_error_angle."""
    t = T_ref_cur_t
    a = f * z[..., None] - t[None, :]
    t_norm = torch.linalg.norm(t)
    a_norm = torch.linalg.norm(a, dim=-1)
    alpha = _angle((f * t[None, :]).sum(-1) / torch.clamp(t_norm, min=1e-9))
    beta = _angle((a * -t[None, :]).sum(-1)
                  / torch.clamp(a_norm * t_norm, min=1e-9))
    beta_plus = beta + px_error_angle
    gamma_plus = math.pi - alpha - beta_plus
    z_plus = t_norm * torch.sin(beta_plus) / torch.clamp(
        torch.sin(gamma_plus), min=1e-9)
    return torch.abs(z_plus - z)


def update_seeds(seeds: SeedState, z_obs: torch.Tensor, tau2: torch.Tensor,
                 obs_valid: torch.Tensor) -> SeedState:
    """One Bayesian update per seed that is valid and observed (z_obs the
    observed INVERSE depth, tau2 its variance)."""
    mu, sigma2, a, b = seeds.mu, seeds.sigma2, seeds.a, seeds.b
    norm_scale = torch.sqrt(sigma2 + tau2)
    s2 = 1.0 / (1.0 / torch.clamp(sigma2, min=1e-12)
                + 1.0 / torch.clamp(tau2, min=1e-12))
    m = s2 * (mu / torch.clamp(sigma2, min=1e-12)
              + z_obs / torch.clamp(tau2, min=1e-12))
    gauss = torch.exp(-0.5 * ((z_obs - mu)
                              / torch.clamp(norm_scale, min=1e-9)) ** 2) \
        / torch.clamp(norm_scale * math.sqrt(2 * math.pi), min=1e-12)
    C1 = a / (a + b) * gauss
    C2 = b / (a + b) / torch.clamp(seeds.z_range, min=1e-9)
    norm = torch.clamp(C1 + C2, min=1e-12)
    C1 = C1 / norm
    C2 = C2 / norm
    f = C1 * (a + 1.0) / (a + b + 1.0) + C2 * a / (a + b + 1.0)
    e = C1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0)) \
        + C2 * a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0))
    mu_new = C1 * m + C2 * mu
    sigma2_new = C1 * (s2 + m * m) + C2 * (sigma2 + mu ** 2) - mu_new ** 2
    # Beta moment matching a = (e - f) / (f - e / f): the zero guard keeps
    # the denominator's sign
    denom = f - e / torch.clamp(f, min=1e-12)
    tiny = torch.where(denom < 0, torch.full_like(denom, -1e-12),
                       torch.full_like(denom, 1e-12))
    denom = torch.where(torch.abs(denom) < 1e-12, tiny, denom)
    a_new = (e - f) / denom
    b_new = a_new * (1.0 - f) / torch.clamp(f, min=1e-12)
    upd = obs_valid & seeds.valid
    return SeedState(
        mu=torch.where(upd, mu_new, mu),
        sigma2=torch.where(upd, torch.clamp(sigma2_new, min=1e-12), sigma2),
        a=torch.where(upd, torch.clamp(a_new, 1e-3, 1e4), a),
        b=torch.where(upd, torch.clamp(b_new, 1e-3, 1e4), b),
        z_range=seeds.z_range, valid=seeds.valid)


def seed_status(seeds: SeedState, sigma_thresh: float = 1.0 / 200.0,
                min_inlier_ratio: float = 0.5):
    """(converged, diverged) masks."""
    inlier_ratio = seeds.a / torch.clamp(seeds.a + seeds.b, min=1e-9)
    converged = (seeds.valid
                 & (torch.sqrt(seeds.sigma2) < sigma_thresh * seeds.z_range)
                 & (inlier_ratio > min_inlier_ratio))
    diverged = seeds.valid & (inlier_ratio < 0.1)
    return converged, diverged


def seed_depths(seeds: SeedState) -> torch.Tensor:
    return 1.0 / torch.clamp(seeds.mu, min=1e-9)


def depth_from_triangulation(T_cur_ref: torch.Tensor, f_ref: torch.Tensor,
                             f_cur: torch.Tensor):
    """Two-view depth along the reference bearing: the 2x2 least squares
    [R f_ref | -f_cur] [z_ref; z_cur] = -t per seed. Returns (z_ref (S,),
    ok (S,)), ok rejecting near-parallel rays and non-positive depths."""
    R = T_cur_ref[:3, :3]
    t = T_cur_ref[:3, 3]
    a = f_ref @ R.T
    b = -f_cur
    A11 = (a * a).sum(-1)
    A12 = (a * b).sum(-1)
    A22 = (b * b).sum(-1)
    r1 = -(a * t[None, :]).sum(-1)
    r2 = -(b * t[None, :]).sum(-1)
    det = A11 * A22 - A12 * A12
    ok = torch.abs(det) > 1e-8
    det_s = torch.where(ok, det, torch.ones_like(det))
    z_ref = (A22 * r1 - A12 * r2) / det_s
    z_cur = (A11 * r2 - A12 * r1) / det_s
    return z_ref, ok & (z_ref > 1e-3) & (z_cur > 1e-3)


def tau_inverse(z: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """A depth-domain std in the inverse-depth domain:
    0.5 (1 / max(z - tau, 1e-4) - 1 / (z + tau))."""
    lo = torch.clamp(z - tau, min=1e-4)
    return 0.5 * (1.0 / lo - 1.0 / (z + tau))
