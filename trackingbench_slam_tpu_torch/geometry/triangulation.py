"""Stereo depth and back-projection (port of the parts of
trackingbench_slam_tpu/geometry/triangulation.py the stereo-VO path uses)."""

from __future__ import annotations

import torch


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
