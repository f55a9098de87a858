"""Pinhole camera with radial-tangential distortion, batched over points.

Port of trackingbench_slam_tpu/geometry/camera.py. Parameters are 0-d
float32 tensors on the pipeline's device, so every product is taken in
float32 as in the reference. Undistortion (`undistort_points`,
`undistort_map`, `undistort_image`) is plain PyTorch, as it is plain XLA in
the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trackingbench_slam_tpu_torch.ops.image import bilinear_sample
from trackingbench_slam_tpu_torch.utils.config import CameraConfig


class CameraParams(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # (5,) = k1, k2, p1, p2, k3
    size: torch.Tensor  # (2,) = (width, height)
    bf: torch.Tensor

    @classmethod
    def from_config(cls, c: CameraConfig, device,
                    dtype=torch.float32) -> "CameraParams":
        def t(v):
            return torch.tensor(v, dtype=dtype, device=device)
        return cls(fx=t(c.fx), fy=t(c.fy), cx=t(c.cx), cy=t(c.cy),
                   dist=t([c.k1, c.k2, c.p1, c.p2, c.k3]),
                   size=t([float(c.width), float(c.height)]), bf=t(c.bf))


def distort_normalized(cam: CameraParams, xy: torch.Tensor) -> torch.Tensor:
    x, y = xy[..., 0], xy[..., 1]
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(cam: CameraParams, xy_d: torch.Tensor,
                         iters: int = 8) -> torch.Tensor:
    xy = xy_d
    for _ in range(iters):
        delta = distort_normalized(cam, xy) - xy
        xy = xy_d - delta
    return xy


def world2cam(cam: CameraParams, pts_cam: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixels."""
    z = pts_cam[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    xy = pts_cam[..., :2] / zsafe[..., None]
    xy = distort_normalized(cam, xy)
    u = cam.fx * xy[..., 0] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def cam2world(cam: CameraParams, px: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixels -> (..., 3) unit bearing vectors."""
    x = (px[..., 0] - cam.cx) / cam.fx
    y = (px[..., 1] - cam.cy) / cam.fy
    xy = undistort_normalized(cam, torch.stack([x, y], dim=-1))
    v = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def undistort_points(cam: CameraParams, px: torch.Tensor) -> torch.Tensor:
    """Distorted pixels (..., 2) -> undistorted pixels (reference
    CameraModel.cpp:104-121)."""
    x = (px[..., 0] - cam.cx) / cam.fx
    y = (px[..., 1] - cam.cy) / cam.fy
    xy = undistort_normalized(cam, torch.stack([x, y], dim=-1))
    return torch.stack([cam.fx * xy[..., 0] + cam.cx,
                        cam.fy * xy[..., 1] + cam.cy], dim=-1)


def undistort_map(cam: CameraParams, height: int, width: int) -> torch.Tensor:
    """(H, W, 2) float32: for each undistorted output pixel, the distorted
    source coordinate (x, y) to sample; the reference's
    cv::initUndistortRectifyMap table (CameraModel.cpp:14-27)."""
    f32 = dict(dtype=torch.float32, device=cam.fx.device)
    v, u = torch.meshgrid(torch.arange(height, **f32),
                          torch.arange(width, **f32), indexing="ij")
    xy = distort_normalized(cam, torch.stack([(u - cam.cx) / cam.fx,
                                              (v - cam.cy) / cam.fy], dim=-1))
    return torch.stack([cam.fx * xy[..., 0] + cam.cx,
                        cam.fy * xy[..., 1] + cam.cy], dim=-1)


def undistort_image(cam: CameraParams, img: torch.Tensor) -> torch.Tensor:
    """The undistorted (H, W) float32 image: one bilinear gather through
    `undistort_map` (cv::remap, CameraModel.cpp:96-102); taps outside the
    image read 0."""
    h, w = img.shape
    return bilinear_sample(img.float(), undistort_map(cam, h, w))


def is_in_frame(cam: CameraParams, px: torch.Tensor,
                boundary: float = 0.0) -> torch.Tensor:
    """(..., 2) -> (...,) bool, at pyramid level 0."""
    w = cam.size[0]
    h = cam.size[1]
    u, v = px[..., 0], px[..., 1]
    return ((u >= boundary) & (v >= boundary) & (u < w - boundary)
            & (v < h - boundary))


def project_jacobian(cam: CameraParams, pts_cam: torch.Tensor) -> torch.Tensor:
    """d(pixel)/d(xi) for camera-frame points: (..., 3) -> (..., 2, 6), for a
    left-multiplied [rho, phi] increment, distortion treated as identity."""
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    zs = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    zi = 1.0 / zs
    zi2 = zi * zi
    fx, fy = cam.fx, cam.fy
    zero = torch.zeros_like(x)
    du = torch.stack([fx * zi, zero, -fx * x * zi2, -fx * x * y * zi2,
                      fx * (1.0 + x * x * zi2), -fx * y * zi], dim=-1)
    dv = torch.stack([zero, fy * zi, -fy * y * zi2,
                      -fy * (1.0 + y * y * zi2), fy * x * y * zi2,
                      fy * x * zi], dim=-1)
    return torch.stack([du, dv], dim=-2)
