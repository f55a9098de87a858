"""FrameState: fixed-capacity struct of tensors for one image.

Port of trackingbench_slam_tpu/models/frame.py (make_frame, with_keypoints,
add_keypoints, is_in_frustum). Field names and layouts are the
reference's; descriptors are (N, 8) int32 words with the reference's uint32
bits.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.models.map import free_slot_destinations
from trackingbench_slam_tpu_torch.ops import packing
from trackingbench_slam_tpu_torch.ops.image import build_pyramid


class FrameState(NamedTuple):
    pyramid: Tuple[torch.Tensor, ...]
    lk_pyr: Tuple[torch.Tensor, ...]   # separate x0.5 pyramid for LK
    kp_xy: torch.Tensor       # (N, 2) level-0 pixels
    kp_level: torch.Tensor    # (N,) int32
    kp_angle: torch.Tensor    # (N,)
    kp_response: torch.Tensor  # (N,)
    desc: torch.Tensor        # (N, 8) int32
    bearing: torch.Tensor     # (N, 3)
    map_idx: torch.Tensor     # (N,) int32, -1 = no landmark
    valid: torch.Tensor       # (N,) bool
    T_cw: torch.Tensor        # (4, 4)

    @property
    def capacity(self) -> int:
        return self.kp_xy.shape[0]


LK_LEVELS = 4


def empty_features(capacity: int, device) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return dict(
        kp_xy=torch.full((capacity, 2), -1.0, **f32),
        kp_level=torch.zeros((capacity,), **i32),
        kp_angle=torch.zeros((capacity,), **f32),
        kp_response=torch.zeros((capacity,), **f32),
        desc=torch.zeros((capacity, 8), **i32),
        bearing=torch.zeros((capacity, 3), **f32),
        map_idx=torch.full((capacity,), -1, **i32),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def make_frame(img: torch.Tensor, capacity: int, num_levels: int,
               scale: float, T_cw: torch.Tensor | None = None) -> FrameState:
    """Pyramids (x`scale` for extraction, 4-level x0.5 for LK) and empty
    feature arrays, on the image's device."""
    img = img.float()
    pyr = tuple(build_pyramid(img, num_levels, scale))
    lk_pyr = tuple(build_pyramid(img, LK_LEVELS, 0.5))
    if T_cw is None:
        T_cw = torch.eye(4, dtype=torch.float32, device=img.device)
    return FrameState(pyramid=pyr, lk_pyr=lk_pyr, T_cw=T_cw,
                      **empty_features(capacity, img.device))


def with_keypoints(frame: FrameState, cam: cam_mod.CameraParams,
                   kp_xy, kp_level, kp_angle, kp_response, desc,
                   valid) -> FrameState:
    """Install keypoints and their bearing vectors (Frame::SetKeys)."""
    bearing = cam_mod.cam2world(cam, kp_xy)
    bearing = torch.where(valid[:, None], bearing, torch.zeros_like(bearing))
    return frame._replace(
        kp_xy=kp_xy, kp_level=kp_level, kp_angle=kp_angle,
        kp_response=kp_response, desc=desc, valid=valid, bearing=bearing,
        map_idx=torch.where(valid, frame.map_idx,
                            torch.full_like(frame.map_idx, -1)))


def add_keypoints(frame: FrameState, cam: cam_mod.CameraParams,
                  kp_xy, kp_level, kp_response, map_idx,
                  new_valid) -> FrameState:
    """Masked insertion of aligned features into free slots (Frame::AddKey,
    Frame.cpp:139-163, used by the direct matcher's FeaturesAlign at
    matcher.cpp:1610-1617): the r-th new keypoint goes to the r-th free
    slot, so no two rows share a destination; those past the free count
    are dropped. Angles of the new rows are 0."""
    dest = free_slot_destinations(~frame.valid, new_valid)
    n = kp_xy.shape[0]
    dev = kp_xy.device
    (xy, level, angle, response, bearing, midx,
     valid) = packing.scatter_rows_set(
        [frame.kp_xy, frame.kp_level, frame.kp_angle, frame.kp_response,
         frame.bearing, frame.map_idx, frame.valid], dest,
        [kp_xy, kp_level, torch.zeros((n,), dtype=torch.float32, device=dev),
         kp_response, cam_mod.cam2world(cam, kp_xy), map_idx,
         torch.ones((n,), dtype=torch.bool, device=dev)])
    return frame._replace(kp_xy=xy, kp_level=level, kp_angle=angle,
                          kp_response=response, bearing=bearing,
                          map_idx=midx, valid=valid)


def is_in_frustum(frame: FrameState, cam: cam_mod.CameraParams,
                  points_w, normals, min_dist, max_dist,
                  view_cos_limit: float = 0.5):
    """Batched Frame::IsInFrustum. Returns (px (M, 2), depth (M,), ok (M,),
    view_cos (M,))."""
    pc = se3.transform_points(frame.T_cw, points_w)
    px = cam_mod.world2cam(cam, pc)
    depth = pc[..., 2]
    inb = cam_mod.is_in_frame(cam, px)
    cam_center = se3.inverse(frame.T_cw)[:3, 3]
    po = points_w - cam_center
    dist = torch.linalg.norm(po, dim=-1)
    dist_ok = (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
    view_cos = (po * normals).sum(-1) / torch.clamp(dist, min=1e-9)
    ok = (depth > 0) & inb & dist_ok & (view_cos > view_cos_limit)
    return px, depth, ok, view_cos
