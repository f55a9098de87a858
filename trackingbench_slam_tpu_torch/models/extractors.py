"""ORB extraction: FAST + grid top-k + IC angle + rBRIEF on every level;
and the direct tracker's FAST + Shi-Tomasi extraction.

Port of trackingbench_slam_tpu/models/extractors.py (extract_orb,
extract_fast and their helpers), following the reference's TPU branch.
`extract_fast` makes one FAST launch for its levels. Two launches on the card
for all levels: the FAST kernel (ops/cuda/fast_kernel.py) scores every
level, then, once each level's keypoints and blurred image are known, the
fused ORB-describe kernel (ops/cuda/patch_kernel.py `orb_describe`) takes
each keypoint's IC angle from the raw level and its rBRIEF bits from the
blurred level. Its plain version, `orb_describe_plain` in the same module,
cuts the 32x32 patches and runs ops/orb.py's math on them level by level.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.models.frame import (FrameState,
                                                       with_keypoints)
from trackingbench_slam_tpu_torch.ops import fast as fast_ops
from trackingbench_slam_tpu_torch.ops import image as image_ops
from trackingbench_slam_tpu_torch.ops.cuda.fast_kernel import \
    fast_score_nms_levels
from trackingbench_slam_tpu_torch.ops.cuda.patch_kernel import orb_describe
from trackingbench_slam_tpu_torch.utils.config import (ExtractorConfig,
                                                       PyramidConfig)


def detect_scores(pyramid, threshold: float, arc: int) -> list[torch.Tensor]:
    """NMS'd FAST score map of every pyramid level (the FAST kernel)."""
    return fast_score_nms_levels(pyramid, threshold, arc)


def level_budgets(total: int, num_levels: int, scale: float) -> list[int]:
    """Geometric per-level split, sum == total."""
    weights = [scale ** lvl for lvl in range(num_levels)]
    s = sum(weights)
    out = [int(round(total * w / s)) for w in weights]
    out[0] += total - sum(out)
    return out


def occupancy_mask(shape_hw, existing_xy: torch.Tensor,
                   existing_valid: torch.Tensor, radius: int) -> torch.Tensor:
    """(H, W) float mask, 0 within `radius` (Chebyshev) of any valid
    keypoint. The reference builds the presence image with a one-hot matrix
    product to avoid TPU scatters; an indexed write followed by max-pool
    dilation gives the same mask."""
    h, w = shape_hw
    xi = torch.round(existing_xy[:, 0]).clamp(0, w - 1).long()
    yi = torch.round(existing_xy[:, 1]).clamp(0, h - 1).long()
    occ = torch.zeros((h, w), dtype=torch.float32,
                      device=existing_xy.device).index_put(
        (yi, xi), existing_valid.float(), accumulate=True)
    occ = (occ > 0.0).float()
    k = 2 * radius + 1
    occ = F.max_pool2d(occ[None, None], k, stride=1, padding=radius)[0, 0]
    return 1.0 - occ


def detect_orb(frame: FrameState, config: ExtractorConfig,
               pyr_cfg: PyramidConfig, suppress_xy: torch.Tensor | None = None,
               suppress_valid: torch.Tensor | None = None):
    """Keypoints of every level, before they are described: (xy (N, 2)
    level coordinates, resp (N,), valid (N,), blurred levels, budgets), rows
    in level order, budgets[l] rows for level l."""
    num_levels = len(frame.pyramid)
    budgets = level_budgets(config.num_features, num_levels,
                            pyr_cfg.scale_factor)
    # every level's score map first: one kernel launch per threshold
    scores = detect_scores(frame.pyramid, float(config.min_threshold),
                           config.fast_arc)
    strongs = [None] * num_levels
    if config.init_threshold > config.min_threshold:
        strongs = [s > 0 for s in detect_scores(
            frame.pyramid, float(config.init_threshold), config.fast_arc)]
    all_xy, all_resp, all_valid, blurred = [], [], [], []
    for lvl in range(num_levels):
        img = frame.pyramid[lvl]
        s = pyr_cfg.scale_factor ** lvl
        score, strong = scores[lvl], strongs[lvl]
        if suppress_xy is not None:
            m = occupancy_mask(img.shape, suppress_xy * s, suppress_valid,
                               max(int(10 * s), 2))
            score = score * m
        cell = max(int(config.cell_size * s), 8)
        xy, resp, valid = fast_ops.grid_topk(score, cell, per_cell=4,
                                             budget=budgets[lvl],
                                             strong=strong)
        all_xy.append(xy)
        all_resp.append(resp)
        all_valid.append(valid)
        blurred.append(image_ops.gaussian_blur(img))
    return (torch.cat(all_xy), torch.cat(all_resp), torch.cat(all_valid),
            blurred, budgets)


def extract_orb(frame: FrameState, cam: cam_mod.CameraParams,
                config: ExtractorConfig, pyr_cfg: PyramidConfig,
                suppress_xy: torch.Tensor | None = None,
                suppress_valid: torch.Tensor | None = None) -> FrameState:
    """ORB over the frame's pyramid; with suppress_xy/valid it behaves like
    AddPoints (no keypoints near live features)."""
    xy, resp, valid, blurred, budgets = detect_orb(
        frame, config, pyr_cfg, suppress_xy, suppress_valid)
    dev = frame.kp_xy.device
    # the IC angle comes from the pre-blur levels, BRIEF from the blurred
    # ones (as the reference computes them): one launch for all levels
    angle, desc = orb_describe(frame.pyramid, blurred, xy, valid, budgets)
    kp_xy = torch.cat([lvl_xy / (pyr_cfg.scale_factor ** lvl)
                       for lvl, lvl_xy in enumerate(xy.split(budgets))])
    level = torch.cat([torch.full((b,), lvl, dtype=torch.int32, device=dev)
                       for lvl, b in enumerate(budgets)])
    cap = frame.capacity
    n = kp_xy.shape[0]
    if n < cap:
        def pad(x, value=0):
            tail = torch.full((cap - n,) + tuple(x.shape[1:]), value,
                              dtype=x.dtype, device=dev)
            return torch.cat([x, tail])
        kp_xy, resp, valid = pad(kp_xy, -1.0), pad(resp), pad(valid)
        level, angle, desc = pad(level), pad(angle), pad(desc)
    elif n > cap:
        key = torch.where(valid, -resp, torch.full_like(resp, 1e9))
        order = torch.sort(key, stable=True).indices[:cap]
        kp_xy, resp, valid = kp_xy[order], resp[order], valid[order]
        level, angle, desc = level[order], angle[order], desc[order]
    return with_keypoints(frame, cam, kp_xy, level, angle, resp, desc, valid)


def extract_fast(frame: FrameState, cam: cam_mod.CameraParams,
                 config: ExtractorConfig, pyr_cfg: PyramidConfig,
                 num_levels: int = 3,
                 suppress_xy: torch.Tensor | None = None,
                 suppress_valid: torch.Tensor | None = None) -> FrameState:
    """SVO-style detection: FAST corners of the first `num_levels` levels
    (one kernel launch) scored by Shi-Tomasi, one winner per grid cell, no
    descriptors. With suppress_xy/valid, nothing is taken within half a cell
    of a live feature."""
    budgets = level_budgets(config.num_features, num_levels,
                            pyr_cfg.scale_factor)
    scores = detect_scores(frame.pyramid[:num_levels],
                           float(config.min_threshold), config.fast_arc)
    dev = frame.kp_xy.device
    all_xy, all_resp, all_valid, all_level = [], [], [], []
    for lvl in range(num_levels):
        img = frame.pyramid[lvl]
        s = pyr_cfg.scale_factor ** lvl
        st = fast_ops.shi_tomasi_map(img)
        score = torch.where(scores[lvl] > 0, st, torch.zeros_like(st))
        if suppress_xy is not None:
            m = occupancy_mask(img.shape, suppress_xy * s, suppress_valid,
                               max(int(config.cell_size * s) // 2, 2))
            score = score * m
        cell = max(int(config.cell_size * s), 8)
        xy, resp, valid = fast_ops.grid_topk(score, cell, per_cell=1,
                                             budget=budgets[lvl])
        all_xy.append(xy / s)
        all_resp.append(resp)
        all_valid.append(valid)
        all_level.append(torch.full((budgets[lvl],), lvl, dtype=torch.int32,
                                    device=dev))
    kp_xy, resp = torch.cat(all_xy), torch.cat(all_resp)
    valid, level = torch.cat(all_valid), torch.cat(all_level)
    cap = frame.capacity
    n = kp_xy.shape[0]
    if n < cap:
        def pad(x, value=0):
            tail = torch.full((cap - n,) + tuple(x.shape[1:]), value,
                              dtype=x.dtype, device=dev)
            return torch.cat([x, tail])
        kp_xy, resp, valid, level = (pad(kp_xy, -1.0), pad(resp), pad(valid),
                                     pad(level))
    angle = torch.zeros((cap,), dtype=frame.kp_angle.dtype, device=dev)
    desc = torch.zeros((cap, 8), dtype=torch.int32, device=dev)
    return with_keypoints(frame, cam, kp_xy[:cap], level[:cap], angle,
                          resp[:cap], desc, valid[:cap])
