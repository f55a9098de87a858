"""The interchangeable matching strategies.

Port of trackingbench_slam_tpu/matchers/matcher.py: `search_by_opflow`
(pyramidal LK from the previous frame + F-RANSAC), the four descriptor
matchers of the indirect tracker (`search_by_nn`, `search_by_bf`,
`search_by_window`, `search_by_projection_frame`),
`search_by_projection_map` (frustum projection of the map, masked Hamming
matrix against the top-4096 frustum-visible landmarks) and `search_by_bow`
(same-vocabulary-node mask), with `_finish`. Every descriptor matcher is a
masked Hamming matrix with its own candidate mask and accept rule; argmin
ties go to the lowest index, as jnp.argmin breaks them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.models.frame import (FrameState,
                                                       is_in_frustum)
from trackingbench_slam_tpu_torch.models.map import MapState
from trackingbench_slam_tpu_torch.ops import hamming
from trackingbench_slam_tpu_torch.ops import image as image_ops
from trackingbench_slam_tpu_torch.ops import orb as orb_ops
from trackingbench_slam_tpu_torch.ops.align import lk_pyramidal
from trackingbench_slam_tpu_torch.ops.fast import stable_topk
from trackingbench_slam_tpu_torch.ops.ransac import (draw_uniform,
                                                     fundamental_ransac)
from trackingbench_slam_tpu_torch.utils.config import MatcherConfig


class MatchResult(NamedTuple):
    idx: torch.Tensor
    dist: torch.Tensor
    ok: torch.Tensor


def _distance_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    return hamming.hamming_matrix_mxu(orb_ops.unpack_to_pm1(d1),
                                      orb_ops.unpack_to_pm1(d2))


def _finish(dist_masked, cfg: MatcherConfig, accept_th: float,
            use_ratio: bool, angles1=None, angles2=None,
            one_to_one: bool = True) -> MatchResult:
    idx, best, second = hamming.best_two(dist_masked)
    ok = best <= accept_th
    if use_ratio:
        ok = ok & hamming.ratio_filter(best, second, cfg.nn_ratio)
    if cfg.check_orientation and angles1 is not None:
        ok = hamming.rotation_histogram_mask(angles1, angles2, idx, ok,
                                             cfg.histo_length)
    if one_to_one:
        ok = hamming.resolve_duplicate_targets(idx, best, ok,
                                               dist_masked.shape[1])
    return MatchResult(idx=idx, dist=best, ok=ok)


def _level_band_mask(lvl1: torch.Tensor, lvl2: torch.Tensor,
                     band: int) -> torch.Tensor:
    return torch.abs(lvl1[:, None] - lvl2[None, :]) <= band


def _global_min_threshold(dm: torch.Tensor, cfg: MatcherConfig):
    """The NN/BF accept threshold min(ratio * max(global min, 1), cap)."""
    global_min = torch.clamp(dm.min(), min=1.0)
    return torch.clamp(cfg.min_dist_ratio * global_min, max=cfg.min_dist_cap)


def search_by_nn(f1_desc, f1_valid, f2_desc, f2_valid,
                 cfg: MatcherConfig = MatcherConfig()) -> MatchResult:
    """Exact nearest neighbours with the accept rule dist < min(ratio *
    max(global min, 1), cap), one-to-one."""
    dm = hamming.masked_distance(_distance_matrix(f1_desc, f2_desc),
                                 f1_valid, f2_valid)
    idx, best, _ = hamming.best_two(dm)
    ok = best < _global_min_threshold(dm, cfg)
    ok = hamming.resolve_duplicate_targets(idx, best, ok, dm.shape[1])
    return MatchResult(idx=idx, dist=best, ok=ok)


def search_by_bf(f1_desc, f1_valid, f2_desc, f2_valid,
                 cfg: MatcherConfig = MatcherConfig()) -> MatchResult:
    """Brute force with cross-check and the NN accept rule."""
    dm = hamming.masked_distance(_distance_matrix(f1_desc, f2_desc),
                                 f1_valid, f2_valid)
    idx, best, mutual = hamming.mutual_best(dm)
    ok = mutual & (best < _global_min_threshold(dm, cfg))
    return MatchResult(idx=idx, dist=best, ok=ok)


def search_by_window(f1: FrameState, f2: FrameState,
                     cfg: MatcherConfig = MatcherConfig()) -> MatchResult:
    """Windowed brute force: candidates within cfg.search_radius px and one
    level; accept best <= TH_LOW with the ratio test and the rotation
    histogram."""
    r = cfg.search_radius
    dpx = f1.kp_xy[:, None, :] - f2.kp_xy[None, :, :]
    within = (dpx * dpx).sum(-1) <= r * r
    lv = _level_band_mask(f1.kp_level, f2.kp_level, 1)
    dm = hamming.masked_distance(_distance_matrix(f1.desc, f2.desc),
                                 f1.valid, f2.valid, within & lv)
    return _finish(dm, cfg, float(cfg.th_low), use_ratio=True,
                   angles1=f1.kp_angle, angles2=f2.kp_angle)


def search_by_projection_frame(cam: cam_mod.CameraParams, f1: FrameState,
                               f2: FrameState, map_pos: torch.Tensor,
                               cfg: MatcherConfig = MatcherConfig(),
                               scale_factor: float = 0.8,
                               base_radius: float = 7.0) -> MatchResult:
    """Frame-to-frame projection search: F2's landmarks projected into F1,
    window-searched at an octave-scaled radius within one level, accept
    best <= TH_HIGH with the rotation histogram. idx indexes F2's
    features."""
    M = map_pos.shape[0]
    pts_w = map_pos[f2.map_idx.clamp(0, M - 1).long()]
    pc = se3.transform_points(f1.T_cw, pts_w)
    proj = cam_mod.world2cam(cam, pc)
    cand2 = (f2.valid & (f2.map_idx >= 0) & (pc[:, 2] > 0.05)
             & cam_mod.is_in_frame(cam, proj))
    inv = torch.full((), 1.0 / scale_factor, dtype=torch.float32,
                     device=map_pos.device)
    r = base_radius * torch.pow(inv, f2.kp_level.float())
    dpx = f1.kp_xy[:, None, :] - proj[None, :, :]
    within = (dpx * dpx).sum(-1) <= (r * r)[None, :]
    lv = _level_band_mask(f1.kp_level, f2.kp_level, 1)
    dm = hamming.masked_distance(_distance_matrix(f1.desc, f2.desc),
                                 f1.valid, cand2, within & lv)
    return _finish(dm, cfg, float(cfg.th_high), use_ratio=False,
                   angles1=f1.kp_angle, angles2=f2.kp_angle)


def search_by_projection_map(cam: cam_mod.CameraParams, f1: FrameState,
                             m: MapState,
                             cfg: MatcherConfig = MatcherConfig(),
                             scale_factor: float = 0.8, num_levels: int = 5,
                             base_radius: float = 4.0,
                             only_unlinked: bool = True,
                             accept_th: float | None = None,
                             use_ratio: bool = True,
                             max_candidates: int = 4096) -> MatchResult:
    """Map-to-frame projection search; idx indexes landmark slots. Above
    `max_candidates` slots, matching runs against the top frustum-visible,
    most-observed landmarks (ties to the lower slot, as jax.lax.top_k)."""
    M = m.pos.shape[0]
    px_all, _, vis_all, view_cos_all = is_in_frustum(
        f1, cam, m.pos, m.normal, m.min_dist, m.max_dist)
    vis_all = vis_all & m.valid
    if M > max_candidates:
        score = (vis_all.float() * 1e6
                 + torch.clamp(m.obs_count, max=1000).float())
        _, sel = stable_topk(score, max_candidates)
        px, vis, view_cos = px_all[sel], vis_all[sel], view_cos_all[sel]
        pos, desc, max_dist = m.pos[sel], m.desc[sel], m.max_dist[sel]
    else:
        sel = None
        px, vis, view_cos = px_all, vis_all, view_cos_all
        pos, desc, max_dist = m.pos, m.desc, m.max_dist
    cam_center = se3.inverse(f1.T_cw)[:3, 3]
    dist_w = torch.linalg.norm(pos - cam_center[None, :], dim=-1)
    ratio = torch.clamp(max_dist / torch.clamp(dist_w, min=1e-9), min=1e-9)
    inv = torch.full((), 1.0 / scale_factor, dtype=ratio.dtype,
                     device=ratio.device)
    log_inv = torch.log(inv)
    pred_lvl = torch.ceil(torch.log(ratio) / log_inv).int().clamp(
        0, num_levels - 1)
    r = torch.where(view_cos > 0.998, 2.5, base_radius)
    r = r * torch.pow(inv, pred_lvl.float())
    dpx = f1.kp_xy[:, None, :] - px[None, :, :]
    within = (dpx * dpx).sum(-1) <= (r * r)[None, :]
    lv = torch.abs(f1.kp_level[:, None] - pred_lvl[None, :]) <= 1
    free1 = f1.valid & (f1.map_idx < 0) if only_unlinked else f1.valid
    dist = _distance_matrix(f1.desc, desc)
    dm = hamming.masked_distance(dist, free1, vis, within & lv)
    th = float(cfg.th_high) if accept_th is None else float(accept_th)
    res = _finish(dm, cfg, th, use_ratio=use_ratio)
    if sel is not None:
        res = res._replace(idx=sel[res.idx.clamp(0, sel.shape[0] - 1)])
    return res


def search_by_bow(f1_desc, f1_valid, f1_node, f1_angle,
                  f2_desc, f2_valid, f2_node, f2_angle,
                  cfg: MatcherConfig = MatcherConfig()) -> MatchResult:
    """BoW-bucketed matching: candidates share a vocabulary node at the
    FeatureVector level (f*_node from bow.vocabulary.transform, -1 for
    invalid features); accept best <= TH_LOW with the ratio test and the
    rotation histogram."""
    same_node = (f1_node[:, None] == f2_node[None, :]) & (f1_node[:, None]
                                                          >= 0)
    dist = _distance_matrix(f1_desc, f2_desc)
    dm = hamming.masked_distance(dist, f1_valid, f2_valid, same_node)
    return _finish(dm, cfg, float(cfg.th_low), use_ratio=True,
                   angles1=f1_angle, angles2=f2_angle)


def search_by_opflow(f1: FrameState, f2: FrameState,
                     generator: torch.Generator | None = None,
                     cfg: MatcherConfig = MatcherConfig(),
                     scale: float = 0.8, use_ransac: bool = True,
                     num_levels: int | None = None,
                     init_offset: torch.Tensor | None = None,
                     uniform: torch.Tensor | None = None):
    """LK-track F2's keypoints into F1 (identity index matching), then
    reject with F-RANSAC. Returns (MatchResult, tracked_xy (N, 2)). RANSAC
    draws from `generator`, or uses the given `uniform` (256, N) draws.
    With cfg.equalize, LK runs on CLAHE-equalized copies of both LK
    pyramids (the frames keep theirs)."""
    f1_pyr, f2_pyr = f1.lk_pyr, f2.lk_pyr
    if cfg.equalize:
        f1_pyr = tuple(image_ops.clahe(p) for p in f1_pyr)
        f2_pyr = tuple(image_ops.clahe(p) for p in f2_pyr)
    res = lk_pyramidal(f2_pyr, f1_pyr, f2.kp_xy, f2.valid, 0.5,
                       half=10, iters=30,
                       num_levels=(num_levels if num_levels is not None
                                   else len(f2_pyr)),
                       init_offset=init_offset)
    h, w = f1.pyramid[0].shape
    inb = ((res.xy[:, 0] >= 0) & (res.xy[:, 0] < w)
           & (res.xy[:, 1] >= 0) & (res.xy[:, 1] < h))
    ok = f2.valid & res.converged & inb
    if use_ransac:
        if uniform is None:
            uniform = draw_uniform(256, ok.shape[0], generator, ok.device)
        inl, _ = fundamental_ransac(f2.kp_xy, res.xy, ok, uniform=uniform)
        ok = ok & inl
    n = f2.kp_xy.shape[0]
    return MatchResult(idx=torch.arange(n, device=ok.device), dist=res.error,
                       ok=ok), res.xy
