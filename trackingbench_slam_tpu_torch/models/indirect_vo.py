"""Indirect (extract and match every frame) visual odometry.

Port of trackingbench_slam_tpu/models/indirect_vo.py: every frame is ORB-
extracted, matched against the previous frame by one of five
interchangeable strategies (`MatchStrategy`), its landmark links propagate
along the matches, the pose is optimized, and the frame becomes a keyframe
with stereo landmarks (models/vo.py `keyframe_step`).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from trackingbench_slam_tpu_torch.bow import vocabulary as bow
from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.matchers import matcher as matchers
from trackingbench_slam_tpu_torch.models import vo as vo_mod
from trackingbench_slam_tpu_torch.models.extractors import extract_orb
from trackingbench_slam_tpu_torch.models.frame import make_frame
from trackingbench_slam_tpu_torch.solvers import pose_opt
from trackingbench_slam_tpu_torch.utils.config import PipelineConfig
from trackingbench_slam_tpu_torch.utils.device import (resolve_device,
                                                       upload_image)

_stage = torch.profiler.record_function


class MatchStrategy(enum.Enum):
    NN = "nn"
    BF = "bf"
    WINDOW = "window"
    PROJECTION = "projection"
    BOW = "bow"


def match_frames(f_cur, prev, map_pos, cam: cam_mod.CameraParams,
                 cfg: PipelineConfig, strategy: str, voc=None):
    """The current frame's features matched against the previous frame's
    by `strategy`; idx indexes the previous frame's features."""
    if strategy == "nn":
        return matchers.search_by_nn(f_cur.desc, f_cur.valid, prev.desc,
                                     prev.valid, cfg.matcher)
    if strategy == "bf":
        return matchers.search_by_bf(f_cur.desc, f_cur.valid, prev.desc,
                                     prev.valid, cfg.matcher)
    if strategy == "window":
        return matchers.search_by_window(f_cur, prev, cfg.matcher)
    if strategy == "bow":
        _, nodes_cur = bow.transform(voc, f_cur.desc, f_cur.valid)
        _, nodes_prev = bow.transform(voc, prev.desc, prev.valid)
        return matchers.search_by_bow(
            f_cur.desc, f_cur.valid, nodes_cur, f_cur.kp_angle, prev.desc,
            prev.valid, nodes_prev, prev.kp_angle, cfg.matcher)
    if strategy == "projection":
        return matchers.search_by_projection_frame(
            cam, f_cur, prev, map_pos, cfg.matcher, cfg.pyramid.scale_factor)
    raise ValueError(f"unknown match strategy {strategy!r}")


def indirect_track_step(state: vo_mod.VOState, img: torch.Tensor,
                        img_right: torch.Tensor, cam: cam_mod.CameraParams,
                        cfg: PipelineConfig, strategy: str = "nn",
                        voc=None) -> vo_mod.VOState:
    """One frame: extract, match against the previous frame, propagate the
    landmark links, optimize the pose, then the stereo keyframe step."""
    with _stage("indirect.extract_orb"):
        f_cur = make_frame(img, cfg.extractor.num_features,
                           cfg.pyramid.num_levels, cfg.pyramid.scale_factor)
        f_cur = extract_orb(f_cur, cam, cfg.extractor, cfg.pyramid)
    f_cur = f_cur._replace(T_cw=state.T_cw)
    prev, m = state.prev, state.map
    with _stage("indirect.match"):
        res = match_frames(f_cur, prev, m.pos, cam, cfg, strategy, voc)
    M = m.capacity
    f_cur = f_cur._replace(map_idx=torch.where(
        res.ok, prev.map_idx[res.idx], torch.full_like(f_cur.map_idx, -1)))
    mp = f_cur.map_idx.clamp(0, M - 1).long()
    edges = (f_cur.map_idx >= 0) & f_cur.valid & m.valid[mp]
    inv_s2 = pose_opt.level_inv_sigma2(f_cur.kp_level,
                                       cfg.pyramid.scale_factor)
    with _stage("indirect.pose_optimization"):
        opt = pose_opt.pose_optimization(cam, state.T_cw, m.pos[mp],
                                         f_cur.kp_xy, inv_s2, edges,
                                         cfg.solver)
    f_cur = f_cur._replace(T_cw=opt.T_cw, map_idx=torch.where(
        edges & ~opt.inliers, torch.full_like(f_cur.map_idx, -1),
        f_cur.map_idx))
    state = state._replace(prev=f_cur, T_cw=opt.T_cw,
                           frame_id=state.frame_id + 1,
                           num_inliers=opt.num_inliers)
    with _stage("indirect.keyframe_step"):
        return vo_mod.keyframe_step(state, img_right, cam, cfg)


class IndirectVO:
    """Host driver: the stereo keyframe step on the first frame, then
    `indirect_track_step` on every frame."""

    def __init__(self, cfg: PipelineConfig,
                 strategy: MatchStrategy = MatchStrategy.NN, voc=None,
                 device=None):
        if strategy is MatchStrategy.BOW and voc is None:
            raise ValueError("MatchStrategy.BOW needs a trained "
                             "bow.Vocabulary (voc=...)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cam = cam_mod.CameraParams.from_config(cfg.camera, self.device)
        self.strategy = strategy
        self.voc = voc
        self.state: Optional[vo_mod.VOState] = None
        self.trajectory: list = []

    def track(self, img_left, img_right) -> vo_mod.VOState:
        img_left = upload_image(img_left, self.device)
        img_right = upload_image(img_right, self.device)
        if self.state is None:
            state = vo_mod.init_state(self.cfg, img_left)
            state = vo_mod.keyframe_step(state, img_right, self.cam, self.cfg)
            self.state = state._replace(frame_id=state.frame_id + 1)
        else:
            self.state = indirect_track_step(
                self.state, img_left, img_right, self.cam, self.cfg,
                strategy=self.strategy.value, voc=self.voc)
        self.trajectory.append(self.state.T_cw)
        return self.state

    def poses(self) -> np.ndarray:
        return torch.stack(self.trajectory).cpu().numpy()
