"""Direct (SVO-style) visual odometry with a live depth filter.

Port of trackingbench_slam_tpu/models/direct_vo.py. Per frame:
  1. sparse image alignment against the reference keyframe
     (matchers/direct.py);
  2. feature alignment of its landmarks into the frame;
  3. motion-only pose optimization on the aligned positions;
  4. a depth-filter round (solvers/depth_filter.py): every live seed batch
     is tracked from its origin keyframe into the frame by the LK kernel
     (half 6, 2 levels, the seed's belief as the prior; one launch a
     batch), triangulated and updated; converged seeds become landmarks of
     the reference keyframe, diverged ones die.
Every `keyframe_every` frames, FAST + Shi-Tomasi re-extraction makes a new
reference keyframe: the still-visible landmarks carry over, stereo depth
(when a right image is given) adds landmarks, and the other corners become
a new seed batch. Only the bootstrap frame needs stereo.

Everything stays on the device; the `num_tracked` and `num_promoted`
properties are the only host reads.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.geometry import triangulation as tri
from trackingbench_slam_tpu_torch.matchers import direct
from trackingbench_slam_tpu_torch.models.extractors import extract_fast
from trackingbench_slam_tpu_torch.models.frame import FrameState, make_frame
from trackingbench_slam_tpu_torch.models.map import free_slot_destinations
from trackingbench_slam_tpu_torch.ops import packing
from trackingbench_slam_tpu_torch.ops.align import lk_pyramidal
from trackingbench_slam_tpu_torch.solvers import depth_filter as df
from trackingbench_slam_tpu_torch.solvers import pose_opt
from trackingbench_slam_tpu_torch.utils.config import PipelineConfig
from trackingbench_slam_tpu_torch.utils.device import (resolve_device,
                                                       upload_image)
from trackingbench_slam_tpu_torch.utils.profiling import stage


def unit_bearings(cam: cam_mod.CameraParams, px: torch.Tensor):
    """(N, 2) pixels -> (N, 3) unit rays of the undistorted pinhole."""
    xn = (px[:, 0] - cam.cx) / cam.fx
    yn = (px[:, 1] - cam.cy) / cam.fy
    f = torch.stack([xn, yn, torch.ones_like(xn)], -1)
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


class DirectVO:
    max_seed_batches = 3

    def __init__(self, cfg: PipelineConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cam = cam_mod.CameraParams.from_config(cfg.camera, self.device)
        self.kf: Optional[FrameState] = None     # reference keyframe
        self.kf_depth = None                     # (N,) z-depth in the keyframe
        self.kf_pos_w = None                     # (N, 3) landmark positions
        self.kf_has_lm = None                    # (N,) landmark-bearing rows
        # seed batches, each with its origin keyframe's pyramid and pose
        self.seed_batches: list[dict] = []
        self.T_cw = torch.eye(4, dtype=torch.float32, device=self.device)
        self.trajectory: list = []
        self.frame_id = 0
        self.last_mean_depth = torch.tensor(8.0, device=self.device)
        self.num_tracked_dev = torch.zeros((), dtype=torch.int32,
                                           device=self.device)
        self.num_promoted_dev = torch.zeros((), dtype=torch.int32,
                                            device=self.device)

    @property
    def num_tracked(self) -> int:
        return int(self.num_tracked_dev)

    @property
    def num_promoted(self) -> int:
        return int(self.num_promoted_dev)

    # ------------------------------------------------------------ keyframe

    def _make_keyframe(self, img_left, img_right, T_cw, carry_pos_w=None,
                       carry_px=None, carry_ok=None):
        """New reference keyframe: carried landmarks take free rows first,
        then plain corners' rows (never stereo landmarks'); stereo LK depth
        with the fused back-track adds landmarks; every other corner seeds
        the depth filter around the scene's mean depth."""
        cfg, cam = self.cfg, self.cam
        dev = self.device
        f = make_frame(img_left, cfg.extractor.num_features,
                       cfg.pyramid.num_levels, cfg.pyramid.scale_factor)
        with stage("direct.extract_fast"):
            f = extract_fast(f, cam, cfg.extractor, cfg.pyramid,
                             num_levels=min(3, cfg.pyramid.num_levels),
                             suppress_xy=carry_px, suppress_valid=carry_ok)
        f = f._replace(T_cw=T_cw)
        cap = f.capacity
        if img_right is not None:
            right = make_frame(img_right, 1, cfg.pyramid.num_levels,
                               cfg.pyramid.scale_factor)
            lk = lk_pyramidal(f.lk_pyr, right.lk_pyr, f.kp_xy, f.valid, 0.5,
                              half=10, iters=30, num_levels=len(f.lk_pyr),
                              fb_iters=10)
            fb_ok = lk.fb_conv & (lk.fb_d2 < 1.0)
            depth, disp_ok = tri.stereo_depth(cam.bf, f.kp_xy[:, 0],
                                              lk.xy[:, 0])
            has_lm = (f.valid & lk.converged & fb_ok & disp_ok
                      & (torch.abs(lk.xy[:, 1] - f.kp_xy[:, 1]) < 2.0)
                      & (depth > 0.1) & (depth < 400.0))
        else:
            depth = torch.zeros((cap,), dtype=torch.float32, device=dev)
            has_lm = torch.zeros((cap,), dtype=torch.bool, device=dev)
        p_cam = tri.backproject(cam.fx, cam.fy, cam.cx, cam.cy, f.kp_xy,
                                depth)
        p_w = se3.transform_points(se3.inverse(T_cw), p_cam)

        if carry_pos_w is not None:
            p_c = se3.transform_points(T_cw, carry_pos_w)
            keep = (carry_ok & (p_c[:, 2] > 0.05)
                    & cam_mod.is_in_frame(cam, carry_px, boundary=8.0))
            zero, one = torch.zeros_like(f.kp_level), torch.ones_like(
                f.kp_level)
            klass = torch.where(~f.valid, zero, torch.where(~has_lm, one,
                                                            2 * one))
            order = torch.sort(klass, stable=True).indices   # free, corners
            n_slots = (klass < 2).sum()
            want_rank = torch.cumsum(keep.int(), 0) - 1
            take = keep & (want_rank < n_slots)
            dest = torch.where(take, order[want_rank.clamp(0, cap - 1)],
                               torch.full_like(order, cap))
            n = carry_px.shape[0]
            (kp_xy, kp_level, bearing, valid, has_lm, depth, p_w
             ) = packing.scatter_rows_set(
                [f.kp_xy, f.kp_level, f.bearing, f.valid, has_lm, depth, p_w],
                dest,
                [carry_px, torch.zeros((n,), dtype=torch.int32, device=dev),
                 unit_bearings(cam, carry_px),
                 torch.ones((n,), dtype=torch.bool, device=dev),
                 torch.ones((n,), dtype=torch.bool, device=dev),
                 p_c[:, 2], carry_pos_w])
            f = f._replace(kp_xy=kp_xy, kp_level=kp_level, bearing=bearing,
                           valid=valid)

        self.kf = f
        self.kf_has_lm = has_lm
        self.kf_depth = torch.where(has_lm, depth, torch.zeros_like(depth))
        self.kf_pos_w = p_w

        # seeds for the corners without depth, around the landmarks' mean
        # depth (or the last keyframe's, for a keyframe without any)
        n_lm = has_lm.sum()
        mean_d = torch.where(
            n_lm > 0,
            torch.where(has_lm, depth, torch.zeros_like(depth)).sum()
            / torch.clamp(n_lm, min=1), self.last_mean_depth)
        self.last_mean_depth = mean_d
        min_d = torch.clamp(0.05 * mean_d, min=0.2)
        self.seed_batches.append(dict(
            seeds=df.SeedState.init(mean_d.repeat(cap), min_d.repeat(cap),
                                    f.valid & ~has_lm),
            lk_pyr=f.lk_pyr, kp_xy=f.kp_xy, bearing=f.bearing, T_cw=T_cw))
        self.seed_batches = self.seed_batches[-self.max_seed_batches:]

    # --------------------------------------------------------- seed update

    def _update_seeds(self, cur: FrameState):
        """One depth-filter round over every live seed batch; promotion and
        retirement are masked writes, nothing is read on the host."""
        cam = self.cam
        px_err_angle = torch.arctan(0.5 / cam.fx) * 2.0
        for b in self.seed_batches:
            s = b["seeds"]
            T_ref_w = b["T_cw"]
            T_cur_ref = se3.compose(self.T_cw, se3.inverse(T_ref_w))
            f_ref = b["bearing"]
            z_ray = 1.0 / torch.clamp(s.mu, min=1e-6)
            p_cur = se3.transform_points(T_cur_ref, f_ref * z_ray[:, None])
            px_pred = cam_mod.world2cam(cam, p_cur)
            trackable = (s.valid & (p_cur[:, 2] > 0.05)
                         & cam_mod.is_in_frame(cam, px_pred, boundary=12.0))
            lk = lk_pyramidal(b["lk_pyr"], cur.lk_pyr, b["kp_xy"], trackable,
                              0.5, half=6, iters=20, num_levels=2,
                              init_offset=px_pred - b["kp_xy"])
            f_cur = unit_bearings(cam, lk.xy)
            z_obs, tri_ok = df.depth_from_triangulation(T_cur_ref, f_ref,
                                                        f_cur)
            T_ref_cur = se3.inverse(T_cur_ref)
            tau = df.compute_tau(T_ref_cur[:3, 3], f_ref, z_obs,
                                 px_err_angle)
            tau2 = df.tau_inverse(z_obs, tau) ** 2
            obs_ok = trackable & lk.converged & tri_ok
            s = df.update_seeds(s, 1.0 / torch.clamp(z_obs, min=1e-6), tau2,
                                obs_ok)
            conv, div = df.seed_status(s)
            z_ray = 1.0 / torch.clamp(s.mu, min=1e-6)
            p_w = se3.transform_points(se3.inverse(T_ref_w),
                                       f_ref * z_ray[:, None])
            self._promote(conv, p_w)
            b["seeds"] = s._replace(valid=s.valid & ~(conv | div))

    def _promote(self, conv: torch.Tensor, pos_w: torch.Tensor):
        """Converged seeds become landmarks of the reference keyframe at
        their projections, in rows that hold no landmark."""
        kf = self.kf
        p_c = se3.transform_points(kf.T_cw, pos_w)
        px = cam_mod.world2cam(self.cam, p_c)
        ok = (conv & (p_c[:, 2] > 0.05)
              & cam_mod.is_in_frame(self.cam, px, boundary=8.0))
        dest = free_slot_destinations(~self.kf_has_lm, ok)
        ones = torch.ones_like(ok)
        kp_xy, valid, has_lm, depth, pos = packing.scatter_rows_set(
            [kf.kp_xy, kf.valid, self.kf_has_lm, self.kf_depth,
             self.kf_pos_w], dest, [px, ones, ones, p_c[:, 2], pos_w])
        self.kf = kf._replace(kp_xy=kp_xy, valid=valid)
        self.kf_has_lm = has_lm
        self.kf_depth = depth
        self.kf_pos_w = pos
        self.num_promoted_dev = self.num_promoted_dev + ok.sum(
            dtype=torch.int32)

    # -------------------------------------------------------------- track

    def track(self, img_left, img_right=None) -> torch.Tensor:
        cfg = self.cfg
        img_left = upload_image(img_left, self.device)
        if img_right is not None:
            img_right = upload_image(img_right, self.device)
        if self.kf is None:
            if img_right is None:
                raise ValueError("DirectVO needs a stereo pair on its first "
                                 "frame")
            self._make_keyframe(img_left, img_right, self.T_cw)
            self.trajectory.append(self.T_cw)
            self.frame_id += 1
            return self.T_cw

        cur = make_frame(img_left, cfg.extractor.num_features,
                         cfg.pyramid.num_levels, cfg.pyramid.scale_factor)
        kf = self.kf
        T_init = se3.compose(self.T_cw, se3.inverse(kf.T_cw))
        with stage("direct.sparse_image_align"):
            res = direct.sparse_image_align(
                self.cam, kf.pyramid, cur.pyramid, kf.kp_xy, self.kf_depth,
                self.kf_has_lm, T_init, cfg.direct,
                scale_factor=cfg.pyramid.scale_factor)
        T_cw = se3.compose(res.T_cur_ref, kf.T_cw)
        cur = cur._replace(T_cw=T_cw)
        with stage("direct.features_align"):
            fa = direct.features_align(
                self.cam, cur, kf.pyramid, kf.T_cw, self.kf_pos_w, kf.kp_xy,
                self.kf_has_lm, cfg.direct,
                num_levels=cfg.pyramid.num_levels,
                scale_factor=cfg.pyramid.scale_factor,
                cand_level=kf.kp_level)
        inv_s2 = torch.ones((kf.capacity,), dtype=torch.float32,
                            device=self.device)
        with stage("direct.pose_optimization"):
            opt = pose_opt.pose_optimization(
                self.cam, T_cw, self.kf_pos_w, fa.px_cur, inv_s2,
                fa.ok & self.kf_has_lm, cfg.solver)
        self.T_cw = opt.T_cw
        self.num_tracked_dev = opt.num_inliers
        with stage("direct.update_seeds"):
            self._update_seeds(cur)
        self.trajectory.append(self.T_cw)
        self.frame_id += 1
        if self.frame_id % cfg.keyframe_every == 0:
            # every still-visible landmark carries over: at its aligned
            # position where alignment held, else at its projection
            p_c = se3.transform_points(self.T_cw, self.kf_pos_w)
            px_proj = cam_mod.world2cam(self.cam, p_c)
            carry_px = torch.where((fa.ok & opt.inliers)[:, None], fa.px_cur,
                                   px_proj)
            carry_ok = (self.kf_has_lm & (p_c[:, 2] > 0.05)
                        & cam_mod.is_in_frame(self.cam, carry_px,
                                              boundary=8.0))
            with stage("direct.make_keyframe"):
                self._make_keyframe(img_left, img_right, self.T_cw,
                                    carry_pos_w=self.kf_pos_w,
                                    carry_px=carry_px, carry_ok=carry_ok)
        return self.T_cw

    def poses(self) -> np.ndarray:
        return torch.stack(self.trajectory).cpu().numpy()
