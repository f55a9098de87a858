"""Monocular visual odometry: essential-matrix bootstrap, then tracking with
two-view triangulated landmarks.

Port of trackingbench_slam_tpu/models/mono_vo.py:
  bootstrap  features of frame 0 are LK-tracked until their median parallax
             clears `min_parallax_px`; then F-RANSAC, E and the cheirality
             census (geometry/epipolar.py) give T_10 up to scale and the
             first map, scaled so its median depth is `init_depth`;
  tracking   the stereo pipeline's `track_step` (models/vo.py);
  keyframes  `mono_keyframe_step`: ORB re-extraction, then landmarks by DLT
             between the last keyframe and the frame (LK forward over 2
             levels, then a separate 1-level back-track), gated by
             parallax and reprojection error; then the map maintenance of
             the stereo keyframe; windowed BA on its cadence with the two
             oldest poses fixed (they pin the scale).
The bootstrap reads three values on the host (the parallax, the tracked
count and the verdict), as the reference does; nothing else syncs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.geometry import epipolar, se3
from trackingbench_slam_tpu_torch.geometry.triangulation import \
    triangulate_dlt
from trackingbench_slam_tpu_torch.models import map as map_mod
from trackingbench_slam_tpu_torch.models import vo as vo_mod
from trackingbench_slam_tpu_torch.models.extractors import extract_orb
from trackingbench_slam_tpu_torch.models.frame import make_frame
from trackingbench_slam_tpu_torch.models.local_mapping import local_ba_step
from trackingbench_slam_tpu_torch.ops.align import lk_pyramidal
from trackingbench_slam_tpu_torch.ops.stats import nanmedian
from trackingbench_slam_tpu_torch.utils.config import PipelineConfig
from trackingbench_slam_tpu_torch.utils.device import (resolve_device,
                                                       upload_image)
from trackingbench_slam_tpu_torch.utils.profiling import stage


def intrinsics(cam: cam_mod.CameraParams) -> torch.Tensor:
    zero, one = torch.zeros_like(cam.fx), torch.ones_like(cam.fx)
    return torch.stack([torch.stack([cam.fx, zero, cam.cx]),
                        torch.stack([zero, cam.fy, cam.cy]),
                        torch.stack([zero, zero, one])])


def _neg1(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, -1)


def _nan_where_not(mask, x):
    return torch.where(mask, x, torch.full_like(x, float("nan")))


def mono_keyframe_step(state: vo_mod.VOState, kf_lk_pyr, kf_T_cw,
                       cam: cam_mod.CameraParams,
                       cfg: PipelineConfig) -> vo_mod.VOState:
    """Mono keyframe on the tracked frame: re-extract into free rows,
    triangulate the features against the last keyframe, then the stereo
    keyframe's map side (models/vo.py `map_keyframe`) without anchor
    cells or right-image rows."""
    f = vo_mod.add_fresh_keypoints(state.prev, cam, cfg)

    # two-view depth: LK from the frame into the last keyframe, primed by
    # projecting each feature at the live landmarks' median distance
    T_wc = se3.inverse(f.T_cw)
    T_kf_cur = se3.compose(kf_T_cw, T_wc)
    d_all = torch.linalg.norm(state.map.pos - T_wc[:3, 3][None, :], dim=-1)
    med_d = nanmedian(_nan_where_not(state.map.valid, d_all), dim=0)
    med_d = torch.where(torch.isfinite(med_d), med_d,
                        torch.full_like(med_d, 8.0))
    xn = (f.kp_xy[:, 0] - cam.cx) / cam.fx
    yn = (f.kp_xy[:, 1] - cam.cy) / cam.fy
    p_guess = torch.stack([xn * med_d, yn * med_d, med_d.expand_as(xn)], -1)
    px_prior = cam_mod.world2cam(cam, se3.transform_points(T_kf_cur,
                                                           p_guess))
    with stage("mono.lk"):
        lk = lk_pyramidal(f.lk_pyr, kf_lk_pyr, f.kp_xy, f.valid, 0.5,
                          half=10, iters=30, num_levels=2,
                          init_offset=px_prior - f.kp_xy)
        back = lk_pyramidal(kf_lk_pyr, f.lk_pyr, lk.xy, f.valid, 0.5,
                            half=10, iters=10, num_levels=1,
                            init_offset=f.kp_xy - lk.xy)
    fb_ok = back.converged & (((back.xy - f.kp_xy) ** 2).sum(-1) < 1.0)
    K = intrinsics(cam)
    X_w = triangulate_dlt(K @ f.T_cw[:3], K @ kf_T_cw[:3], f.kp_xy, lk.xy)
    p_c = se3.transform_points(f.T_cw, X_w)
    p_k = se3.transform_points(kf_T_cw, X_w)
    r_c = X_w - T_wc[:3, 3][None, :]
    r_k = X_w - se3.inverse(kf_T_cw)[:3, 3][None, :]
    cosp = (r_c * r_k).sum(-1) / torch.clamp(
        torch.linalg.norm(r_c, dim=-1) * torch.linalg.norm(r_k, dim=-1),
        min=1e-9)
    reproj = torch.linalg.norm(cam_mod.world2cam(cam, p_c) - f.kp_xy, dim=-1)
    depth_ok = (f.valid & lk.converged & fb_ok & (p_c[:, 2] > 0.1)
                & (p_k[:, 2] > 0.1) & (cosp < 0.99995) & (reproj < 1.5))

    state, _, _ = vo_mod.map_keyframe(state, f, X_w, depth_ok, cam, cfg)
    return state


class MonoVO:
    """Host driver: the bootstrap state machine, then the shared tracking
    loop with mono keyframes and windowed BA. RANSAC draws come from one
    torch.Generator seeded 7."""

    def __init__(self, cfg: PipelineConfig, init_depth: float = 8.0,
                 min_parallax_px: float = 25.0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cam = cam_mod.CameraParams.from_config(cfg.camera, self.device)
        self.init_depth = init_depth
        self.min_parallax_px = min_parallax_px
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(7)
        self.state: Optional[vo_mod.VOState] = None
        self.initialized = False
        self.trajectory: list = []
        self.f0 = None           # the bootstrap reference frame
        self.cur_xy = None       # its features tracked to the latest frame
        self.kf_lk_pyr = None    # the last keyframe's LK pyramid
        self.kf_T_cw = None
        self.fid = 0
        self.kf_count = 0
        self.ba_calls = 0

    def _eye(self) -> torch.Tensor:
        return torch.eye(4, dtype=torch.float32, device=self.device)

    def _try_bootstrap(self, img: torch.Tensor):
        cfg = self.cfg
        f = make_frame(img, cfg.extractor.num_features,
                       cfg.pyramid.num_levels, cfg.pyramid.scale_factor)
        if self.f0 is None:
            self.f0 = extract_orb(f, self.cam, cfg.extractor, cfg.pyramid)
            self.cur_xy = self.f0.kp_xy
            self.trajectory.append(self._eye())
            return
        f0 = self.f0
        lk = lk_pyramidal(f0.lk_pyr, f.lk_pyr, f0.kp_xy, f0.valid, 0.5,
                          half=10, iters=30, num_levels=len(f0.lk_pyr),
                          init_offset=self.cur_xy - f0.kp_xy)
        ok = f0.valid & lk.converged
        self.cur_xy = torch.where(ok[:, None], lk.xy, self.cur_xy)
        par = nanmedian(_nan_where_not(
            ok, torch.linalg.norm(lk.xy - f0.kp_xy, dim=-1)), dim=0)
        self.trajectory.append(self._eye())
        if not (float(par) > self.min_parallax_px and int(ok.sum()) > 60):
            return
        T_10, X, good, bok = epipolar.mono_bootstrap(
            intrinsics(self.cam), f0.kp_xy, lk.xy, ok,
            generator=self.generator)
        if not bool(bok):
            return
        # the free scale: median triangulated depth -> init_depth
        med = nanmedian(_nan_where_not(good, X[:, 2]), dim=0)
        s = self.init_depth / torch.clamp(med, min=1e-6)
        X = X * s
        T_10 = se3.from_rt(T_10[:3, :3], T_10[:3, 3] * s)

        state = vo_mod.init_state(cfg, img)
        dev = self.device
        dist = torch.linalg.norm(X, dim=-1)
        normal = X / torch.clamp(dist[:, None], min=1e-9)
        m, slots = map_mod.add_points(
            state.map, X, f0.desc, normal, dist * 0.3, dist * 3.0,
            torch.zeros_like(f0.kp_level), f0.kp_level, good)
        got = good & (slots < m.capacity)
        f0 = f0._replace(map_idx=torch.where(got, slots, _neg1(slots)))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        feat_idx = torch.arange(f0.capacity, dtype=torch.int32, device=dev)
        m = map_mod.add_observations(m, torch.where(got, slots, _neg1(slots)),
                                     zero, feat_idx, got, desc=f0.desc)
        kfs, _ = map_mod.insert_keyframe(state.kfs, f0, zero, slot=zero)
        f1 = f._replace(kp_xy=torch.where(ok[:, None], lk.xy, f0.kp_xy),
                        kp_level=f0.kp_level, kp_angle=f0.kp_angle,
                        kp_response=f0.kp_response, desc=f0.desc,
                        bearing=f0.bearing,
                        map_idx=torch.where(got & ok, slots, _neg1(slots)),
                        valid=ok, T_cw=T_10)
        self.state = state._replace(
            prev=f1, map=m, kfs=kfs, T_cw=T_10,
            frame_id=torch.tensor(self.fid + 1, dtype=torch.int32,
                                  device=dev))
        self.kf_lk_pyr = f0.lk_pyr
        self.kf_T_cw = self._eye()
        self.trajectory[-1] = T_10
        self.initialized = True

    def track(self, img) -> torch.Tensor:
        img = upload_image(img, self.device)
        self.fid += 1
        if not self.initialized:
            with stage("mono.bootstrap"):
                self._try_bootstrap(img)
            return self.trajectory[-1]
        with stage("track_step"):
            self.state = vo_mod.track_step(self.state, img, self.cam,
                                           self.cfg, self.generator)
        if self.fid % self.cfg.keyframe_every == 0:
            with stage("mono.keyframe_step"):
                self.state = mono_keyframe_step(self.state, self.kf_lk_pyr,
                                                self.kf_T_cw, self.cam,
                                                self.cfg)
            self.kf_count += 1
            if (self.cfg.local_ba_every > 0
                    and self.kf_count % self.cfg.local_ba_every == 0):
                with stage("mono.local_ba_step"):
                    self.state = local_ba_step(self.state, self.cam,
                                               self.cfg, num_fixed=2)
                self.ba_calls += 1
            self.kf_lk_pyr = self.state.prev.lk_pyr
            self.kf_T_cw = self.state.T_cw
        self.trajectory.append(self.state.T_cw)
        return self.state.T_cw

    def poses(self) -> np.ndarray:
        return torch.stack(self.trajectory).cpu().numpy()
