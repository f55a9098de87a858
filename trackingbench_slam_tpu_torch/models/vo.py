"""Stereo visual odometry: the track step, the keyframe step and the host
driver.

Port of trackingbench_slam_tpu/models/vo.py: `track_step` (LK from a
constant-velocity SE3 prior, F-RANSAC, 4x10 Huber LM), `keyframe_step`
(anchored refinement, ORB re-extraction with AddPoints suppression, stereo
LK with the fused forward-backward check, projection-map linking and
fusion, culling, new landmarks, anchor capture, observations, keyframe
insertion, landmark maintenance) and `StereoVO`, which adds windowed local
BA on its cadence (models/local_mapping.py) and, with a LoopCloser
attached, loop closing and relocalization (models/loop_closer.py).

The code runs eagerly on the device of its inputs. The reference picks the
stereo LK pyramid depth with lax.cond on the device; here that choice is a
host branch, which costs one device-to-host sync per keyframe. The steps
also run under torch.func.vmap (parallel/dp_eval.py), where the branch runs
both ways and torch.where selects (`keyframe_step(both_branches=True)`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.geometry import triangulation as tri
from trackingbench_slam_tpu_torch.matchers import matcher as matchers
from trackingbench_slam_tpu_torch.models import map as map_mod
from trackingbench_slam_tpu_torch.models.extractors import extract_orb
from trackingbench_slam_tpu_torch.models.frame import (FrameState,
                                                       is_in_frustum,
                                                       make_frame,
                                                       with_keypoints)
from trackingbench_slam_tpu_torch.models.local_mapping import \
    track_keyframe_ba_step
from trackingbench_slam_tpu_torch.models.loop_closer import (
    apply_loop_correction, track_keyframe_register_step)
from trackingbench_slam_tpu_torch.models.offline import refine_trajectory
from trackingbench_slam_tpu_torch.ops import packing
from trackingbench_slam_tpu_torch.ops.align import (anchored_align,
                                                    lk_pyramidal)
from trackingbench_slam_tpu_torch.ops.stats import nanmedian
from trackingbench_slam_tpu_torch.solvers import pose_opt
from trackingbench_slam_tpu_torch.utils.config import PipelineConfig
from trackingbench_slam_tpu_torch.utils.device import (HostCopy,
                                                       resolve_device,
                                                       upload_image)
from trackingbench_slam_tpu_torch.utils.profiling import stage

# the stage ranges (utils/profiling.py `stage`) that profile_main_path.py
# tables
STAGE_PREFIXES = ("track", "keyframe", "ba.")


class VOState(NamedTuple):
    prev: FrameState
    map: map_mod.MapState
    kfs: map_mod.KeyframeStore
    T_cw: torch.Tensor
    frame_id: torch.Tensor
    # the reference's PRNG key, carried for state conversion only: the port
    # draws RANSAC samples from the driver's torch.Generator
    key: torch.Tensor
    num_inliers: torch.Tensor
    flow: torch.Tensor    # (2,) constant-velocity median-flow prior
    T_rel: torch.Tensor   # (4, 4) constant-velocity SE3 motion model


def init_state(cfg: PipelineConfig, first_img: torch.Tensor) -> VOState:
    with stage("init.state"):
        dev = first_img.device
        frame = make_frame(first_img, cfg.extractor.num_features,
                           cfg.pyramid.num_levels, cfg.pyramid.scale_factor)
        return VOState(
            prev=frame,
            map=map_mod.empty_map(cfg.map.max_points,
                                  cfg.map.max_obs_per_point, dev),
            kfs=map_mod.empty_keyframes(cfg.map.max_keyframes,
                                        cfg.extractor.num_features, dev),
            T_cw=torch.eye(4, dtype=torch.float32, device=dev),
            frame_id=torch.zeros((), dtype=torch.int32, device=dev),
            key=torch.zeros((2,), dtype=torch.int64, device=dev),
            num_inliers=torch.zeros((), dtype=torch.int32, device=dev),
            flow=torch.zeros((2,), dtype=torch.float32, device=dev),
            T_rel=torch.eye(4, dtype=torch.float32, device=dev),
        )


def _neg1(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, -1)


def track_step(state: VOState, img: torch.Tensor, cam: cam_mod.CameraParams,
               cfg: PipelineConfig,
               generator: torch.Generator | None = None,
               uniform: torch.Tensor | None = None) -> VOState:
    """Frame-to-frame tracking: LK match to the previous frame from the
    motion-model prior, landmark links along the match, motion-only BA.
    RANSAC draws come from `generator` (or are given as `uniform`)."""
    with stage("track.make_frame"):
        f_cur = make_frame(img, cfg.extractor.num_features,
                           cfg.pyramid.num_levels, cfg.pyramid.scale_factor)
    nlv = cfg.lk_track_levels if cfg.lk_track_levels > 0 else None
    prev, m = state.prev, state.map
    M = m.capacity
    T_pred = se3.normalize(se3.compose(state.T_rel, state.T_cw))
    mp0 = prev.map_idx.clamp(0, M - 1).long()
    p_pred = se3.transform_points(T_pred, m.pos[mp0])
    px_pred = cam_mod.world2cam(cam, p_pred)
    pred_ok = ((prev.map_idx >= 0) & prev.valid & m.valid[mp0]
               & (p_pred[:, 2] > 0.05))
    init_off = torch.where(pred_ok[:, None], px_pred - prev.kp_xy,
                           state.flow[None, :])
    with stage("track.search_by_opflow"):   # LK + F-RANSAC
        res, xy = matchers.search_by_opflow(
            f_cur, prev, generator, cfg.matcher,
            scale=cfg.pyramid.scale_factor, use_ransac=True, num_levels=nlv,
            init_offset=init_off, uniform=uniform)
    # constant-velocity prior: median flow of the tracked points
    delta = xy - prev.kp_xy
    med = nanmedian(torch.where(res.ok[:, None], delta,
                                torch.full_like(delta, float("nan"))), dim=0)
    good = res.ok.sum() >= 20
    new_flow = torch.where(good & torch.isfinite(med).all(), med, state.flow)
    f_cur = with_keypoints(f_cur, cam, xy, prev.kp_level, prev.kp_angle,
                           prev.kp_response, prev.desc, res.ok)
    f_cur = f_cur._replace(map_idx=torch.where(res.ok, prev.map_idx,
                                               _neg1(prev.map_idx)),
                           T_cw=state.T_cw)

    has_mp = (f_cur.map_idx >= 0) & f_cur.valid
    mp = f_cur.map_idx.clamp(0, M - 1).long()
    edges = has_mp & m.valid[mp]
    inv_s2 = pose_opt.level_inv_sigma2(f_cur.kp_level,
                                       cfg.pyramid.scale_factor)
    with stage("track.pose_optimization"):
        opt = pose_opt.pose_optimization(cam, T_pred, m.pos[mp], f_cur.kp_xy,
                                         inv_s2, edges, cfg.solver)
    f_cur = f_cur._replace(
        map_idx=torch.where(edges & ~opt.inliers, _neg1(f_cur.map_idx),
                            f_cur.map_idx),
        T_cw=opt.T_cw)
    new_map = map_mod.increase_found(m, mp, edges & opt.inliers)
    T_rel_new = se3.normalize(se3.compose(opt.T_cw,
                                          se3.inverse(state.T_cw)))
    T_rel = torch.where(opt.num_inliers >= 15, T_rel_new, state.T_rel)
    return state._replace(prev=f_cur, T_cw=opt.T_cw,
                          frame_id=state.frame_id + 1,
                          num_inliers=opt.num_inliers, map=new_map,
                          flow=new_flow, T_rel=T_rel)


def add_fresh_keypoints(f: FrameState, cam: cam_mod.CameraParams,
                        cfg: PipelineConfig) -> FrameState:
    """ORB re-extraction with suppression near the live features; the
    fresh keypoints fill the free rows, without landmarks."""
    with stage("keyframe.extract_orb"):
        fresh = extract_orb(f, cam, cfg.extractor, cfg.pyramid,
                            suppress_xy=f.kp_xy, suppress_valid=f.valid)
    dest = map_mod.free_slot_destinations(~f.valid, fresh.valid)
    (kp_xy, kp_level, kp_angle, kp_response, desc, bearing, map_idx,
     valid) = packing.scatter_rows_set(
        [f.kp_xy, f.kp_level, f.kp_angle, f.kp_response, f.desc, f.bearing,
         f.map_idx, f.valid],
        dest,
        [fresh.kp_xy, fresh.kp_level, fresh.kp_angle, fresh.kp_response,
         fresh.desc, fresh.bearing, _neg1(f.map_idx),
         torch.ones_like(f.valid)])
    return f._replace(kp_xy=kp_xy, kp_level=kp_level, kp_angle=kp_angle,
                      kp_response=kp_response, desc=desc, bearing=bearing,
                      map_idx=map_idx, valid=valid)


def keyframe_step(state: VOState, img_right: torch.Tensor,
                  cam: cam_mod.CameraParams, cfg: PipelineConfig,
                  both_branches: bool = False) -> VOState:
    """Keyframe insertion on the current (tracked) frame. The stereo LK
    depth (2 primed levels or the full pyramid) is a host branch; with
    `both_branches` (batched callers, under vmap) both calls run and
    torch.where keeps the one the branch would have taken."""
    f = state.prev
    # anchored refinement against creation-time anchor patches
    m_pre = state.map
    M0 = m_pre.capacity
    mp_pre = f.map_idx.clamp(0, M0 - 1).long()
    has_anchor = (f.map_idx >= 0) & f.valid & m_pre.valid[mp_pre]
    centers = map_mod.atlas_cell_centers(mp_pre, m_pre.atlas_grid)
    with stage("keyframe.anchored_align"):
        aa = anchored_align(m_pre.anchor_atlas, f.lk_pyr[0], centers,
                            f.kp_xy, has_anchor, half=4, iters=10)
    drift = ((aa.xy - f.kp_xy) ** 2).sum(-1)
    snap = has_anchor & aa.converged & (drift < 2.25)
    new_xy = torch.where(snap[:, None], aa.xy, f.kp_xy)
    f = with_keypoints(f, cam, new_xy, f.kp_level, f.kp_angle,
                       f.kp_response, f.desc, f.valid)

    f = add_fresh_keypoints(f, cam, cfg)

    # stereo LK left -> right with a disparity prior from known landmarks
    with stage("keyframe.stereo_lk"):
        right = make_frame(img_right, 1, cfg.pyramid.num_levels,
                           cfg.pyramid.scale_factor)
        M = state.map.capacity
        has_mp = (f.map_idx >= 0) & f.valid
        mp = f.map_idx.clamp(0, M - 1).long()
        z = se3.transform_points(f.T_cw, state.map.pos[mp])[:, 2]
        known = has_mp & state.map.valid[mp] & (z > 0.2)
        disp = cam.bf / torch.clamp(z, min=0.2)
        med_disp = nanmedian(torch.where(known, disp,
                                         torch.full_like(disp, float("nan"))),
                             dim=0)
        have_prior = torch.isfinite(med_disp) & (known.sum() >= 10)

        def primed():
            disp_i = torch.where(known, disp, med_disp)
            prior = torch.stack([-disp_i, torch.zeros_like(disp_i)], -1)
            return lk_pyramidal(f.lk_pyr, right.lk_pyr, f.kp_xy, f.valid,
                                0.5, half=10, iters=30, num_levels=2,
                                init_offset=prior, fb_iters=10)

        def full():
            return lk_pyramidal(f.lk_pyr, right.lk_pyr, f.kp_xy, f.valid,
                                0.5, half=10, iters=30,
                                num_levels=len(f.lk_pyr), fb_iters=10)

        if both_branches:
            # the select vmap makes of the reference's lax.cond: both
            # calls run and each sequence keeps its own branch's result
            a, b = primed(), full()
            lk = type(a)(*[torch.where(have_prior, x, y)
                           for x, y in zip(a, b)])
        elif bool(have_prior):   # host branch: one sync per keyframe
            lk = primed()
        else:
            lk = full()
    fb_ok = lk.fb_conv & (lk.fb_d2 < 1.0)
    depth, disp_ok = tri.stereo_depth(cam.bf, f.kp_xy[:, 0], lk.xy[:, 0])
    row_ok = torch.abs(lk.xy[:, 1] - f.kp_xy[:, 1]) < 2.0
    depth_ok = (f.valid & lk.converged & fb_ok & disp_ok & row_ok
                & (depth > 0.1) & (depth < 400.0))
    p_cam = tri.backproject(cam.fx, cam.fy, cam.cx, cam.cy, f.kp_xy, depth)
    p_w = se3.transform_points(se3.inverse(f.T_cw), p_cam)
    kp_ur = torch.where(depth_ok, lk.xy[:, 0], torch.full_like(depth, -1.0))
    state, slots, got = map_keyframe(state, f, p_w, depth_ok, cam, cfg,
                                     kp_ur=kp_ur)
    with stage("keyframe.write_anchor_patches"):
        m = map_mod.write_anchor_patches(state.map, f.lk_pyr[0], f.kp_xy,
                                         slots, got)
    return state._replace(map=m)


def map_keyframe(state: VOState, f: FrameState, p_w: torch.Tensor,
                 depth_ok: torch.Tensor, cam: cam_mod.CameraParams,
                 cfg: PipelineConfig, kp_ur: torch.Tensor | None = None):
    """The map side of a keyframe, shared by the stereo and the mono
    keyframe steps: projection-map linking and fusion, the visibility
    census and found-ratio cull, new landmarks at p_w (world points) for
    the features with depth_ok and no landmark, observations, the keyframe
    ring (with the right-image u kp_ur, where there is one) and the two
    maintenance passes. Returns (state, slots, got): the new landmarks'
    slots and which features got one, for the stereo step's anchor
    cells."""
    dev = f.kp_xy.device
    M = state.map.capacity
    T_wc = se3.inverse(f.T_cw)
    # map-to-frame projection: link fresh features, fuse duplicates
    m0 = state.map
    with stage("keyframe.search_by_projection_map"):
        proj = matchers.search_by_projection_map(
            cam, f, m0, cfg.matcher, scale_factor=cfg.pyramid.scale_factor,
            num_levels=cfg.pyramid.num_levels, only_unlinked=False,
            accept_th=float(cfg.matcher.th_low), use_ratio=False)
    pidx = proj.idx.clamp(0, M - 1).long()
    match_ok = proj.ok & m0.valid[pidx]
    # visibility census + found/visible-ratio cull
    _, _, vis_now, _ = is_in_frustum(f, cam, m0.pos, m0.normal, m0.min_dist,
                                     m0.max_dist)
    m0 = map_mod.increase_visible(
        m0, torch.arange(M, dtype=torch.int32, device=dev), vis_now & m0.valid)
    found_ratio = m0.n_found.float() / torch.clamp(m0.n_visible, min=1).float()
    cull = m0.valid & (m0.n_visible >= 8) & (found_ratio < 0.25)
    m0 = m0._replace(valid=m0.valid & ~cull)
    match_ok = match_ok & ~cull[pidx]
    # links into culled slots drop now (frame and keyframe ring)
    fcl = f.map_idx.clamp(0, M - 1).long()
    f = f._replace(map_idx=torch.where((f.map_idx >= 0) & cull[fcl],
                                       _neg1(f.map_idx), f.map_idx))
    kmi = state.kfs.map_idx
    kfs_culled = state.kfs._replace(map_idx=torch.where(
        (kmi >= 0) & cull[kmi.clamp(0, M - 1).long()], _neg1(kmi), kmi))
    state = state._replace(kfs=kfs_culled)
    link = match_ok & (f.map_idx < 0) & f.valid
    f = f._replace(map_idx=torch.where(link, pidx.int(), f.map_idx))
    fuse = match_ok & (f.map_idx >= 0) & (pidx != f.map_idx) & ~link
    old_idx = f.map_idx.clamp(0, M - 1).long()
    keep_new = m0.obs_count[pidx] >= m0.obs_count[old_idx]
    keeper = torch.where(keep_new, pidx, old_idx)
    victim = torch.where(keep_new, old_idx, pidx)
    m0, redirect = map_mod.replace_points(m0, victim, keeper, fuse)
    f = f._replace(map_idx=torch.where(f.map_idx >= 0, redirect[old_idx],
                                       f.map_idx))
    kmi = state.kfs.map_idx
    state = state._replace(map=m0, kfs=state.kfs._replace(map_idx=torch.where(
        kmi >= 0, redirect[kmi.clamp(0, M - 1).long()], kmi)))

    # new landmarks for features without one
    want = depth_ok & (f.map_idx < 0)
    normal = p_w - T_wc[:3, 3][None, :]
    dist = torch.linalg.norm(normal, dim=-1)
    normal = normal / torch.clamp(dist[:, None], min=1e-9)
    level_scale = torch.pow(torch.full((), 1.0 / cfg.pyramid.scale_factor,
                                       dtype=torch.float32, device=dev),
                            f.kp_level.float())
    max_dist = dist * level_scale
    min_dist = max_dist * (cfg.pyramid.scale_factor
                           ** (cfg.pyramid.num_levels - 1))

    kf_slot = map_mod.next_kf_slot(state.kfs).to(torch.int32)
    m = map_mod.purge_kf_slot(state.map, kf_slot, state.kfs.valid.index_select(
        0, kf_slot.long().reshape(1))[0])
    m, slots = map_mod.add_points(
        m, p_w, f.desc, normal, min_dist, max_dist,
        kf_slot.expand(f.kp_level.shape), f.kp_level, want)
    got = want & (slots < m.capacity)
    f = f._replace(map_idx=torch.where(got, slots, f.map_idx))
    feat_idx = torch.arange(f.capacity, dtype=torch.int32, device=dev)
    tracked = f.valid & (f.map_idx >= 0) & ~got
    m = map_mod.add_observations(m, torch.where(got, slots, f.map_idx),
                                 kf_slot, feat_idx, got | tracked,
                                 desc=f.desc)
    kfs, _ = map_mod.insert_keyframe(state.kfs, f, state.frame_id,
                                     slot=kf_slot, kp_ur=kp_ur)
    m = map_mod.update_normal_and_depth(m, kfs, cfg.pyramid.scale_factor,
                                        cfg.pyramid.num_levels)
    m = map_mod.compute_distinctive_descriptors(m, kfs)
    return state._replace(prev=f, map=m, kfs=kfs), slots, got


def track_and_keyframe_step(state: VOState, img_left, img_right,
                            cam: cam_mod.CameraParams, cfg: PipelineConfig,
                            generator: torch.Generator | None = None,
                            uniform: torch.Tensor | None = None
                            ) -> VOState:
    with stage("track_step"):
        state = track_step(state, img_left, cam, cfg, generator, uniform)
    with stage("keyframe_step"):
        return keyframe_step(state, img_right, cam, cfg)


class StereoVO:
    """Host loop of the stereo pipeline: keyframe cadence on a host
    counter, windowed BA on every `local_ba_every`-th keyframe, tracking-
    loss flag one frame late. With a LoopCloser attached
    (`vo.loop_closer = LoopCloser(...)`), keyframes register in its BoW
    database, detected loops are closed by a pose graph, and a lost frame
    tries relocalization against the database, rate-limited."""

    min_track_inliers = 15
    reloc_cooldown_frames = 3
    reloc_max_fails = 2

    def __init__(self, cfg: PipelineConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cam = cam_mod.CameraParams.from_config(cfg.camera, self.device)
        # RANSAC draws; the reference seeds its key with PRNGKey(0)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        self.state: Optional[VOState] = None
        self.trajectory: list = []
        self.loop_closer = None
        self.lost = False
        self.reloc_events: list = []
        self.loop_events: list = []
        # per closed loop: (the querying keyframe's trajectory node, the
        # matched keyframe's node, the measured (4, 4) pose of the query
        # relative to the match)
        self.loop_matches: list = []
        self.ba_calls = 0
        # trajectory index per LoopCloser ring slot
        self._kf_traj_idx: dict = {}
        self._fid = 0
        self._kf_count = 0
        self._reloc_fails = 0
        self._reloc_cooldown = 0
        self._pending = None

    def _to_device(self, img) -> torch.Tensor:
        return upload_image(img, self.device)

    def _fetch_late(self):
        """Inlier count of the PREVIOUS frame (copied asynchronously while
        this frame computed), then start this frame's copy."""
        prev = None if self._pending is None else int(self._pending.numpy())
        self._pending = HostCopy(self.state.num_inliers)
        return prev

    def track(self, img_left, img_right=None) -> VOState:
        img_left = self._to_device(img_left)
        if self.state is None:
            self.state = init_state(self.cfg, img_left)
            if img_right is not None:
                self.state = keyframe_step(self.state,
                                           self._to_device(img_right),
                                           self.cam, self.cfg)
            self.state = self.state._replace(
                frame_id=self.state.frame_id + 1)
            self._fid = 1
            self.trajectory.append(self.state.T_cw)
            return self.state
        self._fid += 1
        if self.loop_closer is not None and self.loop_closer.has_pending:
            # the loop query issued at an earlier keyframe has had frames
            # to land
            self._finish_loop_detect()
        # while lost, no keyframe is inserted if relocalization can still
        # recover (a lost frame's landmarks would poison the map); after
        # reloc_max_fails failures re-mapping takes over
        hold_kf = (self.lost and self.loop_closer is not None
                   and self._reloc_fails < self.reloc_max_fails
                   and self._fid > self.cfg.keyframe_every)
        is_kf = (img_right is not None
                 and self._fid % self.cfg.keyframe_every == 0
                 and not hold_kf)
        if is_kf:
            self._kf_count += 1
            do_ba = (self.cfg.local_ba_every > 0
                     and self._kf_count % self.cfg.local_ba_every == 0)
            self.ba_calls += int(do_ba)
            img_right = self._to_device(img_right)
            if self.loop_closer is not None:
                self._track_keyframe_with_loop(img_left, img_right, do_ba)
            elif do_ba:
                self.state = track_keyframe_ba_step(
                    self.state, img_left, img_right, self.cam, self.cfg,
                    self.generator)
            else:
                self.state = track_and_keyframe_step(
                    self.state, img_left, img_right, self.cam, self.cfg,
                    self.generator)
        else:
            with stage("track_step"):
                self.state = track_step(self.state, img_left, self.cam,
                                        self.cfg, self.generator)
        prev_inliers = self._fetch_late()
        if prev_inliers is not None:
            self.lost = (prev_inliers < self.min_track_inliers
                         and self._fid > 2)
            if not self.lost:
                self._reloc_fails = 0
                self._reloc_cooldown = 0
            elif self.loop_closer is not None:
                # relocalization attempts at the cooldown cadence while lost
                if self._reloc_cooldown <= 0:
                    self._relocalize()
                    if self.lost:
                        self._reloc_fails += 1
                    self._reloc_cooldown = self.reloc_cooldown_frames
                else:
                    self._reloc_cooldown -= 1
        self.trajectory.append(self.state.T_cw)
        return self.state

    def _track_keyframe_with_loop(self, img_left, img_right, do_ba: bool):
        """Keyframe step (+ BA) and the BoW register/query in one call; the
        query verdict is read frames later (_finish_loop_detect)."""
        lc = self.loop_closer
        kf_node = len(self.trajectory)   # this keyframe's trajectory node
        slot, used_after = lc.begin_slot(self.state.prev.capacity)
        db_a, db_b = lc.db_tables()
        (self.state, nodes, vec, new_a, new_b, top_idx, scores) = (
            track_keyframe_register_step(
                self.state, img_left, img_right, self.cam, self.cfg, lc.voc,
                db_a, db_b, slot, used_after, do_ba, lc.exclude_recent, 3,
                lc.sparse, self.generator))
        f = self.state.prev
        lc.register_precomputed(slot, used_after, nodes, vec, new_a, new_b,
                                top_idx, scores, f.desc, f.valid, f.kp_xy,
                                f.map_idx, self.state.map.pos, f.T_cw,
                                kf_node=kf_node)
        self._kf_traj_idx[slot] = kf_node

    def _finish_loop_detect(self, flush: bool = False):
        """Advance the deferred loop detection (LoopCloser.finish_detect)
        and apply a completed correction; flush drains it (end of run)."""
        loop, kf_node = self.loop_closer.finish_detect(flush=flush)
        if loop is not None:
            self._close_loop(loop, kf_node)

    def _close_loop(self, loop, edge_node: int):
        """Pose graph over the trajectory with the loop edge attached at
        the keyframe node that measured it; the corrections go into the
        keyframe ring, the landmarks and the current pose."""
        cur_index = len(self.trajectory)   # this frame's (future) node
        T_all = torch.cat([torch.stack(self.trajectory),
                           self.state.T_cw[None]]).cpu().numpy()
        matched = self._kf_traj_idx[loop.kf_index]
        T_opt, _ = self.loop_closer.correct_trajectory(
            T_all, loop, cur_index=cur_index, loop_frame_index=matched,
            edge_index=edge_node, device=self.device)
        self.loop_matches.append((edge_node, matched, loop.T_cur_kf))
        # padded to a multiple of 64 frames with the last pose repeated
        F = len(T_opt)
        T_pad = np.tile(T_opt[-1][None], (-(-F // 64) * 64, 1, 1))
        T_pad[:F] = T_opt
        self.state = apply_loop_correction(
            self.state, torch.as_tensor(T_pad, dtype=torch.float32,
                                        device=self.device))
        self.trajectory = list(torch.as_tensor(
            T_opt[:-1], dtype=torch.float32, device=self.device).unbind(0))
        self.loop_events.append(self._fid)
        self.loop_closer.notify_loop_closed()

    def _relocalize(self):
        """Recover from tracking loss by BoW retrieval against the keyframe
        database: on success the pose resets from the loop candidate and
        the frame's features re-link to map landmarks by projection."""
        f = extract_orb(self.state.prev, self.cam, self.cfg.extractor,
                        self.cfg.pyramid)
        loop = self.loop_closer.detect(f.desc, f.valid, f.kp_xy,
                                       self.state.T_cw,
                                       init_from_candidate=True)
        if loop is None:
            return
        kf_T = self.loop_closer.entries[loop.kf_index]["T_cw"]
        T_new = torch.as_tensor(loop.T_cur_kf @ kf_T.cpu().numpy(),
                                dtype=torch.float32, device=self.device)
        f = f._replace(T_cw=T_new, map_idx=_neg1(f.map_idx))
        m = self.state.map
        proj = matchers.search_by_projection_map(
            self.cam, f, m, self.cfg.matcher,
            scale_factor=self.cfg.pyramid.scale_factor,
            num_levels=self.cfg.pyramid.num_levels, base_radius=12.0)
        ok = proj.ok & m.valid[proj.idx.clamp(0, m.capacity - 1)]
        f = f._replace(map_idx=torch.where(ok, proj.idx.to(torch.int32),
                                           _neg1(f.map_idx)))
        # the motion model is meaningless across a teleport
        self.state = self.state._replace(
            T_cw=T_new, prev=f,
            T_rel=torch.eye(4, dtype=torch.float32, device=self.device),
            flow=torch.zeros((2,), dtype=torch.float32, device=self.device))
        self.lost = False
        self.reloc_events.append(int(self.state.frame_id))

    def poses(self, refine_with_keyframes: bool = True) -> np.ndarray:
        """(F, 4, 4) world->camera trajectory; by default each frame is
        re-expressed against its reference keyframe's final ring pose. With
        a loop closer, pending detections are drained first."""
        if self.loop_closer is not None:
            for _ in range(4):
                if not self.loop_closer.has_pending:
                    break
                self._finish_loop_detect(flush=True)
        T = torch.stack(self.trajectory).cpu().numpy()
        if not refine_with_keyframes or self.state is None:
            return T
        k = self.state.kfs
        return refine_trajectory(T, k.frame_id.cpu().numpy(),
                                 k.valid.cpu().numpy(), k.T_cw.cpu().numpy())
