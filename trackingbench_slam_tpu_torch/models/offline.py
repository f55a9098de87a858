"""Recorded sequences: the live loop's cadence over frames uploaded once,
and trajectory refinement against final keyframe poses.

Port of trackingbench_slam_tpu/models/offline.py: `sequence_schedule`,
`offline_run`, `OfflineStereoVO` and `refine_trajectory` (also used by
StereoVO.poses). The reference runs the whole sequence as one lax.scan;
here `offline_run` is a host loop over the same step functions the live
StereoVO calls (track_step, track_and_keyframe_step, track_keyframe_ba_step)
in the same order, drawing RANSAC samples from a generator seeded as
StereoVO seeds its own, so the trajectory equals the live loop's. The
keyframe and BA cadence is a static host schedule, the frames sit on the
device from `prepare`, and poses and inlier counts are stacked on the device
and fetched once. The only host read per keyframe is the keyframe step's
own stereo-prior branch. Loop closing and relocalization stay with the
live loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trackingbench_slam_tpu_torch.utils.config import PipelineConfig


class OfflineResult(NamedTuple):
    # frames 1..T-1; frame 0 (the bootstrap keyframe) is prepended by
    # OfflineStereoVO.poses()
    T_cw: torch.Tensor          # (T-1, 4, 4) world->camera poses
    num_inliers: torch.Tensor   # (T-1,) inliers after the pose solve
    state: object               # the final VOState


def sequence_schedule(cfg: PipelineConfig, n_frames: int):
    """The live loop's cadence as per-frame flags for frames 1..T-1 (frame
    0 is the bootstrap keyframe): (is_kf, right_idx, do_ba). Frame i has
    the host counter fid = i + 1 and is a keyframe when fid %
    keyframe_every == 0; every local_ba_every-th keyframe runs BA. right_idx
    counts the right images in schedule order, 0 being the bootstrap's."""
    is_kf, right_idx, do_ba = [], [], []
    kf_count = 0
    r = 1
    for i in range(1, n_frames):
        kf = (i + 1) % cfg.keyframe_every == 0
        is_kf.append(kf)
        right_idx.append(r if kf else 0)
        if kf:
            r += 1
            kf_count += 1
        do_ba.append(kf and cfg.local_ba_every > 0
                     and kf_count % cfg.local_ba_every == 0)
    return (np.asarray(is_kf, bool), np.asarray(right_idx, np.int32),
            np.asarray(do_ba, bool))


def offline_run(state, lefts: torch.Tensor, rights: torch.Tensor,
                is_kf: np.ndarray, right_idx: np.ndarray, do_ba: np.ndarray,
                cam, cfg: PipelineConfig,
                generator: torch.Generator) -> OfflineResult:
    """Frames 1..T-1 through the live loop's steps; `state` already holds
    the bootstrapped frame 0. lefts (T-1, H, W) and rights (R, H, W) on the
    device, right_idx[t] selecting frame t + 1's right image."""
    from trackingbench_slam_tpu_torch.models import vo as vo_mod
    from trackingbench_slam_tpu_torch.models.local_mapping import \
        track_keyframe_ba_step
    T_cw, inliers = [], []
    for t in range(lefts.shape[0]):
        left = lefts[t]
        if is_kf[t]:
            right = rights[int(right_idx[t])]
            step = (track_keyframe_ba_step if do_ba[t]
                    else vo_mod.track_and_keyframe_step)
            state = step(state, left, right, cam, cfg, generator)
        else:
            with vo_mod._stage("track_step"):
                state = vo_mod.track_step(state, left, cam, cfg, generator)
        T_cw.append(state.T_cw)
        inliers.append(state.num_inliers)
    return OfflineResult(T_cw=torch.stack(T_cw),
                         num_inliers=torch.stack(inliers), state=state)


def refine_trajectory(T_traj: np.ndarray, kf_frame_id: np.ndarray,
                      kf_valid: np.ndarray, kf_T_cw: np.ndarray) -> np.ndarray:
    """Re-express each frame's pose relative to its reference keyframe's
    final ring pose: T_i' = T_i . T_ref^-1 . T_ref_final."""
    T = np.asarray(T_traj)
    final = {max(int(kf_frame_id[s]) - 1, 0): kf_T_cw[s]
             for s in range(len(kf_frame_id)) if kf_valid[s]}
    out = T.copy()
    ref = None
    for i in range(T.shape[0]):
        if i in final:
            ref = i
            out[i] = final[i]
        elif ref is not None:
            out[i] = (T[i] @ np.linalg.inv(T[ref])) @ final[ref]
    return out


class OfflineStereoVO:
    """Recorded sequences: one upload, the steps on the device, one
    trajectory fetch.

    >>> vo = OfflineStereoVO(cfg)          # device="cpu" for the CPU
    >>> vo.run(frames)                     # [(left, right or None), ...]
    >>> poses = vo.poses()                 # (T, 4, 4), BA-refined
    """

    def __init__(self, cfg: PipelineConfig, device=None):
        from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
        from trackingbench_slam_tpu_torch.utils.device import resolve_device
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cam = cam_mod.CameraParams.from_config(cfg.camera, self.device)
        self.result: OfflineResult | None = None
        self._T0 = None

    def prepare(self, frames):
        """Uploads the left images and only the right images the schedule
        uses (the bootstrap's and each keyframe's, in schedule order), so a
        sequence with a right image on every frame gives the same run.
        Returns (lefts, rights, is_kf, right_idx, do_ba, first)."""
        n = len(frames)
        is_kf, right_idx, do_ba = sequence_schedule(self.cfg, n)
        if frames[0][1] is None:
            raise ValueError("frame 0 bootstraps stereo: it needs a right "
                             "image")
        rights = [np.asarray(frames[0][1])]
        for t in range(1, n):
            if is_kf[t - 1]:
                if frames[t][1] is None:
                    raise ValueError(f"keyframe {t} has no right image")
                rights.append(np.asarray(frames[t][1]))

        def up(images):   # uint8 and float32 kept, as upload_image keeps
            t = torch.from_numpy(np.stack(images))
            if t.dtype not in (torch.uint8, torch.float32):
                t = t.float()
            return t.to(self.device)
        lefts = up([np.asarray(L) for L, _ in frames])
        return (lefts[1:], up(rights), is_kf, right_idx, do_ba, lefts[0])

    def run(self, frames=None, prepared=None) -> OfflineResult:
        from trackingbench_slam_tpu_torch.models import vo as vo_mod
        if prepared is None:
            prepared = self.prepare(frames)
        lefts, rights, is_kf, right_idx, do_ba, first = prepared
        cfg = self.cfg
        state = vo_mod.init_state(cfg, first)
        state = vo_mod.keyframe_step(state, rights[0], self.cam, cfg)
        state = state._replace(frame_id=state.frame_id + 1)
        self._T0 = state.T_cw
        # RANSAC draws, seeded as StereoVO seeds its generator
        generator = torch.Generator(device=self.device)
        generator.manual_seed(0)
        self.result = offline_run(state, lefts, rights, is_kf, right_idx,
                                  do_ba, self.cam, cfg, generator)
        return self.result

    def poses(self, refine_with_keyframes: bool = True) -> np.ndarray:
        T = torch.cat([self._T0[None], self.result.T_cw]).cpu().numpy()
        if not refine_with_keyframes:
            return T
        k = self.result.state.kfs
        return refine_trajectory(T, k.frame_id.cpu().numpy(),
                                 k.valid.cpu().numpy(), k.T_cw.cpu().numpy())
