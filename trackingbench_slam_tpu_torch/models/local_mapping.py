"""Local mapping: windowed bundle adjustment as a live pipeline stage.

Port of trackingbench_slam_tpu/models/local_mapping.py. Every
`local_ba_every`-th keyframe, the keyframe ring and the map's observation
lists become one grouped BA problem over the top `solver.max_landmarks`
landmark slots (window-aware ranking), the newest `solver.window_keyframes`
ring poses optimize while the older ones are fixed vertices, and the result
is written back into the keyframe ring, the map and the live pose.

Ties follow the reference: the landmark ranking keeps jax.lax.top_k's
lower-index-first order (`stable_topk`), and the ring order is a stable
argsort of frame ids. Nothing in the solve is fetched to the host.

With cfg.mesh.lm > 1 the solve is landmark-sharded over torch.distributed
(parallel/dist_ba.py), as the reference shards it over its mesh: every rank
runs the front end replicated, solves its equal row block of the grouped
window on its 'lm' process group, and the blocks are gathered back. Without
a torch.distributed world of that many ranks it raises; it never falls back
to the one-device solve.
"""

from __future__ import annotations

import torch

from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.ops.fast import stable_topk
from trackingbench_slam_tpu_torch.parallel import dist_ba
from trackingbench_slam_tpu_torch.parallel import mesh as mesh_mod
from trackingbench_slam_tpu_torch.solvers import pose_opt
from trackingbench_slam_tpu_torch.solvers.local_ba import (
    BAProblem, GroupedBAProblem, _grouped_residuals, bundle_adjust_grouped)
from trackingbench_slam_tpu_torch.utils.config import PipelineConfig

_stage = torch.profiler.record_function


def _ring_order(kfs):
    """(order, dense_of_slot): ring slots oldest first (invalid slots last)
    and its inverse permutation."""
    big = torch.iinfo(torch.int32).max
    fid = torch.where(kfs.valid, kfs.frame_id,
                      torch.full_like(kfs.frame_id, big))
    order = torch.argsort(fid, stable=True)
    return order, torch.argsort(order)


def build_window_problem_grouped(m, kfs, scale_factor: float,
                                 max_landmarks: int,
                                 window_keyframes: int = 0):
    """Keyframe ring + map observation lists -> GroupedBAProblem over the
    top `max_landmarks` landmark slots by live observation count; with
    window_keyframes > 0, ranked first by live observations in the newest
    `window_keyframes` ring keyframes, total count breaking ties.

    Returns (problem, order, lm_idx): order[d] = ring slot at dense window
    index d (oldest first), lm_idx (L,) the selected map slots. Raises
    ValueError when `max_landmarks` is above the map's slot count, as the
    reference's top_k does."""
    KF = kfs.T_cw.shape[0]
    order, dense_of_slot = _ring_order(kfs)
    slot_all = m.obs_kf.clamp(0, KF - 1).long()
    live = (m.obs_kf >= 0) & kfs.valid[slot_all] & m.valid[:, None]
    n_live = live.sum(1)
    if window_keyframes > 0:
        n_valid = kfs.valid.sum()
        in_window = (dense_of_slot[slot_all]
                     >= torch.clamp(n_valid - window_keyframes, min=0))
        n_win = (live & in_window).sum(1)
        rank = n_win * 64 + n_live     # lexicographic; K <= 16 < 64
    else:
        rank = n_live
    if max_landmarks > rank.shape[0]:
        # where jax.lax.top_k raises for k above the operand's size
        raise ValueError(f"solver.max_landmarks ({max_landmarks}) is above "
                         f"map.max_points ({rank.shape[0]})")
    _, lm_idx = stable_topk(rank, max_landmarks)

    kf_slot = m.obs_kf[lm_idx]
    feat = m.obs_feat[lm_idx]
    slot_c = kf_slot.clamp(0, KF - 1).long()
    feat_c = feat.clamp(0, kfs.kp_xy.shape[1] - 1).long()
    ok = ((kf_slot >= 0) & (feat >= 0) & m.valid[lm_idx][:, None]
          & kfs.valid[slot_c] & kfs.kp_valid[slot_c, feat_c])
    problem = GroupedBAProblem(
        T_cw=kfs.T_cw[order],
        points=m.pos[lm_idx],
        obs_kf=torch.where(ok, dense_of_slot[slot_c].to(torch.int32),
                           torch.full_like(kf_slot, -1)),
        obs_px=kfs.kp_xy[slot_c, feat_c],
        obs_inv_sigma2=pose_opt.level_inv_sigma2(
            kfs.kp_level[slot_c, feat_c], scale_factor),
        obs_valid=ok,
        obs_ur=kfs.kp_ur[slot_c, feat_c],
    )
    return problem, order, lm_idx


def build_window_problem(m, kfs, scale_factor: float):
    """Flat-layout window over every observation slot of the map. Returns
    (BAProblem, order)."""
    KF = kfs.T_cw.shape[0]
    M, K = m.obs_kf.shape
    order, dense_of_slot = _ring_order(kfs)
    kf_slot = m.obs_kf.reshape(-1)
    feat = m.obs_feat.reshape(-1)
    lm = torch.arange(M, dtype=torch.int32,
                      device=kf_slot.device).repeat_interleave(K)
    slot_c = kf_slot.clamp(0, KF - 1).long()
    feat_c = feat.clamp(0, kfs.kp_xy.shape[1] - 1).long()
    ok = ((kf_slot >= 0) & (feat >= 0) & m.valid[lm.long()]
          & kfs.valid[slot_c] & kfs.kp_valid[slot_c, feat_c])
    problem = BAProblem(
        T_cw=kfs.T_cw[order],
        points=m.pos,
        obs_kf=dense_of_slot[slot_c].to(torch.int32),
        obs_lm=lm,
        obs_px=kfs.kp_xy[slot_c, feat_c],
        obs_inv_sigma2=pose_opt.level_inv_sigma2(
            kfs.kp_level[slot_c, feat_c], scale_factor),
        obs_valid=ok,
        obs_ur=kfs.kp_ur[slot_c, feat_c],
    )
    return problem, order


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without a host sync."""
    return torch.index_select(x, 0, i.reshape(1))[0]


def local_ba_step(state, cam: cam_mod.CameraParams, cfg: PipelineConfig,
                  num_fixed: int = 1):
    """One local-mapping pass: windowed BA over the ring, written back into
    the VOState (ring poses, the landmarks that had residuals, and the live
    pose moved by the newest keyframe's correction).

    num_fixed: clamped oldest poses (1 for stereo windows, whose u_R rows
    pin scale)."""
    m, kfs = state.map, state.kfs
    KF = kfs.T_cw.shape[0]
    problem, order, lm_idx = build_window_problem_grouped(
        m, kfs, cfg.pyramid.scale_factor, cfg.solver.max_landmarks,
        window_keyframes=cfg.solver.window_keyframes)
    if cfg.solver.stereo_gate_px > 0:
        # drop u_R rows whose residual at the current window estimate
        # exceeds the gate; the observation's mono rows stay
        r0 = _grouped_residuals(cam, problem.T_cw, problem.points,
                                problem)[0]
        bad_ur = ((problem.obs_ur >= 0)
                  & (torch.abs(r0[..., 2]) > cfg.solver.stereo_gate_px))
        problem = problem._replace(obs_ur=torch.where(
            bad_ur, torch.full_like(problem.obs_ur, -1.0), problem.obs_ur))
    # only the newest window_keyframes poses optimize; older ring poses are
    # fixed vertices whose observations still constrain the landmarks
    n_live = kfs.valid.sum()
    d = torch.arange(KF, device=n_live.device)
    fixed_mask = ((d < torch.clamp(n_live - cfg.solver.window_keyframes,
                                   min=num_fixed))
                  | (d >= n_live) | (d < num_fixed))
    solve = dict(iters=cfg.solver.ba_iters,
                 huber_delta=cfg.solver.huber_delta,
                 init_lambda=cfg.solver.init_lambda, num_fixed=num_fixed,
                 fixed_mask=fixed_mask, stereo_weight=cfg.solver.stereo_weight)
    if cfg.mesh.lm > 1:
        with _stage("ba.distributed_bundle_adjust_grouped"):
            T_opt, X_opt = sharded_solve(cam, problem, cfg, **solve)
    else:
        with _stage("ba.bundle_adjust_grouped"):
            T_opt, X_opt = bundle_adjust_grouped(cam, problem, **solve)

    ord_valid = kfs.valid[order]
    T_new = torch.where(ord_valid[:, None, None], T_opt, problem.T_cw)
    kfs = kfs._replace(T_cw=kfs.T_cw.index_copy(0, order, T_new))
    # only landmarks that had residuals move
    touched = problem.obs_valid.any(1) & m.valid[lm_idx]
    new_pos = torch.where(touched[:, None], X_opt, problem.points)
    m = m._replace(pos=m.pos.index_copy(0, lm_idx, new_pos))
    # the newest keyframe's correction moves the live pose
    newest = torch.clamp(kfs.valid.sum() - 1, 0, KF - 1)
    corr = se3.compose(_row(T_new, newest),
                       se3.inverse(_row(problem.T_cw, newest)))
    T_cw = se3.normalize(se3.compose(corr, state.T_cw))
    return state._replace(map=m, kfs=kfs, T_cw=T_cw,
                          prev=state.prev._replace(T_cw=T_cw))


def sharded_solve(cam: cam_mod.CameraParams, problem: GroupedBAProblem,
                  cfg: PipelineConfig, **solve):
    """The grouped window solved landmark-sharded over this rank's 'lm'
    process group (parallel/dist_ba.py): this rank's equal row block, then
    every block gathered back, so every rank writes back the same window.
    Raises when torch.distributed holds fewer than mesh.dp x mesh.lm
    ranks."""
    lm = cfg.mesh.lm
    assert cfg.solver.max_landmarks % lm == 0, (
        "solver.max_landmarks must divide evenly over mesh.lm shards")
    rm = mesh_mod.lm_mesh(lm, cfg.mesh.dp)
    group = rm.lm_group
    T_opt, X_loc = dist_ba.distributed_bundle_adjust_grouped(
        group, cam, dist_ba.row_block(problem, lm, rm.lm_index), **solve)
    blocks = [torch.empty_like(X_loc) for _ in range(lm)]
    torch.distributed.all_gather(blocks, X_loc.contiguous(), group=group)
    return T_opt, torch.cat(blocks)


def track_keyframe_ba_step(state, img_left: torch.Tensor,
                           img_right: torch.Tensor,
                           cam: cam_mod.CameraParams, cfg: PipelineConfig,
                           generator: torch.Generator | None = None,
                           uniform: torch.Tensor | None = None):
    """track_step + keyframe_step + local_ba_step, for the keyframes on the
    BA cadence."""
    from trackingbench_slam_tpu_torch.models import vo as vo_mod
    state = vo_mod.track_and_keyframe_step(state, img_left, img_right, cam,
                                           cfg, generator, uniform)
    with _stage("keyframe.local_ba_step"):
        return local_ba_step(state, cam, cfg)
