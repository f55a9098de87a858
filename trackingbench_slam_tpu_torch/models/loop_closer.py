"""Loop closing: BoW retrieval -> bucketed matching -> geometric
verification -> pose-graph correction.

Port of trackingbench_slam_tpu/models/loop_closer.py:
  1. retrieval: the keyframe's BoW vector is written into the database and
     scored against every entry in the same keyframe step
     (`track_keyframe_register_step`); the top-3 verdict is copied to pinned
     host memory without blocking and read two frames later;
  2. match: `search_by_bow` (same vocabulary node) per candidate;
  3. verify: motion-only pose optimization on the candidate's landmarks,
     accepted on its inlier count (`_verify_candidates_device`, a loop over
     at most 3 candidates with nothing fetched inside it; its (C, 3) counts
     are copied back the same way and read one frame later);
  4. correct: a loop edge into the pose graph over the trajectory
     (`LoopCloser.correct_trajectory`), written back into the VOState by
     `apply_loop_correction`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from trackingbench_slam_tpu_torch.bow import vocabulary as bow
from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.matchers import matcher as matchers
from trackingbench_slam_tpu_torch.ops.fast import stable_topk
from trackingbench_slam_tpu_torch.solvers import pose_graph, pose_opt
from trackingbench_slam_tpu_torch.utils.config import (MatcherConfig,
                                                       SolverConfig)
from trackingbench_slam_tpu_torch.utils.device import HostCopy, resolve_device


def _register_query_device(voc: bow.Vocabulary, vectors: torch.Tensor,
                           slot: int, used_after: int, desc: torch.Tensor,
                           valid: torch.Tensor, exclude_recent: int,
                           top_k: int):
    """The per-keyframe BoW path: tree descent, tf-idf vector, database
    write, L1 score against every entry, top-k (ties to the lower index).
    Returns (nodes, vector, new vectors, top idx, top scores)."""
    words, nodes = bow.transform(voc, desc, valid)
    v = bow.bow_vector(voc, words, valid)
    vectors = vectors.index_copy(
        0, torch.tensor([slot], device=vectors.device), v[None])
    mask = bow.recent_mask(vectors.shape[0], used_after, exclude_recent,
                           vectors.device)
    scores = bow.score_l1(vectors, v[None, :])
    vals, idx = stable_topk(torch.where(mask, scores,
                                        torch.full_like(scores, -1.0)),
                            top_k)
    return nodes, v, vectors, idx, vals


def _register_query_device_sparse(voc: bow.Vocabulary,
                                  db_words: torch.Tensor,
                                  db_weights: torch.Tensor, slot: int,
                                  used_after: int, desc: torch.Tensor,
                                  valid: torch.Tensor, exclude_recent: int,
                                  top_k: int):
    """Sparse-vector twin of `_register_query_device` for large
    vocabularies: the database holds sorted (capacity, S) posting lists."""
    words, nodes = bow.transform(voc, desc, valid)
    v = bow.sparse_bow_vector(voc, words, valid)
    at = torch.tensor([slot], device=db_words.device)
    db_words = db_words.index_copy(0, at, v.words[None])
    db_weights = db_weights.index_copy(0, at, v.weights[None])
    mask = bow.recent_mask(db_words.shape[0], used_after, exclude_recent,
                           db_words.device)
    scores = bow.score_l1_sparse(v, db_words, db_weights)
    vals, idx = stable_topk(torch.where(mask, scores,
                                        torch.full_like(scores, -1.0)),
                            top_k)
    return nodes, v, db_words, db_weights, idx, vals


def _verify_candidates_device(cam, desc, valid, nodes, kp_xy, T_init,
                              c_desc, c_valid, c_nodes, c_map_idx,
                              c_map_pos, c_T_cw, mcfg: MatcherConfig,
                              scfg: SolverConfig):
    """Geometric verification of the retrieved candidates: per candidate a
    BoW-bucketed match and a motion-only pose optimization from T_init[c]
    (the current pose for loop closure, the candidate's own pose for
    relocalization). c_* index candidates along their first axis (stacked
    tensors or lists).

    Returns (counts (C, 3) int32 = matches, matches with a landmark, pose
    inliers; T_cur_cand (C, 4, 4))."""
    zeros = torch.zeros((desc.shape[0],), dtype=torch.float32,
                        device=desc.device)
    counts, rel = [], []
    for c in range(len(c_T_cw)):
        res = matchers.search_by_bow(
            desc, valid, nodes, zeros, c_desc[c], c_valid[c], c_nodes[c],
            torch.zeros((c_desc[c].shape[0],), dtype=torch.float32,
                        device=desc.device), mcfg)
        cmi = c_map_idx[c]
        midx = cmi[res.idx.clamp(0, cmi.shape[0] - 1)]
        has = res.ok & (midx >= 0)
        pts_w = c_map_pos[c][midx.clamp(0, c_map_pos[c].shape[0] - 1).long()]
        opt = pose_opt.pose_optimization(cam, T_init[c], pts_w, kp_xy,
                                         torch.ones_like(zeros), has, scfg)
        rel.append(se3.compose(opt.T_cw, se3.inverse(c_T_cw[c])))
        counts.append(torch.stack([res.ok.sum(), has.sum(),
                                   opt.num_inliers.long()]))
    return torch.stack(counts).to(torch.int32), torch.stack(rel)


def track_keyframe_register_step(state, img_left, img_right, cam, cfg,
                                 voc: bow.Vocabulary, db_a: torch.Tensor,
                                 db_b: torch.Tensor | None, slot: int,
                                 used_after: int, do_ba: bool,
                                 exclude_recent: int, top_k: int,
                                 sparse: bool,
                                 generator: torch.Generator | None = None):
    """track + keyframe (+ BA) + BoW register/query. db_a/db_b are the
    database tables (dense: vectors/None; sparse: words/weights).

    Returns (state, nodes, vector, new db_a, new db_b, top idx, scores)."""
    from trackingbench_slam_tpu_torch.models import local_mapping
    from trackingbench_slam_tpu_torch.models import vo as vo_mod
    if do_ba:
        state = local_mapping.track_keyframe_ba_step(
            state, img_left, img_right, cam, cfg, generator)
    else:
        state = vo_mod.track_and_keyframe_step(state, img_left, img_right,
                                               cam, cfg, generator)
    f = state.prev
    with torch.profiler.record_function("keyframe.bow_register_query"):
        if sparse:
            nodes, v, dba, dbb, idx, vals = _register_query_device_sparse(
                voc, db_a, db_b, slot, used_after, f.desc, f.valid,
                exclude_recent, top_k)
            return state, nodes, v, dba, dbb, idx, vals
        nodes, v, vectors, idx, vals = _register_query_device(
            voc, db_a, slot, used_after, f.desc, f.valid, exclude_recent,
            top_k)
    return state, nodes, v, vectors, None, idx, vals


@dataclasses.dataclass
class LoopCandidate:
    kf_index: int          # database / keyframe index of the loop partner
    score: float           # BoW similarity
    num_inliers: int
    T_cur_kf: np.ndarray   # relative pose current <- candidate keyframe


class LoopCloser:
    """Host-side orchestrator on the device of `cam` and `voc`.

    Keyframe snapshots live in a ring the size of the BoW database, so a
    database index always names the entry that produced the stored vector.
    Detection is deferred (`finish_detect`): the query verdict is read two
    frames after its keyframe, the candidate verification it triggers one
    frame after that, so a tracking frame never waits on loop work."""

    SPARSE_WORD_THRESHOLD = 32768  # dense (capacity, W) tables below this

    def __init__(self, voc: bow.Vocabulary, cam: cam_mod.CameraParams,
                 matcher_cfg: MatcherConfig = MatcherConfig(),
                 solver_cfg: SolverConfig = SolverConfig(),
                 min_score: float = 0.05, min_inliers: int = 30,
                 exclude_recent: int = 10, capacity: int = 1024,
                 sparse: bool | None = None):
        self.voc = voc
        self.cam = cam
        self.device = cam.fx.device
        self.mcfg = matcher_cfg
        self.scfg = solver_cfg
        self.min_score = min_score
        self.min_inliers = min_inliers
        self.sparse = (voc.num_words >= self.SPARSE_WORD_THRESHOLD
                       if sparse is None else sparse)
        if self.sparse:
            self.db = None          # sized on the first keyframe
            self._capacity = capacity
        else:
            self.db = bow.BowDatabase(voc, capacity=capacity)
        self.exclude_recent = exclude_recent
        self.entries: list[Optional[dict]] = [None] * capacity
        self._pending: Optional[dict] = None
        # keyframes without loop DETECTION after an accepted closure
        # (registration continues); StereoVO calls notify_loop_closed()
        self.detect_cooldown_keyframes = 3
        self._detect_cooldown = 0
        self._pending_verify: Optional[dict] = None

    def notify_loop_closed(self):
        self._detect_cooldown = self.detect_cooldown_keyframes

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _entry(self, desc, valid, nodes, kp_xy, map_idx, map_pos, T_cw,
               vec) -> dict:
        return dict(desc=desc, valid=valid, nodes=nodes, kp_xy=kp_xy,
                    map_idx=self._tensor(map_idx, torch.int32),
                    map_pos=self._tensor(map_pos, torch.float32),
                    T_cw=self._tensor(T_cw, torch.float32), vec=vec)

    def _stage_pending(self, used_after, top_idx, scores, desc, valid,
                       nodes, kp_xy, T_cw, kf_node):
        # overwrites an unconsumed verdict: a fresh query fires at every
        # keyframe anyway
        if used_after <= self.exclude_recent:
            return
        if self._detect_cooldown > 0:
            self._detect_cooldown -= 1
            return
        self._pending = dict(idx=HostCopy(top_idx), scores=HostCopy(scores),
                             desc=desc, valid=valid, nodes=nodes,
                             kp_xy=kp_xy, T_cw=T_cw, kf_node=kf_node)

    def _ensure_db(self, width: int):
        if self.sparse and self.db is None:
            self.db = bow.SparseBowDatabase(self.voc, width=width,
                                            capacity=self._capacity)

    @property
    def num_entries(self) -> int:
        """Live keyframes registered (bounded by the ring capacity)."""
        if self.db is None:
            return 0
        return min(self.db.used, self.db.capacity)

    def add_keyframe(self, desc, valid, kp_xy, map_idx, map_pos, T_cw):
        """Register a keyframe: BowVector into the database and a feature
        snapshot into the ring slot. Returns the slot."""
        words, nodes = bow.transform(self.voc, desc, valid)
        if self.sparse:
            self._ensure_db(desc.shape[0])
            v = bow.sparse_bow_vector(self.voc, words, valid)
        else:
            v = bow.bow_vector(self.voc, words, valid)
        idx = self.db.add(v)
        self.entries[idx] = self._entry(desc, valid, nodes, kp_xy, map_idx,
                                        map_pos, T_cw, v)
        return idx

    def register_and_begin(self, desc, valid, kp_xy, map_idx, map_pos,
                           T_cw, kf_node: int) -> int:
        """Registration + deferred loop query for a keyframe whose step
        already ran; kf_node is its trajectory index."""
        slot, used_after = self.begin_slot(desc.shape[0])
        if self.sparse:
            nodes, v, dba, dbb, top_idx, scores = (
                _register_query_device_sparse(
                    self.voc, self.db.words, self.db.weights, slot,
                    used_after, desc, valid, self.exclude_recent, 3))
        else:
            nodes, v, dba, top_idx, scores = _register_query_device(
                self.voc, self.db.vectors, slot, used_after, desc, valid,
                self.exclude_recent, 3)
            dbb = None
        return self.register_precomputed(slot, used_after, nodes, v, dba,
                                         dbb, top_idx, scores, desc, valid,
                                         kp_xy, map_idx, map_pos, T_cw,
                                         kf_node)

    def begin_slot(self, width: int):
        """(slot, used_after) of the next registration."""
        self._ensure_db(width)
        return self.db.used % self.db.capacity, self.db.used + 1

    def db_tables(self):
        """(db_a, db_b) device tables for track_keyframe_register_step."""
        if self.sparse:
            return self.db.words, self.db.weights
        return self.db.vectors, None

    def register_precomputed(self, slot: int, used_after: int, nodes, vec,
                             db_a, db_b, top_idx, scores, desc, valid,
                             kp_xy, map_idx, map_pos, T_cw, kf_node: int):
        """Absorb the outputs of track_keyframe_register_step: the database
        tables, the entry ring, and the deferred query verdict."""
        if self.sparse:
            self.db.words, self.db.weights = db_a, db_b
        else:
            self.db.vectors = db_a
        self.db.used = used_after
        self.entries[slot] = self._entry(desc, valid, nodes, kp_xy, map_idx,
                                         map_pos, T_cw, vec)
        self._stage_pending(used_after, top_idx, scores, desc, valid,
                            nodes, kp_xy, T_cw, kf_node)
        return slot

    @property
    def has_pending(self) -> bool:
        return self._pending is not None or self._pending_verify is not None

    def finish_detect(self, flush: bool = False):
        """Advance the deferred detection by one stage; returns
        (LoopCandidate | None, kf_node | None) when a verification
        completes. Phase A waits until the query verdict has had two frames
        to land, then issues the candidate verification without reading it;
        phase B (the next call) reads its counts. flush=True drains both
        stages at once (end of run)."""
        if self._pending_verify is not None:
            pv, self._pending_verify = self._pending_verify, None
            return self._finish_verify(pv), pv["kf_node"]
        p = self._pending
        if p is None:
            return None, None
        p["age"] = p.get("age", 0) + 1
        if p["age"] < 2 and not flush:
            return None, None
        self._pending = None
        pv = self._issue_verify(p["idx"].numpy(), p["scores"].numpy(),
                                p["desc"], p["valid"], p["nodes"],
                                p["kp_xy"], p["T_cw"],
                                init_from_candidate=False)
        if pv is None:
            return None, None
        pv["kf_node"] = p["kf_node"]
        if flush:
            return self._finish_verify(pv), pv["kf_node"]
        self._pending_verify = pv
        return None, None

    def detect(self, desc, valid, kp_xy, T_cw_init,
               init_from_candidate: bool = False) -> Optional[LoopCandidate]:
        """Synchronous query + verify (relocalization and tests). With
        init_from_candidate the verification starts from the candidate's
        stored pose, not T_cw_init."""
        if self.num_entries <= self.exclude_recent:
            return None
        words, nodes = bow.transform(self.voc, desc, valid)
        v = (bow.sparse_bow_vector(self.voc, words, valid) if self.sparse
             else bow.bow_vector(self.voc, words, valid))
        idx, scores = self.db.query(v, top_k=3,
                                    exclude_recent=self.exclude_recent)
        pv = self._issue_verify(idx.cpu().numpy(), scores.cpu().numpy(),
                                desc, valid, nodes, kp_xy, T_cw_init,
                                init_from_candidate)
        return None if pv is None else self._finish_verify(pv)

    def _issue_verify(self, idx, scores, desc, valid, nodes, kp_xy,
                      T_cw_init, init_from_candidate: bool):
        """Launch the candidate verification without reading it. Returns
        the pending-verify dict, or None when no candidate clears
        min_score."""
        ranks = [r for r in range(len(idx))
                 if idx[r] >= 0 and scores[r] >= self.min_score
                 and self.entries[int(idx[r])] is not None]
        if not ranks:
            return None
        cands = [self.entries[int(idx[r])] for r in ranks]
        c_T_cw = torch.stack([c["T_cw"] for c in cands])
        T_init = (c_T_cw if init_from_candidate else
                  self._tensor(T_cw_init, torch.float32).expand_as(c_T_cw))
        counts, T_cur_cand = _verify_candidates_device(
            self.cam, desc, valid, nodes, kp_xy, T_init,
            *([c[k] for c in cands] for k in ("desc", "valid", "nodes",
                                               "map_idx", "map_pos")),
            c_T_cw, self.mcfg, self.scfg)
        return dict(counts=HostCopy(counts), T_cur_cand=T_cur_cand,
                    ranks=ranks, idx=idx, scores=scores, kf_node=None)

    def _finish_verify(self, pv) -> Optional[LoopCandidate]:
        """Read the (C, 3) counts and pick the first candidate that passes;
        its relative pose is read only then."""
        counts = pv["counts"].numpy()
        idx, scores = pv["idx"], pv["scores"]
        for k, r in enumerate(pv["ranks"]):
            n_bow, n_lm, n_inl = counts[k]
            if n_bow >= 8 and n_lm >= 8 and n_inl >= self.min_inliers:
                return LoopCandidate(
                    kf_index=int(idx[r]), score=float(scores[r]),
                    num_inliers=int(n_inl),
                    T_cur_kf=pv["T_cur_cand"][k].cpu().numpy())
        return None

    @staticmethod
    def correct_trajectory(T_cw_all: np.ndarray, loop: LoopCandidate,
                           cur_index: int, odom_weight: float = 1.0,
                           loop_weight: float = 5.0,
                           loop_frame_index: int | None = None,
                           edge_index: int | None = None, device=None):
        """Pose graph over T_cw_all[:cur_index + 1] with odometry chain
        edges measured from the trajectory itself and the loop edge from
        edge_index (default cur_index) to loop_frame_index (default
        loop.kf_index). Nodes and edges are padded to a multiple of 64 with
        the last pose repeated and zero-weight invalid edges, which changes
        nothing numerically and keeps the shapes fixed. Runs on `device`
        (CUDA unless given); returns (T_opt (cur_index + 1, 4, 4) numpy,
        cost)."""
        dev = resolve_device(device)
        lj = loop.kf_index if loop_frame_index is None else loop_frame_index
        li = cur_index if edge_index is None else edge_index
        K = cur_index + 1
        ei, ej, Tm, w = [], [], [], []
        for k in range(K - 1):
            ei.append(k)
            ej.append(k + 1)
            Tm.append(T_cw_all[k] @ np.linalg.inv(T_cw_all[k + 1]))
            w.append(odom_weight)
        ei.append(li)
        ej.append(lj)
        Tm.append(loop.T_cur_kf)
        w.append(loop_weight)
        K_pad = -(-K // 64) * 64
        E = len(ei)
        E_pad = K_pad  # chain (K - 1) + 1 loop edge always fits
        T_nodes = np.tile(T_cw_all[K - 1][None], (K_pad, 1, 1))
        T_nodes[:K] = T_cw_all[:K]
        ei = np.pad(np.asarray(ei, np.int64), (0, E_pad - E))
        ej = np.pad(np.asarray(ej, np.int64), (0, E_pad - E))
        Tm = np.concatenate([np.stack(Tm),
                             np.tile(np.eye(4)[None], (E_pad - E, 1, 1))])
        w = np.pad(np.asarray(w, np.float32), (0, E_pad - E))
        val = np.zeros((E_pad,), bool)
        val[:E] = True

        def t(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=dev)
        g = pose_graph.PoseGraph(
            T_cw=t(T_nodes, torch.float32), edge_i=t(ei, torch.int64),
            edge_j=t(ej, torch.int64), T_meas=t(Tm, torch.float32),
            weight=t(w, torch.float32), valid=t(val, torch.bool))
        T_opt, cost = pose_graph.optimize_pose_graph(g, iters=25)
        return T_opt.cpu().numpy()[:K], float(cost)


def apply_loop_correction(state, T_new_traj: torch.Tensor):
    """Write a corrected trajectory into the VOState: ring poses move to
    their corrected trajectory nodes, every landmark is re-anchored through
    its reference keyframe's correction (p' = T_new^-1 T_old p), and the
    current pose becomes the last node.

    T_new_traj: (F, 4, 4) corrected world->camera poses; index f holds the
    pose of device frame_id f + 1 (StereoVO's trajectory convention)."""
    kfs, m = state.kfs, state.map
    F = T_new_traj.shape[0]
    idx = (kfs.frame_id - 1).clamp(0, F - 1).long()
    T_old = kfs.T_cw
    T_new = torch.where(kfs.valid[:, None, None], T_new_traj[idx], T_old)
    A = se3.compose(se3.inverse(T_new), T_old)               # (KF, 4, 4)
    KF = T_old.shape[0]
    ref = m.ref_kf.clamp(0, KF - 1).long()
    has_ref = (m.ref_kf >= 0) & m.valid & kfs.valid[ref]
    Ap = A[ref]
    p_new = torch.einsum("mij,mj->mi", Ap[:, :3, :3], m.pos) + Ap[:, :3, 3]
    m = m._replace(pos=torch.where(has_ref[:, None], p_new, m.pos))
    T_cur = T_new_traj[-1]
    return state._replace(kfs=kfs._replace(T_cw=T_new), map=m, T_cw=T_cur,
                          prev=state.prev._replace(T_cw=T_cur))
