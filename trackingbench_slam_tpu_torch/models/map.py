"""MapState / KeyframeStore: fixed-capacity map tables as tensors.

Port of the parts of trackingbench_slam_tpu/models/map.py that the stereo-VO
track and keyframe steps use. The layouts are the reference's, including the
per-landmark obs_desc (M, K, 8) table and the anchor-patch atlas of 16-px
cells (2048 x 2048 at 16384 points). Descriptors are int32 words with the
reference's uint32 bits.

Updates return new tensors (the tables are cloned by the indexed writes),
as the reference's functional updates do. The reference writes the atlas
with a one-hot matrix product and builds keyframe-centre lookups from
one-hot products to avoid TPU scatters and gathers; here the atlas cells are
written by the anchor-cell kernel into a copy of the atlas, and the lookups
are indexed gathers, which give the same values because the written slots
are unique and each one-hot row selects a single entry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.ops import packing
from trackingbench_slam_tpu_torch.ops.cuda.patch_kernel import (
    CELL as ATLAS_CELL, anchor_cells)
from trackingbench_slam_tpu_torch.ops.hamming import popcount32
from trackingbench_slam_tpu_torch.ops.stats import median


class MapState(NamedTuple):
    pos: torch.Tensor        # (M, 3)
    desc: torch.Tensor       # (M, 8) int32
    normal: torch.Tensor     # (M, 3)
    min_dist: torch.Tensor   # (M,)
    max_dist: torch.Tensor   # (M,)
    valid: torch.Tensor      # (M,) bool
    ref_kf: torch.Tensor     # (M,) int32
    ref_level: torch.Tensor  # (M,) int32
    n_visible: torch.Tensor  # (M,) int32
    n_found: torch.Tensor    # (M,) int32
    n_fail_reproj: torch.Tensor  # (M,) int32
    obs_kf: torch.Tensor     # (M, K) int32, -1 empty
    obs_feat: torch.Tensor   # (M, K) int32
    obs_desc: torch.Tensor   # (M, K, 8) int32
    obs_count: torch.Tensor  # (M,) int32
    anchor_atlas: torch.Tensor  # (G*CELL, G*CELL), G = ceil(sqrt(M))

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def atlas_grid(self) -> int:
        return self.anchor_atlas.shape[0] // ATLAS_CELL


class KeyframeStore(NamedTuple):
    T_cw: torch.Tensor      # (KF, 4, 4)
    kp_xy: torch.Tensor     # (KF, N, 2)
    kp_level: torch.Tensor  # (KF, N)
    kp_angle: torch.Tensor  # (KF, N)
    desc: torch.Tensor      # (KF, N, 8) int32
    bearing: torch.Tensor   # (KF, N, 3)
    map_idx: torch.Tensor   # (KF, N)
    kp_valid: torch.Tensor  # (KF, N)
    valid: torch.Tensor     # (KF,)
    frame_id: torch.Tensor  # (KF,)
    kp_ur: torch.Tensor     # (KF, N) right-image u, -1 = none


def atlas_grid_for(capacity: int) -> int:
    g = 1
    while g * g < capacity:
        g += 1
    return g


def atlas_cell_centers(slots: torch.Tensor, grid: int) -> torch.Tensor:
    """(B,) landmark slots -> (B, 2) atlas (x, y) cell centres."""
    c = ATLAS_CELL
    row = torch.div(slots, grid, rounding_mode="floor")
    col = slots - row * grid
    return torch.stack([col * c + c // 2, row * c + c // 2], -1).float()


def empty_map(capacity: int, max_obs: int, device) -> MapState:
    M, K = capacity, max_obs
    A = atlas_grid_for(M) * ATLAS_CELL
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return MapState(
        anchor_atlas=torch.zeros((A, A), **f32),
        pos=torch.zeros((M, 3), **f32),
        desc=torch.zeros((M, 8), **i32),
        normal=torch.zeros((M, 3), **f32),
        min_dist=torch.zeros((M,), **f32),
        max_dist=torch.full((M,), 1e9, **f32),
        valid=torch.zeros((M,), dtype=torch.bool, device=device),
        ref_kf=torch.full((M,), -1, **i32),
        ref_level=torch.zeros((M,), **i32),
        n_visible=torch.ones((M,), **i32),
        n_found=torch.ones((M,), **i32),
        n_fail_reproj=torch.zeros((M,), **i32),
        obs_kf=torch.full((M, K), -1, **i32),
        obs_feat=torch.full((M, K), -1, **i32),
        obs_desc=torch.zeros((M, K, 8), **i32),
        obs_count=torch.zeros((M,), **i32),
    )


def empty_keyframes(max_kf: int, kp_capacity: int, device) -> KeyframeStore:
    KF, N = max_kf, kp_capacity
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return KeyframeStore(
        T_cw=torch.eye(4, **f32).repeat(KF, 1, 1),
        kp_xy=torch.full((KF, N, 2), -1.0, **f32),
        kp_level=torch.zeros((KF, N), **i32),
        kp_angle=torch.zeros((KF, N), **f32),
        desc=torch.zeros((KF, N, 8), **i32),
        bearing=torch.zeros((KF, N, 3), **f32),
        map_idx=torch.full((KF, N), -1, **i32),
        kp_valid=torch.zeros((KF, N), dtype=torch.bool, device=device),
        valid=torch.zeros((KF,), dtype=torch.bool, device=device),
        frame_id=torch.full((KF,), -1, **i32),
        kp_ur=torch.full((KF, N), -1.0, **f32),
    )


def _drop_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Indices outside [0, size) redirected to the scratch row `size`."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < size), idx,
                       torch.full_like(idx, size))


def _set_rows(dst: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """dst.at[idx].set(src, mode="drop") along dim 0."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    if not torch.is_tensor(src):
        src = torch.full((idx.shape[0],) + tuple(dst.shape[1:]), src,
                         dtype=dst.dtype, device=dst.device)
    ext.index_copy_(0, _drop_index(idx, n), src.to(dst.dtype))
    return ext[:n]


def _add_rows(dst: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """dst.at[idx].add(src, mode="drop") along dim 0."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    if not torch.is_tensor(src):
        src = torch.full((idx.shape[0],), src, dtype=dst.dtype,
                         device=dst.device)
    ext.index_add_(0, _drop_index(idx, n), src.to(dst.dtype))
    return ext[:n]


def write_anchor_patches(m: MapState, img: torch.Tensor, kp_xy, slots,
                         want) -> MapState:
    """Capture 16x16 patches around kp_xy and write them into the atlas
    cells of `slots` (rows not wanted write nowhere): the anchor-cell kernel
    (ops/cuda/patch_kernel.py `anchor_cells`) on a copy of the atlas."""
    return m._replace(anchor_atlas=anchor_cells(
        img, kp_xy, slots, want, m.anchor_atlas, m.capacity))


def free_slot_destinations(free: torch.Tensor, want: torch.Tensor):
    """The r-th wanted item goes to the r-th free slot; items beyond the
    free count get destination == capacity."""
    cap = free.shape[0]
    free_rank = torch.cumsum(free.int(), 0) - 1
    slot_idx = torch.arange(cap, dtype=torch.int32, device=free.device)
    slot_of_rank = _set_rows(
        torch.full((cap,), cap, dtype=torch.int32, device=free.device),
        torch.where(free, free_rank, torch.full_like(free_rank, cap)),
        slot_idx)
    want_rank = torch.cumsum(want.int(), 0) - 1
    take = want & (want_rank < free.sum())
    return torch.where(take, slot_of_rank[want_rank.clamp(0, cap - 1).long()],
                       torch.full_like(want_rank, cap)).int()


def add_points(m: MapState, pos, desc, normal, min_dist, max_dist, ref_kf,
               ref_level, want):
    """Allocate landmarks for the wanted rows. Returns (map, slot (n,)
    int32, == capacity where nothing was written)."""
    dest = free_slot_destinations(~m.valid, want)
    M, K = m.obs_kf.shape
    n = pos.shape[0]
    dev = pos.device
    ones = torch.ones((n,), dtype=torch.int32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.int32, device=dev)
    no_obs = torch.full((n, K), -1, dtype=torch.int32, device=dev)
    (pos_, desc_, normal_, min_d, max_d, valid_, ref_kf_, ref_level_, n_vis,
     n_fnd, n_fail, obs_kf_, obs_feat_, obs_desc_,
     obs_count_) = packing.scatter_rows_set(
        [m.pos, m.desc, m.normal, m.min_dist, m.max_dist, m.valid, m.ref_kf,
         m.ref_level, m.n_visible, m.n_found, m.n_fail_reproj, m.obs_kf,
         m.obs_feat, m.obs_desc.reshape(M, K * 8), m.obs_count],
        dest,
        [pos, desc, normal, min_dist, max_dist,
         torch.ones((n,), dtype=torch.bool, device=dev), ref_kf.int(),
         ref_level.int(), ones, ones, zeros, no_obs, no_obs,
         torch.zeros((n, K * 8), dtype=torch.int32, device=dev), zeros])
    return m._replace(
        pos=pos_, desc=desc_, normal=normal_, min_dist=min_d, max_dist=max_d,
        valid=valid_, ref_kf=ref_kf_, ref_level=ref_level_, n_visible=n_vis,
        n_found=n_fnd, n_fail_reproj=n_fail, obs_kf=obs_kf_,
        obs_feat=obs_feat_, obs_desc=obs_desc_.reshape(M, K, 8),
        obs_count=obs_count_), dest


def add_observations(m: MapState, point_idx, kf_slot, feat_idx, want,
                     desc=None) -> MapState:
    """Append (keyframe, feature, descriptor) observations; a full list
    ring-overwrites."""
    M, K = m.obs_kf.shape
    dev = point_idx.device
    pi = torch.where(want, point_idx, torch.full_like(point_idx, M)).long()
    col = (m.obs_count[pi.clamp(0, M - 1)] % K).clamp(0, K - 1).long()
    flat = torch.where(want, pi * K + col, torch.full_like(pi, M * K))
    kf_b = torch.as_tensor(kf_slot, device=dev).to(torch.int32).expand(
        feat_idx.shape)
    if desc is None:
        desc = torch.zeros((feat_idx.shape[0], 8), dtype=torch.int32,
                           device=dev)
    obs_kf = _set_rows(m.obs_kf.reshape(M * K), flat, kf_b).reshape(M, K)
    obs_feat = _set_rows(m.obs_feat.reshape(M * K), flat,
                         feat_idx.int()).reshape(M, K)
    obs_desc = _set_rows(m.obs_desc.reshape(M * K, 8), flat,
                         desc).reshape(M, K, 8)
    obs_count = _add_rows(m.obs_count, pi, want.int())
    return m._replace(obs_kf=obs_kf, obs_feat=obs_feat, obs_desc=obs_desc,
                      obs_count=obs_count)


def replace_points(m: MapState, old_idx, new_idx, want):
    """MapPoint::Replace: victims die, their visible/found counts merge into
    the keepers. Returns (map, redirect (capacity + 1,))."""
    cap = m.capacity
    oi = torch.where(want & (old_idx != new_idx), old_idx,
                     torch.full_like(old_idx, cap)).long()
    ni = new_idx.clamp(0, cap - 1).long()
    dst = torch.where(oi < cap, ni, torch.full_like(ni, cap))
    oc = oi.clamp(0, cap - 1)
    nvis = _add_rows(m.n_visible, dst, m.n_visible[oc])
    nfnd = _add_rows(m.n_found, dst, m.n_found[oc])
    valid = _set_rows(m.valid, oi, False)
    redirect = _set_rows(torch.arange(cap + 1, dtype=torch.int32,
                                      device=oi.device), oi, ni.int())
    return m._replace(valid=valid, n_visible=nvis, n_found=nfnd), redirect


def increase_visible(m: MapState, point_idx, want) -> MapState:
    pi = torch.where(want, point_idx, torch.full_like(point_idx, m.capacity))
    return m._replace(n_visible=_add_rows(m.n_visible, pi, 1))


def increase_found(m: MapState, point_idx, want) -> MapState:
    pi = torch.where(want, point_idx, torch.full_like(point_idx, m.capacity))
    return m._replace(n_found=_add_rows(m.n_found, pi, 1))


def purge_kf_slot(m: MapState, kf_slot, want) -> MapState:
    """Drop every observation of a keyframe slot that is being reused."""
    hit = (m.obs_kf == kf_slot) & want
    ref_dead = (m.ref_kf == kf_slot) & want
    return m._replace(
        obs_kf=torch.where(hit, torch.full_like(m.obs_kf, -1), m.obs_kf),
        obs_feat=torch.where(hit, torch.full_like(m.obs_feat, -1),
                             m.obs_feat),
        ref_kf=torch.where(ref_dead, torch.full_like(m.ref_kf, -1), m.ref_kf))


def _centers_of(centers: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """centers[slots], zero where slots < 0 (the one-hot product's value)."""
    c = centers[slots.clamp(0, centers.shape[0] - 1).long()]
    return torch.where((slots >= 0)[..., None], c, torch.zeros_like(c))


def update_normal_and_depth(m: MapState, kfs: KeyframeStore,
                            scale_factor: float, num_levels: int) -> MapState:
    """Mean viewing normal and scale-invariance band from the observation
    lists (MapPoint::UpdateNormalAndDepth)."""
    obs_ok = (m.obs_kf >= 0) & m.valid[:, None]
    centers = se3.inverse(kfs.T_cw)[:, :3, 3]
    d = m.pos[:, None, :] - _centers_of(centers, m.obs_kf)
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    dn = torch.where(obs_ok[..., None], dn, torch.zeros_like(dn))
    n_obs = torch.clamp(obs_ok.sum(1), min=1)
    normal = dn.sum(1) / n_obs[:, None]
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1,
                                                    keepdim=True), min=1e-9)
    ref_dist = torch.linalg.norm(m.pos - _centers_of(centers, m.ref_kf),
                                 dim=-1)
    s = torch.full((), scale_factor, dtype=torch.float32, device=m.pos.device)
    max_dist = ref_dist * torch.pow(s, -m.ref_level.float())
    min_dist = max_dist * (s ** (num_levels - 1))
    keep = m.valid & obs_ok.any(1)
    keep_band = keep & (m.ref_kf >= 0)
    return m._replace(
        normal=torch.where(keep[:, None], normal, m.normal),
        max_dist=torch.where(keep_band, max_dist, m.max_dist),
        min_dist=torch.where(keep_band, min_dist, m.min_dist))


def compute_distinctive_descriptors(m: MapState, kfs=None) -> MapState:
    """Representative descriptor = the observation with the least median
    Hamming distance to the others (MapPoint::ComputeDistinctive-
    Descriptors), from the obs_desc table.

    Reproduces the reference's median over all K columns with dead pairs at
    1e6: with <= K/2 - 1 live observations every median saturates at 1e6
    and the argmin picks column 0, live or not."""
    del kfs
    M, K = m.obs_kf.shape
    obs_ok = (m.obs_kf >= 0) & (m.obs_feat >= 0)
    descs = m.obs_desc
    x = descs[:, :, None, :] ^ descs[:, None, :, :]
    dist = popcount32(x).sum(-1).float()
    pair_ok = obs_ok[:, :, None] & obs_ok[:, None, :]
    big = 1e6
    dist = torch.where(pair_ok, dist, torch.full_like(dist, big))
    med = median(dist, dim=-1)
    med = torch.where(obs_ok, med, torch.full_like(med, big))
    best = torch.argmin(med, dim=-1)
    chosen = descs[torch.arange(M, device=descs.device), best]
    has_obs = obs_ok.any(-1) & m.valid
    return m._replace(desc=torch.where(has_obs[:, None], chosen, m.desc))


def predict_scale(m: MapState, dist, scale_factor: float, num_levels: int):
    ratio = torch.clamp(m.max_dist / torch.clamp(dist, min=1e-9), min=1e-9)
    inv = 1.0 / scale_factor
    lvl = torch.ceil(torch.log(ratio) / torch.log(torch.full(
        (), inv, dtype=ratio.dtype, device=ratio.device))).int()
    return lvl.clamp(0, num_levels - 1)


def next_kf_slot(kfs: KeyframeStore) -> torch.Tensor:
    """First free ring slot, else the one with the oldest frame_id."""
    free = ~kfs.valid
    first_free = torch.argmax(free.int())
    big = torch.iinfo(torch.int32).max
    oldest = torch.argmin(torch.where(kfs.valid, kfs.frame_id,
                                      torch.full_like(kfs.frame_id, big)))
    return torch.where(free.any(), first_free, oldest)


def insert_keyframe(kfs: KeyframeStore, frame, frame_id, slot=None,
                    kp_ur=None):
    """Write a frame snapshot into ring slot `slot`. Returns (store, slot)."""
    if slot is None:
        slot = next_kf_slot(kfs)
    if kp_ur is None:
        kp_ur = torch.full(frame.kp_level.shape, -1.0, dtype=torch.float32,
                           device=frame.kp_xy.device)
    idx = torch.as_tensor(slot, device=kfs.valid.device).long().reshape(1)

    def put(table, row):
        return _set_rows(table, idx, torch.as_tensor(
            row, device=table.device).to(table.dtype)[None])

    return kfs._replace(
        T_cw=put(kfs.T_cw, frame.T_cw), kp_xy=put(kfs.kp_xy, frame.kp_xy),
        kp_level=put(kfs.kp_level, frame.kp_level),
        kp_angle=put(kfs.kp_angle, frame.kp_angle),
        desc=put(kfs.desc, frame.desc), bearing=put(kfs.bearing, frame.bearing),
        map_idx=put(kfs.map_idx, frame.map_idx),
        kp_valid=put(kfs.kp_valid, frame.valid),
        valid=put(kfs.valid, True), frame_id=put(kfs.frame_id, frame_id),
        kp_ur=put(kfs.kp_ur, kp_ur)), slot
