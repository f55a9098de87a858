"""Landmark-sharded windowed bundle adjustment over torch.distributed.

Port of trackingbench_slam_tpu/parallel/dist_ba.py, where a shard_map over
the mesh axis 'lm' runs one program per device. Here each rank of an 'lm'
process group (parallel/mesh.py) runs the same loop on its own shard:

  * landmarks are sharded over the ranks and every observation lives with
    its landmark's shard (`partition_problem` for the flat layout, equal
    row blocks for the grouped one, `row_block`);
  * the K window poses are replicated;
  * each rank builds its local BA blocks (solvers/local_ba.py); U and bp are
    partial sums over its observations, V, W and bl stay local;
  * the Schur-reduced camera system S = U - W V^-1 W^T and its right-hand
    side are summed over the group by ONE all-reduce per LM iteration;
  * every rank Cholesky-solves the replicated (6K, 6K) system
    (`cholesky_solve_or_nan`) and back-substitutes only its own landmarks;
  * the trial cost and the non-finite-step flag go in a second all-reduce,
    so every rank takes the same accept decision. Without the flag's
    all-reduce a NaN confined to one shard would not show in the summed
    cost, ranks would disagree on `accept` and the replicated poses would
    drift apart.

So an LM iteration makes two collectives: (6K)^2 + 6K floats and 2 floats.
`group=None` is a world of one: the same loop with no collective.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.solvers import local_ba
from trackingbench_slam_tpu_torch.solvers.reprojection import huber_rho


class ShardedBAProblem(NamedTuple):
    """Landmark-sharded flat window. As `partition_problem` returns it, the
    leading axis of points / obs_* is the global (shard-major) axis: shard d
    owns rows [d * M_loc, (d + 1) * M_loc) and observations [d * O_loc,
    (d + 1) * O_loc), whose obs_lm index the shard's own rows [0, M_loc).
    `local_shard` cuts one shard out of it, which is what a rank holds."""

    T_cw: torch.Tensor        # (K, 4, 4) replicated
    points: torch.Tensor      # (D * M_loc, 3)
    obs_kf: torch.Tensor      # (D * O_loc,) window pose ids
    obs_lm: torch.Tensor      # (D * O_loc,) shard-local landmark ids
    obs_px: torch.Tensor      # (D * O_loc, 2)
    obs_inv_sigma2: torch.Tensor
    obs_valid: torch.Tensor
    obs_ur: torch.Tensor      # (D * O_loc,) right-image u; -1 = mono row


def partition_problem(p: local_ba.BAProblem,
                      num_shards: int) -> ShardedBAProblem:
    """Host-side partitioner: block-assign landmarks to shards, co-locate
    and re-index their observations, pad every shard to the largest count.
    Vectorized as the reference's: a stable argsort on the shard id groups
    the observations and a running index places each row. The tensors come
    back on the problem's device."""
    dev = p.T_cw.device
    M = p.points.shape[0]
    O = p.obs_px.shape[0]
    m_loc = -(-M // num_shards)
    obs_lm = p.obs_lm.cpu().numpy()
    obs_shard = obs_lm // m_loc
    counts = np.bincount(obs_shard, minlength=num_shards)
    o_loc = max(int(counts.max()), 1)
    pts = np.zeros((num_shards * m_loc, 3), np.float32)
    pts[:M] = p.points.cpu().numpy()
    okf = np.zeros((num_shards, o_loc), np.int32)
    olm = np.zeros((num_shards, o_loc), np.int32)
    opx = np.zeros((num_shards, o_loc, 2), np.float32)
    ois = np.zeros((num_shards, o_loc), np.float32)
    ova = np.zeros((num_shards, o_loc), bool)
    our = np.full((num_shards, o_loc), -1.0, np.float32)
    order = np.argsort(obs_shard, kind="stable")        # group by shard
    srt = obs_shard[order]
    # position within the shard = rank within its group
    starts = np.zeros(num_shards, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    pos = np.arange(O, dtype=np.int64) - starts[srt]
    okf[srt, pos] = p.obs_kf.cpu().numpy()[order]
    olm[srt, pos] = obs_lm[order] - srt * m_loc
    opx[srt, pos] = p.obs_px.cpu().numpy()[order]
    ois[srt, pos] = p.obs_inv_sigma2.cpu().numpy()[order]
    ova[srt, pos] = p.obs_valid.cpu().numpy()[order]
    if p.obs_ur is not None:
        our[srt, pos] = p.obs_ur.cpu().numpy()[order]

    def t(a):
        return torch.from_numpy(a).to(dev)
    return ShardedBAProblem(
        T_cw=p.T_cw, points=t(pts), obs_kf=t(okf.reshape(-1)),
        obs_lm=t(olm.reshape(-1)), obs_px=t(opx.reshape(-1, 2)),
        obs_inv_sigma2=t(ois.reshape(-1)), obs_valid=t(ova.reshape(-1)),
        obs_ur=t(our.reshape(-1)))


def local_shard(sp: ShardedBAProblem, num_shards: int,
                index: int) -> ShardedBAProblem:
    """Shard `index` of a partitioned problem: what one rank holds."""
    m_loc = sp.points.shape[0] // num_shards
    o_loc = sp.obs_kf.shape[0] // num_shards

    def rows(x, n):
        return x[index * n:(index + 1) * n]
    return ShardedBAProblem(
        T_cw=sp.T_cw, points=rows(sp.points, m_loc),
        **{f: rows(getattr(sp, f), o_loc) for f in ShardedBAProblem._fields
           if f.startswith("obs_")})


def row_block(gp: local_ba.GroupedBAProblem, num_shards: int,
              index: int) -> local_ba.GroupedBAProblem:
    """Rank `index`'s equal row block of a grouped window: landmarks travel
    with their observation rows, nothing is re-indexed (obs_kf holds window
    pose ids). L must divide evenly; pad with invalid rows."""
    L = gp.points.shape[0]
    if L % num_shards:
        raise ValueError(f"{L} landmark rows do not split into "
                         f"{num_shards} equal blocks")
    n = L // num_shards
    return gp._replace(**{
        f: getattr(gp, f)[index * n:(index + 1) * n]
        for f in local_ba.GroupedBAProblem._fields
        if f != "T_cw" and getattr(gp, f) is not None})


def _all_reduce(group, *ts: torch.Tensor) -> list[torch.Tensor]:
    """The sums of `ts` over the group in ONE all-reduce (the tensors
    packed into one float32 buffer), or `ts` themselves for group None."""
    if group is None:
        return list(ts)
    buf = torch.cat([t.reshape(-1).to(torch.float32) for t in ts])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return [x.reshape(t.shape).to(t.dtype)
            for x, t in zip(buf.split([t.numel() for t in ts]), ts)]


def _reduced_system(U, V, Wb, bp, bl, lam):
    """This shard's share of the reduced camera system (K, 6, K, 6) with U
    on its diagonal blocks (undamped), the right-hand side (K, 6), and the
    shard's damped V^-1."""
    K = U.shape[0]
    Vinv = local_ba.inv3x3_sym(local_ba.damp_diagonal(V, lam, 3))
    T1 = torch.einsum("mkij,mjl->mkil", Wb, Vinv)
    S = -torch.einsum("maij,mbkj->aibk", T1, Wb)
    eyeK = torch.eye(K, dtype=U.dtype, device=U.device)
    S = S + torch.einsum("kij,kl->kilj", U, eyeK)
    rhs = bp - torch.einsum("mkij,mj->ki", T1, bl)
    return S, rhs, Vinv


def _solve_step(S, rhs, Wb, Vinv, bl, lam, fixed_mask):
    """Marquardt damping on the assembled diagonal, the clamp mask (fixed
    rows and columns become identity with a zero right-hand side), one
    Cholesky solve of the replicated system and this shard's landmark
    back-substitution. Returns (dxi (K, 6), dX (M_loc, 3))."""
    K = S.shape[0]
    eyeK = torch.eye(K, dtype=S.dtype, device=S.device)
    diag = torch.einsum("kiki->ki", S)
    S = S + torch.einsum("ki,ij,kl->kilj", lam * diag + 1e-6,
                         torch.eye(6, dtype=S.dtype, device=S.device), eyeK)
    fixed = fixed_mask.to(S.dtype)
    free = 1.0 - fixed
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S + torch.diag_embed(fixed[:, None].expand(K, 6).reshape(-1)
                             ).reshape(K, 6, K, 6)
    rhs = rhs * free[:, None]
    dxi = local_ba.cholesky_solve_or_nan(S.reshape(6 * K, 6 * K),
                                         rhs.reshape(-1)).reshape(K, 6)
    dxi = dxi * free[:, None]
    corr = torch.einsum("mkij,ki->mj", Wb, dxi)
    dX = torch.einsum("mij,mj->mi", Vinv, bl - corr)
    return dxi, dX


def _accept_all(group, cost, c_local, dxi, dX):
    """(accept, c_new): the summed trial cost and the all-reduced
    non-finite flag of dX, in one collective, so every rank decides the
    same."""
    bad_local = (~torch.isfinite(dX)).any().to(torch.float32)
    c_new, bad = _all_reduce(group, c_local.to(torch.float32), bad_local)
    accept = ((c_new < cost) & torch.isfinite(c_new)
              & torch.isfinite(dxi).all() & (bad == 0))
    return accept, c_new


def _fixed(K, num_fixed, fixed_mask, device):
    if fixed_mask is None:
        return torch.arange(K, device=device) < num_fixed
    return fixed_mask


def _flat_cost(cam, T_cw, points, p, huber_delta, stereo_weight):
    r, pc, _, _, row_ok = local_ba._obs_residuals(cam, T_cw, points, p,
                                                  stereo_weight)
    chi2 = local_ba._obs_chi2(r, row_ok, p.obs_inv_sigma2)
    chi2 = torch.where(pc[:, 2] <= 0.05, torch.zeros_like(chi2), chi2)
    rho = chi2 if huber_delta is None else huber_rho(chi2, huber_delta)
    return torch.where(p.obs_valid, rho, torch.zeros_like(rho)).sum()


def distributed_bundle_adjust(group, cam, sp: ShardedBAProblem,
                              iters: int = 10,
                              huber_delta: float | None = 2.4477,
                              init_lambda: float = 1e-4,
                              num_fixed: int = 1,
                              stereo_weight: float = 1.0):
    """LM over the landmark-sharded flat window. `sp` is this rank's shard
    (`local_shard`; the whole partitioned problem for group None). Returns
    (T_cw (K, 4, 4) replicated, points (M_loc, 3) of this shard)."""
    obs_ur = sp.obs_ur
    if obs_ur is None:   # mono problem: an explicit all-mono stereo column
        obs_ur = torch.full_like(sp.obs_inv_sigma2, -1.0)
    prob = local_ba.BAProblem(
        T_cw=sp.T_cw, points=sp.points, obs_kf=sp.obs_kf, obs_lm=sp.obs_lm,
        obs_px=sp.obs_px, obs_inv_sigma2=sp.obs_inv_sigma2,
        obs_valid=sp.obs_valid, obs_ur=obs_ur)
    K = sp.T_cw.shape[0]
    fixed_mask = _fixed(K, num_fixed, None, sp.T_cw.device)

    def cost_of(T, X):
        return _flat_cost(cam, T, X, prob, huber_delta, stereo_weight)

    T, X = sp.T_cw, sp.points
    lam = torch.full((), init_lambda, dtype=torch.float32, device=T.device)
    cost, = _all_reduce(group, cost_of(T, X))
    for _ in range(iters):
        U, V, Wb, bp, bl, _ = local_ba.build_ba_blocks(
            cam, T, X, prob, huber_delta, stereo_weight)
        S, rhs, Vinv = _reduced_system(U, V, Wb, bp, bl, lam)
        S, rhs = _all_reduce(group, S, rhs)
        dxi, dX = _solve_step(S, rhs, Wb, Vinv, bl, lam, fixed_mask)
        T_new, X_new = local_ba._lm_step(T, X, dxi, dX)
        accept, c_new = _accept_all(group, cost, cost_of(T_new, X_new), dxi,
                                    dX)
        T = torch.where(accept, T_new, T)
        X = torch.where(accept, X_new, X)
        lam = local_ba._damping(lam, accept)
        cost = torch.where(accept, c_new, cost)
    return se3.normalize(T), X


def distributed_bundle_adjust_grouped(group, cam,
                                      gp: local_ba.GroupedBAProblem,
                                      iters: int = 10,
                                      huber_delta: float | None = 2.4477,
                                      init_lambda: float = 1e-4,
                                      num_fixed: int = 1,
                                      fixed_mask: torch.Tensor | None = None,
                                      stereo_weight: float = 1.0):
    """Single-sweep LM over this rank's row block of a grouped window
    (`row_block`; the whole window for group None): the build at the trial
    point is also the trial cost, and accept adopts the trial blocks, as in
    local_ba.bundle_adjust_grouped. fixed_mask ((K,) bool, replicated)
    overrides num_fixed; clamped poses keep contributing observations.
    Returns (T_cw (K, 4, 4) replicated, points (L_loc, 3) of this block)."""
    if gp.obs_ur is None:
        gp = gp._replace(obs_ur=torch.full_like(gp.obs_inv_sigma2, -1.0))
    K = gp.T_cw.shape[0]
    fixed_mask = _fixed(K, num_fixed, fixed_mask, gp.T_cw.device)

    def build(T, X):
        return local_ba.build_grouped_blocks(
            cam, T, X, gp._replace(T_cw=T, points=X), huber_delta,
            stereo_weight)

    T, X = gp.T_cw, gp.points
    *blocks, c_local = build(T, X)
    cost, = _all_reduce(group, c_local)
    lam = torch.full((), init_lambda, dtype=torch.float32, device=T.device)
    for _ in range(iters):
        U, V, Wb, bp, bl = blocks
        S, rhs, Vinv = _reduced_system(U, V, Wb, bp, bl, lam)
        S, rhs = _all_reduce(group, S, rhs)
        dxi, dX = _solve_step(S, rhs, Wb, Vinv, bl, lam, fixed_mask)
        T_new, X_new = local_ba._lm_step(T, X, dxi, dX)
        *trial, c_local = build(T_new, X_new)
        accept, c_new = _accept_all(group, cost, c_local, dxi, dX)
        T = torch.where(accept, T_new, T)
        X = torch.where(accept, X_new, X)
        blocks = [torch.where(accept, new, old)
                  for new, old in zip(trial, blocks)]
        lam = local_ba._damping(lam, accept)
        cost = torch.where(accept, c_new, cost)
    return se3.normalize(T), X
