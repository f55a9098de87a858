"""Windowed local bundle adjustment via the Schur complement.

Port of trackingbench_slam_tpu/solvers/local_ba.py: the flat (`BAProblem`)
and landmark-grouped (`GroupedBAProblem`) windows, their residuals and
normal-equation blocks

    U (K, 6, 6) pose diagonal blocks, V (M, 3, 3) landmark diagonal blocks,
    Wb (M, K, 6, 3) pose-landmark coupling, bp (K, 6), bl (M, 3),

the Schur solve (reduced (6K, 6K) camera system, one Cholesky, batched 3x3
back-substitution) and the LM loops. Every tensor is float32, as in the
reference (TF32 is off, see the package __init__).

Two properties of the reference are kept on purpose:
  * A Cholesky that fails (a reduced system that is not positive definite)
    gives an all-NaN step, as jax.scipy.linalg.cho_factor does; the LM
    accept test rejects any non-finite step. torch.linalg.cholesky_ex
    returns a finite partial factor instead, so the solution is replaced by
    NaN where its `info` is non-zero, with torch.where: no host sync.
  * The LM iterations choose between trial and current state with
    torch.where on the device; nothing is fetched inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.solvers.reprojection import (huber_rho,
                                                               huber_weight)


class BAProblem(NamedTuple):
    """Fixed-capacity flat window: K poses, M landmarks, O observations.
    obs_ur: right-image u per observation for the stereo row, -1 = mono;
    None disables the stereo rows."""

    T_cw: torch.Tensor        # (K, 4, 4)
    points: torch.Tensor      # (M, 3)
    obs_kf: torch.Tensor      # (O,) int in [0, K)
    obs_lm: torch.Tensor      # (O,) int in [0, M)
    obs_px: torch.Tensor      # (O, 2)
    obs_inv_sigma2: torch.Tensor  # (O,)
    obs_valid: torch.Tensor   # (O,) bool
    obs_ur: torch.Tensor | None = None   # (O,)


class BAResult(NamedTuple):
    T_cw: torch.Tensor
    points: torch.Tensor
    chi2: torch.Tensor        # final total robust cost
    inliers: torch.Tensor     # (O,) final chi2 gate


class GroupedBAProblem(NamedTuple):
    """Landmark-grouped window: the observation table keeps the map's
    (L, O) per-landmark layout. obs_kf: (L, O) dense window pose ids, -1 =
    empty slot."""

    T_cw: torch.Tensor            # (K, 4, 4)
    points: torch.Tensor          # (L, 3)
    obs_kf: torch.Tensor          # (L, O)
    obs_px: torch.Tensor          # (L, O, 2)
    obs_inv_sigma2: torch.Tensor  # (L, O)
    obs_valid: torch.Tensor       # (L, O) bool
    obs_ur: torch.Tensor | None = None   # (L, O), -1 = mono


def _stereo_rows(cam, pc, proj, r, J, obs_ur, stereo_weight):
    """Append the rectified right-image row u_R - (u - bf/z) to the
    residuals (..., 2) and Jacobians (..., 2, 6)."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    r_ur = obs_ur - (proj[..., 0] - cam.bf / zs)
    zero = torch.zeros_like(x)
    # d z / d xi for a left-multiplied increment: [0, 0, 1, y, -x, 0]
    Jz = torch.stack([zero, zero, torch.ones_like(x), y, -x, zero], -1)
    J_ur = J[..., 0, :] + (cam.bf / (zs * zs))[..., None] * Jz
    row_ok = torch.cat([torch.ones_like(r),
                        stereo_weight * (obs_ur >= 0).to(r.dtype)[..., None]],
                       -1)
    return (torch.cat([r, r_ur[..., None]], -1),
            torch.cat([J, J_ur[..., None, :]], -2), row_ok)


def _obs_residuals(cam, T_cw, points, p: BAProblem,
                   stereo_weight: float = 1.0):
    """(r (O, R), pc, J (O, R, 6), Jl (O, R, 3), row_ok (O, R)), R = 2 for
    mono problems and 3 with stereo rows. stereo_weight scales the u_R
    row's weight through row_ok."""
    T_o = T_cw[p.obs_kf.long()]
    X_o = points[p.obs_lm.long()]
    R_o = T_o[:, :3, :3]
    pc = torch.einsum("oij,oj->oi", R_o, X_o) + T_o[:, :3, 3]
    proj = cam_mod.world2cam(cam, pc)
    r = p.obs_px - proj
    J = cam_mod.project_jacobian(cam, pc)
    if p.obs_ur is not None:
        r, J, row_ok = _stereo_rows(cam, pc, proj, r, J, p.obs_ur,
                                    stereo_weight)
    else:
        row_ok = torch.ones_like(r)
    # d row / d X_w = (d row / d pc) . R; the translation columns of J are
    # d row / d pc (left-multiplied increments)
    Jl = torch.einsum("oij,ojk->oik", J[:, :, :3], R_o)
    return r, pc, J, Jl, row_ok


def _obs_chi2(r, row_ok, inv_sigma2):
    return (r * r * row_ok).sum(-1) * inv_sigma2


def build_ba_blocks(cam, T_cw, points, p: BAProblem,
                    huber_delta: float | None, stereo_weight: float = 1.0):
    """(U, V, Wb, bp, bl, cost) of the flat window, by index_add."""
    K, M = T_cw.shape[0], points.shape[0]
    r, pc, J, Jl, row_ok = _obs_residuals(cam, T_cw, points, p,
                                          stereo_weight)
    chi2 = _obs_chi2(r, row_ok, p.obs_inv_sigma2)
    w = p.obs_inv_sigma2 * p.obs_valid * (pc[:, 2] > 0.05)
    if huber_delta is not None:
        w = w * huber_weight(chi2, huber_delta)
    W = w[:, None] * row_ok
    Jw = J * W[:, :, None]
    Jlw = Jl * W[:, :, None]
    kf, lm = p.obs_kf.long(), p.obs_lm.long()
    f32 = dict(dtype=J.dtype, device=J.device)
    U = torch.zeros((K, 6, 6), **f32).index_add(
        0, kf, torch.einsum("oij,oik->ojk", Jw, J))
    V = torch.zeros((M, 3, 3), **f32).index_add(
        0, lm, torch.einsum("oij,oik->ojk", Jlw, Jl))
    Wb = torch.zeros((M * K, 6, 3), **f32).index_add(
        0, lm * K + kf, torch.einsum("oij,oik->ojk", Jw, Jl)).reshape(
        M, K, 6, 3)
    bp = torch.zeros((K, 6), **f32).index_add(
        0, kf, torch.einsum("oij,oi->oj", Jw, r))
    bl = torch.zeros((M, 3), **f32).index_add(
        0, lm, torch.einsum("oij,oi->oj", Jlw, r))
    rho = chi2 if huber_delta is None else huber_rho(chi2, huber_delta)
    cost = torch.where(p.obs_valid, rho, torch.zeros_like(rho)).sum()
    return U, V, Wb, bp, bl, cost


def damp_diagonal(A, lam, n: int):
    """Marquardt damping: A + (lam * diag(A) + 1e-6) I over leading dims."""
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return A + (lam * d + 1e-6)[..., None] * eye


def inv3x3_sym(A):
    """Closed-form batched inverse (adjugate / det) of symmetric 3x3
    blocks; |det| is floored at 1e-30."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30,
                                torch.full_like(det, 1e-30), det)
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c01, c11, c12], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    return adj * inv_det[..., None, None]


def cholesky_solve_or_nan(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b through the lower Cholesky factor of A (its lower
    triangle is read). Where the factorization fails, x is all NaN, as the
    reference's cho_factor/cho_solve give; no host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def schur_solve(U, V, Wb, bp, bl, lam, num_fixed: int = 1,
                fixed_mask: torch.Tensor | None = None):
    """Reduced camera system + landmark back-substitution.

    The first `num_fixed` poses are clamped; `fixed_mask` ((K,) bool)
    overrides num_fixed and clamps every masked pose. A clamped pose's rows
    and columns of the reduced system become identity with a zero right-hand
    side, so its step is zero. Returns (dxi (K, 6), dX (M, 3))."""
    K = U.shape[0]
    dev = U.device
    Vinv = inv3x3_sym(damp_diagonal(V, lam, 3))
    T1 = torch.einsum("mkij,mjl->mkil", Wb, Vinv)               # (M,K,6,3)
    S = -torch.einsum("maij,mbkj->aibk", T1, Wb)                # (K,6,K,6)
    eyeK = torch.eye(K, dtype=U.dtype, device=dev)
    S = S + torch.einsum("kij,kl->kilj", damp_diagonal(U, lam, 6), eyeK)
    rhs = bp - torch.einsum("mkij,mj->ki", T1, bl)              # (K, 6)
    if fixed_mask is None:
        fixed_mask = torch.arange(K, device=dev) < num_fixed
    fixed = fixed_mask.to(U.dtype)
    free = 1.0 - fixed
    S = S * free[:, None, None, None] * free[None, None, :, None]
    # identity diagonal on the clamped blocks keeps the system non-singular
    S = S + torch.diag_embed(fixed[:, None].expand(K, 6).reshape(-1)
                             ).reshape(K, 6, K, 6)
    rhs = rhs * free[:, None]
    dxi = cholesky_solve_or_nan(S.reshape(6 * K, 6 * K),
                                rhs.reshape(-1)).reshape(K, 6)
    dxi = dxi * free[:, None]
    # back-substitute: dX_m = Vinv_m (bl_m - sum_k W_{m,k}^T dxi_k)
    corr = torch.einsum("mkij,ki->mj", Wb, dxi)
    dX = torch.einsum("mij,mj->mi", Vinv, bl - corr)
    return dxi, dX


def _grouped_residuals(cam, T_cw, points, p: GroupedBAProblem,
                       stereo_weight: float = 1.0):
    """(r (L, O, R), pc, J (L, O, R, 6), Jl (L, O, R, 3), row_ok)."""
    K = T_cw.shape[0]
    T_o = T_cw[p.obs_kf.clamp(0, K - 1).long()]                # (L,O,4,4)
    R_o = T_o[..., :3, :3]
    pc = torch.einsum("loij,lj->loi", R_o, points) + T_o[..., :3, 3]
    proj = cam_mod.world2cam(cam, pc)
    r = p.obs_px - proj
    J = cam_mod.project_jacobian(cam, pc)
    if p.obs_ur is not None:
        r, J, row_ok = _stereo_rows(cam, pc, proj, r, J, p.obs_ur,
                                    stereo_weight)
    else:
        row_ok = torch.ones_like(r)
    Jl = torch.einsum("lorj,lojk->lork", J[..., :3], R_o)
    return r, pc, J, Jl, row_ok


def build_grouped_blocks(cam, T_cw, points, p: GroupedBAProblem,
                         huber_delta: float | None,
                         stereo_weight: float = 1.0):
    """Scatter-free blocks: pose-indexed sums go through one (L, O, K)
    one-hot contraction, landmark sums reduce over the local O axis. Empty
    and rejected slots take the one-hot's extra class K, which is dropped,
    as jax.nn.one_hot gives a zero row for index K."""
    K = T_cw.shape[0]
    r, pc, J, Jl, row_ok = _grouped_residuals(cam, T_cw, points, p,
                                              stereo_weight)
    chi2 = _obs_chi2(r, row_ok, p.obs_inv_sigma2)
    ok = p.obs_valid & (p.obs_kf >= 0) & (pc[..., 2] > 0.05)
    w = p.obs_inv_sigma2 * ok
    if huber_delta is not None:
        w = w * huber_weight(chi2, huber_delta)
    W = w[..., None] * row_ok
    Jw = J * W[..., None]
    Jlw = Jl * W[..., None]
    cls = torch.where(ok, p.obs_kf.long(), torch.full_like(p.obs_kf.long(),
                                                            K))
    onehot = F.one_hot(cls, K + 1)[..., :K].to(J.dtype)        # (L, O, K)
    JtJ = torch.einsum("lorj,lork->lojk", Jw, J)
    U = torch.einsum("lok,loij->kij", onehot, JtJ)
    V = torch.einsum("lorj,lork->ljk", Jlw, Jl)
    JtJl = torch.einsum("lorj,lork->lojk", Jw, Jl)
    Wb = torch.einsum("lok,loij->lkij", onehot, JtJl)
    Jtr = torch.einsum("lorj,lor->loj", Jw, r)
    bp = torch.einsum("lok,loj->kj", onehot, Jtr)
    bl = torch.einsum("lorj,lor->lj", Jlw, r)
    rho = chi2 if huber_delta is None else huber_rho(chi2, huber_delta)
    cost = torch.where(ok, rho, torch.zeros_like(rho)).sum()
    return U, V, Wb, bp, bl, cost


def _lm_step(T_cw, points, dxi, dX):
    return se3.compose(se3.exp(dxi), T_cw), points + dX


def _accept(cost, c_new, dxi, dX):
    """A non-finite step is never accepted: NaN positions fall out of the
    behind-camera mask, so a NaN step would score cost 0."""
    return ((c_new < cost) & torch.isfinite(c_new)
            & torch.isfinite(dxi).all() & torch.isfinite(dX).all())


def _damping(lam, accept):
    return torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                       torch.clamp(lam * 10.0, max=1e8))


def bundle_adjust_grouped(cam: cam_mod.CameraParams, p: GroupedBAProblem,
                          iters: int = 10,
                          huber_delta: float | None = 2.4477,
                          init_lambda: float = 1e-4,
                          num_fixed: int = 1,
                          fixed_mask: torch.Tensor | None = None,
                          stereo_weight: float = 1.0):
    """Single-sweep LM over the grouped blocks; returns (T_cw (K, 4, 4),
    points (L, 3)). The blocks ride the loop state: each iteration solves
    from them, steps, and builds once at the trial point, whose cost is the
    trial cost; accept adopts the trial state and its blocks."""

    def build(T_cw, points):
        return build_grouped_blocks(cam, T_cw, points, p, huber_delta,
                                    stereo_weight)

    *blocks, cost = build(p.T_cw, p.points)
    T_cw, points = p.T_cw, p.points
    lam = torch.full((), init_lambda, dtype=torch.float32,
                     device=T_cw.device)
    for _ in range(iters):
        dxi, dX = schur_solve(*blocks, lam, num_fixed, fixed_mask)
        T_new, X_new = _lm_step(T_cw, points, dxi, dX)
        *trial, c_new = build(T_new, X_new)
        accept = _accept(cost, c_new, dxi, dX)
        T_cw = torch.where(accept, T_new, T_cw)
        points = torch.where(accept, X_new, points)
        blocks = [torch.where(accept, new, old)
                  for new, old in zip(trial, blocks)]
        lam = _damping(lam, accept)
        cost = torch.where(accept, c_new, cost)
    return se3.normalize(T_cw), points


def bundle_adjust(cam: cam_mod.CameraParams, problem: BAProblem,
                  iters: int = 10, huber_delta: float | None = 2.4477,
                  init_lambda: float = 1e-4, num_fixed: int = 1,
                  stereo_weight: float = 1.0) -> BAResult:
    """LM over Schur-reduced steps on the flat window, with a separate
    cost sweep per iteration; then the chi2 inlier gate (5.991 for mono
    observations, 7.815 for stereo ones)."""

    def total_cost(T_cw, points):
        r, pc, _, _, row_ok = _obs_residuals(cam, T_cw, points, problem,
                                             stereo_weight)
        chi2 = _obs_chi2(r, row_ok, problem.obs_inv_sigma2)
        chi2 = torch.where(pc[:, 2] <= 0.05, torch.zeros_like(chi2), chi2)
        rho = chi2 if huber_delta is None else huber_rho(chi2, huber_delta)
        return torch.where(problem.obs_valid, rho,
                           torch.zeros_like(rho)).sum()

    T_cw, points = problem.T_cw, problem.points
    lam = torch.full((), init_lambda, dtype=torch.float32,
                     device=T_cw.device)
    cost = total_cost(T_cw, points)
    for _ in range(iters):
        U, V, Wb, bp, bl, _ = build_ba_blocks(cam, T_cw, points, problem,
                                              huber_delta, stereo_weight)
        dxi, dX = schur_solve(U, V, Wb, bp, bl, lam, num_fixed)
        T_new, X_new = _lm_step(T_cw, points, dxi, dX)
        c_new = total_cost(T_new, X_new)
        accept = _accept(cost, c_new, dxi, dX)
        T_cw = torch.where(accept, T_new, T_cw)
        points = torch.where(accept, X_new, points)
        lam = _damping(lam, accept)
        cost = torch.where(accept, c_new, cost)
    T_cw = se3.normalize(T_cw)
    r, pc, _, _, row_ok = _obs_residuals(cam, T_cw, points, problem)
    chi2 = _obs_chi2(r, row_ok, problem.obs_inv_sigma2)
    if problem.obs_ur is None:
        gate = torch.full_like(chi2, 5.991)
    else:
        gate = torch.where(problem.obs_ur >= 0, 7.815, 5.991)
    inliers = problem.obs_valid & (chi2 <= gate) & (pc[:, 2] > 0.05)
    return BAResult(T_cw=T_cw, points=points, chi2=cost, inliers=inliers)
