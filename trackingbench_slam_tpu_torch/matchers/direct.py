"""SVO-style direct matching: sparse image alignment and feature alignment.

Port of trackingbench_slam_tpu/matchers/direct.py, plain PyTorch (the
reference builds both from XLA ops, no Pallas):

  * `sparse_image_align`: coarse-to-fine photometric alignment of the
    reference frame's landmark-bearing 4x4 patches, Levenberg-Marquardt on
    T_cur_ref with inverse-compositional Jacobians; the 6x6 step comes from
    `cholesky_solve_or_nan`, which, as cho_factor does, gives NaN on a
    matrix that is not positive definite, and such a step is rejected.
  * `features_align`: each candidate landmark projected into the current
    frame, its 8x8 template warped from the reference keyframe by the
    inter-view affine, at the search level where the warp's determinant is
    nearest 1 (ties to the lower level), then refined by `align_patches`.

Both run eagerly: a static level loop, with every LM or KLT iteration a
handful of batched ops over all points.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.models.frame import FrameState
from trackingbench_slam_tpu_torch.ops.align import align_patches
from trackingbench_slam_tpu_torch.ops.image import bilinear_sample
from trackingbench_slam_tpu_torch.solvers.local_ba import \
    cholesky_solve_or_nan
from trackingbench_slam_tpu_torch.utils.config import DirectConfig


class SparseAlignResult(NamedTuple):
    T_cur_ref: torch.Tensor
    chi2: torch.Tensor
    num_used: torch.Tensor


def _patch_offsets(half: int, device) -> torch.Tensor:
    offs = torch.arange(2 * half, dtype=torch.float32,
                        device=device) - (half - 0.5)
    ox, oy = torch.meshgrid(offs, offs, indexing="xy")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)    # (P*P, 2)


def _align_level(cam: cam_mod.CameraParams, T0: torch.Tensor,
                 ref_img: torch.Tensor, cur_img: torch.Tensor,
                 p_ref: torch.Tensor, px_ref: torch.Tensor,
                 use: torch.Tensor, level: int, scale_factor: float,
                 iters: int = 10, patch_half: int = 2):
    """One pyramid level: reference patches and Jacobians once, then `iters`
    LM steps T <- T exp(-x), each kept only if it lowers the cost. Returns
    (normalized T, cost)."""
    s = scale_factor ** level
    offsets = _patch_offsets(patch_half, ref_img.device)         # (K, 2)
    coords_ref = (px_ref * s)[:, None, :] + offsets[None]
    ref_patch = bilinear_sample(ref_img, coords_ref)              # (N, K)
    ex = torch.tensor([0.5, 0.0], dtype=ref_img.dtype, device=ref_img.device)
    ey = torch.tensor([0.0, 0.5], dtype=ref_img.dtype, device=ref_img.device)
    gx = (bilinear_sample(ref_img, coords_ref + ex)
          - bilinear_sample(ref_img, coords_ref - ex))
    gy = (bilinear_sample(ref_img, coords_ref + ey)
          - bilinear_sample(ref_img, coords_ref - ey))
    Jpi = cam_mod.project_jacobian(cam, p_ref) * s                # (N, 2, 6)
    J = gx[..., None] * Jpi[:, None, 0, :] + gy[..., None] * Jpi[:, None, 1, :]
    w = use.to(ref_img.dtype)
    H = (J * w[:, None, None]).reshape(-1, 6).T @ J.reshape(-1, 6)
    h, wd = cur_img.shape
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)

    def residuals(T):
        p_cur = se3.transform_points(T, p_ref)
        uv = cam_mod.world2cam(cam, p_cur) * s
        cur_patch = bilinear_sample(cur_img, uv[:, None, :] + offsets[None])
        inb = ((uv[:, 0] >= patch_half + 1) & (uv[:, 0] < wd - patch_half - 1)
               & (uv[:, 1] >= patch_half + 1) & (uv[:, 1] < h - patch_half - 1)
               & (p_cur[:, 2] > 0.05))
        return cur_patch - ref_patch, w * inb.to(ref_img.dtype)

    def cost(T):
        r, m = residuals(T)
        return (r * r * m[:, None]).sum()

    T, lam, c = T0, torch.full((), 1e-4, dtype=T0.dtype, device=T0.device), \
        cost(T0)
    for _ in range(iters):
        r, m = residuals(T)
        b = (J * m[:, None, None]).reshape(-1, 6).T @ r.reshape(-1)
        x = cholesky_solve_or_nan(H + lam * eye6, b)
        T_new = se3.compose(T, se3.exp(-x))
        c_new = cost(T_new)
        accept = c_new < c
        T = torch.where(accept, T_new, T)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        c = torch.where(accept, c_new, c)
    return se3.normalize(T), c


def sparse_image_align(cam: cam_mod.CameraParams,
                       ref_pyramid: Sequence[torch.Tensor],
                       cur_pyramid: Sequence[torch.Tensor],
                       px_ref: torch.Tensor, depth_ref: torch.Tensor,
                       use: torch.Tensor, T_init: torch.Tensor,
                       cfg: DirectConfig = DirectConfig(),
                       scale_factor: float = 0.8) -> SparseAlignResult:
    """Coarse-to-fine alignment from level min(max_level, levels - 1) down
    to min_level. px_ref (N, 2) level-0 reference pixels, depth_ref (N,)
    their depths, use (N,) which take part. Returns T_cur_ref."""
    x = (px_ref[:, 0] - cam.cx) / cam.fx
    y = (px_ref[:, 1] - cam.cy) / cam.fy
    p_ref = torch.stack([x * depth_ref, y * depth_ref, depth_ref], -1)
    use = use & (depth_ref > 1e-3)
    T = T_init
    c = torch.zeros((), dtype=torch.float32, device=T.device)
    hi = min(cfg.max_level, len(ref_pyramid) - 1)
    for level in range(hi, cfg.min_level - 1, -1):
        T, c = _align_level(cam, T, ref_pyramid[level], cur_pyramid[level],
                            p_ref, px_ref, use, level, scale_factor,
                            iters=cfg.sparse_iters, patch_half=cfg.patch_half)
    return SparseAlignResult(T_cur_ref=T, chi2=c, num_used=use.sum())


class FeatureAlignResult(NamedTuple):
    px_cur: torch.Tensor     # (C, 2) refined level-0 positions in cur
    level: torch.Tensor      # (C,) search level used
    ok: torch.Tensor         # (C,) aligned successfully
    err: torch.Tensor        # (C,) residual


def features_align(cam: cam_mod.CameraParams, cur: FrameState,
                   ref_pyramid: Sequence[torch.Tensor],
                   T_ref_w: torch.Tensor, cand_pos_w: torch.Tensor,
                   cand_px_ref: torch.Tensor, cand_valid: torch.Tensor,
                   cfg: DirectConfig = DirectConfig(), num_levels: int = 5,
                   scale_factor: float = 0.8,
                   cand_level: torch.Tensor | None = None
                   ) -> FeatureAlignResult:
    """Align candidate landmarks (world positions cand_pos_w (C, 3), seen at
    level-0 pixels cand_px_ref in the reference keyframe, on its pyramid
    level cand_level, None meaning 0) into `cur` at its pose cur.T_cw."""
    half = cfg.align_patch_half
    dev = cand_pos_w.device
    T_cur_w = cur.T_cw
    T_cur_ref = se3.compose(T_cur_w, se3.inverse(T_ref_w))
    depth_ref = se3.transform_points(T_ref_w, cand_pos_w)[:, 2]
    p_cur = se3.transform_points(T_cur_w, cand_pos_w)
    px_cur0 = cam_mod.world2cam(cam, p_cur)
    vis = (cand_valid & (depth_ref > 0.05) & (p_cur[:, 2] > 0.05)
           & cam_mod.is_in_frame(cam, px_cur0, boundary=half + 2))

    # the affine warp A_cur_ref: reference-pixel offsets (d, 0) and (0, d)
    # at the candidate's depth, projected into cur and differenced
    d = float(half + 1)

    def project_ref_offset(dx, dy):
        xn = (cand_px_ref[:, 0] + dx - cam.cx) / cam.fx
        yn = (cand_px_ref[:, 1] + dy - cam.cy) / cam.fy
        p = torch.stack([xn * depth_ref, yn * depth_ref, depth_ref], -1)
        return cam_mod.world2cam(cam, se3.transform_points(T_cur_ref, p))

    base = project_ref_offset(0.0, 0.0)
    du = (project_ref_offset(d, 0.0) - base) / d
    dv = (project_ref_offset(0.0, d) - base) / d
    A = torch.stack([du, dv], -1)                  # (C, 2, 2)

    # search level: |det A| s^2 nearest 1, the lower level on a tie
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    detA = det.abs()
    s_all = torch.pow(torch.full((), scale_factor, dtype=torch.float32,
                                 device=dev),
                      torch.arange(num_levels, dtype=torch.float32,
                                   device=dev))
    score = torch.abs(detA[:, None] * (s_all ** 2)[None, :] - 1.0)
    search_level = torch.argmin(score, dim=-1)
    s = torch.pow(torch.full((), scale_factor, dtype=torch.float32,
                             device=dev), search_level.float())

    # the bordered template, warped with A^-1 from the reference feature's
    # own level; its gradients by central differences in cur-level pixels
    det_safe = torch.where(detA < 1e-8, torch.full_like(det, 1e-8), det)
    Ainv = torch.stack([torch.stack([A[:, 1, 1], -A[:, 0, 1]], -1),
                        torch.stack([-A[:, 1, 0], A[:, 0, 0]], -1)],
                       -2) / det_safe[:, None, None]
    Pb = 2 * half + 3
    offs_b = torch.arange(Pb, dtype=torch.float32, device=dev) - half - 1.0
    oxb, oyb = torch.meshgrid(offs_b, offs_b, indexing="xy")
    grid_b = torch.stack([oxb, oyb], -1).reshape(-1, 2)          # (Pb*Pb, 2)
    ref_offs0 = torch.einsum("cij,kj->cki", Ainv, grid_b) / s[:, None, None]
    C = cand_pos_w.shape[0]
    if cand_level is None:
        cand_level = torch.zeros((C,), dtype=torch.int32, device=dev)
    tpl_b = torch.zeros((C, Pb * Pb), dtype=torch.float32, device=dev)
    for rl in range(num_levels):
        coords = (cand_px_ref[:, None, :] + ref_offs0) * (scale_factor ** rl)
        t = bilinear_sample(ref_pyramid[rl], coords)
        tpl_b = torch.where((cand_level == rl)[:, None], t, tpl_b)
    tpl_b = tpl_b.reshape(C, Pb, Pb)
    tpl = tpl_b[:, 1:-1, 1:-1]
    tgx = 0.5 * (tpl_b[:, 1:-1, 2:] - tpl_b[:, 1:-1, :-2])
    tgy = 0.5 * (tpl_b[:, 2:, 1:-1] - tpl_b[:, :-2, 1:-1])
    tgrad = torch.stack([tgx, tgy], -1)

    # Align2D at each search level, merged by mask
    ok = torch.zeros_like(cand_valid)
    err = torch.full((C,), float("inf"), dtype=torch.float32, device=dev)
    out_px = px_cur0
    for lvl in range(num_levels):
        sel = vis & (search_level == lvl)
        s_l = scale_factor ** lvl
        res = align_patches(cur.pyramid[lvl], tpl, tgrad, px_cur0 * s_l, sel,
                            half=half, iters=cfg.align_iters,
                            conv_eps=cfg.conv_eps, with_illum=True)
        out_px = torch.where(sel[:, None], res.xy / s_l, out_px)
        ok = torch.where(sel, res.converged, ok)
        err = torch.where(sel, res.error, err)
    drift = torch.linalg.norm(out_px - px_cur0, dim=-1)
    return FeatureAlignResult(px_cur=out_px, level=search_level,
                              ok=ok & (drift < 10.0), err=err)
