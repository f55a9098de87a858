"""Pyramidal and anchored patch alignment on top of the LK kernel, and the
KLT on given templates that the direct tracker's feature alignment runs.

Port of trackingbench_slam_tpu/ops/align.py. `lk_pyramidal` and
`anchored_align` take its TPU form, with the Pallas semantics at every
level: on the card each call is one launch of the LK kernel for all its
levels (ops/cuda/lk_kernel.py `lk_align`), on the CPU the same level loop
over the plain version. `align_patches` and `template_patches_and_grads`
are the reference's XLA functions in plain PyTorch: the templates they
align are warped by the caller, which the LK kernel (it cuts its own
templates) cannot take.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trackingbench_slam_tpu_torch.ops.cuda.lk_kernel import (lk_align,
                                                            patch_align)
from trackingbench_slam_tpu_torch.ops.image import bilinear_sample


class AlignResult(NamedTuple):
    xy: torch.Tensor           # (N, 2) refined positions
    converged: torch.Tensor    # (N,) bool
    error: torch.Tensor        # (N,) mean abs residual at the solution
    fb_conv: Optional[torch.Tensor] = None  # (N,) back-track converged
    fb_d2: Optional[torch.Tensor] = None    # (N,) back-track distance^2


def _patch_grid(half: int, device) -> torch.Tensor:
    offs = torch.arange(2 * half + 1, dtype=torch.float32,
                        device=device) - half
    ox, oy = torch.meshgrid(offs, offs, indexing="xy")
    return torch.stack([ox, oy], dim=-1)          # (P, P, 2)


def template_patches_and_grads(img: torch.Tensor, xy: torch.Tensor,
                               half: int):
    """Template patches at float centres and their gradients, sampled with
    central differences at +-0.5 px. Returns (patches (N, P, P), grads
    (N, P, P, 2))."""
    coords = xy[:, None, None, :] + _patch_grid(half, img.device)[None]
    patches = bilinear_sample(img, coords)
    ex = torch.tensor([0.5, 0.0], dtype=img.dtype, device=img.device)
    ey = torch.tensor([0.0, 0.5], dtype=img.dtype, device=img.device)
    gx = bilinear_sample(img, coords + ex) - bilinear_sample(img, coords - ex)
    gy = bilinear_sample(img, coords + ey) - bilinear_sample(img, coords - ey)
    return patches, torch.stack([gx, gy], dim=-1)


def align_patches(cur_img: torch.Tensor, templates: torch.Tensor,
                  template_grads: torch.Tensor, init_xy: torch.Tensor,
                  valid: torch.Tensor, half: int = 4, iters: int = 20,
                  conv_eps: float = 0.03,
                  with_illum: bool = True) -> AlignResult:
    """Inverse-compositional KLT of N given templates in `cur_img` from
    `init_xy`, all points iterating together, each frozen once its step is
    below `conv_eps`; with `with_illum` the (du, dv, mean) system of Align2D,
    else plain 2-parameter LK. Converged points must end `half` px inside
    the image."""
    n = templates.shape[0]
    grid = _patch_grid(half, cur_img.device)
    gx, gy = template_grads[..., 0], template_grads[..., 1]
    cols = (gx, gy, torch.ones_like(gx)) if with_illum else (gx, gy)
    dim = len(cols)
    H = torch.stack([torch.stack([(a * b).sum((1, 2)) for b in cols], -1)
                     for a in cols], -2)
    H = H + 1e-7 * torch.eye(dim, dtype=H.dtype, device=H.device)[None]
    Hinv = torch.linalg.inv(H)
    xy = init_xy
    mean_diff = torch.zeros((n,), dtype=cur_img.dtype, device=cur_img.device)
    active = valid
    err = torch.full((n,), float("inf"), dtype=cur_img.dtype,
                     device=cur_img.device)
    for _ in range(iters):
        cur = bilinear_sample(cur_img, xy[:, None, None, :] + grid[None])
        res = cur - templates + mean_diff[:, None, None]
        b = torch.stack([(res * c).sum((1, 2)) for c in cols], -1)
        delta = -(Hinv @ b[..., None])[..., 0]
        step = delta[:, :2]
        norm2 = (step * step).sum(-1)
        xy = xy + torch.where(active[:, None], step, torch.zeros_like(step))
        if with_illum:
            mean_diff = mean_diff + torch.where(active, delta[:, 2],
                                                torch.zeros_like(mean_diff))
        err = torch.where(active, res.abs().mean((1, 2)), err)
        active = active & ~(norm2 < conv_eps * conv_eps)
    h, w = cur_img.shape
    inb = ((xy[:, 0] >= half) & (xy[:, 0] < w - half)
           & (xy[:, 1] >= half) & (xy[:, 1] < h - half))
    return AlignResult(xy=xy, converged=valid & ~active & inb, error=err)


def anchored_align(atlas: torch.Tensor, img: torch.Tensor,
                   centers: torch.Tensor, init_xy: torch.Tensor,
                   valid: torch.Tensor, half: int = 4, iters: int = 10,
                   conv_eps: float = 0.03) -> AlignResult:
    """Align features in `img` against their anchor patches in the map's
    atlas (templates at `centers`)."""
    xy, conv, err = patch_align(atlas, img, centers, init_xy, valid,
                                half=half, iters=iters, conv_eps=conv_eps)
    return AlignResult(xy=xy, converged=conv, error=err)


def lk_pyramidal(prev_pyr, cur_pyr, pts: torch.Tensor, valid: torch.Tensor,
                 scale: float, half: int = 10, iters: int = 30,
                 num_levels: int = 3,
                 init_offset: torch.Tensor | None = None,
                 fb_iters: int = 0) -> AlignResult:
    """Coarse-to-fine LK of level-0 points `pts` from prev into cur over
    `num_levels` levels, from `pts + init_offset`; the forward-backward
    check (fb_iters > 0) runs at level 0 only."""
    levels = min(num_levels, len(prev_pyr))
    out = lk_align(tuple(prev_pyr[:levels]), tuple(cur_pyr[:levels]), pts,
                   pts, valid, scale=scale, offset=init_offset, half=half,
                   iters=iters, conv_eps=0.01, fb_iters=fb_iters)
    return AlignResult(*out)
