"""Pyramidal and anchored patch alignment on top of the LK kernel.

Port of trackingbench_slam_tpu/ops/align.py (`lk_pyramidal`,
`anchored_align`) in its TPU form: every level goes through the LK kernel
(ops/cuda/lk_kernel.py) with the Pallas semantics. The reference's CPU
branch (align_patches with gradients sampled at +-0.5 px) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trackingbench_slam_tpu_torch.ops.cuda.lk_kernel import patch_align


class AlignResult(NamedTuple):
    xy: torch.Tensor           # (N, 2) refined positions
    converged: torch.Tensor    # (N,) bool
    error: torch.Tensor        # (N,) mean abs residual at the solution
    fb_conv: Optional[torch.Tensor] = None  # (N,) back-track converged
    fb_d2: Optional[torch.Tensor] = None    # (N,) back-track distance^2


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
    start = pts if init_offset is None else pts + init_offset
    xy = start * (scale ** (levels - 1))
    conv = valid
    err = torch.full((pts.shape[0],), float("inf"), dtype=pts.dtype,
                     device=pts.device)
    fb_conv = fb_d2 = None
    for lvl in range(levels - 1, -1, -1):
        s = scale ** lvl
        tpl_xy = pts * s
        fb_here = fb_iters if lvl == 0 else 0
        out = patch_align(prev_pyr[lvl], cur_pyr[lvl], tpl_xy, xy, valid,
                          half=half, iters=iters, conv_eps=0.01,
                          fb_iters=fb_here)
        if fb_here > 0:
            xy, conv, err, fb_conv, fb_d2 = out
        else:
            xy, conv, err = out
        if lvl > 0:
            xy = xy / scale
    return AlignResult(xy=xy, converged=conv, error=err, fb_conv=fb_conv,
                       fb_d2=fb_d2)
