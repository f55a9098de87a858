"""Pyramidal and anchored patch alignment on top of the LK kernel.

Port of trackingbench_slam_tpu/ops/align.py (`lk_pyramidal`,
`anchored_align`) in its TPU form, with the Pallas semantics at every
level: on the card each call is one launch of the LK kernel for all its
levels (ops/cuda/lk_kernel.py `lk_align`), on the CPU the same level loop
over the plain version. The reference's CPU branch (align_patches with
gradients sampled at +-0.5 px) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trackingbench_slam_tpu_torch.ops.cuda.lk_kernel import (lk_align,
                                                            patch_align)


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
    out = lk_align(tuple(prev_pyr[:levels]), tuple(cur_pyr[:levels]), pts,
                   pts, valid, scale=scale, offset=init_offset, half=half,
                   iters=iters, conv_eps=0.01, fb_iters=fb_iters)
    return AlignResult(*out)
