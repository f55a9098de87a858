"""FAST segment-test corners, 3x3 NMS, the Shi-Tomasi score and grid top-k
selection.

Port of trackingbench_slam_tpu/ops/fast.py. `fast_score_map` and `nms3x3`
are the plain PyTorch semantics of the fused CUDA kernel (csrc/fast.cu,
wrapped by ops/cuda/fast_kernel.py); the score is summed in tap order, as
the Pallas kernel sums it, so the two agree exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Radius-3 Bresenham circle from 12 o'clock clockwise, (dy, dx).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_score_map(img: torch.Tensor, threshold: float = 20.0,
                   arc: int = 9) -> torch.Tensor:
    """FAST-`arc` response per pixel, (H, W) float32; 0 for non-corners and
    within 3 px of the border."""
    img = img.float()
    h, w = img.shape
    p = F.pad(img, (3, 3, 3, 3))
    zero = torch.zeros_like(img)
    run_b, run_d, best_b, best_d = zero, zero, zero, zero
    sb, sd = zero, zero
    for k in range(16 + arc - 1):
        dy, dx = CIRCLE_OFFSETS[k % 16]
        diff = p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img
        run_b = torch.where(diff > threshold, run_b + 1.0, zero)
        run_d = torch.where(diff < -threshold, run_d + 1.0, zero)
        best_b = torch.maximum(best_b, run_b)
        best_d = torch.maximum(best_d, run_d)
        if k < 16:
            sb = sb + torch.clamp(diff - threshold, min=0.0)
            sd = sd + torch.clamp(-diff - threshold, min=0.0)
    is_corner = (best_b >= arc) | (best_d >= arc)
    score = torch.where(is_corner, torch.maximum(sb, sd), zero)
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return torch.where(interior, score, zero)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 NMS, ties broken toward raster order: suppressed by a strictly
    greater neighbour or an equal one that precedes it."""
    h, w = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    suppressed = torch.zeros_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            if dy < 0 or (dy == 0 and dx < 0):
                suppressed |= neigh >= score
            else:
                suppressed |= neigh > score
    return torch.where((score > 0.0) & ~suppressed, score,
                       torch.zeros_like(score))


def shi_tomasi_map(img: torch.Tensor, half: int = 4) -> torch.Tensor:
    """Shi-Tomasi score (min eigenvalue of the gradient covariance / (2
    area)) for every pixel over a (2 half) x (2 half) window of wrapped
    central differences, the window placed as XLA's "SAME" padding places an
    even window (half - 1 before the pixel, half after)."""
    img = img.float()
    dx = 0.5 * (torch.roll(img, -1, 1) - torch.roll(img, 1, 1))
    dy = 0.5 * (torch.roll(img, -1, 0) - torch.roll(img, 1, 0))
    win = 2 * half
    prods = torch.stack([dx * dx, dy * dy, dx * dy])[None]
    prods = F.pad(prods, (half - 1, half, half - 1, half))
    ones = torch.ones((3, 1, win, win), dtype=img.dtype, device=img.device)
    dxx, dyy, dxy = F.conv2d(prods, ones, groups=3)[0]
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    return 0.5 * (tr - disc) / float(win * win)


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties broken toward the lower index,
    as jax.lax.top_k does (torch.topk makes no promise about ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def grid_topk(score: torch.Tensor, cell: int, per_cell: int, budget: int,
              min_score: float = 1e-6, strong: torch.Tensor | None = None):
    """Top `per_cell` per grid cell, then the global top `budget` over the
    cell winners. Returns (xy (budget, 2), resp (budget,), valid
    (budget,)); invalid rows have xy = -1."""
    h, w = score.shape
    ph = (cell - h % cell) % cell
    pw = (cell - w % cell) % cell
    s = F.pad(score, (0, pw, 0, ph))
    H, W = h + ph, w + pw
    ncy, ncx = H // cell, W // cell

    def to_cells(x):
        return x.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(
            ncy * ncx, cell * cell)

    cells = to_cells(s)
    if strong is not None:
        st = to_cells(F.pad(strong, (0, pw, 0, ph)))
        cell_has_strong = torch.any(st & (cells > min_score), dim=1,
                                    keepdim=True)
        cells = torch.where(st | ~cell_has_strong, cells,
                            torch.zeros_like(cells))
    vals, idx = stable_topk(cells, per_cell)
    cid = torch.arange(ncy * ncx, device=score.device)
    py = idx // cell + ((cid // ncx) * cell)[:, None]
    px = idx % cell + ((cid % ncx) * cell)[:, None]
    flat_vals = vals.reshape(-1)
    k = min(budget, flat_vals.shape[0])
    top_vals, top_idx = stable_topk(flat_vals, k)
    x = px.reshape(-1)[top_idx].float()
    y = py.reshape(-1)[top_idx].float()
    valid = top_vals > min_score
    if k < budget:
        pad = budget - k
        top_vals = F.pad(top_vals, (0, pad))
        x = F.pad(x, (0, pad))
        y = F.pad(y, (0, pad))
        valid = F.pad(valid, (0, pad))
    xy = torch.stack([x, y], dim=-1)
    xy = torch.where(valid[:, None], xy, torch.full_like(xy, -1.0))
    return xy, top_vals, valid
