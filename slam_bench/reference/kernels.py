"""Plain PyTorch versions of the port's four hand kernels, batched.

Frozen copies of the plain versions that the port keeps beside its CUDA
kernels, with a leading batch axis B (one sequence per row) in place of
the port's per-sequence loop, and a `dtype` in which every float is
computed (float32 for the reference; a lower one for the control):

  * LK: trackingbench_slam_tpu_torch/ops/cuda/lk_kernel.py:19-38, 264-413
    (`padded_shape`, `lk_align_plain`, `_finish`, `_bases`, `_sample`,
    `_template`, `_run`, `patch_align_plain`); `lk_align` also returns the
    work it did (points run, templates built, iterations), which
    chip_smoke.py:336-368 `lk_work` read off the plain version;
  * FAST + NMS: ops/fast.py:22-74 (`fast_score_map`, `nms3x3`);
  * ORB describe: ops/cuda/patch_kernel.py:49-75, 151-161
    (`padded_shape`, `patch_origins`, `extract_patches32_plain`,
    `orb_describe_plain`) and ops/orb.py:38-127 (moments, `brief_positions`,
    `angle_bins`, `brief_from_patches`, `pack_bits`);
  * anchor cells: ops/cuda/patch_kernel.py:292-325
    (`bilinear_cell_patches`, `anchor_cells_plain`);
  * the kernels' image operands: ops/image.py:32-135 (`pyramid_shapes`,
    `_resize_weights_np`, `_resize_taps_np`, `_blend_axis`,
    `resize_bilinear`, `build_pyramid`, `gaussian_kernel1d`,
    `gaussian_blur`) and models/frame.py:40 (`LK_LEVELS`), so that the
    check rebuilds every pyramid level and blurred level from the host
    frames itself.

Imports nothing of the port.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from slam_bench.reference.orb_pattern import LEARNED_PAIRS

# the reference is float32 throughout: no TF32 in a matrix product or a
# convolution on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# --- LK ---------------------------------------------------------------------

MARGIN = 12
WIN_LANES = 256


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def lk_win_rows(half: int) -> int:
    return _round_up(2 * half + 1 + 2 * MARGIN + 4 + 16, 8)


def lk_slice_rows(half: int) -> int:
    return _round_up(2 * half + 1 + 3, 8) + 8


def lk_padded_shape(h: int, w: int, half: int) -> tuple[int, int]:
    return (_round_up(max(h, lk_win_rows(half)), 8),
            _round_up(max(w, WIN_LANES + 128), 128))


def _bases(xy, half, hp, wp, win):
    bx = torch.round(xy[:, 0]).clamp(-2 ** 30, 2 ** 30).long() - half - MARGIN
    by = torch.round(xy[:, 1]).clamp(-2 ** 30, 2 ** 30).long() - half - MARGIN
    bx = torch.div(bx, 128, rounding_mode="floor") * 128
    by = torch.div(by, 8, rounding_mode="floor") * 8
    return by.clamp(0, hp - win), bx.clamp(0, wp - WIN_LANES)


class _Images:
    """A batch of zero-padded images flattened, and each point's image."""

    def __init__(self, imgs, hp, wp, n_per, dtype):
        B, h, w = imgs.shape
        self.flat = F.pad(imgs.to(dtype), (0, wp - w, 0, hp - h)).reshape(-1)
        self.hp, self.wp = hp, wp
        self.base = (torch.arange(B, device=imgs.device)
                     .repeat_interleave(n_per) * (hp * wp))


def _sample(im: _Images, by, bx, u, v, half, n, win, slc):
    """(Np, n, n) bilinear grid at window-local origin (u - half, v - half)
    with the kernel's slice clamps, each point on its own image."""
    hp, wp = im.hp, im.wp
    P = 2 * half + 1
    vtop = v - float(half)
    utop = u - float(half)
    fiy = torch.floor(vtop)
    fix = torch.floor(utop)
    fy = (vtop - fiy)[:, None, None]
    fx = (utop - fix)[:, None, None]
    iy = fiy.clamp(-2 ** 30, 2 ** 30).long().clamp(0, win - slc)
    ix = fix.clamp(-2 ** 30, 2 ** 30).long().clamp(0, WIN_LANES - P - 2)
    ar = torch.arange(n + 1, device=u.device)
    rows = (by + iy)[:, None] + ar[None]
    cols = (bx + ix)[:, None] + ar[None]
    idx = (im.base[:, None, None]
           + rows.clamp(max=hp - 1)[:, :, None] * wp
           + cols.clamp(max=wp - 1)[:, None, :])
    X = im.flat[idx]
    t00, t01 = X[:, :n, :n], X[:, :n, 1:]
    t10, t11 = X[:, 1:, :n], X[:, 1:, 1:]
    top = t00 + fx * (t01 - t00)
    bot = t10 + fx * (t11 - t10)
    return top + fy * (bot - top)


def _psum(x):
    return x.sum(-1).sum(-1)


def _template(im, by, bx, x, y, half, win, slc):
    P = 2 * half + 1
    S = _sample(im, by, bx, x - 1.0, y - 1.0, half, P + 2, win, slc)
    tpl = S[:, 1:P + 1, 1:P + 1]
    gx = 0.5 * (S[:, 1:P + 1, 2:] - S[:, 1:P + 1, :P])
    gy = 0.5 * (S[:, 2:, 1:P + 1] - S[:, :P, 1:P + 1])
    h00 = _psum(gx * gx) + 1e-6
    h01 = _psum(gx * gy)
    h02 = _psum(gx)
    h11 = _psum(gy * gy) + 1e-6
    h12 = _psum(gy)
    h22 = torch.full_like(h00, float(P * P)) + 1e-6
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    det = h00 * c00 + h01 * c01 + h02 * c02
    det = torch.where(torch.abs(det) < 1e-10, torch.full_like(det, 1e-10),
                      det)
    inv_det = 1.0 / det
    return tpl, gx, gy, (c00, c01, c02, c11, c12, c22, inv_det, h02, h12, h22)


def _run(im, by, bx, tpl, gx, gy, cof, u, v, run, n_iters, eps2, half, win,
         slc):
    """Iterate the points in `run` from window-local (u, v). Returns (u, v,
    md, still active, failed, iterations each point ran)."""
    (a00, a01, a02, a11, a12, a22, inv_det, h02, h12, h22) = cof
    lo = float(half + 1)
    hi_y = float(win - slc + half - 1)
    hi_x = float(WIN_LANES - half - 4)
    P = 2 * half + 1
    md = torch.zeros_like(u)
    active = run.to(u.dtype)
    failed = torch.zeros_like(u)
    n_it = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    for _ in range(n_iters):
        n_it = n_it + (active > 0).int()
        cur = _sample(im, by, bx, u, v, half, P, win, slc)
        r = cur - tpl
        b0 = _psum(r * gx) + md * h02
        b1 = _psum(r * gy) + md * h12
        b2 = _psum(r) + md * h22
        du = -(a00 * b0 + a01 * b1 + a02 * b2) * inv_det
        dv = -(a01 * b0 + a11 * b1 + a12 * b2) * inv_det
        dm = -(a02 * b0 + a12 * b1 + a22 * b2) * inv_det
        u_raw = u + du
        v_raw = v + dv
        out = ((u_raw < lo) | (u_raw > hi_x) | (v_raw < lo)
               | (v_raw > hi_y)).to(u.dtype)
        failed = torch.maximum(failed, active * out)
        u_new = u_raw.clamp(lo, hi_x)
        v_new = v_raw.clamp(lo, hi_y)
        small = ((du * du + dv * dv) < eps2).to(u.dtype)
        u = torch.where(active > 0, u + (u_new - u), u)
        v = torch.where(active > 0, v + (v_new - v), v)
        md = torch.where(active > 0, md + dm, md)
        active = active * (1.0 - small) * (1.0 - failed)
    return u, v, md, active > 0.5, failed > 0.5, n_it


def _patch_align(prev, cur, pts, init_xy, valid, half, iters, conv_eps,
                 fb_iters, dtype, work):
    """One level for a batch: prev / cur (B, H, W), pts / init_xy (B, N, 2),
    valid (B, N). Appends the level's work to `work`."""
    B, h, w = prev.shape
    N = pts.shape[1]
    P = 2 * half + 1
    win, slc = lk_win_rows(half), lk_slice_rows(half)
    hp, wp = lk_padded_shape(h, w, half)
    prev_p = _Images(prev, hp, wp, N, dtype)
    cur_p = _Images(cur, hp, wp, N, dtype)
    pts = pts.reshape(-1, 2).to(dtype)
    init_xy = init_xy.reshape(-1, 2).to(dtype)
    valid = valid.reshape(-1)
    by_t, bx_t = _bases(pts, half, hp, wp, win)
    by_c, bx_c = _bases(init_xy, half, hp, wp, win)
    tx = pts[:, 0] - bx_t.to(dtype)
    ty = pts[:, 1] - by_t.to(dtype)
    ux0 = init_xy[:, 0] - bx_c.to(dtype)
    uy0 = init_xy[:, 1] - by_c.to(dtype)
    lo = float(half + 1)
    hi_y = float(win - slc + half - 1)
    hi_x = float(WIN_LANES - half - 4)
    in_bounds = ((ty >= lo) & (ty <= hi_y) & (tx >= lo) & (tx <= hi_x)
                 & (uy0 >= lo) & (uy0 <= hi_y) & (ux0 >= lo) & (ux0 <= hi_x))
    run = valid & in_bounds
    eps2 = float(conv_eps * conv_eps)
    tpl, gx, gy, cof = _template(prev_p, by_t, bx_t, tx, ty, half, win, slc)
    u, v, md, active, failed, n_it = _run(cur_p, by_c, bx_c, tpl, gx, gy,
                                          cof, ux0, uy0, run, iters, eps2,
                                          half, win, slc)
    loops = [(run, n_it)]
    converged = run & ~active & ~failed
    cur_f = _sample(cur_p, by_c, bx_c, u, v, half, P, win, slc)
    err = _psum(torch.abs(cur_f - tpl + md[:, None, None])) / float(P * P)
    err = torch.where(run, err, torch.full_like(err, 1e9))
    xy = torch.stack([u + bx_c.to(dtype), v + by_c.to(dtype)], dim=-1)
    fb = None
    if fb_iters > 0:
        tplB, gxB, gyB, cofB = _template(cur_p, by_c, bx_c, u, v, half, win,
                                         slc)
        ub, vb, _, activeb, failedb, n_b = _run(
            prev_p, by_t, bx_t, tplB, gxB, gyB, cofB, tx, ty, converged,
            fb_iters, eps2, half, win, slc)
        loops.append((converged, n_b))
        fb_conv = converged & ~activeb & ~failedb
        fb_d2 = (ub - tx) * (ub - tx) + (vb - ty) * (vb - ty)
        fb = (fb_conv, torch.where(fb_conv, fb_d2,
                                   torch.full_like(fb_d2, 1e9)))
    inb = ((xy[:, 0] >= half) & (xy[:, 0] < w - half)
           & (xy[:, 1] >= half) & (xy[:, 1] < h - half))
    conv = converged & inb & valid
    out = (xy, conv, err) if fb is None else (xy, conv, err, fb[0] & conv,
                                              fb[1])
    work.append(dict(prev=(h, w), cur=tuple(cur.shape[1:]),
                     tpl_xy=pts, xy=xy, loops=loops, batch=B))
    return tuple(o.reshape((B, N) + o.shape[1:]) for o in out)


def lk_align(prev_pyr, cur_pyr, pts, start, valid, scale=0.5, offset=None,
             half=10, iters=30, conv_eps=0.01, fb_iters=0,
             dtype=torch.float32):
    """Coarse-to-fine LK for a batch (levels (B, H, W), level 0 first; pts,
    start, offset (B, N, 2); valid (B, N)). Returns (outputs, work):
    outputs (xy, converged, err[, fb_conv, fb_d2]) with a leading B axis,
    work one entry per level, coarsest first (`lk_terms` reads it)."""
    levels = len(prev_pyr)
    s0 = start if offset is None else start + offset
    xy = s0.to(dtype) * (scale ** (levels - 1))
    work = []
    for lvl in range(levels - 1, -1, -1):
        out = _patch_align(prev_pyr[lvl], cur_pyr[lvl],
                           pts.to(dtype) * (scale ** lvl), xy, valid, half,
                           iters, conv_eps, fb_iters if lvl == 0 else 0,
                           dtype, work)
        xy = out[0] if lvl == 0 else out[0] / scale
    return (xy,) + tuple(out[1:]), work


# --- FAST + NMS -------------------------------------------------------------

CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_score_map(img, threshold=20.0, arc=9, dtype=torch.float32):
    """FAST-`arc` response per pixel of (B, H, W) images; 0 for non-corners
    and within 3 px of the border."""
    img = img.to(dtype)
    h, w = img.shape[-2:]
    p = F.pad(img, (3, 3, 3, 3))
    zero = torch.zeros_like(img)
    run_b, run_d, best_b, best_d = zero, zero, zero, zero
    sb, sd = zero, zero
    for k in range(16 + arc - 1):
        dy, dx = CIRCLE_OFFSETS[k % 16]
        diff = p[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img
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


def nms3x3(score):
    """3x3 NMS, ties broken toward raster order."""
    h, w = score.shape[-2:]
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    suppressed = torch.zeros_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            if dy < 0 or (dy == 0 and dx < 0):
                suppressed |= neigh >= score
            else:
                suppressed |= neigh > score
    return torch.where((score > 0.0) & ~suppressed, score,
                       torch.zeros_like(score))


def fast_score_nms(img, threshold=20.0, arc=9, dtype=torch.float32):
    return nms3x3(fast_score_map(img, threshold, arc, dtype))


# --- 32 x 32 patches, ORB describe, anchor cells -----------------------------

PATCH = 32
PATCH_HALF = 15
WIN_ROWS = 56
ANGLE_BINS = 32
CELL = 16


def patch_padded_shape(h: int, w: int) -> tuple[int, int]:
    return (_round_up(max(h, WIN_ROWS), 8),
            _round_up(max(w, WIN_LANES + 128), 128))


def extract_patches32(img, centers):
    """(B, N, 32, 32) patches of (B, H, W) images, top-left at
    round(center) - 15 clamped into the zero-padded image."""
    B, h, w = img.shape
    hp, wp = patch_padded_shape(h, w)
    c = torch.round(centers).clamp(-2 ** 30, 2 ** 30).long() - (PATCH // 2 - 1)
    r0 = c[..., 1].clamp(0, hp - PATCH)
    c0 = c[..., 0].clamp(0, wp - PATCH)
    ar = torch.arange(PATCH, device=img.device)
    rows = r0[..., None] + ar
    cols = c0[..., None] + ar
    inside = (rows < h)[..., :, None] & (cols < w)[..., None, :]
    base = (torch.arange(B, device=img.device) * (h * w))[:, None, None, None]
    idx = (base + rows.clamp(max=h - 1)[..., :, None] * w
           + cols.clamp(max=w - 1)[..., None, :])
    vals = img.reshape(-1)[idx]
    return torch.where(inside, vals, torch.zeros_like(vals))


def _circle_umax_mask() -> np.ndarray:
    ys, xs = np.mgrid[-PATCH_HALF:PATCH_HALF + 1, -PATCH_HALF:PATCH_HALF + 1]
    return (xs * xs + ys * ys <= PATCH_HALF * PATCH_HALF).astype(np.float32)


def _moment_masks(device, dtype):
    m = np.zeros((PATCH, PATCH), np.float32)
    m[:31, :31] = _circle_umax_mask()
    ys, xs = np.mgrid[0:PATCH, 0:PATCH].astype(np.float32)
    return (torch.from_numpy((xs - 15.0) * m).to(device, dtype),
            torch.from_numpy((ys - 15.0) * m).to(device, dtype))


def ic_angle(patches):
    xm, ym = _moment_masks(patches.device, patches.dtype)
    # one sequence at a time: the sums then round as the port's plain
    # version rounds them
    return torch.stack([torch.atan2((p * ym).sum((1, 2)), (p * xm).sum((1, 2)))
                        for p in patches])


@functools.lru_cache(maxsize=4)
def brief_positions(device) -> torch.Tensor:
    """(32, 512) flat patch index of sample (2k + which) of pair k at each
    angle bin."""
    pat = np.asarray(LEARNED_PAIRS, np.int32).astype(np.float64)
    pos = np.zeros((ANGLE_BINS, 512), np.int64)
    for b in range(ANGLE_BINS):
        ang = 2 * np.pi * b / ANGLE_BINS
        ca, sa = np.cos(ang), np.sin(ang)
        for k in range(256):
            for which in range(2):
                x, y = pat[k, which]
                rx = min(max(int(round(x * ca - y * sa)) + 15, 0), PATCH - 1)
                ry = min(max(int(round(x * sa + y * ca)) + 15, 0), PATCH - 1)
                pos[b, 2 * k + which] = ry * PATCH + rx
    return torch.from_numpy(pos).to(device)


def angle_bins(angles):
    """round(mod(a, 2 pi) / 2 pi * 32) % 32, half to even."""
    two_pi = torch.full((), 2.0 * np.pi, dtype=angles.dtype,
                        device=angles.device)
    r = torch.fmod(angles, two_pi)
    r = torch.where((r != 0) & (r < 0), r + two_pi, r)
    return torch.round(r / two_pi * ANGLE_BINS).long() % ANGLE_BINS


def pack_bits(bits):
    """(..., 256) bool -> (..., 8) int32 (bit j of word i = bit 32 i + j)."""
    words = bits.to(torch.int64).reshape(bits.shape[:-1] + (8, 32))
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    packed = (words << shifts).sum(-1)
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    return packed.to(torch.int32)


def orb_describe(raw, blurred, xy, valid, counts, dtype=torch.float32):
    """IC angle and rBRIEF of every level's keypoints for a batch: levels
    (B, H, W), xy (B, N, 2) with counts[l] rows for level l. Returns
    (angle (B, N), desc (B, N, 8) int32), zero on invalid rows."""
    angles, descs = [], []
    for img, blur, p, v in zip(raw, blurred, xy.split(counts, 1),
                               valid.split(counts, 1)):
        ang = ic_angle(extract_patches32(img.to(dtype), p.to(dtype)))
        ang = torch.where(v, ang, torch.zeros_like(ang))
        angles.append(ang)
        patches = extract_patches32(blur.to(dtype), p.to(dtype))
        B, n = v.shape
        idx = brief_positions(patches.device)[angle_bins(ang)]
        samples = torch.gather(patches.reshape(B, n, PATCH * PATCH), 2, idx)
        bits = (samples[..., 0::2] < samples[..., 1::2]) & v[..., None]
        descs.append(pack_bits(bits))
    return torch.cat(angles, 1), torch.cat(descs, 1)


def anchor_cells(img, kp_xy, dtype=torch.float32):
    """(B, N, 16, 16) bilinear cells centred on kp_xy: the crop's integer
    block at floor(kp) - 8, one (fx, fy) per point."""
    c = CELL
    kp_xy = kp_xy.to(dtype)
    x0 = torch.floor(kp_xy[..., 0])
    y0 = torch.floor(kp_xy[..., 1])
    off = float(15 - c // 2)
    pat = extract_patches32(img.to(dtype), torch.stack([x0 + off, y0 + off],
                                                       -1))
    fx = (kp_xy[..., 0] - x0)[..., None, None]
    fy = (kp_xy[..., 1] - y0)[..., None, None]
    block = pat[..., :c + 1, :c + 1]
    t00, t01 = block[..., :c, :c], block[..., :c, 1:]
    t10, t11 = block[..., 1:, :c], block[..., 1:, 1:]
    return ((1 - fy) * ((1 - fx) * t00 + fx * t01)
            + fy * ((1 - fx) * t10 + fx * t11))


def atlas_cells(atlas):
    """(B, A, A) atlases viewed as (B, g*g, 16, 16) cells, row-major."""
    B, A = atlas.shape[0], atlas.shape[-1]
    g = A // CELL
    return (atlas.reshape(B, g, CELL, g, CELL).permute(0, 1, 3, 2, 4)
            .reshape(B, g * g, CELL, CELL))


def cells_atlas(cells):
    """`atlas_cells` undone: (B, g*g, 16, 16) -> (B, A, A)."""
    B, n = cells.shape[:2]
    g = int(round(n ** 0.5))
    return (cells.reshape(B, g, g, CELL, CELL).permute(0, 1, 3, 2, 4)
            .reshape(B, g * CELL, g * CELL))


def last_writer(slots, ok, cells: int):
    """(B, cells) row of the last wanted point naming each atlas cell, -1
    where none does."""
    B, n = slots.shape
    tgt = torch.where(ok, slots.long(), torch.full_like(slots, cells).long())
    pos = torch.arange(n, device=slots.device).expand(B, n)
    winner = torch.full((B, cells + 1), -1, dtype=torch.long,
                        device=slots.device)
    return winner.scatter_reduce(1, tgt, pos, "amax")[:, :cells]


# --- the kernels' image operands ---------------------------------------------

LK_LEVELS = 4   # models/frame.py: the LK pyramid's depth, x0.5 a level


def pyramid_shapes(h: int, w: int, num_levels: int, scale: float):
    """Per-level shapes (Frame::ComputePyramid rounding)."""
    out = []
    for lvl in range(num_levels):
        s = scale ** lvl
        out.append((max(int(round(h * s)), 8), max(int(round(w * s)), 8)))
    return out


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 bilinear weights, computed in float32."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.0) * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(in_size, dtype=np.float32)[:, None])
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=np.float32)
    eps = np.float32(1000.0 * float(np.finfo(np.float32).eps))
    weights = np.where(np.abs(total) > eps,
                       weights / np.where(total != 0, total, np.float32(1)),
                       np.float32(0.0))
    inside = ((sample_f >= -0.5) & (sample_f <= in_size - 0.5))[None, :]
    return np.where(inside, weights, np.float32(0.0)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_taps(in_size: int, out_size: int):
    """(i0, i1, w0, w1): each output's first and last nonzero tap and their
    weights; one tap gives i1 = i0, w1 = 0."""
    w = _resize_weights(in_size, out_size)
    nz = w != 0
    cols = np.arange(out_size)
    i0 = np.argmax(nz, axis=0)
    i1 = in_size - 1 - np.argmax(nz[::-1], axis=0)
    i1 = np.where(nz.any(0), i1, i0)
    w0 = w[i0, cols]
    w1 = np.where(i1 != i0, w[i1, cols], np.float32(0.0))
    return i0, i1, w0.astype(np.float32), w1.astype(np.float32)


def _blend_axis(x, dim: int, in_size: int, out_size: int):
    i0, i1, w0, w1 = (torch.from_numpy(np.asarray(a)).to(x.device)
                      for a in _resize_taps(in_size, out_size))
    if dim == -2:
        w0, w1 = w0[:, None], w1[:, None]
    return (torch.index_select(x, dim, i0) * w0
            + torch.index_select(x, dim, i1) * w1)


def resize_bilinear(img, out_hw):
    """(B, H, W) -> (B, oh, ow): the width first, then the height."""
    h, w = img.shape[-2:]
    oh, ow = out_hw
    x = img
    if ow != w:
        x = _blend_axis(x, -1, w, ow)
    if oh != h:
        x = _blend_axis(x, -2, h, oh)
    return x


def build_pyramid(img, num_levels: int, scale: float):
    """(B, H, W) float32 -> its levels, each resized from the one before."""
    shapes = pyramid_shapes(img.shape[-2], img.shape[-1], num_levels, scale)
    levels = [img]
    for lvl in range(1, num_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lvl]))
    return levels


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """(B, H, W) separable Gaussian blur, reflect-101 borders, the vertical
    pass first; the whole batch in one convolution, as the port's batched
    step runs it."""
    x = torch.arange(ksize, dtype=torch.float32, device=img.device) - (
        ksize - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / torch.sum(k)
    pad = ksize // 2
    y = F.pad(img[:, None], (0, 0, pad, pad), mode="reflect")
    y = F.conv2d(y, k.view(1, 1, ksize, 1))
    y = F.pad(y, (pad, pad, 0, 0), mode="reflect")
    return F.conv2d(y, k.view(1, 1, 1, ksize))[:, 0]
