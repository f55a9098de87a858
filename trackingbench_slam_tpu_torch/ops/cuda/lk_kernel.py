"""Patch alignment (inverse-compositional LK): CUDA kernel csrc/lk.cu and
its plain PyTorch version.

Replaces the Pallas TPU kernel `patch_align_pallas`
(trackingbench_slam_tpu/ops/pallas/lk_kernel.py:347, body `_lk_kernel`).
`lk_align` aligns N points over a pyramid, coarse to fine, the way
ops/align.py's `lk_pyramidal` chains the Pallas kernel level by level; for
CUDA tensors it is one launch of the kernel for all levels, for CPU tensors
`lk_align_plain`, the same level loop over `patch_align_plain`; there is no
other fallback. `patch_align` is its one-level case. Both follow the Pallas
semantics (see csrc/lk.cu): window bases aligned to 8 rows / 128 columns,
travel bounds local to those windows, one enlarged bilinear sample for
template and gradients, cofactor inverse, per-point convergence, an
optional fused forward-backward re-track at level 0, and the final in-image
check against the template image's level-0 shape.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from trackingbench_slam_tpu_torch.ops.cuda import build

MARGIN = 12
WIN_LANES = 256
MAX_HALF = 15
MAX_LEVELS = 4


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def win_rows(half: int) -> int:
    return _round_up(2 * half + 1 + 2 * MARGIN + 4 + 16, 8)


def slice_rows(half: int) -> int:
    return _round_up(2 * half + 1 + 3, 8) + 8


def padded_shape(h: int, w: int, half: int) -> tuple[int, int]:
    return (_round_up(max(h, win_rows(half)), 8),
            _round_up(max(w, WIN_LANES + 128), 128))


def level_table(prev_shapes, cur_shapes, half: int, scale: float):
    """The kernel's per-level arguments, level 0 first: (shapes, scales,
    start_scale) with shapes the flat (h, w, hc, wc, hp, wp) of each level
    (template image, search image, template image's padded shape), scales
    scale ** level, and start_scale the factor that takes level-0 starts to
    the coarsest level."""
    shapes, scales = [], []
    for lvl, ((h, w), (hc, wc)) in enumerate(zip(prev_shapes, cur_shapes)):
        shapes += [h, w, hc, wc, *padded_shape(h, w, half)]
        scales.append(scale ** lvl)
    return shapes, scales, scale ** (len(scales) - 1)


def _check(prev_pyr, cur_pyr, pts, start, valid, half, offset=None):
    if not 1 <= len(prev_pyr) <= MAX_LEVELS or len(cur_pyr) != len(prev_pyr):
        raise ValueError(f"need 1 to {MAX_LEVELS} levels of prev and cur, got "
                         f"{len(prev_pyr)} and {len(cur_pyr)}")
    if not 1 <= half <= MAX_HALF:
        raise ValueError(f"half must be in [1, {MAX_HALF}], got {half}")
    for prev, cur in zip(prev_pyr, cur_pyr):
        if prev.dim() != 2 or cur.dim() != 2:
            raise ValueError("prev/cur must be (H, W) images")
        hp, wp = padded_shape(prev.shape[0], prev.shape[1], half)
        if cur.shape[0] > hp or cur.shape[1] > wp:
            raise ValueError(f"cur {tuple(cur.shape)} exceeds the template "
                             f"image's padded shape {(hp, wp)}")
    n = pts.shape[0]
    if pts.shape != (n, 2) or start.shape != (n, 2) or valid.shape != (n,):
        raise ValueError("pts/start must be (N, 2) and valid (N,)")
    tensors = (*prev_pyr, *cur_pyr, pts, start) + (
        () if offset is None else (offset,))
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    devs = {t.device for t in (*tensors, valid)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def lk_align(prev_pyr, cur_pyr, pts, start, valid, scale: float = 0.5,
             offset=None, half: int = 10, iters: int = 30,
             conv_eps: float = 0.01, fb_iters: int = 0):
    """Coarse-to-fine LK of level-0 points `pts` from the levels of
    `prev_pyr` (level 0 first) into those of `cur_pyr`, starting from
    level-0 positions `start` (+ `offset`, (N, 2) or (2,)), the levels
    `scale` apart. At every level both images are zero-padded to the padded
    shape of that level's prev image, and the final in-image check uses
    prev's level-0 shape, as in the Pallas kernel. For the anchored caller
    (prev the atlas, cur a smaller frame) the Pallas kernel pads cur by
    prev's padding only, so a search window past the frame's right or
    bottom edge reads outside cur; zero padding cur to prev's padded shape
    is what it computes when cur is that large. Returns (xy (N, 2),
    converged (N,), err (N,)) and, with fb_iters > 0, also (fb_conv (N,),
    fb_d2 (N,)) from a back-track at level 0."""
    if offset is not None and offset.shape != pts.shape:
        offset = offset.expand(pts.shape).contiguous()
    _check(prev_pyr, cur_pyr, pts, start, valid, half, offset)
    kw = dict(scale=scale, offset=offset, half=half, iters=iters,
              conv_eps=conv_eps, fb_iters=fb_iters)
    if pts.is_cuda:
        return lk_align_cuda(prev_pyr, cur_pyr, pts, start, valid, **kw)
    if pts.device.type != "cpu":
        raise RuntimeError(f"lk_align: no kernel for {pts.device}")
    return lk_align_plain(prev_pyr, cur_pyr, pts, start, valid, **kw)


def patch_align(prev_img, cur_img, pts, init_xy, valid, half: int = 10,
                iters: int = 30, conv_eps: float = 0.01, fb_iters: int = 0):
    """LK for N points at one level: template at `pts` in prev, search in
    cur from `init_xy` (`lk_align` with one level)."""
    return lk_align((prev_img,), (cur_img,), pts, init_xy, valid, half=half,
                    iters=iters, conv_eps=conv_eps, fb_iters=fb_iters)


_lk_fn = None


def _kernel():
    global _lk_fn
    if _lk_fn is None:
        fn = build.load("lk").lk_align
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        _lk_fn = fn
    return _lk_fn


def lk_align_cuda(prev_pyr, cur_pyr, pts, start, valid, scale=0.5,
                  offset=None, half=10, iters=30, conv_eps=0.01, fb_iters=0):
    """`lk_align` in one launch of csrc/lk.cu (inputs as `lk_align` checks
    them, offset (N, 2) or None)."""
    fn = _kernel()
    levels = len(prev_pyr)
    prev_pyr = [p.contiguous() for p in prev_pyr]
    cur_pyr = [c.contiguous() for c in cur_pyr]
    shapes, scales, start_scale = level_table(
        [p.shape for p in prev_pyr], [c.shape for c in cur_pyr], half, scale)
    pts, start = pts.contiguous(), start.contiguous()
    valid = valid.contiguous()
    offset = None if offset is None else offset.contiguous()
    n = pts.shape[0]
    dev = pts.device
    fbuf = torch.empty((4 * n,), dtype=torch.float32, device=dev)
    bbuf = torch.empty((2 * n,), dtype=torch.bool, device=dev)
    xy, err, fb_d2 = fbuf[:2 * n].view(n, 2), fbuf[2 * n:3 * n], fbuf[3 * n:]
    conv, fb_conv = bbuf[:n], bbuf[n:]
    if n > 0:
        rc = fn((ctypes.c_void_p * levels)(*[p.data_ptr() for p in prev_pyr]),
                (ctypes.c_void_p * levels)(*[c.data_ptr() for c in cur_pyr]),
                (ctypes.c_int * len(shapes))(*shapes),
                (ctypes.c_float * levels)(*scales), levels, pts.data_ptr(),
                start.data_ptr(),
                None if offset is None else offset.data_ptr(),
                valid.data_ptr(), xy.data_ptr(), conv.data_ptr(),
                err.data_ptr(), fb_conv.data_ptr(), fb_d2.data_ptr(), n, half,
                iters, float(conv_eps * conv_eps), fb_iters, win_rows(half),
                slice_rows(half), scale, start_scale,
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "lk_align")
        lk_align_cuda.launches += 1
    if fb_iters > 0:
        return xy, conv, err, fb_conv, fb_d2
    return xy, conv, err


lk_align_cuda.launches = 0


def lk_align_plain(prev_pyr, cur_pyr, pts, start, valid, scale=0.5,
                   offset=None, half=10, iters=30, conv_eps=0.01, fb_iters=0):
    """The kernel's semantics in PyTorch ops: the level loop of
    lk_pyramidal over `patch_align_plain`."""
    levels = len(prev_pyr)
    s0 = start if offset is None else start + offset
    xy = s0 * (scale ** (levels - 1))
    for lvl in range(levels - 1, -1, -1):
        out = patch_align_plain(prev_pyr[lvl], cur_pyr[lvl],
                                pts * (scale ** lvl), xy, valid, half, iters,
                                conv_eps, fb_iters if lvl == 0 else 0)
        xy = out[0] if lvl == 0 else out[0] / scale
    return (xy,) + tuple(out[1:])


# ---------------------------------------------------------------------------
# plain PyTorch version (same semantics, vectorized over points)


def _finish(xy, conv, err, valid, h, w, half, fb):
    """Final in-image check at level resolution (lk_kernel.py:423-428)."""
    inb = ((xy[:, 0] >= half) & (xy[:, 0] < w - half)
           & (xy[:, 1] >= half) & (xy[:, 1] < h - half))
    conv = conv & inb & valid
    if fb is None:
        return xy, conv, err
    fb_conv, fb_d2 = fb
    return xy, conv, err, fb_conv & conv, fb_d2


def _bases(xy, half, hp, wp, win):
    bx = torch.round(xy[:, 0]).clamp(-2 ** 30, 2 ** 30).long() - half - MARGIN
    by = torch.round(xy[:, 1]).clamp(-2 ** 30, 2 ** 30).long() - half - MARGIN
    bx = torch.div(bx, 128, rounding_mode="floor") * 128
    by = torch.div(by, 8, rounding_mode="floor") * 8
    return by.clamp(0, hp - win), bx.clamp(0, wp - WIN_LANES)


def _sample(img_p, by, bx, u, v, half, n, win, slc):
    """(N, n, n) bilinear grid at window-local origin (u - half, v - half)
    with the kernel's slice clamps."""
    hp, wp = img_p.shape
    P = 2 * half + 1
    vtop = v - float(half)
    utop = u - float(half)
    fiy = torch.floor(vtop)
    fix = torch.floor(utop)
    fy = (vtop - fiy)[:, None, None]
    fx = (utop - fix)[:, None, None]
    iy = fiy.clamp(-2 ** 30, 2 ** 30).long().clamp(0, win - slc)
    ix = fix.clamp(-2 ** 30, 2 ** 30).long().clamp(0, WIN_LANES - P - 2)
    ar = torch.arange(n + 1, device=img_p.device)
    rows = (by + iy)[:, None] + ar[None]
    cols = (bx + ix)[:, None] + ar[None]
    idx = (rows.clamp(max=hp - 1)[:, :, None] * wp
           + cols.clamp(max=wp - 1)[:, None, :])
    X = img_p.reshape(-1)[idx]
    t00, t01 = X[:, :n, :n], X[:, :n, 1:]
    t10, t11 = X[:, 1:, :n], X[:, 1:, 1:]
    top = t00 + fx * (t01 - t00)
    bot = t10 + fx * (t11 - t10)
    return top + fy * (bot - top)


def _psum(x):
    return x.sum(-1).sum(-1)


def _template(img_p, by, bx, x, y, half, win, slc):
    P = 2 * half + 1
    S = _sample(img_p, by, bx, x - 1.0, y - 1.0, half, P + 2, win, slc)
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
    det = torch.where(torch.abs(det) < 1e-10, torch.full_like(det, 1e-10), det)
    inv_det = 1.0 / det
    return tpl, gx, gy, (c00, c01, c02, c11, c12, c22, inv_det, h02, h12, h22)


def _run(img_p, by, bx, tpl, gx, gy, cof, u, v, run, n_iters, eps2, half,
         win, slc):
    """Iterate the points in `run` from window-local (u, v). Returns (u, v,
    md, still active, failed, iterations each point ran)."""
    (a00, a01, a02, a11, a12, a22, inv_det, h02, h12, h22) = cof
    lo = float(half + 1)
    hi_y = float(win - slc + half - 1)
    hi_x = float(WIN_LANES - half - 4)
    P = 2 * half + 1
    md = torch.zeros_like(u)
    active = run.float()
    failed = torch.zeros_like(u)
    n_it = torch.zeros_like(u)
    for _ in range(n_iters):
        n_it = n_it + active
        cur = _sample(img_p, by, bx, u, v, half, P, win, slc)
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
               | (v_raw > hi_y)).float()
        failed = torch.maximum(failed, active * out)
        u_new = u_raw.clamp(lo, hi_x)
        v_new = v_raw.clamp(lo, hi_y)
        small = ((du * du + dv * dv) < eps2).float()
        u = torch.where(active > 0, u + (u_new - u), u)
        v = torch.where(active > 0, v + (v_new - v), v)
        md = torch.where(active > 0, md + dm, md)
        active = active * (1.0 - small) * (1.0 - failed)
    return u, v, md, active > 0.5, failed > 0.5, n_it


def patch_align_plain(prev_img, cur_img, pts, init_xy, valid, half=10,
                      iters=30, conv_eps=0.01, fb_iters=0):
    """The kernel's semantics in PyTorch ops on any device."""
    h, w = prev_img.shape
    P = 2 * half + 1
    win, slc = win_rows(half), slice_rows(half)
    hp, wp = padded_shape(h, w, half)
    prev_p = F.pad(prev_img, (0, wp - w, 0, hp - h))
    cur_p = F.pad(cur_img, (0, wp - cur_img.shape[1], 0,
                            hp - cur_img.shape[0]))
    by_t, bx_t = _bases(pts, half, hp, wp, win)
    by_c, bx_c = _bases(init_xy, half, hp, wp, win)
    tx = pts[:, 0] - bx_t.float()
    ty = pts[:, 1] - by_t.float()
    ux0 = init_xy[:, 0] - bx_c.float()
    uy0 = init_xy[:, 1] - by_c.float()
    lo = float(half + 1)
    hi_y = float(win - slc + half - 1)
    hi_x = float(WIN_LANES - half - 4)
    in_bounds = ((ty >= lo) & (ty <= hi_y) & (tx >= lo) & (tx <= hi_x)
                 & (uy0 >= lo) & (uy0 <= hi_y) & (ux0 >= lo) & (ux0 <= hi_x))
    run = valid & in_bounds
    eps2 = float(conv_eps * conv_eps)
    tpl, gx, gy, cof = _template(prev_p, by_t, bx_t, tx, ty, half, win, slc)
    u, v, md, active, failed, _ = _run(cur_p, by_c, bx_c, tpl, gx, gy, cof,
                                       ux0, uy0, run, iters, eps2, half, win,
                                       slc)
    converged = run & ~active & ~failed
    cur_f = _sample(cur_p, by_c, bx_c, u, v, half, P, win, slc)
    err = _psum(torch.abs(cur_f - tpl + md[:, None, None])) / float(P * P)
    err = torch.where(run, err, torch.full_like(err, 1e9))
    xy = torch.stack([u + bx_c.float(), v + by_c.float()], dim=-1)
    fb = None
    if fb_iters > 0:
        tplB, gxB, gyB, cofB = _template(cur_p, by_c, bx_c, u, v, half, win,
                                         slc)
        ub, vb, _, activeb, failedb, _ = _run(
            prev_p, by_t, bx_t, tplB, gxB, gyB, cofB, tx, ty, converged,
            fb_iters, eps2, half, win, slc)
        fb_conv = converged & ~activeb & ~failedb
        fb_d2 = (ub - tx) * (ub - tx) + (vb - ty) * (vb - ty)
        fb = (fb_conv, torch.where(fb_conv, fb_d2, torch.full_like(fb_d2,
                                                                   1e9)))
    return _finish(xy, converged, err, valid, h, w, half, fb)
