"""The yardstick's arithmetic: the H100's peaks and the kernels' bounds.

Frozen copies, each marked with where it came from:

  * the H100's published peaks and `bound` (chip_smoke.py:195-196, 356-359);
  * FAST's operations a pixel and `fast_flops` (chip_smoke.py:380-391), its
    bytes as chip_smoke.py:462 counts them (a float32 read and a float32
    score written a pixel);
  * LK's `lk_flops`, `lk_bytes` and `covered_pixels` (chip_smoke.py:364-
    436), over the work that reference/kernels.py `lk_align` reports, with
    each sequence's images apart.

The profiler's reductions (trackingbench_slam_tpu_torch/
profile_main_path.py:122-169 `kernel_launches`, `range_table`, and the
busy share of :219-248) are in trace.py.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores


def bound(nbytes, flops):
    """(least ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# FAST + NMS per pixel: 16 differences; per tap 2 threshold compares, the
# two clamped excesses (2 ops each) and their 2 running sums (128); the two
# arc tests on 16-bit masks, 2 ops a bit to build and 4 doubling steps of
# rotate-and-and (4 ops each) per mask (96); corner flag, max and select
# (3); 8 NMS compares and 8 ors (16).
FAST_OPS_PER_PIXEL = 16 + 16 * 8 + 2 * (32 + 16) + 3 + 16


def fast_terms(shapes, batch: int):
    """(bytes, operations) of one FAST launch over `batch` sequences'
    levels of `shapes`."""
    px = batch * sum(h * w for h, w in shapes)
    return px * 8, px * FAST_OPS_PER_PIXEL


def covered_pixels(shape, batch_of, blocks):
    """Pixels of a batch of images of `shape` that square blocks cover,
    each pixel of each image counted once; `blocks` is a list of (image of
    each block, top rows, left columns, size)."""
    h, w = shape
    dev = blocks[0][1].device
    mask = torch.zeros(batch_of * h * w, dtype=torch.bool, device=dev)
    for img, top, left, size in blocks:
        ar = torch.arange(size, device=dev)
        rows = (top[:, None] + ar)[:, :, None].expand(-1, size, size)
        cols = (left[:, None] + ar)[:, None, :].expand(-1, size, size)
        inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
        flat = img[:, None, None] * (h * w) + rows * w + cols
        mask[flat[inside]] = True
    return int(mask.sum())


# LK: a bilinear tap is 9 flops; a template pixel adds 2 gradients (4) and
# 5 sums (8); an iteration pixel a residual and 3 sums (6); the error pass
# (level 0 only: the function returns that level's error) a residual, abs
# and sum (3).
def lk_flops(work, half):
    P = 2 * half + 1
    loops = [lp for lv in work for lp in lv["loops"]]
    templates = sum(int(r.sum()) for r, _ in loops)
    iterations = sum(int(n.sum()) for _, n in loops)
    run0 = int(work[-1]["loops"][0][0].sum())
    return (templates * ((P + 2) ** 2 * 9 + P * P * 12)
            + iterations * P * P * 15 + run0 * P * P * 12)


def lk_bytes(work, n, half, fb, offset):
    """At every level, the pixels under the run points' templates in prev
    ((P+3)^2 each) and under their last search sample in cur ((P+1)^2, and
    at level 0 the (P+3)^2 back-track template where one is built), plus
    the point I/O; `n` points in all."""
    P = 2 * half + 1
    px = 0
    for i, lv in enumerate(work):
        batch = lv["batch"]
        per = lv["tpl_xy"].shape[0] // batch
        img = torch.arange(batch, device=lv["xy"].device).repeat_interleave(
            per)
        run = lv["loops"][0][0]
        t = torch.floor(lv["tpl_xy"][run]).long()
        x = torch.floor(lv["xy"][run]).long()
        blocks = [(img[run], x[:, 1] - half, x[:, 0] - half, P + 1)]
        if fb and i == len(work) - 1:
            back = lv["loops"][1][0]
            xb = torch.floor(lv["xy"][back]).long()
            blocks.append((img[back], xb[:, 1] - half - 1,
                           xb[:, 0] - half - 1, P + 3))
        px += (covered_pixels(lv["prev"], batch,
                              [(img[run], t[:, 1] - half - 1,
                                t[:, 0] - half - 1, P + 3)])
               + covered_pixels(lv["cur"], batch, blocks))
    inputs = n * (17 + (8 if offset else 0))
    return 4 * px + inputs + n * (13 + (5 if fb else 0))


def lk_terms(work, n, half, fb, offset):
    """(bytes, operations) of an LK call from its work."""
    return lk_bytes(work, n, half, fb, offset), lk_flops(work, half)
