"""Image-space primitives: pyramid, separable Gaussian blur, bilinear sampling.

Port of trackingbench_slam_tpu/ops/image.py. Images are float32 (H, W) in
[0, 255] on any device.

`resize_bilinear` reproduces jax.image.resize(..., "linear",
antialias=False) rather than F.interpolate: it builds the same normalized
triangle-kernel weights (sample x_in = (x_out + 0.5) / scale - 0.5, taps
outside the image dropped and the rest renormalized). Without antialiasing
an output has at most two nonzero taps, so each axis is applied as a
two-tap gather and blend, x[i0] * w0 + x[i1] * w1, in separate
elementwise multiply and add ops. Every element is then rounded the same
way whatever the leading shape, so a resize under torch.func.vmap equals
the per-image resizes bit for bit; a matrix product, whose rounding
changes once a batch folds into its rows, did not (on the H100). A fused
multiply-add op is avoided too: a CPU kernel may fuse in its vector body
and not in its scalar tail, which would make an element's rounding depend
on its position. At the far border of a x0.8 level the last output column
samples x = W - 0.875, past the last pixel; its one renormalized tap has
weight 1 and gives the edge pixel there, exactly as the reference does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(h: int, w: int, num_levels: int,
                   scale: float) -> list[tuple[int, int]]:
    """Static per-level shapes (Frame::ComputePyramid rounding)."""
    out = []
    for lvl in range(num_levels):
        s = scale ** lvl
        out.append((max(int(round(h * s)), 8), max(int(round(w * s)), 8)))
    return out


@functools.lru_cache(maxsize=64)
def _resize_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights, computed in float32 as jax.image does."""
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
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
def _resize_taps_np(in_size: int, out_size: int):
    """(i0, i1, w0, w1): each output's first and last nonzero tap of
    `_resize_weights_np` and their weights. An output with one tap has
    i1 = i0 and w1 = 0; one with none has both weights 0."""
    w = _resize_weights_np(in_size, out_size)
    nz = w != 0
    if int(nz.sum(0).max(initial=0)) > 2:
        raise ValueError(f"resize {in_size} -> {out_size}: more than two "
                         "taps an output")
    cols = np.arange(out_size)
    i0 = np.argmax(nz, axis=0)
    i1 = in_size - 1 - np.argmax(nz[::-1], axis=0)
    i1 = np.where(nz.any(0), i1, i0)
    w0 = w[i0, cols]
    w1 = np.where(i1 != i0, w[i1, cols], np.float32(0.0))
    return i0, i1, w0.astype(np.float32), w1.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_taps(in_size: int, out_size: int, device):
    i0, i1, w0, w1 = _resize_taps_np(in_size, out_size)
    return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
            torch.from_numpy(w0).to(device), torch.from_numpy(w1).to(device))


def _blend_axis(x: torch.Tensor, dim: int, taps) -> torch.Tensor:
    i0, i1, w0, w1 = taps
    if dim == -2:
        w0, w1 = w0[:, None], w1[:, None]
    a = torch.index_select(x, dim, i0) * w0
    b = torch.index_select(x, dim, i1) * w1
    return a + b


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    h, w = img.shape
    oh, ow = out_hw
    x = img
    if ow != w:
        x = _blend_axis(x, -1, _resize_taps(w, ow, img.device))
    if oh != h:
        x = _blend_axis(x, -2, _resize_taps(h, oh, img.device))
    return x


def build_pyramid(img: torch.Tensor, num_levels: int,
                  scale: float) -> list[torch.Tensor]:
    """Chain-resize, each level from the previous one."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, num_levels, scale)
    levels = [img]
    for lvl in range(1, num_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lvl]))
    return levels


def gaussian_kernel1d(ksize: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(ksize, dtype=torch.float32, device=device) - (
        ksize - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect-101 padding (cv::GaussianBlur's
    default border), vertical pass first."""
    k = gaussian_kernel1d(ksize, sigma, img.device)
    pad = ksize // 2
    x = F.pad(img[None, None], (0, 0, pad, pad), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, ksize, 1))
    x = F.pad(x, (pad, pad, 0, 0), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, 1, ksize))
    return x[0, 0]


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor,
                    pad_value: float = 0.0) -> torch.Tensor:
    """Sample (H, W) at float coords (..., 2) = (x, y); out-of-bounds taps
    read pad_value."""
    h, w = img.shape
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(-1)

    def gather(yy, xx):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = flat[yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)]
        return torch.where(ok, v, torch.full_like(v, pad_value))

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def image_gradients(img: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients (gx, gy) of (H, W), 0.5 (I[x+1] -
    I[x-1]), zero on the border rows and columns."""
    gx = 0.5 * (torch.roll(img, -1, 1) - torch.roll(img, 1, 1))
    gy = 0.5 * (torch.roll(img, -1, 0) - torch.roll(img, 1, 0))
    gx[:, 0] = 0
    gx[:, -1] = 0
    gy[0, :] = 0
    gy[-1, :] = 0
    return gx, gy


def extract_patches(img: torch.Tensor, centers: torch.Tensor,
                    half: int) -> torch.Tensor:
    """(N, P, P) patches, P = 2 half + 1, around (N, 2) float (x, y)
    centers, bilinearly sampled (zero outside the image)."""
    offs = torch.arange(2 * half + 1, dtype=img.dtype,
                        device=img.device) - half
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    grid = torch.stack([ox, oy], -1)
    return bilinear_sample(img, centers[:, None, None, :] + grid[None])


def clahe_like(img: torch.Tensor, clip: float = 3.0,
               grid: int = 8) -> torch.Tensor:
    """Global contrast normalization (mean/std to mid-gray), the cheap
    option beside `clahe` (ops/image.py:137 of the reference). The standard
    deviation is the population one, as jnp.std."""
    mean = img.mean()
    std = img.std(correction=0) + 1e-6
    return torch.clamp((img - mean) / std * 48.0 + 127.0, 0.0, 255.0)


def clahe(img: torch.Tensor, clip: float = 3.0, grid: int = 8,
          bins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization, as the reference's
    `clahe` (ops/image.py:148; cv::createCLAHE(3.0, Size(8, 8))): per-tile
    histograms as one integer bincount over tile * bins + intensity (exact
    in any order), each bin clipped at clip * pixels / bins with the excess
    spread evenly, cumsum LUTs, and a bilinear blend of the 4 tile LUTs
    around each pixel. Tiles are ceil-divided; past the outermost tile
    centres the nearest tile's LUT is used alone (the reference's
    round(clip(.)) edge rule). Float (H, W) images in [0, 255]."""
    h, w = img.shape
    dev = img.device
    th = -(-h // grid)
    tw = -(-w // grid)
    x = torch.clamp(img, 0.0, 255.0)
    q = torch.clamp((x * (bins / 256.0)).to(torch.int32), 0, bins - 1)
    ys = torch.arange(h, device=dev) // th
    xs = torch.arange(w, device=dev) // tw
    tile_id = ys[:, None] * grid + xs[None, :]
    seg = (tile_id * bins + q).reshape(-1)
    hist = torch.bincount(seg, minlength=grid * grid * bins).to(
        torch.float32).reshape(grid * grid, bins)
    npx = torch.clamp(hist.sum(1, keepdim=True), min=1.0)
    limit = torch.clamp(clip * npx / bins, min=1.0)
    excess = torch.clamp(hist - limit, min=0.0).sum(1, keepdim=True)
    hist = torch.minimum(hist, limit) + excess / bins
    lut = torch.clamp(torch.cumsum(hist, 1) / npx * 255.0, 0.0, 255.0)

    cy = (torch.arange(h, dtype=img.dtype, device=dev) - (th - 1) / 2.0) / th
    cx = (torch.arange(w, dtype=img.dtype, device=dev) - (tw - 1) / 2.0) / tw
    y0 = torch.clamp(torch.floor(cy).long(), 0, grid - 1)
    x0 = torch.clamp(torch.floor(cx).long(), 0, grid - 1)
    y1 = torch.clamp(y0 + 1, 0, grid - 1)
    x1 = torch.clamp(x0 + 1, 0, grid - 1)
    fy = torch.clamp(cy - torch.floor(cy), 0.0, 1.0)
    fx = torch.clamp(cx - torch.floor(cx), 0.0, 1.0)
    fy = torch.where((cy < 0) | (cy > grid - 1),
                     torch.round(torch.clamp(cy, 0, 1)), fy)
    fx = torch.where((cx < 0) | (cx > grid - 1),
                     torch.round(torch.clamp(cx, 0, 1)), fx)
    flat = lut.reshape(-1)
    ql = q.long()

    def look(ty, tx):
        return flat[(ty[:, None] * grid + tx[None, :]) * bins + ql]

    top = look(y0, x0) * (1 - fx)[None, :] + look(y0, x1) * fx[None, :]
    bot = look(y1, x0) * (1 - fx)[None, :] + look(y1, x1) * fx[None, :]
    return top * (1 - fy)[:, None] + bot * fy[:, None]
