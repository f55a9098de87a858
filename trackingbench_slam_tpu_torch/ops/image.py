"""Image-space primitives: pyramid, separable Gaussian blur, bilinear sampling.

Port of trackingbench_slam_tpu/ops/image.py. Images are float32 (H, W) in
[0, 255] on any device.

`resize_bilinear` reproduces jax.image.resize(..., "linear",
antialias=False) rather than F.interpolate: it builds the same normalized
triangle-kernel weight matrices (sample x_in = (x_out + 0.5) / scale - 0.5,
taps outside the image dropped and the rest renormalized) and applies them
as two float32 matrix products. At the far border of a x0.8 level the last
output column samples x = W - 0.875, past the last pixel; the renormalized
weights give the edge pixel there, exactly as the reference does.
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
def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights_np(in_size, out_size)).to(device)


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    h, w = img.shape
    oh, ow = out_hw
    x = img
    if ow != w:
        ww = _resize_weights(w, ow, img.device)
        x = x @ ww
    if oh != h:
        wh = _resize_weights(h, oh, img.device)
        x = wh.T @ x
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
