"""32x32 keypoint patch crop: CUDA kernel csrc/patch.cu and its plain
version.

Replaces the Pallas TPU kernel `extract_patches32`
(trackingbench_slam_tpu/ops/pallas/patch_kernel.py:103, body
`_patch_kernel`). The Pallas kernel returns (N, 32, 128) with the patch in
lanes [:32]; this one returns (N, 32, 32). `extract_patches32` launches the
kernel for a CUDA image and runs `extract_patches32_plain` for a CPU image.
"""

from __future__ import annotations

import ctypes

import torch

from trackingbench_slam_tpu_torch.ops.cuda import build

PATCH = 32
WIN_ROWS = 56
WIN_LANES = 256


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def padded_shape(h: int, w: int) -> tuple[int, int]:
    return (_round_up(max(h, WIN_ROWS), 8),
            _round_up(max(w, WIN_LANES + 128), 128))


def _check(img, centers):
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError(f"img must be (H, W) float32, got {tuple(img.shape)}"
                         f" {img.dtype}")
    if (centers.dim() != 2 or centers.shape[1] != 2
            or centers.dtype != torch.float32):
        raise ValueError("centers must be (N, 2) float32")
    if centers.device != img.device:
        raise ValueError("img and centers on different devices")


def extract_patches32(img: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, 32, 32) patches, top-left at round(center) - 15 clamped into the
    zero-padded image (callers mask invalid and near-border rows)."""
    _check(img, centers)
    if img.is_cuda:
        return extract_patches32_cuda(img, centers)
    if img.device.type != "cpu":
        raise RuntimeError(f"extract_patches32: no kernel for {img.device}")
    return extract_patches32_plain(img, centers)


def patch_origins(centers: torch.Tensor, h: int, w: int):
    hp, wp = padded_shape(h, w)
    c = torch.round(centers).clamp(-2 ** 30, 2 ** 30).long() - (PATCH // 2 - 1)
    return c[:, 1].clamp(0, hp - PATCH), c[:, 0].clamp(0, wp - PATCH)


def extract_patches32_plain(img, centers):
    h, w = img.shape
    r0, c0 = patch_origins(centers, h, w)
    ar = torch.arange(PATCH, device=img.device)
    rows = r0[:, None] + ar[None]
    cols = c0[:, None] + ar[None]
    inside = (rows < h)[:, :, None] & (cols < w)[:, None, :]
    idx = rows.clamp(max=h - 1)[:, :, None] * w + cols.clamp(max=w - 1)[:, None, :]
    vals = img.reshape(-1)[idx]
    return torch.where(inside, vals, torch.zeros_like(vals))


def extract_patches32_cuda(img, centers):
    fn = build.load("patch").extract_patches
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    img, centers = img.contiguous(), centers.contiguous()
    h, w = img.shape
    n = centers.shape[0]
    hp, wp = padded_shape(h, w)
    out = torch.empty((n, PATCH, PATCH), dtype=torch.float32,
                      device=img.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(img.device).cuda_stream
    rc = fn(img.data_ptr(), centers.data_ptr(), out.data_ptr(), n, h, w, hp,
            wp, stream)
    build.check(rc, "extract_patches")
    extract_patches32_cuda.launches += 1
    return out


extract_patches32_cuda.launches = 0
