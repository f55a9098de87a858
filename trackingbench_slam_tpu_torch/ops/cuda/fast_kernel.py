"""FAST score + 3x3 NMS: CUDA kernel csrc/fast.cu and its plain version.

Replaces the Pallas TPU kernel `fast_score_map_pallas`
(trackingbench_slam_tpu/ops/pallas/fast_kernel.py:126, body
`_fast_nms_kernel`). `fast_score_nms` launches the kernel for a CUDA image
and runs `fast_score_nms_plain` (ops/fast.py fast_score_map + nms3x3) for a
CPU image.
"""

from __future__ import annotations

import ctypes

import torch

from trackingbench_slam_tpu_torch.ops import fast as fast_ops
from trackingbench_slam_tpu_torch.ops.cuda import build


def _check(img, arc):
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError(f"img must be (H, W) float32, got {tuple(img.shape)}"
                         f" {img.dtype}")
    if not 1 <= arc <= 16:
        raise ValueError(f"arc must be in [1, 16], got {arc}")


def fast_score_nms(img: torch.Tensor, threshold: float = 20.0,
                   arc: int = 9) -> torch.Tensor:
    """NMS'd FAST score map (H, W) float32."""
    _check(img, arc)
    if img.is_cuda:
        return fast_score_nms_cuda(img, threshold, arc)
    if img.device.type != "cpu":
        raise RuntimeError(f"fast_score_nms: no kernel for {img.device}")
    return fast_score_nms_plain(img, threshold, arc)


def fast_score_nms_plain(img, threshold=20.0, arc=9):
    return fast_ops.nms3x3(fast_ops.fast_score_map(img, threshold, arc))


def fast_score_nms_cuda(img, threshold=20.0, arc=9):
    fn = build.load("fast").fast_score_nms
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    img = img.contiguous()
    h, w = img.shape
    out = torch.empty_like(img)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    rc = fn(img.data_ptr(), out.data_ptr(), h, w, float(threshold), arc,
            stream)
    build.check(rc, "fast_score_nms")
    fast_score_nms_cuda.launches += 1
    return out


fast_score_nms_cuda.launches = 0
