"""FAST score + 3x3 NMS: CUDA kernel csrc/fast.cu and its plain version.

Replaces the Pallas TPU kernel `fast_score_map_pallas`
(trackingbench_slam_tpu/ops/pallas/fast_kernel.py:126, body
`_fast_nms_kernel`). `fast_score_nms_levels` scores every level of a
pyramid: for CUDA images in one launch of the kernel, for CPU images with
`fast_score_nms_plain` (ops/fast.py fast_score_map + nms3x3) level by level.
`fast_score_nms` is its one-image case. The levels go through the custom
op `trackingbench::fast_score_nms`, whose batching rule (torch.func.vmap,
parallel/dp_eval.py) scores the B x levels maps of a batch of sequences in
one launch on CUDA and loops over the plain version on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from trackingbench_slam_tpu_torch.ops import fast as fast_ops
from trackingbench_slam_tpu_torch.ops.cuda import batch, build

TILE = 32
MAX_LEVELS = 8


def _check(imgs, arc):
    if not 1 <= len(imgs) <= MAX_LEVELS:
        raise ValueError(f"need 1 to {MAX_LEVELS} images, got {len(imgs)}")
    for img in imgs:
        if img.dim() != 2 or img.dtype != torch.float32:
            raise ValueError(f"img must be (H, W) float32, got "
                             f"{tuple(img.shape)} {img.dtype}")
    devs = {img.device for img in imgs}
    if len(devs) != 1:
        raise ValueError(f"images on several devices: {devs}")
    if not 1 <= arc <= 16:
        raise ValueError(f"arc must be in [1, 16], got {arc}")


def tile_table(shapes):
    """The kernel's flattened grid over the levels' 32x32 output tiles:
    (table, blocks) with table the flat (h, w, tiles a row, first block) of
    each level and blocks the total tile count."""
    table, first = [], 0
    for h, w in shapes:
        tiles_x = -(-w // TILE)
        table += [h, w, tiles_x, first]
        first += tiles_x * -(-h // TILE)
    return table, first


def fast_score_nms_levels(imgs, threshold: float = 20.0,
                          arc: int = 9) -> list[torch.Tensor]:
    """NMS'd FAST score maps, one (H, W) float32 map per image."""
    imgs = list(imgs)
    _check(imgs, arc)
    if imgs[0].device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"fast_score_nms: no kernel for {imgs[0].device}")
    return _fast_op(imgs, float(threshold), int(arc))


@torch.library.custom_op("trackingbench::fast_score_nms", mutates_args=())
def _fast_op(imgs: list[torch.Tensor], threshold: float,
             arc: int) -> list[torch.Tensor]:
    if imgs[0].is_cuda:
        return fast_score_nms_cuda(imgs, threshold, arc)
    return list(fast_score_nms_plain_levels(imgs, threshold, arc))


@_fast_op.register_vmap
def _fast_vmap(info, in_dims, imgs, threshold, arc):
    """B sequences: one launch for the B x levels maps on CUDA, the plain
    version per sequence on the CPU."""
    B = info.batch_size
    imgs = batch.first_all(imgs, in_dims[0], B)
    if imgs[0].is_cuda:
        out = fast_score_nms_cuda_batched(imgs, threshold, arc)
    else:
        out = batch.loop(fast_score_nms_plain_levels, B, imgs, threshold, arc)
    return list(out), [0] * len(out)


def fast_score_nms(img: torch.Tensor, threshold: float = 20.0,
                   arc: int = 9) -> torch.Tensor:
    """NMS'd FAST score map (H, W) float32."""
    return fast_score_nms_levels([img], threshold, arc)[0]


def fast_score_nms_plain(img, threshold=20.0, arc=9):
    return fast_ops.nms3x3(fast_ops.fast_score_map(img, threshold, arc))


def fast_score_nms_plain_levels(imgs, threshold=20.0, arc=9):
    return tuple(fast_score_nms_plain(img, threshold, arc) for img in imgs)


_fast_fn = None


def _kernel():
    global _fast_fn
    if _fast_fn is None:
        fn = build.load("fast").fast_score_nms
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _fast_fn = fn
    return _fast_fn


def fast_score_nms_cuda(imgs, threshold=20.0, arc=9):
    """All images in one launch of csrc/fast.cu: the batch of one."""
    return [o[0] for o in fast_score_nms_cuda_batched(
        [img[None] for img in imgs], threshold, arc)]


def fast_score_nms_cuda_batched(imgs, threshold=20.0, arc=9):
    """B sequences' levels, each (B, H, W), in one launch of csrc/fast.cu;
    returns one (B, H, W) map per level."""
    fn = _kernel()
    imgs = [batch.rows_contiguous(img) for img in imgs]
    B = imgs[0].shape[0]
    shapes = [tuple(img.shape[1:]) for img in imgs]
    table, blocks = tile_table(shapes)
    dev = imgs[0].device
    outs = [torch.empty((B,) + shape, dtype=torch.float32, device=dev)
            for shape in shapes]
    bstrides = [s for img, o in zip(imgs, outs)
                for s in (img.stride(0), o.stride(0))]
    n = len(imgs)
    rc = fn((ctypes.c_void_p * n)(*[img.data_ptr() for img in imgs]),
            (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]),
            (ctypes.c_longlong * len(bstrides))(*bstrides),
            (ctypes.c_int * len(table))(*table), n, blocks, B,
            float(threshold), arc,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "fast_score_nms")
    if blocks > 0 and B > 0:
        fast_score_nms_cuda.launches += 1
    return outs


fast_score_nms_cuda.launches = 0
