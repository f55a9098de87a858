"""The two uses of the 32x32 keypoint patch crop: CUDA kernels csrc/patch.cu
(`orb_describe`, `anchor_cells`) and their plain versions.

Replace the Pallas TPU kernel `extract_patches32`
(trackingbench_slam_tpu/ops/pallas/patch_kernel.py:103, body
`_patch_kernel`) together with what consumes its patches, so that no patch
reaches device memory:

* `orb_describe`: IC angle of the raw crop and rBRIEF of the blurred crop
  for the keypoints of every ORB level, one launch for all levels (plain
  version `orb_describe_plain`: `extract_patches32_plain` +
  ops/orb.py `ic_angle_from_patches` / `brief_from_patches`, level by level);
* `anchor_cells`: the 16x16 bilinear anchor cell of each wanted point written
  into its slot's cell of a copy of the anchor atlas (plain version
  `anchor_cells_plain`: `bilinear_cell_patches` + an indexed row write).

Each wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors. `extract_patches32_plain` is the crop itself, with the
Pallas window clamps: the plain versions' building block.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from trackingbench_slam_tpu_torch.ops import orb as orb_ops
from trackingbench_slam_tpu_torch.ops.cuda import build

PATCH = 32
WIN_ROWS = 56
WIN_LANES = 256
MAX_LEVELS = 8
CELL = 16      # side of an anchor-atlas cell (models/map.py ATLAS_CELL)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def padded_shape(h: int, w: int) -> tuple[int, int]:
    return (_round_up(max(h, WIN_ROWS), 8),
            _round_up(max(w, WIN_LANES + 128), 128))


def patch_origins(centers: torch.Tensor, h: int, w: int):
    hp, wp = padded_shape(h, w)
    c = torch.round(centers).clamp(-2 ** 30, 2 ** 30).long() - (PATCH // 2 - 1)
    return c[:, 1].clamp(0, hp - PATCH), c[:, 0].clamp(0, wp - PATCH)


def extract_patches32_plain(img, centers):
    """(N, 32, 32) patches, top-left at round(center) - 15 clamped into the
    zero-padded image (callers mask invalid and near-border rows)."""
    h, w = img.shape
    r0, c0 = patch_origins(centers, h, w)
    ar = torch.arange(PATCH, device=img.device)
    rows = r0[:, None] + ar[None]
    cols = c0[:, None] + ar[None]
    inside = (rows < h)[:, :, None] & (cols < w)[:, None, :]
    idx = rows.clamp(max=h - 1)[:, :, None] * w + cols.clamp(max=w - 1)[:, None, :]
    vals = img.reshape(-1)[idx]
    return torch.where(inside, vals, torch.zeros_like(vals))


# ---------------------------------------------------------------------------
# orb_describe


def orb_level_table(shapes, counts):
    """The kernel's per-level arguments: the flat (h, w, hp, wp, first row)
    of each level, rows in level order."""
    if len(shapes) != len(counts):
        raise ValueError(f"{len(shapes)} levels but {len(counts)} counts")
    table, first = [], 0
    for (h, w), n in zip(shapes, counts):
        table += [h, w, *padded_shape(h, w), first]
        first += n
    return table


def _check_orb(raw, blurred, xy, valid, counts):
    if not 1 <= len(raw) <= MAX_LEVELS or len(blurred) != len(raw):
        raise ValueError(f"need 1 to {MAX_LEVELS} raw and blurred levels, got"
                         f" {len(raw)} and {len(blurred)}")
    for r, b in zip(raw, blurred):
        if r.dim() != 2 or r.dtype != torch.float32 or r.shape != b.shape \
                or b.dtype != torch.float32:
            raise ValueError(f"levels must be (H, W) float32 pairs, got "
                             f"{tuple(r.shape)} {r.dtype} / {tuple(b.shape)} "
                             f"{b.dtype}")
    n = xy.shape[0]
    if xy.shape != (n, 2) or xy.dtype != torch.float32:
        raise ValueError("xy must be (N, 2) float32")
    if valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError("valid must be (N,) bool")
    if sum(counts) != n:
        raise ValueError(f"level counts {list(counts)} do not add up to {n}")
    devs = {t.device for t in (*raw, *blurred, xy, valid)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def orb_describe(raw, blurred, xy, valid, counts):
    """IC angle and rBRIEF of the keypoints of every pyramid level.

    raw / blurred: the levels and their blurred images; xy (N, 2) level
    coordinates and valid (N,), rows in level order, `counts[l]` rows for
    level l. Returns (angle (N,) float32, desc (N, 8) int32), both zero on
    invalid rows."""
    raw, blurred, counts = list(raw), list(blurred), [int(c) for c in counts]
    _check_orb(raw, blurred, xy, valid, counts)
    if xy.is_cuda:
        return orb_describe_cuda(raw, blurred, xy, valid, counts)
    if xy.device.type != "cpu":
        raise RuntimeError(f"orb_describe: no kernel for {xy.device}")
    return orb_describe_plain(raw, blurred, xy, valid, counts)


def orb_describe_plain(raw, blurred, xy, valid, counts):
    angles, descs = [], []
    for img, blur, p, v in zip(raw, blurred, xy.split(counts),
                               valid.split(counts)):
        ang = orb_ops.ic_angle_from_patches(extract_patches32_plain(img, p))
        ang = torch.where(v, ang, torch.zeros_like(ang))
        angles.append(ang)
        descs.append(orb_ops.brief_from_patches(
            extract_patches32_plain(blur, p), ang, v))
    return torch.cat(angles), torch.cat(descs)


@functools.lru_cache(maxsize=4)
def brief_pairs(device) -> torch.Tensor:
    """(32, 512) int16 patch positions of the rBRIEF tests per angle bin
    (ops/orb.py brief_positions), on `device` once."""
    return orb_ops.brief_positions(torch.device("cpu")).to(
        torch.int16).contiguous().to(device)


_orb_fn = None


def _orb_kernel():
    global _orb_fn
    if _orb_fn is None:
        fn = build.load("patch").orb_describe
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
        _orb_fn = fn
    return _orb_fn


def orb_describe_cuda(raw, blurred, xy, valid, counts):
    """`orb_describe` in one launch of csrc/patch.cu for all levels."""
    fn = _orb_kernel()
    raw = [r.contiguous() for r in raw]
    blurred = [b.contiguous() for b in blurred]
    xy, valid = xy.contiguous(), valid.contiguous()
    table = orb_level_table([tuple(r.shape) for r in raw], counts)
    n, dev = xy.shape[0], xy.device
    angle = torch.empty((n,), dtype=torch.float32, device=dev)
    desc = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n > 0:
        levels = len(raw)
        rc = fn((ctypes.c_void_p * levels)(*[r.data_ptr() for r in raw]),
                (ctypes.c_void_p * levels)(*[b.data_ptr() for b in blurred]),
                (ctypes.c_int * len(table))(*table), levels, xy.data_ptr(),
                valid.data_ptr(), brief_pairs(dev).data_ptr(),
                angle.data_ptr(), desc.data_ptr(), n,
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "orb_describe")
        orb_describe_cuda.launches += 1
    return angle, desc


orb_describe_cuda.launches = 0


# ---------------------------------------------------------------------------
# anchor_cells


def _check_cells(img, kp_xy, slots, want, atlas, capacity):
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError(f"img must be (H, W) float32, got {tuple(img.shape)}"
                         f" {img.dtype}")
    n = kp_xy.shape[0]
    if kp_xy.shape != (n, 2) or kp_xy.dtype != torch.float32:
        raise ValueError("kp_xy must be (N, 2) float32")
    if slots.shape != (n,) or slots.dtype != torch.int32:
        raise ValueError("slots must be (N,) int32")
    if want.shape != (n,) or want.dtype != torch.bool:
        raise ValueError("want must be (N,) bool")
    a = atlas.shape[0]
    if (atlas.dim() != 2 or atlas.shape[1] != a or a % CELL
            or atlas.dtype != torch.float32):
        raise ValueError(f"atlas must be square float32 with a side that is "
                         f"a multiple of {CELL}, got {tuple(atlas.shape)}")
    if not 0 <= capacity <= (a // CELL) ** 2:
        raise ValueError(f"capacity {capacity} exceeds the atlas's "
                         f"{(a // CELL) ** 2} cells")
    devs = {t.device for t in (img, kp_xy, slots, want, atlas)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def anchor_cells(img, kp_xy, slots, want, atlas, capacity: int):
    """A copy of `atlas` in which each wanted point's 16x16 bilinear cell
    around kp_xy sits at the cell of its slot (slot s at cell row s // G,
    column s % G of the G x G grid). Rows not wanted, or whose slot lies
    outside [0, capacity), write nowhere; `atlas` itself is not written."""
    _check_cells(img, kp_xy, slots, want, atlas, capacity)
    if img.is_cuda:
        return anchor_cells_cuda(img, kp_xy, slots, want, atlas, capacity)
    if img.device.type != "cpu":
        raise RuntimeError(f"anchor_cells: no kernel for {img.device}")
    return anchor_cells_plain(img, kp_xy, slots, want, atlas, capacity)


def bilinear_cell_patches(img: torch.Tensor, kp_xy: torch.Tensor):
    """(B, 16, 16) bilinear patches centred on kp_xy: the patch crop cuts
    the integer block at floor(kp) - 8, and one (fx, fy) per point blends
    its 17 x 17 corner (bilinear_cell_patches_pallas)."""
    c = CELL
    x0 = torch.floor(kp_xy[:, 0])
    y0 = torch.floor(kp_xy[:, 1])
    off = float(15 - c // 2)
    pat = extract_patches32_plain(img, torch.stack([x0 + off, y0 + off], -1))
    fx = (kp_xy[:, 0] - x0)[:, None, None]
    fy = (kp_xy[:, 1] - y0)[:, None, None]
    block = pat[:, :c + 1, :c + 1]
    t00, t01 = block[:, :c, :c], block[:, :c, 1:]
    t10, t11 = block[:, 1:, :c], block[:, 1:, 1:]
    return ((1 - fy) * ((1 - fx) * t00 + fx * t01)
            + fy * ((1 - fx) * t10 + fx * t11))


def anchor_cells_plain(img, kp_xy, slots, want, atlas, capacity):
    c = CELL
    g = atlas.shape[0] // c
    G2 = g * g
    ok = want & (slots >= 0) & (slots < capacity)
    cells = bilinear_cell_patches(img, kp_xy)
    # the atlas in cell order plus a scratch cell G2 for the dropped rows
    order = atlas.reshape(g, c, g, c).permute(0, 2, 1, 3).reshape(G2, c, c)
    ext = torch.cat([order, order[:1]])
    ext.index_copy_(0, torch.where(ok, slots, torch.full_like(slots, G2)
                                   ).long(), cells)
    return ext[:G2].reshape(g, g, c, c).permute(0, 2, 1, 3).reshape(g * c,
                                                                   g * c)


_cells_fn = None


def _cells_kernel():
    global _cells_fn
    if _cells_fn is None:
        fn = build.load("patch").anchor_cells
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        _cells_fn = fn
    return _cells_fn


def anchor_cells_cuda(img, kp_xy, slots, want, atlas, capacity):
    """`anchor_cells`: one copy of the atlas, then one launch of
    csrc/patch.cu that writes the wanted cells into it."""
    out = atlas.clone()
    anchor_cells_into(out, img, kp_xy, slots, want, capacity)
    return out


def anchor_cells_into(out, img, kp_xy, slots, want, capacity):
    """The kernel launch of `anchor_cells_cuda`: writes the wanted cells
    into the atlas `out` in place (inputs as `anchor_cells` checks them,
    `out` contiguous)."""
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    fn = _cells_kernel()
    img, kp_xy = img.contiguous(), kp_xy.contiguous()
    slots, want = slots.contiguous(), want.contiguous()
    n = kp_xy.shape[0]
    if n > 0:
        h, w = img.shape
        rc = fn(img.data_ptr(), h, w, *padded_shape(h, w), kp_xy.data_ptr(),
                slots.data_ptr(), want.data_ptr(), out.data_ptr(),
                out.shape[0] // CELL, int(capacity), n,
                torch.cuda.current_stream(img.device).cuda_stream)
        build.check(rc, "anchor_cells")
        anchor_cells_cuda.launches += 1
    return out


anchor_cells_cuda.launches = 0
