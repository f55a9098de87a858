"""The port's plain kernel versions against the Pallas kernels run with
interpret=True: FAST + NMS and the patch crop (the building block of the
ORB-describe and anchor-cell plain versions) exactly, LK within 1e-3 px
with identical converged flags."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.ops.pallas.fast_kernel import fast_score_map_pallas
from trackingbench_slam_tpu.ops.pallas.lk_kernel import patch_align_pallas
from trackingbench_slam_tpu.ops.pallas.patch_kernel import extract_patches32 \
    as jax_extract_patches32
from trackingbench_slam_tpu_torch.ops.cuda import fast_kernel, lk_kernel, \
    patch_kernel
from tests.conftest import make_textured_image


def _blur_np(img, k=5):
    ker = np.ones(k) / k
    img = np.apply_along_axis(lambda m: np.convolve(m, ker, mode="same"), 0, img)
    img = np.apply_along_axis(lambda m: np.convolve(m, ker, mode="same"), 1, img)
    return img.astype(np.float32)


@pytest.mark.parametrize("shape,arc,integer", [
    ((61, 93), 9, True), ((48, 130), 10, True), ((77, 101), 9, False),
    ((40, 64), 10, False)])
def test_fast_plain_matches_pallas_exactly(shape, arc, integer):
    h, w = shape
    img = make_textured_image(h, w, seed=h + w, blobs=h * w // 60)
    if integer:
        # uint8-valued frames: FAST scores are integers, so ties are common
        img = np.round(img).astype(np.float32)
    ref = np.asarray(fast_score_map_pallas(jnp.asarray(img), 12.0, arc,
                                           interpret=True))
    got = fast_kernel.fast_score_nms(torch.from_numpy(img), 12.0, arc).numpy()
    assert (ref > 0).sum() > 10
    np.testing.assert_array_equal(got, ref)


def test_patch_crop_plain_matches_pallas_exactly():
    h, w = 90, 150
    img = make_textured_image(h, w, seed=3)
    r = np.random.RandomState(0)
    inner = np.stack([r.uniform(0, w, 40), r.uniform(0, h, 40)], -1)
    # every border, corner and the half-pixel rounding cases
    edge = np.array([[0, 0], [w - 1, h - 1], [2.5, 40], [w - 1.5, 3.5],
                     [75, -3], [75, h + 4], [-6, 50], [w + 9, 50],
                     [16.5, 15.5], [14.5, 17.5], [w - 16.5, h - 16.5],
                     [200.0, 60.0], [-40, -40]], np.float64)
    pts = np.concatenate([inner, edge]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    ref = np.asarray(jax_extract_patches32(jnp.asarray(img), jnp.asarray(pts),
                                           jnp.asarray(valid),
                                           interpret=True))[:, :, :32]
    got = patch_kernel.extract_patches32_plain(torch.from_numpy(img),
                                               torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, ref)


def _lk_case(half, seed):
    h, w = 150, 300
    img1 = _blur_np(make_textured_image(h, w, seed=seed, blobs=400))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x2 = np.clip(xs + 1.7, 0, w - 1)
    y2 = np.clip(ys - 0.9, 0, h - 1)
    x0, y0 = x2.astype(int), y2.astype(int)
    fx, fy = x2 - x0, y2 - y0
    x1, y1 = np.clip(x0 + 1, 0, w - 1), np.clip(y0 + 1, 0, h - 1)
    img2 = (img1[y0, x0] * (1 - fx) * (1 - fy) + img1[y0, x1] * fx * (1 - fy)
            + img1[y1, x0] * (1 - fx) * fy + img1[y1, x1] * fx * fy
            ).astype(np.float32)
    r = np.random.RandomState(seed)
    n = 48
    pts = np.stack([r.uniform(15, w - 15, n), r.uniform(15, h - 15, n)], -1)
    # points straddling the 128-column and 8-row window alignment
    straddle = np.array([[128 - half - 12 + d, 8 * k + 0.5 * d]
                         for d in (-1.0, 0.0, 1.0) for k in (3, 7)])
    pts = np.concatenate([pts, straddle, straddle + [128, 0]])
    init = pts + r.uniform(-1.5, 1.5, pts.shape)
    # starts whose clipped window leaves them past the travel bounds (the
    # left, top and bottom edges): these points never run
    init[:3] = [[3.0, 60.0], [100.0, 2.0], [150.0, h - 3.0]]
    valid = np.ones(len(pts), bool)
    valid[5] = False
    return (img1, img2, pts.astype(np.float32), init.astype(np.float32),
            valid)


@pytest.mark.parametrize("half,fb_iters", [(10, 0), (10, 10), (4, 0), (4, 10)])
def test_lk_plain_matches_pallas(half, fb_iters):
    img1, img2, pts, init, valid = _lk_case(half, 11 + half)
    iters, eps = (30, 0.01) if half == 10 else (10, 0.03)
    ref = patch_align_pallas(jnp.asarray(img1), jnp.asarray(img2),
                             jnp.asarray(pts), jnp.asarray(init),
                             jnp.asarray(valid), half=half, iters=iters,
                             conv_eps=eps, interpret=True, fb_iters=fb_iters)
    got = lk_kernel.patch_align(torch.from_numpy(img1),
                                torch.from_numpy(img2),
                                torch.from_numpy(pts), torch.from_numpy(init),
                                torch.from_numpy(valid), half=half,
                                iters=iters, conv_eps=eps, fb_iters=fb_iters)
    ref = [np.asarray(a) for a in ref]
    got = [a.numpy() for a in got]
    conv = ref[1]
    assert conv.sum() > 0.6 * len(conv), conv.sum()
    assert not conv[:3].any() and not conv[5]
    np.testing.assert_array_equal(got[1], conv)
    np.testing.assert_allclose(got[0][conv], ref[0][conv], atol=1e-3)
    # points that never ran keep their start exactly (to f32 rounding)
    np.testing.assert_allclose(got[0][:3], init[:3], atol=1e-4)
    np.testing.assert_allclose(got[2][conv], ref[2][conv], atol=1e-3)
    assert (got[2][:3] == 1e9).all()
    if fb_iters:
        np.testing.assert_array_equal(got[3], ref[3])
        np.testing.assert_allclose(got[4][ref[3]], ref[4][ref[3]], atol=1e-3)


def test_lk_search_image_smaller_than_template_image():
    """The anchored caller's shape: templates in a large atlas, search in a
    smaller frame. The port zero-pads the search image to the template
    image's padded shape, which is what the Pallas kernel computes when
    given that padded image. Where a search window lies inside the frame
    the unpadded call agrees too; where it runs past the frame's right or
    bottom edge, the Pallas call's window copy runs outside the unpadded
    image and its answers there differ, while the port finds the true
    shift."""
    H, W, h, w = 256, 512, 150, 300
    half, iters, eps = 4, 10, 0.03
    atlas = _blur_np(make_textured_image(H, W, seed=5, blobs=1500))
    shift = np.array([0.6, -0.4])
    # frame = the atlas's top-left corner sampled at +shift
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x2, y2 = xs + shift[0], ys + shift[1]
    x0, y0 = np.floor(x2).astype(int), np.floor(y2).astype(int)
    fx, fy = x2 - x0, y2 - y0
    y0c, y1c = np.clip(y0, 0, H - 1), np.clip(y0 + 1, 0, H - 1)
    cur = (atlas[y0c, x0] * (1 - fx) * (1 - fy)
           + atlas[y0c, x0 + 1] * fx * (1 - fy)
           + atlas[y1c, x0] * (1 - fx) * fy
           + atlas[y1c, x0 + 1] * fx * fy).astype(np.float32)
    r = np.random.RandomState(0)
    n = 64
    pts = np.stack([r.uniform(10, w - 10, n), r.uniform(10, h - 10, n)], -1)
    pts[:20, 0] = r.uniform(w - 60, w - 8, 20)    # near the right edge
    pts[20:40, 1] = r.uniform(h - 40, h - 8, 20)  # near the bottom edge
    pts = pts.astype(np.float32)
    truth = pts - shift
    init = (truth + r.uniform(-1, 1, pts.shape)).astype(np.float32)
    valid = np.ones(n, bool)
    kw = dict(half=half, iters=iters, conv_eps=eps)
    hp, wp = lk_kernel.padded_shape(H, W, half)
    cur_padded = np.zeros((hp, wp), np.float32)
    cur_padded[:h, :w] = cur

    def pallas(search):
        return [np.asarray(a) for a in patch_align_pallas(
            jnp.asarray(atlas), jnp.asarray(search), jnp.asarray(pts),
            jnp.asarray(init), jnp.asarray(valid), interpret=True, **kw)]

    got = [a.numpy() for a in lk_kernel.patch_align(
        *(torch.from_numpy(a) for a in (atlas, cur, pts, init, valid)), **kw)]
    ref_padded = pallas(cur_padded)
    np.testing.assert_array_equal(got[1], ref_padded[1])
    conv = got[1]
    np.testing.assert_allclose(got[0][conv], ref_padded[0][conv], atol=1e-3)

    # points whose search window (8-row / 128-column aligned base) lies
    # inside the frame
    bx = np.clip((np.round(init[:, 0]).astype(int) - half - 12) // 128 * 128,
                 0, wp - 256)
    by = np.clip((np.round(init[:, 1]).astype(int) - half - 12) // 8 * 8,
                 0, hp - lk_kernel.win_rows(half))
    inside = (bx + 256 <= w) & (by + lk_kernel.win_rows(half) <= h)
    assert 5 <= inside.sum() <= n - 30, inside.sum()
    ref = pallas(cur)
    np.testing.assert_array_equal(got[1][inside], ref[1][inside])
    both = inside & conv
    np.testing.assert_allclose(got[0][both], ref[0][both], atol=1e-3)
    # past the frame's edge the port still recovers the shift
    edge = ~inside & conv
    assert edge.sum() >= 0.9 * (~inside).sum()
    assert np.median(np.abs(got[0][edge] - truth[edge])) < 0.05


def _wrapper_calls(device):
    img = torch.zeros((64, 96), dtype=torch.float32, device=device)
    pts = torch.full((4, 2), 30.0, dtype=torch.float32, device=device)
    valid = torch.ones((4,), dtype=torch.bool, device=device)
    slots = torch.arange(4, dtype=torch.int32, device=device)
    atlas = torch.zeros((32, 32), dtype=torch.float32, device=device)
    return {
        "fast": (fast_kernel.fast_score_nms, fast_kernel.fast_score_nms_cuda,
                 (img, 12.0, 9)),
        "orb_describe": (patch_kernel.orb_describe,
                         patch_kernel.orb_describe_cuda,
                         ([img], [img], pts, valid, [4])),
        "anchor_cells": (patch_kernel.anchor_cells,
                         patch_kernel.anchor_cells_cuda,
                         (img, pts, slots, valid, atlas, 4)),
        "lk": (lk_kernel.patch_align, lk_kernel.lk_align_cuda,
               (img, img, pts, pts, valid)),
    }


@pytest.mark.parametrize("name", ["fast", "orb_describe", "anchor_cells",
                                  "lk"])
def test_wrapper_takes_plain_version_only_for_cpu_tensors(name):
    wrapper, cuda_fn, args = _wrapper_calls("cpu")[name]
    before = cuda_fn.launches
    out = wrapper(*args)
    first = out[0] if isinstance(out, tuple) else out
    assert first.device.type == "cpu"
    assert cuda_fn.launches == before
    # a tensor on neither the CPU nor CUDA gets no plain fallback
    wrapper, _, args = _wrapper_calls("meta")[name]
    with pytest.raises(RuntimeError, match="no kernel"):
        wrapper(*args)
