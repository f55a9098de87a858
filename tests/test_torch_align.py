"""The port's fused LK and batched FAST entry points on the CPU: pyramidal LK
against the reference's TPU branch (the Pallas kernel in interpret mode,
level by level, as trackingbench_slam_tpu/ops/align.py composes it when
use_pallas is true), the FAST score maps of a pyramid against the Pallas
kernel level by level, and the argument tables the CUDA wrappers pack for
their one launch per pyramid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.ops import image as j_image
from trackingbench_slam_tpu.ops.pallas.fast_kernel import fast_score_map_pallas
from trackingbench_slam_tpu.ops.pallas.lk_kernel import patch_align_pallas
from trackingbench_slam_tpu_torch.ops import align as t_align
from trackingbench_slam_tpu_torch.ops.cuda import fast_kernel, lk_kernel
from tests.conftest import make_textured_image


def _shifted_pair(dx, dy, h=160, w=240, seed=21):
    img = np.asarray(j_image.gaussian_blur(jnp.asarray(
        make_textured_image(h, w, seed=seed, blobs=300)), 7, 2.0))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    return img, np.asarray(j_image.bilinear_sample(
        jnp.asarray(img), jnp.asarray(np.stack([xs - dx, ys - dy], -1),
                                      jnp.float32)))


def _reference_tpu_branch(prev_pyr, cur_pyr, pts, valid, scale, half, iters,
                          num_levels, init_offset=None, fb_iters=0):
    """lk_pyramidal's use_pallas branch (trackingbench_slam_tpu/ops/
    align.py:196-227) with the Pallas kernel in interpret mode."""
    levels = min(num_levels, len(prev_pyr))
    start = pts if init_offset is None else pts + init_offset
    xy = start * (scale ** (levels - 1))
    fb_conv = fb_d2 = None
    for lvl in range(levels - 1, -1, -1):
        s = scale ** lvl
        tpl_xy = pts * s
        fb_here = fb_iters if lvl == 0 else 0
        out = patch_align_pallas(prev_pyr[lvl], cur_pyr[lvl], tpl_xy, xy,
                                 valid, half=half, iters=iters, conv_eps=0.01,
                                 fb_iters=fb_here, interpret=True)
        if fb_here > 0:
            xy, conv, err, fb_conv, fb_d2 = out
        else:
            xy, conv, err = out
        if lvl > 0:
            xy = xy / scale
    return xy, conv, err, fb_conv, fb_d2


@pytest.mark.parametrize("case", ["3 levels", "2 levels, prior, fb"])
def test_lk_pyramidal_matches_reference_tpu_path(case):
    img1, img2 = _shifted_pair(3.4, -1.7)
    r = np.random.RandomState(4)
    n = 40
    pts = np.stack([r.uniform(12, 228, n), r.uniform(12, 148, n)],
                   -1).astype(np.float32)
    valid = np.ones(n, bool)
    valid[7] = False
    pj = j_image.build_pyramid(jnp.asarray(img1), 4, 0.5)
    cj = j_image.build_pyramid(jnp.asarray(img2), 4, 0.5)
    if case == "3 levels":
        kw = dict(num_levels=3)
        offset = None
    else:
        offset = (np.float32([3.0, -1.5])
                  + r.uniform(-0.5, 0.5, (n, 2))).astype(np.float32)
        kw = dict(num_levels=2, fb_iters=10)
    ref = _reference_tpu_branch(
        tuple(pj), tuple(cj), jnp.asarray(pts), jnp.asarray(valid), 0.5, 10,
        30, init_offset=None if offset is None else jnp.asarray(offset),
        **kw)
    got = t_align.lk_pyramidal(
        tuple(torch.from_numpy(np.array(p)) for p in pj),
        tuple(torch.from_numpy(np.array(c)) for c in cj),
        torch.from_numpy(pts), torch.from_numpy(valid), 0.5, half=10,
        iters=30, init_offset=None if offset is None
        else torch.from_numpy(offset), **kw)
    conv = np.asarray(ref[1])
    assert conv.sum() > 0.7 * n and not conv[7]
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    np.testing.assert_allclose(got.xy.numpy()[conv], np.asarray(ref[0])[conv],
                               atol=1e-3)
    np.testing.assert_allclose(got.error.numpy()[conv],
                               np.asarray(ref[2])[conv], atol=1e-3)
    if "fb_iters" in kw:
        fb = np.asarray(ref[3])
        assert fb.sum() > 0.7 * n
        np.testing.assert_array_equal(got.fb_conv.numpy(), fb)
        np.testing.assert_allclose(got.fb_d2.numpy()[fb],
                                   np.asarray(ref[4])[fb], atol=1e-3)
    else:
        assert got.fb_conv is None and got.fb_d2 is None


def test_lk_align_one_level_is_patch_align_and_broadcasts_offset():
    img1, img2 = _shifted_pair(1.2, 0.6, h=120, w=200, seed=5)
    r = np.random.RandomState(6)
    pts = torch.from_numpy(np.stack([r.uniform(12, 188, 24),
                                     r.uniform(12, 108, 24)],
                                    -1).astype(np.float32))
    valid = torch.ones(24, dtype=torch.bool)
    prev, cur = torch.from_numpy(img1), torch.from_numpy(img2)
    shift = torch.tensor([1.0, 0.5])
    one = lk_kernel.patch_align(prev, cur, pts, pts + shift, valid, half=4,
                                iters=10, conv_eps=0.03)
    fused = lk_kernel.lk_align((prev,), (cur,), pts, pts, valid, offset=shift,
                               half=4, iters=10, conv_eps=0.03)
    assert int(one[1].sum()) > 18
    for a, b in zip(one, fused):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lk_level_table_matches_per_level_shapes():
    prev = [(370, 1226), (185, 613), (93, 307), (47, 154)]
    cur = [(300, 1000), (150, 500), (75, 250), (38, 125)]
    for half in (4, 10, 15):
        shapes, scales, start_scale = lk_kernel.level_table(prev, cur, half,
                                                            0.5)
        assert len(shapes) == 6 * len(prev)
        for lvl, (p, c) in enumerate(zip(prev, cur)):
            assert shapes[6 * lvl:6 * lvl + 6] == [
                *p, *c, *lk_kernel.padded_shape(*p, half)]
            # the level's entry is what a one-level call packs for it
            one = lk_kernel.level_table([p], [c], half, 0.5)
            assert one == (shapes[6 * lvl:6 * lvl + 6], [1.0], 1.0)
        assert scales == [0.5 ** lvl for lvl in range(len(prev))]
        assert start_scale == 0.5 ** (len(prev) - 1)


def test_fast_tile_table_covers_each_level_once():
    shapes = [(70, 97), (56, 77), (45, 61), (33, 32), (1, 1)]
    table, blocks = fast_kernel.tile_table(shapes)
    first = 0
    for lvl, (h, w) in enumerate(shapes):
        one, n = fast_kernel.tile_table([(h, w)])
        assert table[4 * lvl:4 * lvl + 3] == one[:3] and one[3] == 0
        assert table[4 * lvl + 3] == first
        first += n
    assert blocks == first
    # the kernel's block -> (level, tile) mapping covers every pixel of
    # every level exactly once
    cover = [np.zeros(s, np.int32) for s in shapes]
    firsts = table[3::4]
    for b in range(blocks):
        lvl = max(i for i, f in enumerate(firsts) if b >= f)
        h, w, tiles_x, f = table[4 * lvl:4 * lvl + 4]
        t = b - f
        y0, x0 = (t // tiles_x) * 32, (t % tiles_x) * 32
        cover[lvl][y0:y0 + 32, x0:x0 + 32] += 1
    for c in cover:
        assert (c == 1).all()


def test_fast_levels_plain_matches_pallas_per_level():
    img = np.round(make_textured_image(120, 160, seed=8, blobs=300))
    pyr = j_image.build_pyramid(jnp.asarray(img), 3, 0.8)
    got = fast_kernel.fast_score_nms_levels(
        [torch.from_numpy(np.array(p)) for p in pyr], 12.0, 9)
    assert len(got) == 3
    for p, g in zip(pyr, got):
        ref = np.asarray(fast_score_map_pallas(p, 12.0, 9, interpret=True))
        assert (ref > 0).sum() > 10
        np.testing.assert_array_equal(g.numpy(), ref)
        np.testing.assert_array_equal(
            g.numpy(), fast_kernel.fast_score_nms_plain(
                torch.from_numpy(np.array(p)), 12.0, 9).numpy())
