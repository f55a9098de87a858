"""Modules of the port that hold a kernel, against the JAX package: ORB
extraction (FAST kernel + ORB-describe kernel), anchor-patch capture
(anchor-cell kernel) and pyramidal / anchored alignment (LK kernel)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.models import extractors as j_ext
from trackingbench_slam_tpu.models import frame as j_frame
from trackingbench_slam_tpu.models import map as j_map
from trackingbench_slam_tpu.ops import align as j_align
from trackingbench_slam_tpu.ops import fast as j_fast
from trackingbench_slam_tpu.ops import image as j_image
from trackingbench_slam_tpu.ops import orb as j_orb
from trackingbench_slam_tpu.ops.pallas.fast_kernel import fast_score_map_pallas
from trackingbench_slam_tpu.ops.pallas.patch_kernel import (
    brief_from_patches, extract_patches32, ic_angle_from_patches)
from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.models import extractors as t_ext
from trackingbench_slam_tpu_torch.models import frame as t_frame
from trackingbench_slam_tpu_torch.models import map as t_map
from trackingbench_slam_tpu_torch.ops import align as t_align
from trackingbench_slam_tpu_torch.ops import orb as t_orb
from trackingbench_slam_tpu_torch.ops.cuda import patch_kernel
from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       ExtractorConfig,
                                                       PyramidConfig)
from tests.conftest import make_textured_image

CPU = torch.device("cpu")
CAM = dict(width=320, height=240, fx=185.0, fy=185.0, cx=160.0, cy=120.0,
           bf=100.0)
EXT = dict(num_features=256, min_threshold=12, cell_size=24)


def t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _frames(img, suppress=None):
    """The same frame in both packages, sharing the JAX pyramid images so
    that the comparison starts from identical levels."""
    fj = j_frame.make_frame(jnp.asarray(img), EXT["num_features"], 3, 0.8)
    ft = t_frame.make_frame(t(img), EXT["num_features"], 3, 0.8)
    ft = ft._replace(pyramid=tuple(t(p) for p in fj.pyramid))
    return fj, ft


def _wrap(a):
    return np.abs(np.angle(np.exp(1j * a)))


def test_extract_orb_matches_reference_tpu_path():
    img = np.round(make_textured_image(240, 320, seed=9, blobs=400))
    fj, ft = _frames(img)
    r = np.random.RandomState(1)
    sup_xy = np.stack([r.uniform(0, 320, 60), r.uniform(0, 240, 60)],
                      -1).astype(np.float32)
    sup_valid = r.uniform(size=60) > 0.2
    tc = t_cam.CameraParams.from_config(CameraConfig(**CAM), CPU)
    out = t_ext.extract_orb(ft, tc, ExtractorConfig(**EXT),
                            PyramidConfig(num_levels=3, scale_factor=0.8),
                            suppress_xy=t(sup_xy), suppress_valid=t(sup_valid))
    budgets = j_ext.level_budgets(256, 3, 0.8)
    assert t_ext.level_budgets(256, 3, 0.8) == budgets
    assert t_orb.pattern_id() == j_orb.pattern_id()
    start = 0
    for lvl, img_l in enumerate(fj.pyramid):
        s = 0.8 ** lvl
        score = fast_score_map_pallas(img_l, 12.0, 9, interpret=True)
        occ_j = j_ext.occupancy_mask(img_l.shape, jnp.asarray(sup_xy) * s,
                                     jnp.asarray(sup_valid),
                                     max(int(10 * s), 2))
        occ_t = t_ext.occupancy_mask(img_l.shape, t(sup_xy) * s,
                                     t(sup_valid), max(int(10 * s), 2))
        np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
        cell = max(int(24 * s), 8)
        xy, resp, valid = j_fast.grid_topk(score * occ_j, cell, 4,
                                           budgets[lvl])
        sl = slice(start, start + budgets[lvl])
        start += budgets[lvl]
        valid = np.asarray(valid)
        assert valid.sum() > 20
        # keypoints: index-exact
        np.testing.assert_array_equal(out.valid[sl].numpy(), valid)
        np.testing.assert_array_equal(out.kp_xy[sl].numpy(),
                                      np.asarray(xy) / np.float32(s))
        np.testing.assert_array_equal(out.kp_response[sl].numpy(),
                                      np.asarray(resp))
        # angles: the reference's moments of the interpret-mode patches
        patches = extract_patches32(img_l, xy, jnp.asarray(valid),
                                    interpret=True)
        ang_j = np.where(valid, np.asarray(ic_angle_from_patches(patches)),
                         0.0)
        assert _wrap(out.kp_angle[sl].numpy() - ang_j).max() < 1e-5
        # descriptors: bit-exact on the same blurred image and angles
        blur_j = j_image.gaussian_blur(img_l)
        bpat_j = extract_patches32(blur_j, xy, jnp.asarray(valid),
                                   interpret=True)
        desc_j = np.asarray(brief_from_patches(bpat_j, jnp.asarray(ang_j),
                                               jnp.asarray(valid)))
        bpat_t = patch_kernel.extract_patches32_plain(t(blur_j), t(xy))
        desc_t = t_orb.brief_from_patches(bpat_t, t(ang_j), t(valid))
        np.testing.assert_array_equal(desc_t.numpy().view(np.uint32), desc_j)
        # with the port's own blur (a 7-tap convolution summed in another
        # order) near-tie pixel pairs of flat regions can flip: >= 99.9% of
        # bits and >= 90% of whole descriptors agree
        bits_t = t_orb.unpack_bits(out.desc[sl]).numpy()
        bits_j = t_orb.unpack_bits(t(desc_j)).numpy()
        assert (bits_t == bits_j).mean() >= 0.999
        assert (bits_t == bits_j).all(-1).mean() >= 0.9


def test_anchor_patch_capture_matches_pallas_blend():
    img = make_textured_image(120, 200, seed=12)
    r = np.random.RandomState(2)
    kp = np.stack([r.uniform(10, 190, 64), r.uniform(10, 110, 64)],
                  -1).astype(np.float32)
    ok = np.ones(64, bool)
    ref = np.asarray(j_map.bilinear_cell_patches_pallas(
        jnp.asarray(img), jnp.asarray(kp), jnp.asarray(ok), interpret=True))
    got = patch_kernel.bilinear_cell_patches(t(img), t(kp)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # written into the atlas cells of their slots
    M = 100
    slots = r.permutation(M)[:64].astype(np.int32)
    want = r.uniform(size=64) > 0.2
    m = t_map.write_anchor_patches(t_map.empty_map(M, 4, CPU), t(img), t(kp),
                                   t(slots), t(want))
    g, c = m.atlas_grid, t_map.ATLAS_CELL
    atlas = m.anchor_atlas.numpy()
    for i in range(64):
        row, col = divmod(int(slots[i]), g)
        cellv = atlas[row * c:(row + 1) * c, col * c:(col + 1) * c]
        np.testing.assert_allclose(cellv, ref[i] if want[i] else 0.0,
                                   atol=1e-4)


def test_orb_describe_plain_matches_reference_tpu_path():
    """The fused describe's plain version over three levels against the
    reference's TPU branch: Pallas crops (interpret mode) + the moment and
    selection-matrix math of ops/pallas/patch_kernel.py."""
    img = np.round(make_textured_image(240, 320, seed=5, blobs=60))
    fj, ft = _frames(img)
    r = np.random.RandomState(7)
    sup_xy = np.stack([r.uniform(0, 320, 80), r.uniform(0, 240, 80)],
                      -1).astype(np.float32)
    xy, _, valid, _, budgets = t_ext.detect_orb(
        ft, ExtractorConfig(**EXT), PyramidConfig(num_levels=3,
                                                  scale_factor=0.8),
        suppress_xy=t(sup_xy), suppress_valid=t(np.ones(80, bool)))
    assert sum(budgets) == 256 and 0 < int(valid.sum()) < 256
    blur_j = [j_image.gaussian_blur(p) for p in fj.pyramid]
    angle, desc = patch_kernel.orb_describe(
        [t(p) for p in fj.pyramid], [t(b) for b in blur_j], xy, valid,
        budgets)
    assert angle.shape == (256,) and desc.shape == (256, 8)
    assert desc.dtype == torch.int32
    for lvl, (sl_xy, sl_v, sl_a, sl_d) in enumerate(zip(
            xy.split(budgets), valid.split(budgets), angle.split(budgets),
            desc.split(budgets))):
        xy_j, v = jnp.asarray(sl_xy.numpy()), sl_v.numpy()
        assert v.sum() > 10
        patches = extract_patches32(fj.pyramid[lvl], xy_j, jnp.asarray(v),
                                    interpret=True)
        ang_j = np.where(v, np.asarray(ic_angle_from_patches(patches)), 0.0)
        assert _wrap(sl_a.numpy() - ang_j).max() < 1e-5
        # bit-exact for the same blurred image and angles
        bpat = extract_patches32(blur_j[lvl], xy_j, jnp.asarray(v),
                                 interpret=True)
        desc_j = np.asarray(brief_from_patches(bpat, jnp.asarray(sl_a.numpy()),
                                               jnp.asarray(v)))
        np.testing.assert_array_equal(sl_d.numpy().view(np.uint32), desc_j)
        assert (sl_a.numpy()[~v] == 0).all() and (sl_d.numpy()[~v] == 0).all()


def test_orb_level_table_maps_rows_to_their_level():
    shapes = [(370, 1226), (296, 981), (237, 785), (40, 50)]
    counts = [819, 656, 525, 7]
    table = patch_kernel.orb_level_table(shapes, counts)
    assert table == [370, 1226, 376, 1280, 0, 296, 981, 296, 1024, 819,
                     237, 785, 240, 896, 1475, 40, 50, 56, 384, 2000]
    for lvl, (h, w) in enumerate(shapes):
        assert table[5 * lvl + 2:5 * lvl + 4] == list(
            patch_kernel.padded_shape(h, w))
    # the kernel's lookup (the last level whose first row <= the row) gives
    # every row the level whose rows it is in
    firsts = table[4::5]
    want = np.repeat(np.arange(len(counts)), counts)
    got = [max(lvl for lvl, f in enumerate(firsts) if i >= f)
           for i in range(sum(counts))]
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="add up"):
        patch_kernel.orb_describe([torch.zeros(40, 50)] * 2,
                                  [torch.zeros(40, 50)] * 2,
                                  torch.zeros(5, 2), torch.ones(5, dtype=bool),
                                  [2, 2])


def test_orb_kernel_tables_match_the_plain_math():
    """What csrc/patch.cu takes for granted about the plain version: the
    moment mask is the disk dx^2 + dy^2 <= 225 about (15, 15), and the
    (32, 512) int16 position table, read as one int32 per test, holds the
    first sample in its low half and the second in its high half."""
    mask = t_orb._circle_umax_mask() > 0
    r, c = np.arange(31)[:, None], np.arange(31)[None, :]
    np.testing.assert_array_equal(mask, (r - 15) ** 2 + (c - 15) ** 2 <= 225)
    pairs = patch_kernel.brief_pairs(CPU)
    assert pairs.shape == (32, 512) and pairs.dtype == torch.int16
    words = pairs.numpy().view(np.int32)          # (32, 256), little-endian
    pos = t_orb.brief_positions(CPU).numpy()
    np.testing.assert_array_equal(words & 0xffff, pos[:, 0::2])
    np.testing.assert_array_equal(words >> 16, pos[:, 1::2])
    assert pos.min() >= 0 and pos.max() < 32 * 32


def test_anchor_cells_plain_matches_pallas_at_every_border():
    """Cells next to every border, where the crop clamp shifts the block,
    against the Pallas blend; each written to its slot's cell of a copy of
    the atlas, every other cell untouched."""
    h, w = 120, 200
    img = make_textured_image(h, w, seed=13)
    r = np.random.RandomState(4)
    n = 96
    kp = np.stack([r.uniform(16, w - 16, n), r.uniform(16, h - 16, n)], -1)
    near = r.uniform(0, 16, (4, 8))
    kp[0:8, 0] = near[0]                 # left
    kp[8:16, 0] = w - 1e-3 - near[1]     # right
    kp[16:24, 1] = near[2]               # top
    kp[24:32, 1] = h - 1e-3 - near[3]    # bottom
    kp[32:36] = [[0.3, 0.7], [w - 0.5, 1.2], [2.5, h - 0.25],
                 [w - 3.75, h - 7.5]]    # corners
    kp = kp.astype(np.float32)
    ok = np.ones(n, bool)
    ref = np.asarray(j_map.bilinear_cell_patches_pallas(
        jnp.asarray(img), jnp.asarray(kp), jnp.asarray(ok), interpret=True))
    M, cap = 150, 140
    slots = r.permutation(M)[:n].astype(np.int32)
    slots[40:44] = [-1, cap, cap + 5, M + 20]   # outside [0, capacity)
    want = r.uniform(size=n) > 0.15
    atlas = torch.from_numpy(r.uniform(0, 255, (208, 208)).astype(np.float32))
    before = atlas.clone()
    out = patch_kernel.anchor_cells(t(img), t(kp), t(slots), t(want), atlas,
                                    cap)
    assert torch.equal(atlas, before)
    g, c = 13, patch_kernel.CELL
    expect = before.numpy().copy()
    for i in range(n):
        if want[i] and 0 <= slots[i] < cap:
            row, col = divmod(int(slots[i]), g)
            expect[row * c:(row + 1) * c, col * c:(col + 1) * c] = ref[i]
    np.testing.assert_allclose(out.numpy(), expect, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(
        out.numpy(), patch_kernel.anchor_cells_plain(
            t(img), t(kp), t(slots), t(want), before, cap).numpy())


def _shifted_pair(dx, dy, h=160, w=240, seed=21):
    img = np.asarray(j_image.gaussian_blur(jnp.asarray(
        make_textured_image(h, w, seed=seed, blobs=300)), 7, 2.0))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    return img, np.asarray(j_image.bilinear_sample(
        jnp.asarray(img), jnp.asarray(np.stack([xs - dx, ys - dy], -1),
                                      jnp.float32)))


def test_lk_pyramidal_and_anchored_match_reference_cpu_path():
    """The reference's CPU path samples gradients at +-0.5 px where the
    Pallas semantics (the port's) use the one-pixel stencil, so converged
    positions agree to ~1e-2 px, not bit for bit."""
    img1, img2 = _shifted_pair(3.4, -1.7)
    r = np.random.RandomState(3)
    pts = np.stack([r.uniform(30, 210, 96), r.uniform(30, 130, 96)],
                   -1).astype(np.float32)
    valid = np.ones(96, bool)
    pj = j_image.build_pyramid(jnp.asarray(img1), 4, 0.5)
    cj = j_image.build_pyramid(jnp.asarray(img2), 4, 0.5)
    for kw in (dict(num_levels=3), dict(num_levels=2, fb_iters=10,
                                        init_offset=np.array([3.0, -1.5],
                                                             np.float32))):
        rj = j_align.lk_pyramidal(tuple(pj), tuple(cj), jnp.asarray(pts),
                                  jnp.asarray(valid), 0.5, half=10, iters=30,
                                  **{k: (jnp.asarray(v) if k == "init_offset"
                                         else v) for k, v in kw.items()})
        rt = t_align.lk_pyramidal(tuple(t(p) for p in pj),
                                  tuple(t(p) for p in cj), t(pts), t(valid),
                                  0.5, half=10, iters=30,
                                  **{k: (t(v) if k == "init_offset" else v)
                                     for k, v in kw.items()})
        both = np.asarray(rj.converged) & rt.converged.numpy()
        assert both.mean() > 0.85
        d = np.abs(rt.xy.numpy()[both] - np.asarray(rj.xy)[both])
        assert np.median(d) < 1e-2 and d.max() < 0.1, (np.median(d), d.max())
        # bilinear resampling is a low-pass, not an exact translation
        np.testing.assert_allclose(rt.xy.numpy()[both], pts[both] +
                                   [3.4, -1.7], atol=0.15)
        if "fb_iters" in kw:
            assert (rt.fb_conv.numpy()[both]).mean() > 0.9
            assert np.median(rt.fb_d2.numpy()[rt.fb_conv.numpy()]) < 1e-3
    # anchored: 16-px atlas cells cut from img1, searched in img2. The atlas
    # (256 x 256 at 256 slots) covers the frame, as the 2048^2 atlas of the
    # main path does: the Pallas semantics take the in-image check from it
    m = t_map.write_anchor_patches(t_map.empty_map(256, 4, CPU), t(img1),
                                   t(pts), t(np.arange(96, dtype=np.int32)),
                                   t(valid))
    centers = t_map.atlas_cell_centers(torch.arange(96), m.atlas_grid)
    init = (pts + np.float32([3.4, -1.7])
            + r.uniform(-0.3, 0.3, pts.shape)).astype(np.float32)
    at = t_align.anchored_align(m.anchor_atlas, t(img2), centers, t(init),
                                t(valid))
    aj = j_align.anchored_align(jnp.asarray(m.anchor_atlas.numpy()),
                                jnp.asarray(img2), jnp.asarray(centers.numpy()),
                                jnp.asarray(init), jnp.asarray(valid))
    both = np.asarray(aj.converged) & at.converged.numpy()
    assert both.mean() > 0.8
    d = np.abs(at.xy.numpy()[both] - np.asarray(aj.xy)[both])
    assert np.median(d) < 1e-2 and d.max() < 0.1, (np.median(d), d.max())
