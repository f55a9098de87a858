"""The port's direct (SVO) family against the JAX package on the CPU: the
Shi-Tomasi map, extract_fast, align_patches, sparse image alignment,
feature alignment and the depth filter one by one; then a 10-frame
DirectVO run (stereo on the first frame only), one DirectVO step from a
carried-over JAX state, and the state converter. Where the JAX code
reaches a Pallas kernel it runs its TPU branch in interpret mode
(`reference_tpu_semantics`), the branch the port follows."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.geometry import camera as j_cam
from trackingbench_slam_tpu.matchers import direct as j_direct
from trackingbench_slam_tpu.models import extractors as j_ext
from trackingbench_slam_tpu.models.direct_vo import DirectVO as JDirectVO
from trackingbench_slam_tpu.models.frame import make_frame as j_make_frame
from trackingbench_slam_tpu.ops import align as j_align
from trackingbench_slam_tpu.ops import fast as j_fast
from trackingbench_slam_tpu.solvers import depth_filter as j_df
from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.matchers import direct as t_direct
from trackingbench_slam_tpu_torch.models import extractors as t_ext
from trackingbench_slam_tpu_torch.models.direct_vo import DirectVO
from trackingbench_slam_tpu_torch.models.frame import make_frame
from trackingbench_slam_tpu_torch.ops import align as t_align
from trackingbench_slam_tpu_torch.ops import fast as t_fast
from trackingbench_slam_tpu_torch.solvers import depth_filter as t_df
from trackingbench_slam_tpu_torch.utils import metrics
from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       DirectConfig,
                                                       ExtractorConfig,
                                                       MapConfig,
                                                       PipelineConfig,
                                                       PyramidConfig)
from trackingbench_slam_tpu_torch.utils.convert import (
    direct_vo_state_to_numpy, load_direct_vo_state)
from trackingbench_slam_tpu_torch.utils.synthetic import (
    CorridorScene, forward_yaw_trajectory)
from tests.conftest import make_textured_image
from tests.test_torch_align import reference_tpu_semantics

CPU = torch.device("cpu")
N_FRAMES = 10
BASELINE = 0.3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager steps are thousands of small ops: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.array(a))


def small_config():
    """The JAX package's direct-VO gate configuration (4 levels x0.8, cell
    24, a keyframe every 3rd frame) at 320x240 and 256 features."""
    cam = CameraConfig(width=320, height=240, fx=400.0, fy=400.0, cx=160.0,
                       cy=120.0, bf=400.0 * BASELINE)
    return PipelineConfig(
        camera=cam, pyramid=PyramidConfig(num_levels=4, scale_factor=0.8),
        extractor=ExtractorConfig(num_features=256, min_threshold=10,
                                  cell_size=24),
        map=MapConfig(max_keyframes=8, max_points=2048), keyframe_every=3,
        local_ba_every=0)


def cams(cfg):
    jcfg = JConfig.from_json(cfg.to_json())
    return (j_cam.CameraParams.from_config(jcfg.camera),
            t_cam.CameraParams.from_config(cfg.camera, CPU))


@pytest.fixture(scope="module")
def scene():
    cfg = small_config()
    gt = forward_yaw_trajectory(N_FRAMES, step=0.1, yaw_rate=0.006)
    sc = CorridorScene(cfg.camera)

    def u8(a):
        return np.clip(a, 0, 255).astype(np.uint8)
    frames = [tuple(u8(x) for x in sc.stereo_pair(gt[0], BASELINE))]
    frames += [(u8(sc.render(T)), None) for T in gt[1:]]
    return cfg, frames, gt, sc


def test_shi_tomasi_map_matches_reference():
    img = make_textured_image(90, 130, seed=3, blobs=120)
    for im in (np.round(img), img * 0.731):     # integer and fractional
        ref = np.asarray(j_fast.shi_tomasi_map(jnp.asarray(im)))
        got = t_fast.shi_tomasi_map(t(im)).numpy()
        assert ref.max() > 10
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("suppress", [False, True])
def test_extract_fast_matches_reference_tpu_path(scene, suppress):
    cfg, frames, _, _ = scene
    j_c, t_c = cams(cfg)
    jcfg = JConfig.from_json(cfg.to_json())
    img = frames[1][0]
    sup_xy = sup_valid = None
    if suppress:
        r = np.random.RandomState(2)
        sup_xy = np.stack([r.uniform(0, 320, 80), r.uniform(0, 240, 80)],
                          -1).astype(np.float32)
        sup_valid = r.uniform(size=80) > 0.2
    with reference_tpu_semantics():
        ref = j_ext.extract_fast(
            j_make_frame(jnp.asarray(img), 256, 4, 0.8), j_c, jcfg.extractor,
            jcfg.pyramid, num_levels=3,
            suppress_xy=None if sup_xy is None else jnp.asarray(sup_xy),
            suppress_valid=None if sup_valid is None
            else jnp.asarray(sup_valid))
    got = t_ext.extract_fast(
        make_frame(t(img), 256, 4, 0.8), t_c, cfg.extractor, cfg.pyramid,
        num_levels=3, suppress_xy=None if sup_xy is None else t(sup_xy),
        suppress_valid=None if sup_valid is None else t(sup_valid))
    valid = np.asarray(ref.valid)
    assert valid.sum() > 100
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.kp_xy.numpy(), np.asarray(ref.kp_xy))
    np.testing.assert_array_equal(got.kp_level.numpy(),
                                  np.asarray(ref.kp_level))
    resp = np.asarray(ref.kp_response)
    np.testing.assert_allclose(got.kp_response.numpy(), resp, rtol=1e-4,
                               atol=1e-4 * resp.max())
    np.testing.assert_allclose(got.bearing.numpy(), np.asarray(ref.bearing),
                               atol=1e-6)
    assert not got.desc.any() and not got.kp_angle.any()


def _shifted(img, dx, dy):
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x2, y2 = np.clip(xs + dx, 0, w - 1.001), np.clip(ys + dy, 0, h - 1.001)
    x0, y0 = x2.astype(int), y2.astype(int)
    fx, fy = x2 - x0, y2 - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy
            + img[y0 + 1, x0 + 1] * fx * fy).astype(np.float32)


@pytest.mark.parametrize("with_illum", [True, False])
def test_align_patches_matches_reference(with_illum):
    img1 = np.asarray(make_textured_image(120, 160, seed=9, blobs=200))
    img1 = _shifted(img1, 0.0, 0.0)
    img2 = _shifted(img1, 1.3, -0.6) * 0.9 + 7.0
    r = np.random.RandomState(1)
    n = 64
    pts = np.stack([r.uniform(8, 152, n), r.uniform(8, 112, n)],
                   -1).astype(np.float32)
    init = (pts - [1.3, -0.6] + r.uniform(-1, 1, (n, 2))).astype(np.float32)
    valid = r.uniform(size=n) > 0.1
    tj, gj = j_align.template_patches_and_grads(jnp.asarray(img1),
                                                jnp.asarray(pts), 4)
    tt, gt_ = t_align.template_patches_and_grads(t(img1), t(pts), 4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(gt_.numpy(), np.asarray(gj), atol=1e-4)
    ref = j_align.align_patches(jnp.asarray(img2), tj, gj, jnp.asarray(init),
                                jnp.asarray(valid), half=4, iters=20,
                                conv_eps=0.03, with_illum=with_illum)
    got = t_align.align_patches(t(img2), tt, gt_, t(init), t(valid), half=4,
                                iters=20, conv_eps=0.03,
                                with_illum=with_illum)
    conv = np.asarray(ref.converged)
    assert conv.sum() > 0.5 * n
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    np.testing.assert_allclose(got.xy.numpy()[conv], np.asarray(ref.xy)[conv],
                               atol=1e-3)
    np.testing.assert_allclose(got.error.numpy()[conv],
                               np.asarray(ref.error)[conv], atol=1e-3)


def _align_inputs(scene):
    """The bootstrap frame's FAST keypoints with their true depths, the
    pyramids of frames 0 and 1, both packages' cameras."""
    cfg, frames, gt, sc = scene
    j_c, t_c = cams(cfg)
    f0 = t_ext.extract_fast(make_frame(t(frames[0][0]), 256, 4, 0.8), t_c,
                            cfg.extractor, cfg.pyramid, num_levels=3)
    f1 = make_frame(t(frames[1][0]), 256, 4, 0.8)
    depth_map = sc.depth_map(gt[0])
    kp = f0.kp_xy.numpy()
    xi = np.clip(np.round(kp[:, 0]).astype(int), 0, 319)
    yi = np.clip(np.round(kp[:, 1]).astype(int), 0, 239)
    depth = np.where(f0.valid.numpy(), depth_map[yi, xi], 0.0)
    return cfg, gt, j_c, t_c, f0, f1, depth.astype(np.float32)


def test_sparse_image_align_matches_reference(scene):
    cfg, gt, j_c, t_c, f0, f1, depth = _align_inputs(scene)
    T_true = (gt[1] @ np.linalg.inv(gt[0])).astype(np.float32)
    xi = np.float32([0.01, -0.005, 0.02, 0.002, -0.003, 0.001])
    T_init = np.asarray(j_direct.se3.exp(jnp.asarray(xi))) @ T_true
    ref = j_direct.sparse_image_align(
        j_c, tuple(jnp.asarray(p.numpy()) for p in f0.pyramid),
        tuple(jnp.asarray(p.numpy()) for p in f1.pyramid),
        jnp.asarray(f0.kp_xy.numpy()), jnp.asarray(depth),
        jnp.asarray(f0.valid.numpy()), jnp.asarray(T_init), DirectConfig(),
        scale_factor=0.8)
    got = t_direct.sparse_image_align(
        t_c, f0.pyramid, f1.pyramid, f0.kp_xy, t(depth), f0.valid,
        t(T_init), DirectConfig(), scale_factor=0.8)
    T_ref = np.asarray(ref.T_cur_ref)
    np.testing.assert_allclose(got.T_cur_ref.numpy(), T_ref, atol=1e-4)
    assert int(got.num_used) == int(ref.num_used) > 100
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-3)
    # and the alignment is right: within 5 mm of the true motion
    assert np.abs(T_ref[:3, 3] - T_true[:3, 3]).max() < 5e-3


def test_features_align_matches_reference(scene):
    cfg, gt, j_c, t_c, f0, f1, depth = _align_inputs(scene)
    kp = f0.kp_xy.numpy()
    xn = (kp[:, 0] - 160.0) / 400.0
    yn = (kp[:, 1] - 120.0) / 400.0
    p_c0 = np.stack([xn * depth, yn * depth, depth], -1)
    T_wc0 = np.linalg.inv(gt[0])
    pos_w = (p_c0 @ T_wc0[:3, :3].T + T_wc0[:3, 3]).astype(np.float32)
    # the current pose 1.5 cm off the truth: alignment has pixels to fix
    T_cur = gt[1].astype(np.float32).copy()
    T_cur[0, 3] += 0.015
    level = np.asarray(f0.kp_level.numpy())
    valid = f0.valid.numpy() & (depth > 0.5)
    f1 = f1._replace(T_cw=t(T_cur))
    jf1 = j_make_frame(jnp.asarray(scene[1][1][0]), 256, 4, 0.8,
                       T_cw=jnp.asarray(T_cur))._replace(
        pyramid=tuple(jnp.asarray(p.numpy()) for p in f1.pyramid))
    T_ref = gt[0].astype(np.float32)
    ref = j_direct.features_align(
        j_c, jf1, tuple(jnp.asarray(p.numpy()) for p in f0.pyramid),
        jnp.asarray(T_ref), jnp.asarray(pos_w), jnp.asarray(kp),
        jnp.asarray(valid), DirectConfig(), num_levels=4, scale_factor=0.8,
        cand_level=jnp.asarray(level))
    got = t_direct.features_align(
        t_c, f1, f0.pyramid, t(T_ref), t(pos_w), f0.kp_xy, t(valid),
        DirectConfig(), num_levels=4, scale_factor=0.8, cand_level=t(level))
    ok_r, ok_t = np.asarray(ref.ok), got.ok.numpy()
    assert ok_r.sum() > 0.5 * valid.sum()
    assert (ok_r == ok_t).mean() >= 0.99
    np.testing.assert_array_equal(got.level.numpy(), np.asarray(ref.level))
    both = ok_r & ok_t
    np.testing.assert_allclose(got.px_cur.numpy()[both],
                               np.asarray(ref.px_cur)[both], atol=1e-3)


def _seed_rays(r, S, t_scale):
    """Unit bearings of S points 2-20 m deep in a reference camera, seen
    again from a camera moved by exp([t_scale * (1, -0.15, 0.25), small
    rotation]) with 0.01 m of noise."""
    T = np.asarray(j_direct.se3.exp(jnp.asarray(np.float32(
        [t_scale, -0.15 * t_scale, 0.25 * t_scale, 0.01, -0.02, 0.005]))))
    f_ref = r.normal(size=(S, 3)) * [0.3, 0.2, 0.0] + [0, 0, 1]
    f_ref /= np.linalg.norm(f_ref, axis=1, keepdims=True)
    z_true = r.uniform(2, 20, S)
    p_cur = (f_ref * z_true[:, None]) @ T[:3, :3].T + T[:3, 3]
    p_cur += r.normal(scale=0.01, size=p_cur.shape)
    f_cur = p_cur / np.linalg.norm(p_cur, axis=1, keepdims=True)
    return T, f_ref.astype(np.float32), f_cur.astype(np.float32), z_true


@pytest.mark.parametrize("baseline", [2.0, 0.2])
def test_depth_filter_matches_reference(baseline):
    """Every depth-filter function on the same inputs in both packages,
    within 1e-5 relative, but two. tau, the depth change of one pixel of
    disparity, is a difference of two nearly equal float32 depths: both
    packages sit up to 2e-4 from a float64 evaluation of the same formula,
    so each is held to float64 and to the other at 4e-4. The two-view depth
    is such a difference when the baseline is short against the depth: at
    0.2 m over 2-20 m both sit up to 2e-3 from float64, held at 4e-3."""
    r = np.random.RandomState(5)
    S = 300
    T, f_ref, f_cur, z_true = _seed_rays(r, S, baseline)
    well = baseline > 1.0
    rt_z, rt_tau = (1e-5 if well else 4e-3), 4e-4

    def close(a, b, rtol=1e-5, mask=None):
        a, b = np.asarray(a), np.asarray(b)
        if mask is not None:
            a, b = a[mask], b[mask]
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * np.abs(b).max())

    zj, okj = j_df.depth_from_triangulation(jnp.asarray(T), jnp.asarray(f_ref),
                                            jnp.asarray(f_cur))
    zt, okt = t_df.depth_from_triangulation(t(T), t(f_ref), t(f_cur))
    ok = np.asarray(okj)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(okt.numpy(), ok)
    z64, _ = t_df.depth_from_triangulation(t(T).double(), t(f_ref).double(),
                                           t(f_cur).double())
    close(zt, zj, rt_z, ok)
    if not well:
        close(zt, z64, rt_z, ok)
        close(zj, z64, rt_z, ok)

    T_rc = np.linalg.inv(T.astype(np.float64)).astype(np.float32)
    ang = float(np.arctan(np.float32(0.5) / np.float32(400.0)) * 2)
    tau_j = j_df.compute_tau(jnp.asarray(T_rc[:3, 3]), jnp.asarray(f_ref), zj,
                             ang)
    tau_t = t_df.compute_tau(t(T_rc[:3, 3]), t(f_ref), t(zj), ang)
    tau_64 = t_df.compute_tau(t(T_rc[:3, 3]).double(), t(f_ref).double(),
                              t(zj).double(), ang)
    close(tau_t, tau_j, rt_tau, ok)
    close(tau_t, tau_64, rt_tau, ok)
    close(tau_j, tau_64, rt_tau, ok)
    close(t_df.tau_inverse(t(zj), t(tau_j)), j_df.tau_inverse(zj, tau_j))

    # Bayesian updates, each round from the same prior in both packages;
    # observations near the truth, or outliers
    mean = r.uniform(2, 20, S).astype(np.float32)
    dmin = np.maximum(0.05 * mean, 0.2).astype(np.float32)
    valid = r.uniform(size=S) > 0.1
    sj = j_df.SeedState.init(jnp.asarray(mean), jnp.asarray(dmin),
                             jnp.asarray(valid))
    st = t_df.SeedState.init(t(mean), t(dmin), t(valid))
    for name in t_df.SeedState._fields:
        close(getattr(st, name), getattr(sj, name))
    obs = ok & (r.uniform(size=S) > 0.2)
    for _ in range(4):
        noise = r.normal(scale=0.05, size=S) + (r.uniform(size=S) < 0.2) * 3
        z_obs = (1.0 / (z_true + noise).clip(0.5)).astype(np.float32)
        tau2 = r.uniform(1e-5, 1e-3, S).astype(np.float32)
        prior = t_df.SeedState(*(t(np.asarray(x)) for x in sj))
        sj = j_df.update_seeds(sj, jnp.asarray(z_obs), jnp.asarray(tau2),
                               jnp.asarray(obs))
        st = t_df.update_seeds(prior, t(z_obs), t(tau2), t(obs))
        for name in t_df.SeedState._fields:
            close(getattr(st, name), getattr(sj, name))
    # the status of those seeds, and of seeds with pseudo-counts drawn so
    # that some diverge
    drawn = sj._replace(a=jnp.asarray(r.uniform(0.5, 20, S), jnp.float32),
                        b=jnp.asarray(r.uniform(0.5, 40, S), jnp.float32))
    for state in (sj, drawn):
        st = t_df.SeedState(*(t(np.asarray(x)) for x in state))
        conv_j, div_j = j_df.seed_status(state, sigma_thresh=0.05)
        conv_t, div_t = t_df.seed_status(st, sigma_thresh=0.05)
        assert 0 < int(conv_j.sum()) < S
        np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))
        np.testing.assert_array_equal(div_t.numpy(), np.asarray(div_j))
        close(t_df.seed_depths(st), j_df.seed_depths(state))
    assert int(div_j.sum()) > 0


def _snapshot(jvo):
    """The JAX tracker's host state after a frame (its arrays are never
    written in place; its seed batches are dicts that are)."""
    snap = copy.copy(jvo)
    snap.seed_batches = [dict(b) for b in jvo.seed_batches]
    snap.trajectory = list(jvo.trajectory)
    return snap


@pytest.fixture(scope="module")
def runs(scene):
    cfg, frames, gt, _ = scene
    with reference_tpu_semantics():
        jvo = JDirectVO(JConfig.from_json(cfg.to_json()))
        snaps = []
        for left, right in frames:
            jvo.track(left, right)
            snaps.append(_snapshot(jvo))
    tvo = DirectVO(cfg, device="cpu")
    for left, right in frames:
        tvo.track(left, right)
    return snaps, tvo


def test_direct_vo_tracks_reference_within_1cm(scene, runs):
    _, frames, gt, _ = scene
    snaps, tvo = runs
    P_j = np.stack([np.asarray(T) for T in snaps[-1].trajectory])
    P_t = tvo.poses()
    assert P_t.shape == (N_FRAMES, 4, 4) and np.isfinite(P_t).all()
    d = np.linalg.norm(metrics.trajectory_positions(P_t)
                       - metrics.trajectory_positions(P_j), axis=1)
    assert d.max() < 0.01, d
    assert metrics.ate_rmse(P_t, gt, align=True) < 0.01
    assert tvo.num_tracked > 100
    assert abs(tvo.num_tracked - snaps[-1].num_tracked) <= 3
    assert tvo.num_promoted == snaps[-1].num_promoted > 0


def test_direct_vo_step_from_carried_reference_state(scene, runs):
    """Frame 8 (the first promotions) from the JAX tracker's state after
    frame 7: pose within 1e-4, the tracked count within 2, the same
    promotions and landmark rows, seed means within 5e-3 relative (each
    observation is a two-view depth, float32-exact to ~2e-3 in both
    packages; test_depth_filter_matches_reference)."""
    cfg, frames, _, _ = scene
    snaps, _ = runs
    k = 8
    before, after = snaps[k - 1], snaps[k]
    assert after.num_promoted > before.num_promoted
    vo = DirectVO(cfg, device="cpu")
    load_direct_vo_state(vo, before)
    T = vo.track(*frames[k]).numpy()
    np.testing.assert_allclose(T, np.asarray(after.T_cw), atol=1e-4)
    assert abs(vo.num_tracked - after.num_tracked) <= 2
    assert vo.num_promoted == after.num_promoted
    np.testing.assert_array_equal(vo.kf_has_lm.numpy(),
                                  np.asarray(after.kf_has_lm))
    assert len(vo.seed_batches) == len(after.seed_batches)
    for bt, bj in zip(vo.seed_batches, after.seed_batches):
        vj = np.asarray(bj["seeds"].valid)
        np.testing.assert_array_equal(bt["seeds"].valid.numpy(), vj)
        np.testing.assert_allclose(bt["seeds"].mu.numpy()[vj],
                                   np.asarray(bj["seeds"].mu)[vj], rtol=5e-3)


def test_direct_state_converter_round_trips(scene, runs):
    cfg, frames, _, _ = scene
    _, tvo = runs
    tree = direct_vo_state_to_numpy(tvo)
    vo = DirectVO(cfg, device="cpu")
    load_direct_vo_state(vo, tree)
    back = direct_vo_state_to_numpy(vo)
    flat = [(k, v) for k, v in tree.items() if not isinstance(v, (list,
                                                                  dict))]
    for name, v in flat:
        np.testing.assert_array_equal(back[name], v)
    for name, v in tree["kf"].items():
        if isinstance(v, tuple):
            for a, b in zip(back["kf"][name], v):
                np.testing.assert_array_equal(a, b)
        else:
            assert back["kf"][name].dtype == v.dtype
            np.testing.assert_array_equal(back["kf"][name], v)
    assert len(back["seed_batches"]) == len(tree["seed_batches"]) == 3
    for bb, bt in zip(back["seed_batches"], tree["seed_batches"]):
        for name in ("kp_xy", "bearing", "T_cw"):
            np.testing.assert_array_equal(bb[name], bt[name])
        for name, v in bt["seeds"].items():
            np.testing.assert_array_equal(bb["seeds"][name], v)
    assert back["frame_id"] == tree["frame_id"] == N_FRAMES
