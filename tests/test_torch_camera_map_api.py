"""The remaining camera, map and frame API of the port against the JAX
package: undistortion, erase_points, add_reproj_failures,
get_close_view_obs, add_keypoints, the plane renderer, kitti_stereo_config,
rpe_translation, and the demo."""

import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.geometry import camera as j_cam
from trackingbench_slam_tpu.models import frame as j_frame
from trackingbench_slam_tpu.models import map as j_map
from trackingbench_slam_tpu.utils import config as j_config
from trackingbench_slam_tpu.utils import metrics as j_metrics
from trackingbench_slam_tpu.utils import synthetic as j_syn
from trackingbench_slam_tpu_torch import demo
from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.models import frame as t_frame
from trackingbench_slam_tpu_torch.models import map as t_map
from trackingbench_slam_tpu_torch.utils import config as t_config
from trackingbench_slam_tpu_torch.utils import metrics as t_metrics
from trackingbench_slam_tpu_torch.utils import synthetic as t_syn

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager steps are thousands of small ops: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# EuRoC cam0's radtan coefficients as its sensor.yaml publishes them, on the
# EuRoC operating point; and tests/test_camera.py's distorted camera
EUROC_RADTAN = dict(k1=-0.28340811, k2=0.07395907, p1=1.9359e-4,
                    p2=1.76187114e-5)
CAMERAS = {
    "euroc": dict(width=752, height=480, fx=435.2046959714599,
                  fy=435.2046959714599, cx=367.4517211914062,
                  cy=252.2008514404297, **EUROC_RADTAN),
    "test_camera": dict(width=640, height=480, fx=450.0, fy=455.0, cx=320.5,
                        cy=239.5, k1=-0.28, k2=0.07, p1=2e-4, p2=-2e-5),
}


def cameras(name):
    kw = CAMERAS[name]
    return (t_cam.CameraParams.from_config(t_config.CameraConfig(**kw), CPU),
            j_cam.CameraParams.from_config(j_config.CameraConfig(**kw)),
            kw)


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_undistort_points_matches_reference_and_cv2(name, rng):
    """Within 1e-4 px of the JAX function. Both packages stop after 8
    fixed-point steps and cv2.undistortPoints after 5 of its own scheme,
    so they part by up to 0.19 px at the edge of the EuRoC image: against
    cv2 the check is tests/test_camera.py's, on its camera and points,
    0.05 px."""
    t, j, kw = cameras(name)
    px = rng.rand(64, 2)
    px[:, 0] = px[:, 0] * (kw["width"] - 140) + 70
    px[:, 1] = px[:, 1] * (kw["height"] - 120) + 60
    got = t_cam.undistort_points(t, torch.tensor(px, dtype=torch.float32))
    ref = j_cam.undistort_points(j, jnp.asarray(px, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    if name != "test_camera":
        return
    K = np.array([[kw["fx"], 0, kw["cx"]], [0, kw["fy"], kw["cy"]],
                  [0, 0, 1]])
    dist = np.array([kw["k1"], kw["k2"], kw["p1"], kw["p2"], 0.0])
    cv = cv2.undistortPoints(px.reshape(-1, 1, 2), K, dist, P=K)
    np.testing.assert_allclose(got.numpy(), cv.reshape(-1, 2), atol=0.05)


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_undistort_map_and_image_match_reference(name, rng):
    t, j, kw = cameras(name)
    h, w = kw["height"] // 4, kw["width"] // 4
    got = t_cam.undistort_map(t, h, w)
    ref = np.asarray(j_cam.undistort_map(j, h, w))
    assert got.shape == (h, w, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
    img = (rng.rand(kw["height"], kw["width"]) * 255).astype(np.float32)
    got = t_cam.undistort_image(t, torch.from_numpy(img))
    ref = np.asarray(j_cam.undistort_image(j, jnp.asarray(img)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
    # uint8 frames as the loaders give them
    got8 = t_cam.undistort_image(t, torch.from_numpy(img.astype(np.uint8)))
    ref8 = np.asarray(j_cam.undistort_image(
        j, jnp.asarray(img.astype(np.uint8).astype(np.float32))))
    np.testing.assert_allclose(got8.numpy(), ref8, atol=1e-3)


M, K_OBS, KF = 64, 16, 4


def random_map(rng):
    """A MapState's leaves as numpy (the JAX layouts), random but valid."""
    A = j_map.atlas_grid_for(M) * j_map.ATLAS_CELL
    return dict(
        pos=(rng.randn(M, 3) * 2 + [0, 0, 6]).astype(np.float32),
        desc=rng.randint(0, 2 ** 32, (M, 8), dtype=np.uint64
                         ).astype(np.uint32),
        normal=rng.randn(M, 3).astype(np.float32),
        min_dist=rng.rand(M).astype(np.float32),
        max_dist=(rng.rand(M) * 10 + 1).astype(np.float32),
        valid=rng.rand(M) < 0.8,
        ref_kf=rng.randint(-1, KF, M).astype(np.int32),
        ref_level=rng.randint(0, 3, M).astype(np.int32),
        n_visible=rng.randint(1, 9, M).astype(np.int32),
        n_found=rng.randint(1, 9, M).astype(np.int32),
        n_fail_reproj=rng.randint(24, 31, M).astype(np.int32),
        obs_kf=np.where(rng.rand(M, K_OBS) < 0.4,
                        rng.randint(0, KF, (M, K_OBS)), -1).astype(np.int32),
        obs_feat=rng.randint(0, 100, (M, K_OBS)).astype(np.int32),
        obs_desc=rng.randint(0, 2 ** 32, (M, K_OBS, 8), dtype=np.uint64
                             ).astype(np.uint32),
        obs_count=rng.randint(0, K_OBS, M).astype(np.int32),
        anchor_atlas=rng.rand(A, A).astype(np.float32))


def both_maps(d):
    j = j_map.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    t = t_map.MapState(**{k: torch.from_numpy(
        v.view(np.int32) if v.dtype == np.uint32 else v.copy())
        for k, v in d.items()})
    return t, j


def assert_maps_equal(t, j):
    for name in t_map.MapState._fields:
        got = getattr(t, name).numpy()
        ref = np.asarray(getattr(j, name))
        if ref.dtype == np.uint32:
            ref = ref.view(np.int32)
        np.testing.assert_array_equal(got, ref, err_msg=name)


def point_rows(rng, n=48):
    """Point indices with repeats and one past the end, and a mask."""
    idx = rng.randint(0, M, n).astype(np.int32)
    idx[:6] = idx[6:12]            # repeated targets, some wanted twice
    idx[-1] = M + 5                # dropped
    return idx, rng.rand(n) < 0.7


def test_erase_points_matches_reference(rng):
    t, j = both_maps(random_map(rng))
    idx, want = point_rows(rng)
    got = t_map.erase_points(t, torch.from_numpy(idx), torch.from_numpy(want))
    ref = j_map.erase_points(j, jnp.asarray(idx), jnp.asarray(want))
    assert_maps_equal(got, ref)
    assert not got.valid[torch.from_numpy(idx[want & (idx < M)]).long()].any()


def test_add_reproj_failures_counts_and_evicts_like_reference(rng):
    """Counts start at 24-30, so landmarks named twice or more cross the
    eviction threshold of 30 and die."""
    t, j = both_maps(random_map(rng))
    idx, failed = point_rows(rng)
    for _ in range(3):
        t = t_map.add_reproj_failures(t, torch.from_numpy(idx),
                                      torch.from_numpy(failed))
        j = j_map.add_reproj_failures(j, jnp.asarray(idx),
                                      jnp.asarray(failed))
        assert_maps_equal(t, j)
    assert int((t.n_fail_reproj > 30).sum()) > 0
    assert not bool((t.valid & (t.n_fail_reproj > 30)).any())


def test_get_close_view_obs_matches_reference_with_ties(rng):
    """Columns 1 and 3 repeat column 0's keyframe on half the landmarks:
    equal cosines, where the first column must win."""
    d = random_map(rng)
    tie = rng.rand(M) < 0.5
    d["obs_kf"][tie, 1] = d["obs_kf"][tie, 0]
    d["obs_kf"][tie, 3] = d["obs_kf"][tie, 0]
    t, j = both_maps(d)
    from scipy.spatial.transform import Rotation
    T = np.tile(np.eye(4), (KF, 1, 1))
    T[:, :3, :3] = Rotation.from_rotvec(rng.randn(KF, 3) * 0.2).as_matrix()
    T[:, :3, 3] = rng.randn(KF, 3)
    T = T.astype(np.float32)
    tk = t_map.empty_keyframes(KF, 8, CPU)._replace(T_cw=torch.from_numpy(T))
    jk = j_map.empty_keyframes(KF, 8)._replace(T_cw=jnp.asarray(T))
    center = np.array([0.3, -0.2, 0.5], np.float32)
    got = t_map.get_close_view_obs(t, tk, torch.from_numpy(center))
    ref = j_map.get_close_view_obs(j, jk, jnp.asarray(center))
    for g, r, name in zip(got, ref, ("kf_slot", "feat_idx", "ok")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
    assert 0 < int(got[2].sum()) < M


@pytest.mark.parametrize("n_new", [20, 40])
def test_add_keypoints_matches_reference(n_new, rng):
    """20 or 40 new rows (16 or 32 wanted) into a 32-slot frame with 12
    free slots: the overflow is dropped; map indices repeat."""
    cap = 32
    img = rng.rand(48, 64).astype(np.float32) * 255
    kw = dict(width=64, height=48, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
    tf = t_frame.make_frame(torch.from_numpy(img), cap, 2, 0.8)
    jf = j_frame.make_frame(jnp.asarray(img), cap, 2, 0.8)
    valid = np.zeros(cap, bool)
    valid[rng.permutation(cap)[:20]] = True
    xy = (rng.rand(cap, 2) * [64, 48]).astype(np.float32)
    tf = tf._replace(valid=torch.from_numpy(valid),
                     kp_xy=torch.from_numpy(xy))
    jf = jf._replace(valid=jnp.asarray(valid), kp_xy=jnp.asarray(xy))
    new_xy = (rng.rand(n_new, 2) * [64, 48]).astype(np.float32)
    level = rng.randint(0, 2, n_new).astype(np.int32)
    resp = rng.rand(n_new).astype(np.float32)
    midx = rng.randint(-1, 5, n_new).astype(np.int32)   # repeats
    want = np.zeros(n_new, bool)
    want[rng.permutation(n_new)[:(16 if n_new == 20 else 32)]] = True
    got = t_frame.add_keypoints(
        tf, t_cam.CameraParams.from_config(t_config.CameraConfig(**kw), CPU),
        *(torch.from_numpy(a) for a in (new_xy, level, resp, midx, want)))
    ref = j_frame.add_keypoints(
        jf, j_cam.CameraParams.from_config(j_config.CameraConfig(**kw)),
        *(jnp.asarray(a) for a in (new_xy, level, resp, midx, want)))
    for name in ("kp_xy", "kp_level", "kp_angle", "kp_response", "map_idx",
                 "valid", "desc"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(),
            np.asarray(getattr(ref, name)).view(
                np.int32 if name == "desc" else getattr(ref, name).dtype),
            err_msg=name)
    np.testing.assert_allclose(got.bearing.numpy(), np.asarray(ref.bearing),
                               atol=1e-6)
    assert bool(got.valid.all())   # every free slot filled, the rest dropped


def test_plane_renderer_matches_reference():
    np.testing.assert_array_equal(t_syn.textured_plane(60, 80, seed=3),
                                  j_syn.textured_plane(60, 80, seed=3))
    kw = dict(width=96, height=64, fx=90.0, fy=90.0, cx=48.0, cy=32.0,
              bf=90.0 * 0.2)
    t = t_syn.PlaneSequence(t_config.CameraConfig(**kw), depth=6.0)
    j = j_syn.PlaneSequence(j_config.CameraConfig(**kw), depth=6.0)
    for T in j_syn.lateral_trajectory(3, step=0.05):
        for a, b in zip(t.stereo_pair(T, 0.2), j.stereo_pair(T, 0.2)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.depth_map(T), j.depth_map(T))


@pytest.mark.parametrize("width,radius", [(8.0, 1.0), (16.0, 1.0)])
def test_corridor_renderer_matches_reference(width, radius):
    """The port's CorridorScene, which samples each plane's texture only
    at the pixels that plane takes, renders the reference's frames and
    depth maps bit for bit: around a closed circle (every wall, the back
    and end walls, floor and ceiling in view) and down the corridor."""
    kw = dict(width=160, height=96, fx=92.0, fy=92.0, cx=78.5, cy=47.0,
              bf=92.0 * 0.54)
    t = t_syn.CorridorScene(t_config.CameraConfig(**kw), width=width,
                            height=5.0)
    j = j_syn.CorridorScene(j_config.CameraConfig(**kw), width=width,
                            height=5.0)
    poses = list(j_syn.loop_trajectory(8, radius=radius))
    poses += list(j_syn.forward_yaw_trajectory(2))
    for T in poses:
        for a, b in zip(t.stereo_pair(T, 0.54), j.stereo_pair(T, 0.54)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.depth_map(T), j.depth_map(T))


def test_render_pool_renders_the_same_frames():
    """Inside corridor.render_pool, each corridor sequence renders on two
    spawned processes, a run of frames each, frame for frame as in-process
    (right images where each sequence has them)."""
    from trackingbench_slam_tpu_torch.utils import corridor
    cam = t_config.CameraConfig(width=160, height=96, fx=92.0, fy=92.0,
                                cx=78.5, cy=47.0, bf=92.0 * 0.54)
    cfg = dataclasses.replace(corridor.tracked_loop_config(), camera=cam)
    runs = (lambda: corridor.corridor_frames(cfg, 5)[0],
            lambda: corridor.tracked_loop_frames(cfg, 7)[0],
            lambda: corridor.direct_frames(cfg, 4)[0],
            lambda: corridor.indirect_frames(cfg, 3)[0],
            lambda: [(f, None) for f in corridor.mono_frames(cfg, 4)[0]])
    alone = [run() for run in runs]
    with corridor.render_pool(2):
        pooled = [run() for run in runs]
    for a, b in zip(alone, pooled):
        assert len(a) == len(b)
        for (la, ra), (lb, rb) in zip(a, b):
            assert la.dtype == lb.dtype and (ra is None) == (rb is None)
            np.testing.assert_array_equal(la, lb)
            if ra is not None:
                np.testing.assert_array_equal(ra, rb)
    # a right image on frame 0 and on each keyframe (every 3rd frame)
    assert [r is None for _, r in alone[0]] == [False, True, False, True,
                                                True]


def test_kitti_stereo_config_matches_reference():
    assert (dataclasses.asdict(t_config.kitti_stereo_config())
            == dataclasses.asdict(j_config.kitti_stereo_config()))


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_translation_matches_reference(delta, rng):
    from scipy.spatial.transform import Rotation
    T = np.tile(np.eye(4), (2, 12, 1, 1))
    T[..., :3, :3] = Rotation.from_rotvec(
        rng.randn(24, 3) * 0.1).as_matrix().reshape(2, 12, 3, 3)
    T[..., :3, 3] = rng.randn(2, 12, 3)
    got = t_metrics.rpe_translation(T[0], T[1], delta)
    assert abs(got - j_metrics.rpe_translation(T[0], T[1], delta)) < 1e-9
    assert got > 0 and t_metrics.rpe_translation(T[0], T[0], delta) < 1e-9


def test_demo_runs_on_the_cpu():
    assert demo.main(["--cpu", "--frames", "6"]) == 0
