"""The port's monocular family against the JAX package on the CPU: DLT and
midpoint triangulation, pose recovery from an essential matrix (also with
the SVD's signs flipped), the bootstrap fed the reference's RANSAC draws,
one mono keyframe step from a carried-over JAX state, a short MonoVO run
(bootstrap, tracking, mono keyframes, windowed BA with two fixed poses) and
the state converter. The JAX package runs its TPU branches in interpret
mode (`reference_tpu_semantics`)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.geometry import camera as j_cam
from trackingbench_slam_tpu.geometry import epipolar as j_epi
from trackingbench_slam_tpu.geometry import se3 as j_se3
from trackingbench_slam_tpu.geometry import triangulation as j_tri
from trackingbench_slam_tpu.models import mono_vo as j_mv
from trackingbench_slam_tpu.models import vo as j_vo
from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.geometry import epipolar as t_epi
from trackingbench_slam_tpu_torch.geometry import triangulation as t_tri
from trackingbench_slam_tpu_torch.matchers import matcher as t_matcher
from trackingbench_slam_tpu_torch.models import mono_vo as t_mv
from trackingbench_slam_tpu_torch.ops import ransac as t_ransac
from trackingbench_slam_tpu_torch.utils import metrics
from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       ExtractorConfig,
                                                       MapConfig,
                                                       PipelineConfig,
                                                       PyramidConfig,
                                                       SolverConfig)
from trackingbench_slam_tpu_torch.utils.convert import (
    load_mono_vo_state, mono_vo_state_to_numpy, vo_state_from_numpy)
from trackingbench_slam_tpu_torch.utils.synthetic import (CorridorScene,
                                                          lateral_trajectory)
from tests.test_torch_align import reference_tpu_semantics

CPU = torch.device("cpu")
FX = 250.0
K = np.float32([[FX, 0, 160], [0, FX, 120], [0, 0, 1]])
N_FRAMES = 10
MIN_PARALLAX = 8.0


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
    """The JAX package's mono gate configuration (3 levels x0.8, cell 24,
    windowed BA on every 2nd keyframe) at 320x240 and 256 features, a
    keyframe every 2nd frame."""
    cam = CameraConfig(width=320, height=240, fx=FX, fy=FX, cx=160.0,
                       cy=120.0)
    return PipelineConfig(
        camera=cam, pyramid=PyramidConfig(num_levels=3, scale_factor=0.8),
        extractor=ExtractorConfig(num_features=256, min_threshold=10,
                                  cell_size=24),
        map=MapConfig(max_keyframes=8, max_points=2048),
        solver=SolverConfig(max_landmarks=512), keyframe_every=2,
        local_ba_every=2)


def _two_view(r, n=200, xi=(0.3, -0.05, 0.02, 0.02, 0.06, -0.01)):
    """Exact pixel matches of n points 4-12 m deep between the identity
    and T_21 = exp(xi)."""
    xn = (r.rand(n) - 0.5) * 1.0
    yn = (r.rand(n) - 0.5) * 0.7
    z = 4.0 + 8.0 * r.rand(n)
    X = np.stack([xn * z, yn * z, z], -1).astype(np.float32)
    T_21 = np.asarray(j_se3.exp(jnp.asarray(np.float32(xi))))
    p1 = X @ K.T
    p2 = (X @ T_21[:3, :3].T + T_21[:3, 3]) @ K.T
    px1 = (p1[:, :2] / p1[:, 2:3]).astype(np.float32)
    px2 = (p2[:, :2] / p2[:, 2:3]).astype(np.float32)
    valid = ((px1 > 8).all(1) & (px1 < [312, 232]).all(1)
             & (px2 > 8).all(1) & (px2 < [312, 232]).all(1))
    return X, T_21, px1, px2, valid


def test_triangulate_dlt_matches_reference():
    """Within 1e-4 of the point's depth in both views' geometry."""
    r = np.random.RandomState(0)
    X, T_21, px1, px2, _ = _two_view(r)
    px1 = px1 + r.normal(scale=0.3, size=px1.shape).astype(np.float32)
    P1 = K @ np.eye(4, dtype=np.float32)[:3]
    P2 = K @ T_21[:3]
    ref = np.asarray(j_tri.triangulate_dlt(jnp.asarray(P1), jnp.asarray(P2),
                                           jnp.asarray(px1),
                                           jnp.asarray(px2)))
    got = t_tri.triangulate_dlt(t(P1), t(P2), t(px1), t(px2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref[:, 2]).max())
    assert np.median(np.abs(ref - X).max(1) / X[:, 2]) < 0.02


def test_triangulate_midpoint_matches_reference():
    r = np.random.RandomState(1)
    X, T_21, px1, px2, _ = _two_view(r)
    Kinv = np.linalg.inv(K)

    def bearings(px):
        f = np.concatenate([px, np.ones_like(px[:, :1])], 1) @ Kinv.T
        return (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(
            np.float32)
    T_w1 = np.eye(4, dtype=np.float32)
    T_w2 = np.linalg.inv(T_21.astype(np.float64)).astype(np.float32)
    f1, f2 = bearings(px1), bearings(px2)
    f2[:5] = f1[:5]                       # parallel rays: not valid
    mj, vj = j_tri.triangulate_midpoint(jnp.asarray(T_w1), jnp.asarray(T_w2),
                                        jnp.asarray(f1), jnp.asarray(f2))
    mt, vt = t_tri.triangulate_midpoint(t(T_w1), t(T_w2), t(f1), t(f2))
    v = np.asarray(vj)
    assert 150 < v.sum() < len(v)
    np.testing.assert_array_equal(vt.numpy(), v)
    # near-parallel rays make the midpoint a difference of nearly equal
    # numbers: 5e-4 relative
    np.testing.assert_allclose(mt.numpy()[v], np.asarray(mj)[v], rtol=5e-4,
                               atol=1e-4)


def _flipped_svd(signs):
    """torch.linalg.svd with the singular vectors' signs flipped in pairs
    (U's column k and Vh's row k together), which leaves U S Vh unchanged:
    another valid SVD, as another library may return."""
    real = torch.linalg.svd

    def svd(A, *args, **kwargs):
        U, S, Vh = real(A, *args, **kwargs)
        s = torch.tensor(signs, dtype=A.dtype)
        return U * s, S, s[:, None] * Vh
    return svd


@pytest.mark.parametrize("signs", [None, (-1.0, 1.0, 1.0), (1.0, -1.0, -1.0),
                                   (-1.0, -1.0, -1.0)])
def test_recover_pose_matches_reference(monkeypatch, signs):
    """The chosen pose within 1e-4 and the same cheirality mask, also when
    the SVD's sign choices differ from the reference's."""
    r = np.random.RandomState(2)
    X, T_21, px1, px2, valid = _two_view(r)
    tx = T_21[:3, 3]
    E = (np.float32([[0, -tx[2], tx[1]], [tx[2], 0, -tx[0]],
                     [-tx[1], tx[0], 0]]) @ T_21[:3, :3]).astype(np.float32)
    E += r.normal(scale=1e-4, size=E.shape).astype(np.float32)
    Tj, Xj, gj = j_epi.recover_pose(jnp.asarray(E), jnp.asarray(K),
                                    jnp.asarray(px1), jnp.asarray(px2),
                                    jnp.asarray(valid))
    if signs is not None:
        monkeypatch.setattr(torch.linalg, "svd", _flipped_svd(signs))
    Tt, Xt, gt_ = t_epi.recover_pose(t(E), t(K), t(px1), t(px2), t(valid))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_array_equal(gt_.numpy(), np.asarray(gj))
    g = np.asarray(gj)
    assert g.sum() > 0.9 * valid.sum()
    np.testing.assert_allclose(Xt.numpy()[g], np.asarray(Xj)[g], rtol=1e-3,
                               atol=1e-3)
    # and it is the true pose, up to the scale of t
    np.testing.assert_allclose(Tt.numpy()[:3, :3], T_21[:3, :3], atol=2e-3)


def test_mono_bootstrap_with_reference_draws():
    """The reference's own bootstrap case (its test's seeds), the port fed
    the reference's draws: the same cheirality mask on >= 99% of matches,
    the pose within 2e-3 and both within 0.1 degree and 0.999 of the true
    rotation and direction of travel. The 8-point F of one sample differs
    between the packages by ~1e-3 after normalization (float32 inverse
    iteration), which moves the pose that much."""
    r = np.random.RandomState(0)
    X, T_21, px1, px2, valid = _two_view(r)
    key = jax.random.PRNGKey(0)
    Tj, Xj, gj, okj = j_epi.mono_bootstrap(
        jnp.asarray(K), jnp.asarray(px1), jnp.asarray(px2),
        jnp.asarray(valid), key)
    draws = np.asarray(jax.random.uniform(key, (256, len(px1)), minval=1e-9,
                                          maxval=1.0))
    Tt, Xt, gt_, okt = t_epi.mono_bootstrap(t(K), t(px1), t(px2), t(valid),
                                            uniform=t(draws))
    assert bool(okj) and bool(okt)
    g = np.asarray(gj)
    assert (gt_.numpy() == g).mean() >= 0.99 and g.sum() > 0.9 * valid.sum()
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=2e-3)
    t_true = T_21[:3, 3] / np.linalg.norm(T_21[:3, 3])
    for T in (Tt.numpy(), np.asarray(Tj)):
        dR = T[:3, :3].T @ T_21[:3, :3]
        assert np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1,
                                            1))) < 0.1
        assert abs(T[:3, 3] @ t_true) > 0.999
    both = g & gt_.numpy()
    np.testing.assert_allclose(Xt.numpy()[both], np.asarray(Xj)[both],
                               rtol=1e-2)


class ReferenceDraws:
    """The RANSAC draws of the reference's MonoVO, in its order: the
    bootstrap attempts split a key seeded 7, the tracking steps the state's
    key seeded 0. Installed as the port's draw functions."""

    def __init__(self):
        self.keys = {"bootstrap": jax.random.PRNGKey(7),
                     "track": jax.random.PRNGKey(0)}

    def drawer(self, chain):
        def draw(num_samples, n, generator, device):
            self.keys[chain], sub = jax.random.split(self.keys[chain])
            return t(jax.random.uniform(sub, (num_samples, n), minval=1e-9,
                                        maxval=1.0)).to(device)
        return draw


@pytest.fixture(scope="module")
def sequence():
    """Lateral corridor frames; the JAX MonoVO run under its TPU branches
    with its state after every frame; and, for the first keyframe after the
    bootstrap, the JAX track step's output and the JAX mono keyframe step
    on it."""
    cfg = small_config()
    jcfg = JConfig.from_json(cfg.to_json())
    gt = lateral_trajectory(N_FRAMES, step=0.06, yaw_amp=0.01)
    sc = CorridorScene(cfg.camera)
    frames = [np.clip(sc.render(T), 0, 255).astype(np.uint8) for T in gt]
    with reference_tpu_semantics():
        jvo = j_mv.MonoVO(jcfg, min_parallax_px=MIN_PARALLAX)
        snaps, kf_case = [], None
        for i, img in enumerate(frames):
            before = copy.copy(jvo)
            jvo.track(img)
            snaps.append(copy.copy(jvo))
            if (kf_case is None and before.initialized
                    and (before._fid + 1) % cfg.keyframe_every == 0):
                cam = j_cam.CameraParams.from_config(jcfg.camera)
                tracked = j_vo.track_step(before.state, jnp.asarray(
                    img, jnp.float32), cam, jcfg)
                out = j_mv.mono_keyframe_step(tracked, before._kf_lk_pyr,
                                              before._kf_T_cw, cam, jcfg)
                kf_case = (i, jax.tree.map(np.asarray, tracked),
                           tuple(np.asarray(p) for p in before._kf_lk_pyr),
                           np.asarray(before._kf_T_cw),
                           jax.tree.map(np.asarray, out))
    return cfg, frames, gt, jvo, snaps, kf_case


def test_mono_keyframe_step_from_carried_reference_state(sequence):
    """The JAX track step's output through the mono keyframe step in both
    packages: the same landmark rows and links, landmarks within 1e-3 m,
    the same keyframe slot."""
    cfg, _, _, _, _, kf_case = sequence
    assert kf_case is not None, "no keyframe after the bootstrap"
    _, tracked, kf_pyr, kf_T, ref = kf_case
    cam = t_cam.CameraParams.from_config(cfg.camera, CPU)
    out = t_mv.mono_keyframe_step(vo_state_from_numpy(tracked, CPU),
                                  tuple(t(p) for p in kf_pyr), t(kf_T), cam,
                                  cfg)
    new = ref.map.valid & ~tracked.map.valid
    assert new.sum() > 10
    np.testing.assert_array_equal(out.map.valid.numpy(), ref.map.valid)
    np.testing.assert_array_equal(out.prev.map_idx.numpy(), ref.prev.map_idx)
    live = ref.map.valid
    np.testing.assert_allclose(out.map.pos.numpy()[live], ref.map.pos[live],
                               atol=1e-3)
    np.testing.assert_array_equal(out.kfs.valid.numpy(), ref.kfs.valid)
    np.testing.assert_array_equal(out.kfs.frame_id.numpy(), ref.kfs.frame_id)


def test_mono_vo_tracks_reference_within_1cm(sequence, monkeypatch):
    """The same frames, the port drawing the reference's RANSAC samples:
    it bootstraps on the same frame and stays within 1 cm."""
    cfg, frames, gt, jvo, _, _ = sequence
    draws = ReferenceDraws()
    monkeypatch.setattr(t_ransac, "draw_uniform", draws.drawer("bootstrap"))
    monkeypatch.setattr(t_matcher, "draw_uniform", draws.drawer("track"))
    vo = t_mv.MonoVO(cfg, min_parallax_px=MIN_PARALLAX, device="cpu")
    for img in frames:
        vo.track(img)
    assert vo.initialized and jvo.initialized
    P_t, P_j = vo.poses(), jvo.poses()
    assert P_t.shape == (N_FRAMES, 4, 4) and np.isfinite(P_t).all()
    k0 = next(i for i in range(1, N_FRAMES)
              if not np.allclose(P_j[i], np.eye(4)))
    assert not np.allclose(P_t[k0], np.eye(4))
    d = np.linalg.norm(metrics.trajectory_positions(P_t)
                       - metrics.trajectory_positions(P_j), axis=1)
    assert d.max() < 0.01, d
    assert metrics.ate_rmse(P_t[k0:], gt[k0:], align=True,
                            with_scale=True) < 0.02
    n_t, n_j = int(vo.state.map.valid.sum()), int(jvo.state.map.valid.sum())
    assert abs(n_t - n_j) <= 0.05 * n_j
    assert vo.kf_count == jvo._kf_count
    assert vo.ba_calls == jvo._kf_count // cfg.local_ba_every > 0


def test_mono_state_converter_round_trips(sequence):
    cfg, _, _, _, snaps, _ = sequence
    vo = t_mv.MonoVO(cfg, device="cpu")
    load_mono_vo_state(vo, snaps[-1])
    tree = mono_vo_state_to_numpy(vo)
    again = t_mv.MonoVO(cfg, device="cpu")
    load_mono_vo_state(again, tree)
    back = mono_vo_state_to_numpy(again)
    assert back["initialized"] and back["fid"] == N_FRAMES
    assert back["kf_count"] == tree["kf_count"] == snaps[-1]._kf_count
    np.testing.assert_array_equal(back["kf_T_cw"], tree["kf_T_cw"])
    np.testing.assert_array_equal(back["kf_T_cw"],
                                  np.asarray(snaps[-1]._kf_T_cw))
    for a, b in zip(back["kf_lk_pyr"], tree["kf_lk_pyr"]):
        np.testing.assert_array_equal(a, b)
    for name, v in tree["f0"].items():
        if not isinstance(v, tuple):
            np.testing.assert_array_equal(back["f0"][name], v)
    np.testing.assert_array_equal(back["state"]["map"]["pos"],
                                  np.asarray(snaps[-1].state.map.pos))
    assert back["state"]["prev"]["desc"].dtype == np.uint32
    assert len(back["trajectory"]) == N_FRAMES
