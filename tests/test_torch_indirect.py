"""The port's indirect (extract and match every frame) family against the
JAX package on the CPU: the cross-check and the four descriptor matchers
(index-exact), one `indirect_track_step` from a carried-over JAX state for
each of the five strategies, and a short IndirectVO run. The JAX package
runs its TPU branches in interpret mode (`reference_tpu_semantics`): its
CPU branch describes ORB keypoints differently, and descriptor matching
is sensitive to that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.bow import vocabulary as j_bow
from trackingbench_slam_tpu.geometry import camera as j_cam
from trackingbench_slam_tpu.geometry import se3 as j_se3
from trackingbench_slam_tpu.matchers import matcher as j_matcher
from trackingbench_slam_tpu.models import indirect_vo as j_iv
from trackingbench_slam_tpu.models.extractors import extract_orb as j_orb
from trackingbench_slam_tpu.models.frame import FrameState as JFrameState
from trackingbench_slam_tpu.models.frame import make_frame as j_make_frame
from trackingbench_slam_tpu.ops import hamming as j_ham
from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.matchers import matcher as t_matcher
from trackingbench_slam_tpu_torch.models import indirect_vo as t_iv
from trackingbench_slam_tpu_torch.models.frame import FrameState
from trackingbench_slam_tpu_torch.ops import hamming as t_ham
from trackingbench_slam_tpu_torch.utils import metrics
from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       ExtractorConfig,
                                                       MapConfig,
                                                       MatcherConfig,
                                                       PipelineConfig,
                                                       PyramidConfig)
from trackingbench_slam_tpu_torch.utils.convert import (vo_state_from_numpy,
                                                        vocabulary_from_numpy)
from trackingbench_slam_tpu_torch.utils.synthetic import (
    CorridorScene, forward_yaw_trajectory)
from tests.test_torch_align import reference_tpu_semantics

CPU = torch.device("cpu")
N_FRAMES = 4
STRATEGIES = [s.value for s in t_iv.MatchStrategy]


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
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def small_config():
    """The JAX package's indirect corridor configuration (3 levels x0.8,
    cell 24) at 320x240 and 256 features."""
    cam = CameraConfig(width=320, height=240, fx=250.0, fy=250.0, cx=160.0,
                       cy=120.0, bf=250.0 * 0.3)
    return PipelineConfig(
        camera=cam, pyramid=PyramidConfig(num_levels=3, scale_factor=0.8),
        extractor=ExtractorConfig(num_features=256, min_threshold=10,
                                  cell_size=24),
        map=MapConfig(max_keyframes=8, max_points=2048), keyframe_every=1,
        local_ba_every=0)


def test_mutual_best_matches_reference():
    r = np.random.RandomState(0)
    d = r.randint(0, 12, (70, 90)).astype(np.float32)   # many ties
    d[:, 5] = 10_000.0
    idx_j, best_j, mut_j = j_ham.mutual_best(jnp.asarray(d))
    idx_t, best_t, mut_t = t_ham.mutual_best(t(d))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(best_t.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(mut_t.numpy(), np.asarray(mut_j))
    assert 0 < int(mut_j.sum()) < 70


def _two_views(r, n1=150, n2=170, M=400):
    """Two frames seeing a common set of landmarks: view 2 links its
    features to their landmarks; view 1's features are a shuffled subset
    seen 3 cm and 0.5 degrees away, their descriptors a few bits off, plus
    unrelated features. Returns numpy fields of both frames and the map."""
    pos = np.stack([r.uniform(-3, 3, M), r.uniform(-2, 2, M),
                    r.uniform(4, 12, M)], -1).astype(np.float32)
    words = r.randint(0, 2 ** 32, (M, 8), dtype=np.uint64).astype(np.uint32)
    angle = r.uniform(0, 2 * np.pi, M).astype(np.float32)
    T2 = np.eye(4, dtype=np.float32)
    T1 = np.asarray(j_se3.exp(jnp.asarray(
        np.float32([0.03, 0.0, 0.01, 0.0, 0.009, 0.0]))))
    K = np.float32([[250, 0, 160], [0, 250, 120], [0, 0, 1]])

    def project(T, p):
        q = (p @ T[:3, :3].T + T[:3, 3]) @ K.T
        return q[:, :2] / q[:, 2:3]

    def flip(w, bits):
        w = w.copy()
        for row in w:
            for b in r.randint(0, 256, bits):
                row[b // 32] ^= np.uint32(1 << (b % 32))
        return w

    lm2 = r.choice(M, n2, replace=False)
    lm1 = np.concatenate([r.choice(lm2, n1 - 30, replace=False),
                          r.choice(np.setdiff1d(np.arange(M), lm2), 30,
                                   replace=False)])
    r.shuffle(lm1)
    level = r.randint(0, 3, M).astype(np.int32)

    def frame(lm, T, bits):
        n = len(lm)
        xy = project(T, pos[lm]) + r.normal(scale=0.5, size=(n, 2))
        return dict(kp_xy=xy.astype(np.float32), kp_level=level[lm],
                    kp_angle=(angle[lm] + r.normal(scale=0.05, size=n)
                              + 0.3).astype(np.float32) % np.float32(6.28),
                    desc=flip(words[lm], bits),
                    valid=r.uniform(size=n) > 0.07, T_cw=T)

    f1 = frame(lm1, T1, 6)
    f2 = frame(lm2, T2, 0)
    f2["map_idx"] = np.where(r.uniform(size=n2) > 0.15, lm2, -1).astype(
        np.int32)
    f1["map_idx"] = np.full(n1, -1, np.int32)
    return f1, f2, pos


def _frames(f):
    """The same frame as the JAX package's FrameState and the port's."""
    n = f["kp_xy"].shape[0]
    full = dict(f, kp_response=np.ones(n, np.float32),
                bearing=np.zeros((n, 3), np.float32))
    tree = {k: full[k] for k in JFrameState._fields
            if k not in ("pyramid", "lk_pyr")}
    jf = JFrameState(pyramid=(), lk_pyr=(),
                     **{k: jnp.asarray(v) for k, v in tree.items()})
    tf = FrameState(pyramid=(), lk_pyr=(),
                    **{k: t(v) for k, v in tree.items()})
    return jf, tf


@pytest.mark.parametrize("strategy", ["nn", "bf", "window", "projection"])
def test_descriptor_matcher_matches_reference(strategy):
    r = np.random.RandomState(3)
    f1, f2, pos = _two_views(r)
    j1, t1 = _frames(f1)
    j2, t2 = _frames(f2)
    cfg = MatcherConfig()
    jcfg = JConfig().matcher
    if strategy == "nn":
        ref = j_matcher.search_by_nn(j1.desc, j1.valid, j2.desc, j2.valid,
                                     j2.kp_level, j2.map_idx, jcfg)
        got = t_matcher.search_by_nn(t1.desc, t1.valid, t2.desc, t2.valid,
                                     cfg)
    elif strategy == "bf":
        ref = j_matcher.search_by_bf(j1.desc, j1.valid, j2.desc, j2.valid,
                                     jcfg)
        got = t_matcher.search_by_bf(t1.desc, t1.valid, t2.desc, t2.valid,
                                     cfg)
    elif strategy == "window":
        ref = j_matcher.search_by_window(j1, j2, jcfg)
        got = t_matcher.search_by_window(t1, t2, cfg)
    else:
        ccfg = CameraConfig(width=320, height=240, fx=250.0, fy=250.0,
                            cx=160.0, cy=120.0)
        j_c = j_cam.CameraParams.from_config(
            JConfig.from_json(PipelineConfig(camera=ccfg).to_json()).camera)
        t_c = t_cam.CameraParams.from_config(ccfg, CPU)
        ref = j_matcher.search_by_projection_frame(
            j_c, j1, j2, jnp.asarray(pos), jcfg, 0.8, 3)
        got = t_matcher.search_by_projection_frame(t_c, t1, t2, t(pos), cfg,
                                                   0.8)
    ok = np.asarray(ref.ok)
    assert 20 < ok.sum() < len(ok)
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))


# --- the tracker


@pytest.fixture(scope="module")
def sequence():
    """Stereo corridor frames, the JAX run's states (its indirect_track_step
    runs unfused, so that its jitted parts compile once for all five
    strategies), and a vocabulary trained on the JAX package's ORB of every
    3rd left image."""
    cfg = small_config()
    jcfg = JConfig.from_json(cfg.to_json())
    sc = CorridorScene(cfg.camera)
    gt = forward_yaw_trajectory(N_FRAMES, step=0.08, yaw_rate=0.012)

    def u8(a):
        return np.clip(a, 0, 255).astype(np.uint8)
    frames = [tuple(u8(x) for x in sc.stereo_pair(T, 0.3)) for T in gt]
    j_c = j_cam.CameraParams.from_config(jcfg.camera)
    with reference_tpu_semantics():
        descs = []
        for left, _ in frames[::3]:
            f = j_orb(j_make_frame(jnp.asarray(left), 256, 3, 0.8), j_c,
                      jcfg.extractor, jcfg.pyramid)
            descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
        voc = j_bow.train(np.concatenate(descs)[:4000], branching=6, depth=3,
                          seed=0)
        step = j_iv.indirect_track_step.__wrapped__
        real = j_iv.indirect_track_step
        j_iv.indirect_track_step = step
        try:
            jvo = j_iv.IndirectVO(jcfg, j_iv.MatchStrategy.NN)
            states = []
            for left, right in frames:
                jvo.track(left, right)
                states.append(jax.tree.map(np.asarray, jvo.state))
            steps = {}
            for s in STRATEGIES:
                out = step(jax.tree.map(jnp.asarray, states[0]),
                           jnp.asarray(frames[1][0]),
                           jnp.asarray(frames[1][1]), j_c, jcfg, strategy=s,
                           voc=voc if s == "bow" else None)
                steps[s] = jax.tree.map(np.asarray, out)
        finally:
            j_iv.indirect_track_step = real
    return cfg, frames, gt, jvo.poses(), states, steps, voc


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_indirect_track_step_from_carried_reference_state(sequence,
                                                          strategy):
    """Frame 1 from the JAX state after the bootstrap keyframe, each
    strategy: pose within 1e-4 (m and rotation entries), the same inliers
    and landmark links, landmarks within 1e-3 m."""
    cfg, frames, _, _, states, steps, voc = sequence
    cam = t_cam.CameraParams.from_config(cfg.camera, CPU)
    out = t_iv.indirect_track_step(
        vo_state_from_numpy(states[0], CPU), t(frames[1][0]),
        t(frames[1][1]), cam, cfg, strategy=strategy,
        voc=vocabulary_from_numpy(voc, CPU) if strategy == "bow" else None)
    ref = steps[strategy]
    assert int(ref.num_inliers) > 30
    np.testing.assert_allclose(out.T_cw.numpy(), ref.T_cw, atol=1e-4)
    assert int(out.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(out.prev.map_idx.numpy(), ref.prev.map_idx)
    np.testing.assert_array_equal(out.map.valid.numpy(), ref.map.valid)
    live = ref.map.valid
    np.testing.assert_allclose(out.map.pos.numpy()[live], ref.map.pos[live],
                               atol=1e-3)
    assert int(out.frame_id) == int(ref.frame_id)


def test_indirect_vo_tracks_reference_within_1cm(sequence):
    cfg, frames, gt, P_j, _, _, _ = sequence
    vo = t_iv.IndirectVO(cfg, t_iv.MatchStrategy.NN, device="cpu")
    for left, right in frames:
        vo.track(left, right)
    P_t = vo.poses()
    assert P_t.shape == (N_FRAMES, 4, 4) and np.isfinite(P_t).all()
    d = np.linalg.norm(metrics.trajectory_positions(P_t)
                       - metrics.trajectory_positions(P_j), axis=1)
    assert d.max() < 0.01, d
    assert metrics.ate_rmse(P_t, gt, align=True) < 0.02
    assert int(vo.state.num_inliers) > 30


def test_euroc_config_is_the_references():
    from trackingbench_slam_tpu.utils.config import euroc_stereo_config as j
    from trackingbench_slam_tpu_torch.utils.config import euroc_stereo_config
    assert euroc_stereo_config().to_json() == j().to_json()


def test_bow_strategy_needs_a_vocabulary():
    with pytest.raises(ValueError, match="Vocabulary"):
        t_iv.IndirectVO(small_config(), t_iv.MatchStrategy.BOW, device="cpu")
