"""The port's OfflineStereoVO: the live loop's cadence, the live loop's
trajectory exactly, dense and sparse right images alike, and the JAX
OfflineStereoVO within the tolerance the StereoVO tests use."""

import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.models.offline import \
    OfflineStereoVO as JOfflineStereoVO
from trackingbench_slam_tpu.models.offline import \
    sequence_schedule as j_schedule
from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
from trackingbench_slam_tpu_torch.models.offline import (OfflineStereoVO,
                                                         sequence_schedule)
from trackingbench_slam_tpu_torch.models.vo import StereoVO
from trackingbench_slam_tpu_torch.utils import metrics
from trackingbench_slam_tpu_torch.utils.config import SolverConfig
from trackingbench_slam_tpu_torch.utils.corridor import (BASELINE,
                                                         corridor_frames)
from tests.test_torch_vo import small_config

N_FRAMES = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager steps are thousands of small ops: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ba_config():
    """A keyframe every 3rd frame, windowed BA on each (frames 2 and 5 of
    the scan), compacted to 512 landmarks."""
    return small_config(keyframe_every=3, local_ba_every=1,
                        solver=SolverConfig(max_landmarks=512))


@pytest.fixture(scope="module")
def sequence():
    cfg = ba_config()
    frames, gt, scene = corridor_frames(cfg, N_FRAMES)
    return cfg, frames, gt, scene


@pytest.mark.parametrize("kf_every,ba_every,n", [(5, 2, 16), (3, 1, 7),
                                                 (4, 0, 13), (2, 3, 20)])
def test_schedule_matches_live_cadence(kf_every, ba_every, n):
    cfg = small_config(keyframe_every=kf_every, local_ba_every=ba_every)
    got = sequence_schedule(cfg, n)
    want = j_schedule(JConfig.from_json(cfg.to_json()), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # and the live loop's own counters: keyframes and BA calls
    is_kf, right_idx, do_ba = got
    fid = np.arange(2, n + 1)
    np.testing.assert_array_equal(is_kf, fid % kf_every == 0)
    np.testing.assert_array_equal(right_idx[is_kf],
                                  np.arange(1, is_kf.sum() + 1))
    if kf_every == 5:   # frames 4, 9, 14; BA at the 2nd: frame 9
        assert list(np.nonzero(is_kf)[0] + 1) == [4, 9, 14]
        assert list(np.nonzero(do_ba)[0] + 1) == [9]


def test_offline_trajectory_equals_live_loop(sequence):
    """The same steps in the same order with the same draws: every pose,
    the inlier counts and the final map equal the live StereoVO's."""
    cfg, frames, gt, _ = sequence
    live = StereoVO(cfg, device="cpu")
    inliers = []
    for left, right in frames:
        live.track(left, right)
        inliers.append(int(live.state.num_inliers))
    off = OfflineStereoVO(cfg, device="cpu")
    res = off.run(frames)
    assert live.ba_calls == 2
    assert res.T_cw.shape == (N_FRAMES - 1, 4, 4)
    np.testing.assert_array_equal(
        torch.cat([off._T0[None], res.T_cw]).numpy(),
        torch.stack(live.trajectory).numpy())
    np.testing.assert_array_equal(res.num_inliers.numpy(), inliers[1:])
    np.testing.assert_array_equal(off.poses(), live.poses())
    np.testing.assert_array_equal(off.poses(refine_with_keyframes=False),
                                  live.poses(refine_with_keyframes=False))
    for name in ("pos", "valid", "obs_kf", "obs_desc"):
        assert torch.equal(getattr(res.state.map, name),
                           getattr(live.state.map, name)), name
    assert metrics.ate_rmse(off.poses(), gt, align=True) < 0.01


def test_offline_dense_rights_equal_sparse_rights(sequence):
    """A right image on every frame gives the run that right images on the
    schedule's keyframes give: prepare stacks only the ones it uses."""
    cfg, frames, gt, scene = sequence
    dense = [(left, right if right is not None else np.clip(
        scene.stereo_pair(T, BASELINE)[1], 0, 255).astype(np.uint8))
        for (left, right), T in zip(frames, gt)]
    a = OfflineStereoVO(cfg, device="cpu")
    a.run(frames)
    b = OfflineStereoVO(cfg, device="cpu")
    prepared = b.prepare(dense)
    assert prepared[1].shape[0] == 1 + int(prepared[2].sum())
    b.run(prepared=prepared)
    np.testing.assert_array_equal(a.poses(), b.poses())
    with pytest.raises(ValueError, match="keyframe"):
        OfflineStereoVO(cfg, device="cpu").prepare(
            [f if i != 2 else (f[0], None) for i, f in enumerate(frames)])
    with pytest.raises(ValueError, match="frame 0"):
        OfflineStereoVO(cfg, device="cpu").prepare(
            [(frames[0][0], None)] + frames[1:])


def test_offline_tracks_reference_offline_within_1cm(sequence):
    cfg, frames, gt, _ = sequence
    jvo = JOfflineStereoVO(JConfig.from_json(cfg.to_json()))
    jres = jvo.run(frames)
    P_j = jvo.poses()
    off = OfflineStereoVO(cfg, device="cpu")
    off.run(frames)
    P_t = off.poses()
    assert P_t.shape == P_j.shape == (N_FRAMES, 4, 4)
    d = np.linalg.norm(metrics.trajectory_positions(P_t)
                       - metrics.trajectory_positions(P_j), axis=1)
    assert d.max() < 0.01, d
    assert metrics.ate_rmse(P_t, gt) < 0.01
    assert metrics.ate_rmse(P_j, gt) < 0.01
    assert int(np.asarray(jres.num_inliers)[-1]) > 100
    assert int(off.result.num_inliers[-1]) > 100
