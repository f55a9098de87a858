"""The port's row writes with repeated targets against the reference's
scatters, and its host utilities: the upload prefetcher, checkpoints (its
own and the JAX package's npz layout), the profiling helpers and the
viewer."""

import dataclasses
import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.models import map as j_map
from trackingbench_slam_tpu.models.vo import StereoVO as JStereoVO
from trackingbench_slam_tpu.ops import packing as j_packing
from trackingbench_slam_tpu.utils import checkpoint as j_ckpt
from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
from trackingbench_slam_tpu_torch.models import map as t_map
from trackingbench_slam_tpu_torch.models.vo import StereoVO
from trackingbench_slam_tpu_torch.ops import packing
from trackingbench_slam_tpu_torch.utils import checkpoint as ckpt
from trackingbench_slam_tpu_torch.utils import metrics
from trackingbench_slam_tpu_torch.utils.convert import vo_state_to_numpy
from trackingbench_slam_tpu_torch.utils.corridor import corridor_frames
from trackingbench_slam_tpu_torch.utils.prefetch import DevicePrefetcher
from trackingbench_slam_tpu_torch.utils.profiling import StageTimer, fence
from trackingbench_slam_tpu_torch.viewer.viewer import Viewer
from tests.test_torch_vo import small_config

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


def t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


# --- row writes with repeated targets

def _rows(rng, n, rows):
    """Destinations with repeats, and some past the end (dropped). No
    negative ones: the reference wraps those, the port drops them, and no
    caller passes one."""
    idx = rng.randint(0, rows // 2, n).astype(np.int32)
    idx[rng.uniform(size=n) < 0.2] = rows
    idx[rng.uniform(size=n) < 0.1] = rows + 7
    return idx


def test_scatter_rows_set_with_repeated_targets_matches_reference(rng):
    """Four arrays of four dtypes, 64 sources onto 16 of 32 rows: every
    array equals the reference's packed scatter, and each written row
    comes whole from one source row (the last one naming it)."""
    rows, n = 32, 64
    dsts = [rng.normal(size=(rows, 3)).astype(np.float32),
            rng.randint(-9, 9, rows).astype(np.int32),
            rng.uniform(size=rows) > 0.5,
            rng.randint(0, 2 ** 32, (rows, 8), dtype=np.uint64
                        ).astype(np.uint32)]
    srcs = [rng.normal(size=(n, 3)).astype(np.float32),
            np.arange(n, dtype=np.int32) + 100,
            rng.uniform(size=n) > 0.5,
            rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64
                        ).astype(np.uint32)]
    idx = _rows(rng, n, rows)
    assert len(set(idx[(idx >= 0) & (idx < rows)])) < ((idx >= 0)
                                                        & (idx < rows)).sum()
    ref = [np.asarray(a) for a in j_packing.scatter_rows_set(
        [jnp.asarray(d) for d in dsts], jnp.asarray(idx),
        [jnp.asarray(s) for s in srcs])]
    got = packing.scatter_rows_set([t(d) for d in dsts], t(idx),
                                   [t(s) for s in srcs])
    for g, r in zip(got, ref):
        g = g.numpy()
        np.testing.assert_array_equal(g.view(r.dtype) if r.dtype == np.uint32
                                      else g, r)
    written = got[1].numpy() >= 100          # the source position + 100
    for row in np.nonzero(written)[0]:
        k = got[1].numpy()[row] - 100
        assert k == np.nonzero(idx == row)[0].max()
        np.testing.assert_array_equal(got[0].numpy()[row], srcs[0][k])
        np.testing.assert_array_equal(got[3].numpy()[row].view(np.uint32),
                                      srcs[3][k])


@pytest.mark.parametrize("shape", [(40,), (40, 8)])
def test_set_rows_with_repeated_targets_matches_reference(rng, shape):
    dst = rng.normal(size=shape).astype(np.float32)
    src = rng.normal(size=(90,) + shape[1:]).astype(np.float32)
    idx = _rows(rng, 90, shape[0])
    ref = np.asarray(jnp.asarray(dst).at[idx].set(src, mode="drop"))
    np.testing.assert_array_equal(
        t_map._set_rows(t(dst), t(idx), t(src)).numpy(), ref)
    ref = np.asarray(jnp.asarray(dst).at[idx].set(7.0, mode="drop"))
    np.testing.assert_array_equal(
        t_map._set_rows(t(dst), t(idx), 7.0).numpy(), ref)


def _assert_map_equal(mt, mj):
    for name, a in mj._asdict().items():
        a = np.asarray(a)
        b = getattr(mt, name).numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_add_observations_two_features_on_one_landmark_matches_reference(
        rng):
    """Features 3 and 9 of one keyframe observe landmark 5, and 4 and 6
    landmark 2 (a full list that ring-overwrites): both write the same
    (landmark, column) cell; the cell holds the last feature's keyframe,
    index and descriptor together, as the reference's packed scatter."""
    M, K, N = 12, 4, 16
    mj = j_map.empty_map(M, K)
    mt = t_map.empty_map(M, K, CPU)
    pidx = np.full(N, -1, np.int32)
    pidx[[3, 9]] = 5
    pidx[[4, 6]] = 2
    pidx[[1, 11]] = [7, 0]
    want = pidx >= 0
    desc = rng.randint(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    feat = np.arange(N, dtype=np.int32)
    for slot in range(6):       # landmark 2's list fills and wraps
        w = want if slot % 2 == 0 else want & (pidx == 2)
        mj = j_map.add_observations(mj, pidx, np.int32(slot), feat, w,
                                    desc=desc)
        mt = t_map.add_observations(mt, t(pidx), torch.tensor(slot),
                                    t(feat), t(w), desc=t(desc))
        _assert_map_equal(mt, mj)
    obs_feat = mt.obs_feat.numpy()
    obs_desc = mt.obs_desc.numpy().view(np.uint32)
    for m in (5, 2):
        for k in range(K):
            f = obs_feat[m, k]
            if f >= 0:      # the row is whole: its descriptor is feature f's
                np.testing.assert_array_equal(obs_desc[m, k], desc[f])
    assert obs_feat[5, 0] == 9


def test_replace_points_with_a_victim_named_twice_matches_reference():
    """Landmark 4 is fused into 1 by one pair and into 7 by a later one:
    the redirect takes the later keeper, as the reference's scatter."""
    M = 10
    mj = j_map.empty_map(M, 4)._replace(valid=jnp.ones(M, bool),
                                        n_visible=jnp.arange(M) + 1,
                                        n_found=jnp.arange(M) + 2)
    mt = t_map.empty_map(M, 4, CPU)._replace(
        valid=torch.ones(M, dtype=torch.bool),
        n_visible=torch.arange(M, dtype=torch.int32) + 1,
        n_found=torch.arange(M, dtype=torch.int32) + 2)
    old = np.array([4, 3, 4, 8], np.int32)
    new = np.array([1, 3, 7, 2], np.int32)
    want = np.array([True, True, True, False])
    mj2, rj = j_map.replace_points(mj, old, new, want)
    mt2, rt = t_map.replace_points(mt, t(old), t(new), t(want))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert int(rt[4]) == 7
    for name in ("valid", "n_visible", "n_found"):
        np.testing.assert_array_equal(getattr(mt2, name).numpy(),
                                      np.asarray(getattr(mj2, name)))


# --- prefetch

def test_device_prefetcher_returns_the_frames_on_the_cpu():
    frames = [(np.full((8, 8), i, np.uint8),
               np.full((8, 8), 100 + i, np.uint8) if i % 2 == 0 else None)
              for i in range(6)]
    with DevicePrefetcher(frames, depth=2, device="cpu") as pf:
        assert len(pf) == 6
        for i in range(6):
            L, R = pf[i]
            assert isinstance(L, torch.Tensor) and L.device == CPU
            assert L.dtype == torch.uint8 and int(L[0, 0]) == i
            if i % 2 == 0:
                assert int(R[0, 0]) == 100 + i
            else:
                assert R is None


def test_device_prefetcher_random_access_reschedules():
    frames = [(np.full((4, 4), i, np.float64), None) for i in range(5)]
    pf = DevicePrefetcher(frames, depth=1, device="cpu")
    L, _ = pf[3]           # never prefetched in order
    assert L.dtype == torch.float32 and float(L[0, 0]) == 3.0
    L, _ = pf[0]
    assert float(L[0, 0]) == 0.0
    pf.close()


def test_prefetched_frames_track_as_the_arrays_do():
    """StereoVO takes the prefetched tensors as they are: the poses equal
    the run fed with numpy arrays."""
    cfg = small_config()
    frames, _, _ = corridor_frames(cfg, 3)
    a, b = StereoVO(cfg, device="cpu"), StereoVO(cfg, device="cpu")
    with DevicePrefetcher(frames, depth=2, device="cpu") as pf:
        for i, (left, right) in enumerate(frames):
            a.track(left, right)
            b.track(*pf[i])
    np.testing.assert_array_equal(a.poses(), b.poses())


# --- checkpoint

@pytest.fixture(scope="module")
def tracked():
    """The port's StereoVO over 6 small corridor frames, its state saved
    after 4 (by the tests that need it)."""
    cfg = small_config()
    frames, gt, _ = corridor_frames(cfg, 6)
    vo = StereoVO(cfg, device="cpu")
    states = []
    for left, right in frames:
        vo.track(left, right)
        states.append((vo.state, list(vo.trajectory)))
    return cfg, frames, gt, states


def test_checkpoint_round_trip_and_resume(tracked, tmp_path):
    cfg, frames, gt, states = tracked
    state, traj = states[3]
    path = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(path, state, cfg, traj, step=4)
    state2, cfg2, traj2, step = ckpt.load_checkpoint(path, device="cpu")
    assert step == 4 and cfg2 == cfg
    np.testing.assert_array_equal(traj2, torch.stack(traj).numpy())
    a, b = vo_state_to_numpy(state), vo_state_to_numpy(state2)
    flat_a, flat_b = ckpt._flatten(a), ckpt._flatten(b)
    assert [n for n, _ in flat_a] == [n for n, _ in flat_b]
    for (name, x), (_, y) in zip(flat_a, flat_b):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    # resume tracking from the restored state
    vo = StereoVO(cfg2, device="cpu")
    vo.state = state2
    vo.trajectory = [torch.as_tensor(T) for T in traj2]
    for left, right in frames[4:]:
        vo.track(left, right)
    assert metrics.ate_rmse(vo.poses(), gt, align=True) < 0.02


def test_checkpoint_mismatch_raises(tracked, tmp_path):
    cfg, _, _, states = tracked
    path = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(path, states[0][0], cfg, step=1)
    meta_file = os.path.join(path, "meta.json")
    meta = json.load(open(meta_file))
    assert meta["leaf_count"] == len(meta["leaf_names"]) > 40
    # another schema version
    json.dump(dict(meta, state_schema_version=99), open(meta_file, "w"))
    with pytest.raises(ValueError, match="schema"):
        ckpt.load_checkpoint(path, device="cpu")
    # a leaf missing from the file
    json.dump(meta, open(meta_file, "w"))
    z = dict(np.load(os.path.join(path, "state.npz")))
    np.savez(os.path.join(path, "state.npz"),
             **{k: v for k, v in z.items() if k != f"leaf_{len(z) - 1}"})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_checkpoint(path, device="cpu")
    # a config whose state has other shapes
    np.savez(os.path.join(path, "state.npz"), **z)
    with open(os.path.join(path, "config.json"), "w") as fh:
        fh.write(dataclasses.replace(cfg, map=dataclasses.replace(
            cfg.map, max_points=1024)).to_json())
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(path, device="cpu")


def test_jax_written_checkpoint_loads_as_the_converter_reads_it(
        tracked, tmp_path, monkeypatch):
    """The JAX package's checkpoint of its StereoVO after 2 frames (the
    npz layout it writes without orbax) loads into the port's VOState
    equal, leaf for leaf, to the JAX state's numpy view."""
    cfg = tracked[0]
    frames = tracked[1]
    jcfg = JConfig.from_json(cfg.to_json())
    jvo = JStereoVO(jcfg)
    for left, right in frames[:2]:
        jvo.track(left, right)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    path = str(tmp_path / "jax_ckpt")
    j_ckpt.save_checkpoint(path, jvo.state, jcfg, jvo.trajectory, step=2)
    assert os.path.exists(os.path.join(path, "state.npz"))
    state, cfg2, traj, step = ckpt.load_checkpoint(path, device="cpu")
    assert step == 2 and cfg2 == cfg and traj.shape == (2, 4, 4)
    ref = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jvo.state))
    got = [x for _, x in ckpt._flatten(vo_state_to_numpy(state))]
    assert len(got) == len(ref)
    for x, r in zip(got, ref):
        assert x.dtype == r.dtype
        np.testing.assert_array_equal(x, r)


# --- profiling and viewer

def test_stage_timer_fence_and_trace():
    timer = StageTimer(device="cpu")
    x = torch.ones((64, 64))
    with timer.time("op"):
        y = x * 2
    with timer.time("op"):
        y = y + 1
    timer.add("other", 0.5)
    assert timer.counts == {"op": 2, "other": 1}
    assert timer.totals["other"] == 0.5 and timer.totals["op"] >= 0
    rep = timer.report()
    assert "op" in rep and "x2" in rep
    fence({"a": (y, [x])})
    timer.reset()
    assert timer.totals == {}


def test_profiling_and_prefetch_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from trackingbench_slam_tpu_torch.models.offline import OfflineStereoVO
    for make in (lambda: StageTimer(), lambda: DevicePrefetcher([]),
                 lambda: OfflineStereoVO(small_config())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_viewer_renders_frames(tmp_path):
    out = str(tmp_path / "viz")
    v = Viewer(out_dir=out, every=2)
    v.run()
    rng = np.random.RandomState(0)
    pts = rng.rand(100, 3) * 5
    for i in range(6):
        T = np.eye(4)
        T[0, 3] = -0.1 * i
        v.set_map_points(pts)
        v.set_camera_pose(T)
        v.set_keyframes(np.stack([T, T]), valid=np.array([True, False]))
    v.stop()
    assert not v._thread.is_alive()
    files = glob.glob(os.path.join(out, "frame_*.png"))
    assert len(files) >= 2, files


def test_repeat_check_finds_identical_runs_on_the_cpu(tmp_path, monkeypatch):
    """The repeat diagnostic at its CPU rehearsal size: three runs of the
    closer-less loop bench (the last two op-logged) agree frame by frame,
    state by state and op by op, and the result file says so."""
    from trackingbench_slam_tpu_torch import repeat_check
    monkeypatch.chdir(tmp_path)
    assert repeat_check.main(["--cpu-config", "--frames", "3", "--runs",
                              "3", "--op-log", "--label", "t"]) == 0
    out = json.load(open(tmp_path / "chiprun_out" / "repeat_check_t.json"))
    assert len(out["closing_err_m"]) == 3
    for cmp in out["against_first"] + [out["ops_second_against_third"]]:
        assert cmp["identical"] and cmp["max_pose_diff"] == 0.0, cmp
        assert "first_op" not in cmp
    a = np.array([1.0, np.nan, 2.0])
    assert not repeat_check._differ(a, a.copy()).any()
    assert repeat_check._differ(a, np.array([1.0, np.nan, 3.0]))[2]
