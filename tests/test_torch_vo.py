"""The slice as a whole: the port's StereoVO against the JAX StereoVO on the
same small corridor, with windowed BA off and on; one track step and one
local BA step from a carried-over JAX state; the state converter; and the
port's guards (no JAX, no silent CPU, no distributed BA)."""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.geometry import camera as j_cam
from trackingbench_slam_tpu.models import local_mapping as j_lm
from trackingbench_slam_tpu.models.vo import StereoVO as JStereoVO
from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.models import local_mapping as t_lm
from trackingbench_slam_tpu_torch.models import vo as t_vo
from trackingbench_slam_tpu_torch.utils import metrics
from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       ExtractorConfig,
                                                       MapConfig,
                                                       MeshConfig,
                                                       PipelineConfig,
                                                       PyramidConfig,
                                                       SolverConfig)
from trackingbench_slam_tpu_torch.utils.convert import (vo_state_from_numpy,
                                                        vo_state_to_numpy)
from trackingbench_slam_tpu_torch.utils.corridor import corridor_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N_FRAMES = 7


def small_config(**kw):
    """bench.py's operating point at 320x240 with 256 features, BA off
    unless `kw` says otherwise."""
    fx = 707.09 * 320 / 1226
    cam = CameraConfig(width=320, height=240, fx=fx, fy=fx, cx=160.0,
                       cy=120.0, bf=fx * 0.54)
    return PipelineConfig(
        camera=cam, pyramid=PyramidConfig(num_levels=3, scale_factor=0.8),
        extractor=ExtractorConfig(num_features=256, min_threshold=12,
                                  cell_size=24),
        map=MapConfig(max_keyframes=8, max_points=2048),
        **dict(dict(keyframe_every=5, local_ba_every=0), **kw))


@pytest.fixture(scope="module")
def runs():
    cfg = small_config()
    frames, gt, _ = corridor_frames(cfg, N_FRAMES)
    jvo = JStereoVO(JConfig.from_json(cfg.to_json()))
    jstates = []
    for left, right in frames:
        jvo.track(left, right)
        jstates.append(jax.tree.map(np.asarray, jvo.state))
    tvo = t_vo.StereoVO(cfg, device="cpu")
    for left, right in frames:
        tvo.track(left, right)
    return cfg, frames, gt, jvo.poses(), jstates, tvo


def test_stereo_vo_tracks_reference_within_1cm(runs):
    cfg, frames, gt, P_j, _, tvo = runs
    P_t = tvo.poses()
    assert P_t.shape == (N_FRAMES, 4, 4) and np.isfinite(P_t).all()
    d = np.linalg.norm(metrics.trajectory_positions(P_t)
                       - metrics.trajectory_positions(P_j), axis=1)
    assert d.max() < 0.01, d
    assert metrics.ate_rmse(P_t, gt) < 0.01
    assert metrics.ate_rmse(P_j, gt) < 0.01
    assert int(tvo.state.num_inliers) > 100
    assert int(tvo.state.kfs.valid.sum()) == 2


def test_track_step_from_carried_reference_state(runs):
    cfg, frames, _, _, jstates, _ = runs
    state0 = vo_state_from_numpy(jstates[0], CPU)
    cam = t_cam.CameraParams.from_config(cfg.camera, CPU)
    gen = torch.Generator().manual_seed(0)
    out = t_vo.track_step(state0, torch.from_numpy(frames[1][0]), cam, cfg,
                          gen)
    T_t = out.T_cw.numpy().astype(np.float64)
    dT = np.linalg.inv(jstates[1].T_cw.astype(np.float64)) @ T_t
    rot = np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))
    assert np.linalg.norm(dT[:3, 3]) < 1e-3 and rot < 1e-3
    n_j = int(jstates[1].num_inliers)
    assert abs(int(out.num_inliers) - n_j) <= 0.1 * n_j
    assert int(out.frame_id) == int(jstates[1].frame_id)


@pytest.fixture(scope="module")
def ba_runs():
    """Windowed BA on every keyframe (a keyframe every 3rd frame: BA at
    frames 3 and 6), compacted to 512 landmarks."""
    cfg = small_config(keyframe_every=3, local_ba_every=1,
                       solver=SolverConfig(max_landmarks=512))
    frames, gt, _ = corridor_frames(cfg, N_FRAMES)
    jvo = JStereoVO(JConfig.from_json(cfg.to_json()))
    tvo = t_vo.StereoVO(cfg, device="cpu")
    for left, right in frames:
        jvo.track(left, right)
        tvo.track(left, right)
    return cfg, gt, jvo.poses(), tvo


def test_stereo_vo_with_local_ba_tracks_reference_within_1cm(ba_runs):
    cfg, gt, P_j, tvo = ba_runs
    assert tvo.ba_calls == 2
    P_t = tvo.poses()
    assert P_t.shape == (N_FRAMES, 4, 4) and np.isfinite(P_t).all()
    d = np.linalg.norm(metrics.trajectory_positions(P_t)
                       - metrics.trajectory_positions(P_j), axis=1)
    assert d.max() < 0.01, d
    assert metrics.ate_rmse(P_t, gt) < 0.01
    assert metrics.ate_rmse(P_j, gt) < 0.01
    assert int(tvo.state.kfs.valid.sum()) == 3


def test_local_ba_step_from_carried_reference_state(runs):
    """The BA-off run's last state (two keyframes, the bootstrap's and
    frame 5's) through one local BA step in both packages: live pose,
    ring poses within 1e-3 m and 1e-3 rad, landmarks within 1e-3 m."""
    _, _, _, _, jstates, _ = runs
    cfg = small_config(local_ba_every=1,
                       solver=SolverConfig(max_landmarks=512))
    jcfg = JConfig.from_json(cfg.to_json())
    js = jax.tree.map(jax.numpy.asarray, jstates[-1])
    ref = jax.tree.map(np.asarray, j_lm.local_ba_step(
        js, j_cam.CameraParams.from_config(jcfg.camera), jcfg))
    got = t_lm.local_ba_step(vo_state_from_numpy(jstates[-1], CPU),
                             t_cam.CameraParams.from_config(cfg.camera, CPU),
                             cfg)

    def close(T_t, T_j):
        dT = np.linalg.inv(T_j.astype(np.float64)) @ T_t.astype(np.float64)
        rot = np.arccos(np.clip((np.trace(dT[..., :3, :3], axis1=-2,
                                          axis2=-1) - 1) / 2, -1, 1))
        return max(np.abs(dT[..., :3, 3]).max(), np.max(rot))
    assert close(got.T_cw.numpy(), ref.T_cw) < 1e-3
    assert close(got.kfs.T_cw.numpy(), ref.kfs.T_cw) < 1e-3
    moved = np.abs(ref.map.pos - jstates[-1].map.pos).max(1) > 0
    assert moved.sum() > 100
    np.testing.assert_allclose(got.map.pos.numpy(), ref.map.pos, atol=1e-3)


def test_state_converter_round_trips_reference_state(runs):
    tree = runs[4][0]
    back = vo_state_to_numpy(vo_state_from_numpy(tree, CPU))
    flat_ref = jax.tree_util.tree_leaves_with_path(tree._asdict())
    assert len(flat_ref) > 30
    for path, ref in flat_ref:
        node = back
        for key in path:
            for attr in ("key", "name", "idx"):
                if hasattr(key, attr):
                    node = node[getattr(key, attr)]
                    break
        assert node.dtype == ref.dtype, path
        np.testing.assert_array_equal(node, ref)


def test_port_imports_no_jax():
    """Every module of the port imports with jax unimportable, and loads
    nothing of the JAX package; chip_smoke.py imports neither."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import trackingbench_slam_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'trackingbench_slam_tpu'\n"
        "       or m.startswith('trackingbench_slam_tpu.') or m == 'jax'\n"
        "       and sys.modules[m] is not None]\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('trackingbench_slam_tpu_torch')]), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) > 20
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert "trackingbench_slam_tpu_torch" in {n.split(".")[0] for n in names}
    for name in names:
        assert name.split(".")[0] not in ("jax", "trackingbench_slam_tpu",
                                          "bench"), name


def test_stereo_vo_needs_cuda_unless_asked_for_cpu():
    cfg = small_config()
    with pytest.raises(NotImplementedError, match="mesh.lm"):
        t_vo.StereoVO(PipelineConfig(camera=cfg.camera, local_ba_every=2,
                                     mesh=MeshConfig(lm=2)), device="cpu")
    vo = t_vo.StereoVO(cfg, device="cpu")
    assert vo.device.type == "cpu" and vo.cam.fx.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    for c in (cfg, small_config(local_ba_every=2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            t_vo.StereoVO(c)
