"""Multi-process start-up (parallel/multihost.py), the rank layout
(parallel/mesh.py) and the pipeline's sharded BA route (models/
local_mapping.py with mesh.lm > 1) on the CPU with gloo: initialize() is a
no-op without torchrun's environment and joins four ranks with it; the host
layout puts 'lm' on a node's ranks and trims it; local_ba_step at mesh.lm = 2
on a converted JAX state equals mesh.lm = 1 within tests/test_multihost.py's
bounds (poses 5e-4, landmarks 5e-3); an lm that does not divide
max_landmarks, or no process group, raises."""

import dataclasses
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.models import local_mapping as t_lm
from trackingbench_slam_tpu_torch.parallel import mesh as t_mesh
from trackingbench_slam_tpu_torch.parallel import multihost
from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       ExtractorConfig,
                                                       MapConfig,
                                                       MeshConfig,
                                                       PipelineConfig,
                                                       PyramidConfig,
                                                       SolverConfig)
from trackingbench_slam_tpu_torch.utils.convert import vo_state_from_numpy
from trackingbench_slam_tpu_torch.utils.corridor import corridor_frames

CPU = torch.device("cpu")
ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
       "LOCAL_WORLD_SIZE")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_config(**kw):
    """tests/test_torch_vo.py's 320x240 operating point (repeated here so
    that the ranks import torch alone, not the JAX package)."""
    fx = 707.09 * 320 / 1226
    cam = CameraConfig(width=320, height=240, fx=fx, fy=fx, cx=160.0,
                       cy=120.0, bf=fx * 0.54)
    return PipelineConfig(
        camera=cam, pyramid=PyramidConfig(num_levels=3, scale_factor=0.8),
        extractor=ExtractorConfig(num_features=256, min_threshold=12,
                                  cell_size=24),
        map=MapConfig(max_keyframes=8, max_points=2048),
        **dict(dict(keyframe_every=5, local_ba_every=0), **kw))


def _ba_config(lm=1, dp=1, max_landmarks=512):
    return small_config(local_ba_every=1,
                        solver=SolverConfig(max_landmarks=max_landmarks),
                        mesh=MeshConfig(lm=lm, dp=dp))


@pytest.fixture(scope="module")
def reference_state():
    """The JAX StereoVO's state after 4 corridor frames at 320x240: two
    keyframes (frames 0 and 3), BA off."""
    import jax
    from trackingbench_slam_tpu.models.vo import StereoVO as JStereoVO
    from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
    cfg = small_config(keyframe_every=3)
    frames, _, _ = corridor_frames(cfg, 4)
    jvo = JStereoVO(JConfig.from_json(cfg.to_json()))
    for left, right in frames:
        jvo.track(left, right)
    return jax.tree.map(np.asarray, jvo.state)


def _rank_main(rank, port, state_path, out_dir):
    """One of four torchrun-style ranks on two 'nodes' of two."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE="4",
                      LOCAL_RANK=str(rank % 2), LOCAL_WORLD_SIZE="2")
    assert multihost.initialize(device="cpu")
    assert multihost.initialize(device="cpu")          # idempotent
    try:
        host = multihost.make_host_mesh()
        trimmed = multihost.make_host_mesh(lm_per_host=1)
        everyone = t_mesh.make_mesh()
        with pytest.raises(ValueError):
            multihost.make_host_mesh(lm_per_host=3)
        # mesh.dp = 2 rows of mesh.lm = 2: each row solves the window
        cfg = _ba_config(lm=2, dp=2)
        state = torch.load(state_path, weights_only=False)
        out = t_lm.local_ba_step(state, t_cam.CameraParams.from_config(
            cfg.camera, CPU), cfg)
        torch.save(dict(host=host.grid, trimmed=trimmed.grid,
                        everyone=everyone.grid, lm_index=host.lm_index,
                        info=multihost.process_info(), T_cw=out.T_cw,
                        kfs_T_cw=out.kfs.T_cw, pos=out.map.pos),
                   os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference_state):
    d = tmp_path_factory.mktemp("multihost")
    # handed over as a file: pickling the state into each spawned rank
    # takes seconds
    torch.save(vo_state_from_numpy(reference_state, CPU), d / "state.pt")
    mp.spawn(_rank_main, args=(_free_port(), str(d / "state.pt"), str(d)),
             nprocs=4, join=True)
    return [torch.load(d / f"rank{r}.pt") for r in range(4)]


def test_initialize_without_environment_is_single_process(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert not dist.is_initialized()
    m = multihost.make_host_mesh()
    assert m.shape == {"dp": 1, "lm": 1} and m.groups == (None,)
    assert m.lm_index == 0 and m.lm_group is None
    info = multihost.process_info()
    assert info["process_index"] == 0 and info["process_count"] == 1
    with pytest.raises(ValueError):
        t_mesh.make_mesh(lm=2)


def test_host_layout_puts_lm_on_a_node_and_trims_it(ranks):
    for r, got in enumerate(ranks):
        assert got["host"] == ((0, 1), (2, 3))
        assert got["trimmed"] == ((0,), (2,))
        assert got["everyone"] == ((0, 1, 2, 3),)
        assert got["lm_index"] == r % 2
        assert got["info"]["process_index"] == r
        assert got["info"]["process_count"] == 4
        assert got["info"]["local_rank"] == r % 2
        assert got["info"]["local_process_count"] == 2


def test_local_ba_step_sharded_equals_one_device(ranks, reference_state):
    """mesh.lm = 2 (each rank its half of the 512-row window, the reduced
    system all-reduced) against the one-device solve, on every rank. The
    sharded solve damps the assembled diagonal of the reduced system, the
    one-device solve U's, as in the reference; landmarks ~18 m deep then
    part by up to ~1e-3 m."""
    cfg = _ba_config()
    one = t_lm.local_ba_step(vo_state_from_numpy(reference_state, CPU),
                             t_cam.CameraParams.from_config(cfg.camera, CPU),
                             cfg)
    moved = (one.map.pos - torch.from_numpy(np.array(
        reference_state.map.pos))).abs().amax(1) > 0
    assert int(moved.sum()) > 100
    for got in ranks:
        # the replicated state is the same on every rank, bit for bit
        assert torch.equal(got["T_cw"], ranks[0]["T_cw"])
        assert torch.equal(got["pos"], ranks[0]["pos"])
        np.testing.assert_allclose(got["T_cw"].numpy(), one.T_cw.numpy(),
                                   atol=5e-4)
        np.testing.assert_allclose(got["kfs_T_cw"].numpy(),
                                   one.kfs.T_cw.numpy(), atol=5e-4)
        np.testing.assert_allclose(got["pos"].numpy(), one.map.pos.numpy(),
                                   atol=5e-3)


def test_lm_must_divide_max_landmarks(reference_state):
    cfg = _ba_config(lm=2, max_landmarks=1001)
    with pytest.raises(AssertionError, match="max_landmarks"):
        t_lm.local_ba_step(vo_state_from_numpy(reference_state, CPU),
                           t_cam.CameraParams.from_config(cfg.camera, CPU),
                           cfg)


def test_lm_without_a_process_group_raises(reference_state):
    """No torch.distributed world: mesh.lm = 2 raises rather than run the
    one-device solve."""
    assert not dist.is_initialized()
    cfg = dataclasses.replace(_ba_config(lm=2))
    with pytest.raises(RuntimeError, match="mesh.lm = 2"):
        t_lm.local_ba_step(vo_state_from_numpy(reference_state, CPU),
                           t_cam.CameraParams.from_config(cfg.camera, CPU),
                           cfg)
