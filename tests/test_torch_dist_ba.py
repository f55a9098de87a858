"""Landmark-sharded BA over torch.distributed (parallel/dist_ba.py) on the
CPU with gloo: the partitioner gives the JAX arrays exactly, and the flat
and grouped solves at world 1, 2 and 4 equal the port's single-device
solves and JAX's distributed solves on its 8-virtual-device mesh within
5e-4 (the bound of tests/test_dist_ba.py); a NaN step confined to one shard
is rejected on every rank. One spawn of four processes serves the module
(file:// rendezvous, one torch thread a rank); the JAX package is imported
only in the parent, so the ranks start with torch alone."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.geometry import se3 as t_se3
from trackingbench_slam_tpu_torch.parallel import dist_ba
from trackingbench_slam_tpu_torch.solvers import local_ba
from trackingbench_slam_tpu_torch.utils.config import CameraConfig

CPU = torch.device("cpu")
WORLDS = (1, 2, 4)
FLAT_CAM = CameraConfig(width=640, height=480, fx=500.0, fy=500.0, cx=320.0,
                        cy=240.0)
GROUPED_CAM = CameraConfig(width=512, height=384, fx=400.0, fy=400.0,
                           cx=256.0, cy=192.0, bf=400.0 * 0.3)
FLAT_KW = dict(iters=12, num_fixed=2)
GROUPED_KW = dict(iters=10, num_fixed=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The ranks run one torch thread each; so does the parent, so that a
    world of one sums in the same order in both."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(tree, cls):
    return cls(**{k: None if v is None else torch.from_numpy(np.array(v))
                  for k, v in tree.items()})


def _solves(rank, flat, grouped):
    """This rank's flat and grouped solves on its shard at every world it
    belongs to."""
    fcam = t_cam.CameraParams.from_config(FLAT_CAM, CPU)
    gcam = t_cam.CameraParams.from_config(GROUPED_CAM, CPU)
    groups = {1: dist.new_group([0]), 2: dist.new_group([0, 1]),
              4: dist.group.WORLD}
    out = {}
    for w, group in groups.items():
        if rank >= w:
            continue
        sp = dist_ba.partition_problem(_t(flat, local_ba.BAProblem), w)
        out["flat", w] = dist_ba.distributed_bundle_adjust(
            group, fcam, dist_ba.local_shard(sp, w, rank), **FLAT_KW)
        gp = dist_ba.row_block(_t(grouped, local_ba.GroupedBAProblem), w,
                               rank)
        out["grouped", w] = dist_ba.distributed_bundle_adjust_grouped(
            group, gcam, gp, **GROUPED_KW)
    return out


def _nan_step(rank, grouped):
    """One grouped iteration at world 4, clean and with a NaN put into the
    last shard's landmark step."""
    gcam = t_cam.CameraParams.from_config(GROUPED_CAM, CPU)
    gp = dist_ba.row_block(_t(grouped, local_ba.GroupedBAProblem), 4, rank)
    kw = dict(iters=1, num_fixed=1)
    clean = dist_ba.distributed_bundle_adjust_grouped(dist.group.WORLD, gcam,
                                                      gp, **kw)
    solve_step = dist_ba._solve_step

    def poisoned(*args):
        dxi, dX = solve_step(*args)
        if rank == 3:
            dX = dX.clone()
            dX[5, 1] = float("nan")
        return dxi, dX
    dist_ba._solve_step = poisoned
    try:
        bad = dist_ba.distributed_bundle_adjust_grouped(dist.group.WORLD,
                                                        gcam, gp, **kw)
    finally:
        dist_ba._solve_step = solve_step
    return clean, bad


def _rank_main(rank, world, init, flat, grouped, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        res = _solves(rank, flat, grouped)
        res["nan"] = _nan_step(rank, grouped)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _flat_problem():
    from tests.test_dist_ba import _problem
    prob, T_true, X_true = _problem(np.random.RandomState(0))
    return ({k: None if v is None else np.asarray(v)
             for k, v in prob._asdict().items()}, T_true, X_true)


def _grouped_problem():
    """tests/test_dist_ba.py's grouped window: 5 poses, 128 landmarks in the
    (L, O) = (128, 8) layout, poses and points perturbed."""
    from tests.test_local_mapping import _synthetic_window
    rng = np.random.RandomState(0)
    T_gt, pts_gt, obs = _synthetic_window(rng, K=5, M=128)
    T0 = T_gt.copy()
    for k in range(1, T0.shape[0]):
        T0[k, :3, 3] += rng.randn(3).astype(np.float32) * 0.02
    pts0 = pts_gt + rng.randn(*pts_gt.shape).astype(np.float32) * 0.03
    L, O = 128, 8
    g_kf = -np.ones((L, O), np.int32)
    g_px = np.zeros((L, O, 2), np.float32)
    g_ur = -np.ones((L, O), np.float32)
    g_ok = np.zeros((L, O), bool)
    counts = np.zeros(L, np.int32)
    for o in range(obs["obs_kf"].shape[0]):
        m = int(obs["obs_lm"][o])
        c = counts[m]
        if c >= O:
            continue
        g_kf[m, c] = int(obs["obs_kf"][o])
        g_px[m, c] = np.asarray(obs["obs_px"][o])
        g_ur[m, c] = float(obs["obs_ur"][o])
        g_ok[m, c] = True
        counts[m] += 1
    return dict(T_cw=T0.astype(np.float32), points=pts0.astype(np.float32),
                obs_kf=g_kf, obs_px=g_px,
                obs_inv_sigma2=np.ones((L, O), np.float32), obs_valid=g_ok,
                obs_ur=g_ur)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_ba")
    flat, _, _ = _flat_problem()
    grouped = _grouped_problem()
    mp.spawn(_rank_main, args=(4, f"file://{d / 'rendezvous'}", flat,
                               grouped, str(d)), nprocs=4, join=True)
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(4)]
    return flat, grouped, ranks


def _pose_err(T_a, T_b):
    """Largest |log(T_a T_b^-1)| entry over the window (tests/
    test_dist_ba.py's measure)."""
    T_a = torch.as_tensor(np.asarray(T_a), dtype=torch.float32)
    T_b = torch.as_tensor(np.asarray(T_b), dtype=torch.float32)
    return float(t_se3.log(t_se3.compose(T_a, t_se3.inverse(T_b))).abs()
                 .max())


def _gathered(ranks, key, w):
    """(T of rank 0, every rank's T equal to it, the shards' points in
    global order)."""
    T0 = ranks[0][key, w][0]
    same = all(torch.equal(ranks[r][key, w][0], T0) for r in range(w))
    return T0, same, torch.cat([ranks[r][key, w][1] for r in range(w)])


def test_partition_problem_gives_reference_arrays():
    import jax.numpy as jnp
    from trackingbench_slam_tpu.parallel import dist_ba as j_dist
    from trackingbench_slam_tpu.solvers import local_ba as j_ba
    flat, _, _ = _flat_problem()
    for shards in (1, 3, 8):
        for ur in (False, True):
            tree = dict(flat)
            if ur:
                tree["obs_ur"] = np.linspace(-1.0, 300.0, len(tree["obs_kf"]),
                                             dtype=np.float32)
            ref = j_dist.partition_problem(j_ba.BAProblem(**{
                k: None if v is None else jnp.asarray(v)
                for k, v in tree.items()}), shards)
            got = dist_ba.partition_problem(_t(tree, local_ba.BAProblem),
                                            shards)
            for name in dist_ba.ShardedBAProblem._fields:
                r, g = np.asarray(getattr(ref, name)), getattr(got, name)
                assert g.numpy().dtype == r.dtype, name
                np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
            # each shard is what a rank holds
            part = dist_ba.local_shard(got, shards, shards - 1)
            assert part.points.shape[0] * shards == got.points.shape[0]


@pytest.mark.parametrize("w", WORLDS)
def test_flat_solve_matches_single_device_and_reference(runs, w):
    from tests.test_dist_ba import CAM as J_CAM
    import jax.numpy as jnp
    from trackingbench_slam_tpu.parallel import dist_ba as j_dist
    from trackingbench_slam_tpu.parallel import mesh as j_mesh
    from trackingbench_slam_tpu.solvers import local_ba as j_ba
    flat, _, ranks = runs
    T_d, same, X_d = _gathered(ranks, "flat", w)
    assert same
    single = local_ba.bundle_adjust(
        t_cam.CameraParams.from_config(FLAT_CAM, CPU),
        _t(flat, local_ba.BAProblem), **FLAT_KW)
    assert _pose_err(T_d, single.T_cw) < 5e-4
    jp = j_ba.BAProblem(**{k: None if v is None else jnp.asarray(v)
                           for k, v in flat.items()})
    T_j, X_j = j_dist.distributed_bundle_adjust(
        j_mesh.make_mesh(lm=8), J_CAM, j_dist.partition_problem(jp, 8),
        **FLAT_KW)
    assert _pose_err(T_d, T_j) < 5e-4
    M = flat["points"].shape[0]
    np.testing.assert_allclose(X_d[:M].numpy(), single.points.numpy(),
                               atol=5e-4)
    np.testing.assert_allclose(X_d[:M].numpy(), np.asarray(X_j)[:M],
                               atol=5e-4)


@pytest.mark.parametrize("w", WORLDS)
def test_grouped_solve_matches_single_device_and_reference(runs, w):
    import jax.numpy as jnp
    from tests.test_local_mapping import CAM as J_CAM
    from trackingbench_slam_tpu.parallel import dist_ba as j_dist
    from trackingbench_slam_tpu.parallel import mesh as j_mesh
    from trackingbench_slam_tpu.solvers import local_ba as j_ba
    _, grouped, ranks = runs
    T_d, same, X_d = _gathered(ranks, "grouped", w)
    assert same
    T_s, X_s = local_ba.bundle_adjust_grouped(
        t_cam.CameraParams.from_config(GROUPED_CAM, CPU),
        _t(grouped, local_ba.GroupedBAProblem), **GROUPED_KW)
    assert _pose_err(T_d, T_s) < 5e-4
    T_j, X_j = j_dist.distributed_bundle_adjust_grouped(
        j_mesh.make_mesh(lm=8), J_CAM,
        j_ba.GroupedBAProblem(**{k: jnp.asarray(v)
                                 for k, v in grouped.items()}),
        **GROUPED_KW)
    assert _pose_err(T_d, T_j) < 5e-4
    np.testing.assert_allclose(X_d.numpy(), X_s.numpy(), atol=5e-4)
    np.testing.assert_allclose(X_d.numpy(), np.asarray(X_j), atol=5e-4)


def test_world_of_one_without_a_group_is_the_same_loop(runs):
    """group=None runs the same loop with no collective: equal to the
    gloo world of one bit for bit."""
    flat, grouped, ranks = runs
    T, X = dist_ba.distributed_bundle_adjust_grouped(
        None, t_cam.CameraParams.from_config(GROUPED_CAM, CPU),
        _t(grouped, local_ba.GroupedBAProblem), **GROUPED_KW)
    assert torch.equal(T, ranks[0]["grouped", 1][0])
    assert torch.equal(X, ranks[0]["grouped", 1][1])
    sp = dist_ba.partition_problem(_t(flat, local_ba.BAProblem), 1)
    T, X = dist_ba.distributed_bundle_adjust(
        None, t_cam.CameraParams.from_config(FLAT_CAM, CPU), sp, **FLAT_KW)
    assert torch.equal(T, ranks[0]["flat", 1][0])
    assert torch.equal(X, ranks[0]["flat", 1][1])


def test_nan_in_one_shard_is_rejected_on_every_rank(runs):
    _, grouped, ranks = runs
    T0 = t_se3.normalize(torch.from_numpy(grouped["T_cw"]))
    X0 = torch.from_numpy(grouped["points"]).chunk(4)
    for r in range(4):
        (T_clean, _), (T_bad, X_bad) = ranks[r]["nan"]
        # the clean first step is taken: the poses move
        assert _pose_err(T_clean, T0) > 1e-4
        # the poisoned one is refused on all four ranks alike
        assert torch.equal(T_bad, T0), r
        assert torch.equal(X_bad, X0[r]), r
        assert torch.isfinite(X_bad).all()
