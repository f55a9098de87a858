"""The pose solve's round op (ops/cuda/pose_kernel.py): its plain path, its
argument check and its batching rule on the CPU, `pose_optimization`
through it against the solve as it was written before the op (rounds of
`lm_pose_iterations`, each followed by its gate, chi2 evaluated again at
the end), and, on the card only, csrc/pose.cu against the plain solve.

The card's case (this file imports no JAX; tests/conftest.py does):

    python -m pytest -m cuda --noconftest tests/test_torch_pose_kernel.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.geometry.camera import CameraParams
from trackingbench_slam_tpu_torch.ops.cuda import pose_kernel
from trackingbench_slam_tpu_torch.solvers import pose_opt, reprojection
from trackingbench_slam_tpu_torch.utils import profiling
from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       SolverConfig)

# the slam_bench `lm` control's solve: one round of two iterations
LM_CONTROL = dataclasses.replace(SolverConfig(), rounds=1, iters_per_round=2)
CAMERA = dataclasses.replace(CameraConfig(), k1=-0.05, k2=0.01, p1=1e-3,
                             p2=-1e-3, k3=1e-3)


def reference_solve(cam, T_init, pts_w, obs_px, inv_sigma2, valid, config):
    """`pose_optimization` as written before the round op."""
    inlier, T = valid, T_init
    for rnd in range(config.rounds):
        delta = config.huber_delta if rnd < config.rounds - 1 else None
        T, _ = pose_kernel.lm_pose_iterations(
            cam, T, pts_w, obs_px, inv_sigma2, inlier,
            iters=config.iters_per_round, huber_delta=delta,
            init_lambda=config.init_lambda)
        r, pc = reprojection.residuals(cam, T, pts_w, obs_px)
        chi2 = reprojection.chi2(r, inv_sigma2)
        inlier = (valid & (chi2 <= config.chi2_threshold)
                  & (pc[..., 2] > 0.05))
    r, pc = reprojection.residuals(cam, T, pts_w, obs_px)
    chi2 = reprojection.chi2(r, inv_sigma2)
    return pose_opt.PoseOptResult(T_cw=T, inliers=inlier,
                                  num_inliers=inlier.sum().to(torch.int32),
                                  chi2=chi2)


def problem(n, seed, kind="tracked", device="cpu"):
    """A motion-only problem: n landmarks 3-25 m ahead seen from a pose a
    few centimetres and milliradians off the prior, half-pixel noise,
    outliers on one point in ten, pyramid levels 0-2, 10% of the edges
    invalid. `kind` "invalid" makes every edge invalid, "behind" puts
    every landmark behind the camera."""
    rng = np.random.RandomState(seed)
    pw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n),
                   rng.uniform(3, 25, n)], -1)
    if kind == "behind":
        pw[:, 2] = -pw[:, 2]
    xi = np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.005, 3)])
    T_true = se3.exp(torch.tensor(xi, dtype=torch.float64)).numpy()
    pc = pw @ T_true[:3, :3].T + T_true[:3, 3]
    c = CAMERA
    obs = np.stack([c.fx * pc[:, 0] / pc[:, 2] + c.cx,
                    c.fy * pc[:, 1] / pc[:, 2] + c.cy], -1)
    obs += rng.normal(0, 0.5, obs.shape)
    out = rng.uniform(size=n) < 0.1
    obs[out] += rng.uniform(-30, 30, (int(out.sum()), 2))
    inv_s2 = 0.64 ** rng.randint(0, 3, n)
    valid = rng.uniform(size=n) > 0.1
    if kind == "invalid":
        valid[:] = False
    f32 = dict(dtype=torch.float32, device=device)
    cam = CameraParams.from_config(CAMERA, device)
    return (cam, torch.eye(4, **f32), torch.tensor(pw, **f32),
            torch.tensor(obs, **f32), torch.tensor(inv_s2, **f32),
            torch.tensor(valid, device=device))


def assert_results_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("config", [SolverConfig(), LM_CONTROL],
                         ids=["solver", "lm_control"])
@pytest.mark.parametrize("n", [37, 1500, 2000, 2048, 2049])
def test_solve_through_the_op_equals_the_plain_solve(n, config):
    args = problem(n, seed=n)
    got = pose_opt.pose_optimization(*args, config)
    assert_results_equal(got, reference_solve(*args, config))
    assert 0 < int(got.num_inliers) < n


@pytest.mark.parametrize("kind", ["invalid", "behind"])
@pytest.mark.parametrize("config", [SolverConfig(), LM_CONTROL],
                         ids=["solver", "lm_control"])
def test_degenerate_solve_equals_the_plain_solve(kind, config):
    args = problem(300, seed=5, kind=kind)
    got = pose_opt.pose_optimization(*args, config)
    assert_results_equal(got, reference_solve(*args, config))
    assert int(got.num_inliers) == 0


def test_cpu_path_is_plain_and_counts_no_launch():
    cam, T, pw, obs, s2, valid = problem(200, seed=1)
    before = pose_kernel.pose_round_cuda.launches
    with profiling.record() as rec:
        with profiling.stage("track.pose_optimization"):
            got = pose_opt.pose_optimization(cam, T, pw, obs, s2, valid)
    assert pose_kernel.pose_round_cuda.launches == before
    assert [s.name for s in rec.spans].count(
        "track.pose_optimization.round") == SolverConfig().rounds
    assert not any("pose_kernel_launches" in s.counts for s in rec.spans)
    camv = pose_kernel.camera_vector(cam)
    plain = pose_kernel.pose_round_plain(camv, T, pw, obs, s2, valid, valid,
                                         None, 3, 1e-4, 5.991)
    op = pose_kernel.pose_round(camv, T, pw, obs, s2, valid, valid, None, 3,
                                1e-4, 5.991)
    for x, y in zip(op, plain):
        assert torch.equal(x, y)
    assert int(got.num_inliers) > 100


def _round_args(n=64, seed=2):
    cam, T, pw, obs, s2, valid = problem(n, seed)
    return [pose_kernel.camera_vector(cam), T, pw, obs, s2, valid, valid]


@pytest.mark.parametrize("arg,bad,error", [
    (1, lambda t: t.double(), TypeError),
    (2, lambda t: t.double(), TypeError),
    (2, lambda t: t.t().contiguous().t(), ValueError),
    (3, lambda t: torch.stack([t[:, 0], t[:, 1]], 0).t(), ValueError),
    (5, lambda t: t.float(), TypeError),
    (4, lambda t: t[:-1], ValueError),
], ids=["T_float64", "pts_float64", "pts_transposed", "obs_transposed",
        "mask_float", "inv_sigma2_short"])
def test_argument_check_rejects(arg, bad, error):
    args = _round_args()
    pose_kernel._check(*args)
    args[arg] = bad(args[arg])
    with pytest.raises(error):
        pose_kernel._check(*args)
    with pytest.raises(error):
        pose_kernel.pose_round(*args, 2.4477, 2, 1e-4, 5.991)


def test_vmap_rule_equals_a_loop_of_plain_rounds():
    seqs = [_round_args(n=300, seed=s) for s in range(3)]
    stacked = [torch.stack(col) for col in zip(*seqs)]
    for delta in (2.4477, None):
        batched = torch.func.vmap(
            lambda *a, d=delta: pose_kernel.pose_round(*a, d, 4, 1e-4, 5.991),
            in_dims=(None,) + (0,) * 6)(stacked[0][0], *stacked[1:])
        for b, args in enumerate(seqs):
            one = pose_kernel.pose_round_plain(*args, delta, 4, 1e-4, 5.991)
            for x, y in zip(batched, one):
                assert torch.equal(x[b], y)


def pose_gap(Ta, Tb) -> float:
    """Largest norm of se3.log(Ta Tb^-1) over a batch of poses."""
    d = Ta.double() @ torch.linalg.inv(Tb.double())
    return float(se3.log(d).norm(dim=-1).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 2000, 2049, 5000])
def test_kernel_matches_plain_solve_on_the_card(n):
    """csrc/pose.cu's solve against the plain solve on the card: pose gap
    <= 1e-4, inlier flags differing on <= 0.1% of the edges; a batch of
    four equals the four sequences solved alone, bit for bit; one launch a
    round."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: csrc/pose.cu has no CPU mode")
    dev = torch.device("cuda")
    seqs = [problem(n, seed=10 * n + s, device=dev) for s in range(4)]
    cam = seqs[0][0]
    for config in (SolverConfig(), LM_CONTROL):
        before = pose_kernel.pose_round_cuda.launches
        alone = [pose_opt.pose_optimization(*a, config) for a in seqs]
        assert (pose_kernel.pose_round_cuda.launches - before
                == len(seqs) * config.rounds)
        plain = [reference_solve(*a, config) for a in seqs]
        got_T = torch.stack([r.T_cw for r in alone])
        assert pose_gap(got_T, torch.stack([r.T_cw for r in plain])) <= 1e-4
        edges = sum(int(a[5].sum()) for a in seqs)
        differing = sum(int((r.inliers != p.inliers).sum())
                        for r, p in zip(alone, plain))
        assert differing <= 1e-3 * edges
        stacked = [torch.stack(col) for col in zip(*(a[1:] for a in seqs))]
        batched = torch.func.vmap(
            lambda *a: tuple(pose_opt.pose_optimization(cam, *a, config)))(
                *stacked)
        for b, one in enumerate(alone):
            for x, y in zip(batched, one):
                assert torch.equal(x[b], y)
