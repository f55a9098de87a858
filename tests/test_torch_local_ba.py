"""Windowed BA of the port against the JAX package: the grouped and flat
normal-equation blocks, the 3x3 inverse, the Schur solve (with num_fixed
and with a fixed mask), both LM loops, the NaN-on-failure Cholesky, and the
landmark compaction's tie order. One synthetic stereo window made from a
numpy seed: K = 6 poses, L = 64 landmarks, O = 6 observation slots, about
10% of the slots empty or invalid."""

from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.geometry import camera as j_cam
from trackingbench_slam_tpu.geometry import se3 as j_se3
from trackingbench_slam_tpu.models import local_mapping as j_lm
from trackingbench_slam_tpu.solvers import local_ba as j_ba
from trackingbench_slam_tpu.utils.config import CameraConfig as JCameraConfig
from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.models import local_mapping as t_lm
from trackingbench_slam_tpu_torch.solvers import local_ba as t_ba
from trackingbench_slam_tpu_torch.utils.config import CameraConfig
from trackingbench_slam_tpu_torch.utils.convert import (
    ba_problem_from_numpy, grouped_ba_problem_from_numpy)

CPU = torch.device("cpu")
CAM_KW = dict(width=640, height=480, fx=500.0, fy=500.0, cx=320.0, cy=240.0,
              bf=250.0)
K, L, O = 6, 64, 6
HUBER = 2.4477


def cams():
    return (j_cam.CameraParams.from_config(JCameraConfig(**CAM_KW)),
            t_cam.CameraParams.from_config(CameraConfig(**CAM_KW), CPU))


def t(a):
    return torch.from_numpy(np.array(a))


def window(seed=0, noise=0.3):
    """(GroupedBAProblem as a numpy dict at a perturbed state, true poses,
    true points)."""
    r = np.random.RandomState(seed)
    T_true = np.stack([np.asarray(j_se3.exp(jnp.asarray(np.concatenate(
        [[0.25 * k, 0.02 * k, 0.1 * k], r.randn(3) * 0.02]), jnp.float32)))
        for k in range(K)])
    X = np.stack([r.uniform(-3, 3, L), r.uniform(-2, 2, L),
                  r.uniform(6, 14, L)], -1).astype(np.float32)
    fx, cx, cy, bf = (CAM_KW[k] for k in ("fx", "cx", "cy", "bf"))
    pc = np.einsum("kij,lj->lki", T_true[:, :3, :3], X) + T_true[:, :3, 3]
    px = np.stack([fx * pc[..., 0] / pc[..., 2] + cx,
                   fx * pc[..., 1] / pc[..., 2] + cy], -1)
    ur = px[..., 0] - bf / pc[..., 2]
    obs_kf = np.tile(np.arange(O, dtype=np.int32), (L, 1))
    empty = r.rand(L, O) < 0.05
    obs_kf[empty] = -1
    valid = ~empty & (r.rand(L, O) > 0.05)
    ur = np.where(r.rand(L, O) < 0.2, -1.0, ur + r.randn(L, O) * noise)
    T0 = T_true.copy()
    for k in range(1, K):
        d = np.concatenate([r.randn(3) * 0.03, r.randn(3) * 0.005])
        T0[k] = np.asarray(j_se3.exp(jnp.asarray(d, jnp.float32))) @ T0[k]
    prob = dict(
        T_cw=T0.astype(np.float32),
        points=(X + r.randn(L, 3) * 0.05).astype(np.float32),
        obs_kf=obs_kf,
        obs_px=(px + r.randn(L, O, 2) * noise).astype(np.float32),
        obs_inv_sigma2=(0.64 ** r.randint(0, 3, (L, O))).astype(np.float32),
        obs_valid=valid,
        obs_ur=ur.astype(np.float32))
    return prob, T_true, X


def problems(prob):
    jp = j_ba.GroupedBAProblem(**{k: jnp.asarray(v) for k, v in prob.items()})
    return jp, grouped_ba_problem_from_numpy(prob, CPU)


def flat(prob):
    """The same observations as a flat (L * O,) BAProblem dict."""
    kf = prob["obs_kf"].reshape(-1)
    return dict(T_cw=prob["T_cw"], points=prob["points"],
                obs_kf=np.maximum(kf, 0),
                obs_lm=np.repeat(np.arange(L, dtype=np.int32), O),
                obs_px=prob["obs_px"].reshape(-1, 2),
                obs_inv_sigma2=prob["obs_inv_sigma2"].reshape(-1),
                obs_valid=prob["obs_valid"].reshape(-1) & (kf >= 0),
                obs_ur=prob["obs_ur"].reshape(-1))


def assert_rel(got, ref, rel=1e-4):
    """|got - ref| <= rel * max |ref| per block."""
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-12))


def pose_errors(T_a, T_b):
    """(max translation difference, max rotation angle difference)."""
    T_a, T_b = np.asarray(T_a, np.float64), np.asarray(T_b, np.float64)
    dt = np.abs(T_a[:, :3, 3] - T_b[:, :3, 3]).max()
    R = np.einsum("kji,kjl->kil", T_a[:, :3, :3], T_b[:, :3, :3])
    # small angles from the skew part (arccos of the trace is ill-posed
    # near 0 in float32)
    w = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                  R[:, 1, 0] - R[:, 0, 1]], -1) / 2
    return dt, np.arcsin(np.clip(np.linalg.norm(w, axis=1), 0, 1)).max()


def test_grouped_blocks_match_reference():
    jc, tc = cams()
    prob, _, _ = window()
    jp, tp = problems(prob)
    ref = j_ba.build_grouped_blocks(jc, jp.T_cw, jp.points, jp, HUBER,
                                    stereo_weight=0.5)
    got = t_ba.build_grouped_blocks(tc, tp.T_cw, tp.points, tp, HUBER,
                                    stereo_weight=0.5)
    for g, r in zip(got, ref):
        assert_rel(g, r)   # relative 1e-4 of each block's largest entry


def test_flat_blocks_match_reference():
    jc, tc = cams()
    prob, _, _ = window()
    fp = flat(prob)
    jp = j_ba.BAProblem(**{k: jnp.asarray(v) for k, v in fp.items()})
    tp = ba_problem_from_numpy(fp, CPU)
    ref = j_ba.build_ba_blocks(jc, jp.T_cw, jp.points, jp, HUBER)
    got = t_ba.build_ba_blocks(tc, tp.T_cw, tp.points, tp, HUBER)
    for g, r in zip(got, ref):
        assert_rel(g, r)


def test_inv3x3_sym_matches_reference():
    r = np.random.RandomState(1)
    B = r.randn(200, 3, 3).astype(np.float32)
    A = np.einsum("nij,nkj->nik", B, B) + 0.1 * np.eye(3, dtype=np.float32)
    ref = np.asarray(j_ba.inv3x3_sym(jnp.asarray(A)))
    got = t_ba.inv3x3_sym(t(A)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(
        ref).max())


@pytest.mark.parametrize("clamp", ["num_fixed", "fixed_mask"])
def test_schur_solve_matches_reference(clamp):
    jc, tc = cams()
    prob, _, _ = window()
    jp, tp = problems(prob)
    *jb, _ = j_ba.build_grouped_blocks(jc, jp.T_cw, jp.points, jp, HUBER)
    *tb, _ = t_ba.build_grouped_blocks(tc, tp.T_cw, tp.points, tp, HUBER)
    mask = np.array([True, False, True, False, False, False])
    if clamp == "num_fixed":
        jargs, targs = dict(num_fixed=2), dict(num_fixed=2)
    else:
        jargs = dict(fixed_mask=jnp.asarray(mask))
        targs = dict(fixed_mask=t(mask))
    dxi_j, dX_j = j_ba.schur_solve(*jb, jnp.float32(1e-4), **jargs)
    dxi_t, dX_t = t_ba.schur_solve(*tb, torch.tensor(1e-4), **targs)
    fixed = mask if clamp == "fixed_mask" else np.arange(K) < 2
    assert (dxi_t.numpy()[fixed] == 0).all()
    assert np.isfinite(np.asarray(dxi_j)).all()
    assert_rel(dxi_t, dxi_j, 1e-3)
    assert_rel(dX_t, dX_j, 1e-3)


def test_bundle_adjust_grouped_matches_reference():
    jc, tc = cams()
    prob, T_true, X_true = window()
    jp, tp = problems(prob)
    mask = np.arange(K) < 1
    T_j, X_j = j_ba.bundle_adjust_grouped(jc, jp, iters=8,
                                          fixed_mask=jnp.asarray(mask))
    T_t, X_t = t_ba.bundle_adjust_grouped(tc, tp, iters=8,
                                          fixed_mask=t(mask))
    dt, dr = pose_errors(T_t.numpy(), T_j)
    assert dt < 1e-4 and dr < 1e-4, (dt, dr)
    assert np.abs(X_t.numpy() - np.asarray(X_j)).max() < 1e-4
    # and the solve moved the poses toward the truth
    assert (pose_errors(T_t.numpy(), T_true)[0]
            < 0.5 * pose_errors(prob["T_cw"], T_true)[0])


def test_bundle_adjust_flat_matches_reference():
    jc, tc = cams()
    prob, _, _ = window()
    fp = flat(prob)
    jp = j_ba.BAProblem(**{k: jnp.asarray(v) for k, v in fp.items()})
    tp = ba_problem_from_numpy(fp, CPU)
    ref = j_ba.bundle_adjust(jc, jp, iters=8, num_fixed=1)
    got = t_ba.bundle_adjust(tc, tp, iters=8, num_fixed=1)
    dt, dr = pose_errors(got.T_cw.numpy(), ref.T_cw)
    assert dt < 1e-4 and dr < 1e-4, (dt, dr)
    assert np.abs(got.points.numpy() - np.asarray(ref.points)).max() < 1e-4
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert abs(float(got.chi2) - float(ref.chi2)) <= 1e-4 * float(ref.chi2)


def test_indefinite_schur_system_gives_nan_and_the_step_is_rejected():
    """Negative information weights make the reduced system negative
    definite: the reference's cho_factor gives NaN (torch's cholesky_ex a
    finite partial factor, which the port replaces by NaN), and LM rejects
    every step, so both return the input state."""
    jc, tc = cams()
    prob, _, _ = window()
    prob["obs_inv_sigma2"] = -prob["obs_inv_sigma2"]
    jp, tp = problems(prob)
    *jb, _ = j_ba.build_grouped_blocks(jc, jp.T_cw, jp.points, jp, None)
    *tb, _ = t_ba.build_grouped_blocks(tc, tp.T_cw, tp.points, tp, None)
    dxi_j, _ = j_ba.schur_solve(*jb, jnp.float32(1e-4))
    dxi_t, _ = t_ba.schur_solve(*tb, torch.tensor(1e-4))
    free = np.arange(K) >= 1
    assert np.isnan(np.asarray(dxi_j)[free]).all()
    assert np.isnan(dxi_t.numpy()[free]).all()
    _, info = torch.linalg.cholesky_ex(torch.tensor([[1.0, 2.0],
                                                     [2.0, 1.0]]))
    assert int(info) != 0
    T_j, X_j = j_ba.bundle_adjust_grouped(jc, jp, iters=3, huber_delta=None)
    T_t, X_t = t_ba.bundle_adjust_grouped(tc, tp, iters=3, huber_delta=None)
    np.testing.assert_array_equal(np.asarray(X_j), prob["points"])
    np.testing.assert_array_equal(X_t.numpy(), prob["points"])
    assert pose_errors(T_t.numpy(), prob["T_cw"])[0] < 1e-6
    assert pose_errors(np.asarray(T_j), prob["T_cw"])[0] < 1e-6


MapT = namedtuple("MapT", "obs_kf obs_feat valid pos")
KfsT = namedtuple("KfsT", "T_cw valid frame_id kp_xy kp_valid kp_level kp_ur")


def test_window_compaction_ties_follow_reference_order():
    """Most of the 512 slots rank 0 and the live ones tie in small groups:
    the selected slots and the ring order equal the reference's exactly
    (jax.lax.top_k and the stable argsort take the lower index first). The
    256-slot selection takes ~100 of the rank-0 slots, as the main path's
    2048 of 16384 does."""
    r = np.random.RandomState(3)
    M, KO, KF, N = 512, 8, 8, 40
    obs_kf = np.full((M, KO), -1, np.int32)
    live = r.rand(M) < 0.3
    for m in np.nonzero(live)[0]:
        n = r.randint(1, 4)
        obs_kf[m, :n] = r.choice(KF, n, replace=False)
    obs_feat = np.where(obs_kf >= 0, r.randint(0, N, (M, KO)), -1).astype(
        np.int32)
    kvalid = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    frame_id = np.array([15, 5, 0, 30, 10, 25, 0, 20], np.int32)
    arrays = dict(
        m=dict(obs_kf=obs_kf, obs_feat=obs_feat, valid=live,
               pos=r.randn(M, 3).astype(np.float32)),
        k=dict(T_cw=np.tile(np.eye(4, dtype=np.float32), (KF, 1, 1)),
               valid=kvalid, frame_id=frame_id,
               kp_xy=r.uniform(0, 300, (KF, N, 2)).astype(np.float32),
               kp_valid=r.rand(KF, N) < 0.9,
               kp_level=r.randint(0, 3, (KF, N)).astype(np.int32),
               kp_ur=r.uniform(0, 300, (KF, N)).astype(np.float32)))
    jm = MapT(**{k: jnp.asarray(v) for k, v in arrays["m"].items()})
    jk = KfsT(**{k: jnp.asarray(v) for k, v in arrays["k"].items()})
    tm = MapT(**{k: t(v) for k, v in arrays["m"].items()})
    tk = KfsT(**{k: t(v) for k, v in arrays["k"].items()})
    for wk, top in ((0, 64), (3, 64), (3, 256)):
        pj, oj, lj = j_lm.build_window_problem_grouped(jm, jk, 0.8, top, wk)
        pt, ot, lt = t_lm.build_window_problem_grouped(tm, tk, 0.8, top, wk)
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        for name in ("obs_kf", "obs_valid", "obs_px", "obs_inv_sigma2",
                     "obs_ur", "points", "T_cw"):
            np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                          np.asarray(getattr(pj, name)),
                                          err_msg=name)
    # the ties are real: far fewer distinct ranks than selected slots
    assert len(np.unique(np.asarray(jm.obs_kf >= 0).sum(1)[lj])) < 10
