"""Modules of the port without a kernel against the JAX package: geometry,
images, RANSAC (fed the JAX draws), pose optimization, Hamming matching and
the projection matcher (index-exact), and the map bookkeeping."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.geometry import camera as j_cam
from trackingbench_slam_tpu.geometry import se3 as j_se3
from trackingbench_slam_tpu.geometry import triangulation as j_tri
from trackingbench_slam_tpu.matchers import matcher as j_matcher
from trackingbench_slam_tpu.models import map as j_map
from trackingbench_slam_tpu.models.frame import FrameState as JFrameState
from trackingbench_slam_tpu.ops import hamming as j_ham
from trackingbench_slam_tpu.ops import image as j_image
from trackingbench_slam_tpu.ops import ransac as j_ransac
from trackingbench_slam_tpu.solvers import pose_opt as j_pose
from trackingbench_slam_tpu.utils.config import CameraConfig as JCameraConfig
from trackingbench_slam_tpu.utils.config import MatcherConfig as JMatcherConfig
from trackingbench_slam_tpu.utils.config import SolverConfig as JSolverConfig
from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.geometry import se3 as t_se3
from trackingbench_slam_tpu_torch.geometry import triangulation as t_tri
from trackingbench_slam_tpu_torch.matchers import matcher as t_matcher
from trackingbench_slam_tpu_torch.models import map as t_map
from trackingbench_slam_tpu_torch.models.frame import FrameState as TFrameState
from trackingbench_slam_tpu_torch.ops import hamming as t_ham
from trackingbench_slam_tpu_torch.ops import image as t_image
from trackingbench_slam_tpu_torch.ops import ransac as t_ransac
from trackingbench_slam_tpu_torch.ops import stats as t_stats
from trackingbench_slam_tpu_torch.solvers import pose_opt as t_pose
from trackingbench_slam_tpu_torch.utils.config import CameraConfig, \
    MatcherConfig, SolverConfig
from tests.conftest import make_textured_image

CPU = torch.device("cpu")
CAM_KW = dict(width=320, height=240, fx=190.0, fy=188.0, cx=161.0, cy=119.0,
              k1=-0.05, k2=0.01, p1=0.001, p2=-0.0005, bf=100.0)


def t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def cams():
    return (j_cam.CameraParams.from_config(JCameraConfig(**CAM_KW)),
            t_cam.CameraParams.from_config(CameraConfig(**CAM_KW), CPU))


def random_pose(r, rot=0.2, trans=0.5):
    xi = np.concatenate([r.uniform(-trans, trans, 3),
                         r.uniform(-rot, rot, 3)]).astype(np.float32)
    return np.asarray(j_se3.exp(jnp.asarray(xi)))


# --- geometry ---------------------------------------------------------------

def test_se3_matches_reference(rng):
    for scale in (1e-5, 0.3, 2.0):
        xi = rng.uniform(-scale, scale, 6).astype(np.float32)
        Tj = np.asarray(j_se3.exp(jnp.asarray(xi)))
        Tt = t_se3.exp(t(xi)).numpy()
        np.testing.assert_allclose(Tt, Tj, atol=1e-6)
        np.testing.assert_allclose(t_se3.log(t(Tj)).numpy(),
                                   np.asarray(j_se3.log(jnp.asarray(Tj))),
                                   atol=1e-5)
    A, B = random_pose(rng), random_pose(rng)
    pts = rng.uniform(-3, 3, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(t_se3.compose(t(A), t(B)).numpy(),
                               np.asarray(j_se3.compose(A, B)), atol=1e-6)
    np.testing.assert_allclose(t_se3.inverse(t(A)).numpy(),
                               np.asarray(j_se3.inverse(A)), atol=1e-6)
    np.testing.assert_allclose(t_se3.transform_points(t(A), t(pts)).numpy(),
                               np.asarray(j_se3.transform_points(A, pts)),
                               atol=1e-5)
    skew = A.copy()
    skew[:3, :3] += rng.uniform(-1e-3, 1e-3, (3, 3)).astype(np.float32)
    np.testing.assert_allclose(t_se3.normalize(t(skew)).numpy(),
                               np.asarray(j_se3.normalize(skew)), atol=1e-6)


def test_camera_and_triangulation_match_reference(rng):
    jc, tc = cams()
    pc = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                   rng.uniform(0.5, 20, 200)], -1).astype(np.float32)
    px_j = np.asarray(j_cam.world2cam(jc, pc))
    np.testing.assert_allclose(t_cam.world2cam(tc, t(pc)).numpy(), px_j,
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(t_cam.cam2world(tc, t(px_j)).numpy(),
                               np.asarray(j_cam.cam2world(jc, px_j)),
                               atol=1e-5)
    np.testing.assert_array_equal(t_cam.is_in_frame(tc, t(px_j)).numpy(),
                                  np.asarray(j_cam.is_in_frame(jc, px_j)))
    np.testing.assert_allclose(t_cam.project_jacobian(tc, t(pc)).numpy(),
                               np.asarray(j_cam.project_jacobian(jc, pc)),
                               rtol=1e-5, atol=1e-3)
    uL = rng.uniform(0, 320, 100).astype(np.float32)
    uR = (uL - rng.uniform(-2, 30, 100)).astype(np.float32)
    dj, vj = j_tri.stereo_depth(jc.bf, uL, uR)
    dt, vt = t_tri.stereo_depth(tc.bf, t(uL), t(uR))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    bj = j_tri.backproject(jc.fx, jc.fy, jc.cx, jc.cy, px_j, pc[:, 2])
    bt = t_tri.backproject(tc.fx, tc.fy, tc.cx, tc.cy, t(px_j), t(pc[:, 2]))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-5,
                               atol=1e-5)


# --- images -----------------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((240, 320), 0.8), ((237, 311), 0.8),
                                         ((240, 320), 0.5)])
def test_pyramid_matches_jax_image_resize_at_borders(shape, scale):
    img = make_textured_image(*shape, seed=2)
    pj = j_image.build_pyramid(jnp.asarray(img), 3, scale)
    pt = t_image.build_pyramid(t(img), 3, scale)
    assert t_image.pyramid_shapes(*shape, 3, scale) == j_image.pyramid_shapes(
        *shape, 3, scale)
    # 1e-3 on [0, 255] values: the weights are identical, but the
    # reference's XLA-CPU contraction is off the exact float64 result by up
    # to 6.4e-4 on some pixels (the port's two float32 products by ~2e-5)
    for a, b in zip(pj, pt):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape
        # the last row/column sample past the image edge: renormalized
        # weights give the edge pixel in both (F.interpolate would not)
        np.testing.assert_allclose(b[:, -1], a[:, -1], atol=1e-3)
        np.testing.assert_allclose(b[-1, :], a[-1, :], atol=1e-3)
        np.testing.assert_allclose(b[:, 0], a[:, 0], atol=1e-3)
        np.testing.assert_allclose(b, a, atol=1e-3)


IMAGE_OPS = {
    "resize_bilinear": lambda x: t_image.resize_bilinear(x, (95, 144)),
    "build_pyramid": lambda x: tuple(t_image.build_pyramid(x, 3, 0.8)),
    "gaussian_blur": t_image.gaussian_blur,
}


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("op", sorted(IMAGE_OPS))
def test_image_ops_under_vmap_equal_the_per_image_calls(op, b):
    """The image side of a batched step must be bit-equal to the serial
    one: each image op under torch.func.vmap gives the per-image result
    exactly."""
    fn = IMAGE_OPS[op]
    imgs = torch.stack([t(make_textured_image(119, 180, seed=10 + i))
                        for i in range(b)])
    batched = torch.func.vmap(fn)(imgs)
    for i in range(b):
        one = fn(imgs[i])
        got = torch.utils._pytree.tree_map(lambda x, i=i: x[i], batched)
        for x, y in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(one)):
            assert torch.equal(x, y), (op, b, i)


def test_resize_is_a_gather_and_blend():
    """No matrix product in the resize (its rounding moves with the
    batch): each axis is two index_selects, two multiplies and an add."""
    img = t(make_textured_image(60, 90, seed=5))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t_image.resize_bilinear(img, (48, 72))
    ops = {e.key: e.count for e in prof.key_averages()}
    assert not {"aten::mm", "aten::matmul", "aten::bmm", "aten::addmm",
                "aten::einsum"} & set(ops), ops
    assert ops["aten::index_select"] == 4 and ops["aten::mul"] == 4
    assert ops["aten::add"] == 2


def test_blur_and_bilinear_sample_match_reference(rng):
    img = make_textured_image(60, 90, seed=4)
    np.testing.assert_allclose(t_image.gaussian_blur(t(img)).numpy(),
                               np.asarray(j_image.gaussian_blur(img)),
                               atol=1e-4)
    xy = rng.uniform(-3, 93, (40, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(t_image.bilinear_sample(t(img), t(xy)).numpy(),
                               np.asarray(j_image.bilinear_sample(img, xy)),
                               atol=1e-4)


def test_medians_average_the_middle_pair():
    x = np.array([[1.0, np.nan], [4.0, np.nan], [2.0, 3.0], [7.0, np.nan]],
                 np.float32)
    np.testing.assert_allclose(t_stats.nanmedian(t(x), 0).numpy(),
                               np.asarray(jnp.nanmedian(x, axis=0)))
    assert np.isnan(t_stats.nanmedian(t(np.full((3, 1), np.nan,
                                                 np.float32)), 0).numpy()[0])
    y = np.array([[5.0, 1.0, 9.0, 2.0]], np.float32)
    np.testing.assert_allclose(t_stats.median(t(y)).numpy(),
                               np.asarray(jnp.median(y, axis=-1)))


# --- RANSAC and pose optimization --------------------------------------------

def _two_views(r, N=200, outliers=40):
    P = np.stack([r.uniform(-4, 4, N), r.uniform(-2, 2, N),
                  r.uniform(4, 20, N)], -1)
    T2 = random_pose(r, rot=0.05, trans=0.4)
    f, c = 300.0, np.array([320.0, 240.0])

    def proj(X):
        return X[:, :2] / X[:, 2:] * f + c

    p1 = proj(P)
    p2 = proj(P @ T2[:3, :3].T + T2[:3, 3])
    p2 = p2 + r.normal(0, 0.3, p2.shape)
    p2[:outliers] += r.uniform(-40, 40, (outliers, 2))
    valid = np.ones(N, bool)
    valid[-10:] = False
    return p1.astype(np.float32), p2.astype(np.float32), valid


def test_ransac_with_reference_draws_matches(rng):
    p1, p2, valid = _two_views(rng)
    key = jax.random.PRNGKey(3)
    inl_j, F_j = j_ransac.fundamental_ransac(jnp.asarray(p1), jnp.asarray(p2),
                                             jnp.asarray(valid), key)
    draws = np.asarray(jax.random.uniform(key, (256, p1.shape[0]),
                                          minval=1e-9, maxval=1.0))
    inl_t, F_t = t_ransac.fundamental_ransac(t(p1), t(p2), t(valid),
                                             uniform=t(draws))
    inl_j = np.asarray(inl_j)
    assert inl_j.sum() > 100
    assert (inl_t.numpy() == inl_j).mean() >= 0.99
    Fj = np.asarray(F_j) / np.linalg.norm(F_j)
    Ft = F_t.numpy() / np.linalg.norm(F_t.numpy())
    assert min(np.abs(Fj - Ft).max(), np.abs(Fj + Ft).max()) < 1e-3


def test_pose_optimization_matches_reference(rng):
    jc, tc = cams()
    N = 300
    T_true = random_pose(rng, rot=0.1, trans=0.3)
    pw = np.stack([rng.uniform(-4, 4, N), rng.uniform(-2, 2, N),
                   rng.uniform(3, 25, N)], -1).astype(np.float32)
    obs = np.asarray(j_cam.world2cam(jc, j_se3.transform_points(T_true, pw)))
    obs = (obs + rng.normal(0, 0.5, obs.shape)).astype(np.float32)
    obs[:30] += rng.uniform(-30, 30, (30, 2)).astype(np.float32)
    levels = rng.randint(0, 3, N).astype(np.int32)
    valid = rng.uniform(size=N) > 0.1
    T0 = (T_true @ random_pose(rng, rot=0.01, trans=0.05)).astype(np.float32)
    inv_j = j_pose.level_inv_sigma2(jnp.asarray(levels), 0.8)
    inv_t = t_pose.level_inv_sigma2(t(levels), 0.8)
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=1e-6)
    rj = j_pose.pose_optimization(jc, T0, pw, obs, inv_j, valid,
                                  JSolverConfig())
    rt = t_pose.pose_optimization(tc, t(T0), t(pw), t(obs), inv_t, t(valid),
                                  SolverConfig())
    np.testing.assert_allclose(rt.T_cw.numpy(), np.asarray(rj.T_cw),
                               atol=1e-4)
    assert (rt.inliers.numpy() == np.asarray(rj.inliers)).mean() >= 0.99
    assert abs(int(rt.num_inliers) - int(rj.num_inliers)) <= 3
    A = rng.normal(size=(6, 6)).astype(np.float32)
    A = A @ A.T + np.eye(6, dtype=np.float32)
    b = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(t_pose._chol6_solve(t(A), t(b)).numpy(),
                               np.asarray(j_pose._chol6_solve(A, b)),
                               rtol=1e-4, atol=1e-5)


# --- Hamming and the projection matcher -------------------------------------

def _descs(r, n):
    return r.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def test_hamming_primitives_index_exact(rng):
    d1 = _descs(rng, 64)
    d2 = np.concatenate([d1[:20] ^ np.uint32(1), _descs(rng, 80)])
    from trackingbench_slam_tpu.ops import orb as j_orb
    from trackingbench_slam_tpu_torch.ops import orb as t_orb
    dj = np.asarray(j_ham.hamming_matrix_mxu(
        j_orb.unpack_to_pm1(jnp.asarray(d1)),
        j_orb.unpack_to_pm1(jnp.asarray(d2)))).astype(np.float32)
    dt = t_ham.hamming_matrix_mxu(t_orb.unpack_to_pm1(t(d1)),
                                  t_orb.unpack_to_pm1(t(d2))).numpy()
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(
        t_ham.popcount32(t(d1 ^ d2[:64])).sum(-1).numpy(),
        np.asarray(j_ham.hamming_matrix_popcount(jnp.asarray(d1),
                                                 jnp.asarray(d2[:64])))
        .diagonal())
    # integer distances: ties everywhere
    dist = np.floor(dj / 16.0).astype(np.float32)
    v1, v2 = rng.uniform(size=64) > 0.1, rng.uniform(size=100) > 0.1
    mj = np.asarray(j_ham.masked_distance(dist, v1, v2))
    mt = t_ham.masked_distance(t(dist), t(v1), t(v2))
    np.testing.assert_array_equal(mt.numpy(), mj)
    bj = [np.asarray(a) for a in j_ham.best_two(jnp.asarray(mj))]
    bt = [a.numpy() for a in t_ham.best_two(mt)]
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a, b)
    ok = bj[1] <= 7
    np.testing.assert_array_equal(
        t_ham.resolve_duplicate_targets(t(bj[0]), t(bj[1]), t(ok),
                                        100).numpy(),
        np.asarray(j_ham.resolve_duplicate_targets(
            jnp.asarray(bj[0]), jnp.asarray(bj[1]), jnp.asarray(ok), 100)))
    a1 = rng.uniform(-4, 4, 64).astype(np.float32)
    a2 = rng.uniform(-4, 4, 100).astype(np.float32)
    np.testing.assert_array_equal(
        t_ham.rotation_histogram_mask(t(a1), t(a2), t(bj[0]), t(ok)).numpy(),
        np.asarray(j_ham.rotation_histogram_mask(
            jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(bj[0]),
            jnp.asarray(ok))))


def _frame_pair(r, N=128, M=300):
    """The same frame and map in both packages."""
    jc, tc = cams()
    T = random_pose(r, rot=0.05, trans=0.2)
    pw = np.stack([r.uniform(-5, 5, M), r.uniform(-3, 3, M),
                   r.uniform(3, 15, M)], -1).astype(np.float32)
    pc = np.asarray(j_se3.transform_points(T, pw))
    px = np.asarray(j_cam.world2cam(jc, pc))
    mdesc = _descs(r, M)
    # features: noisy re-observations of some landmarks, descriptors with a
    # few flipped bits, plus clutter
    pick = r.choice(M, N, replace=False)
    kp = (px[pick] + r.normal(0, 0.7, (N, 2))).astype(np.float32)
    fdesc = mdesc[pick] ^ (np.uint32(1) << r.randint(0, 32, (N, 8)).astype(
        np.uint32))
    fdesc[: N // 4] = _descs(r, N // 4)
    dist = np.linalg.norm(pw - np.linalg.inv(T)[:3, 3], axis=-1)
    normal = (pw - np.linalg.inv(T)[:3, 3]) / dist[:, None]
    frame = dict(
        kp_xy=kp, kp_level=r.randint(0, 3, N).astype(np.int32),
        kp_angle=np.zeros(N, np.float32), kp_response=np.ones(N, np.float32),
        desc=fdesc, bearing=np.zeros((N, 3), np.float32),
        map_idx=np.where(r.uniform(size=N) < 0.3, r.randint(0, M, N),
                         -1).astype(np.int32),
        valid=r.uniform(size=N) > 0.05, T_cw=T.astype(np.float32))
    mj = j_map.empty_map(M, 16)
    mp = dict(pos=pw, desc=mdesc, normal=normal.astype(np.float32),
              min_dist=(dist * 0.3).astype(np.float32),
              max_dist=(dist * 2.0).astype(np.float32),
              valid=r.uniform(size=M) > 0.1,
              obs_count=r.randint(0, 3, M).astype(np.int32))
    mj = mj._replace(**{k: jnp.asarray(v) for k, v in mp.items()})
    mt = t_map.MapState(**{k: t(np.asarray(v)) for k, v in
                           mj._asdict().items()})
    fj = JFrameState(pyramid=(), lk_pyr=(),
                     **{k: jnp.asarray(v) for k, v in frame.items()})
    ft = TFrameState(pyramid=(), lk_pyr=(),
                     **{k: t(v) for k, v in frame.items()})
    return (jc, fj, mj), (tc, ft, mt)


@pytest.mark.parametrize("max_candidates,only_unlinked", [(4096, True),
                                                          (64, False)])
def test_projection_map_matcher_index_exact(rng, max_candidates,
                                            only_unlinked):
    (jc, fj, mj), (tc, ft, mt) = _frame_pair(rng)
    kw = dict(scale_factor=0.8, num_levels=3, only_unlinked=only_unlinked,
              max_candidates=max_candidates)
    rj = j_matcher.search_by_projection_map(jc, fj, mj, JMatcherConfig(),
                                            accept_th=50.0, use_ratio=False,
                                            **kw)
    rt = t_matcher.search_by_projection_map(tc, ft, mt, MatcherConfig(),
                                            accept_th=50.0, use_ratio=False,
                                            **kw)
    ok = np.asarray(rj.ok)
    assert ok.sum() > 10
    np.testing.assert_array_equal(rt.ok.numpy(), ok)
    np.testing.assert_array_equal(rt.idx.numpy()[ok], np.asarray(rj.idx)[ok])
    np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))


# --- map bookkeeping ---------------------------------------------------------

def _assert_map_equal(mt, mj, atol=0.0):
    for name, a in mj._asdict().items():
        a = np.asarray(a)
        b = getattr(mt, name).numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_map_ops_match_reference(rng):
    M, K, N, KF = 96, 16, 40, 4
    mj = j_map.empty_map(M, K)
    mt = t_map.empty_map(M, K, CPU)
    kfj = j_map.empty_keyframes(KF, N)
    kft = t_map.empty_keyframes(KF, N, CPU)
    for step in range(3):
        pos = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
        desc = _descs(rng, N)
        normal = rng.normal(size=(N, 3)).astype(np.float32)
        mind = rng.uniform(0.1, 1, N).astype(np.float32)
        maxd = rng.uniform(2, 9, N).astype(np.float32)
        lvl = rng.randint(0, 3, N).astype(np.int32)
        want = rng.uniform(size=N) > 0.3
        slot = np.int32(np.asarray(j_map.next_kf_slot(kfj)))
        assert int(t_map.next_kf_slot(kft)) == slot
        mj = j_map.purge_kf_slot(mj, slot, kfj.valid[slot])
        mt = t_map.purge_kf_slot(mt, torch.tensor(slot), kft.valid[slot])
        refkf = np.full(N, slot, np.int32)
        mj, sj = j_map.add_points(mj, pos, desc, normal, mind, maxd, refkf,
                                  lvl, want)
        mt, st = t_map.add_points(mt, t(pos), t(desc), t(normal), t(mind),
                                  t(maxd), t(refkf), t(lvl), t(want))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        sj = np.asarray(sj)
        got = want & (sj < M)
        feat = np.arange(N, dtype=np.int32)
        mj = j_map.add_observations(mj, np.where(got, sj, -1), slot, feat,
                                    got, desc=desc)
        mt = t_map.add_observations(mt, t(np.where(got, sj, -1)),
                                    torch.tensor(slot), t(feat), t(got),
                                    desc=t(desc))
        idx = rng.randint(0, M, 30).astype(np.int32)
        w = rng.uniform(size=30) > 0.5
        mj = j_map.increase_visible(j_map.increase_found(mj, idx, w), idx, ~w)
        mt = t_map.increase_visible(t_map.increase_found(mt, t(idx), t(w)),
                                    t(idx), t(~w))
        frame = JFrameState(
            pyramid=(), lk_pyr=(), kp_xy=jnp.asarray(pos[:, :2]),
            kp_level=jnp.asarray(lvl), kp_angle=jnp.zeros(N),
            kp_response=jnp.zeros(N), desc=jnp.asarray(desc),
            bearing=jnp.zeros((N, 3)), map_idx=jnp.asarray(sj),
            valid=jnp.asarray(want),
            T_cw=jnp.asarray(random_pose(rng)))
        kfj, _ = j_map.insert_keyframe(kfj, frame, 10 * step + 1, slot=slot)
        kft, _ = t_map.insert_keyframe(
            kft, TFrameState(**{k: (t(np.asarray(v)) if k not in (
                "pyramid", "lk_pyr") else ()) for k, v in
                frame._asdict().items()}), 10 * step + 1,
            slot=torch.tensor(slot))
    old = rng.randint(0, M, 12).astype(np.int32)
    new = rng.randint(0, M, 12).astype(np.int32)
    fz = rng.uniform(size=12) > 0.3
    mj, redj = j_map.replace_points(mj, old, new, fz)
    mt, redt = t_map.replace_points(mt, t(old), t(new), t(fz))
    np.testing.assert_array_equal(redt.numpy(), np.asarray(redj))
    mj = j_map.update_normal_and_depth(mj, kfj, 0.8, 3)
    mt = t_map.update_normal_and_depth(mt, kft, 0.8, 3)
    mj = j_map.compute_distinctive_descriptors(mj, kfj)
    mt = t_map.compute_distinctive_descriptors(mt, kft)
    _assert_map_equal(mt, mj, atol=1e-5)
    for name, a in kfj._asdict().items():
        b = getattr(kft, name).numpy()
        if np.asarray(a).dtype == np.uint32:
            b = b.view(np.uint32)
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, err_msg=name)
    dist = rng.uniform(0.5, 10, M).astype(np.float32)
    np.testing.assert_array_equal(
        t_map.predict_scale(mt, t(dist), 0.8, 3).numpy(),
        np.asarray(j_map.predict_scale(mj, dist, 0.8, 3)))


@pytest.mark.parametrize("live", [5, 7, 8, 12])
def test_distinctive_descriptor_saturated_median_picks_column0(rng, live):
    """Reference quirk, reproduced on purpose (models/map.py:507-511): the
    median runs over all K = 16 columns with dead pairs at 1e6, so with
    <= 7 live observations every median saturates and argmin picks column
    0 even though that observation is dead."""
    M, K = 4, 16
    mj = j_map.empty_map(M, K)
    obs_kf = np.full((M, K), -1, np.int32)
    cols = rng.choice(np.arange(1, K), live, replace=False)
    obs_kf[:, cols] = 0
    obs_desc = rng.randint(0, 2 ** 32, (M, K, 8), dtype=np.uint64).astype(
        np.uint32)
    mj = mj._replace(obs_kf=jnp.asarray(obs_kf), obs_feat=jnp.asarray(obs_kf),
                     obs_desc=jnp.asarray(obs_desc),
                     valid=jnp.ones(M, bool))
    mt = t_map.MapState(**{k: t(np.asarray(v)) for k, v in
                           mj._asdict().items()})
    out_j = np.asarray(j_map.compute_distinctive_descriptors(mj, None).desc)
    out_t = t_map.compute_distinctive_descriptors(mt).desc.numpy().view(
        np.uint32)
    np.testing.assert_array_equal(out_t, out_j)
    if live <= K // 2 - 1:
        np.testing.assert_array_equal(out_t, obs_desc[:, 0])
    else:
        assert not (out_t == obs_desc[:, 0]).all(axis=-1).any()
