"""Loop closing of the port against the JAX package: vocabulary training,
transform, BoW vectors and scores, the dense and sparse databases,
search_by_bow, se3.log where the reference's float32 formula cancels, the
pose graph (Jacobians at the identity against jax.jacfwd, a perturbed ring
with a loop edge), correct_trajectory, apply_loop_correction from a carried
state, the candidate verification, the converters, the live StereoVO with a
LoopCloser attached (registration, a loop correction, relocalization), and
the loop bench's configuration and trajectory against bench.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.bow import vocabulary as j_bow
from trackingbench_slam_tpu.geometry import camera as j_cam
from trackingbench_slam_tpu.geometry import se3 as j_se3
from trackingbench_slam_tpu.matchers import matcher as j_matcher
from trackingbench_slam_tpu.models import loop_closer as j_lc
from trackingbench_slam_tpu.models import vo as j_vo
from trackingbench_slam_tpu.solvers import pose_graph as j_pg
from trackingbench_slam_tpu.utils.config import CameraConfig as JCameraConfig
from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
from trackingbench_slam_tpu_torch.bow import vocabulary as t_bow
from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.geometry import se3 as t_se3
from trackingbench_slam_tpu_torch.matchers import matcher as t_matcher
from trackingbench_slam_tpu_torch.models import loop_closer as t_lc
from trackingbench_slam_tpu_torch.models import vo as t_vo
from trackingbench_slam_tpu_torch.solvers import pose_graph as t_pg
from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       ExtractorConfig,
                                                       MapConfig,
                                                       MatcherConfig,
                                                       PipelineConfig,
                                                       PyramidConfig,
                                                       SolverConfig)
from trackingbench_slam_tpu_torch.utils.convert import (
    bow_database_from_numpy, vo_state_from_numpy, vocabulary_from_numpy,
    vocabulary_to_numpy)
from trackingbench_slam_tpu_torch.utils.corridor import corridor_frames

CPU = torch.device("cpu")


def t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def clustered_descriptors(r, n, n_centers=24, flips=12):
    """(n, 8) uint32 descriptors around random centres, `flips` random
    bits flipped each."""
    centers = r.randint(0, 2 ** 32, (n_centers, 8), dtype=np.uint64)
    d = centers[r.randint(0, n_centers, n)].astype(np.uint32)
    return flip_bits(r, d, flips)


def flip_bits(r, d, flips):
    d = d.copy()
    for i in range(d.shape[0]):
        for b in r.choice(256, flips, replace=False):
            d[i, b // 32] ^= np.uint32(1 << (b % 32))
    return d


@pytest.fixture(scope="module")
def vocs():
    r = np.random.RandomState(0)
    descs = clustered_descriptors(r, 1500)
    jv = j_bow.train(descs, branching=4, depth=3, seed=0)
    tv = t_bow.train(descs, branching=4, depth=3, seed=0, device="cpu")
    return descs, jv, tv


def test_train_gives_reference_tables_and_idf(vocs):
    _, jv, tv = vocs
    assert (tv.branching, tv.depth, tv.levels_up) == (4, 3, 2)
    for a, b in zip(tv.levels, jv.levels):
        np.testing.assert_array_equal(t_bow.as_uint32(a), np.asarray(b))
    np.testing.assert_array_equal(tv.word_weights.numpy(),
                                  np.asarray(jv.word_weights))


def test_transform_vectors_and_scores_match_reference(vocs):
    descs, jv, tv = vocs
    r = np.random.RandomState(1)
    valid = r.rand(300) > 0.1
    wj, nj = j_bow.transform(jv, jnp.asarray(descs[:300]),
                             jnp.asarray(valid))
    wt, nt = t_bow.transform(tv, t(descs[:300]), t(valid))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    vj = j_bow.bow_vector(jv, wj, jnp.asarray(valid))
    vt = t_bow.bow_vector(tv, wt, t(valid))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
    wj2, _ = j_bow.transform(jv, jnp.asarray(descs[300:600]),
                             jnp.ones(300, bool))
    vj2 = j_bow.bow_vector(jv, wj2, jnp.ones(300, bool))
    vt2 = t(np.asarray(vj2))
    for name in ("score_l1", "score_l2", "score_dot", "score_bhattacharyya",
                 "score_chi_square", "score_kl"):
        np.testing.assert_allclose(
            float(getattr(t_bow, name)(vt, vt2)),
            float(getattr(j_bow, name)(vj, vj2)), atol=1e-6, err_msg=name)
    sj = j_bow.sparse_bow_vector(jv, wj, jnp.asarray(valid))
    st = t_bow.sparse_bow_vector(tv, wt, t(valid))
    np.testing.assert_array_equal(st.words.numpy(), np.asarray(sj.words))
    np.testing.assert_allclose(st.weights.numpy(), np.asarray(sj.weights),
                               atol=1e-6)
    # the sparse L1 score equals the dense one
    assert abs(float(t_bow.score_l1_sparse(st, st.words, st.weights))
               - 1.0) < 1e-5


@pytest.mark.parametrize("sparse", [False, True])
def test_databases_give_reference_top_k(vocs, sparse):
    descs, jv, tv = vocs
    r = np.random.RandomState(2)
    jdb = (j_bow.SparseBowDatabase(jv, width=100, capacity=6) if sparse
           else j_bow.BowDatabase(jv, capacity=6))
    tdb = (t_bow.SparseBowDatabase(tv, width=100, capacity=6) if sparse
           else t_bow.BowDatabase(tv, capacity=6))
    jvec = j_bow.sparse_bow_vector if sparse else j_bow.bow_vector
    tvec = t_bow.sparse_bow_vector if sparse else t_bow.bow_vector
    for i in range(8):     # the 6-entry ring wraps
        d = descs[r.randint(0, 1500, 100)]
        ok = np.ones(100, bool)
        jw, _ = j_bow.transform(jv, jnp.asarray(d), jnp.asarray(ok))
        tw, _ = t_bow.transform(tv, t(d), t(ok))
        assert jdb.add(jvec(jv, jw, jnp.asarray(ok))) == tdb.add(
            tvec(tv, tw, t(ok)))
        qj = jvec(jv, jw, jnp.asarray(ok))
        qt = tvec(tv, tw, t(ok))
        for ex in (0, 2):
            ij, sj = jdb.query(qj, top_k=3, exclude_recent=ex)
            it, st = tdb.query(qt, top_k=3, exclude_recent=ex)
            np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
            np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    back = bow_database_from_numpy(jdb, tv, CPU)
    assert back.used == tdb.used == 8
    table = ("words", "weights") if sparse else ("vectors",)
    for name in table:
        np.testing.assert_allclose(getattr(back, name).numpy().astype(float),
                                   getattr(tdb, name).numpy().astype(float),
                                   atol=1e-6)


def test_search_by_bow_matches_reference(vocs):
    descs, jv, tv = vocs
    r = np.random.RandomState(4)
    d2 = descs[:200]
    d1 = flip_bits(r, d2[r.permutation(200)], 6)
    v1, v2 = r.rand(200) > 0.1, r.rand(200) > 0.1
    a1 = r.uniform(0, 0.3, 200).astype(np.float32)
    a2 = r.uniform(0, 0.3, 200).astype(np.float32)
    _, n1 = j_bow.transform(jv, jnp.asarray(d1), jnp.asarray(v1))
    _, n2 = j_bow.transform(jv, jnp.asarray(d2), jnp.asarray(v2))
    ref = j_matcher.search_by_bow(d1, v1, n1, a1, d2, v2, n2, a2)
    got = t_matcher.search_by_bow(t(d1), t(v1), t(np.asarray(n1)), t(a1),
                                  t(d2), t(v2), t(np.asarray(n2)), t(a2))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    ok = np.asarray(ref.ok)
    assert ok.sum() > 100
    np.testing.assert_array_equal(got.idx.numpy()[ok], np.asarray(ref.idx)[ok])
    np.testing.assert_array_equal(got.dist.numpy()[ok],
                                  np.asarray(ref.dist)[ok])


def random_poses(r, n, rot=0.3, trans=1.0):
    xi = np.concatenate([r.uniform(-trans, trans, (n, 3)),
                         r.uniform(-rot, rot, (n, 3))], 1).astype(np.float32)
    return np.stack([np.asarray(j_se3.exp(jnp.asarray(x))) for x in xi])


def test_pose_graph_jacobians_match_jax_jacfwd():
    """At the identity (where every odometry residual is log(I) at the
    first iteration of a correction): equal to jax.jacfwd within 1e-6. At
    random poses: within 2e-6 of the port's own float64 Jacobians, and
    within 5e-4 of jax.jacfwd, whose se3.log cancels for the 0.06 rad
    residual rotation among these edges (see the log test above)."""
    r = np.random.RandomState(5)
    eye = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for Ti, Tj, Tm in ((eye, eye, eye),
                       tuple(random_poses(r, 3) for _ in range(3))):
        at_identity = Ti is eye
        z = jnp.zeros((3, 6), jnp.float32)
        args = (jnp.asarray(Ti), jnp.asarray(Tj), jnp.asarray(Tm))
        Ji = jax.vmap(jax.jacfwd(j_pg._residual_of_increments, argnums=0))(
            z, z, *args)
        Jj = jax.vmap(jax.jacfwd(j_pg._residual_of_increments, argnums=1))(
            z, z, *args)
        gi, gj = t_pg.edge_jacobians(t(Ti), t(Tj), t(Tm))
        assert np.isfinite(gi.numpy()).all() and np.isfinite(gj.numpy()).all()
        tol = 1e-6 if at_identity else 5e-4
        np.testing.assert_allclose(gi.numpy(), np.asarray(Ji), atol=tol)
        np.testing.assert_allclose(gj.numpy(), np.asarray(Jj), atol=tol)
        gi64, gj64 = t_pg.edge_jacobians(t(Ti).double(), t(Tj).double(),
                                         t(Tm).double())
        np.testing.assert_allclose(gi.numpy(), gi64.numpy(), atol=2e-6)
        np.testing.assert_allclose(gj.numpy(), gj64.numpy(), atol=2e-6)
        np.testing.assert_allclose(
            t_pg.edge_residual(t(Ti), t(Tj), t(Tm)).numpy(),
            np.asarray(jax.vmap(j_pg.edge_residual)(*args)), atol=1e-5)


def ring(K=12, seed=42):
    """A circle of K poses, a drifted odometry guess, and the exact chain
    plus a loop edge 0 <-> K-1."""
    r = np.random.RandomState(seed)
    T_true = np.stack([np.asarray(j_se3.exp(jnp.asarray(np.array(
        [0.5 * np.sin(k * 0.5), 0.5 * (1 - np.cos(k * 0.5)), 0, 0, 0,
         k * 0.1], np.float32)))) for k in range(K)])
    T0 = [T_true[0]]
    for k in range(1, K):
        rel = T_true[k] @ np.linalg.inv(T_true[k - 1])
        d = np.concatenate([r.randn(3) * 0.02, r.randn(3) * 0.005])
        T0.append(np.asarray(j_se3.exp(jnp.asarray(d, jnp.float32)))
                  @ rel @ T0[-1])
    ei = list(range(K - 1)) + [0]
    ej = list(range(1, K)) + [K - 1]
    Tm = np.stack([T_true[i] @ np.linalg.inv(T_true[j])
                   for i, j in zip(ei, ej)])
    return dict(T_cw=np.stack(T0).astype(np.float32),
                edge_i=np.asarray(ei, np.int32),
                edge_j=np.asarray(ej, np.int32),
                T_meas=Tm.astype(np.float32),
                weight=np.ones(K, np.float32), valid=np.ones(K, bool)), T_true


def test_optimize_pose_graph_closes_a_ring_like_reference():
    g, T_true = ring()
    Tj, cj = j_pg.optimize_pose_graph(
        j_pg.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}),
        iters=25)
    Tt, ct = t_pg.optimize_pose_graph(
        t_pg.PoseGraph(**{k: t(v) for k, v in g.items()}), iters=25)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    assert abs(float(ct) - float(cj)) < 1e-6 + 1e-3 * float(cj)
    assert np.abs(Tt.numpy()[:, :3, 3] - T_true[:, :3, 3]).max() < 3e-3
    i, j, Tm = t_pg.odometry_chain_edges(t(T_true))
    ji, jj, jTm = j_pg.odometry_chain_edges(jnp.asarray(T_true))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(Tm.numpy(), np.asarray(jTm), atol=1e-5)


def log64(T):
    """float64 se(3) log of a (4, 4) pose, for ground truth."""
    from scipy.spatial.transform import Rotation
    phi = Rotation.from_matrix(T[:3, :3]).as_rotvec()
    th = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]],
                  [-phi[1], phi[0], 0]])
    coef = ((1 - th * np.sin(th) / (2 * (1 - np.cos(th)))) / th ** 2
            if th > 1e-6 else 1 / 12)
    return np.concatenate([(np.eye(3) - K / 2 + coef * K @ K) @ T[:3, 3],
                           phi])


@pytest.mark.parametrize("theta", [3e-4, 1.1e-3, 3e-3, 1e-2, 0.1, 1.0])
def test_se3_log_is_accurate_where_the_reference_cancels(theta):
    """The reference's V^-1 coefficient cancels in float32 for rotations of
    ~1e-3 rad (1 - cos t); the port's half-angle form stays within 3e-7 of
    float64 at every angle, and equals the reference within 1e-6 where the
    reference is accurate (theta^2 below its 1e-6 Taylor switch, or large)."""
    r = np.random.RandomState(int(theta * 1e4))
    for _ in range(20):
        axis = r.randn(3)
        xi = np.concatenate([r.randn(3) * 0.5,
                             axis / np.linalg.norm(axis) * theta])
        T = np.asarray(j_se3.exp(jnp.asarray(xi, jnp.float32)))
        got = t_se3.log(t(T)).numpy()
        assert np.abs(got - log64(T.astype(np.float64))).max() < 3e-7
        if theta < 1e-3 or theta >= 1.0:
            np.testing.assert_allclose(got, np.asarray(j_se3.log(T)),
                                       atol=1e-6)


def test_correct_trajectory_matches_reference():
    """A drifted 20-pose circle with a loop edge from node 18 to node 2.
    The residuals along the chain reach the ~1e-3 rad rotations where the
    reference's se3.log cancels, so the two packages stop at different
    points of a flat optimum: poses within 2e-3 of each other, and the
    port's cost, evaluated in float64, no higher than the reference's."""
    g, T_true = ring(K=20, seed=7)
    T_drift = g["T_cw"]
    K = len(T_drift)
    rel = T_true[K - 2] @ np.linalg.inv(T_true[2])
    jloop = j_lc.LoopCandidate(kf_index=2, score=0.3, num_inliers=80,
                               T_cur_kf=rel)
    tloop = t_lc.LoopCandidate(kf_index=2, score=0.3, num_inliers=80,
                               T_cur_kf=rel)
    Tj, cj = j_lc.LoopCloser.correct_trajectory(T_drift, jloop, K - 1,
                                                edge_index=K - 2)
    Tt, ct = t_lc.LoopCloser.correct_trajectory(T_drift, tloop, K - 1,
                                                edge_index=K - 2,
                                                device="cpu")
    assert Tt.shape == (K, 4, 4)
    np.testing.assert_allclose(Tt, Tj, atol=2e-3)

    def cost64(T):
        r = [log64(np.linalg.inv(Tm) @ T[i] @ np.linalg.inv(T[j]))
             for i, j, Tm in [(k, k + 1, T_drift[k].astype(np.float64)
                               @ np.linalg.inv(T_drift[k + 1]))
                              for k in range(K - 1)] + [(K - 2, 2, rel)]]
        w = np.array([1.0] * (K - 1) + [5.0])
        return float((np.square(r).sum(1) * w).sum())
    c0, c_ref, c_port = (cost64(T.astype(np.float64))
                         for T in (T_drift, Tj, Tt))
    assert c_port < 0.5 * c0 and c_port <= c_ref * 1.001
    assert abs(ct - c_port) < 1e-2 * c_port


def small_config(**kw):
    fx = 707.09 * 320 / 1226
    cam = CameraConfig(width=320, height=240, fx=fx, fy=fx, cx=160.0,
                       cy=120.0, bf=fx * 0.54)
    base = dict(camera=cam,
                pyramid=PyramidConfig(num_levels=3, scale_factor=0.8),
                extractor=ExtractorConfig(num_features=256, min_threshold=12,
                                          cell_size=24),
                map=MapConfig(max_keyframes=8, max_points=2048),
                keyframe_every=5, local_ba_every=0,
                solver=SolverConfig(max_landmarks=512))
    base.update(kw)
    return PipelineConfig(**base)


def test_apply_loop_correction_from_carried_state():
    r = np.random.RandomState(8)
    cfg = small_config()
    img = jnp.asarray(r.uniform(0, 255, (240, 320)), jnp.float32)
    js = j_vo.init_state(JConfig.from_json(cfg.to_json()), img)
    KF, M = cfg.map.max_keyframes, cfg.map.max_points
    js = js._replace(
        kfs=js.kfs._replace(
            T_cw=jnp.asarray(random_poses(r, KF)),
            valid=jnp.asarray(r.rand(KF) > 0.3),
            frame_id=jnp.asarray(r.randint(0, 80, KF), jnp.int32)),
        map=js.map._replace(
            pos=jnp.asarray(r.randn(M, 3), jnp.float32),
            valid=jnp.asarray(r.rand(M) > 0.5),
            ref_kf=jnp.asarray(r.randint(-1, KF, M), jnp.int32)))
    state = vo_state_from_numpy(jax.tree.map(np.asarray, js), CPU)
    T_traj = random_poses(r, 64)
    ref = j_lc.apply_loop_correction(js, jnp.asarray(T_traj))
    got = t_lc.apply_loop_correction(state, t(T_traj))
    np.testing.assert_allclose(got.kfs.T_cw.numpy(),
                               np.asarray(ref.kfs.T_cw), atol=1e-6)
    np.testing.assert_allclose(got.map.pos.numpy(), np.asarray(ref.map.pos),
                               atol=1e-4)
    np.testing.assert_array_equal(got.T_cw.numpy(), T_traj[-1])
    np.testing.assert_array_equal(got.prev.T_cw.numpy(), T_traj[-1])


def test_verify_candidates_counts_match_reference(vocs):
    """A candidate keyframe that sees the current frame's landmarks and one
    that does not."""
    _, jv, tv = vocs
    r = np.random.RandomState(9)
    N = 200
    cc = CameraConfig(width=320, height=240, fx=300.0, fy=300.0, cx=160.0,
                      cy=120.0)
    jc = j_cam.CameraParams.from_config(JCameraConfig(**vars(cc)))
    tc = t_cam.CameraParams.from_config(cc, CPU)
    X = np.stack([r.uniform(-2, 2, N), r.uniform(-1.5, 1.5, N),
                  r.uniform(4, 8, N)], -1).astype(np.float32)
    T_c = np.eye(4, dtype=np.float32)
    T_cur = random_poses(r, 1, rot=0.03, trans=0.1)[0]

    def project(T):
        pc = X @ T[:3, :3].T + T[:3, 3]
        return np.stack([300 * pc[:, 0] / pc[:, 2] + 160,
                         300 * pc[:, 1] / pc[:, 2] + 120], -1).astype(
            np.float32)

    d_c = clustered_descriptors(r, N, n_centers=200, flips=0)
    d_cur = flip_bits(r, d_c, 4)
    d_other = clustered_descriptors(r, N, n_centers=200, flips=0)
    valid = np.ones(N, bool)
    kp = project(T_cur) + r.randn(N, 2).astype(np.float32) * 0.2
    map_idx = np.where(r.rand(N) > 0.1, np.arange(N), -1).astype(np.int32)

    def nodes(d):
        return np.asarray(j_bow.transform(jv, jnp.asarray(d),
                                          jnp.asarray(valid))[1])
    T_init = np.stack([T_c, T_c])
    c = dict(desc=np.stack([d_c, d_other]), valid=np.stack([valid, valid]),
             nodes=np.stack([nodes(d_c), nodes(d_other)]),
             map_idx=np.stack([map_idx, map_idx]), map_pos=np.stack([X, X]),
             T_cw=np.stack([T_c, T_c]))
    mc, sc = JConfig().matcher, JConfig().solver
    cj, Tj = j_lc._verify_candidates_device(
        jc, jnp.asarray(d_cur), jnp.asarray(valid), jnp.asarray(nodes(d_cur)),
        jnp.asarray(kp), jnp.asarray(T_init),
        *(jnp.asarray(c[k]) for k in ("desc", "valid", "nodes", "map_idx",
                                      "map_pos", "T_cw")), mc, sc)
    ct, Tt = t_lc._verify_candidates_device(
        tc, t(d_cur), t(valid), t(nodes(d_cur)), t(kp), t(T_init),
        *(t(c[k]) for k in ("desc", "valid", "nodes", "map_idx", "map_pos",
                            "T_cw")), MatcherConfig(), SolverConfig())
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    # the seeing candidate clears the loop bench's 40 inliers, the other
    # is not even matched
    assert ct.numpy()[0, 2] >= 40 and ct.numpy()[1, 0] < 8
    np.testing.assert_allclose(Tt.numpy()[0], np.asarray(Tj)[0], atol=1e-4)
    np.testing.assert_allclose(Tt.numpy()[0], T_cur, atol=1e-2)


def test_vocabulary_converter_round_trips(vocs, tmp_path):
    _, jv, tv = vocs
    back = vocabulary_from_numpy(jv, CPU)
    out = vocabulary_to_numpy(back)
    for a, b in zip(out["levels"], jv.levels):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(out["word_weights"],
                                  np.asarray(jv.word_weights))
    assert (out["branching"], out["depth"], out["levels_up"]) == (4, 3, 2)
    # the npz and DBoW2 text files of the two packages read each other
    j_bow.save_vocabulary(jv, str(tmp_path / "j.npz"))
    t_bow.save_vocabulary(tv, str(tmp_path / "t.npz"))
    t_bow.save_vocabulary_text(tv, str(tmp_path / "t.txt"))
    for voc in (t_bow.load_vocabulary(str(tmp_path / "j.npz"), device="cpu"),
                vocabulary_from_numpy(j_bow.load_vocabulary(
                    str(tmp_path / "t.npz")), CPU),
                t_bow.load_vocabulary_text(str(tmp_path / "t.txt"),
                                           device="cpu")):
        for a, b in zip(voc.levels, tv.levels):
            assert torch.equal(a, b)
        np.testing.assert_allclose(voc.word_weights.numpy(),
                                   tv.word_weights.numpy(), rtol=1e-6)


@pytest.fixture(scope="module")
def loop_runs():
    """Both packages' StereoVO over 9 small corridor frames with a keyframe
    every 2nd frame, windowed BA on every 2nd keyframe and a LoopCloser
    attached, each keyframe's register_precomputed call recorded."""
    cfg = small_config(keyframe_every=2, local_ba_every=2)
    frames, gt, _ = corridor_frames(cfg, 9)
    jcfg = JConfig.from_json(cfg.to_json())
    from trackingbench_slam_tpu.models.extractors import extract_orb
    from trackingbench_slam_tpu.models.frame import make_frame
    jcam = j_cam.CameraParams.from_config(jcfg.camera)
    f = make_frame(jnp.asarray(frames[0][0], jnp.float32), 256, 3, 0.8)
    f = extract_orb(f, jcam, jcfg.extractor, jcfg.pyramid)
    jv = j_bow.train(np.asarray(f.desc)[np.asarray(f.valid)], branching=4,
                     depth=3, seed=0)
    tv = vocabulary_from_numpy(jv, CPU)

    def record(closer):
        seen = []
        real = closer.register_precomputed

        def spy(slot, used_after, nodes, vec, db_a, db_b, top_idx, scores,
                *rest, **kw):
            seen.append((slot, np.asarray(top_idx).tolist(),
                         np.asarray(scores)))
            return real(slot, used_after, nodes, vec, db_a, db_b, top_idx,
                        scores, *rest, **kw)
        closer.register_precomputed = spy
        return seen

    jvo = j_vo.StereoVO(jcfg)
    jvo.loop_closer = j_lc.LoopCloser(jv, jcam, min_score=0.015,
                                      min_inliers=40, exclude_recent=1)
    jseen = record(jvo.loop_closer)
    tvo = t_vo.StereoVO(cfg, device="cpu")
    tvo.loop_closer = t_lc.LoopCloser(tv, tvo.cam, min_score=0.015,
                                      min_inliers=40, exclude_recent=1)
    tseen = record(tvo.loop_closer)
    for left, right in frames:
        jvo.track(left, right)
        tvo.track(left, right)
    return jvo, tvo, jseen, tseen, gt


def test_stereo_vo_with_loop_closer_registers_like_reference(loop_runs):
    """The same keyframes register in both packages, each keyframe's
    database query gives the same top-k, BA runs on every 2nd keyframe, and
    the trajectories agree within 1 cm."""
    jvo, tvo, jseen, tseen, _ = loop_runs
    Pj, Pt = jvo.poses(), tvo.poses()
    assert len(tseen) == len(jseen) == 4 and tvo.ba_calls == 2
    assert tvo.loop_closer.num_entries == jvo.loop_closer.num_entries == 4
    for (ts, ti, tsc), (js, ji, jsc) in zip(tseen, jseen):
        assert ts == js and ti == ji, (tseen, jseen)
        np.testing.assert_allclose(tsc, jsc, atol=0.05)
    assert tvo._kf_traj_idx == jvo._kf_traj_idx
    d = np.abs(Pt[:, :3, 3] - Pj[:, :3, 3]).max()
    assert d < 0.01, d


def test_close_loop_and_relocalize_like_reference(loop_runs):
    """The online correction of both packages on the same loop candidate
    (the newest keyframe seen from the first one, the measured relative
    pose nudged by 2 cm and 0.01 rad): trajectories and ring poses within
    1 cm (the packages' se3.log differ, see above), the same loop event;
    then a relocalization attempt from
    the current frame: the same outcome, poses within 1 cm."""
    jvo, tvo, _, _, _ = loop_runs
    newest = tvo.loop_closer.num_entries - 1
    edge_node = tvo._kf_traj_idx[newest]
    # drain the deferred detections; with exclude_recent=1 neighbouring
    # corridor keyframes already closed loops during the run, at the same
    # frames in both packages
    jvo.poses()
    P = tvo.poses(refine_with_keyframes=False)
    before = list(jvo.loop_events)
    assert before and tvo.loop_events == before
    nudge = np.asarray(j_se3.exp(jnp.asarray([0.02, 0, 0, 0, 0.01, 0],
                                             jnp.float32)))
    rel = (nudge @ P[edge_node] @ np.linalg.inv(P[tvo._kf_traj_idx[0]])
           ).astype(np.float32)
    jvo._close_loop(j_lc.LoopCandidate(0, 0.5, 100, rel), edge_node)
    tvo._close_loop(t_lc.LoopCandidate(0, 0.5, 100, rel), edge_node)
    assert tvo.loop_events == jvo.loop_events == before + [9]
    Pj, Pt = jvo.poses(), tvo.poses()
    assert np.abs(Pt[:, :3, 3] - Pj[:, :3, 3]).max() < 0.01
    assert np.abs(Pt - P).max() > 1e-3      # the correction moved poses
    np.testing.assert_allclose(tvo.state.kfs.T_cw.numpy(),
                               np.asarray(jvo.state.kfs.T_cw), atol=0.01)
    jvo._relocalize()
    tvo._relocalize()
    assert tvo.reloc_events == jvo.reloc_events
    np.testing.assert_allclose(tvo.state.T_cw.numpy(),
                               np.asarray(jvo.state.T_cw), atol=0.01)


def test_configs_and_loop_trajectory_are_bench_py_s():
    """main_path_config() is bench.py's build_config() exactly (windowed BA
    every 2nd keyframe, 2048 landmarks); the BA-off and loop-bench variants
    differ from it in local_ba_every and lk_track_levels alone; the loop
    bench's circle equals the reference's loop_trajectory."""
    import dataclasses
    import bench
    from trackingbench_slam_tpu.utils.synthetic import \
        loop_trajectory as j_loop
    from trackingbench_slam_tpu_torch.utils import corridor
    from trackingbench_slam_tpu_torch.utils.synthetic import loop_trajectory
    ref, baseline = bench.build_config()
    cfg = corridor.main_path_config()
    assert cfg.to_json() == ref.to_json() and baseline == corridor.BASELINE
    assert cfg.local_ba_every == 2 and cfg.solver.max_landmarks == 2048
    assert corridor.main_path_config_ba_off() == dataclasses.replace(
        cfg, local_ba_every=0)
    assert corridor.loop_bench_config() == dataclasses.replace(
        cfg, lk_track_levels=3)
    np.testing.assert_array_equal(loop_trajectory(96, radius=1.5),
                                  j_loop(96, radius=1.5))
    # exact poses in the VO's world (the first camera's) close exactly
    gt = j_loop(8, radius=1.5)
    assert corridor.closing_error(gt @ np.linalg.inv(gt[0]), gt) < 1e-9
