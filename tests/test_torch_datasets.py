"""The recorded-dataset path of the port against the JAX package: trajectory
files, the image loader, the KITTI and EuRoC writers and loaders, StereoVO
over a PNG sequence read from disk, and the real-sequence protocol."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from trackingbench_slam_tpu.models.vo import StereoVO as JStereoVO
from trackingbench_slam_tpu.utils import datasets as j_datasets
from trackingbench_slam_tpu.utils import trajectory_io as j_traj
from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
from trackingbench_slam_tpu.utils.native_loader import \
    ImageLoader as JImageLoader
from trackingbench_slam_tpu_torch import sequence_eval
from trackingbench_slam_tpu_torch.models.vo import StereoVO
from trackingbench_slam_tpu_torch.utils import datasets as t_datasets
from trackingbench_slam_tpu_torch.utils import metrics
from trackingbench_slam_tpu_torch.utils import trajectory_io as t_traj
from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       ExtractorConfig,
                                                       MapConfig,
                                                       PipelineConfig,
                                                       PyramidConfig)
from trackingbench_slam_tpu_torch.utils.image_loader import ImageLoader

W, H = 320, 240
FX = 707.09 * W / 1226     # bench.py's field of view at 320x240
BASELINE = 0.54


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager steps are thousands of small ops: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_poses(rng, n=9):
    from scipy.spatial.transform import Rotation
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rotation.from_rotvec(rng.randn(n, 3) * 0.3).as_matrix()
    T[:, :3, 3] = rng.randn(n, 3)
    return T


def test_trajectory_files_round_trip_and_cross_packages(tmp_path, rng):
    """Each package reads what the other writes, within 1e-6."""
    T = random_poses(rng)
    ts = 1403636579.76 + np.arange(len(T)) * 0.05
    for writer, reader, tag in ((t_traj, t_traj, "tt"), (t_traj, j_traj, "tj"),
                                (j_traj, t_traj, "jt")):
        kitti = str(tmp_path / f"{tag}.kitti")
        tum = str(tmp_path / f"{tag}.tum")
        writer.save_kitti_trajectory(kitti, T)
        writer.save_tum_trajectory(tum, T, ts)
        np.testing.assert_allclose(reader.load_kitti_trajectory(kitti), T,
                                   atol=1e-6)
        got_ts, got = reader.load_tum_trajectory(tum)
        np.testing.assert_allclose(got, T, atol=1e-6)
        np.testing.assert_allclose(got_ts, ts, atol=1e-6)
    # the two packages write the same bytes
    for name in ("tt", "jt"):
        assert (open(tmp_path / "tt.kitti").read()
                == open(tmp_path / f"{name}.kitti").read())
    t_traj.save_tum_trajectory(str(tmp_path / "n.tum"), T)   # no stamps
    np.testing.assert_array_equal(
        t_traj.load_tum_trajectory(str(tmp_path / "n.tum"))[0],
        np.arange(len(T)))


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """Gray PNGs, an RGB PNG, a PGM and a float .npy with values outside
    [0, 255] and fractions (clipped and truncated by both loaders)."""
    d = tmp_path_factory.mktemp("imgs")
    r = np.random.RandomState(0)
    paths = {}
    for i in range(6):
        p = str(d / f"{i:04d}.png")
        Image.fromarray((r.rand(48, 64) * 255).astype(np.uint8)).save(p)
        paths.setdefault("gray_png", []).append(p)
    paths["rgb_png"] = [str(d / "rgb.png")]
    Image.fromarray((r.rand(32, 40, 3) * 255).astype(np.uint8)).save(
        paths["rgb_png"][0])
    paths["pgm"] = [str(d / "img.pgm")]
    with open(paths["pgm"][0], "wb") as f:
        f.write(b"P5\n# comment\n30 24\n255\n")
        f.write((r.rand(24, 30) * 255).astype(np.uint8).tobytes())
    paths["npy"] = [str(d / "f32.npy"), str(d / "u8.npy")]
    np.save(paths["npy"][0], (r.rand(24, 30) * 320 - 30).astype(np.float32))
    np.save(paths["npy"][1], (r.rand(24, 30) * 255).astype(np.uint8))
    return paths


@pytest.mark.parametrize("kind,tol", [("gray_png", 0), ("rgb_png", 1),
                                      ("pgm", 0), ("npy", 0)])
def test_image_loader_matches_reference(image_files, kind, tol):
    """Exact, except RGB to gray: PIL's luma rounds where the reference's
    native decoder truncates, one grey level at most (the JAX test's
    bound)."""
    paths = image_files[kind]
    ref = JImageLoader(paths)
    assert ref.native
    with ImageLoader(paths, prefetch=2, threads=2) as got:
        assert len(got) == len(paths)
        for i in range(len(paths)):
            a, b = got[i], ref[i]
            assert a.dtype == np.uint8 and a.shape == b.shape
            assert np.abs(a.astype(int) - b.astype(int)).max() <= tol


@pytest.mark.parametrize("prefetch,threads", [(4, 2), (1, 1), (0, 3)])
def test_image_loader_any_order(image_files, prefetch, threads):
    paths = image_files["gray_png"]
    ref = [np.asarray(Image.open(p).convert("L")) for p in paths]
    order = [4, 1, 5, 5, 0, 2, 3, 4, -1]
    with ImageLoader(paths, prefetch=prefetch, threads=threads) as got:
        for i in order:
            np.testing.assert_array_equal(got[i], ref[i])
        with pytest.raises(IndexError):
            got[len(paths)]


@pytest.mark.parametrize("kind", ["missing", "corrupt_png", "corrupt_npy"])
def test_image_loader_raises_ioerror_naming_the_path(tmp_path, kind):
    name = {"missing": "nope.png", "corrupt_png": "bad.png",
            "corrupt_npy": "bad.npy"}[kind]
    path = str(tmp_path / name)
    if kind != "missing":
        with open(path, "wb") as f:
            f.write(b"\x89PNG not really" if name.endswith(".png")
                    else b"\x93NUMPY garbage")
    with ImageLoader([path]) as loader:
        with pytest.raises(IOError, match=name):
            loader[0]


WRITERS = {
    "corridor_kitti": ("save_corridor_kitti", dict(
        n_frames=6, width=W, height=H, fx=FX, baseline=BASELINE)),
    "synthetic_kitti": ("save_synthetic_kitti", dict(
        n_frames=6, width=W, height=H)),
    "synthetic_euroc": ("save_synthetic_euroc", dict(
        n_frames=6, width=W, height=H, fx=180.0, baseline=0.11)),
}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each writer of both packages into its own directory: {name: (port
    root, JAX root)}."""
    out = {}
    for name, (fn, kw) in WRITERS.items():
        roots = []
        for pkg, mod in (("torch", t_datasets), ("jax", j_datasets)):
            root = str(tmp_path_factory.mktemp(f"{name}_{pkg}"))
            getattr(mod, fn)(root, **kw)
            roots.append(root)
        out[name] = tuple(roots)
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_writers_write_reference_files(written, name):
    """The same files: equal pixel arrays, equal text."""
    ours, ref = written[name]
    files = _files(ref)
    assert _files(ours) == files and len(files) >= 14
    for f in files:
        a, b = os.path.join(ours, f), os.path.join(ref, f)
        if f.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                          np.asarray(Image.open(b)))
        elif f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            assert open(a).read() == open(b).read(), f


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_loaders_match_reference(written, name):
    """Both packages' loaders on the JAX writer's directory: the same
    images, timestamps and ground truth (within 1e-9)."""
    _, root = written[name]
    load = "load_euroc" if name.endswith("euroc") else "load_kitti_odometry"
    got = getattr(t_datasets, load)(root)
    ref = getattr(j_datasets, load)(root)
    assert len(got) == len(ref) == 6 and got.name == ref.name
    for (gl, gr), (rl, rr) in zip(got, ref):
        np.testing.assert_array_equal(gl, rl)
        np.testing.assert_array_equal(gr, rr)
    np.testing.assert_allclose(got.timestamps, ref.timestamps, atol=1e-9,
                               rtol=0)
    np.testing.assert_allclose(got.gt_T_cw, ref.gt_T_cw, atol=1e-9, rtol=0)
    if name.endswith("euroc"):
        assert abs((got.timestamps[1] - got.timestamps[0]) - 0.05) < 1e-6


def small_config():
    """bench.py's operating point at 320x240 with 256 features, BA off, at
    the camera save_corridor_kitti writes."""
    cam = CameraConfig(width=W, height=H, fx=FX, fy=FX, cx=W / 2, cy=H / 2,
                       bf=FX * BASELINE)
    return PipelineConfig(
        camera=cam, pyramid=PyramidConfig(num_levels=3, scale_factor=0.8),
        extractor=ExtractorConfig(num_features=256, min_threshold=12,
                                  cell_size=24),
        map=MapConfig(max_keyframes=8, max_points=2048),
        keyframe_every=5, local_ba_every=0)


def test_stereo_vo_on_kitti_pngs_tracks_reference_within_1cm(tmp_path):
    """7 corridor frames written as KITTI PNGs, each package reading them
    through its own loader into its own StereoVO."""
    root = str(tmp_path / "kitti")
    seq = t_datasets.save_corridor_kitti(root, n_frames=7, width=W, height=H,
                                         fx=FX, baseline=BASELINE)
    jseq = j_datasets.load_kitti_odometry(root)
    cfg = small_config()
    tvo = StereoVO(cfg, device="cpu")
    for left, right in seq:
        tvo.track(left, right)
    jvo = JStereoVO(JConfig.from_json(cfg.to_json()))
    for left, right in jseq:
        jvo.track(left, right)
    P_t, P_j = tvo.poses(), jvo.poses()
    d = np.linalg.norm(metrics.trajectory_positions(P_t)
                       - metrics.trajectory_positions(P_j), axis=1)
    assert d.max() < 0.01, d
    assert metrics.ate_rmse(P_t, seq.gt_T_cw) < 0.01
    assert int(tvo.state.num_inliers) > 100
    jax.clear_caches()


def test_real_sequence_eval_without_roots_returns_none(tmp_path,
                                                       monkeypatch):
    monkeypatch.delenv("KITTI_ROOT", raising=False)
    monkeypatch.delenv("EUROC_ROOT", raising=False)
    assert sequence_eval.real_sequence_eval(device="cpu") is None
    assert sequence_eval.real_sequence_eval(
        kitti_root=str(tmp_path / "no"), euroc_root=str(tmp_path / "none"),
        device="cpu") is None
    assert sequence_eval.main(["--kitti-root", str(tmp_path / "no")]) == 2


def test_real_sequence_eval_reads_the_root_and_writes_both_files(
        written, tmp_path, monkeypatch):
    """The protocol's plumbing on 3 frames of the small KITTI root, found
    through KITTI_ROOT: the trajectory files hold the frames it tracked,
    stamped with the sequence's times."""
    _, root = written["synthetic_kitti"]
    monkeypatch.setenv("KITTI_ROOT", root)
    monkeypatch.delenv("EUROC_ROOT", raising=False)
    out = str(tmp_path / "out")
    res = sequence_eval.real_sequence_eval(max_frames=3, out_dir=out,
                                           device="cpu")
    assert res["dataset"] == "kitti00" and res["frames"] == 3
    assert res["fps"] > 0 and np.isfinite(res["ate_rmse_m"])
    P = t_traj.load_kitti_trajectory(os.path.join(out,
                                                  "traj_kitti00.kitti.txt"))
    ts, P2 = t_traj.load_tum_trajectory(os.path.join(out,
                                                     "traj_kitti00.tum.txt"))
    assert P.shape == (3, 4, 4) and np.isfinite(P).all()
    np.testing.assert_allclose(P2, P, atol=1e-5)
    np.testing.assert_allclose(ts, [0.0, 0.1, 0.2], atol=1e-9)


@pytest.mark.slow
def test_real_sequence_eval_on_a_kitti_root(tmp_path):
    """tests/test_datasets_e2e.py's bench.real_sequence_eval run on the
    port: 10 PlaneSequence frames at 1226x370 in the KITTI layout, at
    kitti_stereo_config's camera."""
    root = str(tmp_path / "kitti")
    t_datasets.save_synthetic_kitti(root, n_frames=10)
    out = sequence_eval.real_sequence_eval(kitti_root=root, max_frames=10,
                                           out_dir=str(tmp_path),
                                           device="cpu")
    assert out is not None and out["dataset"] == "kitti00"
    assert out["frames"] == 10
    assert out["ate_rmse_m"] < 0.05
    assert os.path.exists(tmp_path / "traj_kitti00.kitti.txt")
    assert os.path.exists(tmp_path / "traj_kitti00.tum.txt")
