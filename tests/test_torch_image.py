"""CLAHE and the photometric-stress frames against the JAX package, and
one CLAHE-config track step from a carried JAX state."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.models.vo import StereoVO as JStereoVO
from trackingbench_slam_tpu.ops import image as j_image
from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
from trackingbench_slam_tpu.utils.synthetic import \
    photometric_stress as j_stress
from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.models import vo as t_vo
from trackingbench_slam_tpu_torch.ops import image as t_image
from trackingbench_slam_tpu_torch.utils.convert import vo_state_from_numpy
from trackingbench_slam_tpu_torch.utils.corridor import corridor_frames
from trackingbench_slam_tpu_torch.utils.synthetic import photometric_stress
from tests.test_torch_vo import small_config

CPU = torch.device("cpu")
# CLAHE's LUTs are float32 cumsums of 256 bins scaled to [0, 255]; the
# summation order of the two packages may differ in the last bits
CLAHE_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager steps are thousands of small ops: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", [(240, 320), (120, 160), (37, 53),
                                   (185, 613), (9, 100)])
def test_clahe_matches_reference(rng, shape):
    """Random images past both ends of [0, 255], at sizes the 8x8 grid
    divides and sizes it does not (ceil-divided tiles, edge rule)."""
    img = (rng.uniform(-20, 280, shape)).astype(np.float32)
    img[: shape[0] // 3] *= 0.3           # a dark band: tiles differ
    got = t_image.clahe(torch.from_numpy(img)).numpy()
    want = np.asarray(j_image.clahe(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=0, atol=CLAHE_ATOL)
    # LUT values lie in [0, 255]; their float32 blend may round past 255
    assert got.min() >= 0.0 and got.max() <= 255.0 + CLAHE_ATOL
    got = t_image.clahe_like(torch.from_numpy(img)).numpy()
    want = np.asarray(j_image.clahe_like(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=0, atol=CLAHE_ATOL)


def test_clahe_of_a_constant_tile_and_clip_limits(rng):
    """A flat image, and a smaller clip and grid: the clip-and-redistribute
    and the one-tile edge cases."""
    for img, kw in ((np.full((64, 96), 77.0, np.float32), {}),
                    (rng.uniform(0, 255, (50, 70)).astype(np.float32),
                     dict(clip=1.5, grid=4))):
        got = t_image.clahe(torch.from_numpy(img), **kw).numpy()
        want = np.asarray(j_image.clahe(jnp.asarray(img), **kw))
        np.testing.assert_allclose(got, want, rtol=0, atol=CLAHE_ATOL)


@pytest.mark.parametrize("frame_index,seed", [(0, 0), (7, 3), (23, 0)])
def test_photometric_stress_equals_reference(frame_index, seed):
    cfg = small_config()
    frames, _, _ = corridor_frames(cfg, 1)
    img = frames[0][0].astype(np.float32)
    got = photometric_stress(img, frame_index, seed=seed)
    want = j_stress(img, frame_index, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(photometric_stress(img, frame_index, seed),
                                  got)
    assert not np.array_equal(photometric_stress(img, frame_index + 1, seed),
                              got)


def _stressed(frames):
    def u8(a):
        return np.clip(a, 0, 255).astype(np.uint8)
    return [(u8(photometric_stress(L.astype(np.float32), i)),
             None if R is None
             else u8(photometric_stress(R.astype(np.float32), i)))
            for i, (L, R) in enumerate(frames)]


def test_clahe_track_step_from_carried_reference_state():
    """MatcherConfig(equalize=True) on stressed frames: the JAX StereoVO
    bootstraps on frame 0 and tracks frame 1; the port's track_step from
    the JAX state after frame 0 gives frame 1's pose within 1e-3 m and
    1e-3 rad and its inlier count within 10%."""
    base = small_config()
    cfg = dataclasses.replace(base, matcher=dataclasses.replace(
        base.matcher, equalize=True))
    frames = _stressed(corridor_frames(cfg, 2)[0])
    jvo = JStereoVO(JConfig.from_json(cfg.to_json()))
    jvo.track(*frames[0])
    j0 = jax.tree.map(np.asarray, jvo.state)
    jvo.track(*frames[1])
    j1 = jax.tree.map(np.asarray, jvo.state)
    cam = t_cam.CameraParams.from_config(cfg.camera, CPU)
    gen = torch.Generator().manual_seed(0)
    out = t_vo.track_step(vo_state_from_numpy(j0, CPU),
                          torch.from_numpy(frames[1][0]), cam, cfg, gen)
    dT = (np.linalg.inv(j1.T_cw.astype(np.float64))
          @ out.T_cw.numpy().astype(np.float64))
    rot = np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))
    assert np.linalg.norm(dT[:3, 3]) < 1e-3 and rot < 1e-3
    n_j = int(j1.num_inliers)
    assert n_j > 50
    assert abs(int(out.num_inliers) - n_j) <= 0.1 * n_j
    # the plain config on the same state tracks too, through other pyramids
    plain = t_vo.track_step(vo_state_from_numpy(j0, CPU),
                            torch.from_numpy(frames[1][0]), cam, base,
                            torch.Generator().manual_seed(0))
    assert int(plain.num_inliers) > 50
