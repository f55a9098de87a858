"""The JAX package's two end-to-end loop tests (tests/test_loop_online.py)
on the port, held to the JAX package's runs of them: online loop closure
on a closed circle, and relocalization after an induced tracking loss. The
configuration, frames, vocabulary recipe and LoopCloser settings are the
JAX tests' own. The JAX runs are part `loop_online` of
trackingbench_slam_tpu_torch/records/jax_full_width.npz: the JAX package
on its TPU branches in interpret mode (tests/test_torch_records.py
`reference_semantics`), written on the CPU by

    python -m tests.test_torch_records --write --part loop_online

(`record_runs` below; running JAX beside the port here took 460 s). The
port, on the CPU, draws JAX's RANSAC samples (tests/test_torch_mono.py
`ReferenceDraws`: the key chain of JAX's StereoVO, PRNGKey(0) split once a
track step) and uses the record's vocabulary, trained on JAX's ORB.

Bounds: the same loop and relocalization frames as JAX; every pose within
1 cm of JAX's (the carried steps agree within 1e-3 m a frame,
tests/test_torch_records.py), except while the camera is blinded, where no
pose is posed; and the JAX tests' own bounds, which the record meets too:
a closing error below 8 cm, a relocalized camera within 5 cm of the
revisited ground truth."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.bow import vocabulary as j_bow
from trackingbench_slam_tpu.geometry import camera as j_cam
from trackingbench_slam_tpu.models import loop_closer as j_lc
from trackingbench_slam_tpu.models import vo as j_vo
from trackingbench_slam_tpu.models.extractors import extract_orb as j_orb
from trackingbench_slam_tpu.models.frame import make_frame as j_make_frame
from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
from trackingbench_slam_tpu_torch import parity
from trackingbench_slam_tpu_torch.matchers import matcher as t_matcher
from trackingbench_slam_tpu_torch.models import loop_closer as t_lc
from trackingbench_slam_tpu_torch.models import vo as t_vo
from trackingbench_slam_tpu_torch.utils import corridor
from trackingbench_slam_tpu_torch.utils.corridor import closing_error
from trackingbench_slam_tpu_torch.utils.synthetic import (
    forward_yaw_trajectory, loop_trajectory)
from tests.test_torch_mono import ReferenceDraws
from tests.test_torch_records import reference_semantics

CLOSER = dict(min_score=0.015, min_inliers=40)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(keyframe_every):
    """tests/test_loop_online.py _cfg (utils/corridor.py
    tracked_loop_config) with a keyframe every `keyframe_every` frames."""
    return dataclasses.replace(corridor.tracked_loop_config(),
                               keyframe_every=keyframe_every)


def _train_voc(scene, poses, jcfg):
    """tests/test_loop_online.py _train_voc on the JAX package: ORB of
    every 4th view, the first 4000 descriptors, k = 6, L = 3, seed 0."""
    cam = j_cam.CameraParams.from_config(jcfg.camera)
    descs = []
    for T in poses[::4]:
        f = j_make_frame(jnp.asarray(scene.render(T), jnp.float32), 600,
                         jcfg.pyramid.num_levels, jcfg.pyramid.scale_factor)
        f = j_orb(f, cam, jcfg.extractor, jcfg.pyramid)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    return j_bow.train(np.concatenate(descs)[:4000], branching=6, depth=3,
                       seed=0)


def _frames(gt, cfg):
    """The JAX tests' frames and scene (utils/corridor.py's renderer of
    the tracked loop): a stereo pair on frame 0 and on keyframes, a left
    image otherwise (float32, as rendered), in the 8 m wide corridor."""
    frames, _, scene = corridor._render(cfg, gt, corridor.TRACKED_BASELINE,
                                        width=8.0, u8=False)
    return frames, scene


def _closer(voc, cam, exclude_recent, package):
    return package.LoopCloser(voc, cam, exclude_recent=exclude_recent,
                              **CLOSER)


def _circle():
    """tests/test_loop_online.py:60's sequence: 48 frames of a 1 m circle,
    a keyframe every 3rd frame, exclude_recent 5."""
    return loop_trajectory(48, radius=1.0), _cfg(keyframe_every=3), 5


def _blind():
    """tests/test_loop_online.py:97's sequence: 18 forward frames with a
    keyframe every 2nd frame, exclude_recent 2; then three black frames
    and up to three views of frame 8's pose."""
    return (forward_yaw_trajectory(18, step=0.10, yaw_rate=0.01),
            _cfg(keyframe_every=2), 2)


def _black(cfg):
    return np.zeros((cfg.camera.height, cfg.camera.width), np.float32)


def _row(vo, pose):
    return dict(T_cw=np.asarray(pose, np.float32), lost=bool(vo.lost))


def _jax_run(gt, cfg, exclude_recent, prefix, blinded):
    """One of the JAX tests' runs on the JAX package (call inside
    reference_semantics()), as record entries under `prefix`."""
    from tests.test_torch_records import rows_arrays, voc_arrays
    jcfg = JConfig.from_json(cfg.to_json())
    frames, scene = _frames(gt, cfg)
    voc = _train_voc(scene, gt, jcfg)
    vo = j_vo.StereoVO(jcfg)
    vo.loop_closer = _closer(voc, vo.cam, exclude_recent, j_lc)
    if blinded:
        vo.min_track_inliers = 15
        frames = frames + [(_black(cfg), None)] * 3
    rows = []
    for left, right in frames:
        vo.track(left, right)
        rows.append(_row(vo, vo.trajectory[-1]))
    out = {f"{prefix}.entries": np.int32(vo.loop_closer.num_entries)}
    if blinded:
        view = scene.render(gt[8])
        for k in range(3):
            vo.track(view)
            frames.append((view, None))
            rows.append(_row(vo, vo.trajectory[-1]))
            if vo.reloc_events:
                break
        out[f"{prefix}.revisits"] = np.int32(k + 1)
    else:
        out[f"{prefix}.poses"] = vo.poses().astype(np.float32)
    out.update(rows_arrays(prefix, rows))
    out.update(voc_arrays(f"{prefix}.voc", voc, 0))
    out.update({f"{prefix}.loops": np.asarray(vo.loop_events, np.int32),
                f"{prefix}.relocs": np.asarray(vo.reloc_events, np.int32),
                f"{prefix}.frame_sha": np.asarray(
                    [parity.frame_sha(frames[0]),
                     parity.frame_sha(frames[-1])])})
    return out


def record_runs(log) -> dict:
    """Both JAX runs, as the record's part `loop_online`."""
    out = {}
    with reference_semantics():
        for name, seq, blinded in (("circle", _circle, False),
                                   ("blind", _blind, True)):
            p = f"loop_online.{name}"
            out.update(_jax_run(*seq(), p, blinded))
            log(f"{p}: loops {out[f'{p}.loops'].tolist()}, relocalizations "
                f"{out[f'{p}.relocs'].tolist()}, lost "
                f"{np.flatnonzero(out[f'{p}.lost']).tolist()}")
    return out


def _port_run(rec, gt, cfg, exclude_recent, prefix, blinded, monkeypatch):
    """The port over the frames of the record's run `prefix`, on JAX's
    draws and the record's vocabulary: (tracker, per-frame rows)."""
    monkeypatch.setattr(t_matcher, "draw_uniform",
                        ReferenceDraws().drawer("track"))
    vo = t_vo.StereoVO(cfg, device="cpu")
    vo.loop_closer = _closer(parity.record_vocabulary(
        rec, f"{prefix}.voc", torch.device("cpu")), vo.cam, exclude_recent,
        t_lc)
    frames, scene = _frames(gt, cfg)
    if blinded:
        vo.min_track_inliers = 15
        frames += [(_black(cfg), None)] * 3
        frames += [(scene.render(gt[8]), None)] * int(
            rec[f"{prefix}.revisits"])
    assert [parity.frame_sha(frames[0]), parity.frame_sha(frames[-1])] \
        == rec[f"{prefix}.frame_sha"].tolist()
    rows = []
    for left, right in frames:
        vo.track(left, right)
        rows.append(_row(vo, vo.trajectory[-1].numpy()))
    return vo, rows


@pytest.fixture(scope="module")
def record():
    rec = parity.load_record()
    if "loop_online.circle.T_cw" not in rec:
        pytest.fail("the record has no part loop_online: write it with "
                    "python -m tests.test_torch_records --write --part "
                    "loop_online")
    return rec


def test_online_loop_closure_fires_and_corrects_like_reference(record):
    """Both packages close the same loops on the circle (JAX's database,
    built online, holds >= 10 keyframes, as its test asks), every live
    and final pose within 1 cm of JAX's, and the corrected trajectory
    closes within 8 cm."""
    p = "loop_online.circle"
    gt, cfg, excl = _circle()
    with pytest.MonkeyPatch.context() as mp:
        vo, rows = _port_run(record, gt, cfg, excl, p, False, mp)
        P = vo.poses()
    assert record[f"{p}.entries"] >= 10
    assert vo.loop_closer.num_entries == record[f"{p}.entries"]
    assert len(record[f"{p}.loops"]) >= 1, "JAX closed no loop"
    assert vo.loop_events == record[f"{p}.loops"].tolist()
    assert vo.reloc_events == record[f"{p}.relocs"].tolist()
    live = parity.compare_poses(np.stack([r["T_cw"] for r in rows]),
                                record[f"{p}.T_cw"])
    assert live["max_diff_m"] < 0.01, live["max_diff_m"]
    final = parity.compare_poses(P, record[f"{p}.poses"])
    assert final["max_diff_m"] < 0.01, final["max_diff_m"]
    for poses in (P, record[f"{p}.poses"]):
        assert closing_error(poses, gt) < 0.08, closing_error(poses, gt)


def test_relocalization_fires_after_induced_loss_like_reference(record):
    """The black frames leave both packages lost; the revisit relocalizes
    both on the same frame, within 1 cm of each other and 5 cm of the
    revisited pose; the frames before the blinding within 1 cm."""
    p = "loop_online.blind"
    gt, cfg, excl = _blind()
    with pytest.MonkeyPatch.context() as mp:
        vo, rows = _port_run(record, gt, cfg, excl, p, True, mp)
    n = len(gt)
    assert record[f"{p}.entries"] >= 8
    assert vo.loop_closer.num_entries >= 8
    lost = np.asarray([r["lost"] for r in rows])
    np.testing.assert_array_equal(lost[:n + 3], record[f"{p}.lost"][:n + 3])
    assert lost[n + 2], "the black frames left tracking"
    assert len(record[f"{p}.relocs"]) >= 1, "JAX never relocalized"
    assert vo.reloc_events == record[f"{p}.relocs"].tolist()
    T = np.stack([r["T_cw"] for r in rows])
    before = parity.compare_poses(T[:n], record[f"{p}.T_cw"][:n])
    assert before["max_diff_m"] < 0.01, before["max_diff_m"]
    after = parity.compare_poses(T[-1:], record[f"{p}.T_cw"][-1:])
    assert after["max_diff_m"] < 0.01, after["max_diff_m"]
    c_gt = np.linalg.inv(gt[8])[:3, 3]
    for T_cw in (T[-1], record[f"{p}.T_cw"][-1]):
        c = np.linalg.inv(T_cw.astype(np.float64) @ gt[0])[:3, 3]
        assert np.linalg.norm(c - c_gt) < 0.05, (c, c_gt)
