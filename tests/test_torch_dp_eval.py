"""Batched multi-sequence tracking (parallel/dp_eval.py) on the CPU: B = 3
sequences cut as tests/test_dp_eval.py cuts them (one plane scene, steps
0.01 + 0.004 b) step as one vmapped program and must equal serial runs of
the port within 1e-5, and JAX's dp_track_step from the same states within
the carried-state tolerance (1e-3); the batched keyframe step must equal
serial keyframe steps with one sequence on each side of the stereo-prior
branch. No op may fall back to vmap's per-sequence loop (its warning is an
error here), and each hand kernel's batching rule runs once per step."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.geometry import camera as j_cam
from trackingbench_slam_tpu.models import vo as j_vo
from trackingbench_slam_tpu.parallel import dp_eval as j_dp
from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.models import vo as t_vo
from trackingbench_slam_tpu_torch.ops.cuda import batch
from trackingbench_slam_tpu_torch.parallel import batch_check, dp_eval
from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       ExtractorConfig,
                                                       MapConfig,
                                                       PipelineConfig,
                                                       PyramidConfig)
from trackingbench_slam_tpu_torch.utils.convert import vo_state_from_numpy
from trackingbench_slam_tpu_torch.utils.synthetic import (PlaneSequence,
                                                          lateral_trajectory)
from tests.test_torch_align import reference_tpu_semantics

CPU = torch.device("cpu")
B = 3
N_FRAMES = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    camc = CameraConfig(width=256, height=192, fx=220, fy=220, cx=128,
                        cy=96, bf=220 * 0.25)
    cfg = PipelineConfig(
        camera=camc, pyramid=PyramidConfig(num_levels=3, scale_factor=0.8),
        extractor=ExtractorConfig(num_features=256, min_threshold=10,
                                  cell_size=20),
        map=MapConfig(max_keyframes=4, max_points=2048),
        keyframe_every=10, local_ba_every=0)
    cam = t_cam.CameraParams.from_config(camc, CPU)
    scene = PlaneSequence(camc, depth=6.0)
    seqs = []
    for b in range(B):
        gt = lateral_trajectory(N_FRAMES + 1, step=0.01 + 0.004 * b)
        seqs.append([tuple(torch.from_numpy(np.asarray(x, np.float32))
                           for x in scene.stereo_pair(T, 0.25)) for T in gt])
    boot = []
    for b in range(B):
        left, right = seqs[b][0]
        st = t_vo.init_state(cfg, left)
        st = t_vo.keyframe_step(st, right, cam, cfg)
        boot.append(st._replace(frame_id=st.frame_id + 1))
    return cfg, cam, seqs, boot


def _generators():
    return [torch.Generator().manual_seed(b) for b in range(B)]


def _max_diff(a, b):
    fa, _ = torch.utils._pytree.tree_flatten(a)
    fb, _ = torch.utils._pytree.tree_flatten(b)
    assert len(fa) == len(fb)
    return max((x.double() - y.double()).abs().max().item()
               for x, y in zip(fa, fb) if x.numel())


def _assert_image_side_equal(o, s):
    """The leaves the images alone determine, bit-equal: every pyramid
    level, keypoint validity and levels, descriptors (the frame's and the
    keyframe ring's)."""
    for x, y in zip(o.prev.pyramid + o.prev.lk_pyr,
                    s.prev.pyramid + s.prev.lk_pyr):
        assert torch.equal(x, y)
    for name in ("valid", "kp_level", "desc"):
        assert torch.equal(getattr(o.prev, name), getattr(s.prev, name)), name
    for name in ("kp_valid", "kp_level", "desc"):
        assert torch.equal(getattr(o.kfs, name), getattr(s.kfs, name)), name


@pytest.fixture()
def no_vmap_fallback(monkeypatch):
    """Any 'performance drop' warning of vmap's per-sequence fallback
    raises; the batching rules' calls are counted per plain kernel."""
    calls = {}
    loop = batch.loop

    def counted(fn, size, *args, **kw):
        calls[fn.__name__] = calls.get(fn.__name__, 0) + 1
        return loop(fn, size, *args, **kw)
    monkeypatch.setattr(batch, "loop", counted)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yield calls


def test_stack_unstack_round_trip(setup):
    _, _, _, boot = setup
    stacked = dp_eval.stack_states(boot)
    assert stacked.T_cw.shape == (B, 4, 4)
    assert stacked.prev.lk_pyr[2].shape[0] == B
    back = dp_eval.unstack_states(stacked, B)
    for b in range(B):
        assert _max_diff(back[b], boot[b]) == 0.0
    moved = dp_eval.shard_batch(stacked, "cpu")
    assert _max_diff(moved, stacked) == 0.0


def test_batched_track_step_equals_serial_runs(setup, no_vmap_fallback):
    cfg, cam, seqs, boot = setup
    serial = []
    for b, g in enumerate(_generators()):
        st = boot[b]
        for i in range(1, N_FRAMES + 1):
            st = t_vo.track_step(st, seqs[b][i][0], cam, cfg, g)
        serial.append(st)
    gens = _generators()
    batched = dp_eval.stack_states(boot)
    for i in range(1, N_FRAMES + 1):
        imgs = torch.stack([seqs[b][i][0] for b in range(B)])
        batched = dp_eval.dp_track_step(batched, imgs, cam, cfg,
                                        dp_eval.draw_uniform(gens, cfg))
    # one batched LK launch a step (the rule's one call), nothing else
    assert no_vmap_fallback == {"lk_align_plain": N_FRAMES}
    out = dp_eval.unstack_states(batched, B)
    for b in range(B):
        np.testing.assert_allclose(out[b].T_cw.numpy(),
                                   serial[b].T_cw.numpy(), atol=1e-5)
        assert _max_diff(out[b], serial[b]) < 1e-3
        assert int(out[b].num_inliers) == int(serial[b].num_inliers) > 100
    # the sequences differ: the batch is not one sequence three times
    assert not np.allclose(serial[0].T_cw.numpy(), serial[-1].T_cw.numpy(),
                           atol=1e-4)


def _ops_in_track_step(setup, b):
    """Op counts of one batched track step, the kernels' batching rules
    stubbed to one plain call (on the CPU they loop over the sequences, on
    the card they are one launch)."""
    cfg, cam, seqs, boot = setup
    states = dp_eval.stack_states(boot[:1] * b)
    imgs = seqs[0][1][0].expand((b,) + tuple(seqs[0][1][0].shape))
    u = dp_eval.draw_uniform([torch.Generator().manual_seed(0)] * b, cfg)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        dp_eval.dp_track_step(states, imgs, cam, cfg, u)
    return {e.key: e.count for e in prof.key_averages()}


def test_batched_step_runs_no_op_once_per_sequence(setup, monkeypatch):
    """vmap warns when an op has no batching rule, but some rules loop over
    the batch silently (index_add with a batched index did): the ops of a
    batched track step must not grow with the batch."""
    def one_call(fn, size, *args, **kw):
        out = fn(*batch._pick(args, 0),
                 **{k: batch._pick(v, 0) for k, v in kw.items()})
        return tuple(x.expand((size,) + tuple(x.shape)) for x in out)
    monkeypatch.setattr(batch, "loop", one_call)
    two, four = _ops_in_track_step(setup, 2), _ops_in_track_step(setup, 4)
    grown = {k: (two.get(k, 0), n) for k, n in four.items()
             if n > two.get(k, 0)}
    assert not grown, grown


def test_batched_track_step_matches_reference_dp_track_step(setup):
    """JAX's vmapped track step (unsharded, its TPU branches in interpret
    mode) and the port's batched step from the same converted states."""
    cfg, _, seqs, _ = setup
    jcfg = JConfig.from_json(cfg.to_json())
    jcam = j_cam.CameraParams.from_config(jcfg.camera)
    with reference_tpu_semantics():
        jboot = []
        for b in range(B):
            left, right = (jnp.asarray(x.numpy()) for x in seqs[b][0])
            st = j_vo.init_state(jcfg, left)
            st = j_vo.keyframe_step(st, right, jcam, jcfg)
            jboot.append(st._replace(frame_id=st.frame_id + 1))
        imgs = jnp.stack([jnp.asarray(seqs[b][1][0].numpy())
                          for b in range(B)])
        jout = j_dp.dp_track_step(j_dp.stack_states(jboot), imgs, jcam, jcfg)
        jout = jax.tree.map(np.asarray, jout)
        jboot = [jax.tree.map(np.asarray, s) for s in jboot]
    states = dp_eval.stack_states([vo_state_from_numpy(s, CPU)
                                   for s in jboot])
    cam = t_cam.CameraParams.from_config(cfg.camera, CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = dp_eval.dp_track_step(
            states, torch.stack([seqs[b][1][0] for b in range(B)]), cam, cfg,
            dp_eval.draw_uniform(_generators(), cfg))
    for b in range(B):
        dT = (np.linalg.inv(jout.T_cw[b].astype(np.float64))
              @ out.T_cw[b].numpy().astype(np.float64))
        rot = np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))
        assert np.linalg.norm(dT[:3, 3]) < 1e-3 and rot < 1e-3, b
        n_j = int(jout.num_inliers[b])
        assert abs(int(out.num_inliers[b]) - n_j) <= 0.1 * n_j
    assert (out.frame_id.numpy() == jout.frame_id).all()


def test_batched_keyframe_step_takes_each_sequences_branch(
        setup, no_vmap_fallback):
    """Sequence 0 is a fresh state (no landmark: no stereo prior, the full
    pyramid); sequences 1 and 2 carry a tracked frame (the primed 2-level
    call). Each must equal its own serial keyframe step."""
    cfg, cam, seqs, boot = setup
    fresh = t_vo.init_state(cfg, seqs[0][0][0])
    gens = _generators()
    states = [fresh] + [t_vo.track_step(boot[b], seqs[b][1][0], cam, cfg,
                                        gens[b]) for b in (1, 2)]
    rights = [seqs[0][0][1], seqs[1][1][1], seqs[2][1][1]]
    serial = [t_vo.keyframe_step(s, r, cam, cfg)
              for s, r in zip(states, rights)]
    stacked = dp_eval.stack_states(states)
    batched = torch.func.vmap(
        lambda s, r: t_vo.keyframe_step(s, r, cam, cfg, both_branches=True),
        randomness="error")(stacked, torch.stack(rights))
    # per rule one batched call: anchored LK + both stereo branches, FAST,
    # ORB describe, anchor cells
    assert no_vmap_fallback == {"lk_align_plain": 3,
                                "fast_score_nms_plain_levels": 1,
                                "orb_describe_plain": 1,
                                "anchor_cells_plain": 1}
    out = dp_eval.unstack_states(batched, B)
    assert int(serial[0].kfs.valid.sum()) == 1
    for b in range(B):
        assert _max_diff(out[b], serial[b]) < 1e-5, b
        _assert_image_side_equal(out[b], serial[b])
    assert int(serial[0].map.valid.sum()) > 50


def test_batched_track_and_keyframe_step_equals_serial(setup,
                                                       no_vmap_fallback):
    cfg, cam, seqs, boot = setup
    gens = _generators()
    serial = [t_vo.track_and_keyframe_step(boot[b], seqs[b][1][0],
                                           seqs[b][1][1], cam, cfg, gens[b])
              for b in range(B)]
    out = dp_eval.dp_track_and_keyframe_step(
        dp_eval.stack_states(boot),
        torch.stack([seqs[b][1][0] for b in range(B)]),
        torch.stack([seqs[b][1][1] for b in range(B)]), cam, cfg,
        dp_eval.draw_uniform(_generators(), cfg))
    assert no_vmap_fallback["lk_align_plain"] == 4
    for b, o in enumerate(dp_eval.unstack_states(out, B)):
        np.testing.assert_allclose(o.T_cw.numpy(), serial[b].T_cw.numpy(),
                                   atol=1e-5)
        assert _max_diff(o, serial[b]) < 1e-3
        _assert_image_side_equal(o, serial[b])
        assert int(o.kfs.valid.sum()) == 2


def test_batch_check_finds_no_image_side_call_differing(setup):
    """parallel/batch_check.py on the keyframe frame's inputs: every stage
    of the track and keyframe steps recorded, no call that differs between
    the serial and the vmapped run on the same inputs (on the CPU not even
    a float: the pose solve's sums and the se3 products are fixed-order),
    every call repeating itself, and the whole batched steps equal to the
    serial ones."""
    cfg, cam, seqs, boot = setup
    report = batch_check.batch_check(
        boot, [seqs[b][1][0] for b in range(B)],
        [seqs[b][1][1] for b in range(B)], cam, cfg,
        dp_eval.draw_uniform(_generators(), cfg))
    stages = {c["stage"] for c in report["calls"]}
    assert set(batch_check.STAGES) | {"track.rest", "keyframe.rest"} \
        <= stages
    assert report["image_side_differing"] == []
    assert report["not_repeatable"] == []
    assert report["differing_by_stage"] == {}
    assert report["steps"] == {"track_step": {},
                               "track_and_keyframe_step": {}}


def test_dp_eval_bench_reports_both_batch_sizes(setup):
    cfg, _, seqs, _ = setup
    frames = [tuple(x.numpy() for x in f) for f in seqs[0]]
    out = dp_eval.dp_eval_bench(cfg, frames, B=2, steps=1, device="cpu")
    assert set(out) == {"B1_seq_frames_per_s", "B2_seq_frames_per_s",
                        "batch_speedup"}
    assert all(v > 0 for v in out.values())
    assert out["batch_speedup"] == pytest.approx(
        out["B2_seq_frames_per_s"] / out["B1_seq_frames_per_s"])


def test_chip_smoke_holds_batched_keyframes_to_serial(setup):
    """chip_smoke.py's gate of a batched keyframe step: equal states pass;
    a descriptor bit, a fresh keypoint moved by 1e-3 px, a pyramid pixel,
    the atlas or a landmark past 1e-4 m fail; a landmark within 1e-4 m
    passes."""
    import chip_smoke
    cfg, cam, seqs, boot = setup
    before = [t_vo.track_step(boot[b], seqs[b][1][0], cam, cfg, g)
              for b, g in enumerate(_generators())]
    serial = [t_vo.keyframe_step(s, seqs[b][1][1], cam, cfg)
              for b, s in enumerate(before)]
    assert chip_smoke.held_to_serial(serial, serial, before)["failures"] == []
    s0 = serial[0]
    fresh = int(torch.nonzero(s0.prev.valid & ~before[0].prev.valid)[0, 0])
    live = int(torch.nonzero(s0.map.valid)[0, 0])

    def failures(state):
        return chip_smoke.held_to_serial([state] + serial[1:], serial,
                                         before)["failures"]

    desc = s0.prev.desc.clone()
    desc[fresh, 0] ^= 1
    assert failures(s0._replace(prev=s0.prev._replace(desc=desc))) == [
        ".prev.desc"]
    xy = s0.prev.kp_xy.clone()
    xy[fresh, 0] += 1e-3
    assert failures(s0._replace(prev=s0.prev._replace(kp_xy=xy))) == [
        "fresh keypoint positions"]
    pyr = list(s0.prev.pyramid)
    pyr[1] = pyr[1].clone()
    pyr[1][5, 5] += 1e-3
    assert failures(s0._replace(prev=s0.prev._replace(
        pyramid=tuple(pyr)))) == [".prev.pyramid[1]"]
    atlas = s0.map.anchor_atlas.clone()
    atlas[0, 0] += 1e-3
    assert failures(s0._replace(map=s0.map._replace(
        anchor_atlas=atlas))) == [".map.anchor_atlas"]
    for shift, failed in ((5e-5, []), (2e-4, [".map.pos"])):
        pos = s0.map.pos.clone()
        pos[live, 0] += shift
        assert failures(s0._replace(map=s0.map._replace(pos=pos))) == failed
