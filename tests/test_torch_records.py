"""The JAX package's record at full width, and the port held to it frame by
frame from carried state.

As a script (from the repository root, on the CPU):

    python -m tests.test_torch_records --write [--part NAME] [--parts DIR]
    python -m tests.test_torch_records --carried A:B [--part loop_tracked
        --frames N]

`--write` runs the JAX package on its TPU branches (Pallas in interpret
mode, `tests/test_torch_align.py` `reference_tpu_semantics`; never its
XLA-CPU branch, whose ORB descriptors differ) over the loop bench
(bench.py:322-404, without and with bench.py's LoopCloser) and the direct,
indirect (five strategies) and mono trackers at the configurations that
chip_smoke.py phases 10-12 run, and writes
trackingbench_slam_tpu_torch/records/jax_full_width.npz: every frame's
pose and counters, the loop and relocalization frames, the vocabularies,
the F-RANSAC hypothesis indices JAX's gumbel top-8 picked, and metadata
(semantics, versions, the ORB pattern id, a sha256 of every source file of
the JAX package and of the first and last frame of each sequence). Each
sequence is written as a part first (`--parts`, default
.bench_cache/records; the loop bench's run A also every 24 frames with a
checkpoint to resume from), and the record is assembled once every part is
there. `--part` writes one part only.

`--carried A:B` runs JAX's loop bench (run A; with `--part loop_tracked`
the tracked loop at `--frames` frames, closer-less) up to frame A and
then, for every frame from A to B, steps the port on the CPU from JAX's
state with JAX's draws, printing per stage (the track step, and inside it
LK, F-RANSAC and the pose solve from the same inputs; the keyframe; BA)
where the two first differ.

As tests (tier-1): the record's keys and shapes, its vocabularies through
`vocabulary_from_numpy`, its first and last frames rendered again against
their sha256, the draws it stores through `parity.draws_selecting`, and a
carried-state run at 320x240 with the loop bench's settings, each port
step started from the JAX state and held to JAX's next state.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    # as a script: JAX on the CPU, as tests/conftest.py sets it for pytest
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")

import contextlib
import glob
import hashlib
import json
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.bow import vocabulary as j_bow
from trackingbench_slam_tpu.geometry import camera as j_cam
from trackingbench_slam_tpu.matchers import matcher as j_matcher
from trackingbench_slam_tpu.models import direct_vo as j_dv
from trackingbench_slam_tpu.models import indirect_vo as j_iv
from trackingbench_slam_tpu.models import mono_vo as j_mv
from trackingbench_slam_tpu.models import vo as j_vo
from trackingbench_slam_tpu.models.extractors import extract_orb as j_orb
from trackingbench_slam_tpu.models.frame import make_frame as j_make_frame
from trackingbench_slam_tpu.models.loop_closer import LoopCloser as JCloser
from trackingbench_slam_tpu.ops import orb as j_orb_ops
from trackingbench_slam_tpu.ops import ransac as j_ransac
from trackingbench_slam_tpu.utils.config import PipelineConfig as JConfig
from trackingbench_slam_tpu_torch import parity
from trackingbench_slam_tpu_torch.parity import frame_sha
from trackingbench_slam_tpu_torch.geometry import camera as t_cam
from trackingbench_slam_tpu_torch.matchers import matcher as t_matcher
from trackingbench_slam_tpu_torch.models import local_mapping as t_lm
from trackingbench_slam_tpu_torch.models import vo as t_vo
from trackingbench_slam_tpu_torch.ops import align as t_align
from trackingbench_slam_tpu_torch.ops import fast as t_fast
from trackingbench_slam_tpu_torch.ops import orb as t_orb
from trackingbench_slam_tpu_torch.ops import ransac as t_ransac
from trackingbench_slam_tpu_torch.ops.cuda import lk_kernel as t_lk_kernel
from trackingbench_slam_tpu_torch.utils import corridor
from trackingbench_slam_tpu_torch.utils.config import SolverConfig
from trackingbench_slam_tpu_torch.utils.convert import (vo_state_from_numpy,
                                                        vocabulary_to_numpy)
from trackingbench_slam_tpu_torch.utils.device import HostCopy
from trackingbench_slam_tpu_torch.utils.synthetic import (
    CorridorScene, forward_yaw_trajectory, lateral_trajectory,
    loop_trajectory)
from trackingbench_slam_tpu_torch.utils.config import euroc_stereo_config
from tests.conftest import make_textured_image
from tests.test_torch_align import reference_tpu_semantics
from tests.test_torch_kernels import _blur_np
from tests.test_torch_vo import small_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "trackingbench_slam_tpu_torch", "records",
                      "jax_full_width.npz")
PARTS = os.path.join(REPO, ".bench_cache", "records")
JAX_SOURCES = os.path.join(REPO, "trackingbench_slam_tpu")
STRATEGIES = ("nn", "bf", "window", "bow", "projection")
CLOSER = dict(min_score=0.015, min_inliers=40, exclude_recent=5)
SEQUENCES = ("loop", "direct", "indirect", "mono", "loop_tracked",
             "loop_tracked48", "loop_online")


# --------------------------------------------------------------- recording

def source_hashes() -> dict:
    """{path under trackingbench_slam_tpu/: sha256} of every .py file."""
    out = {}
    for path in sorted(glob.glob(os.path.join(JAX_SOURCES, "**", "*.py"),
                                 recursive=True)):
        with open(path, "rb") as fh:
            out[os.path.relpath(path, REPO)] = hashlib.sha256(
                fh.read()).hexdigest()
    return out


@contextlib.contextmanager
def ransac_tap(sink):
    """While inside, every F-RANSAC call of the JAX package also sends its
    (256, 8) hypothesis indices and its valid mask to `sink` (a list), as
    (site, idx, valid): "track" for search_by_opflow's call, "bootstrap"
    for the mono bootstrap's. The indices are the gumbel top-8 of the
    function itself, on the same key; the call's result is the function's
    own."""
    original = j_ransac.fundamental_ransac

    def tapped(site):
        def call(p1, p2, valid, key, threshold=3.0, num_samples=256):
            n = p1.shape[0]
            logits = jnp.where(valid, 0.0, -1e9)
            gumbel = -jnp.log(-jnp.log(jax.random.uniform(
                key, (num_samples, n), minval=1e-9, maxval=1.0) + 1e-12))
            _, idx = jax.lax.top_k(logits[None, :] + gumbel, 8)
            jax.debug.callback(
                lambda i, v: sink.append((site, np.asarray(i),
                                          np.asarray(v))), idx, valid)
            return original(p1, p2, valid, key, threshold, num_samples)
        return call

    jax.clear_caches()
    j_matcher.fundamental_ransac = tapped("track")
    j_ransac.fundamental_ransac = tapped("bootstrap")
    try:
        yield
    finally:
        j_matcher.fundamental_ransac = original
        j_ransac.fundamental_ransac = original
        jax.clear_caches()


@contextlib.contextmanager
def anchored_search_padded():
    """While inside, the JAX package's anchored_align gets its search image
    (the frame) zero-padded to the template image's (the atlas's) padded
    shape. Its Pallas kernel copies each search window from the search
    image as if that image had the template image's padded shape; with a
    frame smaller than the atlas, a window past the frame's right or bottom
    edge then runs outside it. In interpret mode that copy is a clamped
    dynamic slice, which shifts the window and answers for the wrong
    pixels. With the frame padded every window lies inside it, and the
    kernel answers as the port's lk_align does (zero padding,
    tests/test_torch_kernels.py test_lk_search_image_smaller_than_
    template_image)."""
    from trackingbench_slam_tpu.ops import align as j_align
    original = j_align.anchored_align

    def padded(atlas, img, centers, init_xy, valid, half=4, **kw):
        hp, wp = t_lk_kernel.padded_shape(atlas.shape[0], atlas.shape[1],
                                          half)
        img = jnp.pad(img, ((0, max(hp - img.shape[0], 0)),
                            (0, max(wp - img.shape[1], 0))))
        return original(atlas, img, centers, init_xy, valid, half=half,
                        **kw)

    jax.clear_caches()
    j_align.anchored_align = padded
    try:
        yield
    finally:
        j_align.anchored_align = original
        jax.clear_caches()


@contextlib.contextmanager
def reference_semantics():
    """The JAX package as the record runs it: its TPU branches in interpret
    mode (tests/test_torch_align.py reference_tpu_semantics), with the
    anchored search image padded (anchored_search_padded)."""
    with reference_tpu_semantics(), anchored_search_padded():
        yield


class Calls:
    """The RANSAC calls of one run, each tagged with its frame."""

    def __init__(self):
        self.sink, self.frame, self.site, self.idx, self.valid = \
            [], [], [], [], []

    def take(self, i):
        jax.effects_barrier()
        for site, idx, valid in self.sink:
            self.frame.append(i)
            self.site.append(0 if site == "track" else 1)
            self.idx.append(idx.astype(np.int16))
            self.valid.append(np.packbits(valid))
        self.sink.clear()

    def arrays(self, prefix):
        n = len(self.idx)
        return {f"{prefix}.ransac_frame": np.asarray(self.frame, np.int32),
                f"{prefix}.ransac_site": np.asarray(self.site, np.int8),
                f"{prefix}.ransac_idx": (np.stack(self.idx) if n else
                                         np.zeros((0, 256, 8), np.int16)),
                f"{prefix}.ransac_valid": (np.stack(self.valid) if n else
                                           np.zeros((0, 0), np.uint8))}


def voc_arrays(prefix, voc, n_desc):
    out = {f"{prefix}.level{i}": np.asarray(t)
           for i, t in enumerate(voc.levels)}
    out.update({f"{prefix}.word_weights": np.asarray(voc.word_weights),
                f"{prefix}.branching": np.int32(voc.branching),
                f"{prefix}.depth": np.int32(voc.depth),
                f"{prefix}.levels_up": np.int32(voc.levels_up),
                f"{prefix}.descriptors": np.int32(n_desc)})
    return out


def train_jax_vocabulary(jcfg, frames, every):
    """bench.py's vocabulary recipe on the JAX package's ORB: every
    `every`-th left image, the first 4000 valid descriptors, k = 6, L = 3,
    seed 0."""
    cam = j_cam.CameraParams.from_config(jcfg.camera)
    descs = []
    for i in range(0, len(frames), every):
        f = j_make_frame(jnp.asarray(frames[i][0], jnp.float32),
                         jcfg.extractor.num_features,
                         jcfg.pyramid.num_levels, jcfg.pyramid.scale_factor)
        f = j_orb(f, cam, jcfg.extractor, jcfg.pyramid)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    descs = np.concatenate(descs)[:4000]
    return j_bow.train(descs, branching=6, depth=3, seed=0), len(descs)


def _host(x):
    return jax.tree.map(np.asarray, x)


def _device(x):
    return jax.tree.map(jnp.asarray, x)


def stereo_checkpoint(vo, rows, calls, path):
    """A closer-less JAX StereoVO's state and the rows so far, to resume."""
    d = {k: v for k, v in vo.__dict__.items()
         if k not in ("cfg", "cam", "loop_closer")}
    d = dict(d, state=_host(d["state"]),
             trajectory=[np.asarray(T) for T in d["trajectory"]],
             _pending_inliers=np.asarray(d["_pending_inliers"]))
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(dict(vo=d, rows=rows, calls=calls.__dict__), fh)
    os.replace(path + ".tmp", path)


def stereo_resume(vo, path, calls):
    with open(path, "rb") as fh:
        saved = pickle.load(fh)
    d = saved["vo"]
    d.update(state=_device(d["state"]),
             trajectory=[jnp.asarray(T) for T in d["trajectory"]],
             _pending_inliers=jnp.asarray(d["_pending_inliers"]))
    vo.__dict__.update(d)
    calls.__dict__.update(saved["calls"])
    return saved["rows"]


def stereo_row(vo, kf_before):
    st = vo.state
    kf = vo._kf_count > kf_before
    return dict(T_cw=np.asarray(vo.trajectory[-1], np.float32),
                inliers=int(st.num_inliers), lost=bool(vo.lost),
                keyframe=kf,
                ba=bool(kf and vo.cfg.local_ba_every > 0
                        and vo._kf_count % vo.cfg.local_ba_every == 0),
                landmarks=int(np.asarray(st.map.valid).sum()))


def rows_arrays(prefix, rows):
    out = {}
    for k in rows[0]:
        a = np.stack([r[k] for r in rows])
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        out[f"{prefix}.{k}"] = a
    return out


def run_loop_bench(jcfg, frames, gt, voc, with_closer, prefix, parts_dir,
                   log):
    """One JAX loop-bench run, a row a frame; run A is checkpointed every
    24 frames."""
    vo = j_vo.StereoVO(jcfg)
    if with_closer:
        vo.loop_closer = JCloser(voc, vo.cam, **CLOSER)
    calls = Calls()
    rows, start = [], 0
    ckpts = sorted(glob.glob(os.path.join(
        parts_dir, f"{prefix}.ckpt[0-9][0-9][0-9].pkl")))
    if not with_closer and ckpts:
        rows = stereo_resume(vo, ckpts[-1], calls)
        start = len(rows)
        log(f"{prefix}: resumed at frame {start}")
    with ransac_tap(calls.sink):
        for i in range(start, len(frames)):
            t0 = time.perf_counter()
            kf_before = vo._kf_count
            vo.track(*frames[i])
            calls.take(i)
            rows.append(stereo_row(vo, kf_before))
            r = rows[-1]
            log(f"{prefix} f{i:3d} inliers={r['inliers']:5d} "
                f"lost={int(r['lost'])} kf={int(r['keyframe'])} "
                f"ba={int(r['ba'])} lm={r['landmarks']} "
                f"{time.perf_counter() - t0:.1f} s")
            if not with_closer and (i + 1) % 24 == 0 and i + 1 < len(frames):
                stereo_checkpoint(vo, rows, calls, os.path.join(
                    parts_dir, f"{prefix}.ckpt{i + 1:03d}.pkl"))
        poses = vo.poses()
    out = rows_arrays(prefix, rows)
    out.update(calls.arrays(prefix))
    out.update({f"{prefix}.poses": poses.astype(np.float32),
                f"{prefix}.closing_err_m": np.float64(
                    corridor.closing_error(poses, gt)),
                f"{prefix}.loops": np.asarray(vo.loop_events, np.int32),
                f"{prefix}.relocs": np.asarray(vo.reloc_events, np.int32)})
    return out


def write_loop(parts_dir, log, n=96):
    cfg = corridor.loop_bench_config()
    jcfg = JConfig.from_json(cfg.to_json())
    frames, gt, _ = corridor.loop_frames(cfg, n)
    out = {"loop.frame_sha": np.asarray([frame_sha(frames[0]),
                                         frame_sha(frames[-1])]),
           "loop.gt": gt.astype(np.float32)}
    with reference_semantics():
        voc, n_desc = train_jax_vocabulary(jcfg, frames, 12)
        out.update(voc_arrays("loop.voc", voc, n_desc))
        log(f"loop: vocabulary from {n_desc} descriptors")
        for run, closer in (("A", False), ("B", True)):
            out.update(run_loop_bench(jcfg, frames, gt, voc, closer,
                                      f"loop.{run}", parts_dir, log))
    return out


def write_loop_tracked(parts_dir, log, n=parity.TRACKED_FRAMES,
                       name="loop_tracked", closerless=True):
    """The tracked loop (utils/corridor.py tracked_loop_config and
    tracked_loop_frames: the JAX package's own loop test's circle, at
    parity.TRACKED_FRAMES frames) with
    bench.py's LoopCloser (the test's settings too) on a vocabulary
    trained from JAX's ORB of every 4th left image (the test's recipe),
    `loop_tracked.closer`, and with `closerless` without it,
    `loop_tracked.without`: every frame's row and F-RANSAC draws."""
    cfg = corridor.tracked_loop_config()
    jcfg = JConfig.from_json(cfg.to_json())
    frames, gt = corridor.tracked_loop_frames(cfg, n)
    out = {f"{name}.frame_sha": np.asarray([frame_sha(frames[0]),
                                            frame_sha(frames[-1])]),
           f"{name}.gt": gt.astype(np.float32)}
    with reference_semantics():
        voc, n_desc = train_jax_vocabulary(
            jcfg, frames, parity.VOC_EVERY["loop_tracked"])
        out.update(voc_arrays(f"{name}.voc", voc, n_desc))
        log(f"{name}: {n} frames, vocabulary from {n_desc} descriptors")
        for run, closer in (("closer", True), ("without", False)):
            if closer or closerless:
                out.update(run_loop_bench(jcfg, frames, gt, voc, closer,
                                          f"{name}.{run}", parts_dir, log))
    return out


def write_loop_tracked48(parts_dir, log, n=48):
    """The tracked loop at the JAX loop test's own 48 frames, with the
    closer only, `loop_tracked48.closer` (chip_smoke.py's run E48)."""
    return write_loop_tracked(parts_dir, log, n, "loop_tracked48", False)


def write_direct(parts_dir, log, n=24):
    cfg = corridor.direct_config()
    jcfg = JConfig.from_json(cfg.to_json())
    frames, gt = corridor.direct_frames(cfg, n)
    rows = []
    with reference_semantics():
        vo = j_dv.DirectVO(jcfg)
        for i, f in enumerate(frames):
            t0 = time.perf_counter()
            vo.track(*f)
            rows.append(dict(T_cw=np.asarray(vo.T_cw, np.float32),
                             tracked=vo.num_tracked,
                             promoted=vo.num_promoted))
            log(f"direct f{i:3d} tracked={rows[-1]['tracked']} promoted="
                f"{rows[-1]['promoted']} {time.perf_counter() - t0:.1f} s")
        poses = vo.poses()
    out = rows_arrays("direct", rows)
    out.update({"direct.poses": poses.astype(np.float32),
                "direct.gt": gt.astype(np.float32),
                "direct.frame_sha": np.asarray([frame_sha(frames[0]),
                                                frame_sha(frames[-1])])})
    return out


def write_indirect(parts_dir, log, n=12):
    cfg = euroc_stereo_config()
    jcfg = JConfig.from_json(cfg.to_json())
    frames, gt = corridor.indirect_frames(cfg, n)
    out = {"indirect.gt": gt.astype(np.float32),
           "indirect.frame_sha": np.asarray([frame_sha(frames[0]),
                                             frame_sha(frames[-1])])}
    with reference_semantics():
        voc, n_desc = train_jax_vocabulary(jcfg, frames, 3)
        out.update(voc_arrays("indirect.voc", voc, n_desc))
        for s in STRATEGIES:
            strategy = j_iv.MatchStrategy(s)
            vo = j_iv.IndirectVO(jcfg, strategy,
                                 voc=voc if s == "bow" else None)
            rows = []
            for i, f in enumerate(frames):
                t0 = time.perf_counter()
                vo.track(*f)
                rows.append(dict(T_cw=np.asarray(vo.state.T_cw, np.float32),
                                 inliers=int(vo.state.num_inliers)))
                log(f"indirect {s} f{i:3d} inliers={rows[-1]['inliers']} "
                    f"{time.perf_counter() - t0:.1f} s")
            out.update(rows_arrays(f"indirect.{s}", rows))
            out[f"indirect.{s}.poses"] = vo.poses().astype(np.float32)
    return out


def write_mono(parts_dir, log, n=28):
    cfg = corridor.mono_config()
    jcfg = JConfig.from_json(cfg.to_json())
    frames, gt = corridor.mono_frames(cfg, n)
    calls, rows = Calls(), []
    with reference_semantics(), ransac_tap(calls.sink):
        vo = j_mv.MonoVO(jcfg, min_parallax_px=20.0)
        for i, img in enumerate(frames):
            t0 = time.perf_counter()
            vo.track(img)
            calls.take(i)
            init = vo.initialized
            rows.append(dict(
                T_cw=np.asarray(vo.trajectory[-1], np.float32),
                initialized=bool(init),
                inliers=int(vo.state.num_inliers) if init else 0,
                landmarks=(int(np.asarray(vo.state.map.valid).sum())
                           if init else 0)))
            log(f"mono f{i:3d} init={int(init)} inliers="
                f"{rows[-1]['inliers']} lm={rows[-1]['landmarks']} "
                f"{time.perf_counter() - t0:.1f} s")
        poses = vo.poses()
    out = rows_arrays("mono", rows)
    out.update(calls.arrays("mono"))
    init = np.flatnonzero(out["mono.initialized"])
    out.update({"mono.poses": poses.astype(np.float32),
                "mono.gt": gt.astype(np.float32),
                "mono.init_frame": np.int32(init[0] if len(init) else -1),
                "mono.kf_count": np.int32(vo._kf_count),
                "mono.frame_sha": np.asarray([frame_sha(frames[0]),
                                              frame_sha(frames[-1])])})
    return out


def write_loop_online(parts_dir, log, n=None):
    """tests/test_loop_online.py's two runs (tests/test_torch_loop_online.py
    record_runs)."""
    from tests.test_torch_loop_online import record_runs
    return record_runs(log)


WRITERS = dict(loop=write_loop, direct=write_direct, indirect=write_indirect,
               mono=write_mono, loop_tracked=write_loop_tracked,
               loop_tracked48=write_loop_tracked48,
               loop_online=write_loop_online)


def metadata() -> dict:
    return {"meta.semantics": np.asarray("tpu-interpret"),
            "meta.jax": np.asarray(jax.__version__),
            "meta.numpy": np.asarray(np.__version__),
            "meta.anchored_search": np.asarray(
                "zero-padded to the atlas's padded shape"),
            "meta.pattern_id": np.asarray(j_orb_ops.pattern_id()),
            "meta.sources": np.asarray(json.dumps(source_hashes(),
                                                  sort_keys=True))}


def write(parts_dir, only=None, frames=None):
    """Writes the parts asked for (all, or `only`) that are not in
    `parts_dir` yet, then assembles the record: each sequence from its
    part, or, where no part was written, from the record as it is (a
    sequence with neither is left out, and the tests that read it fail)."""
    os.makedirs(parts_dir, exist_ok=True)

    def log(msg):
        print(msg, flush=True)

    for name in (only,) if only else SEQUENCES:
        path = os.path.join(parts_dir, f"{name}.npz")
        if os.path.exists(path):
            log(f"{name}: part exists, kept")
            continue
        t0 = time.perf_counter()
        kw = {} if frames is None else dict(n=frames)
        out = WRITERS[name](parts_dir, log, **kw)
        out[f"{name}.seconds"] = np.float64(time.perf_counter() - t0)
        np.savez_compressed(path, **out)
        log(f"{name}: part written, {out[f'{name}.seconds']:.0f} s")
    old = parity.load_record() if os.path.exists(RECORD) else {}
    out = metadata()
    for name in SEQUENCES:
        path = os.path.join(parts_dir, f"{name}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                out.update({k: z[k] for k in z.files})
            continue
        kept = {k: v for k, v in old.items() if k.startswith(f"{name}.")}
        if not kept:
            log(f"{name}: no part and no record entries, left out")
        out.update(kept)
    os.makedirs(os.path.dirname(RECORD), exist_ok=True)
    np.savez_compressed(RECORD, **out)
    log(f"record written: {os.path.getsize(RECORD)} bytes")


# ------------------------------------------------------- carried-state steps

def jax_draws(key, n: int) -> torch.Tensor:
    """The (256, n) uniforms JAX's next track step draws from its state's
    key (vo.py:89 splits it, ransac.py draws from the second half)."""
    _, sub = jax.random.split(key)
    return torch.from_numpy(np.array(jax.random.uniform(
        sub, (256, n), minval=1e-9, maxval=1.0)))


def port_from_jax(jvo, device) -> t_vo.StereoVO:
    """A closer-less port StereoVO carrying a JAX StereoVO's state and host
    counters, as they are before its next frame."""
    tvo = t_vo.StereoVO(jvo.cfg_port, device=device)
    tvo.state = vo_state_from_numpy(_host(jvo.state), device)
    tvo.trajectory = [tvo.state.T_cw]
    tvo._fid, tvo._kf_count, tvo.lost = jvo._fid, jvo._kf_count, jvo.lost
    tvo._reloc_fails, tvo._reloc_cooldown = (jvo._reloc_fails,
                                             jvo._reloc_cooldown)
    if jvo._pending_inliers is not None:
        tvo._pending = HostCopy(torch.tensor(
            int(jvo._pending_inliers), dtype=torch.int32, device=device))
    return tvo


@contextlib.contextmanager
def given_draws(u: torch.Tensor):
    """The port's track-step draws are `u` while inside."""
    saved = t_matcher.draw_uniform
    t_matcher.draw_uniform = lambda s, n, g, device: u.to(device)
    try:
        yield
    finally:
        t_matcher.draw_uniform = saved


def pose_difference(T_a, T_b) -> tuple:
    """(translation m, rotation rad) of T_b^-1 T_a; the angle from both the
    skew and the trace part, accurate near zero where arccos of the trace
    is not in float32-rounded rotations."""
    dT = np.linalg.inv(np.asarray(T_b, np.float64)) @ np.asarray(T_a,
                                                                 np.float64)
    R = dT[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return (float(np.linalg.norm(dT[:3, 3])),
            float(np.arctan2(np.linalg.norm(w) / 2, (np.trace(R) - 1) / 2)))


def carried_frame(jvo, frame, device) -> dict:
    """One frame from JAX's state: the port's StereoVO steps from it on
    JAX's draws, JAX's own steps on; both results side by side."""
    tvo = port_from_jax(jvo, device)
    u = jax_draws(jvo.state.key, jvo.state.prev.kp_xy.shape[0])
    kf_j, kf_t, ba_t = jvo._kf_count, tvo._kf_count, tvo.ba_calls
    with given_draws(u):
        tvo.track(*frame)
    jvo.track(*frame)
    st_j, st_t = jvo.state, tvo.state
    kf = jvo._kf_count > kf_j
    dt, drot = pose_difference(st_t.T_cw.numpy(), np.asarray(st_j.T_cw))
    return dict(
        dt_m=dt, drot=drot,
        inliers=(int(st_t.num_inliers), int(st_j.num_inliers)),
        lost=(tvo.lost, jvo.lost),
        keyframe=(tvo._kf_count > kf_t, kf),
        ba=(tvo.ba_calls > ba_t, bool(
            kf and jvo.cfg.local_ba_every > 0
            and jvo._kf_count % jvo.cfg.local_ba_every == 0)),
        landmarks=(int(st_t.map.valid.sum()),
                   int(np.asarray(st_j.map.valid).sum())),
        port_T_cw=st_t.T_cw.tolist())


def _stage_diffs(name, a, b, pose_only=False):
    """Where a port stage's output `a` (a VOState) and JAX's `b` (numpy)
    first differ: pose, inliers, keypoints, descriptors, stereo u, map
    count and ring poses."""
    out = dict(stage=name)
    out["dt_m"], out["drot"] = pose_difference(a.T_cw.numpy(), b.T_cw)
    out["inliers"] = (int(a.num_inliers), int(b.num_inliers))
    va, vb = a.prev.valid.numpy(), np.asarray(b.prev.valid)
    both = va & vb
    out["valid"] = (int(va.sum()), int(vb.sum()), int(both.sum()))
    out["kp_xy_max"] = float(np.abs(a.prev.kp_xy.numpy()[both]
                                    - np.asarray(b.prev.kp_xy)[both]).max()
                             ) if both.any() else 0.0
    out["map_idx_equal"] = float(np.mean(
        a.prev.map_idx.numpy()[both] == np.asarray(b.prev.map_idx)[both])
    ) if both.any() else 1.0
    if pose_only:
        return out
    da = a.prev.desc.numpy().view(np.uint32)[both]
    db = np.asarray(b.prev.desc).view(np.uint32)[both]
    out["desc_equal"] = float(np.mean(np.all(da == db, axis=1))
                              ) if both.any() else 1.0
    ka, kb = a.kfs.valid.numpy(), np.asarray(b.kfs.valid)
    out["kf_slots"] = (int(ka.sum()), int(kb.sum()))
    ur_a, ur_b = a.kfs.kp_ur.numpy(), np.asarray(b.kfs.kp_ur)
    has = (ur_a >= 0) & (ur_b >= 0)
    out["ur_rows"] = (int((ur_a >= 0).sum()), int((ur_b >= 0).sum()))
    out["ur_max"] = float(np.abs(ur_a[has] - ur_b[has]).max()
                          ) if has.any() else 0.0
    out["landmarks"] = (int(a.map.valid.sum()),
                        int(np.asarray(b.map.valid).sum()))
    Ka, Kb = a.kfs.T_cw.numpy(), np.asarray(b.kfs.T_cw)
    live = ka & kb
    out["ring_T_max"] = float(np.abs(Ka[live] - Kb[live]).max()
                              ) if live.any() else 0.0
    return out


def track_substages(jvo, frame, u, device) -> dict:
    """Inside the track step, each part from the same inputs in both
    packages: LK (converged flags and positions), F-RANSAC on JAX's LK
    result and JAX's draws (inlier counts), and the pose solve on JAX's
    landmark edges (pose difference)."""
    from trackingbench_slam_tpu.geometry import camera as j_camera
    from trackingbench_slam_tpu.geometry import se3 as j_se3
    from trackingbench_slam_tpu.models.frame import with_keypoints
    from trackingbench_slam_tpu.solvers import pose_opt as j_po
    from trackingbench_slam_tpu_torch.solvers import pose_opt as t_po
    cfg, jcfg, st = jvo.cfg_port, jvo.cfg, jvo.state
    f_cur = j_make_frame(jnp.asarray(frame[0]), jcfg.extractor.num_features,
                         jcfg.pyramid.num_levels, jcfg.pyramid.scale_factor)
    _, sub = jax.random.split(st.key)
    M = st.map.capacity
    T_pred = j_se3.normalize(j_se3.compose(st.T_rel, st.T_cw))
    mp0 = jnp.clip(st.prev.map_idx, 0, M - 1)
    p_pred = j_se3.transform_points(T_pred, st.map.pos[mp0])
    pred_ok = ((st.prev.map_idx >= 0) & st.prev.valid & st.map.valid[mp0]
               & (p_pred[:, 2] > 0.05))
    init_off = jnp.where(pred_ok[:, None], j_camera.world2cam(
        jvo.cam, p_pred) - st.prev.kp_xy, st.flow[None, :])
    kw = dict(scale=jcfg.pyramid.scale_factor, num_levels=jcfg.lk_track_levels)
    res_j, xy_j = j_matcher.search_by_opflow(
        f_cur, st.prev, sub, jcfg.matcher, use_ransac=False,
        init_offset=init_off, **kw)
    prev_t = vo_state_from_numpy(_host(st), device).prev
    f_t = vo_state_from_numpy(_host(st._replace(prev=f_cur)), device).prev
    res_t, xy_t = t_matcher.search_by_opflow(
        f_t, prev_t, None, cfg.matcher, use_ransac=False,
        init_offset=torch.from_numpy(np.array(init_off)).to(device), **kw)
    ok_j, ok_t = np.array(res_j.ok), res_t.ok.cpu().numpy()
    both = ok_j & ok_t
    inl_j, _ = j_ransac.fundamental_ransac(st.prev.kp_xy, xy_j, res_j.ok, sub)
    inl_t, _ = t_ransac.fundamental_ransac(
        prev_t.kp_xy, torch.from_numpy(np.array(xy_j)).to(device),
        torch.from_numpy(ok_j).to(device), uniform=u.to(device))
    ok = res_j.ok & inl_j
    f = with_keypoints(f_cur, jvo.cam, xy_j, st.prev.kp_level,
                       st.prev.kp_angle, st.prev.kp_response, st.prev.desc, ok)
    f = f._replace(map_idx=jnp.where(ok, st.prev.map_idx, -1))
    mp = jnp.clip(f.map_idx, 0, M - 1)
    edges = (f.map_idx >= 0) & f.valid & st.map.valid[mp]
    inv_s2 = j_po.level_inv_sigma2(f.kp_level, jcfg.pyramid.scale_factor)
    opt_j = j_po.pose_optimization(jvo.cam, T_pred, st.map.pos[mp], f.kp_xy,
                                   inv_s2, edges, jcfg.solver)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)
    opt_t = t_po.pose_optimization(
        t_cam.CameraParams.from_config(cfg.camera, device), t(T_pred),
        t(st.map.pos[mp]), t(f.kp_xy), t(inv_s2), t(edges), cfg.solver)
    return dict(
        lk_ok=(int(ok_t.sum()), int(ok_j.sum()), int((ok_j == ok_t).sum())),
        lk_xy_max=float(np.abs(np.asarray(xy_j) - xy_t.cpu().numpy())[
            both].max()) if both.any() else 0.0,
        ransac_inliers=(int(inl_t.sum()), int(np.asarray(inl_j).sum()),
                        int((inl_t.cpu().numpy() == np.asarray(inl_j)).sum())),
        pose_opt_dt_m=pose_difference(opt_t.T_cw.cpu().numpy(),
                                      np.asarray(opt_j.T_cw))[0],
        pose_opt_inliers=(int(opt_t.num_inliers), int(opt_j.num_inliers)))


def carried_stages(jvo, frame, device) -> list:
    """One frame at stage granularity: the port's track step, keyframe step
    and BA step, each from JAX's output of the stage before (converted), on
    JAX's draws, against JAX's own stage outputs."""
    from trackingbench_slam_tpu.models import local_mapping as j_lm
    cfg, jcfg = jvo.cfg_port, jvo.cfg
    cam_t = t_cam.CameraParams.from_config(cfg.camera, device)
    fid = jvo._fid + 1
    hold = (jvo.lost and jvo.loop_closer is not None
            and jvo._reloc_fails < jvo.reloc_max_fails
            and fid > cfg.keyframe_every)
    is_kf = frame[1] is not None and fid % cfg.keyframe_every == 0 \
        and not hold
    do_ba = is_kf and cfg.local_ba_every > 0 and \
        (jvo._kf_count + 1) % cfg.local_ba_every == 0
    left = jnp.asarray(frame[0])
    u = jax_draws(jvo.state.key, jvo.state.prev.kp_xy.shape[0])
    out = []
    j_tr = _host(j_vo.track_step(jvo.state, left, jvo.cam, jcfg))
    t_tr = t_vo.track_step(vo_state_from_numpy(_host(jvo.state), device),
                           torch.from_numpy(frame[0]).to(device), cam_t, cfg,
                           uniform=u)
    out.append(dict(_stage_diffs("track", t_tr, j_tr, pose_only=True),
                    **track_substages(jvo, frame, u, device)))
    if is_kf:
        right = jnp.asarray(frame[1])
        j_kf = _host(j_vo.keyframe_step(_device(j_tr), right, jvo.cam, jcfg))
        t_kf = t_vo.keyframe_step(vo_state_from_numpy(j_tr, device),
                                  torch.from_numpy(frame[1]).to(device),
                                  cam_t, cfg)
        out.append(_stage_diffs("keyframe", t_kf, j_kf))
        if do_ba:
            j_ba = _host(j_lm.local_ba_step(_device(j_kf), jvo.cam, jcfg))
            t_ba = t_lm.local_ba_step(vo_state_from_numpy(j_kf, device),
                                      cam_t, cfg)
            out.append(_stage_diffs("ba", t_ba, j_ba))
    return out


def carried_full_width(a: int, b: int, parts_dir: str = PARTS,
                       name: str = "loop", n: int | None = None):
    """The loop bench's run A (or with `name` "loop_tracked" the tracked
    loop at `n` frames, closer-less) on JAX up to frame `a` (from run A's
    latest checkpoint at or before it, where the recorder left one), then
    for every frame from `a` to `b` the port's stages from JAX's state on
    JAX's draws, on the CPU, printed stage by stage."""
    if name == "loop_tracked":
        cfg = corridor.tracked_loop_config()
        frames, _ = corridor.tracked_loop_frames(
            cfg, n or parity.TRACKED_FRAMES)
    else:
        cfg = corridor.loop_bench_config()
        frames, _, _ = corridor.loop_frames(cfg, n or 96)
    jcfg = JConfig.from_json(cfg.to_json())
    cpu = torch.device("cpu")
    with reference_semantics():
        jvo = j_vo.StereoVO(jcfg)
        jvo.cfg_port = cfg
        start, calls = 0, Calls()
        ckpts = sorted(c for c in glob.glob(os.path.join(
            parts_dir, "loop.A.ckpt[0-9][0-9][0-9].pkl"))
            if int(c[-7:-4]) <= a and name == "loop")
        if ckpts:
            start = len(stereo_resume(jvo, ckpts[-1], calls))
        print(f"JAX from frame {start} to {a}", flush=True)
        for i in range(start, a):
            jvo.track(*frames[i])
        for i in range(a, b + 1):
            t0 = time.perf_counter()
            stages = carried_stages(jvo, frames[i], cpu)
            row = carried_frame(jvo, frames[i], cpu)
            print(json.dumps(dict(frame=i, **row, stages=stages,
                                  seconds=time.perf_counter() - t0)),
                  flush=True)

# ------------------------------------------------------------ stage counts

@contextlib.contextmanager
def jax_stage_counts(sink):
    """While inside, the JAX StereoVO's steps also send parity.StageCounts'
    counts to `sink` (a list of (name, value)), through jax.debug.callback
    from the functions models/vo.py and matchers/matcher.py call: the same
    counts the port's StageCounts takes, on JAX's own values (depths
    accepted from the keyframe's right-image u, as the ring stores it)."""
    from trackingbench_slam_tpu.models import map as j_map
    from trackingbench_slam_tpu.ops import align as j_align
    saved = dict(ransac=j_matcher.fundamental_ransac,
                 anchored=j_align.anchored_align, orb=j_vo.extract_orb,
                 free=j_map.free_slot_destinations, lk=j_vo.lk_pyramidal,
                 insert=j_map.insert_keyframe, add=j_map.add_points)

    def put(**kw):
        names = list(kw)
        jax.debug.callback(lambda *v: sink.extend(
            (k, int(x)) for k, x in zip(names, v)), *kw.values())

    def ransac(p1, p2, valid, key, *a, **kw):
        inl, F = saved["ransac"](p1, p2, valid, key, *a, **kw)
        put(lk_ok=valid.sum(), ransac_inliers=(inl & valid).sum())
        return inl, F

    def anchored(atlas, img, centers, xy, valid, *a, **kw):
        put(linked_live=valid.sum())
        return saved["anchored"](atlas, img, centers, xy, valid, *a, **kw)

    def orb(f, cam, ecfg, pcfg, suppress_xy=None, suppress_valid=None):
        out = saved["orb"](f, cam, ecfg, pcfg, suppress_xy=suppress_xy,
                           suppress_valid=suppress_valid)
        if suppress_valid is not None:
            put(valid_before=suppress_valid.sum(),
                free=(~suppress_valid).sum(), fresh=out.valid.sum(),
                fresh_unsuppressed=saved["orb"](f, cam, ecfg,
                                                pcfg).valid.sum())
        return out

    def free(free_rows, want):
        dest = saved["free"](free_rows, want)
        if free_rows.shape == want.shape:   # a frame's rows, not the map's
            put(placed=(dest < free_rows.shape[0]).sum())
        return dest

    def lk(prev_pyr, cur_pyr, pts, valid, *a, **kw):
        res = saved["lk"](prev_pyr, cur_pyr, pts, valid, *a, **kw)
        conv = res.converged & valid
        put(stereo_converged=conv.sum(), stereo_fb_ok=(
            conv & res.fb_conv & (res.fb_d2 < 1.0)).sum())
        return res

    def insert(kfs, frame, frame_id, slot=None, kp_ur=None):
        if kp_ur is not None:
            put(depth_ok=(kp_ur >= 0).sum())
        return saved["insert"](kfs, frame, frame_id, slot=slot, kp_ur=kp_ur)

    def add(m, *a):
        m2, slots = saved["add"](m, *a)
        put(new_wanted=a[-1].sum(),
            added=(a[-1] & (slots < m2.valid.shape[0])).sum())
        return m2, slots

    jax.clear_caches()
    (j_matcher.fundamental_ransac, j_align.anchored_align, j_vo.extract_orb,
     j_map.free_slot_destinations, j_vo.lk_pyramidal, j_map.insert_keyframe,
     j_map.add_points) = (ransac, anchored, orb, free, lk, insert, add)
    try:
        yield
    finally:
        (j_matcher.fundamental_ransac, j_align.anchored_align,
         j_vo.extract_orb, j_map.free_slot_destinations, j_vo.lk_pyramidal,
         j_map.insert_keyframe, j_map.add_points) = saved.values()
        jax.clear_caches()


def jax_counts(n_frames: int):
    """The loop bench's run A on the JAX package (as the record runs it)
    over its first `n_frames` frames, printing parity.counts_line for each
    frame and then the table as one JSON line."""
    cfg = corridor.loop_bench_config()
    jcfg = JConfig.from_json(cfg.to_json())
    frames, _, _ = corridor.loop_frames(cfg, 96)
    sink, table = [], []
    with reference_semantics(), jax_stage_counts(sink):
        vo = j_vo.StereoVO(jcfg)
        for i in range(n_frames):
            vo.track(*frames[i])
            jax.effects_barrier()
            row = dict(frame=i, **dict(sink), inliers=int(
                vo.state.num_inliers), lost=bool(vo.lost))
            sink.clear()
            table.append(row)
            print(parity.counts_line(row), f"inliers={row['inliers']}",
                  flush=True)
    print(json.dumps(table), flush=True)


# ------------------------------------------------------------------ tests

def loop_small_config():
    """The loop bench's settings at 320x240, scaled as
    tests/test_torch_vo.py small_config scales the main path: 3 LK
    tracking levels, a keyframe every 5th frame, windowed BA on every 2nd
    keyframe (compacted to 512 landmarks, within the 2048-point map)."""
    return small_config(lk_track_levels=3, local_ba_every=2,
                        solver=SolverConfig(max_landmarks=512))


N_CARRIED = 20     # keyframes at frames 4, 9, 14, 19; BA at 9 and 19


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def unfused_jax_steps():
    """While inside, the JAX StereoVO runs its fused keyframe programs
    (track_and_keyframe_step, track_keyframe_ba_step) as their stages,
    track_step, keyframe_step and local_ba_step, each jitted on its own:
    the same steps in the same order, with three programs to compile
    instead of five (the compiles of the Pallas kernels in interpret mode
    are most of the test's time)."""
    from trackingbench_slam_tpu.models import local_mapping as j_lm
    saved = j_vo.track_and_keyframe_step, j_lm.track_keyframe_ba_step

    def track_and_keyframe(state, left, right, cam, cfg):
        return j_vo.keyframe_step(j_vo.track_step(state, left, cam, cfg),
                                  right, cam, cfg)

    def track_keyframe_ba(state, left, right, cam, cfg):
        return j_lm.local_ba_step(track_and_keyframe(state, left, right,
                                                     cam, cfg), cam, cfg)

    j_vo.track_and_keyframe_step = track_and_keyframe
    j_lm.track_keyframe_ba_step = track_keyframe_ba
    try:
        yield
    finally:
        j_vo.track_and_keyframe_step, j_lm.track_keyframe_ba_step = saved


def carried_rows(cfg, seq) -> list:
    """JAX's StereoVO on its TPU branches over `seq` (frames, or the
    poses of the loop bench's frames), and before every frame a port
    StereoVO carrying JAX's state and counters, stepping on JAX's draws
    (carried_frame); at keyframes also the port's compound step on the
    same draws. Call inside reference_semantics()."""
    jcfg = JConfig.from_json(cfg.to_json())
    frames = (seq if isinstance(seq, list) else
              corridor._render(cfg, seq, corridor.BASELINE)[0])
    cpu = torch.device("cpu")
    cam = t_cam.CameraParams.from_config(cfg.camera, cpu)
    rows = []
    jvo = j_vo.StereoVO(jcfg)
    jvo.cfg_port = cfg
    jvo.track(*frames[0])
    for i in range(1, len(frames)):
        before = vo_state_from_numpy(_host(jvo.state), cpu)
        u = jax_draws(jvo.state.key, jvo.state.prev.kp_xy.shape[0])
        rows.append(carried_frame(jvo, frames[i], cpu))
        if rows[-1]["keyframe"][0]:
            # the keyframe's compound step, given the same draws
            step = (t_lm.track_keyframe_ba_step if rows[-1]["ba"][0]
                    else t_vo.track_and_keyframe_step)
            rows[-1]["compound_T_cw"] = step(
                before, *(torch.from_numpy(x) for x in frames[i]), cam,
                cfg, uniform=u).T_cw.tolist()
    return rows


N_CARRIED_TRACKED = 12   # keyframes at frames 2, 5, 8, 11; no BA


@pytest.fixture(scope="module")
def carried_runs(one_thread):
    """Carried steps (carried_rows), in one reference context: the first
    N_CARRIED frames of the loop bench's circle at 320x240 ("loop"), and
    the first N_CARRIED_TRACKED frames of the tracked loop at its own
    configuration ("loop_tracked")."""
    tcfg = corridor.tracked_loop_config()
    with reference_semantics(), unfused_jax_steps():
        return {"loop": carried_rows(
                    loop_small_config(),
                    loop_trajectory(96, radius=1.5)[:N_CARRIED]),
                "loop_tracked": carried_rows(tcfg, corridor._render(
                    tcfg, loop_trajectory(parity.TRACKED_FRAMES, radius=1.0)[
                        :N_CARRIED_TRACKED], corridor.TRACKED_BASELINE,
                    width=8.0, u8=False)[0])}


@pytest.fixture(scope="module")
def carried(carried_runs):
    """The loop bench's circle at 320x240 (its first N_CARRIED frames):
    JAX's StereoVO on its TPU branches, and before every frame a port
    StereoVO carrying JAX's state and counters, stepping on JAX's draws."""
    return carried_runs["loop"]


def held_carried(carried, n=N_CARRIED, ba=2, keyframes=4):
    assert len(carried) == n - 1
    assert sum(r["ba"][1] for r in carried) == ba
    assert sum("compound_T_cw" in r for r in carried) == keyframes
    for i, r in enumerate(carried, start=1):
        assert r["dt_m"] < 1e-3 and r["drot"] < 1e-3, (i, r)
        n_t, n_j = r["inliers"]
        assert abs(n_t - n_j) <= max(2, 0.02 * n_j), (i, r)
        for k in ("lost", "keyframe", "ba"):
            assert r[k][0] == r[k][1], (i, k, r)
        l_t, l_j = r["landmarks"]
        assert abs(l_t - l_j) <= 0.02 * l_j, (i, r)
        if r["keyframe"][0]:
            # the compound step on the given draws is the tracker's step
            assert r["compound_T_cw"] == r["port_T_cw"], i


def test_carried_loop_bench_steps_match_reference(carried):
    """Each bound and why:
    - pose within 1e-3 m and 1e-3 rad: both step the same float32 solver
      from the same state on the same draws; LK and the 4x10 Huber LM
      differ in summation order only (the carried track step of
      tests/test_torch_vo.py holds the same bound);
    - inliers within 2% or 2 points: a point whose LK residual or
      epipolar distance sits on its threshold may go either way;
    - lost flag, keyframe insertion and BA call equal: host decisions on
      counters that the bounds above already hold far from their limits;
    - live landmarks within 2%: stereo matches and the cull gate points
      on their thresholds, as for the inliers."""
    held_carried(carried)


def test_carried_tracked_loop_steps_match_reference(carried_runs):
    """The tracked loop's first frames at its own configuration, each port
    step from JAX's state on JAX's draws, under the bounds of the loop
    bench's (test_carried_loop_bench_steps_match_reference)."""
    held_carried(carried_runs["loop_tracked"], N_CARRIED_TRACKED, ba=0,
                 keyframes=4)


@pytest.fixture(scope="module")
def record():
    return parity.load_record()


def test_record_metadata_matches_the_packages(record):
    """The record was made on JAX's TPU branches, from the JAX package's
    sources as they are now (a change under trackingbench_slam_tpu/ makes
    it stale: write it again), with the ORB pattern the port uses."""
    assert str(record["meta.semantics"]) == "tpu-interpret"
    assert json.loads(str(record["meta.sources"])) == source_hashes()
    assert str(record["meta.pattern_id"]) == t_orb.pattern_id()
    assert os.path.getsize(parity.RECORD) < 2 * 2 ** 20


def _counts(record, prefix):
    return len(record[f"{prefix}.T_cw"])


@pytest.mark.parametrize("prefix,frames,keys", [
    ("loop.A", 96, ("inliers", "lost", "keyframe", "ba", "landmarks")),
    ("loop.B", 96, ("inliers", "lost", "keyframe", "ba", "landmarks")),
    ("loop_tracked.closer", parity.TRACKED_FRAMES,
     ("inliers", "lost", "keyframe", "ba", "landmarks")),
    ("loop_tracked.without", parity.TRACKED_FRAMES,
     ("inliers", "lost", "keyframe", "ba", "landmarks")),
    ("loop_tracked48.closer", 48,
     ("inliers", "lost", "keyframe", "ba", "landmarks")),
    ("direct", None, ("tracked", "promoted")),
    ("mono", None, ("inliers", "initialized", "landmarks")),
] + [(f"indirect.{s}", None, ("inliers",)) for s in STRATEGIES])
def test_record_runs_have_their_rows(record, prefix, frames, keys):
    n = _counts(record, prefix)
    if frames is not None:
        assert n == frames
    assert record[f"{prefix}.T_cw"].shape == (n, 4, 4)
    assert record[f"{prefix}.poses"].shape == (n, 4, 4)
    assert np.isfinite(record[f"{prefix}.T_cw"]).all()
    for k in keys:
        assert record[f"{prefix}.{k}"].shape == (n,), k
    if f"{prefix}.ransac_idx" in record:
        c = len(record[f"{prefix}.ransac_frame"])
        assert record[f"{prefix}.ransac_idx"].shape == (c, 256, 8)
        assert record[f"{prefix}.ransac_idx"].dtype == np.int16
        assert (np.diff(record[f"{prefix}.ransac_frame"]) >= 0).all()
        # every hypothesis draws its 8 rows among the call's valid ones
        valid = np.unpackbits(record[f"{prefix}.ransac_valid"], axis=1
                              ).astype(bool)
        for idx, v in zip(record[f"{prefix}.ransac_idx"], valid):
            if v.sum() >= 8:
                assert v[idx].all()
    if prefix.startswith("loop"):
        # every frame after the bootstrap makes one F-RANSAC call
        assert record[f"{prefix}.ransac_frame"].tolist() == list(range(1, n))


@pytest.mark.parametrize("prefix", ["loop.voc", "indirect.voc",
                                    "loop_tracked.voc",
                                    "loop_tracked48.voc"])
def test_record_vocabulary_round_trip(record, prefix):
    voc = parity.record_vocabulary(record, prefix, torch.device("cpu"))
    back = vocabulary_to_numpy(voc)
    assert voc.branching == 6 and voc.depth == 3
    for i, level in enumerate(back["levels"]):
        np.testing.assert_array_equal(level, record[f"{prefix}.level{i}"])
    np.testing.assert_array_equal(back["word_weights"],
                                  record[f"{prefix}.word_weights"])


def _render_one(name, cfg, index, n):
    """Frame `index` of sequence `name` rendered alone, as its generator
    renders it inside the whole sequence."""
    base = corridor.BASELINE
    if name.startswith("loop_tracked"):
        scene = CorridorScene(cfg.camera, width=8.0, height=5.0)
        T = loop_trajectory(n, radius=1.0)[index]
        stereo = index == 0 or (index + 1) % cfg.keyframe_every == 0
        return (scene.stereo_pair(T, corridor.TRACKED_BASELINE) if stereo
                else (scene.render(T), None))
    if name == "loop":
        scene = CorridorScene(cfg.camera, width=10.0, height=5.0)
        T = loop_trajectory(n, radius=1.5)[index]
        stereo = index == 0 or (index + 1) % cfg.keyframe_every == 0
        return (tuple(corridor._u8(x) for x in scene.stereo_pair(T, base))
                if stereo else (corridor._u8(scene.render(T)), None))
    scene = CorridorScene(cfg.camera)
    if name == "direct":
        T = forward_yaw_trajectory(n, step=0.05, yaw_rate=0.006)[index]
        return (tuple(corridor._u8(x) for x in scene.stereo_pair(T, base))
                if index == 0 else (corridor._u8(scene.render(T)), None))
    if name == "indirect":
        T = forward_yaw_trajectory(n, step=0.08, yaw_rate=0.012)[index]
        b = cfg.camera.bf / cfg.camera.fx
        return tuple(corridor._u8(x) for x in scene.stereo_pair(T, b))
    T = lateral_trajectory(n, step=0.06, yaw_amp=0.01)[index]
    return corridor._u8(scene.render(T))


CONFIGS = dict(loop=corridor.loop_bench_config,
               loop_tracked=corridor.tracked_loop_config,
               loop_tracked48=corridor.tracked_loop_config,
               direct=corridor.direct_config, indirect=euroc_stereo_config,
               mono=corridor.mono_config)


@pytest.mark.parametrize("name", SEQUENCES[:-1])
def test_record_frames_render_again(record, name):
    """Frame 0 and the last frame of each sequence, rendered again alone
    at the record's size, hash to the record's sha256; so do the
    trajectories' ground truth."""
    cfg = CONFIGS[name]()
    prefix = {"loop": "loop.A", "indirect": "indirect.nn",
              "loop_tracked": "loop_tracked.closer",
              "loop_tracked48": "loop_tracked48.closer"}.get(name, name)
    n = _counts(record, prefix)
    shas = record[f"{name}.frame_sha"].tolist()
    for index, want in zip((0, n - 1), shas):
        assert frame_sha(_render_one(name, cfg, index, n)) == want, index


def test_record_tracked_loop_is_tracked_and_closed(record):
    """The JAX package tracks the tracked loop without flagging a frame
    lost, with the closer and without; with it, it closes a loop and ends
    within bench.py's 5 cm of the start, below the closer-less run; the
    record's ground truth is that circle's, and its frames start as the
    JAX loop test's (part loop_online)."""
    p = "loop_tracked.closer"
    assert not record[f"{p}.lost"].any()
    assert not record["loop_tracked.without.lost"].any()
    assert len(record[f"{p}.loops"]) >= 1
    assert len(record[f"{p}.relocs"]) == 0
    assert record[f"{p}.closing_err_m"] < parity.CLOSING_TOL_M
    assert record[f"{p}.closing_err_m"] < record[
        "loop_tracked.without.closing_err_m"]
    np.testing.assert_array_equal(
        record["loop_tracked.gt"],
        loop_trajectory(parity.TRACKED_FRAMES, radius=1.0
                        ).astype(np.float32))
    # the same first frame as the loop test's 48-frame circle
    assert record["loop_tracked.frame_sha"][0] == record[
        "loop_online.circle.frame_sha"][0]


def test_record_loop_test_circle_is_tracked_and_closed(record):
    """The JAX loop test's own circle at its 48 frames (part
    loop_tracked48: the same first and last frame as part loop_online's
    circle): the JAX package loses no frame, closes the revisit loop and
    ends within 5 cm of the start; its pose inliers dip below
    WELL_POSED_INLIERS (to 21 at keyframe 29), so chip_smoke.py's run E48
    is held to it only while they do not."""
    p = "loop_tracked48.closer"
    assert not record[f"{p}.lost"].any()
    assert record[f"{p}.loops"].tolist() == [48]
    assert len(record[f"{p}.relocs"]) == 0
    assert record[f"{p}.closing_err_m"] < parity.CLOSING_TOL_M
    assert record["loop_tracked48.frame_sha"].tolist() == record[
        "loop_online.circle.frame_sha"].tolist()
    assert record[f"{p}.inliers"][1:].min() < parity.WELL_POSED_INLIERS


def test_draws_selecting_reproduces_jax_hypotheses():
    """JAX's gumbel top-8 on a key, given back to the port as uniforms by
    draws_selecting under the same valid mask, picks the same rows in the
    same order, and the port's F-RANSAC then keeps JAX's inliers."""
    r = np.random.RandomState(3)
    n = 300
    X = np.c_[r.uniform(-4, 4, (n, 2)), r.uniform(4, 12, n)]
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    p1 = (X @ K.T)[:, :2] / X[:, 2:]
    X2 = X + np.array([0.3, 0.05, 0.2])
    p2 = (X2 @ K.T)[:, :2] / X2[:, 2:]
    p2[::7] += r.uniform(-30, 30, (len(p2[::7]), 2))     # outliers
    valid = r.uniform(size=n) > 0.2
    p1, p2 = p1.astype(np.float32), p2.astype(np.float32)
    key = jax.random.PRNGKey(11)
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(
        key, (256, n), minval=1e-9, maxval=1.0) + 1e-12))
    _, idx = jax.lax.top_k(logits[None, :] + gumbel, 8)
    v_t = torch.from_numpy(valid)
    u = parity.draws_selecting(np.asarray(idx), v_t)
    g = -torch.log(-torch.log(u + 1e-12))
    _, picked = t_fast.stable_topk(torch.where(
        v_t, 0.0, -1e9)[None, :] + g, 8)
    np.testing.assert_array_equal(picked.numpy(), np.asarray(idx))
    inl_j, _ = j_ransac.fundamental_ransac(jnp.asarray(p1), jnp.asarray(p2),
                                           jnp.asarray(valid), key)
    inl_t, _ = t_ransac.fundamental_ransac(torch.from_numpy(p1),
                                           torch.from_numpy(p2), v_t,
                                           uniform=u)
    assert (inl_t.numpy() == np.asarray(inl_j)).mean() >= 0.99
    assert inl_t.sum() > 0.6 * valid.sum()


def test_anchored_search_padding_gives_the_ports_anchored_align():
    """The anchored caller's shape (templates in a large atlas, search in
    a smaller frame) through the JAX package's anchored_align: on its TPU
    branch alone, search windows past the frame's right or bottom edge are
    shifted copies in interpret mode and their points fail; with the frame
    padded (reference_semantics, as the record runs it) every flag and
    position equals the port's."""
    H, W, h, w = 256, 512, 150, 300
    atlas = _blur_np(make_textured_image(H, W, seed=5, blobs=1500))
    frame = np.ascontiguousarray(atlas[:h, :w]) + np.float32(1.0)
    r = np.random.RandomState(0)
    n = 64
    pts = np.stack([r.uniform(10, w - 10, n), r.uniform(10, h - 10, n)],
                   -1).astype(np.float32)
    pts[:20, 0] = r.uniform(w - 60, w - 8, 20)
    init = (pts + r.uniform(-0.5, 0.5, pts.shape)).astype(np.float32)
    valid = np.ones(n, bool)
    args = [jnp.asarray(a) for a in (atlas, frame, pts, init, valid)]
    from trackingbench_slam_tpu.ops import align as j_align
    with reference_tpu_semantics():
        raw = np.asarray(j_align.anchored_align(*args).converged)
    with reference_semantics():
        ref = j_align.anchored_align(*args)
    got = t_align.anchored_align(*(torch.from_numpy(a) for a in (
        atlas, frame, pts, init, valid)))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy),
                               atol=1e-4)
    assert got.converged.sum() > 0.9 * n
    assert raw[:20].sum() < got.converged[:20].sum()


def _fake_record(n=6):
    """A record of one stereo run of `n` frames, camera centres on a line
    (with ground truth beside them), lost after frame 3."""
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, 0, 3] = -0.1 * np.arange(n)
    rec = {"r.T_cw": T, "r.lost": np.arange(n) >= 4,
           "r.inliers": np.asarray([0, 900, 800, 60, 40, 10][:n], np.int32),
           "r.keyframe": np.arange(n) % 2 == 1, "r.ba": np.arange(n) == 3,
           "r.loops": np.asarray([5], np.int32),
           "r.relocs": np.zeros(0, np.int32),
           "r.closing_err_m": np.float64(0.25), "r.gt": T.copy(),
           "r.ransac_frame": np.asarray([1, 2], np.int32),
           "r.ransac_site": np.asarray([0, 0], np.int8),
           "r.ransac_valid": np.packbits(np.ones((2, 40), bool), axis=1),
           "r.ransac_idx": np.stack([np.tile(np.arange(8, dtype=np.int16),
                                             (256, 1)) + k
                                     for k in range(2)])}
    return rec


def test_compare_stereo_finds_the_parting_and_lost_frames():
    rec = _fake_record()
    rows = {k: rec[f"r.{k}"].copy() for k in ("T_cw", "lost", "keyframe",
                                              "ba")}
    rows["T_cw"][2:, 0, 3] += 0.005          # 5 mm: not parted
    rows["T_cw"][3:, 0, 3] += 0.02           # 2.5 cm from frame 3 on
    rows["lost"] = np.arange(6) >= 5
    rows["keyframe"][5] = False              # after the first lost frame
    rows.update(loops=[], relocs=[2], poses=rows["T_cw"])
    out = parity.compare_stereo(rec, "r", rows)
    assert out["first_parting"] == 3 and out["first_lost"] == 4
    assert out["lost_port"] == [5] and out["lost_jax"] == [4, 5]
    assert out["keyframes_equal_until_lost"] and not out["keyframes_equal"]
    assert out["ba_equal_until_lost"]
    assert abs(out["max_diff_until_lost_m"] - 0.025) < 1e-6
    # frame 3 still rests on 60 inliers; frame 4's 40 end the position gate
    assert out["well_posed_frames"] == 4
    assert not out["held"]
    rec["r.inliers"][3] = 45      # now frames 0-2 only: 5 mm, held
    out = parity.compare_stereo(rec, "r", rows)
    assert out["well_posed_frames"] == 3 and out["held"]
    rows["ba"][1] = True          # a BA frame apart before the first lost
    assert not parity.compare_stereo(rec, "r", rows)["held"]
    rows["ba"][1] = False
    assert out["loops_port"] == [] and out["loops_jax"] == [5]
    assert out["relocs_port"] == [2] and out["closing_err_jax_m"] == 0.25
    rows["T_cw"] = rec["r.T_cw"].copy()
    out = parity.compare_stereo(rec, "r", rows)
    assert out["held"] and not parity.held_every_frame(out)
    # held at every frame: no frame lost, the same loops and relocalizations
    rows["lost"] = rec["r.lost"] = np.zeros(6, bool)
    rows.update(loops=[5], relocs=[], poses=rec["r.T_cw"].copy(),
                keyframe=rec["r.keyframe"].copy())
    out = parity.compare_stereo(rec, "r", rows)   # gt from "r.gt"
    assert out["closing_err_port_m"] == 0.0 and parity.held_every_frame(out)
    rows["loops"] = []
    assert not parity.held_every_frame(parity.compare_stereo(rec, "r", rows))


def test_tracked_loop_gate_asks_for_the_revisit_loop_and_a_margin():
    """A closer run passes on a loop in the last REVISIT_FRAMES frames, a
    closing error below CLOSING_TOL_M and CLOSER_MARGIN_M below the
    closer-less run's, no frame lost in either."""
    def run(err, loops=(), lost=()):
        return dict(closing_err_m=err, loops=list(loops), lost=list(lost))
    without = run(0.0539)
    assert parity.tracked_loop_gate(run(0.0402, [21, 72]), without,
                                    72)["passed"]
    for closer, check in ((run(0.0402, [21]), "revisit_loop"),
                          (run(0.0402, [21, 72], [30]), "no_lost"),
                          (run(0.0510, [72]), "closes"),
                          (run(0.0495, [72]), "below_closerless")):
        gate = parity.tracked_loop_gate(closer, without, 72)
        assert not gate["passed"] and not gate[check], (check, gate)
    gate = parity.tracked_loop_gate(run(0.0402, [72]), run(0.0539, [],
                                                           [5]), 72)
    assert not gate["no_lost"]
    assert abs(parity.tracked_loop_gate(run(0.0402, [72]), without, 72)[
        "margin_m"] - 0.0137) < 1e-9


def test_recorded_draws_are_handed_out_by_frame():
    """Installed, the port's track-step draw function returns the
    record's hypotheses for the frame set in `at`, and the generator's
    draws for a frame the record holds no call for."""
    rec = _fake_record()
    draws = parity.RecordedDraws(rec, "r")
    gen = torch.Generator().manual_seed(0)
    valid = torch.ones(40, dtype=torch.bool)
    with draws.installed():
        for frame, k in ((1, 0), (2, 1)):
            draws.at = frame
            u = t_matcher.draw_uniform(256, 40, gen, torch.device("cpu"))
            _, idx = t_fast.stable_topk(-torch.log(-torch.log(
                u + 1e-12)), 8)
            np.testing.assert_array_equal(idx.numpy(), rec["r.ransac_idx"][k])
        draws.at = 4
        u = t_matcher.draw_uniform(256, 40, gen, torch.device("cpu"))
        assert u.shape == (256, 40) and bool((u > 1e-9).all())
    assert t_matcher.draw_uniform is parity._draw
    assert (draws.used, draws.missing) == (2, 1)
    # an index the mask leaves out is not reproduced
    valid[3] = False
    u = parity.draws_selecting(rec["r.ransac_idx"][0], valid)
    assert float(u[:, 3].max()) == pytest.approx(1e-9)


def test_carried_on_cpu_agrees_with_itself_on_the_cpu(one_thread):
    """parity.carried_on_cpu steps a tracker's next frame from its state on
    the tracker's device and on a CPU copy, stage by stage; for a tracker
    on the CPU both are the same computation, so every stage agrees
    exactly (here on a keyframe, which adds the keyframe step), and the
    tracker itself is not stepped."""
    cfg = corridor.tracked_loop_config()
    frames, _ = corridor.tracked_loop_frames(cfg, 48)
    vo = t_vo.StereoVO(cfg, device="cpu")
    for f in frames[:2]:
        vo.track(*f)
    state, fid = vo.state, vo._fid
    gen = torch.Generator().manual_seed(0)
    u = t_ransac.draw_uniform(256, vo.state.prev.capacity, gen, "cpu")
    out = parity.carried_on_cpu(vo, frames[2], u)
    assert vo.state is state and vo._fid == fid
    n_ok, n_ok_cpu, same = out["lk_ok"]
    assert n_ok == n_ok_cpu > 100 and same == vo.state.prev.capacity
    assert out["lk_xy_max"] == 0.0 and out["T_pred_apart"] == 0.0
    assert out["ransac_inliers"][0] == out["ransac_inliers"][1] > 100
    assert out["pose_dt_m"] == 0.0 and out["step_dt_m"] == 0.0
    assert out["step_inliers"][0] == out["step_inliers"][1]
    kf = out["keyframe"]
    assert kf["valid"][0] == kf["valid"][1] == kf["valid"][2]
    assert kf["landmarks"][0] == kf["landmarks"][1]
    assert kf["kp_xy_max"] == 0.0 and kf["ur_max"] == 0.0


def test_parity_entry_point_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        parity.main([])


def main(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--part", choices=SEQUENCES)
    ap.add_argument("--parts", default=PARTS)
    ap.add_argument("--frames", type=int, default=None,
                    help="the part's sequence at this many frames")
    ap.add_argument("--carried", default=None, metavar="A:B",
                    help="carried steps of the loop bench (or of --part "
                         "loop_tracked at --frames) from frame A to B")
    ap.add_argument("--counts", type=int, default=None, metavar="N",
                    help="JAX's stage counts over the loop bench's first "
                         "N frames (run A)")
    args = ap.parse_args(argv)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    if args.write:
        write(args.parts, args.part, args.frames)
    if args.carried:
        a, b = (int(x) for x in args.carried.split(":"))
        carried_full_width(a, b, name=args.part or "loop", n=args.frames)
    if args.counts:
        jax_counts(args.counts)


if __name__ == "__main__":
    main(sys.argv[1:])
