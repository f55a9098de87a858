"""The port held to the JAX package's record, frame by frame.

records/jax_full_width.npz is a run of the JAX package on its TPU branches
(Pallas in interpret mode) at full width: the loop bench (bench.py's
loop_closing_bench) without the closer (run A) and with bench.py's
LoopCloser (run B), and the direct, indirect (five strategies) and mono
trackers at chip_smoke.py's configurations. It holds every frame's pose and
counters, the vocabularies, and the (256, 8) hypothesis indices each
F-RANSAC call drew. It is written by `python -m tests.test_torch_records
--write`, which needs the JAX package; this module needs numpy and torch.

`draws_selecting` turns recorded indices into uniform draws whose gumbel
top-8 picks the same rows, and `RecordedDraws` installs them as the
port's draw functions (matchers/matcher.py `draw_uniform` for the track
step, ops/ransac.py `draw_uniform` for the mono bootstrap), so that a port
run takes JAX's RANSAC hypotheses. `compare_stereo` and `compare_poses`
report where a port run parts from the record. `StageCounts` counts, per
frame, what each stage of the track and keyframe steps kept.

    python -m trackingbench_slam_tpu_torch.parity [--closer] [--free]
        [--frames N] [--counts] [--cpu]

runs the loop bench on the card (run C, or D with --closer: the record's
vocabulary and run B's draws) and prints a line a frame, the record's
columns beside the port's (with --counts, the stage counts after it), then
the report as one JSON line.

    python -m trackingbench_slam_tpu_torch.parity --tracked [PART]
        [--carried A:B] [--cpu]

is run E: the tracked loop (part loop_tracked, or loop_tracked48: the
JAX loop test's own 48 frames) with bench.py's LoopCloser on the record's
vocabulary and draws, a line a frame and the report, held at every frame
(`held_every_frame`) or while well posed (`held`); with `--carried A:B`
it prints before each frame from A to B `carried_on_cpu`: the frame
stepped from the tracker's state on the card and on a CPU copy, stage by
stage.

    python -m trackingbench_slam_tpu_torch.parity --loop-tracked
        [--seeds 8] [--frames N] [--full-width] [--cpu]

is the tracked loop's seed sweep (the JAX package's own loop test's
configuration and circle at TRACKED_FRAMES frames, or N, utils/corridor.py
`tracked_loop_config`, which both packages track without losing a frame;
with `--full-width` its circle at the loop bench's configuration): for
each RANSAC generator seed the loop without and with bench.py's
LoopCloser (on a vocabulary trained from the port's ORB), a line per seed
(loops, relocalizations, lost frames, both closing errors and their
margin, whether it passes `tracked_loop_gate`), then a JSON line; it
exits 1 if a seed fails.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys

import numpy as np
import torch

from trackingbench_slam_tpu_torch.matchers import matcher as matcher_mod
from trackingbench_slam_tpu_torch.models import map as map_mod
from trackingbench_slam_tpu_torch.models import vo as vo_mod
from trackingbench_slam_tpu_torch.ops import ransac as ransac_mod
from trackingbench_slam_tpu_torch.utils.convert import vocabulary_from_numpy

RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "records",
                      "jax_full_width.npz")
POSITION_TOL_M = 0.01          # a frame "parts" beyond 1 cm
# the loop bench's position gate holds while the record's frame rests on at
# least this many pose inliers: the carried steps agree within 6e-5 m at
# every such frame, and below it the free runs' sub-millimetre distance is
# amplified (PERF.md, section 6)
WELL_POSED_INLIERS = 50
SITES = {"track": 0, "bootstrap": 1}
_draw = ransac_mod.draw_uniform   # the generator's draws
CLOSING_TOL_M = 0.05           # bench.py's closing-error gate
# vocabulary training: every this many left images of the loop bench's
# frames (bench.py's recipe) and of the tracked loop's (its test's)
VOC_EVERY = {"loop": 12, "loop_tracked": 4}
# frames of the tracked loop's circle: the JAX loop test's 48 dip to 21
# pose inliers at frame 29, where F-RANSAC's inlier set turns on rounding,
# and fail the gate at 2 RANSAC seeds in 8; 96 close 2 mm above the
# closer-less run at every seed; 72 keep >= 57 inliers and pass at every
# seed (PERF.md)
TRACKED_FRAMES = 72
REVISIT_FRAMES = 10      # the revisit loop closes within the last 10 frames
CLOSER_MARGIN_M = 0.005  # and ends >= 5 mm below the closer-less run


def load_record(path: str = RECORD) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def record_vocabulary(rec: dict, prefix: str, device):
    """The vocabulary stored under `prefix` ("loop.voc", "indirect.voc")."""
    depth = int(rec[f"{prefix}.depth"])
    return vocabulary_from_numpy(dict(
        levels=tuple(rec[f"{prefix}.level{i}"] for i in range(depth)),
        word_weights=rec[f"{prefix}.word_weights"],
        branching=int(rec[f"{prefix}.branching"]), depth=depth,
        levels_up=int(rec[f"{prefix}.levels_up"])), device)


def frame_sha(frame) -> str:
    """sha256 of a frame: its left image's bytes, then its right's (a
    frame is an image or a (left, right or None) pair)."""
    h = hashlib.sha256()
    for img in (frame if isinstance(frame, tuple) else (frame,)):
        if img is not None:
            h.update(np.ascontiguousarray(img).tobytes())
    return h.hexdigest()


def draws_selecting(idx, valid: torch.Tensor) -> torch.Tensor:
    """(S, 8) hypothesis indices -> (S, N) uniform draws in [1e-9, 1) whose
    gumbel top-8 (ops/ransac.py) picks, row by row and in order, the
    indices that are valid under `valid` (N,). Each valid pick gets one of
    the 8 largest float32 values below 1, in decreasing order; every other
    entry gets the floor 1e-9. A pick that is not valid is not reproduced:
    the -1e9 logit of an invalid row swamps any draw, and such rows tie,
    broken toward the lower index, in both packages."""
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=valid.device)
    S, N = idx.shape[0], valid.shape[0]
    top = 1.0 - torch.arange(1, idx.shape[1] + 1, dtype=torch.float64,
                             device=valid.device) * 2.0 ** -24
    u = torch.full((S, N), 1e-9, dtype=torch.float32, device=valid.device)
    picked = top.to(torch.float32).expand(S, -1)
    u.scatter_(1, idx, torch.where(valid[idx], picked,
                                   torch.full_like(picked, 1e-9)))
    return u


class RecordedDraws:
    """The recorded RANSAC calls of one run (`prefix`, e.g. "loop.A"),
    handed out by frame: set `at` to the frame being tracked before each
    `track` call. Each call's draws pick the recorded hypotheses under
    JAX's valid mask of that call. A call the record does not hold (the
    port drew where JAX did not) falls back to the generator and is
    counted in `missing`."""

    def __init__(self, rec: dict, prefix: str):
        self.frames = rec[f"{prefix}.ransac_frame"]
        self.sites = rec[f"{prefix}.ransac_site"]
        self.idx = rec[f"{prefix}.ransac_idx"]
        self.valid = np.unpackbits(rec[f"{prefix}.ransac_valid"], axis=1
                                   ).astype(bool)
        self.at = None
        self.used = 0
        self.missing = 0

    def call(self, site: str) -> int | None:
        """The record's call at frame `at` and `site`, if it holds one."""
        k = np.flatnonzero((self.frames == self.at)
                           & (self.sites == SITES[site]))
        return int(k[0]) if len(k) == 1 else None

    def uniform(self, k: int, n: int, device) -> torch.Tensor:
        """Call `k`'s (256, n) draws."""
        return draws_selecting(self.idx[k], torch.from_numpy(
            self.valid[k, :n]).to(device))

    def drawer(self, site: str):
        def draw(num_samples, n, generator, device):
            k = self.call(site)
            if k is None or num_samples != self.idx.shape[1]:
                self.missing += 1
                return _draw(num_samples, n, generator, device)
            self.used += 1
            return self.uniform(k, n, device)
        return draw

    @contextlib.contextmanager
    def installed(self):
        """The port's draw functions replaced by this record's while
        inside."""
        saved = matcher_mod.draw_uniform, ransac_mod.draw_uniform
        matcher_mod.draw_uniform = self.drawer("track")
        ransac_mod.draw_uniform = self.drawer("bootstrap")
        try:
            yield self
        finally:
            matcher_mod.draw_uniform, ransac_mod.draw_uniform = saved


def centres(T: np.ndarray) -> np.ndarray:
    """(F, 4, 4) world->camera poses -> (F, 3) camera centres."""
    T = np.asarray(T, np.float64)
    return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])


def gt_error(T: np.ndarray, gt: np.ndarray, gt0: np.ndarray) -> float:
    """Distance of a frame's camera centre from its ground truth `gt`, the
    VO world anchored at the first frame's `gt0` (bench.py's
    closing-error convention)."""
    T, gt, gt0 = (np.asarray(x, np.float64) for x in (T, gt, gt0))
    return float(np.linalg.norm(np.linalg.inv(T @ gt0)[:3, 3]
                                - np.linalg.inv(gt)[:3, 3]))


def first_index(mask) -> int | None:
    hit = np.flatnonzero(mask)
    return int(hit[0]) if len(hit) else None


def compare_poses(T_port: np.ndarray, T_rec: np.ndarray) -> dict:
    """Frame-by-frame camera-centre distance of two runs."""
    n = min(len(T_port), len(T_rec))
    d = np.linalg.norm(centres(T_port[:n]) - centres(T_rec[:n]), axis=1)
    return dict(frames=n, first_parting=first_index(d > POSITION_TOL_M),
                max_diff_m=float(d.max()) if n else 0.0,
                diff_m=d.tolist())


def compare_stereo(rec: dict, prefix: str, rows: dict) -> dict:
    """A port loop-bench run (`rows`: per-frame T_cw, inliers, lost,
    keyframe, ba, landmarks; and loops, relocs) against the record's run
    `prefix`: the first frame more than 1 cm from JAX, the lost frames of
    each, whether keyframe and BA frames agree, the loop and relocalization
    frames. `held` is the gate: until the first frame either package flags
    lost, equal keyframe and BA frames, and positions within 1 cm at the
    frames before it whose record rests on at least WELL_POSED_INLIERS pose
    inliers (from the bootstrap on, up to the first that does not)."""
    pose = compare_poses(rows["T_cw"], rec[f"{prefix}.T_cw"])
    n = pose["frames"]
    lost_p = np.asarray(rows["lost"][:n], bool)
    lost_j = rec[f"{prefix}.lost"][:n].astype(bool)
    first_lost = first_index(lost_p | lost_j)
    upto = n if first_lost is None else first_lost
    weak = first_index(rec[f"{prefix}.inliers"][1:n] < WELL_POSED_INLIERS)
    posed = upto if weak is None else min(upto, weak + 1)
    same = {k: bool(np.array_equal(np.asarray(rows[k][:upto], bool),
                                   rec[f"{prefix}.{k}"][:upto].astype(bool)))
            for k in ("keyframe", "ba")}
    d = np.asarray(pose["diff_m"])
    out = dict(
        frames=n, first_parting=pose["first_parting"],
        max_diff_m=pose["max_diff_m"], first_lost=first_lost,
        max_diff_until_lost_m=float(d[:upto].max()) if upto else 0.0,
        well_posed_frames=posed,
        max_diff_well_posed_m=float(d[:posed].max()) if posed else 0.0,
        lost_port=np.flatnonzero(lost_p).tolist(),
        lost_jax=np.flatnonzero(lost_j).tolist(),
        keyframes_equal_until_lost=same["keyframe"],
        ba_equal_until_lost=same["ba"],
        keyframes_equal=bool(np.array_equal(
            np.asarray(rows["keyframe"][:n], bool),
            rec[f"{prefix}.keyframe"][:n].astype(bool))),
        ba_equal=bool(np.array_equal(np.asarray(rows["ba"][:n], bool),
                                     rec[f"{prefix}.ba"][:n].astype(bool))),
        loops_port=[int(x) for x in rows.get("loops", [])],
        loops_jax=rec[f"{prefix}.loops"].tolist(),
        relocs_port=[int(x) for x in rows.get("relocs", [])],
        relocs_jax=rec[f"{prefix}.relocs"].tolist(),
        closing_err_jax_m=float(rec[f"{prefix}.closing_err_m"]),
        frames_jax=len(rec[f"{prefix}.T_cw"]))
    if "poses" in rows:
        from trackingbench_slam_tpu_torch.utils.corridor import closing_error
        out["closing_err_port_m"] = closing_error(
            rows["poses"], rec[f"{prefix.split('.')[0]}.gt"].astype(
                np.float64))
    out["held"] = bool(same["keyframe"] and same["ba"]
                       and out["max_diff_well_posed_m"] <= POSITION_TOL_M)
    return out


def held_every_frame(report: dict) -> bool:
    """A compare_stereo report held at every frame of the record (the
    tracked loop's gate): no frame more than POSITION_TOL_M from JAX, the
    same keyframe, BA, loop and relocalization frames, no frame lost in
    either package."""
    r = report
    return bool(r["frames"] == r["frames_jax"] and r["first_parting"] is None
                and r["keyframes_equal"] and r["ba_equal"]
                and r["loops_port"] == r["loops_jax"]
                and r["relocs_port"] == r["relocs_jax"]
                and not r["lost_port"] and not r["lost_jax"])


class StereoRows:
    """A StereoVO run's per-frame rows (the pose, inliers, lost flag,
    keyframe insertion, BA call and live landmarks after each frame), kept
    as device tensors, with no host read, until `arrays`. Call `before`
    and `after` around each `track`."""

    def __init__(self):
        self.rows = []
        self._kf = self._ba = 0

    def before(self, vo):
        self._kf, self._ba = vo._kf_count, vo.ba_calls

    def after(self, vo):
        st = vo.state
        self.rows.append(dict(
            T_cw=vo.trajectory[-1], inliers=st.num_inliers, lost=vo.lost,
            keyframe=vo._kf_count > self._kf, ba=vo.ba_calls > self._ba,
            landmarks=st.map.valid.sum()))

    def row(self, i: int) -> dict:
        return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                for k, v in self.rows[i].items()}

    def arrays(self, vo=None) -> dict:
        """The rows stacked on the host; with the tracker, also its final
        poses (which drain the closer's deferred detections) and its loop
        and relocalization frames."""
        out = {k: np.stack([self.row(i)[k] for i in range(len(self.rows))])
               for k in self.rows[0]}
        if vo is not None:
            out["poses"] = vo.poses()
            out.update(loops=list(vo.loop_events),
                       relocs=list(vo.reloc_events))
        return out


def loop_bench_tracker(cfg, device, voc=None, seed=None):
    """StereoVO at `cfg`, with bench.py's LoopCloser when `voc` is given,
    its RANSAC generator seeded `seed` when given (0 otherwise)."""
    from trackingbench_slam_tpu_torch.models.loop_closer import LoopCloser
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    vo = StereoVO(cfg, device=device)
    if seed is not None:
        vo.generator.manual_seed(seed)
    if voc is not None:
        vo.loop_closer = LoopCloser(voc, vo.cam, min_score=0.015,
                                    min_inliers=40, exclude_recent=5)
    return vo


def run_loop_bench(cfg, frames, device, voc=None, draws=None,
                   on_frame=None, seed=None, counts=None,
                   before_frame=None) -> tuple:
    """The loop bench on the port, a row a frame: StereoVO at `cfg`, with
    bench.py's LoopCloser when `voc` is given, on `draws`
    (RecordedDraws) when given, else on the generator seeded `seed`;
    `counts` (StageCounts) counts its stages; `before_frame(i, vo,
    frame)` and `on_frame(i, row)` are called around each frame. Returns
    (rows, vo)."""
    vo = loop_bench_tracker(cfg, device, voc, seed)
    rows = StereoRows()
    with contextlib.ExitStack() as stack:
        if draws:
            stack.enter_context(draws.installed())
        if counts:
            stack.enter_context(counts.installed())
        for i, f in enumerate(frames):
            if draws:
                draws.at = i
            if counts:
                counts.at = i
            if before_frame:
                before_frame(i, vo, f)
            rows.before(vo)
            vo.track(*f)
            rows.after(vo)
            if on_frame:
                on_frame(i, rows.row(i))
    return rows.arrays(vo), vo


class StageCounts:
    """What each stage of a StereoVO run kept, frame by frame: per track
    step the LK matches that converged inside the image (`lk_ok`) and the
    F-RANSAC inliers among them; per keyframe step the valid feature rows
    it starts from (`valid_before`), those linked to a live landmark
    (`linked_live`, the anchored refinement's points) and the free rows,
    the ORB keypoints the frame gives without suppression
    (`fresh_unsuppressed`, an extra extraction made for the count), the
    fresh ones left after AddPoints suppression (`fresh`) and those placed
    in free rows (`placed`), the stereo LK matches that converged
    (`stereo_converged`) and also passed the forward-backward check
    (`stereo_fb_ok`), the depths accepted (`depth_ok`), the rows
    wanting a landmark (depth accepted and unlinked after the projection
    search, `new_wanted`) and the landmarks added (`added`). The counts
    are read through the functions models/vo.py, models/map.py and
    matchers/matcher.py call, wrapped while `installed()`; the steps are
    unchanged and no count is read to the host before `table()`. Set `at`
    to the frame before each `track` call."""

    TRACK = ("lk_ok", "ransac_inliers")
    KEYFRAME = ("valid_before", "linked_live", "free", "fresh_unsuppressed",
                "fresh", "placed", "stereo_converged", "stereo_fb_ok",
                "depth_ok", "new_wanted", "added")

    def __init__(self):
        self.at = None
        self.counts: dict = {}
        self._fresh_pending = False

    def _put(self, **kw):
        self.counts.setdefault(self.at, {}).update(kw)

    @contextlib.contextmanager
    def installed(self):
        saved = dict(ransac=matcher_mod.fundamental_ransac,
                     anchored=vo_mod.anchored_align,
                     add_fresh=vo_mod.add_fresh_keypoints,
                     orb=vo_mod.extract_orb, lk=vo_mod.lk_pyramidal,
                     map_kf=vo_mod.map_keyframe, add=map_mod.add_points)

        def ransac(p1, p2, valid, *a, **kw):
            inl, F = saved["ransac"](p1, p2, valid, *a, **kw)
            self._put(lk_ok=valid.sum(), ransac_inliers=(inl & valid).sum())
            return inl, F

        def anchored(atlas, img, centers, xy, valid, *a, **kw):
            self._put(linked_live=valid.sum())
            return saved["anchored"](atlas, img, centers, xy, valid, *a,
                                     **kw)

        def add_fresh(f, cam, cfg):
            self._fresh_pending = True
            try:
                out = saved["add_fresh"](f, cam, cfg)
            finally:
                self._fresh_pending = False
            self._put(valid_before=f.valid.sum(), free=(~f.valid).sum(),
                      placed=out.valid.sum() - f.valid.sum())
            return out

        def orb(f, cam, ecfg, pcfg, **kw):
            out = saved["orb"](f, cam, ecfg, pcfg, **kw)
            if self._fresh_pending:       # not a relocalization's call
                # and once more without the suppression, for the count
                self._put(fresh=out.valid.sum(), fresh_unsuppressed=saved[
                    "orb"](f, cam, ecfg, pcfg).valid.sum())
            return out

        def lk(prev_pyr, cur_pyr, pts, valid, *a, **kw):
            res = saved["lk"](prev_pyr, cur_pyr, pts, valid, *a, **kw)
            conv = res.converged & valid
            self._put(stereo_converged=conv.sum(), stereo_fb_ok=(
                conv & res.fb_conv & (res.fb_d2 < 1.0)).sum())
            return res

        def map_kf(state, f, p_w, depth_ok, *a, **kw):
            self._put(depth_ok=depth_ok.sum())
            return saved["map_kf"](state, f, p_w, depth_ok, *a, **kw)

        def add(m, *a):
            want = a[-1]
            m2, slots = saved["add"](m, *a)
            self._put(new_wanted=want.sum(),
                      added=(want & (slots < m2.capacity)).sum())
            return m2, slots

        (matcher_mod.fundamental_ransac, vo_mod.anchored_align,
         vo_mod.add_fresh_keypoints, vo_mod.extract_orb,
         vo_mod.lk_pyramidal, vo_mod.map_keyframe,
         map_mod.add_points) = (ransac, anchored, add_fresh, orb, lk,
                                map_kf, add)
        try:
            yield self
        finally:
            (matcher_mod.fundamental_ransac, vo_mod.anchored_align,
             vo_mod.add_fresh_keypoints, vo_mod.extract_orb,
             vo_mod.lk_pyramidal, vo_mod.map_keyframe,
             map_mod.add_points) = saved.values()

    def table(self) -> list:
        """[{frame, and each count taken at that frame}] on the host, by
        frame."""
        return [dict(frame=int(i), **{k: int(v) for k, v in c.items()})
                for i, c in sorted(self.counts.items())]


def counts_line(row: dict) -> str:
    """One frame's stage counts; a keyframe's after its track counts."""
    cols = [f"{k}={row[k]}" for k in StageCounts.TRACK + StageCounts.KEYFRAME
            if k in row]
    return f"f{row['frame']:3d} counts " + " ".join(cols)


def tracked_loop_gate(with_closer: dict, without: dict, frames: int) -> dict:
    """The tracked loop's gate on one seed (each dict: closing_err_m,
    loops, lost frames; `frames` the circle's length): no frame flagged
    lost in either run, the revisit loop closed (a loop at one of the last
    REVISIT_FRAMES frames; both packages also close one at frame 21,
    which no test holds to ground truth), a closing error below
    CLOSING_TOL_M and at least CLOSER_MARGIN_M below the closer-less
    run's."""
    margin = without["closing_err_m"] - with_closer["closing_err_m"]
    checks = dict(
        no_lost=not with_closer["lost"] and not without["lost"],
        revisit_loop=any(f >= frames - REVISIT_FRAMES
                         for f in with_closer["loops"]),
        closes=with_closer["closing_err_m"] < CLOSING_TOL_M,
        below_closerless=margin >= CLOSER_MARGIN_M)
    return dict(checks, margin_m=margin, passed=all(checks.values()))


def sweep_frames(n: int = TRACKED_FRAMES, full_width: bool = False):
    """(cfg, frames, gt) of the tracked loop at n frames (utils/corridor.py
    tracked_loop_config, tracked_loop_frames), or with `full_width` of its
    circle at the loop bench's configuration (loop_bench_config: 1226x370,
    2000 features, windowed BA on every 2nd keyframe)."""
    from trackingbench_slam_tpu_torch.utils import corridor
    if full_width:
        cfg = corridor.loop_bench_config()
        return (cfg, *corridor.tracked_loop_frames(cfg, n, corridor.BASELINE))
    cfg = corridor.tracked_loop_config()
    return (cfg, *corridor.tracked_loop_frames(cfg, n))


def seed_sweep(cfg, frames, gt, device, voc, seeds, log=None) -> list:
    """The loop without and with bench.py's LoopCloser (on `voc`) for
    each RANSAC generator seed: a dict per seed with both runs' closing
    errors, loops, relocalizations and lost frames, and the gate's
    verdict (tracked_loop_gate)."""
    from trackingbench_slam_tpu_torch.utils.corridor import closing_error
    out = []
    for seed in seeds:
        runs = {}
        for key, run_voc in (("without", None), ("with", voc)):
            rows, vo = run_loop_bench(cfg, frames, device, run_voc,
                                      seed=seed)
            runs[key] = dict(
                closing_err_m=closing_error(rows["poses"], gt),
                loops=rows["loops"], relocs=rows["relocs"],
                lost=np.flatnonzero(rows["lost"]).tolist(),
                min_inliers=int(rows["inliers"][1:].min()))
        row = dict(seed=seed, without=runs["without"], closer=runs["with"],
                   **tracked_loop_gate(runs["with"], runs["without"],
                                       len(frames)))
        if log:
            log(sweep_line(row))
        out.append(row)
    return out


def sweep_line(r: dict) -> str:
    w, c = r["without"], r["closer"]
    return (f"seed {r['seed']}: closer loops {c['loops']} relocs "
            f"{c['relocs']} lost {c['lost']} closing error "
            f"{c['closing_err_m']:.4f} m (min inliers {c['min_inliers']}); "
            f"without loops lost {w['lost']} closing error "
            f"{w['closing_err_m']:.4f} m (min inliers {w['min_inliers']}); "
            f"margin {r['margin_m']:.4f} m; "
            f"{'pass' if r['passed'] else 'FAIL'}")


def frame_line(i: int, row: dict, rec: dict, prefix: str, gt) -> str:
    """One frame, loop_noclose_diag.py's columns for the port and then for
    the record."""
    def cols(T, n, lost):
        return (f"inliers={int(n):5d} |t|={np.linalg.norm(T[:3, 3]):8.3f} "
                f"err={gt_error(T, gt[i], gt[0]):8.3f}"
                f"{' LOST' if lost else '     '}")
    return (f"f{i:3d} port {cols(row['T_cw'], row['inliers'], row['lost'])}"
            f" | jax {cols(rec[f'{prefix}.T_cw'][i], rec[f'{prefix}.inliers'][i], rec[f'{prefix}.lost'][i])}")


def _to(tree, device):
    """A state (NamedTuples and tuples of tensors) copied to `device`."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, tuple):
        items = [_to(x, device) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return tree


def _apart(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest absolute difference of two tensors on any devices."""
    if a.numel() == 0:
        return 0.0
    return float((a.cpu().double() - b.cpu().double()).abs().max())


def _centre_apart(T_a: torch.Tensor, T_b: torch.Tensor) -> float:
    return float(np.linalg.norm(centres(T_a.cpu().numpy()[None])
                                - centres(T_b.cpu().numpy()[None])))


def carried_on_cpu(vo, frame, uniform: torch.Tensor) -> dict:
    """`vo`'s next frame stepped from its state on its device and on a CPU
    copy of that state, on the same draws `uniform` (256, N), stage by
    stage, each from the device's output of the stage before: LK (the
    converged-in-image flags, positions where both converged), F-RANSAC
    on the device's LK result, the pose solve on the device's landmark
    edges, the whole track step; at a keyframe (a right image at the
    keyframe cadence) the keyframe step from the device's track output.
    Returns (device, CPU) pairs and largest differences; `vo` itself is
    not stepped."""
    from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
    from trackingbench_slam_tpu_torch.geometry import se3
    from trackingbench_slam_tpu_torch.models.frame import make_frame
    from trackingbench_slam_tpu_torch.solvers import pose_opt
    from trackingbench_slam_tpu_torch.utils.device import upload_image
    cfg, dev, cpu = vo.cfg, vo.device, torch.device("cpu")
    devs = (dev, cpu)
    cams = {dev: vo.cam, cpu: cam_mod.CameraParams.from_config(cfg.camera,
                                                               cpu)}
    st = {dev: vo.state, cpu: _to(vo.state, cpu)}
    left = {d: upload_image(frame[0], d) for d in devs}
    nlv = cfg.lk_track_levels if cfg.lk_track_levels > 0 else None
    M = vo.state.map.capacity
    lk = {}
    for d in devs:
        s = st[d]
        f_cur = make_frame(left[d], cfg.extractor.num_features,
                           cfg.pyramid.num_levels, cfg.pyramid.scale_factor)
        T_pred = se3.normalize(se3.compose(s.T_rel, s.T_cw))
        mp0 = s.prev.map_idx.clamp(0, M - 1).long()
        p_pred = se3.transform_points(T_pred, s.map.pos[mp0])
        pred_ok = ((s.prev.map_idx >= 0) & s.prev.valid & s.map.valid[mp0]
                   & (p_pred[:, 2] > 0.05))
        init_off = torch.where(pred_ok[:, None], cam_mod.world2cam(
            cams[d], p_pred) - s.prev.kp_xy, s.flow[None, :])
        res, xy = matcher_mod.search_by_opflow(
            f_cur, s.prev, None, cfg.matcher, scale=cfg.pyramid.scale_factor,
            use_ransac=False, num_levels=nlv, init_offset=init_off)
        lk[d] = res.ok, xy, T_pred
    ok, xy, T_pred = lk[dev]
    both = (ok & lk[cpu][0].to(dev))
    out = dict(
        lk_ok=(int(ok.sum()), int(lk[cpu][0].sum()),
               int((ok == lk[cpu][0].to(dev)).sum())),
        lk_xy_max=_apart(xy[both], lk[cpu][1].to(dev)[both]),
        T_pred_apart=_apart(T_pred, lk[cpu][2]))
    inl = {d: ransac_mod.fundamental_ransac(
        st[d].prev.kp_xy, xy.to(d), ok.to(d), uniform=uniform.to(d))[0]
        for d in devs}
    out["ransac_inliers"] = (int((inl[dev] & ok).sum()),
                             int((inl[cpu] & ok.cpu()).sum()),
                             int((inl[dev].cpu() == inl[cpu]).sum()))
    s = st[dev]
    mp = s.prev.map_idx.clamp(0, M - 1).long()
    edges = ok & inl[dev] & (s.prev.map_idx >= 0) & s.prev.valid \
        & s.map.valid[mp]
    inv_s2 = pose_opt.level_inv_sigma2(s.prev.kp_level,
                                       cfg.pyramid.scale_factor)
    opt = {d: pose_opt.pose_optimization(
        cams[d], T_pred.to(d), s.map.pos[mp].to(d), xy.to(d),
        inv_s2.to(d), edges.to(d), cfg.solver) for d in devs}
    out.update(pose_edges=int(edges.sum()),
               pose_dt_m=_centre_apart(opt[dev].T_cw, opt[cpu].T_cw),
               pose_inliers=(int(opt[dev].num_inliers),
                             int(opt[cpu].num_inliers)))
    step = {d: vo_mod.track_step(st[d], left[d], cams[d], cfg,
                                 uniform=uniform.to(d)) for d in devs}
    out.update(step_dt_m=_centre_apart(step[dev].T_cw, step[cpu].T_cw),
               step_inliers=(int(step[dev].num_inliers),
                             int(step[cpu].num_inliers)))
    if (frame[1] is not None and not vo.lost
            and (vo._fid + 1) % cfg.keyframe_every == 0):
        tracked = {dev: step[dev], cpu: _to(step[dev], cpu)}
        kf = {d: vo_mod.keyframe_step(tracked[d], upload_image(frame[1], d),
                                      cams[d], cfg) for d in devs}
        va, vb = kf[dev].prev.valid.cpu(), kf[cpu].prev.valid
        ur_a, ur_b = kf[dev].kfs.kp_ur.cpu(), kf[cpu].kfs.kp_ur
        has = (ur_a >= 0) & (ur_b >= 0)
        out["keyframe"] = dict(
            valid=(int(va.sum()), int(vb.sum()), int((va & vb).sum())),
            kp_xy_max=_apart(kf[dev].prev.kp_xy.cpu()[va & vb],
                             kf[cpu].prev.kp_xy[va & vb]),
            landmarks=(int(kf[dev].map.valid.sum()),
                       int(kf[cpu].map.valid.sum())),
            ur_rows=(int((ur_a >= 0).sum()), int((ur_b >= 0).sum())),
            ur_max=_apart(ur_a[has], ur_b[has]))
    return out


def tracked_main(args, device) -> int:
    """--tracked: run E, the tracked loop with bench.py's LoopCloser on the
    record's vocabulary and draws, a line a frame beside the record, then
    the report (compare_stereo, held_every_frame); with --carried A:B,
    before each frame from A to B carried_on_cpu's line."""
    rec = load_record(args.record)
    part = args.tracked
    prefix = f"{part}.closer"
    n = len(rec[f"{prefix}.T_cw"])
    cfg, frames, gt = sweep_frames(n)
    if frame_sha(frames[-1]) != rec[f"{part}.frame_sha"][1]:
        raise SystemExit("the tracked loop renders other frames than the "
                         "record's")
    frames = frames[:args.frames or n]
    draws = RecordedDraws(rec, prefix)
    a, b = (map(int, args.carried.split(":")) if args.carried
            else (0, -1))

    def carry(i, vo, frame):
        k = draws.call("track")
        if a <= i <= b and vo.state is not None and k is not None:
            u = draws.uniform(k, vo.state.prev.capacity, device)
            print(json.dumps(dict(frame=i, carried=carried_on_cpu(
                vo, frame, u))), flush=True)
    rows, _ = run_loop_bench(
        cfg, frames, device, record_vocabulary(rec, f"{part}.voc", device),
        draws,
        lambda i, r: print(frame_line(i, r, rec, prefix, gt), flush=True),
        before_frame=carry)
    report = compare_stereo(rec, prefix, rows)
    report.update(run=f"E on {part}",
                  held_every_frame=held_every_frame(report),
                  draws_used=draws.used, draws_missing=draws.missing)
    print(json.dumps(report))
    return 0


def sweep_main(args, device) -> int:
    """--loop-tracked: the seed sweep, a line a seed, then the JSON."""
    from trackingbench_slam_tpu_torch.repeat_check import train_vocabulary
    n = args.frames or TRACKED_FRAMES
    cfg, frames, gt = sweep_frames(n, args.full_width)
    voc, n_desc = train_vocabulary(cfg, frames, device,
                                   every=VOC_EVERY["loop_tracked"])
    print(f"the tracked loop: {n} frames {cfg.camera.width}x"
          f"{cfg.camera.height}; vocabulary of {voc.num_words} words from "
          f"{n_desc} descriptors", flush=True)
    rows = seed_sweep(cfg, frames, gt, device, voc, range(args.seeds),
                      lambda m: print(m, flush=True))
    print(json.dumps(dict(frames=n, full_width=args.full_width, seeds=rows,
                          all_passed=all(r["passed"] for r in rows))))
    return 0 if all(r["passed"] for r in rows) else 1


def main(argv=None) -> int:
    from trackingbench_slam_tpu_torch.utils import corridor
    from trackingbench_slam_tpu_torch.utils.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--closer", action="store_true",
                    help="run D: bench.py's LoopCloser on the record's "
                         "vocabulary and run B's draws")
    ap.add_argument("--free", action="store_true",
                    help="the port's own draws instead of the record's")
    ap.add_argument("--frames", type=int, default=None,
                    help="the first N frames; the sweep: the circle's "
                         "length (default TRACKED_FRAMES)")
    ap.add_argument("--counts", action="store_true",
                    help="count each stage's survivors (StageCounts)")
    ap.add_argument("--tracked", nargs="?", const="loop_tracked",
                    default=None, metavar="PART",
                    help="run E on the record's tracked loop (part "
                         "loop_tracked or loop_tracked48)")
    ap.add_argument("--carried", default=None, metavar="A:B",
                    help="with --tracked: carried_on_cpu at frames A-B")
    ap.add_argument("--loop-tracked", action="store_true",
                    help="the tracked loop's seed sweep")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--full-width", action="store_true",
                    help="the sweep at the loop bench's configuration")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--record", default=RECORD)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if args.loop_tracked:
        return sweep_main(args, device)
    if args.tracked:
        return tracked_main(args, device)
    rec = load_record(args.record)
    prefix = "loop.B" if args.closer else "loop.A"
    cfg = corridor.loop_bench_config()
    n = len(rec[f"{prefix}.T_cw"])
    frames, gt, _ = corridor.loop_frames(cfg, n)
    frames = frames[:args.frames or n]
    voc = record_vocabulary(rec, "loop.voc", device) if args.closer else None
    draws = None if args.free else RecordedDraws(rec, prefix)
    counts = StageCounts() if args.counts else None
    rows, _ = run_loop_bench(
        cfg, frames, device, voc, draws,
        lambda i, r: print(frame_line(i, r, rec, prefix, gt), flush=True),
        counts=counts)
    report = compare_stereo(rec, prefix, rows)
    report.update(run="D" if args.closer else "C", free=args.free,
                  draws_used=draws.used if draws else 0,
                  draws_missing=draws.missing if draws else 0)
    if counts:
        report["counts"] = counts.table()
        for row in report["counts"]:
            print(counts_line(row), flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
