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
report where a port run parts from the record.

    python -m trackingbench_slam_tpu_torch.parity [--closer] [--free]
        [--frames N] [--cpu]

runs the loop bench on the card (run C, or D with --closer: the record's
vocabulary and run B's draws) and prints a line a frame, the record's
columns beside the port's, then the report as one JSON line.
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

    def drawer(self, site: str):
        code = SITES[site]

        def draw(num_samples, n, generator, device):
            k = np.flatnonzero((self.frames == self.at)
                               & (self.sites == code))
            if len(k) != 1 or num_samples != self.idx.shape[1]:
                self.missing += 1
                return _draw(num_samples, n, generator, device)
            self.used += 1
            return draws_selecting(self.idx[k[0]], torch.from_numpy(
                self.valid[k[0], :n]).to(device))
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
        closing_err_jax_m=float(rec[f"{prefix}.closing_err_m"]))
    if "poses" in rows:
        from trackingbench_slam_tpu_torch.utils.corridor import closing_error
        out["closing_err_port_m"] = closing_error(
            rows["poses"], rec["loop.gt"].astype(np.float64))
    out["held"] = bool(same["keyframe"] and same["ba"]
                       and out["max_diff_well_posed_m"] <= POSITION_TOL_M)
    return out


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


def loop_bench_tracker(cfg, device, voc=None):
    """StereoVO at `cfg`, with bench.py's LoopCloser when `voc` is
    given."""
    from trackingbench_slam_tpu_torch.models.loop_closer import LoopCloser
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    vo = StereoVO(cfg, device=device)
    if voc is not None:
        vo.loop_closer = LoopCloser(voc, vo.cam, min_score=0.015,
                                    min_inliers=40, exclude_recent=5)
    return vo


def run_loop_bench(cfg, frames, device, voc=None, draws=None,
                   on_frame=None) -> tuple:
    """The loop bench on the port, a row a frame: StereoVO at `cfg`, with
    bench.py's LoopCloser when `voc` is given, on `draws`
    (RecordedDraws) when given. Returns (rows, vo)."""
    vo = loop_bench_tracker(cfg, device, voc)
    rows = StereoRows()
    with draws.installed() if draws else contextlib.nullcontext():
        for i, f in enumerate(frames):
            if draws:
                draws.at = i
            rows.before(vo)
            vo.track(*f)
            rows.after(vo)
            if on_frame:
                on_frame(i, rows.row(i))
    return rows.arrays(vo), vo


def frame_line(i: int, row: dict, rec: dict, prefix: str, gt) -> str:
    """One frame, loop_noclose_diag.py's columns for the port and then for
    the record."""
    def cols(T, n, lost):
        return (f"inliers={int(n):5d} |t|={np.linalg.norm(T[:3, 3]):8.3f} "
                f"err={gt_error(T, gt[i], gt[0]):8.3f}"
                f"{' LOST' if lost else '     '}")
    return (f"f{i:3d} port {cols(row['T_cw'], row['inliers'], row['lost'])}"
            f" | jax {cols(rec[f'{prefix}.T_cw'][i], rec[f'{prefix}.inliers'][i], rec[f'{prefix}.lost'][i])}")


def main(argv=None) -> int:
    from trackingbench_slam_tpu_torch.utils import corridor
    from trackingbench_slam_tpu_torch.utils.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--closer", action="store_true",
                    help="run D: bench.py's LoopCloser on the record's "
                         "vocabulary and run B's draws")
    ap.add_argument("--free", action="store_true",
                    help="the port's own draws instead of the record's")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--record", default=RECORD)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    rec = load_record(args.record)
    prefix = "loop.B" if args.closer else "loop.A"
    cfg = corridor.loop_bench_config()
    n = len(rec[f"{prefix}.T_cw"])
    frames, gt, _ = corridor.loop_frames(cfg, n)
    frames = frames[:args.frames or n]
    voc = record_vocabulary(rec, "loop.voc", device) if args.closer else None
    draws = None if args.free else RecordedDraws(rec, prefix)
    rows, _ = run_loop_bench(
        cfg, frames, device, voc, draws,
        lambda i, r: print(frame_line(i, r, rec, prefix, gt), flush=True))
    report = compare_stereo(rec, prefix, rows)
    report.update(run="D" if args.closer else "C", free=args.free,
                  draws_used=draws.used if draws else 0,
                  draws_missing=draws.missing if draws else 0)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
