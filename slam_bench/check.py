"""`correct`: what the timed path produced, against plain references.

Two layers are compared, each number against the limit that the cell's
workload file gives it (`limits`); `correct` holds when every number is
within its limit:

  * the poses of every execution over every frame it tracked, window
    included, against the rendered ground truth (reference/trajectory.py):
    `step_err_max_mm`, the worst frame-to-frame translation error;
    `step_err_rms_mm`, the root mean square of those errors over every
    execution's first `ate_frames` frames, which the same frames give
    however fast the program runs; and `ate_seq_max_mm`, the worst
    execution's trajectory error over those frames (each NaN where a pose
    is not finite);
  * the hand kernels' outputs, every call of one keyframe cadence of
    batched steps after the window (capture.py), against
    reference/kernels.py in float32. Every image operand that is a frame's
    pyramid (FAST's and ORB's levels, ORB's blurred levels, LK's levels,
    the anchor cells' image) the reference rebuilds itself from the host
    frame whose level 0 it is (of the step's left and right frames and the
    previous left frame, the nearest); the rest it takes as recorded,
    following the program from its own state: the keypoints, LK's points,
    starts and offsets, the anchor atlas and its slots. Compared:
    `lk_xy_gap_px` (points converged on both sides), `lk_flags_differing`
    (converged and back-track flags), `fast_score_gap`,
    `orb_angle_gap_rad` (valid rows), `orb_bits_differing` (valid rows
    whose two angles fall in one rBRIEF bin) and `anchor_cell_gap` (every
    cell written). A call whose outputs cannot be set beside the
    reference's gives NaN.

The references run after the window, the peak memory read and the
batched state freed, a few sequences at a time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_bench import arith
from slam_bench.reference import kernels as ref
from slam_bench.reference import trajectory

CHUNK = 16   # sequences a reference call takes at a time
LOST_INLIERS = 15   # models/vo.py StereoVO.min_track_inliers


def _chunks(B):
    return [slice(i, min(i + CHUNK, B)) for i in range(0, B, CHUNK)]


def _max(a, b):
    return max(a, b) if not (math.isnan(a) or math.isnan(b)) else math.nan


def _fmax(t: torch.Tensor) -> float:
    """Largest entry, NaN if any is NaN, 0 for no entries."""
    if t.numel() == 0:
        return 0.0
    if torch.isnan(t).any():
        return math.nan
    return float(t.max())


def poses(run) -> dict:
    """The pose numbers; each execution's squared ATE errors over its
    first `ate_frames` frames are kept for the ate_rmse_mm metric."""
    n, a = run.frames_done, run.ate_frames
    step_max = ate_max = 0.0
    sq, step_sq = [], []
    for b in range(run.B):
        est = run.poses[b, :n].astype(np.float64)
        gt = run.gt[run.seq_of[b], :n]
        if not np.isfinite(est).all():
            step_max = ate_max = math.nan
            sq.append(np.full(a, np.nan))
            step_sq.append(np.full(a - 1, np.nan))
            continue
        err = trajectory.step_errors(est, gt)
        step_max = _max(step_max, float(err.max()))
        step_sq.append(err[:a - 1] ** 2)
        sq.append(trajectory.ate_sq_errors(est[:a], gt[:a]))
        ate_max = _max(ate_max, float(np.sqrt(sq[-1].mean())))
    run.ate_sq = np.stack(sq)
    return dict(step_err_max_mm=step_max * 1e3,
                step_err_rms_mm=float(np.sqrt(np.mean(step_sq))) * 1e3,
                ate_seq_max_mm=ate_max * 1e3)


_FRAMES = {}   # step frame -> its candidate frames, while kernels() runs


def _host_frames(run, i: int) -> torch.Tensor:
    """Every frame a step-i call's images can be, as (n, H, W) float32 on
    the device: of each sequence, left i - 1, left i and, at a keyframe
    step, right i."""
    if i not in _FRAMES:
        got = []
        for s in range(len(run.lefts)):
            got += [run.lefts[s][j] for j in (i - 1, i)
                    if 0 <= j < len(run.lefts[s])]
            if i in run.rights[s]:
                got.append(run.rights[s][i])
        _FRAMES.clear()
        _FRAMES[i] = torch.from_numpy(np.stack(got)).to(run.device).float()
    return _FRAMES[i]


def _nearest(frames: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """For each row of x (B, H, W), the frame that differs least from it."""
    return torch.stack([frames[int((frames - row).abs().flatten(1).amax(1)
                                   .argmin())] for row in x])


def _rebuilt(run, call, levels, scale, blurred=None):
    """`levels` as the reference builds them from the host frames that
    their level 0 is (the nearest candidate, row by row), or as recorded
    where level 0 is no frame's shape (an atlas); with `blurred`, the
    reference's blurred levels too. The largest gap between the recorded
    and the rebuilt operands is kept in run.operand_gaps."""
    first = levels[0]
    frames = _host_frames(run, call["frame"])
    if tuple(first.shape[1:]) != tuple(frames.shape[1:]):
        return list(levels) if blurred is None else (list(levels), blurred)
    out = ref.build_pyramid(_nearest(frames, first), len(levels), scale)
    pairs = list(zip(out, levels))
    if blurred is not None:
        out_b = [ref.gaussian_blur(x) for x in out]
        pairs += list(zip(out_b, blurred))
    key = call["kind"]
    gap = run.operand_gaps.get(key, 0.0)
    for a, b in pairs:
        if a.shape != b.shape:
            raise ValueError(f"{key}: operand {tuple(b.shape)} where the "
                             f"reference builds {tuple(a.shape)}")
        gap = _max(gap, _fmax((a - b).abs()))
    run.operand_gaps[key] = gap
    return out if blurred is None else (out, out_b)


def _lk(run, call):
    prev, cur, pts, start, valid = call["inputs"]
    kw = call["kw"]
    prev = _rebuilt(run, call, prev, kw.get("scale", 0.5))
    cur = _rebuilt(run, call, cur, kw.get("scale", 0.5))
    out = call["out"]
    fb = kw.get("fb_iters", 0) > 0
    gap, flags, nbytes, flops = 0.0, 0, 0, 0
    for c in _chunks(pts.shape[0]):
        off = kw.get("offset")
        r, work = ref.lk_align([p[c] for p in prev], [q[c] for q in cur],
                               pts[c], start[c], valid[c],
                               scale=kw.get("scale", 0.5),
                               offset=None if off is None else off[c],
                               half=kw.get("half", 10),
                               iters=kw.get("iters", 30),
                               conv_eps=kw.get("conv_eps", 0.01),
                               fb_iters=kw.get("fb_iters", 0))
        both = out[1][c] & r[1]
        gap = _max(gap, _fmax((out[0][c] - r[0]).abs()[both]))
        flags += int((out[1][c] != r[1]).sum())
        if fb:
            flags += int((out[3][c] != r[3]).sum())
        b, f = arith.lk_terms(work, pts[c].shape[0] * pts.shape[1],
                              kw.get("half", 10), fb, off is not None)
        nbytes, flops = nbytes + b, flops + f
    call["bound_ms"], call["bound_by"] = arith.bound(nbytes, flops)
    return dict(lk_xy_gap_px=gap, lk_flags_differing=flags)


def _fast(run, call):
    (imgs,), kw, out = call["inputs"], call["kw"], call["out"]
    imgs = _rebuilt(run, call, imgs, run.pyramid[1])
    gap = 0.0
    for img, o in zip(imgs, out):
        for c in _chunks(img.shape[0]):
            r = ref.fast_score_nms(img[c], kw["threshold"], kw["arc"])
            gap = _max(gap, _fmax((o[c] - r).abs()))
    call["bound_ms"], call["bound_by"] = arith.bound(*arith.fast_terms(
        [tuple(i.shape[1:]) for i in imgs], imgs[0].shape[0]))
    return dict(fast_score_gap=gap)


def _popcount(x: torch.Tensor) -> int:
    shifts = torch.arange(32, device=x.device, dtype=torch.int32)
    return int(((x[..., None] >> shifts) & 1).sum())


def _orb(run, call):
    raw, blurred, xy, valid = call["inputs"]
    raw, blurred = _rebuilt(run, call, raw, run.pyramid[1], blurred)
    counts = call["kw"]["counts"]
    angle, desc = call["out"]
    gap, bits = 0.0, 0
    for c in _chunks(xy.shape[0]):
        ra, rd = ref.orb_describe([r[c] for r in raw], [b[c] for b in blurred],
                                  xy[c], valid[c], counts)
        v = valid[c]
        d = (angle[c] - ra).abs()
        d = torch.minimum(d, 2 * math.pi - d)
        gap = _max(gap, _fmax(d[v]))
        # bits where both angles fall in one of rBRIEF's 32 bins: an angle
        # a rounding away from a bin's edge turns the whole pattern, and
        # the angle's own gap is judged above
        same = v & (ref.angle_bins(angle[c]) == ref.angle_bins(ra))
        bits += _popcount((desc[c] ^ rd)[same])
    return dict(orb_angle_gap_rad=gap, orb_bits_differing=bits)


def _anchor(run, call):
    img, kp, slots, want = call["inputs"]
    (img,) = _rebuilt(run, call, [img], 1.0)
    cap = call["kw"]["capacity"]
    (atlas,) = call["out"]
    gap = 0.0
    for c in _chunks(kp.shape[0]):
        cells = ref.anchor_cells(img[c], kp[c])
        got = ref.atlas_cells(atlas[c])
        ok = want[c] & (slots[c] >= 0) & (slots[c] < cap)
        win = ref.last_writer(slots[c], ok, got.shape[1])
        has = win >= 0
        bi = torch.arange(win.shape[0], device=win.device)[:, None].expand_as(
            win)
        gap = _max(gap, _fmax((got[has] - cells[bi[has], win[has]]).abs()))
    return dict(anchor_cell_gap=gap)


KERNEL_CHECKS = dict(lk=_lk, fast=_fast, orb=_orb, anchor=_anchor)
KERNEL_NUMBERS = dict(lk=("lk_xy_gap_px", "lk_flags_differing"),
                      fast=("fast_score_gap",),
                      orb=("orb_angle_gap_rad", "orb_bits_differing"),
                      anchor=("anchor_cell_gap",))


def kernels(run) -> dict:
    """The kernel numbers over every recorded call (worst gap, summed
    counts); a kernel with no call, or with a call that cannot be set
    beside the reference, gives NaN."""
    got = {}
    for call in run.calls:
        try:
            with torch.no_grad():
                numbers = KERNEL_CHECKS[call["kind"]](run, call)
        except (ValueError, RuntimeError, IndexError) as e:
            run.operand_gaps[call["kind"] + "_error"] = str(e)[:200]
            numbers = {k: math.nan for k in KERNEL_NUMBERS[call["kind"]]}
        for k, v in numbers.items():
            if k not in got:
                got[k] = v
            elif isinstance(v, int):
                got[k] += v
            else:
                got[k] = _max(got[k], v)
    for names in KERNEL_NUMBERS.values():
        for k in names:
            got.setdefault(k, math.nan)
    _FRAMES.clear()
    return got


def check(run, limits: dict) -> dict:
    """{number: dict(value, limit, ok)} for every number in `limits`."""
    values = dict(poses(run))
    values.update(kernels(run))
    out = {}
    for name, limit in limits.items():
        v = values.get(name, math.nan)
        ok = not math.isnan(v) and v <= limit
        out[name] = dict(value=None if math.isnan(v) else v, limit=limit,
                         ok=ok)
    return out


def lost_frames(run, first: int, last: int) -> int:
    """Sequence-frames in frames first..last tracked on fewer than
    LOST_INLIERS pose inliers."""
    return int((run.inliers[:, first:last + 1] < LOST_INLIERS).sum())
