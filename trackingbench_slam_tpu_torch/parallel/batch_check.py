"""Which ops of a batched step give other bits than the serial step.

A batched step (parallel/dp_eval.py) is the serial step under
torch.func.vmap. Elementwise ops and the hand kernels compute each element
the same way whatever the batch, but an op whose implementation depends on
the shape (a matrix product that folds the batch into its rows, a
convolution whose algorithm is picked per batch size, a reduction) may
round differently. This module finds such ops:

  * `batch_check(states, lefts, rights, cam, cfg, uniform)` runs the track
    step and then `keyframe_step(both_branches=True)` serially for each of
    the B sequences, recording every call of the functions in `WATCHED`
    with its inputs and the stage it ran in (the `models/vo.py` ranges:
    track.make_frame, track.search_by_opflow, track.pose_optimization,
    keyframe.anchored_align, keyframe.extract_orb, keyframe.stereo_lk,
    keyframe.search_by_projection_map, keyframe.write_anchor_patches; a call
    outside them is in "track.rest" or "keyframe.rest": the cull and replace
    pass, add_points, add_observations, insert_keyframe and the
    maintenance passes). Each recorded call then runs twice on those same
    inputs: once per sequence, once for all B under vmap. The report gives,
    for every call, the output leaves that are not equal (entries, of how
    many, largest difference), and the same for the whole steps (the
    batched steps of dp_eval against the serial steps from the same
    states).
  * "Equal" is bit-equal, with NaN equal to NaN at the same entry
    (`tree_diff`).

    python -m trackingbench_slam_tpu_torch.parallel.batch_check [--cpu] [--batch B]

runs it at the main path's configuration on B sequences cut from its
corridor frames (`batched_sequences`, the sequences chip_smoke.py's batched
phase steps), each bootstrapped and tracked TRACK_STEPS frames serially,
and writes the report to chiprun_out/batch_check.json. It runs on the card
unless --cpu is given; at the full width on the CPU it takes minutes.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys

import torch
import torch.utils._pytree as pytree

from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.matchers import matcher as matcher_mod
from trackingbench_slam_tpu_torch.models import extractors
from trackingbench_slam_tpu_torch.models import frame as frame_mod
from trackingbench_slam_tpu_torch.models import map as map_mod
from trackingbench_slam_tpu_torch.models import vo as vo_mod
from trackingbench_slam_tpu_torch.ops import fast as fast_ops
from trackingbench_slam_tpu_torch.ops import image as image_ops
from trackingbench_slam_tpu_torch.parallel import dp_eval
from trackingbench_slam_tpu_torch.solvers import pose_opt
from trackingbench_slam_tpu_torch.utils import profiling

TRACK_STEPS = 3   # serial track steps before the checked keyframe frame

# (module, function name, recorded inside another recorded call too): the
# calls the steps make, down to the image ops and the pose solve's rounds.
# The se3 helpers run thousands of times inside the solvers: only their
# calls from the steps' own code are recorded.
WATCHED = (
    (vo_mod, "make_frame", True), (frame_mod, "build_pyramid", True),
    (image_ops, "resize_bilinear", True),
    (matcher_mod, "search_by_opflow", True),
    (matcher_mod, "lk_pyramidal", True),
    (matcher_mod, "fundamental_ransac", True),
    (pose_opt, "pose_optimization", True),
    (pose_opt, "lm_pose_iterations", True),
    (vo_mod, "nanmedian", True), (vo_mod, "with_keypoints", True),
    (vo_mod, "anchored_align", True),
    (vo_mod, "add_fresh_keypoints", True), (vo_mod, "extract_orb", True),
    (extractors, "fast_score_nms_levels", True),
    (extractors, "occupancy_mask", True), (fast_ops, "grid_topk", True),
    (image_ops, "gaussian_blur", True), (extractors, "orb_describe", True),
    (vo_mod, "lk_pyramidal", True), (vo_mod, "map_keyframe", True),
    (matcher_mod, "search_by_projection_map", True),
    (vo_mod, "is_in_frustum", True), (map_mod, "increase_visible", True),
    (map_mod, "replace_points", True), (map_mod, "purge_kf_slot", True),
    (map_mod, "add_points", True), (map_mod, "add_observations", True),
    (map_mod, "insert_keyframe", True),
    (map_mod, "update_normal_and_depth", True),
    (map_mod, "compute_distinctive_descriptors", True),
    (map_mod, "write_anchor_patches", True),
    (se3, "compose", False), (se3, "inverse", False),
    (se3, "normalize", False), (se3, "transform_points", False),
)
STAGES = ("track.make_frame", "track.search_by_opflow",
          "track.pose_optimization", "keyframe.anchored_align",
          "keyframe.extract_orb", "keyframe.stereo_lk",
          "keyframe.search_by_projection_map",
          "keyframe.write_anchor_patches")
# functions whose outputs the images alone determine (pyramids, blur, FAST
# keypoints, ORB angles and descriptors, the anchor cells' pixels): these
# must be equal under a batch
IMAGE_SIDE = ("make_frame", "build_pyramid", "resize_bilinear",
              "gaussian_blur", "fast_score_nms_levels", "orb_describe",
              "grid_topk")


def leaf_equal(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Entrywise bit equality, NaN equal to NaN."""
    eq = x == y
    if x.is_floating_point():
        eq = eq | (torch.isnan(x) & torch.isnan(y))
    return eq


def tree_diff(a, b) -> dict:
    """The tensor leaves of two trees of one structure that are not equal
    (`leaf_equal`): {path: [entries differing, entries, largest |a - b|
    (None for integer and bool leaves)]}."""
    fa, spec_a = pytree.tree_flatten_with_path(a)
    fb, spec_b = pytree.tree_flatten(b)
    if len(fa) != len(fb):
        raise ValueError("the trees differ in structure")
    out = {}
    for (path, x), y in zip(fa, fb):
        if not isinstance(x, torch.Tensor):
            continue
        ne = ~leaf_equal(x, y)
        n = int(ne.sum())
        if n:
            d = None
            if x.is_floating_point():
                d = float(torch.where(ne, (x - y).abs(), torch.zeros_like(x))
                          .nan_to_num(nan=float("inf")).max())
            out[pytree.keystr(path)] = [n, x.numel(), d]
    return out


def merge_diffs(diffs) -> dict:
    """Per-sequence `tree_diff`s summed: entries and sizes added, the
    largest difference kept."""
    out = {}
    for diff in diffs:
        for k, (n, size, d) in diff.items():
            m = out.setdefault(k, [0, 0, None])
            m[0] += n
            m[1] += size
            if d is not None:
                m[2] = d if m[2] is None else max(m[2], d)
    return out


class _Recorder:
    """Records the WATCHED calls of serial steps, per stage: a consumer of
    the stage spans (utils/profiling.py `record`)."""

    def __init__(self):
        self.calls = None
        self.stages = []
        self.depth = 0
        self.step = None

    def enter(self, span):
        self.stages.append(span.name)

    def exit(self, span):
        self.stages.pop()

    def wrap(self, fn, nested):
        @functools.wraps(fn)
        def recorded(*args, **kwargs):
            if self.calls is None or (self.depth and not nested):
                return fn(*args, **kwargs)
            inner = [s for s in self.stages if s in STAGES]
            stage = inner[-1] if inner else f"{self.step}.rest"
            self.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.depth -= 1
            self.calls.append((stage, fn, args, kwargs, out))
            return out
        return recorded

    @contextlib.contextmanager
    def installed(self):
        saved = [(m, n, getattr(m, n)) for m, n, _ in WATCHED]
        try:
            for m, n, nested in WATCHED:
                setattr(m, n, self.wrap(getattr(m, n), nested))
            with profiling.record(self):
                yield self
        finally:
            for m, n, fn in saved:
                setattr(m, n, fn)


_TENSOR = object()   # marks an output leaf that vmap returns


def _replay_batched(fn, per_seq):
    """fn on every sequence's recorded (args, kwargs) as one vmapped call:
    tensor leaves that differ between sequences are stacked, leaves that
    are one tensor for all (the camera) are captured, other leaves must be
    equal."""
    flat = [pytree.tree_flatten(ak) for ak in per_seq]
    spec = flat[0][1]
    if any(s != spec for _, s in flat):
        raise ValueError(f"{fn.__name__}: calls differ in structure")
    cols = list(zip(*(leaves for leaves, _ in flat)))
    fixed, batched = [], []
    for i, col in enumerate(cols):
        x0 = col[0]
        if isinstance(x0, torch.Tensor):
            if all(x is x0 for x in col):
                fixed.append(x0)
            else:
                batched.append(i)
                fixed.append(None)
        elif any(x != x0 for x in col[1:]):
            raise ValueError(f"{fn.__name__}: argument {i} differs between "
                             f"sequences: {col}")
        else:
            fixed.append(x0)

    out_spec = []

    def one(*xs):
        leaves = list(fixed)
        for i, x in zip(batched, xs):
            leaves[i] = x
        args, kwargs = pytree.tree_unflatten(leaves, spec)
        out, ospec = pytree.tree_flatten(fn(*args, **kwargs))
        out_spec[:] = [ospec, [_TENSOR if isinstance(x, torch.Tensor) else x
                               for x in out]]
        return tuple(x for x in out if isinstance(x, torch.Tensor))
    tensors = iter(torch.func.vmap(one, randomness="error")(
        *[torch.stack(cols[i]) for i in batched]))
    ospec, others = out_spec
    return pytree.tree_unflatten(
        [next(tensors) if x is _TENSOR else x for x in others], ospec)


def batch_check(states, lefts, rights, cam, cfg, uniform) -> dict:
    """B serial states before a keyframe frame, that frame's left and right
    images ((B, H, W) each, or lists) and the track step's RANSAC draws
    (B, 256, N): the report described in the module docstring."""
    B = len(states)
    rec = _Recorder()
    calls, serial_track, serial_kf = [], [], []
    with rec.installed():
        for b in range(B):
            rec.calls = []
            rec.step = "track"
            tracked = vo_mod.track_step(states[b], lefts[b], cam, cfg,
                                        uniform=uniform[b])
            rec.step = "keyframe"
            kf = vo_mod.keyframe_step(tracked, rights[b], cam, cfg,
                                      both_branches=True)
            calls.append(rec.calls)
            serial_track.append(tracked)
            serial_kf.append(kf)
        rec.calls = None
    n_calls = {len(c) for c in calls}
    if len(n_calls) != 1:
        raise ValueError(f"the sequences made different calls: {n_calls}")
    stacked = dp_eval.stack_states(list(states))
    imgs_l = torch.stack(list(lefts)).float()
    imgs_r = torch.stack(list(rights)).float()
    bt = dp_eval.dp_track_step(stacked, imgs_l, cam, cfg, uniform)
    bk = dp_eval.dp_track_and_keyframe_step(stacked, imgs_l, imgs_r, cam,
                                            cfg, uniform)
    steps = {
        "track_step": merge_diffs(
            tree_diff(o, s) for o, s in zip(dp_eval.unstack_states(bt, B),
                                            serial_track)),
        "track_and_keyframe_step": merge_diffs(
            tree_diff(o, s) for o, s in zip(dp_eval.unstack_states(bk, B),
                                            serial_kf))}
    del bt, bk
    report, seen = [], {}
    for k in range(len(calls[0])):
        stage, fn = calls[0][k][:2]
        if any(c[k][1] is not fn for c in calls):
            raise ValueError(f"call {k}: the sequences called different "
                             "functions")
        name = fn.__name__
        seen[(stage, name)] = seen.get((stage, name), 0) + 1
        per_seq = [(c[k][2], c[k][3]) for c in calls]
        again = [fn(*a, **kw) for a, kw in per_seq]
        batched = _replay_batched(fn, per_seq)
        report.append(dict(
            stage=stage, call=f"{name}#{seen[(stage, name)]}",
            image_side=name in IMAGE_SIDE,
            batched=merge_diffs(
                tree_diff(pytree.tree_map(
                    lambda x, b=b: x[b] if isinstance(x, torch.Tensor)
                    else x, batched), again[b]) for b in range(B)),
            repeat=merge_diffs(tree_diff(a, c[k][4])
                               for a, c in zip(again, calls))))
        for c in calls:    # free the recorded tensors as we go
            c[k] = None
    by_stage = {}
    for r in report:
        if r["batched"]:
            by_stage.setdefault(r["stage"], []).append(r["call"])
    return dict(batch=B, device=str(imgs_l.device), steps=steps,
                calls=report, differing_by_stage=by_stage,
                image_side_differing=[f"{r['stage']}: {r['call']}"
                                      for r in report
                                      if r["image_side"] and r["batched"]],
                not_repeatable=[f"{r['stage']}: {r['call']}" for r in report
                                if r["repeat"]])


def batched_sequences(frames, gt, scene, batch, track_steps=TRACK_STEPS):
    """`batch` distinct sequences cut from the corridor frames: sequence b
    is frames 4b .. 4b + track_steps + 1, bootstrapped at 4b, tracked over
    the next track_steps and keyframed on its last frame; the right images
    those two frames need are rendered where the sequence has none."""
    from trackingbench_slam_tpu_torch.utils.corridor import BASELINE, _u8
    seqs = []
    for b in range(batch):
        first, last = 4 * b, 4 * b + track_steps + 1
        seq = []
        for i in range(first, last + 1):
            left, right = frames[i]
            if right is None and i in (first, last):
                right = _u8(scene.stereo_pair(gt[i], BASELINE)[1])
            seq.append((left, right))
        seqs.append(seq)
    return seqs


def bootstrap(seq_frames, cam, cfg):
    """A sequence's state after its bootstrap keyframe (its first frame,
    left and right on the device)."""
    left, right = seq_frames[0]
    st = vo_mod.init_state(cfg, left)
    st = vo_mod.keyframe_step(st, right, cam, cfg)
    return st._replace(frame_id=st.frame_id + 1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the CPU")
    p.add_argument("--batch", type=int, default=8)
    args = p.parse_args(argv)
    import trackingbench_slam_tpu_torch  # noqa: F401  (precision pins)
    from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
    from trackingbench_slam_tpu_torch.utils.corridor import (
        corridor_frames, main_path_config)
    from trackingbench_slam_tpu_torch.utils.device import (resolve_device,
                                                           upload_image)
    dev = resolve_device("cpu" if args.cpu else None)
    cfg = main_path_config()
    cam = cam_mod.CameraParams.from_config(cfg.camera, dev)
    frames, gt, scene = corridor_frames(cfg, 4 * args.batch + 1)
    up = [[tuple(None if x is None else upload_image(x, dev) for x in f)
           for f in seq]
          for seq in batched_sequences(frames, gt, scene, args.batch)]
    gens = [torch.Generator(device=dev).manual_seed(b)
            for b in range(args.batch)]
    states = []
    for b, seq in enumerate(up):
        st = bootstrap(seq, cam, cfg)
        for i in range(1, TRACK_STEPS + 1):
            st = vo_mod.track_step(st, seq[i][0], cam, cfg, gens[b])
        states.append(st)
    report = batch_check(states, [s[-1][0] for s in up],
                         [s[-1][1] for s in up], cam, cfg,
                         dp_eval.draw_uniform(gens, cfg))
    if dev.type == "cuda":
        report["card"] = torch.cuda.get_device_name(0)
    out_dir = "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "batch_check.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    for r in report["calls"]:
        if r["batched"] or r["repeat"]:
            print(f"[batch_check] {r['stage']} {r['call']}: batched "
                  f"{r['batched']} repeat {r['repeat']}")
    print(json.dumps(dict(
        batch=report["batch"], device=report["device"],
        steps={k: v for k, v in report["steps"].items()},
        differing_by_stage=report["differing_by_stage"],
        image_side_differing=report["image_side_differing"],
        not_repeatable=report["not_repeatable"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
