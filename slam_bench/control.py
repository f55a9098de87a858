"""The controls of `correct`: the timed path in the precision below the
configuration's, which the check has to find not correct.

The configurations state float32 (`dtype`). While `installed(kind)` is in
force, the run goes on from what the control gives:

  * `kernels`: every hand-kernel launch of the port (the batched launchers
    on the card, the plain versions on the CPU) computes
    reference/kernels.py in bfloat16 instead;
  * `pose`: the port's motion-only pose solve (solvers/pose_opt.py
    `pose_optimization`, the track step's largest stage) takes its pose,
    landmarks and observations in bfloat16 and hands its pose back in
    bfloat16, its own arithmetic left as it is;
  * `lm`: a fault, not a precision: the same solve with one LM round of two
    iterations in place of the configuration's rounds.

The benchmark's own runs never install one.

    python -m slam_bench.control --workload kitti-stereo.dataset \
        --kind pose --seeds 11,12,13 --seconds 5

runs the cell once a seed with the control in place, on the card, and
prints each run's checks as one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import sys

import torch

from slam_bench.reference import kernels as ref

DTYPE = torch.bfloat16


CHUNK = 8   # sequences a replacement computes at a time (memory)


def _chunked(fn):
    """fn over the batch a CHUNK of sequences at a time (every tensor
    argument, also inside lists, split on its first axis), the outputs
    joined again."""
    def pick(x, c):
        if isinstance(x, (list, tuple)):
            return [pick(v, c) for v in x]
        return x[c] if isinstance(x, torch.Tensor) else x

    def batched(*args, **kw):
        first = args[0][0] if isinstance(args[0], (list, tuple)) else args[0]
        B = first.shape[0]
        outs = [fn(*pick(args, slice(i, i + CHUNK)),
                   **{k: pick(v, slice(i, i + CHUNK)) for k, v in kw.items()})
                for i in range(0, B, CHUNK)]
        out = type(outs[0])(torch.cat(o) for o in zip(*outs))
        if first.is_cuda:
            # hand the replacement's scratch back: the EuRoC cell's own
            # peak is 90% of the card
            del outs
            torch.cuda.empty_cache()
        return out
    return batched


@_chunked
def _lk(prev, cur, pts, start, valid, scale=0.5, offset=None, half=10,
        iters=30, conv_eps=0.01, fb_iters=0):
    out, _ = ref.lk_align(prev, cur, pts, start, valid, scale=scale,
                          offset=offset, half=half, iters=iters,
                          conv_eps=conv_eps, fb_iters=fb_iters, dtype=DTYPE)
    return tuple(o.float() if o.is_floating_point() else o for o in out)


@_chunked
def _fast(imgs, threshold=20.0, arc=9):
    return [ref.fast_score_nms(i, threshold, arc, DTYPE).float()
            for i in imgs]


@_chunked
def _orb(raw, blurred, xy, valid, counts):
    angle, desc = ref.orb_describe(raw, blurred, xy, valid, list(counts),
                                   DTYPE)
    return angle.float(), desc


def _cells_into(out, img, kp, slots, want, capacity):
    """The wanted cells written into the (B, A, A) atlases `out`, a CHUNK
    of sequences at a time."""
    for i in range(0, out.shape[0], CHUNK):
        c = slice(i, i + CHUNK)
        grid = ref.atlas_cells(out[c])
        ok = want[c] & (slots[c] >= 0) & (slots[c] < capacity)
        win = ref.last_writer(slots[c], ok, grid.shape[1])
        cells = ref.anchor_cells(img[c], kp[c], DTYPE).float()
        bi = torch.arange(win.shape[0], device=out.device)[:, None].expand_as(
            win)
        has = win >= 0
        grid[has] = cells[bi[has], win[has]]
        out[c] = ref.cells_atlas(grid)
    return out


def _one(fn):
    """A batched function as the per-sequence plain version it stands for."""
    def plain(*args, **kw):
        def b(x):
            if isinstance(x, (list, tuple)):
                return [b(v) for v in x]
            return x[None] if isinstance(x, torch.Tensor) else x
        out = fn(*b(args), **{k: b(v) for k, v in kw.items()})
        if isinstance(out, torch.Tensor):
            return out[0]
        return type(out)(o[0] for o in out)
    return plain


def _cells_plain(img, kp, slots, want, atlas, capacity):
    return _cells_into(atlas.clone()[None], img[None], kp[None], slots[None],
                       want[None], capacity)[0]


REPLACEMENTS = {
    "trackingbench_slam_tpu_torch.ops.cuda.lk_kernel": dict(
        lk_align_cuda_batched=_lk, lk_align_plain=_one(_lk)),
    "trackingbench_slam_tpu_torch.ops.cuda.fast_kernel": dict(
        fast_score_nms_cuda_batched=_fast,
        fast_score_nms_plain_levels=_one(_fast)),
    "trackingbench_slam_tpu_torch.ops.cuda.patch_kernel": dict(
        orb_describe_cuda_batched=_orb, orb_describe_plain=_one(_orb),
        anchor_cells_into_batched=_cells_into,
        anchor_cells_plain=_cells_plain),
}


POSE_MODULE = "trackingbench_slam_tpu_torch.solvers.pose_opt"


def _low(x):
    return x.to(DTYPE).to(x.dtype) if x.is_floating_point() else x


def _pose_in_bfloat16(real):
    def solve(cam, T_init, pts_w, obs_px, inv_sigma2, valid, config):
        out = real(cam, _low(T_init), _low(pts_w), _low(obs_px), inv_sigma2,
                   valid, config)
        return out._replace(T_cw=_low(out.T_cw))
    return solve


def _pose_one_round(real):
    def solve(cam, T_init, pts_w, obs_px, inv_sigma2, valid, config):
        return real(cam, T_init, pts_w, obs_px, inv_sigma2, valid,
                    dataclasses.replace(config, rounds=1, iters_per_round=2))
    return solve


KINDS = dict(kernels=None, pose=_pose_in_bfloat16, lm=_pose_one_round)


@contextlib.contextmanager
def installed(kind: str = "kernels"):
    with contextlib.ExitStack() as stack:
        if kind == "kernels":
            repl = REPLACEMENTS
        else:
            mod = importlib.import_module(POSE_MODULE)
            repl = {POSE_MODULE: dict(pose_optimization=KINDS[kind](
                mod.pose_optimization))}
        for modname, fns in repl.items():
            mod = importlib.import_module(modname)
            for name, fn in fns.items():
                stack.callback(setattr, mod, name, getattr(mod, name))
                setattr(mod, name, fn)
        yield


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--kind", choices=sorted(KINDS), default="kernels")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    from slam_bench import battery, registry, run as run_mod
    found = registry.find_cell(registry.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("slam_bench.control: no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        with installed(args.kind):
            r = battery.run_cell(found, seed, args.seconds, False, "cuda",
                                 run_mod.process_start(),
                                 lambda m: print(m, file=sys.stderr))
        row = dict(kind=args.kind, seed=seed,
                   correct=all(c["ok"] for c in r.checks.values()),
                   checks=r.checks)
        print(json.dumps(row), flush=True)
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
