"""Does the loop bench repeat? The loop bench run several times in one
process on the same frames, compared frame by frame.

    python3 -m trackingbench_slam_tpu_torch.repeat_check [--runs 2]
        [--closer] [--deterministic] [--op-log] [--frames-cache PATH]
        [--label NAME]

Per run it keeps every frame's pose and, after every frame, one float64
sum per VOState leaf (the leaves of utils/convert.py's numpy view, in its
order), reduced on the device and fetched at the end. Runs after the first
are compared with it: the first frame whose pose is not torch.equal, the
first frame whose state differs and the leaves that differ there, and the
closing error of each run. Without --closer the runs track with no loop
closer; with it each run attaches bench.py's LoopCloser(voc, cam,
min_score=0.015, min_inliers=40, exclude_recent=5), all on one vocabulary
trained once (`train_vocabulary`), and the frames at which loops closed and
tracking relocalized are compared too. With --op-log every ATen op's
outputs are summed too in the runs after the first (a TorchDispatchMode;
factory ops that return uninitialised memory, and outputs on the host, are
skipped), and the second and third runs are compared op by op, which
names the first op whose output differs (the first run fills the caches
and warms up, so its op sequence is not compared).
--deterministic runs under torch.use_deterministic_algorithms(True,
warn_only=True) and prints the ops that warned. The loop bench's 96 frames
take minutes to render: --frames-cache keeps them in an .npz for the next
process. Results go to chiprun_out/repeat_check_<label>.json.

Uses only StereoVO, the loop closer, the vocabulary and the corridor, so it
also runs against an older checkout of the package (copy this file into
it).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

FACTORY_OPS = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "resize_", "set_")


def frames_cached(cfg, n, path):
    from trackingbench_slam_tpu_torch.utils.corridor import loop_frames
    if path and os.path.exists(path):
        z = np.load(path)
        lefts, gt = z["lefts"], z["gt"]
        rights = {int(k[6:]): z[k] for k in z.files if k.startswith("right_")}
        return [(lefts[i], rights.get(i)) for i in range(n)], gt[:n]
    frames, gt, _ = loop_frames(cfg, n)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, lefts=np.stack([f[0] for f in frames]), gt=gt,
                 **{f"right_{i}": f[1] for i, f in enumerate(frames)
                    if f[1] is not None})
    return frames, gt


def train_vocabulary(cfg, frames, device, every=12):
    """bench.py's in-domain vocabulary: ORB of every `every`-th left image,
    the first 4000 valid descriptors, k = 6, L = 3, seed 0. Returns
    (vocabulary, descriptors used)."""
    import torch
    from trackingbench_slam_tpu_torch.bow import vocabulary as bow
    from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
    from trackingbench_slam_tpu_torch.models.extractors import extract_orb
    from trackingbench_slam_tpu_torch.models.frame import make_frame
    cam = cam_mod.CameraParams.from_config(cfg.camera, device)
    descs = []
    for i in range(0, len(frames), every):
        f = make_frame(torch.from_numpy(frames[i][0]).to(device),
                       cfg.extractor.num_features, cfg.pyramid.num_levels,
                       cfg.pyramid.scale_factor)
        f = extract_orb(f, cam, cfg.extractor, cfg.pyramid)
        descs.append(f.desc[f.valid].cpu().numpy())
    descs = np.concatenate(descs)[:4000]
    return bow.train(descs, branching=6, depth=3, seed=0,
                     device=device), len(descs)


def named_leaves(state):
    """[(name, tensor)] of a VOState in utils/convert.py's field order."""
    out = []
    for name, v in state._asdict().items():
        if hasattr(v, "_asdict"):
            for sub, x in v._asdict().items():
                if isinstance(x, tuple):
                    out += [(f"{name}.{sub}.{i}", t) for i, t in enumerate(x)]
                else:
                    out.append((f"{name}.{sub}", x))
        else:
            out.append((name, v))
    return out


def digest(t):
    import torch
    return t.detach().to(torch.float64).sum() if t.numel() else \
        torch.zeros((), dtype=torch.float64, device=t.device)


def op_logger(device):
    """A TorchDispatchMode that keeps a float64 sum of every op's tensor
    outputs (tensors on `device`, fetched later) and the op's name."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class OpLog(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names, self.sums = [], []
            self.device = device

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in FACTORY_OPS:
                return out
            # outputs on the host are skipped: host bookkeeping, and copies
            # into pinned memory whose data has not landed when summed
            ts = [t if t.dtype != torch.bool else t.to(torch.uint8)
                  for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                  and t.numel() and t.device == self.device]
            if ts:
                with torch.utils._python_dispatch._disable_current_modes():
                    s = sum(t.to(torch.float64).sum() for t in ts)
                self.names.append(name)
                self.sums.append(s)
            return out
    return OpLog()


def one_run(cfg, frames, device, op_log: bool, voc=None):
    import torch
    from trackingbench_slam_tpu_torch.models.loop_closer import LoopCloser
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    vo = StereoVO(cfg, device=device)
    if voc is not None:
        vo.loop_closer = LoopCloser(voc, vo.cam, min_score=0.015,
                                    min_inliers=40, exclude_recent=5)
    digests, names, op_frames = [], None, []
    t0 = time.perf_counter()
    for left, right in frames:
        if op_log:
            log = op_logger(device)
            with log:
                vo.track(left, right)
            op_frames.append((log.names, torch.stack(log.sums).cpu().numpy()
                              if log.sums else np.zeros(0)))
        else:
            vo.track(left, right)
        leaves = named_leaves(vo.state)
        names = [n for n, _ in leaves]
        digests.append(torch.stack([digest(t) for _, t in leaves]))
    torch.cuda.synchronize() if device.type == "cuda" else None
    seconds = time.perf_counter() - t0
    traj = torch.stack(vo.trajectory).cpu()
    return dict(traj=traj, digests=torch.stack(digests).cpu().numpy(),
                names=names, poses=vo.poses(), ops=op_frames,
                seconds=seconds, loop_events=list(vo.loop_events),
                reloc_events=list(vo.reloc_events))


def _differ(x, y):
    """Elementwise x != y, NaN equal to NaN."""
    return (x != y) & ~(np.isnan(x) & np.isnan(y))


def compare(a, b):
    import torch
    n = len(a["traj"])
    pose_frame = next((i for i in range(n)
                       if not torch.equal(a["traj"][i], b["traj"][i])), None)
    differ = _differ(a["digests"], b["digests"])
    state_frame = next((i for i in range(n) if differ[i].any()), None)
    out = dict(first_pose_frame=pose_frame, first_state_frame=state_frame,
               identical=(pose_frame is None and state_frame is None
                          and a["loop_events"] == b["loop_events"]
                          and a["reloc_events"] == b["reloc_events"]),
               loop_events=[a["loop_events"], b["loop_events"]],
               reloc_events=[a["reloc_events"], b["reloc_events"]],
               max_pose_diff=float((a["traj"] - b["traj"]).abs().max()))
    if state_frame is not None:
        out["leaves_differing"] = [a["names"][j] for j in
                                   np.nonzero(differ[state_frame])[0]]
    if a["ops"] and b["ops"]:
        for f, ((na, sa), (nb, sb)) in enumerate(zip(a["ops"], b["ops"])):
            if na != nb:
                k = next(i for i, (x, y) in enumerate(zip(na, nb)) if x != y)
                out["first_op"] = dict(frame=f, index=k, op=na[k],
                                       note="op sequences part here")
                break
            bad = np.nonzero(_differ(sa, sb))[0]
            if len(bad):
                k = int(bad[0])
                out["first_op"] = dict(
                    frame=f, index=k, op=na[k], ops_in_frame=len(na),
                    preceding=na[max(0, k - 8):k],
                    sums=[float(sa[k]), float(sb[k])])
                break
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--closer", action="store_true",
                    help="attach bench.py's LoopCloser to every run")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--op-log", action="store_true")
    ap.add_argument("--frames-cache", default="")
    ap.add_argument("--label", default="run")
    ap.add_argument("--cpu-config", action="store_true",
                    help="a 320x240 loop bench on the CPU (rehearsal)")
    args = ap.parse_args(argv)
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import trackingbench_slam_tpu_torch  # noqa: F401  (precision pins)
    from trackingbench_slam_tpu_torch.utils.corridor import (
        closing_error, loop_bench_config)
    if args.cpu_config:
        import dataclasses
        from trackingbench_slam_tpu_torch.utils.config import (
            CameraConfig, ExtractorConfig, MapConfig)
        fx = 707.09 * 320 / 1226
        cfg = dataclasses.replace(
            loop_bench_config(),
            camera=CameraConfig(width=320, height=240, fx=fx, fy=fx,
                                cx=160.0, cy=120.0, bf=fx * 0.54),
            extractor=ExtractorConfig(num_features=256, min_threshold=12,
                                      cell_size=24),
            map=MapConfig(max_keyframes=8, max_points=2048))
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("repeat_check: no CUDA device", file=sys.stderr)
            return 2
        cfg = loop_bench_config()
        device = torch.device("cuda")
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    frames, gt = frames_cached(cfg, args.frames, args.frames_cache)
    render_s = time.perf_counter() - t0
    voc = train_vocabulary(cfg, frames, device)[0] if args.closer else None
    runs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k in range(args.runs):
            runs.append(one_run(cfg, frames, device, args.op_log and k > 0,
                                voc))
    warned = sorted({str(w.message).split("\n")[0][:160] for w in caught
                     if "deterministic" in str(w.message)})
    result = dict(label=args.label, closer=args.closer,
                  deterministic=args.deterministic,
                  op_log=args.op_log, frames=args.frames, render_s=render_s,
                  device=(torch.cuda.get_device_name(0)
                          if device.type == "cuda" else "cpu"),
                  nvidia_smi=(subprocess.run(
                      ["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True, timeout=60).stdout.strip()
                      if device.type == "cuda" else None),
                  closing_err_m=[closing_error(r["poses"], gt) for r in runs],
                  run_s=[r["seconds"] for r in runs],
                  against_first=[compare(runs[0], r) for r in runs[1:]],
                  ops_second_against_third=(
                      compare(runs[1], runs[2]) if args.op_log
                      and len(runs) > 2 else None),
                  nondeterministic_ops_warned=warned)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out",
                           f"repeat_check_{args.label}.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
