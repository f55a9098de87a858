"""Stereo VO over a recorded sequence on disk, scored and exported: the
reference's own evaluation protocol (test/test_vo.cpp:511-577), as
bench.py:547 `real_sequence_eval` runs it.

    python -m trackingbench_slam_tpu_torch.sequence_eval --kitti-root DIR
    python -m trackingbench_slam_tpu_torch.sequence_eval --euroc-root DIR
        [--max-frames 150]

The roots also come from the KITTI_ROOT and EUROC_ROOT environment
variables. Prints one JSON object: the dataset, the frames tracked, frames
per second (the kernels' first-use build included) and the ATE RMSE
against the sequence's ground truth where it has one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def real_sequence_eval(kitti_root=None, euroc_root=None, max_frames=150,
                       out_dir=".", device=None):
    """StereoVO over KITTI sequence 00 under `kitti_root`, else over the
    EuRoC MAV sequence under `euroc_root`, with a keyframe every 5th frame
    and local BA every 2nd keyframe; at most `max_frames` frames.

    Writes traj_<tag>.kitti.txt and traj_<tag>.tum.txt (the sequence's
    timestamps) into `out_dir` and returns {dataset, frames, fps,
    ate_rmse_m} (no ate_rmse_m without ground truth), or None when neither
    root is a directory.

    As in the reference protocol, a KITTI root runs at kitti_stereo_config's
    camera (1241x376, fx 718.856, cx 607.1928, cy 185.2157, bf 0.573 fx)
    whatever size and intrinsics the directory's images have."""
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    from trackingbench_slam_tpu_torch.utils import (datasets, metrics,
                                                    trajectory_io)
    from trackingbench_slam_tpu_torch.utils.config import (
        euroc_stereo_config, kitti_stereo_config)
    kitti_root = kitti_root or os.environ.get("KITTI_ROOT")
    euroc_root = euroc_root or os.environ.get("EUROC_ROOT")
    if kitti_root and os.path.isdir(kitti_root):
        seq = datasets.load_kitti_odometry(kitti_root, "00")
        cfg, tag = kitti_stereo_config(), "kitti00"
    elif euroc_root and os.path.isdir(euroc_root):
        seq = datasets.load_euroc(euroc_root)
        cfg, tag = euroc_stereo_config(), "euroc"
    else:
        return None
    cfg = dataclasses.replace(cfg, keyframe_every=5, local_ba_every=2)
    vo = StereoVO(cfg, device=device)
    n = min(max_frames, len(seq))
    t0 = time.time()
    for i in range(n):
        vo.track(seq.left[i], seq.right[i] if seq.right is not None else None)
    P = vo.poses()
    dt = time.time() - t0
    os.makedirs(out_dir, exist_ok=True)
    trajectory_io.save_kitti_trajectory(
        os.path.join(out_dir, f"traj_{tag}.kitti.txt"), P)
    trajectory_io.save_tum_trajectory(
        os.path.join(out_dir, f"traj_{tag}.tum.txt"), P, seq.timestamps[:n])
    res = {"dataset": tag, "frames": n, "fps": n / dt}
    if seq.gt_T_cw is not None:
        res["ate_rmse_m"] = metrics.ate_rmse(P, seq.gt_T_cw[:n], align=True)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kitti-root", default=None)
    p.add_argument("--euroc-root", default=None)
    p.add_argument("--max-frames", type=int, default=150)
    args = p.parse_args(argv)
    res = real_sequence_eval(args.kitti_root, args.euroc_root,
                             args.max_frames)
    if res is None:
        print("sequence_eval: no KITTI or EuRoC root (--kitti-root, "
              "--euroc-root, KITTI_ROOT, EUROC_ROOT) is a directory",
              file=sys.stderr)
        return 2
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
