"""Runnable demo: stereo VO over a rendered synthetic sequence.

    python -m trackingbench_slam_tpu_torch.demo [--frames N] [--cpu] [--step S]

Prints per-frame estimated vs ground-truth camera position (the reference's
eval protocol, test/test_vo.cpp:763-764), then the ATE-RMSE and RPE(1);
exits with 1 when the ATE is above 5 cm. Runs on CUDA unless --cpu is
given. The counterpart of trackingbench_slam_tpu/demo.py.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the CPU "
                        "(default: CUDA)")
    p.add_argument("--step", type=float, default=0.03,
                   help="camera translation per frame (m)")
    args = p.parse_args(argv)
    if args.frames < 2:
        p.error("--frames must be >= 2")

    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    from trackingbench_slam_tpu_torch.utils import metrics
    from trackingbench_slam_tpu_torch.utils.config import (
        CameraConfig, ExtractorConfig, MapConfig, PipelineConfig,
        PyramidConfig)
    from trackingbench_slam_tpu_torch.utils.synthetic import (
        PlaneSequence, lateral_trajectory)

    baseline = 0.2
    cam = CameraConfig(width=320, height=240, fx=300.0, fy=300.0,
                       cx=160.0, cy=120.0, bf=300.0 * baseline)
    cfg = PipelineConfig(
        camera=cam,
        pyramid=PyramidConfig(num_levels=3, scale_factor=0.8),
        extractor=ExtractorConfig(num_features=512, min_threshold=12,
                                  cell_size=16),
        map=MapConfig(max_keyframes=8, max_points=4096),
        keyframe_every=5,
    )
    vo = StereoVO(cfg, device="cpu" if args.cpu else None)
    print(f"device: {vo.device}", flush=True)
    print("rendering synthetic stereo sequence...", flush=True)
    seq = PlaneSequence(cfg.camera, depth=8.0)
    gt = lateral_trajectory(args.frames, step=args.step)
    frames = [seq.stereo_pair(T, baseline) for T in gt]

    t0 = time.time()
    for i, (L, R) in enumerate(frames):
        st = vo.track(L, R)
        est = metrics.trajectory_positions(vo.poses()[-1:])[0]
        ref = metrics.trajectory_positions(gt[i:i + 1])[0]
        print(f"frame {i:3d}  est=({est[0]:+.3f},{est[1]:+.3f},{est[2]:+.3f})"
              f"  gt=({ref[0]:+.3f},{ref[1]:+.3f},{ref[2]:+.3f})"
              f"  inliers={int(st.num_inliers):4d}"
              f"  map={int(st.map.valid.sum()):5d}", flush=True)
    dt = time.time() - t0

    poses = vo.poses()
    ate = metrics.ate_rmse(poses, gt, align=True)
    rpe = metrics.rpe_translation(poses, gt)
    print(f"\nATE-RMSE: {ate * 100:.2f} cm   RPE(1): {rpe * 100:.2f} cm"
          f"   wall: {dt:.1f}s ({len(frames) / dt:.2f} fps incl. the "
          f"kernels' first-use build)")
    if ate > 0.05:
        print("FAIL: ATE above 5 cm", file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
