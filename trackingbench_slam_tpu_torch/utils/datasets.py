"""Dataset loaders and writers: the KITTI odometry and EuRoC MAV layouts.

A copy of trackingbench_slam_tpu/utils/datasets.py on this package's own
image loader, renderers and trajectories. The reference hardcodes absolute
paths to these datasets and open-codes the parsing in each test program
(LoadImages / LoadKittiGroundTruth, test/test_vo.cpp:511-577; EuRoC at
test_vo.cpp:114-176). Here they are loaders over the standard layouts:

  KITTI odometry:  <root>/sequences/<SS>/image_0/*.png  (+ image_1 right),
                   <root>/sequences/<SS>/times.txt,
                   <root>/poses/<SS>.txt  (3x4 row-major world_from_cam)
  EuRoC MAV:       <root>/mav0/cam0/data/*.png (+ cam1),
                   <root>/mav0/cam0/data.csv (timestamps),
                   <root>/mav0/state_groundtruth_estimate0/data.csv

Images stream through utils/image_loader.py, which decodes ahead of the
tracker. The writers put rendered sequences with exact ground truth into
the same layouts.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np

from trackingbench_slam_tpu_torch.utils.config import CameraConfig
from trackingbench_slam_tpu_torch.utils.image_loader import ImageLoader
from trackingbench_slam_tpu_torch.utils.synthetic import (
    PlaneSequence, forward_yaw_trajectory, lateral_trajectory)


@dataclasses.dataclass
class StereoSequence:
    left: ImageLoader
    right: Optional[ImageLoader]
    timestamps: np.ndarray          # (N,) seconds
    gt_T_cw: Optional[np.ndarray]   # (N, 4, 4) world->camera, if available
    name: str = ""

    def __len__(self):
        return len(self.left)

    def __getitem__(self, i):
        """(left, right or None) of frame i, decoded by the loaders."""
        return (self.left[i],
                self.right[i] if self.right is not None else None)

    def __iter__(self) -> Iterator:
        for i in range(len(self)):
            yield self[i]


def _sorted_images(d: str) -> list[str]:
    exts = (".png", ".pgm", ".npy", ".jpg")
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.lower().endswith(exts))


def _T_cw_of_kitti_rows(raw: np.ndarray) -> np.ndarray:
    """KITTI's 3x4 T_w_cam rows -> (N, 4, 4) world->camera."""
    raw = raw.reshape(-1, 3, 4)
    T = np.tile(np.eye(4), (raw.shape[0], 1, 1))
    T[:, :3, :] = raw
    return np.linalg.inv(T)


def load_kitti_odometry(root: str, sequence: str = "00",
                        prefetch: int = 4) -> StereoSequence:
    """KITTI odometry gray (the reference's test_kitti data,
    test/test_vo.cpp:619-628)."""
    seq_dir = os.path.join(root, "sequences", sequence)
    left_paths = _sorted_images(os.path.join(seq_dir, "image_0"))
    right_dir = os.path.join(seq_dir, "image_1")
    right_paths = (_sorted_images(right_dir) if os.path.isdir(right_dir)
                   else None)
    times_file = os.path.join(seq_dir, "times.txt")
    if os.path.exists(times_file):
        timestamps = np.loadtxt(times_file)
    else:
        timestamps = np.arange(len(left_paths)) * 0.1
    poses_file = os.path.join(root, "poses", sequence + ".txt")
    gt = (_T_cw_of_kitti_rows(np.loadtxt(poses_file))
          if os.path.exists(poses_file) else None)
    return StereoSequence(
        left=ImageLoader(left_paths, prefetch=prefetch),
        right=ImageLoader(right_paths, prefetch=prefetch)
        if right_paths else None,
        timestamps=timestamps, gt_T_cw=gt, name=f"kitti-{sequence}")


def load_euroc(root: str, prefetch: int = 4) -> StereoSequence:
    """EuRoC MAV layout (the reference's test_vo_1 data,
    test/test_vo.cpp:114-122)."""
    cam0 = os.path.join(root, "mav0", "cam0", "data")
    cam1 = os.path.join(root, "mav0", "cam1", "data")
    left_paths = _sorted_images(cam0)
    right_paths = _sorted_images(cam1) if os.path.isdir(cam1) else None
    # timestamps are the filenames (ns)
    timestamps = np.asarray(
        [int(os.path.splitext(os.path.basename(p))[0]) for p in left_paths],
        np.float64) * 1e-9
    gt = None
    gt_csv = os.path.join(root, "mav0", "state_groundtruth_estimate0",
                          "data.csv")
    if os.path.exists(gt_csv):
        from scipy.spatial.transform import Rotation
        # columns: t[ns], p_xyz (3), q_wxyz (4), ...
        rows = np.genfromtxt(gt_csv, delimiter=",", skip_header=1)
        t_gt = rows[:, 0] * 1e-9
        # the ground-truth row at or after each frame's stamp
        idx = np.searchsorted(t_gt, timestamps).clip(0, len(t_gt) - 1)
        q = rows[idx, 4:8]  # w, x, y, z
        T_wb = np.tile(np.eye(4), (len(idx), 1, 1))
        T_wb[:, :3, :3] = Rotation.from_quat(q[:, [1, 2, 3, 0]]).as_matrix()
        T_wb[:, :3, 3] = rows[idx, 1:4]
        gt = np.linalg.inv(T_wb)  # body->world -> world->body (~camera)
    return StereoSequence(
        left=ImageLoader(left_paths, prefetch=prefetch),
        right=ImageLoader(right_paths, prefetch=prefetch)
        if right_paths else None,
        timestamps=timestamps, gt_T_cw=gt, name="euroc")


def _write_gray_png(path: str, img: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), mode="L").save(
        path)


def _centred_camera(width, height, fx, baseline) -> CameraConfig:
    return CameraConfig(width=width, height=height, fx=fx, fy=fx,
                        cx=width / 2, cy=height / 2, bf=fx * baseline)


def _write_kitti_layout(root: str, gt: np.ndarray, write_pair) -> None:
    """Frame i's pair through write_pair(T, left stem, right stem) into
    image_0 / image_1 as 00000i, times.txt at 10 Hz and poses/00.txt."""
    n = len(gt)
    seq_dir = os.path.join(root, "sequences", "00")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    for i, T in enumerate(gt):
        write_pair(T, os.path.join(seq_dir, "image_0", f"{i:06d}"),
                   os.path.join(seq_dir, "image_1", f"{i:06d}"))
    np.savetxt(os.path.join(seq_dir, "times.txt"), np.arange(n) * 0.1)
    T_wc = np.linalg.inv(gt)
    np.savetxt(os.path.join(root, "poses", "00.txt"),
               T_wc[:, :3, :].reshape(n, 12))


def save_corridor_kitti(root: str, n_frames: int = 100,
                        width: int = 1226, height: int = 370,
                        baseline: float = 0.54, step: float = 0.12,
                        yaw_rate: float = 0.01,
                        fx: float = 707.09) -> StereoSequence:
    """The corridor scene as a KITTI-layout sequence: PNG stereo pairs,
    times.txt and a poses/00.txt ground truth, the full-sequence protocol
    of the reference's test_kitti (test/test_vo.cpp:613-872) with exact
    ground truth. Returns the loaded StereoSequence."""
    from trackingbench_slam_tpu_torch.utils.corridor import render_sequence
    gt = forward_yaw_trajectory(n_frames, step=step, yaw_rate=yaw_rate)
    pairs = iter(render_sequence(
        _centred_camera(width, height, fx, baseline),
        dict(width=10.0, height=5.0), gt, baseline, False, "all"))

    def write_pair(T, left, right):
        L, R = next(pairs)
        _write_gray_png(left + ".png", L)
        _write_gray_png(right + ".png", R)
    _write_kitti_layout(root, gt, write_pair)
    return load_kitti_odometry(root, "00")


def save_synthetic_euroc(root: str, n_frames: int = 24,
                         width: int = 752, height: int = 480,
                         baseline: float = 0.11,
                         fx: float = 435.2) -> StereoSequence:
    """A corridor sequence in the EuRoC MAV layout (cam0/cam1 PNGs named by
    their ns timestamps, data.csv, a ground-truth csv of p + q_wxyz rows),
    so that load_euroc runs end to end."""
    from scipy.spatial.transform import Rotation

    from trackingbench_slam_tpu_torch.utils.corridor import render_sequence
    gt = forward_yaw_trajectory(n_frames, step=0.08, yaw_rate=0.012)
    pairs = render_sequence(_centred_camera(width, height, fx, baseline),
                            dict(width=8.0, height=4.0), gt, baseline,
                            False, "all")
    cam0 = os.path.join(root, "mav0", "cam0", "data")
    cam1 = os.path.join(root, "mav0", "cam1", "data")
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    for d in (cam0, cam1, gt_dir):
        os.makedirs(d, exist_ok=True)
    t0 = 1403636579763555584  # EuRoC-style ns epoch
    stamps = t0 + np.arange(n_frames, dtype=np.int64) * 50_000_000
    rows = []
    for i, (T, (L, R)) in enumerate(zip(gt, pairs)):
        _write_gray_png(os.path.join(cam0, f"{stamps[i]}.png"), L)
        _write_gray_png(os.path.join(cam1, f"{stamps[i]}.png"), R)
        T_wc = np.linalg.inv(T)
        q = Rotation.from_matrix(T_wc[:3, :3]).as_quat()  # x, y, z, w
        rows.append([stamps[i], *T_wc[:3, 3], q[3], q[0], q[1], q[2]])
    with open(os.path.join(root, "mav0", "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for s in stamps:
            f.write(f"{s},{s}.png\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp, p_x, p_y, p_z, q_w, q_x, q_y, q_z\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")
    return load_euroc(root)


def save_synthetic_kitti(root: str, n_frames: int = 20,
                         width: int = 1226, height: int = 370,
                         baseline: float = 0.54) -> StereoSequence:
    """A PlaneSequence in the KITTI layout (.npy images), so that the
    loaders and the pipeline run end to end with no external data."""
    seq = PlaneSequence(_centred_camera(width, height, 707.09, baseline),
                        depth=12.0)

    def write_pair(T, left, right):
        L, R = seq.stereo_pair(T, baseline)
        np.save(left + ".npy", L.astype(np.uint8))
        np.save(right + ".npy", R.astype(np.uint8))
    _write_kitti_layout(root, lateral_trajectory(n_frames, step=0.05),
                        write_pair)
    return load_kitti_odometry(root, "00")
