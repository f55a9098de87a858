"""Synthetic stereo sequences with exact ground truth (the corridor scene).

A copy of the corridor renderer and its two trajectories (forward with yaw,
and the closed loop) of trackingbench_slam_tpu/utils/synthetic.py, so that
this package renders the same frames without importing the JAX package.

The reference's tests depend on absolute paths to KITTI/EuRoC on the author's
machine (test/test_vo.cpp:114-122, 619-628) plus a bundled two-frame stereo
pair. For a hermetic harness we render sequences ourselves: a textured plane
observed by a moving pinhole camera is *exactly* renderable via homography
(H = K (R - t n^T / d) K^-1), including the rectified stereo pair — so VO
output can be scored against exact poses and exact depth with zero I/O.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from trackingbench_slam_tpu_torch.utils.config import CameraConfig


def _bilinear_np(img: np.ndarray, uv: np.ndarray) -> np.ndarray:
    h, w = img.shape
    x = np.clip(uv[:, 0], 0, w - 1.001)
    y = np.clip(uv[:, 1], 0, h - 1.001)
    x0 = x.astype(int)
    y0 = y.astype(int)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


@dataclasses.dataclass
class _Plane:
    p0: np.ndarray      # a point on the plane (3,)
    n: np.ndarray       # unit normal (3,)
    u: np.ndarray       # in-plane texture x axis (3,), unit
    v: np.ndarray       # in-plane texture y axis (3,), unit
    half_u: float       # plane half-extent along u (meters)
    half_v: float       # half-extent along v
    canvas: np.ndarray  # texture image
    px_per_m: float     # texture sampling density


@dataclasses.dataclass
class CorridorScene:
    """Multi-plane scene with real depth variation: floor, ceiling, two side
    walls and an end wall, each carrying independent texture. Rendering is
    exact per-pixel ray casting with a z-buffer over the planes, so rotation-
    heavy and forward trajectories produce geometrically exact images and
    depth maps — the non-degenerate counterpart of PlaneSequence (whose
    single fronto-parallel plane under lateral motion is the easy case the
    round-1 verdict flagged).

    Geometry (world frame, camera starts at origin looking +z):
      floor y=+h/2, ceiling y=-h/2, walls x=+-w/2, end wall z=length.
    """

    cam: CameraConfig
    width: float = 6.0     # corridor width (m)
    height: float = 4.0    # corridor height (m)
    length: float = 40.0   # end wall distance (m)
    seed: int = 7

    def __post_init__(self):
        w2, h2, L = self.width / 2, self.height / 2, self.length
        ex = np.array([1.0, 0, 0])
        ey = np.array([0, 1.0, 0])
        ez = np.array([0, 0, 1.0])
        ppm = 24.0  # texture px per meter
        margin = 8.0  # extra extent so turns never run off-texture

        def tex(seed, su, sv):
            H = int(sv * ppm)
            W = int(su * ppm)
            r = np.random.RandomState(seed)
            img = 70.0 + 60.0 * np.outer(np.linspace(0, 1, H),
                                         np.linspace(0, 1, W))
            for _ in range(int(su * sv * 3.0)):
                y = r.randint(0, max(H - 12, 1))
                x = r.randint(0, max(W - 12, 1))
                img[y:y + r.randint(2, 12), x:x + r.randint(2, 12)] = \
                    r.randint(10, 245)
            k = np.ones(3) / 3.0
            img = np.apply_along_axis(
                lambda m: np.convolve(m, k, mode="same"), 0, img)
            img = np.apply_along_axis(
                lambda m: np.convolve(m, k, mode="same"), 1, img)
            return img.astype(np.float32)

        # slab planes span z in [-margin, L] and a back wall closes the
        # corridor at z=-margin, so 360-degree (loop) trajectories always
        # see texture in every direction
        span = L + margin
        zc = (L - margin) / 2
        self.planes = [
            # floor: normal -y, texture axes (x, z)
            _Plane(np.array([0, h2, zc]), -ey, ex, ez, w2 + margin,
                   span / 2, tex(self.seed + 1, 2 * (w2 + margin), span),
                   ppm),
            # ceiling
            _Plane(np.array([0, -h2, zc]), ey, ex, ez, w2 + margin,
                   span / 2, tex(self.seed + 2, 2 * (w2 + margin), span),
                   ppm),
            # left wall x=-w2, normal +x, axes (z, y)
            _Plane(np.array([-w2, 0, zc]), ex, ez, ey, span / 2,
                   h2 + margin, tex(self.seed + 3, span, 2 * (h2 + margin)),
                   ppm),
            # right wall
            _Plane(np.array([w2, 0, zc]), -ex, ez, ey, span / 2,
                   h2 + margin, tex(self.seed + 4, span, 2 * (h2 + margin)),
                   ppm),
            # end wall z=L, normal -z, axes (x, y)
            _Plane(np.array([0, 0, L]), -ez, ex, ey, w2 + margin,
                   h2 + margin, tex(self.seed + 5, 2 * (w2 + margin),
                                    2 * (h2 + margin)), ppm),
            # back wall z=-margin, normal +z
            _Plane(np.array([0, 0, -margin]), ez, ex, ey, w2 + margin,
                   h2 + margin, tex(self.seed + 6, 2 * (w2 + margin),
                                    2 * (h2 + margin)), ppm),
        ]

    def _raycast(self, T_cw: np.ndarray):
        cfg = self.cam
        h, w = cfg.height, cfg.width
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        xn = (xs - cfg.cx) / cfg.fx
        yn = (ys - cfg.cy) / cfg.fy
        rays = np.stack([xn, yn, np.ones_like(xn)], axis=-1).reshape(-1, 3)
        T_wc = np.linalg.inv(T_cw)
        R, c = T_wc[:3, :3], T_wc[:3, 3]
        d_w = rays @ R.T  # (N, 3)
        best_t = np.full(d_w.shape[0], np.inf)
        out = np.zeros(d_w.shape[0], np.float32)
        for pl in self.planes:
            denom = d_w @ pl.n
            denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            t = ((pl.p0 - c) @ pl.n) / denom
            pts = c[None, :] + t[:, None] * d_w
            rel = pts - pl.p0[None, :]
            uu = rel @ pl.u
            vv = rel @ pl.v
            hit = ((t > 0.1) & (t < best_t)
                   & (np.abs(uu) <= pl.half_u) & (np.abs(vv) <= pl.half_v))
            ch, cw = pl.canvas.shape
            uv = np.stack([uu * pl.px_per_m + cw / 2,
                           vv * pl.px_per_m + ch / 2], axis=-1)
            vals = _bilinear_np(pl.canvas, uv)
            out = np.where(hit, vals, out).astype(np.float32)
            best_t = np.where(hit, t, best_t)
        depth = (best_t[:, None] * rays)[:, 2]  # z along camera axis
        return (out.reshape(h, w),
                np.where(np.isfinite(depth), depth, 0.0)
                .reshape(h, w).astype(np.float32))

    def render(self, T_cw: np.ndarray) -> np.ndarray:
        return self._raycast(T_cw)[0]

    def depth_map(self, T_cw: np.ndarray) -> np.ndarray:
        return self._raycast(T_cw)[1]

    def stereo_pair(self, T_cw: np.ndarray, baseline: float):
        left = self.render(T_cw)
        shift = np.eye(4)
        shift[0, 3] = -baseline
        right = self.render(shift @ T_cw)
        return left, right


def forward_yaw_trajectory(n: int, step: float = 0.12,
                           yaw_rate: float = 0.01,
                           pitch_amp: float = 0.004):
    """World->camera poses for forward motion down the corridor with a
    continuous yaw turn and gentle pitch oscillation — rotation-heavy and
    depth-varying (near floor texture vs far end wall). yaw_rate is rad per
    frame; n * yaw_rate of total rotation accumulates."""
    from scipy.spatial.transform import Rotation
    poses = []
    c = np.zeros(3)
    yaw = 0.0
    for i in range(n):
        yaw += yaw_rate
        pitch = pitch_amp * np.sin(i * 0.35)
        R_wc = Rotation.from_euler("yx", [yaw, pitch]).as_matrix()
        # advance along the current viewing direction (z axis of camera)
        c = c + R_wc[:, 2] * step
        T_wc = np.eye(4)
        T_wc[:3, :3] = R_wc
        T_wc[:3, 3] = c
        poses.append(np.linalg.inv(T_wc))
    return np.stack(poses)


def loop_trajectory(n: int, radius: float = 1.2, height_amp: float = 0.02,
                    ease: float = 0.75):
    """A closed circular path in the x-z plane with tangent-following yaw:
    the camera returns to, and re-observes, its starting view. `ease`
    reparametrizes the circle with the speed profile
    s(u) = u - (ease / 2pi) sin(2pi u): the turn rate ramps from (1 - ease)
    of the mean to (1 + ease) at mid-loop and back."""
    from scipy.spatial.transform import Rotation
    poses = []
    for i in range(n):
        u = i / n
        s = u - ease / (2 * np.pi) * np.sin(2 * np.pi * u)
        th = 2 * np.pi * s
        c = np.array([radius * np.sin(th), height_amp * np.sin(3 * th),
                      radius * (1 - np.cos(th)) + 2.0])
        R_wc = Rotation.from_euler("y", th).as_matrix()
        T_wc = np.eye(4)
        T_wc[:3, :3] = R_wc
        T_wc[:3, 3] = c
        poses.append(np.linalg.inv(T_wc))
    return np.stack(poses)
