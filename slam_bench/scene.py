"""The corridor scene and the sequences' trajectories, rendered in torch.

A frozen copy of the port's corridor renderer
(trackingbench_slam_tpu_torch/utils/synthetic.py:123-255 `CorridorScene`,
`_bilinear_np` at :98-113; the frame conversion of utils/corridor.py:78-79
`_u8`), with the ray cast and the texture blur in torch, in float64, so
that a battery's thousands of frames render on the card in set-up. The
textures keep the copied layout (a gradient, rectangles of random grey,
a 3-tap box blur along each axis), but their rectangles are drawn in bulk
from a torch.Generator instead of one numpy draw at a time; `plane_layout`
gives a copied scene's planes the canvases of the repo's own scene for the
test that holds the two renderers together.

Trajectories follow the main path's motion (utils/synthetic.py:258-279
`forward_yaw_trajectory`: 0.12 m a frame along the view, the same pitch
wobble), with a yaw that swings smoothly instead of turning on, so the
camera stays inside the corridor for hundreds of frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

def plane_layout(width: float, height: float, length: float,
                 margin: float = 8.0):
    """(p0, n, u, v, half_u, half_v, (texture metres along u, along v)) of
    each plane, as CorridorScene.__post_init__ lays them out
    (utils/synthetic.py:150-214)."""
    w2, h2, L = width / 2, height / 2, length
    ex, ey, ez = np.eye(3)
    span = L + margin
    zc = (L - margin) / 2
    return [
        (np.array([0, h2, zc]), -ey, ex, ez, w2 + margin, span / 2,
         (2 * (w2 + margin), span)),
        (np.array([0, -h2, zc]), ey, ex, ez, w2 + margin, span / 2,
         (2 * (w2 + margin), span)),
        (np.array([-w2, 0, zc]), ex, ez, ey, span / 2, h2 + margin,
         (span, 2 * (h2 + margin))),
        (np.array([w2, 0, zc]), -ex, ez, ey, span / 2, h2 + margin,
         (span, 2 * (h2 + margin))),
        (np.array([0, 0, L]), -ez, ex, ey, w2 + margin, h2 + margin,
         (2 * (w2 + margin), 2 * (h2 + margin))),
        (np.array([0, 0, -margin]), ez, ex, ey, w2 + margin, h2 + margin,
         (2 * (w2 + margin), 2 * (h2 + margin))),
    ]


def box_blur(img: torch.Tensor) -> torch.Tensor:
    """np.convolve(row, [1/3] * 3, mode="same") down the columns, then along
    the rows (zero outside), in float64 (utils/synthetic.py:172-176), as
    shifted sums (a float64 convolution is slow on the card)."""
    k = 1.0 / 3.0
    p = F.pad(img.double(), (0, 0, 1, 1))
    x = p[:-2] * k + p[1:-1] * k + p[2:] * k
    p = F.pad(x, (1, 1))
    return p[:, :-2] * k + p[:, 1:-1] * k + p[:, 2:] * k


def texture(shape_m, ppm: float, blobs_per_m2: float, gen: torch.Generator,
            device) -> torch.Tensor:
    """A plane's canvas (float32): the gradient 70 + 60 y x, then
    int(su sv blobs_per_m2) rectangles of 2-11 px a side and grey 10-244
    painted in order (a later one covers an earlier), then the box blur.
    The rectangles come from `gen` in four bulk draws."""
    su, sv = shape_m
    H, W = int(sv * ppm), int(su * ppm)
    n = int(su * sv * blobs_per_m2)
    f64 = dict(dtype=torch.float64, device=device)
    img = 70.0 + 60.0 * torch.outer(torch.linspace(0, 1, H, **f64),
                                    torch.linspace(0, 1, W, **f64))
    draw = torch.randint(0, 2 ** 31 - 1, (5, n), generator=gen,
                         device=device)
    y = draw[0] % max(H - 12, 1)
    x = draw[1] % max(W - 12, 1)
    bh = 2 + draw[2] % 10
    bw = 2 + draw[3] % 10
    grey = (10 + draw[4] % 235).double()
    ar = torch.arange(11, device=device)
    rows = y[:, None, None] + ar[None, :, None]
    cols = x[:, None, None] + ar[None, None, :]
    inside = ((ar[None, :, None] < bh[:, None, None])
              & (ar[None, None, :] < bw[:, None, None])
              & (rows < H) & (cols < W))
    shape = inside.shape
    order = torch.arange(n, device=device)[:, None, None].expand(shape)
    flat = (rows * W + cols).expand(shape)[inside]
    last = torch.full((H * W,), -1, dtype=torch.long, device=device)
    last.scatter_reduce_(0, flat, order[inside], "amax")
    painted = last >= 0
    img = img.reshape(-1)
    img[painted] = grey[last[painted]]
    return box_blur(img.reshape(H, W)).float()


class Corridor:
    """The corridor of CorridorScene (floor, ceiling, two side walls, end
    and back walls) for a camera (width, height, fx, fy, cx, cy), its
    canvases on `device`: drawn from `gen`, or given as `canvases` (one
    per plane, in plane_layout's order)."""

    def __init__(self, camera: dict, width: float, height: float,
                 length: float, device, gen: torch.Generator | None = None,
                 ppm: float = 24.0, blobs_per_m2: float = 3.0,
                 canvases=None):
        self.cam = camera
        self.device = torch.device(device)
        self.ppm = ppm
        layout = plane_layout(width, height, length)
        if canvases is None:
            canvases = [texture(sz, ppm, blobs_per_m2, gen, self.device)
                        for *_, sz in layout]
        self.canvases = [torch.as_tensor(c, dtype=torch.float32,
                                         device=self.device)
                         for c in canvases]
        f64 = dict(dtype=torch.float64, device=self.device)
        self.geom = [tuple(torch.as_tensor(a, **f64) for a in g[:4])
                     + g[4:6] for g in layout]
        h, w = camera["height"], camera["width"]
        ys, xs = torch.meshgrid(torch.arange(h, **f64),
                                torch.arange(w, **f64), indexing="ij")
        self.rays = torch.stack([(xs - camera["cx"]) / camera["fx"],
                                 (ys - camera["cy"]) / camera["fy"],
                                 torch.ones_like(xs)], -1).reshape(-1, 3)

    def render(self, T_cw) -> torch.Tensor:
        """(F, H, W) float32 views of the (F, 4, 4) world->camera poses:
        each pixel's ray cast against every plane, the nearest hit past
        0.1 m kept, its canvas sampled bilinearly (0 where nothing is
        hit)."""
        T_cw = torch.as_tensor(T_cw, dtype=torch.float64,
                               device=self.device)
        T_wc = torch.linalg.inv(T_cw)
        R, c = T_wc[:, :3, :3], T_wc[:, :3, 3]
        d_w = torch.einsum("pk,fjk->fpj", self.rays, R)     # (F, P, 3)
        best_t = torch.full(d_w.shape[:2], math.inf, dtype=torch.float64,
                            device=self.device)
        best = torch.full(d_w.shape[:2], -1, dtype=torch.int8,
                          device=self.device)
        best_uv = torch.zeros(d_w.shape[:2] + (2,), dtype=torch.float64,
                              device=self.device)
        for k, (p0, n, u, v, half_u, half_v) in enumerate(self.geom):
            denom = d_w @ n
            denom = torch.where(denom.abs() < 1e-9,
                                torch.full_like(denom, 1e-9), denom)
            t = ((p0[None] - c) @ n)[:, None] / denom
            rel = c[:, None, :] + t[..., None] * d_w - p0
            uu, vv = rel @ u, rel @ v
            hit = ((t > 0.1) & (t < best_t) & (uu.abs() <= half_u)
                   & (vv.abs() <= half_v))
            best_t = torch.where(hit, t, best_t)
            best = torch.where(hit, k, best)
            best_uv = torch.where(hit[..., None], torch.stack([uu, vv], -1),
                                  best_uv)
        # each pixel samples the canvas of the plane it sees, once
        out = torch.zeros(d_w.shape[:2], dtype=torch.float32,
                          device=self.device)
        for k, canvas in enumerate(self.canvases):
            sel = best == k
            uv = best_uv[sel]
            ch, cw = canvas.shape
            out[sel] = bilinear(canvas, uv[:, 0] * self.ppm + cw / 2,
                                uv[:, 1] * self.ppm + ch / 2).float()
        h, w = self.cam["height"], self.cam["width"]
        return out.reshape(-1, h, w)


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """_bilinear_np: the float32 canvas sampled at (x, y), clipped to
    [0, size - 1.001], the blend in float64."""
    h, w = img.shape
    x = x.clamp(0, w - 1.001)
    y = y.clamp(0, h - 1.001)
    x0, y0 = x.long(), y.long()
    fx, fy = x - x0, y - y0
    flat = img.reshape(-1).double()
    i = y0 * w + x0
    v00, v01 = flat[i], flat[i + 1]
    v10, v11 = flat[i + w], flat[i + w + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """utils/corridor.py `_u8`: clipped to [0, 255], truncated to uint8."""
    return img.clamp(0, 255).to(torch.uint8)


def swing_trajectory(n: int, phase: float, step: float, yaw_rate_max: float,
                     period: float, pitch_amp: float, pitch_freq: float,
                     start_z: float) -> np.ndarray:
    """(n, 4, 4) world->camera poses (float64): the camera moves `step` m a
    frame along its view from (0, 0, start_z), its yaw
    A sin(2 pi i / period + phase) with A = yaw_rate_max period / (2 pi), so
    the yaw rate never passes yaw_rate_max and the heading swings about the
    corridor's axis; its pitch pitch_amp sin(i pitch_freq), as
    forward_yaw_trajectory's."""
    amp = yaw_rate_max * period / (2 * math.pi)
    poses = np.zeros((n, 4, 4))
    c = np.array([0.0, 0.0, start_z])
    for i in range(n):
        yaw = amp * math.sin(2 * math.pi * i / period + phase)
        pitch = pitch_amp * math.sin(i * pitch_freq)
        cy, sy = math.cos(yaw), math.sin(yaw)
        cp, sp = math.cos(pitch), math.sin(pitch)
        # scipy's Rotation.from_euler("yx", [yaw, pitch]): Rx(pitch) Ry(yaw)
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        R_wc = rx @ ry
        c = c + R_wc[:, 2] * step
        T_wc = np.eye(4)
        T_wc[:3, :3] = R_wc
        T_wc[:3, 3] = c
        poses[i] = np.linalg.inv(T_wc)
    return poses
