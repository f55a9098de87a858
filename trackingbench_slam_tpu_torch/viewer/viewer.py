"""Host-side visualization of a tracking run.

Copy of trackingbench_slam_tpu/viewer/viewer.py `Viewer` (numpy, a render
thread fed through a queue, matplotlib for the PNG frames, and a stdlib
HTTP server on the loopback address for the live page). It reads poses and
points as numpy arrays, so it runs the same beside a tracker on the card or
on the CPU; it touches no device.

  Viewer.run()            starts the render thread (and the live server)
  Viewer.set_camera_pose  adds a (4, 4) world->camera pose
  Viewer.set_map_points   sets the map's points (with an optional mask)
  Viewer.set_keyframes    sets the keyframe poses (with an optional mask)
  Viewer.stop()           renders the last frame and stops

`live=True` serves an auto-refreshing page of the latest render on `port`;
`follow=True` keeps the top view centred on the current camera.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np


class Viewer:
    def __init__(self, out_dir: str, every: int = 10, live: bool = False,
                 port: int = 8764, follow: bool = False,
                 follow_radius: float = 15.0, host: str = "127.0.0.1"):
        self.out_dir = out_dir
        self.every = every
        self.live = live
        self.port = port
        # loopback by default: the live server exposes out_dir with no auth,
        # so binding all interfaces is an opt-in (host="0.0.0.0")
        self.host = host
        self.follow = follow
        self.follow_radius = follow_radius
        self._q: queue.Queue = queue.Queue(maxsize=8)
        self._thread: Optional[threading.Thread] = None
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._frame_count = 0
        self._traj: list[np.ndarray] = []
        self._points = np.zeros((0, 3))
        self._kfs = np.zeros((0, 4, 4))

    # -- producer side (tracking loop) ------------------------------------
    def set_camera_pose(self, T_cw) -> None:
        self._traj.append(np.asarray(T_cw))
        self._frame_count += 1
        if self._frame_count % self.every == 0:
            self._enqueue()

    def set_map_points(self, points_w, valid=None) -> None:
        pts = np.asarray(points_w)
        if valid is not None:
            pts = pts[np.asarray(valid)]
        self._points = pts

    def set_keyframes(self, T_cw_stack, valid=None) -> None:
        kfs = np.asarray(T_cw_stack)
        if valid is not None:
            kfs = kfs[np.asarray(valid)]
        self._kfs = kfs

    def _enqueue(self):
        snap = (list(self._traj), self._points.copy(), self._kfs.copy(),
                self._frame_count)
        try:
            self._q.put_nowait(snap)
        except queue.Full:
            pass  # drop frames rather than stall tracking (viewer-side QoS)

    # -- render thread ----------------------------------------------------
    def run(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        if self.live:
            self._start_http()

    def _start_http(self):
        """Minimal live view: serve out_dir with an auto-refresh index; the
        render thread keeps latest.png current. Pure stdlib, daemon thread,
        zero coupling to the tracking loop."""
        import http.server

        index = (b"<!doctype html><title>trackingbench-slam viewer</title>"
                 b"<body style='background:#111;text-align:center'>"
                 b"<img id=v style='max-width:100%' src='latest.png'>"
                 b"<script>setInterval(()=>{document.getElementById('v')"
                 b".src='latest.png?t='+Date.now()},1000)</script>")
        with open(os.path.join(self.out_dir, "index.html"), "wb") as f:
            f.write(index)
        class Quiet(http.server.SimpleHTTPRequestHandler):
            def __init__(s, *a, **k):
                super().__init__(*a, directory=self.out_dir, **k)

            def log_message(s, *a):
                pass

        try:
            self._httpd = http.server.ThreadingHTTPServer(
                (self.host, self.port), Quiet)
        except OSError:  # port busy: pick any free port
            self._httpd = http.server.ThreadingHTTPServer((self.host, 0),
                                                          Quiet)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._http_thread.start()

    def _loop(self):
        while not self._stop.is_set() or not self._q.empty():
            try:
                snap = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            self._render(snap)

    def _render(self, snap):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        traj, points, kfs, count = snap
        centers = np.stack([-T[:3, :3].T @ T[:3, 3] for T in traj]) \
            if traj else np.zeros((0, 3))
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
        if points.shape[0]:
            ax1.scatter(points[:, 0], points[:, 2], s=1, c="k", alpha=0.4,
                        label="map points")
        if centers.shape[0]:
            ax1.plot(centers[:, 0], centers[:, 2], "g-", lw=2,
                     label="trajectory")
        for T in kfs:
            c = -T[:3, :3].T @ T[:3, 3]
            ax1.plot(c[0], c[2], "bs", ms=4)
        ax1.set_xlabel("x [m]")
        ax1.set_ylabel("z [m]")
        ax1.legend(loc="upper right", fontsize=8)
        ax1.set_title(f"top view, frame {count}")
        ax1.axis("equal")
        if self.follow and centers.shape[0]:
            # follow-camera (Viewer.cpp menu toggle): fixed window around
            # the current camera instead of whole-trajectory autofit
            cx, cz = centers[-1, 0], centers[-1, 2]
            r = self.follow_radius
            ax1.set_xlim(cx - r, cx + r)
            ax1.set_ylim(cz - r, cz + r)
        if centers.shape[0]:
            ax2.plot(centers[:, 0], "r-", label="x")
            ax2.plot(centers[:, 1], "g-", label="y")
            ax2.plot(centers[:, 2], "b-", label="z")
        ax2.set_xlabel("frame")
        ax2.set_ylabel("position [m]")
        ax2.legend(fontsize=8)
        fig.savefig(os.path.join(self.out_dir, f"frame_{count:06d}.png"),
                    dpi=80)
        if self.live:
            # atomic refresh of the live page's target
            tmp = os.path.join(self.out_dir, ".latest.tmp.png")
            fig.savefig(tmp, dpi=80)
            os.replace(tmp, os.path.join(self.out_dir, "latest.png"))
        plt.close(fig)

    def stop(self, final: bool = True) -> None:
        if final:
            self._enqueue()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
