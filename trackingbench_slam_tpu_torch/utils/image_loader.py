"""Prefetching grayscale image loader.

Counterpart of trackingbench_slam_tpu/utils/native_loader.py `ImageLoader`,
with the same signature and results. It replaces the reference's
synchronous per-frame cv::imread on the tracking thread
(test/test_vo.cpp:680): decode runs in a thread pool that stays `prefetch`
frames ahead of the last frame asked for.

PNG and PGM decode through PIL, which releases the interpreter lock while it
decodes; colour images become gray by PIL's ITU-R 601-2 luma, within one
grey level of the reference's native decoder. `.npy` frames load with
np.load and are clipped to uint8, as the reference loads them. The JAX
package decodes with its own C++ library where that builds and with PIL
where it does not; this loader is the one Python decoder, the same on every
machine.
"""

from __future__ import annotations

import concurrent.futures
from typing import Sequence

import numpy as np


def decode_gray(path: str) -> np.ndarray:
    """(H, W) uint8 of one image file; IOError naming the path if it is
    missing or cannot be decoded."""
    try:
        if path.endswith(".npy"):
            return np.clip(np.load(path), 0, 255).astype(np.uint8)
        from PIL import Image
        with Image.open(path) as im:
            return np.array(im.convert("L"))   # writable, as np.load gives
    except (OSError, ValueError) as e:
        raise IOError(f"cannot load image {path}: {e}") from e


class ImageLoader:
    """Prefetching grayscale image loader.

    >>> loader = ImageLoader(paths, prefetch=4)
    >>> img = loader[0]   # (H, W) uint8; the next 4 decode in the background

    Frames may be read in any order; a frame read again, or read outside
    the window, is decoded again. `close()` (or leaving a `with` block)
    stops the pool; a loader dropped without it lets its idle workers exit
    when it is collected.
    """

    def __init__(self, paths: Sequence[str], prefetch: int = 4,
                 threads: int = 2):
        self.paths = [str(p) for p in paths]
        self.prefetch = max(int(prefetch), 0)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(int(threads), 1),
            thread_name_prefix="image-loader")
        self._pending: dict[int, concurrent.futures.Future] = {}

    def __len__(self):
        return len(self.paths)

    def _submit(self, idx: int) -> concurrent.futures.Future:
        fut = self._pending.get(idx)
        if fut is None:
            fut = self._pool.submit(decode_gray, self.paths[idx])
            self._pending[idx] = fut
        return fut

    def __getitem__(self, idx: int) -> np.ndarray:
        idx = range(len(self.paths))[idx]   # IndexError past the end
        fut = self._submit(idx)
        ahead = range(idx + 1, min(idx + 1 + self.prefetch, len(self.paths)))
        for j in ahead:
            self._submit(j)
        # forget what lies outside the new window; a decode still running
        # finishes in the pool and is dropped
        for j in [j for j in self._pending if j != idx and j not in ahead]:
            self._pending.pop(j).cancel()
        del self._pending[idx]
        return fut.result()

    def close(self) -> None:
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
