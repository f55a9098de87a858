"""Frame upload ahead of tracking.

Port of trackingbench_slam_tpu/utils/prefetch.py `DevicePrefetcher`. The
reference hides its upload latency behind a pool of worker threads calling
jax.device_put. On the card the same overlap comes from the copy engine:
frame j is staged into a pinned host buffer and copied on a separate CUDA
stream while the tracker's kernels for earlier frames run, so
`StereoVO.track(*pf[i])` receives tensors that are already on the device
(its upload is then a no-op).

    with DevicePrefetcher(frames, depth=2) as pf:   # [(left, right|None)]
        for i in range(len(pf)):
            vo.track(*pf[i])

Lifetimes on the card:
  * the pinned buffers form a ring of depth + 1 slots (left and right
    each); a slot is refilled only after the event of its last copy has
    completed;
  * each frame's device tensors are allocated on the copy stream; when a
    frame is handed out, the consumer's stream waits on that frame's event
    and the tensors are marked with record_stream, so the caching allocator
    does not give their memory to another tensor before the consumer's work
    on them is done.
On the CPU the frames come back as CPU tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from trackingbench_slam_tpu_torch.utils.device import resolve_device


def _host_tensor(img) -> torch.Tensor:
    """The frame as a CPU tensor: uint8 and float32 kept, anything else
    float32 (the types upload_image keeps)."""
    t = torch.as_tensor(np.ascontiguousarray(img))
    if t.dtype not in (torch.uint8, torch.float32):
        t = t.float()
    return t


class DevicePrefetcher:
    """Uploads (left, right | None) frame pairs `depth` frames ahead of the
    one asked for. Random access reschedules: asking for a frame that was
    not prefetched uploads it then."""

    def __init__(self, frames: Sequence, depth: int = 2, device=None):
        self._frames = frames
        self._depth = max(1, depth)
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._pending: dict[int, tuple] = {}
        self._slots = self._depth + 1
        # per ring slot: pinned buffers (left, right) and its last event
        self._pinned: list[list] = [[None, None] for _ in range(self._slots)]
        self._slot_event: list = [None] * self._slots
        self._stream = (torch.cuda.Stream(device=self.device) if self._cuda
                        else None)

    def _stage(self, slot: int, k: int, img) -> torch.Tensor:
        src = _host_tensor(img)
        buf = self._pinned[slot][k]
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self._pinned[slot][k] = buf
        buf.copy_(src)
        with torch.cuda.stream(self._stream):
            dev = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            dev.copy_(buf, non_blocking=True)
        return dev

    def _schedule(self, j: int) -> None:
        if j >= len(self._frames) or j in self._pending:
            return
        left, right = self._frames[j]
        if not self._cuda:
            self._pending[j] = (_host_tensor(left), None if right is None
                                else _host_tensor(right), None)
            return
        slot = j % self._slots
        if self._slot_event[slot] is not None:
            # the slot's pinned buffers may still feed an earlier copy
            self._slot_event[slot].synchronize()
        out_l = self._stage(slot, 0, left)
        out_r = None if right is None else self._stage(slot, 1, right)
        event = torch.cuda.Event()
        event.record(self._stream)
        self._slot_event[slot] = event
        self._pending[j] = (out_l, out_r, event)

    def __getitem__(self, i: int):
        for j in range(i, i + self._depth + 1):
            self._schedule(j)
        left, right, event = self._pending.pop(i)
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in (left, right):
                if t is not None:
                    t.record_stream(consumer)
        return left, right

    def __len__(self) -> int:
        return len(self._frames)

    def close(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()
        self._pending.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
