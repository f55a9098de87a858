"""The device an entry point runs on, and reading device results late."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names another device. Raises when CUDA is
    asked for and missing; there is no fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this package runs on CUDA by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


def upload_image(img, device: torch.device) -> torch.Tensor:
    """A frame on `device`, uint8 and float32 kept as they are (make_frame
    converts on the device), anything else as float32."""
    t = torch.as_tensor(img)
    if t.dtype not in (torch.uint8, torch.float32):
        t = t.float()
    return t.to(device)


class HostCopy:
    """A device tensor's copy into pinned host memory, started without
    blocking; `numpy()` waits for that copy alone (a CUDA event), so a
    result read a frame or two later costs no device sync. On the CPU it
    holds the tensor itself."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
