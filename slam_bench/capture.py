"""Records the hand kernels' calls of a batched step from outside the port.

The port's kernel wrappers are custom ops whose batching rules look up the
batched launchers (`*_cuda_batched`, `anchor_cells_into_batched`) in their
module when they run, and on the CPU the plain versions. While
`Capture(...)` is active those names are wrapped: each call runs as
before and its inputs and outputs are kept (references, no copies: the
steps are functional, and the anchor-cell launcher writes into a fresh
copy of the atlas). On the CPU each sequence's call is kept as a batch of
one.
"""

from __future__ import annotations

import contextlib

# kernel: (module, batched launcher, plain version)
KERNELS = {
    "lk": ("trackingbench_slam_tpu_torch.ops.cuda.lk_kernel",
           "lk_align_cuda_batched", "lk_align_plain"),
    "fast": ("trackingbench_slam_tpu_torch.ops.cuda.fast_kernel",
             "fast_score_nms_cuda_batched", "fast_score_nms_plain_levels"),
    "orb": ("trackingbench_slam_tpu_torch.ops.cuda.patch_kernel",
            "orb_describe_cuda_batched", "orb_describe_plain"),
    "anchor": ("trackingbench_slam_tpu_torch.ops.cuda.patch_kernel",
               "anchor_cells_into_batched", "anchor_cells_plain"),
}


def _b(x):
    """A per-sequence argument as a batch of one."""
    if isinstance(x, (list, tuple)):
        return [_b(v) for v in x]
    return None if x is None else x[None]


def _record(kind, batched, args, kw, out):
    """One call in batched form: dict(kind, inputs, kw, out)."""
    if kind == "lk":
        prev, cur, pts, start, valid = args
        kw = dict(kw)
        if not batched:
            prev, cur, pts, start, valid = map(_b, (prev, cur, pts, start,
                                                    valid))
            kw["offset"] = _b(kw.get("offset"))
            out = _b(out)
        return dict(kind=kind, inputs=(prev, cur, pts, start, valid), kw=kw,
                    out=list(out))
    if kind == "fast":
        imgs, threshold, arc = (list(args) + [kw.get("threshold"),
                                              kw.get("arc")])[:3]
        if not batched:
            imgs, out = _b(imgs), _b(out)
        return dict(kind=kind, inputs=(imgs,),
                    kw=dict(threshold=threshold, arc=arc), out=list(out))
    if kind == "orb":
        raw, blurred, xy, valid, counts = args
        if not batched:
            raw, blurred, xy, valid, out = map(_b, (raw, blurred, xy, valid,
                                                   out))
        return dict(kind=kind, inputs=(raw, blurred, xy, valid),
                    kw=dict(counts=list(counts)), out=list(out))
    if batched:   # anchor_cells_into_batched(out, img, kp, slots, want, cap)
        atlas, img, kp, slots, want, cap = args
        out = atlas
    else:         # anchor_cells_plain(img, kp, slots, want, atlas, cap)
        img, kp, slots, want, _, cap = args
        img, kp, slots, want, out = map(_b, (img, kp, slots, want, out))
    return dict(kind="anchor", inputs=(img, kp, slots, want),
                kw=dict(capacity=int(cap)), out=[out])


class Capture:
    """`with Capture() as cap:` keeps every hand-kernel call in `cap.calls`
    while `cap.on` is true, each tagged with `cap.frame`, the frame of the
    step that made it."""

    def __init__(self):
        self.calls = []
        self.on = False
        self.frame = None
        self._stack = None

    def __enter__(self):
        import importlib
        self._stack = contextlib.ExitStack()
        for kind, (modname, batched_name, plain_name) in KERNELS.items():
            mod = importlib.import_module(modname)
            for name, batched in ((batched_name, True),
                                  (plain_name, False)):
                real = getattr(mod, name)
                setattr(mod, name, self._wrap(kind, batched, real))
                self._stack.callback(setattr, mod, name, real)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def _wrap(self, kind, batched, real):
        def wrapped(*args, **kw):
            out = real(*args, **kw)
            if self.on:
                self.calls.append(dict(_record(kind, batched, args, kw, out),
                                       frame=self.frame))
            return out
        wrapped.__wrapped__ = real
        return wrapped
