"""Helpers for the kernels' batching rules (torch.func.vmap).

Each kernel wrapper is a `torch.library.custom_op` with a batching rule: on
CUDA the rule launches the kernel once for all B sequences, on the CPU it
loops over the plain version. These helpers move the batch axis to the
front and run that loop.
"""

from __future__ import annotations

import torch


def first(t, dim, size: int):
    """`t` with its batch axis `dim` first; an unbatched tensor (dim None)
    is expanded to `size` without a copy; None stays None."""
    if t is None:
        return None
    if dim is None:
        return t.expand((size,) + tuple(t.shape))
    return t.movedim(dim, 0)


def first_all(ts, dims, size: int) -> list:
    return [first(t, d, size) for t, d in zip(ts, dims)]


def rows_contiguous(t: torch.Tensor) -> torch.Tensor:
    """A (B, H, W) image batch whose (H, W) planes are contiguous; the batch
    stride may be anything, 0 included (one image shared by the batch)."""
    if t.stride(-1) == 1 and t.stride(-2) == t.shape[-1]:
        return t
    return t.contiguous()


def _pick(x, b: int):
    if isinstance(x, torch.Tensor):
        return x[b]
    if isinstance(x, (list, tuple)):
        return type(x)(_pick(v, b) for v in x)
    return x


def loop(fn, size: int, *args, **kw) -> tuple:
    """fn on each sequence b (every tensor argument, also inside lists,
    indexed at b), the outputs stacked along a new first axis."""
    outs = [fn(*_pick(args, b), **{k: _pick(v, b) for k, v in kw.items()})
            for b in range(size)]
    if isinstance(outs[0], torch.Tensor):
        return (torch.stack(outs),)
    return tuple(torch.stack(o) for o in zip(*outs))
