"""Medians with numpy/JAX semantics.

torch.median and torch.nanmedian return the LOWER of the two middle values
of an even-length sample; jnp.median and jnp.nanmedian (like numpy) return
their mean. The reference's flow prior, disparity prior and descriptor
maintenance depend on the mean, so these two are used throughout the port.
"""

from __future__ import annotations

import torch


def median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Median along `dim`, averaging the two middle values."""
    v = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo = v.narrow(dim, (n - 1) // 2, 1)
    hi = v.narrow(dim, n // 2, 1)
    return ((lo + hi) * 0.5).squeeze(dim)


def nanmedian(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Median of the non-NaN entries along `dim`, averaging the two middle
    values; NaN where a slice has none."""
    v = torch.sort(x, dim=dim).values          # NaNs sort last
    count = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    lo = torch.gather(v, dim, torch.clamp((count - 1) // 2, min=0))
    hi = torch.gather(v, dim, torch.clamp(count // 2, max=x.shape[dim] - 1))
    med = ((lo + hi) * 0.5).squeeze(dim)
    return torch.where(count.squeeze(dim) > 0, med,
                       torch.full_like(med, float("nan")))
