"""Oriented BRIEF over 32x32 keypoint patches: the plain math of the fused
ORB-describe kernel.

Port of the ORB math of trackingbench_slam_tpu (ops/orb.py and the consumers
in ops/pallas/patch_kernel.py:162-217). On the card, IC angle, bin and the
256 tests run inside one kernel, `orb_describe` (ops/cuda/patch_kernel.py,
csrc/patch.cu), which reads `brief_positions` as its test table; these
functions over (N, 32, 32) patches are its plain version
(`orb_describe_plain`). Descriptors are (N, 8) int32 words carrying the
same bits as the reference's uint32 words: torch's uint32 lacks shifts and
reductions on CUDA.

rBRIEF quantizes the keypoint angle into 32 bins with round-half-to-even;
each bin's rotated sample positions are rounded with Python's round (also
half to even) and clamped into the patch. The reference selects them with a
0/1 matrix product; each column selects one pixel, so gathering the same
positions is identical.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from trackingbench_slam_tpu_torch.ops.orb_pattern_learned import LEARNED_PAIRS

PATCH_HALF = 15
PATCH = 32
ANGLE_BINS = 32


def brief_pattern() -> np.ndarray:
    """(256, 2, 2) int32: two (x, y) offsets per bit (the learned table)."""
    return np.asarray(LEARNED_PAIRS, np.int32)


@functools.lru_cache(maxsize=1)
def pattern_id() -> str:
    """Content hash of the BRIEF pattern table; equal to the JAX package's
    ops/orb.py pattern_id() for the same table."""
    return hashlib.sha256(brief_pattern().tobytes()).hexdigest()[:16]


def _circle_umax_mask() -> np.ndarray:
    ys, xs = np.mgrid[-PATCH_HALF:PATCH_HALF + 1, -PATCH_HALF:PATCH_HALF + 1]
    return (xs * xs + ys * ys <= PATCH_HALF * PATCH_HALF).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _moment_masks(device):
    """(32, 32) x and y moment weights over the radius-15 circle centred
    at (15, 15)."""
    m = np.zeros((PATCH, PATCH), np.float32)
    m[:31, :31] = _circle_umax_mask()
    ys, xs = np.mgrid[0:PATCH, 0:PATCH].astype(np.float32)
    return (torch.from_numpy((xs - 15.0) * m).to(device),
            torch.from_numpy((ys - 15.0) * m).to(device))


def ic_angle_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """(N, 32, 32) patches -> (N,) intensity-centroid angle over the
    radius-15 circle centred at (15, 15)."""
    xm, ym = _moment_masks(patches.device)
    m10 = (patches * xm).sum((1, 2))
    m01 = (patches * ym).sum((1, 2))
    return torch.atan2(m01, m10)


@functools.lru_cache(maxsize=4)
def brief_positions(device, bins: int = ANGLE_BINS) -> torch.Tensor:
    """(bins, 512) int64 flat patch index of sample (2k + which) of pair k at
    angle bin b (the reference's _brief_selection_matrix, as indices)."""
    pat = brief_pattern().astype(np.float64)
    pos = np.zeros((bins, 512), np.int64)
    for b in range(bins):
        ang = 2 * np.pi * b / bins
        ca, sa = np.cos(ang), np.sin(ang)
        for k in range(256):
            for which in range(2):
                x, y = pat[k, which]
                rx = int(round(x * ca - y * sa)) + 15
                ry = int(round(x * sa + y * ca)) + 15
                rx = min(max(rx, 0), PATCH - 1)
                ry = min(max(ry, 0), PATCH - 1)
                pos[b, 2 * k + which] = ry * PATCH + rx
    return torch.from_numpy(pos).to(device)


def angle_bins(angles: torch.Tensor) -> torch.Tensor:
    """round(mod(a, 2 pi) / 2 pi * 32) % 32, with jnp.mod's exact remainder
    and round half to even."""
    two_pi = torch.full((), 2.0 * np.pi, dtype=angles.dtype,
                        device=angles.device)
    r = torch.fmod(angles, two_pi)
    r = torch.where((r != 0) & (r < 0), r + two_pi, r)
    return torch.round(r / two_pi * ANGLE_BINS).long() % ANGLE_BINS


def brief_from_patches(patches: torch.Tensor, angles: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """(N, 32, 32) blurred patches + (N,) angles -> (N, 8) int32."""
    n = patches.shape[0]
    pos = brief_positions(patches.device)
    idx = pos[angle_bins(angles)]                          # (N, 512)
    samples = torch.gather(patches.reshape(n, PATCH * PATCH), 1, idx)
    bits = samples[:, 0::2] < samples[:, 1::2]
    bits = bits & valid[:, None]
    return pack_bits(bits)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) {0,1} -> (N, 8) int32 (bit j of word i = bit 32 i + j)."""
    words = bits.to(torch.int64).reshape(bits.shape[0], 8, 32)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    packed = (words << shifts).sum(-1)
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    return packed.to(torch.int32)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 -> (N, 256) bool."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 256).bool()


def unpack_to_pm1(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 -> (N, 256) float32 in {-1, +1}; for 256-bit strings
    hamming(a, b) = (256 - A.B) / 2."""
    return unpack_bits(desc).float() * 2.0 - 1.0
