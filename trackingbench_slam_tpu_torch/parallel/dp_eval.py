"""Batched multi-sequence tracking: B sequences step as one program.

Port of trackingbench_slam_tpu/parallel/dp_eval.py, the workload the repo
is named after: re-running many sequences. The reference vmaps the step
and shards the batch over its 'dp' mesh axis. Here the B sequences live on
one card and `torch.func.vmap` turns the eager step into one batched
program: every op runs once on (B, ...) tensors, and each hand kernel's
batching rule (ops/cuda/*_kernel.py) launches it once for all B sequences.
So a step makes about the launches of one sequence, and the host cost,
which bounds the port (PERF.md section 5), is paid once for B.

Two parts of the serial step cannot run under vmap and have batched forms:
  * RANSAC draws: a generator cannot be used inside vmap (randomness is
    "error"). `draw_uniform` draws each sequence's (256, N) uniforms outside,
    from its own torch.Generator, exactly what a serial StereoVO run of that
    sequence draws, so batched and serial runs see the same hypotheses.
  * The keyframe's stereo-prior branch, a host branch in the serial step:
    batched, both stereo LK calls run and torch.where keeps each sequence's
    own branch, as the reference's vmap turns its lax.cond into a select.

Usage:
    states = stack_states([s0, ..., s7])            # batched VOState
    u = draw_uniform(generators, cfg)               # (B, 256, N)
    states = dp_track_step(states, imgs, cam, cfg, u)   # imgs (B, H, W)
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from trackingbench_slam_tpu_torch.models import vo as vo_mod
from trackingbench_slam_tpu_torch.ops import ransac

RANSAC_SAMPLES = 256   # hypotheses a track step draws (search_by_opflow)


def stack_states(states: list) -> vo_mod.VOState:
    """Stack B per-sequence VOStates into one batched state (axis 0 = B)."""
    leaves = [pytree.tree_flatten(s) for s in states]
    spec = leaves[0][1]
    return pytree.tree_unflatten(
        [torch.stack(xs) for xs in zip(*(lv for lv, _ in leaves))], spec)


def unstack_states(batched: vo_mod.VOState, b: int) -> list:
    return [pytree.tree_map(lambda x: x[i], batched) for i in range(b)]


def shard_batch(tree, device=None):
    """The batched tree on `device` (CUDA unless told otherwise). One card
    holds the whole batch, so there is nothing to shard: the reference's
    name is kept for the step that places the batch."""
    from trackingbench_slam_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    return pytree.tree_map(lambda x: x.to(dev), tree)


def draw_uniform(generators, cfg, device=None) -> torch.Tensor:
    """(B, 256, N) RANSAC draws of one track step, sequence b's from
    generators[b], as a serial run of that sequence would draw them."""
    n = cfg.extractor.num_features
    dev = generators[0].device if device is None else device
    return torch.stack([ransac.draw_uniform(RANSAC_SAMPLES, n, g, dev)
                        for g in generators])


def dp_track_step(states: vo_mod.VOState, imgs: torch.Tensor, cam, cfg,
                  uniform: torch.Tensor) -> vo_mod.VOState:
    """One tracking step for all B sequences as one batched program: imgs
    (B, H, W), uniform (B, 256, N) (`draw_uniform`)."""
    def step(state, img, u):
        return vo_mod.track_step(state, img, cam, cfg, uniform=u)
    with torch.profiler.record_function("dp.track_step"):
        return torch.func.vmap(step, randomness="error")(states, imgs,
                                                          uniform)


def dp_track_and_keyframe_step(states: vo_mod.VOState, imgs_l: torch.Tensor,
                               imgs_r: torch.Tensor, cam, cfg,
                               uniform: torch.Tensor) -> vo_mod.VOState:
    """Keyframe-cadence frames for all B sequences (track + stereo map),
    both sides of the stereo-prior branch run and selected per sequence."""
    def step(state, left, right, u):
        state = vo_mod.track_step(state, left, cam, cfg, uniform=u)
        return vo_mod.keyframe_step(state, right, cam, cfg,
                                    both_branches=True)
    with torch.profiler.record_function("dp.track_and_keyframe_step"):
        return torch.func.vmap(step, randomness="error")(states, imgs_l,
                                                          imgs_r, uniform)
