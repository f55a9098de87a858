"""`correct` on the CPU: the references equal the port's plain versions,
and a run with the timed path broken underneath, or with the control in
the kernels' place, comes out not correct."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from slam_bench import control
from slam_bench.reference import kernels as ref
from slam_bench.tests import tiny


def _images(B=3, H=120, W=200, seed=0):
    g = torch.Generator().manual_seed(seed)
    imgs = (torch.rand(B, H, W, generator=g) * 255).round()
    return F.avg_pool2d(imgs[:, None], 3, 1, 1)[:, 0]


def test_reference_kernels_equal_the_port_plain_versions():
    """reference/kernels.py on a batch equals the port's plain versions run
    sequence by sequence, bit for bit, on the CPU."""
    from trackingbench_slam_tpu_torch.ops.cuda import (fast_kernel,
                                                       lk_kernel,
                                                       patch_kernel)
    B, H, W, N = 3, 120, 200, 50
    g = torch.Generator().manual_seed(1)
    imgs = _images(B, H, W)
    for b in range(B):
        assert torch.equal(ref.fast_score_nms(imgs, 12.0, 9)[b],
                           fast_kernel.fast_score_nms_plain(imgs[b], 12.0, 9))
    cur = torch.roll(imgs, (1, 2), (1, 2))
    prev_pyr = [imgs, F.avg_pool2d(imgs[:, None], 2)[:, 0]]
    cur_pyr = [cur, F.avg_pool2d(cur[:, None], 2)[:, 0]]
    pts = torch.rand(B, N, 2, generator=g) * torch.tensor([W - 40, H - 40]) + 20
    valid = torch.rand(B, N, generator=g) > 0.1
    start = pts + torch.randn(B, N, 2, generator=g)
    for fb in (0, 10):
        out, _ = ref.lk_align(prev_pyr, cur_pyr, pts, start, valid,
                              fb_iters=fb)
        for b in range(B):
            want = lk_kernel.lk_align_plain(
                [p[b] for p in prev_pyr], [c[b] for c in cur_pyr], pts[b],
                start[b], valid[b], fb_iters=fb)
            assert all(torch.equal(x[b], y) for x, y in zip(out, want))
    blur = F.avg_pool2d(imgs[:, None], 3, 1, 1)[:, 0]
    lv1, bl1 = imgs[:, ::2, ::2].contiguous(), blur[:, ::2, ::2].contiguous()
    xy = torch.cat([torch.rand(B, 30, 2, generator=g) * torch.tensor([W, H]),
                    torch.rand(B, 20, 2, generator=g)
                    * torch.tensor([W // 2, H // 2])], 1)
    v = torch.rand(B, N, generator=g) > 0.2
    a, d = ref.orb_describe([imgs, lv1], [blur, bl1], xy, v, [30, 20])
    for b in range(B):
        a2, d2 = patch_kernel.orb_describe_plain(
            [imgs[b], lv1[b]], [blur[b], bl1[b]], xy[b], v[b], [30, 20])
        assert torch.equal(a[b], a2) and torch.equal(d[b], d2)
    slots = torch.randint(-2, 70, (B, N), generator=g).int()
    want_ = torch.rand(B, N, generator=g) > 0.3
    cells = ref.anchor_cells(imgs, xy)
    win = ref.last_writer(slots, want_ & (slots >= 0) & (slots < 64), 64)
    for b in range(B):
        out = patch_kernel.anchor_cells_plain(imgs[b], xy[b], slots[b],
                                              want_[b], torch.zeros(128, 128),
                                              64)
        grid = out.reshape(8, 16, 8, 16).permute(0, 2, 1, 3).reshape(64, 16,
                                                                    16)
        has = win[b] >= 0
        assert torch.equal(grid[has], cells[b][win[b][has]])
        assert torch.equal(ref.atlas_cells(out[None])[0], grid)
        assert torch.equal(ref.cells_atlas(grid[None])[0], out)


def test_reference_operands_equal_the_port_image_ops():
    """The pyramids and blurred levels that the check rebuilds from host
    frames equal the port's own, bit for bit, on the CPU."""
    from trackingbench_slam_tpu_torch.ops import image
    imgs = _images(2, 370, 613)
    for n, scale in ((3, 0.8), (5, 0.8), (4, 0.5)):
        mine = ref.build_pyramid(imgs, n, scale)
        for b in range(2):
            theirs = image.build_pyramid(imgs[b], n, scale)
            assert all(torch.equal(x[b], y) for x, y in zip(mine, theirs))
            assert all(torch.equal(ref.gaussian_blur(x)[b],
                                   image.gaussian_blur(y))
                       for x, y in zip(mine, theirs))


@contextlib.contextmanager
def _broken_steps(kind: str):
    """The port's batched steps broken underneath: `unchanged` returns the
    state as it came; `half` steps only the first half of the batch;
    `pose` moves execution 0's pose by 0.1 m on the window's second frame."""
    from trackingbench_slam_tpu_torch.parallel import dp_eval
    real = dict(track=dp_eval.dp_track_step,
                keyframe=dp_eval.dp_track_and_keyframe_step)

    def wrap(fn):
        def step(states, *args):
            new = fn(states, *args)
            if kind == "unchanged":
                return states
            if kind == "half":
                keep = torch.arange(states.T_cw.shape[0]) >= (
                    states.T_cw.shape[0] // 2)

                def pick(old, upd):
                    m = keep.reshape((-1,) + (1,) * (old.dim() - 1))
                    return torch.where(m, old, upd)
                return pytree.tree_map(pick, states, new)
            if int(new.frame_id[0]) == 6:
                T = new.T_cw.clone()
                T[0, 0, 3] += 0.1
                return new._replace(T_cw=T)
            return new
        return step
    dp_eval.dp_track_step = wrap(real["track"])
    dp_eval.dp_track_and_keyframe_step = wrap(real["keyframe"])
    try:
        yield
    finally:
        dp_eval.dp_track_step = real["track"]
        dp_eval.dp_track_and_keyframe_step = real["keyframe"]


@contextlib.contextmanager
def _lk_output_moved():
    """LK's output altered where it is produced: one point 0.25 px off."""
    from trackingbench_slam_tpu_torch.ops.cuda import lk_kernel
    real = lk_kernel.lk_align_plain

    def moved(*args, **kw):
        out = real(*args, **kw)
        xy = out[0].clone()
        xy[0] += 0.25
        return (xy,) + tuple(out[1:])
    lk_kernel.lk_align_plain = moved
    try:
        yield
    finally:
        lk_kernel.lk_align_plain = real


@contextlib.contextmanager
def _pyramid_off():
    """The frames' pyramids altered where they are built: every level
    past the first one grey level brighter."""
    from trackingbench_slam_tpu_torch.models import frame
    real = frame.build_pyramid

    def brighter(img, n, scale):
        levels = real(img, n, scale)
        return [levels[0]] + [x + 1.0 for x in levels[1:]]
    frame.build_pyramid = brighter
    try:
        yield
    finally:
        frame.build_pyramid = real


def _failed(run):
    return sorted(k for k, c in run.checks.items() if not c["ok"])


def test_broken_steps_are_not_correct():
    """A step that returns its state unchanged, half the batch left out,
    and a pose altered where it is produced each fail `correct` (a cell on
    one card has no exchange between chips to leave out)."""
    for kind in ("unchanged", "half", "pose"):
        with _broken_steps(kind):
            run = tiny.run_tiny()
        assert "step_err_max_mm" in _failed(run), (kind, run.checks)


def test_a_kernel_output_altered_is_not_correct():
    with _lk_output_moved():
        run = tiny.run_tiny()
    assert "lk_xy_gap_px" in _failed(run), run.checks


def test_a_pyramid_altered_where_it_is_built_is_not_correct():
    """The check rebuilds the kernels' image operands from the host
    frames, so a fault in the program's own pyramid shows."""
    with _pyramid_off():
        run = tiny.run_tiny()
    assert abs(run.operand_gaps["fast"] - 1.0) < 1e-3
    assert set(_failed(run)) & {"fast_score_gap", "orb_angle_gap_rad",
                                "orb_bits_differing", "lk_xy_gap_px",
                                "lk_flags_differing"}, run.checks


def test_the_control_in_bfloat16_is_not_correct():
    """The reference in bfloat16 in the kernels' place fails the check."""
    with control.installed():
        run = tiny.run_tiny()
    failed = _failed(run)
    assert failed and set(failed) & {"lk_xy_gap_px", "fast_score_gap",
                                     "orb_angle_gap_rad", "anchor_cell_gap"}
