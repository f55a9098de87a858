"""One round of the motion-only LM pose solve: CUDA kernel csrc/pose.cu and
its plain PyTorch version.

Replaces no Pallas kernel: the JAX package leaves the solve to XLA. On the
card the eager round was ~3,363 small launches, which held the host for
most of a batched track step; the kernel runs a round in one launch
(csrc/pose.cu says how). A round (solvers/pose_opt.py runs 4) is
`lm_pose_iterations` from the round's pose with the round's weight mask,
then the round's inlier gate at the normalized pose: valid, chi2 <= the
threshold and in front of the camera. `pose_round` returns (T (4, 4),
inliers (N,), chi2 (N,)).

`pose_round` goes through the custom op `trackingbench::pose_round`: for a
CUDA tensor it launches the kernel (`pose_round_cuda`) or raises, for a CPU
tensor it runs `pose_round_plain`; there is no other fallback. Its batching
rule (torch.func.vmap, parallel/dp_eval.py) launches the kernel once for
the whole batch on CUDA and loops over the plain version on the CPU.

The camera goes in as one (9,) tensor, `camera_vector`: fx, fy, cx, cy and
the five distortion coefficients.
"""

from __future__ import annotations

import ctypes

import torch

from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.ops.cuda import batch, build
from trackingbench_slam_tpu_torch.solvers import reprojection as rp
from trackingbench_slam_tpu_torch.utils import profiling


def camera_vector(cam: cam_mod.CameraParams) -> torch.Tensor:
    """(9,) float32: fx, fy, cx, cy, k1, k2, p1, p2, k3."""
    return torch.cat([torch.stack([cam.fx, cam.fy, cam.cx, cam.cy]),
                      cam.dist])


def _camera(camv: torch.Tensor) -> cam_mod.CameraParams:
    """The projection's parameters of `camera_vector` as CameraParams."""
    return cam_mod.CameraParams(fx=camv[0], fy=camv[1], cx=camv[2],
                                cy=camv[3], dist=camv[4:9], size=None,
                                bf=None)


# ---------------------------------------------------------------------------
# plain PyTorch version


def lm_pose_iterations(cam, T0, pts_w, obs_px, inv_sigma2, mask,
                       iters: int, huber_delta, init_lambda: float = 1e-4):
    maskf = mask.float()

    def build(T):
        return rp.normal_equations(cam, T, pts_w, obs_px, inv_sigma2, maskf,
                                   huber_delta)

    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    H, b, cost = build(T0)
    T = T0
    lam = torch.full((), init_lambda, dtype=T0.dtype, device=T0.device)
    for _ in range(iters):
        dx = rp.chol6_solve(H + lam * eye6, b)
        T_new = se3.compose(se3.exp(dx), T)
        H_t, b_t, cost_new = build(T_new)
        accept = cost_new < cost
        T = torch.where(accept, T_new, T)
        H = torch.where(accept, H_t, H)
        b = torch.where(accept, b_t, b)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
        cost = torch.where(accept, cost_new, cost)
    return se3.normalize(T), cost


def pose_round_plain(camv, T, pts_w, obs_px, inv_sigma2, mask, valid,
                     huber_delta, iters, init_lambda, chi2_threshold):
    """The kernel's semantics in PyTorch ops on any device: the LM loop,
    then the round's gate."""
    cam = _camera(camv)
    T, _ = lm_pose_iterations(cam, T, pts_w, obs_px, inv_sigma2, mask,
                              iters=iters, huber_delta=huber_delta,
                              init_lambda=init_lambda)
    r, pc = rp.residuals(cam, T, pts_w, obs_px)
    chi2 = rp.chi2(r, inv_sigma2)
    inliers = valid & (chi2 <= chi2_threshold) & (pc[..., 2] > 0.05)
    return T, inliers, chi2


# ---------------------------------------------------------------------------
# the op and its batching rule


def _check(camv, T, pts_w, obs_px, inv_sigma2, mask, valid):
    """The kernel's inputs, with any leading batch shape (that of T): the
    camera (..., 9) with its last axis dense, the rest contiguous."""
    lead = tuple(T.shape[:-2])
    n = pts_w.shape[-2] if pts_w.dim() >= 2 else -1
    shapes = ((camv, (9,)), (T, (4, 4)), (pts_w, (n, 3)), (obs_px, (n, 2)),
              (inv_sigma2, (n,)), (mask, (n,)), (valid, (n,)))
    for t, s in shapes:
        if tuple(t.shape) != lead + s:
            raise ValueError(f"pose_round: expected shape {lead + s}, got "
                             f"{tuple(t.shape)}")
    for t in (camv, T, pts_w, obs_px, inv_sigma2):
        if t.dtype != torch.float32:
            raise TypeError(f"pose_round: expected float32, got {t.dtype}")
    for t in (mask, valid):
        if t.dtype != torch.bool:
            raise TypeError(f"pose_round: masks must be bool, got {t.dtype}")
    devs = {t.device for t, _ in shapes}
    if len(devs) != 1:
        raise ValueError(f"pose_round: inputs on several devices: {devs}")
    if camv.stride(-1) != 1 or not all(t.is_contiguous()
                                       for t, _ in shapes[1:]):
        raise ValueError("pose_round: inputs must be contiguous")


def pose_round(camv, T, pts_w, obs_px, inv_sigma2, mask, valid,
               huber_delta: float | None, iters: int, init_lambda: float,
               chi2_threshold: float):
    """One LM round from pose T over N points (`camera_vector` camv, world
    points (N, 3), observed pixels (N, 2), inverse variances (N,), the
    round's weight mask and the solve's edges (N,) bool), Huber with
    `huber_delta` unless None: (T (4, 4), inliers (N,), chi2 (N,))."""
    _check(camv, T, pts_w, obs_px, inv_sigma2, mask, valid)
    if T.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"pose_round: no kernel for {T.device}")
    return _pose_round_op(camv, T, pts_w, obs_px, inv_sigma2, mask, valid,
                          None if huber_delta is None else float(huber_delta),
                          int(iters), float(init_lambda),
                          float(chi2_threshold))


@torch.library.custom_op("trackingbench::pose_round", mutates_args=())
def _pose_round_op(camv: torch.Tensor, T: torch.Tensor, pts_w: torch.Tensor,
                   obs_px: torch.Tensor, inv_sigma2: torch.Tensor,
                   mask: torch.Tensor, valid: torch.Tensor,
                   huber_delta: float | None, iters: int, init_lambda: float,
                   chi2_threshold: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    fn = pose_round_cuda if T.is_cuda else pose_round_plain
    return tuple(fn(camv, T, pts_w, obs_px, inv_sigma2, mask, valid,
                    huber_delta, iters, init_lambda, chi2_threshold))


@_pose_round_op.register_vmap
def _pose_round_vmap(info, in_dims, camv, T, pts_w, obs_px, inv_sigma2, mask,
                     valid, huber_delta, iters, init_lambda, chi2_threshold):
    """B sequences: one launch on CUDA, the plain version per sequence on
    the CPU."""
    B = info.batch_size
    tensors = batch.first_all((camv, T, pts_w, obs_px, inv_sigma2, mask,
                               valid), in_dims[:7], B)
    scalars = (huber_delta, iters, init_lambda, chi2_threshold)
    if T.is_cuda:
        # an unbatched camera stays one row, read at batch stride 0
        cam = tensors[0] if in_dims[0] is None else tensors[0].contiguous()
        out = pose_round_cuda_batched(
            cam, *(t.contiguous() for t in tensors[1:]), *scalars)
    else:
        out = batch.loop(pose_round_plain, B, *tensors, *scalars)
    return tuple(out), (0, 0, 0)


_pose_fn = None


def _kernel():
    global _pose_fn
    if _pose_fn is None:
        lib = build.load("pose")
        fn = lib.pose_round
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 3 + [ctypes.c_int]
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.pose_scratch_floats.restype = ctypes.c_longlong
        lib.pose_scratch_floats.argtypes = [ctypes.c_int]
        _pose_fn = (fn, lib.pose_scratch_floats)
    return _pose_fn


def pose_round_cuda(camv, T, pts_w, obs_px, inv_sigma2, mask, valid,
                    huber_delta, iters, init_lambda, chi2_threshold):
    """`pose_round` in one launch of csrc/pose.cu: the batch of one
    sequence."""
    out = pose_round_cuda_batched(
        camv[None], T[None], pts_w[None], obs_px[None], inv_sigma2[None],
        mask[None], valid[None], huber_delta, iters, init_lambda,
        chi2_threshold)
    return tuple(o[0] for o in out)


def pose_round_cuda_batched(camv, T, pts_w, obs_px, inv_sigma2, mask, valid,
                            huber_delta, iters, init_lambda, chi2_threshold):
    """B sequences in one launch of csrc/pose.cu: camv (B, 9) (a batch
    stride of 0 shares one camera), T (B, 4, 4), pts_w (B, N, 3), obs_px
    (B, N, 2), inv_sigma2, mask and valid (B, N). Returns the outputs with
    a leading B axis."""
    _check(camv, T, pts_w, obs_px, inv_sigma2, mask, valid)
    if not T.is_cuda:
        raise RuntimeError("pose_round_cuda_batched needs CUDA tensors")
    fn, scratch_floats = _kernel()
    B, n = pts_w.shape[:2]
    dev = T.device
    T_out = torch.empty((B, 4, 4), dtype=torch.float32, device=dev)
    inliers = torch.empty((B, n), dtype=torch.bool, device=dev)
    chi2 = torch.empty((B, n), dtype=torch.float32, device=dev)
    if B > 0:
        per_seq = scratch_floats(n)
        scratch = (torch.empty((B, per_seq), dtype=torch.float32, device=dev)
                   if per_seq else None)
        huber = huber_delta is not None
        delta = float(huber_delta) if huber else 0.0
        rc = fn(camv.data_ptr(), camv.stride(0), T.data_ptr(),
                pts_w.data_ptr(), obs_px.data_ptr(), inv_sigma2.data_ptr(),
                mask.data_ptr(), valid.data_ptr(), T_out.data_ptr(),
                inliers.data_ptr(), chi2.data_ptr(),
                None if scratch is None else scratch.data_ptr(), B, n,
                int(huber), delta, 2.0 * delta, delta * delta, int(iters),
                float(init_lambda), float(chi2_threshold),
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "pose_round")
        pose_round_cuda.launches += 1
        profiling.count("pose_kernel_launches")
    return T_out, inliers, chi2


pose_round_cuda.launches = 0
