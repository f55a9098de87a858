"""One run of a cell: a battery of B sequences stepped as one batched
program, its window timed, its output checked.

The path the window drives is the port's batched step
(trackingbench_slam_tpu_torch/parallel/dp_eval.py): S rendered sequences,
each run `executions` times (B = S x executions), are bootstrapped one by
one on their first frame (models/vo.py `init_state` + `keyframe_step`, as
parallel/batch_check.py `bootstrap` does), stacked (`stack_states`), and
stepped together: `dp_track_step` on every frame, `dp_track_and_keyframe_step`
on the configuration's keyframe cadence, each execution drawing its RANSAC
numbers from its own torch.Generator (`draw_uniform`). Frames reach the
port as host uint8 arrays through its upload path (utils/device.py
`upload_image`), one upload a sequence a frame shared by its executions;
poses come back one step late through utils/device.py `HostCopy`, without
a blocking wait, as StereoVO reads its inlier counts.

Phases, in order (`Run.phases` keeps their seconds):
  set-up   imports, the kernel build, the scenes and frames rendered on the
           device and copied to the host, the serial bootstraps, stacking,
           `warmup_frames` batched steps (a keyframe cadence and two: every
           shape the window uses), a fence;
  window   batched steps until `seconds` have passed, then a fence, with
           the host held steady (host.py); the window ends early only if
           the sequences run out of frames, and the result line says so;
  drain    untimed steps until every sequence has `ate_frames` frames, so
           the trajectory error covers the same frames however fast the
           program runs;
  sample   one keyframe cadence of steps with the hand kernels' calls
           recorded (capture.py), each tagged with its step's frame, under
           torch.profiler in a traced run;
  check    the peak memory read, the program's state freed, then the
           poses against the rendered ground truth and the recorded kernel
           calls against reference/kernels.py, on image operands that the
           check rebuilds from the host frames (check.py).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from slam_bench import scene as scene_mod


@dataclasses.dataclass
class Run:
    """What a run leaves for the metric readers (slam_bench/metrics/)."""

    device: torch.device
    B: int = 0
    S: int = 0
    kf_every: int = 0
    setup_s: float = 0.0
    phases: dict = dataclasses.field(default_factory=dict)
    window_s: float = 0.0
    window_steps: list = dataclasses.field(default_factory=list)  # kinds
    window_ended_early: bool = False
    host: dict = dataclasses.field(default_factory=dict)  # host.delta
    upload_ms: list = dataclasses.field(default_factory=list)
    draw_ms: list = dataclasses.field(default_factory=list)
    readback_ms: list = dataclasses.field(default_factory=list)
    bootstrap_ms: list = dataclasses.field(default_factory=list)
    dispatch_ms: dict = dataclasses.field(default_factory=dict)
    poses: np.ndarray | None = None      # (B, frames, 4, 4)
    inliers: np.ndarray | None = None    # (B, frames)
    gt: np.ndarray | None = None         # (S, frames, 4, 4)
    lefts: list | None = None            # per sequence (frames, H, W) u8
    rights: list | None = None           # per sequence {frame: (H, W) u8}
    pyramid: tuple = (1, 1.0)            # (levels, scale) of extraction
    seq_of: np.ndarray | None = None     # (B,) sequence of each execution
    frames_done: int = 0
    window_first: int = 0
    ate_frames: int = 0
    ate_sq: np.ndarray | None = None     # (B, ate_frames) squared errors
    calls: list = dataclasses.field(default_factory=list)
    profile: dict | None = None
    checks: dict = dataclasses.field(default_factory=dict)
    operand_gaps: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0


def pipeline_config(config: dict):
    from trackingbench_slam_tpu_torch.utils.config import PipelineConfig
    import json
    return PipelineConfig.from_json(json.dumps(config))


def draw_sequences(traffic: dict, seed: int):
    """The battery's sequences in the order `seed` puts them, as (texture
    seed, trajectory phase) of each, and each execution's RANSAC generator
    seed, drawn from `seed`. The sequences themselves are the dataset's,
    drawn from the workload's `dataset_seed`: every run re-runs the same
    recordings, as a workbench does, and the seed changes which draws
    each execution makes and where in the batch each sequence sits."""
    S, E = traffic["sequences"], traffic["executions"]
    data = np.random.default_rng(traffic["dataset_seed"])
    tex = data.integers(0, 2 ** 62, size=S)
    phase = data.uniform(0.0, 2 * math.pi, size=S)
    rng = np.random.default_rng(seed)
    order = rng.permutation(S)
    gens = rng.integers(0, 2 ** 62, size=S * E)
    return tex[order], phase[order], gens


def render_battery(traffic: dict, camera: dict, baseline: float,
                   kf_every: int, seed: int, device):
    """(lefts, rights, gt): per sequence its left frames (F, H, W) and right
    frames {frame: (H, W)} (frame 0 and the keyframes) as host uint8
    arrays, and the (S, F, 4, 4) ground truth."""
    tex, phase, _ = draw_sequences(traffic, seed)
    tr, cor = traffic["trajectory"], traffic["corridor"]
    n = traffic["frames_per_sequence"]
    chunk = 48   # views a render call casts (a few GB of float64 rays)
    right_at = [i for i in range(n) if i == 0 or (i + 1) % kf_every == 0]
    shift = np.eye(4)
    shift[0, 3] = -baseline
    lefts, rights, gts = [], [], []
    for s in range(len(tex)):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(tex[s]))
        corridor = scene_mod.Corridor(
            camera, cor["width_m"], cor["height_m"], cor["length_m"],
            device, gen, ppm=cor["texture_px_per_m"],
            blobs_per_m2=cor["blobs_per_m2"])
        gt = scene_mod.swing_trajectory(
            n, float(phase[s]), tr["step_m"], tr["yaw_rate_max"],
            tr["yaw_period_frames"], tr["pitch_amp"], tr["pitch_freq"],
            tr["start_z_m"])
        poses = np.concatenate([gt, shift @ gt[right_at]])
        views = torch.cat([scene_mod.to_u8(corridor.render(poses[i:i + chunk]))
                           for i in range(0, len(poses), chunk)]).cpu().numpy()
        lefts.append(views[:n])
        rights.append(dict(zip(right_at, views[n:])))
        gts.append(gt)
    return lefts, rights, np.stack(gts)


class Battery:
    """The B sequences' batched state and the step that advances it."""

    def __init__(self, run: Run, cfg, lefts, rights, gen_seeds, device):
        from trackingbench_slam_tpu_torch.geometry.camera import CameraParams
        from trackingbench_slam_tpu_torch.models import vo as vo_mod
        from trackingbench_slam_tpu_torch.parallel import dp_eval
        from trackingbench_slam_tpu_torch.utils.device import upload_image
        self.run, self.cfg, self.dev = run, cfg, device
        self.lefts, self.rights = lefts, rights
        self.upload = upload_image
        self.cam = CameraParams.from_config(cfg.camera, device)
        S = len(lefts)
        E = run.B // S
        self.seq_of = torch.arange(S, device=device).repeat_interleave(E)
        run.seq_of = self.seq_of.cpu().numpy()
        boots = []
        for s in range(S):   # serial bootstraps: batch_check.bootstrap
            t = time.perf_counter()
            left = upload_image(lefts[s][0], device)
            st = vo_mod.init_state(cfg, left)
            st = vo_mod.keyframe_step(st, upload_image(rights[s][0], device),
                                      self.cam, cfg)
            boots.append(st._replace(frame_id=st.frame_id + 1))
            run.bootstrap_ms.append((time.perf_counter() - t) * 1e3)
        # the executions of a sequence start from its one bootstrap
        self.states = dp_eval.stack_states([boots[s] for s in
                                            self.seq_of.tolist()])
        del boots
        self.gens = []
        for g in gen_seeds:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(g))
            self.gens.append(gen)
        n = len(lefts[0])
        run.poses = np.zeros((run.B, n, 4, 4), np.float32)
        run.inliers = np.zeros((run.B, n), np.int32)
        run.poses[:, 0] = np.eye(4)
        self.frame = 0          # last frame stepped
        self.pending = None     # (frame, HostCopy of T_cw, of inliers)

    def _frames(self, which):
        ups = [self.upload(which(s), self.dev) for s in range(len(self.lefts))]
        return torch.stack(ups).index_select(0, self.seq_of)

    def step(self, timed: bool = False) -> str:
        """Advance every sequence by one frame; returns "track" or
        "keyframe". With `timed`, the host ms of the uploads and of the
        step's dispatch are appended to the run."""
        from trackingbench_slam_tpu_torch.parallel import dp_eval
        from trackingbench_slam_tpu_torch.utils.device import HostCopy
        i = self.frame + 1
        kf = (i + 1) % self.cfg.keyframe_every == 0
        kind = "keyframe" if kf else "track"
        rec = torch.profiler.record_function
        t0 = time.perf_counter()
        with rec("bench.upload"):
            lefts = self._frames(lambda s: self.lefts[s][i])
            rights = (self._frames(lambda s: self.rights[s][i]) if kf
                      else None)
        t1 = time.perf_counter()
        with rec("bench.draw"):
            u = dp_eval.draw_uniform(self.gens, self.cfg)
        t2 = time.perf_counter()
        if kf:
            self.states = dp_eval.dp_track_and_keyframe_step(
                self.states, lefts, rights, self.cam, self.cfg, u)
        else:
            self.states = dp_eval.dp_track_step(self.states, lefts, self.cam,
                                                self.cfg, u)
        t3 = time.perf_counter()
        with rec("bench.readback"):
            self._land()
            self.pending = (i, HostCopy(self.states.T_cw),
                            HostCopy(self.states.num_inliers))
        if timed:
            self.run.upload_ms.append((t1 - t0) * 1e3)
            self.run.draw_ms.append((t2 - t1) * 1e3)
            self.run.dispatch_ms.setdefault(kind, []).append(
                (t3 - t2) * 1e3)
            self.run.readback_ms.append((time.perf_counter() - t3) * 1e3)
        self.frame = i
        return kind

    def _land(self):
        """The previous step's poses, copied while this one was issued."""
        if self.pending is not None:
            j, T, n = self.pending
            self.run.poses[:, j] = T.numpy()
            self.run.inliers[:, j] = n.numpy()
            self.pending = None

    def finish(self):
        self._land()


def _quartiles(ms) -> str:
    if len(ms) == 0:
        return "-"
    return " ".join(f"{q:.1f}" for q in np.percentile(ms, [25, 50, 75]))


def fence(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiled(fn, device):
    """(profiler, wall ms) of fn() under torch.profiler (CPU and, on the
    card, CUDA activity)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    fence(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        fence(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def run_cell(found: dict, seed: int, seconds: float, trace: bool, device,
             process_start: float, log=print) -> Run:
    """Set-up, window, drain, sample and check of one run (module
    docstring); returns the Run with its checks."""
    from slam_bench import capture as capture_mod
    from slam_bench import check as check_mod
    from slam_bench import host
    device = torch.device(device)
    traffic, config = found["traffic"], found["config"]
    run = Run(device=device)
    t_import = time.time()
    import trackingbench_slam_tpu_torch  # noqa: F401  (TF32 pins)
    cfg = pipeline_config(config)
    run.phases["import_s"] = time.time() - t_import
    run.kf_every = cfg.keyframe_every
    run.pyramid = (cfg.pyramid.num_levels, cfg.pyramid.scale_factor)
    run.S = traffic["sequences"]
    run.B = run.S * traffic["executions"]
    run.ate_frames = traffic["ate_frames"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        t = time.time()
        from trackingbench_slam_tpu_torch.ops.cuda import build
        build.build_all()
        run.phases["build_s"] = time.time() - t
    t = time.time()
    cam = dataclasses.asdict(cfg.camera)
    run.lefts, run.rights, run.gt = render_battery(
        traffic, cam, cfg.camera.bf / cfg.camera.fx, cfg.keyframe_every,
        seed, device)
    run.phases["render_s"] = time.time() - t
    t = time.time()
    _, _, gen_seeds = draw_sequences(traffic, seed)
    bat = Battery(run, cfg, run.lefts, run.rights, gen_seeds, device)
    fence(device)
    run.phases["bootstrap_s"] = time.time() - t
    t = time.time()
    n_frames = traffic["frames_per_sequence"]
    sample = cfg.keyframe_every
    last_window_frame = n_frames - 1 - sample
    for _ in range(traffic["warmup_frames"]):
        bat.step()
    fence(device)
    run.phases["warmup_s"] = time.time() - t
    run.window_first = bat.frame + 1
    starts = []
    with host.steady():
        before = host.counters(torch, device)
        run.setup_s = time.time() - process_start
        t0 = time.perf_counter()
        while bat.frame < last_window_frame:
            starts.append(time.perf_counter())
            run.window_steps.append(bat.step(timed=True))
            if time.perf_counter() - t0 >= seconds:
                break
        else:
            run.window_ended_early = True
        fence(device)
        run.window_s = time.perf_counter() - t0
        run.host = host.delta(before, host.counters(torch, device))
    log(f"[bench] set-up {run.setup_s:.3f} s "
        + " ".join(f"{k} {v:.3f}" for k, v in run.phases.items())
        + f"; window started at frame {run.window_first} of {n_frames}: "
        "every sequence bootstrapped before it, none ends or restarts in it")
    gaps = np.diff(starts + [t0 + run.window_s]) * 1e3
    kinds = np.array(run.window_steps)
    log(f"[bench] window {run.window_s:.3f} s: frames "
        f"{bat.frame - len(run.window_steps) + 1}-{bat.frame}, "
        f"{len(run.window_steps)} steps "
        f"({run.window_steps.count('keyframe')} keyframe steps) x B "
        f"{run.B}" + (" (ran out of frames)" if run.window_ended_early
                      else "") + "; step ms (quartiles) track "
        + _quartiles(gaps[kinds == "track"]) + ", keyframe "
        + _quartiles(gaps[kinds == "keyframe"])
        + "; host ms a step (quartiles) upload " + _quartiles(run.upload_ms)
        + ", draw " + _quartiles(run.draw_ms) + ", dispatch track "
        + _quartiles(run.dispatch_ms.get("track", [])) + ", dispatch keyframe "
        + _quartiles(run.dispatch_ms.get("keyframe", [])) + ", readback "
        + _quartiles(run.readback_ms)
        + f"; bootstraps ms min {min(run.bootstrap_ms):.1f} median "
        f"{np.median(run.bootstrap_ms):.1f} max {max(run.bootstrap_ms):.1f}"
        "; host " + " ".join(f"{k} {v}" for k, v in run.host.items()))
    t = time.time()
    while bat.frame < run.ate_frames - 1:
        bat.step()
    run.phases["drain_s"] = time.time() - t
    with capture_mod.Capture() as cap:
        def sample_steps():
            cap.on = True
            for _ in range(sample):
                cap.frame = bat.frame + 1
                bat.step()
            cap.on = False
        if trace:
            prof, wall_ms = profiled(sample_steps, device)
            run.profile = dict(prof=prof, wall_ms=wall_ms, steps=sample)
        else:
            sample_steps()
    fence(device)
    bat.finish()
    run.frames_done = bat.frame + 1
    run.calls = cap.calls
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    del bat
    t = time.time()
    run.checks = check_mod.check(run, found["traffic"]["limits"])
    run.phases["check_s"] = time.time() - t
    return run
