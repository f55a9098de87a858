"""A cell small enough for the CPU: the KITTI configuration at 256x160 with
300 features, 2 levels, a keyframe every 3rd frame; 2 sequences x 2
executions of 14 frames. The harness runs it with the port's plain kernel
versions; `run_tiny` skips only run.py's look for a card."""

from __future__ import annotations

import copy
import json
import time

from slam_bench import battery, registry

LIMITS = dict(step_err_max_mm=40.0, step_err_rms_mm=20.0,
              ate_seq_max_mm=20.0, lk_xy_gap_px=1e-3,
              lk_flags_differing=0, fast_score_gap=0.0,
              orb_angle_gap_rad=1e-5, orb_bits_differing=0,
              anchor_cell_gap=1e-5)


def tiny_cell(frames: int = 14) -> dict:
    bench = registry.load_benchmark()
    found = registry.find_cell(bench, "kitti-stereo.dataset")
    cfg = copy.deepcopy(found["config"])
    cfg["camera"].update(width=256, height=160, fx=180.0, fy=180.0,
                         cx=128.0, cy=80.0, bf=180.0 * 0.54)
    cfg["extractor"].update(num_features=300)
    cfg["pyramid"].update(num_levels=2)
    cfg["map"].update(max_points=1024, max_keyframes=6)
    cfg["keyframe_every"] = 3
    traffic = copy.deepcopy(found["traffic"])
    traffic.update(sequences=2, executions=2, frames_per_sequence=frames,
                   warmup_frames=3, ate_frames=8, limits=dict(LIMITS))
    return dict(found, workload=dict(found["workload"], name="tiny"),
                config=cfg, traffic=traffic)


def run_tiny(found=None, seed: int = 3_141_592_653, seconds: float = 1.0,
             trace: bool = False):
    import torch
    torch.set_num_threads(4)
    return battery.run_cell(found or tiny_cell(), seed, seconds, trace,
                            "cpu", time.time(), lambda m: None)


if __name__ == "__main__":   # the tiny run's result line, for a subprocess
    import sys
    from slam_bench import run as run_mod
    found = tiny_cell()
    r = run_tiny(found)
    print(json.dumps(dict(result=run_mod.result_line(r, found, False),
                          forbidden=run_mod.forbidden_modules(),
                          modules=sorted({m.split(".")[0]
                                          for m in sys.modules}))))
