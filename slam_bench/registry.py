"""Finds a cell's pieces by name: nothing here changes when a cell, a
configuration, a traffic mix or a metric is added.

  * `BENCHMARK.json` at the checkout's root names the cells, their
    configurations and the metrics;
  * a configuration's file is the one its `configs` entry names: the port's
    PipelineConfig tree as run (trackingbench_slam_tpu_torch/utils/config.py
    field names), with the source's own figures beside it;
  * a cell's traffic is `slam_bench/workloads/<cell>.json`: the battery's
    sequences, executions, lengths, trajectory and scene parameters, and
    the limits of its `correct` check;
  * a metric is `slam_bench/metrics/<metric>.py`, whose `read(run)` returns
    the metric's value, or None where the run holds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The cell `name` with its configuration, traffic and metrics:
    dict(workload, config_entry, config, traffic, end_to_end, per_layer,
    root)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has "
                       f"{sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = json.loads((Path(root) / entry["file"]).read_text())
    traffic = json.loads((Path(root) / "slam_bench" / "workloads"
                          / f"{name}.json").read_text())

    def used(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return dict(workload=cell, config_entry=entry, config=config,
                traffic=traffic, end_to_end=used(bench["end_to_end"]),
                per_layer=used(bench["per_layer"]), root=str(root))


def metric_reader(name: str, root: Path = ROOT):
    """`read` of slam_bench/metrics/<name>.py."""
    path = Path(root) / "slam_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "slam_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
