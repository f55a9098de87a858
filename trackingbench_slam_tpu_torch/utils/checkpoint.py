"""Checkpoint and resume of the stereo tracker's state.

Port of trackingbench_slam_tpu/utils/checkpoint.py `save_checkpoint` and
`load_checkpoint`. A checkpoint is a directory: `config.json`, `meta.json`
(step, trajectory length, the BRIEF pattern's id, the state schema and its
version, the leaf count and names), `trajectory.npy` and `state.npz`, whose
`leaf_<i>` arrays are the VOState leaves in field order with the
reference's dtypes (uint32 descriptors and key), which is the layout the
reference writes when orbax is not installed. So the loader here also reads
a checkpoint the JAX package wrote in that layout, through
utils/convert.py, and a JAX run can be resumed on the card. A checkpoint
whose schema, leaf count or leaf shapes do not match the configuration's
state raises a ValueError that says which.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from trackingbench_slam_tpu_torch.utils.config import PipelineConfig

SCHEMA = "VOState"
SCHEMA_VERSION = 1


def _flatten(tree: dict, prefix: str = "") -> list:
    """[(dotted name, array)] of a vo_state_to_numpy tree in field order,
    tuples expanded in place (the reference's pytree leaf order)."""
    out = []
    for name, v in tree.items():
        key = prefix + name
        if isinstance(v, dict):
            out += _flatten(v, key + ".")
        elif isinstance(v, tuple):
            out += [(f"{key}.{i}", x) for i, x in enumerate(v)]
        else:
            out.append((key, v))
    return out


def _unflatten(template: dict, leaves: list, prefix: str = "") -> dict:
    """`template`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    out = {}
    for name, v in template.items():
        if isinstance(v, dict):
            out[name] = _unflatten(v, leaves, prefix + name + ".")
        elif isinstance(v, tuple):
            out[name] = tuple(next(leaves) for _ in v)
        else:
            out[name] = next(leaves)
    return out


def _template(cfg: PipelineConfig) -> dict:
    """The numpy tree of an empty state of `cfg` (shapes and names)."""
    from trackingbench_slam_tpu_torch.models.vo import init_state
    from trackingbench_slam_tpu_torch.utils.convert import vo_state_to_numpy
    img = torch.zeros((cfg.camera.height, cfg.camera.width),
                      dtype=torch.float32)
    return vo_state_to_numpy(init_state(cfg, img))


def save_checkpoint(path: str, state, cfg: PipelineConfig, trajectory=None,
                    step: int = 0) -> None:
    """Writes the state (a VOState on any device), the config, the
    trajectory ((4, 4) poses) and the step into the directory `path`."""
    from trackingbench_slam_tpu_torch.ops.orb import pattern_id
    from trackingbench_slam_tpu_torch.utils.convert import vo_state_to_numpy
    leaves = _flatten(vo_state_to_numpy(state))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        fh.write(cfg.to_json())
    meta = {"step": int(step),
            "trajectory_len": 0 if trajectory is None else len(trajectory),
            # descriptors are only comparable under the pattern that made
            # them
            "descriptor_pattern_id": pattern_id(),
            "state_schema": SCHEMA, "state_schema_version": SCHEMA_VERSION,
            "leaf_count": len(leaves), "leaf_names": [n for n, _ in leaves]}
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    if trajectory is not None and len(trajectory):
        np.save(os.path.join(path, "trajectory.npy"), np.stack(
            [torch.as_tensor(T).cpu().numpy() for T in trajectory]))
    np.savez(os.path.join(path, "state.npz"),
             **{f"leaf_{i}": a for i, (_, a) in enumerate(leaves)})


def load_checkpoint(path: str, device=None):
    """Reads a checkpoint of this package or of the JAX package (its npz
    layout). Returns (VOState on `device`, config, trajectory (T, 4, 4)
    numpy or None, step). `device` defaults to CUDA and raises without it;
    pass device="cpu" for the CPU."""
    from trackingbench_slam_tpu_torch.ops.orb import pattern_id
    from trackingbench_slam_tpu_torch.utils.convert import vo_state_from_numpy
    from trackingbench_slam_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as fh:
        cfg = PipelineConfig.from_json(fh.read())
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    saved_pat = meta.get("descriptor_pattern_id")
    if saved_pat is not None and saved_pat != pattern_id():
        raise ValueError(
            f"checkpoint at {path} holds descriptors of BRIEF pattern "
            f"{saved_pat}, but this package's pattern is {pattern_id()}: "
            "Hamming distances across patterns mean nothing")
    # a checkpoint of the JAX package carries no schema: it is read as the
    # reference's VOState, whose fields this package's VOState keeps
    schema = meta.get("state_schema", SCHEMA)
    version = meta.get("state_schema_version", SCHEMA_VERSION)
    if schema != SCHEMA or version != SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint at {path} holds state schema {schema!r} version "
            f"{version}; this package reads {SCHEMA!r} version "
            f"{SCHEMA_VERSION}")
    npz = os.path.join(path, "state.npz")
    if not os.path.exists(npz):
        raise ValueError(
            f"checkpoint at {path} has no state.npz (a JAX checkpoint "
            "written through orbax?); this package reads the npz layout")
    template = _template(cfg)
    expected = _flatten(template)
    with np.load(npz) as z:
        count = len([k for k in z.files if k.startswith("leaf_")])
        saved = meta.get("leaf_count", count)
        if count != len(expected) or saved != count:
            raise ValueError(
                f"checkpoint at {path} holds {count} state leaves (meta "
                f"says {saved}); a VOState of its config has "
                f"{len(expected)}")
        leaves = [z[f"leaf_{i}"] for i in range(count)]
    for (name, want), got in zip(expected, leaves):
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(
                f"checkpoint at {path}: leaf {name} has shape "
                f"{tuple(got.shape)}, the config's state {tuple(want.shape)}")
    state = vo_state_from_numpy(_unflatten(template, iter(leaves)), dev)
    traj_file = os.path.join(path, "trajectory.npy")
    trajectory = np.load(traj_file) if os.path.exists(traj_file) else None
    return state, cfg, trajectory, int(meta["step"])
