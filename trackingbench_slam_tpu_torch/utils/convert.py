"""VOState <-> nested numpy, for carrying a state between the two packages.

`vo_state_from_numpy` takes the reference's VOState with numpy leaves (what
`jax.tree.map(np.asarray, state)` gives: NamedTuples, or the nested dicts
and tuples of `vo_state_to_numpy`) and returns this package's VOState on
`device`. Nothing here knows JAX types: NamedTuples are read by field name,
plain tuples by position. uint32 descriptor words are stored as int32 with
the same bits; the PRNG key as int64.
"""

from __future__ import annotations

import numpy as np
import torch

from trackingbench_slam_tpu_torch.models.frame import FrameState
from trackingbench_slam_tpu_torch.models.map import KeyframeStore, MapState
from trackingbench_slam_tpu_torch.models.vo import VOState

_DESC_FIELDS = ("desc", "obs_desc")


def _as_dict(node, cls) -> dict:
    if isinstance(node, dict):
        return node
    if hasattr(node, "_asdict"):
        return node._asdict()
    return dict(zip(cls._fields, node))


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _build(node, cls, device):
    d = _as_dict(node, cls)
    out = {}
    for name in cls._fields:
        v = d[name]
        if name in ("pyramid", "lk_pyr"):
            out[name] = tuple(_to_tensor(x, device) for x in v)
        else:
            out[name] = _to_tensor(v, device)
    return cls(**out)


def vo_state_from_numpy(tree, device) -> VOState:
    d = _as_dict(tree, VOState)
    out = {"prev": _build(d["prev"], FrameState, device),
           "map": _build(d["map"], MapState, device),
           "kfs": _build(d["kfs"], KeyframeStore, device)}
    for name in VOState._fields:
        if name not in out:
            out[name] = _to_tensor(d[name], device)
    out["key"] = torch.from_numpy(
        np.asarray(d["key"]).astype(np.int64)).to(device)
    return VOState(**out)


def _leaf(name, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if name in _DESC_FIELDS:
        a = a.view(np.uint32)
    return a


def _dump(nt) -> dict:
    out = {}
    for name, v in nt._asdict().items():
        if isinstance(v, tuple):
            out[name] = tuple(_leaf(name, x) for x in v)
        else:
            out[name] = _leaf(name, v)
    return out


def vo_state_to_numpy(state: VOState) -> dict:
    """Nested dicts of numpy arrays with the reference's field names and
    dtypes (uint32 descriptors and key)."""
    out = {"prev": _dump(state.prev), "map": _dump(state.map),
           "kfs": _dump(state.kfs)}
    for name in VOState._fields:
        if name not in out:
            out[name] = _leaf(name, getattr(state, name))
    out["key"] = out["key"].astype(np.uint32)
    return out
