"""The reference's states <-> this package's, through numpy.

`vo_state_from_numpy` takes the reference's VOState with numpy leaves (what
`jax.tree.map(np.asarray, state)` gives: NamedTuples, or the nested dicts
and tuples of `vo_state_to_numpy`) and returns this package's VOState on
`device`. Likewise the BoW vocabulary and databases and the two BA problem
tuples. Nothing here knows JAX types: NamedTuples and objects are read by
field name, plain tuples by position. uint32 descriptor words are stored as
int32 with the same bits; the PRNG key as int64.
"""

from __future__ import annotations

import numpy as np
import torch

from trackingbench_slam_tpu_torch.bow import vocabulary as bow
from trackingbench_slam_tpu_torch.models.frame import FrameState
from trackingbench_slam_tpu_torch.models.map import KeyframeStore, MapState
from trackingbench_slam_tpu_torch.models.vo import VOState
from trackingbench_slam_tpu_torch.solvers import local_ba

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
    elif a.dtype == np.float64:   # a Python float among the leaves
        a = a.astype(np.float32)
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


def _field(node, name):
    return node[name] if isinstance(node, dict) else getattr(node, name)


# --- tracker host state. The dicts use the attribute names of this
# package's trackers; an object given instead (the reference's tracker) is
# read by the reference's attribute names, listed here where they differ.
_REFERENCE_NAMES = {
    "last_mean_depth": "_last_mean_depth",
    "num_tracked_dev": "_num_tracked_dev",
    "num_promoted_dev": "_num_promoted_dev",
    "f0": "_f0", "cur_xy": "_cur_xy", "kf_lk_pyr": "_kf_lk_pyr",
    "kf_T_cw": "_kf_T_cw", "fid": "_fid", "kf_count": "_kf_count",
}
_DIRECT_TENSORS = ("kf_depth", "kf_pos_w", "kf_has_lm", "T_cw",
                   "last_mean_depth", "num_tracked_dev", "num_promoted_dev")


def _host_field(node, name):
    if isinstance(node, dict):
        return node[name]
    return getattr(node, _REFERENCE_NAMES.get(name, name))


def _dump_value(v):
    """Tensors, NamedTuples of tensors and tuples of tensors as numpy."""
    if v is None or isinstance(v, (bool, int, float)):
        return v
    if hasattr(v, "_asdict"):
        return _dump(v)
    if isinstance(v, (tuple, list)):
        return tuple(_leaf("", x) for x in v)
    return _leaf("", v)


def direct_vo_state_to_numpy(vo) -> dict:
    """A DirectVO's host state with numpy leaves."""
    out = {name: _dump_value(getattr(vo, name)) for name in _DIRECT_TENSORS}
    out["kf"] = _dump(vo.kf)
    out["seed_batches"] = [{k: _dump_value(v) for k, v in b.items()}
                           for b in vo.seed_batches]
    out["trajectory"] = [_leaf("", T) for T in vo.trajectory]
    out["frame_id"] = vo.frame_id
    return out


def load_direct_vo_state(vo, tree) -> None:
    """Sets a DirectVO's host state (on its device) from `tree`: a dict of
    `direct_vo_state_to_numpy`, or the reference's DirectVO."""
    from trackingbench_slam_tpu_torch.solvers.depth_filter import SeedState
    dev = vo.device
    for name in _DIRECT_TENSORS:
        setattr(vo, name, _to_tensor(_host_field(tree, name), dev))
    vo.kf = _build(_host_field(tree, "kf"), FrameState, dev)
    vo.seed_batches = [dict(
        seeds=_build(b["seeds"], SeedState, dev),
        lk_pyr=tuple(_to_tensor(x, dev) for x in b["lk_pyr"]),
        kp_xy=_to_tensor(b["kp_xy"], dev),
        bearing=_to_tensor(b["bearing"], dev),
        T_cw=_to_tensor(b["T_cw"], dev))
        for b in _host_field(tree, "seed_batches")]
    vo.trajectory = [_to_tensor(T, dev)
                     for T in _host_field(tree, "trajectory")]
    vo.frame_id = int(_host_field(tree, "frame_id"))


def mono_vo_state_to_numpy(vo) -> dict:
    """A MonoVO's host state with numpy leaves (state: vo_state_to_numpy's
    dicts, None before the bootstrap)."""
    return dict(
        state=None if vo.state is None else vo_state_to_numpy(vo.state),
        initialized=vo.initialized,
        f0=None if vo.f0 is None else _dump(vo.f0),
        cur_xy=_dump_value(vo.cur_xy), kf_lk_pyr=_dump_value(vo.kf_lk_pyr),
        kf_T_cw=_dump_value(vo.kf_T_cw), fid=vo.fid, kf_count=vo.kf_count,
        trajectory=[_leaf("", T) for T in vo.trajectory])


def load_mono_vo_state(vo, tree) -> None:
    """Sets a MonoVO's host state (on its device) from `tree`: a dict of
    `mono_vo_state_to_numpy`, or the reference's MonoVO."""
    dev = vo.device

    def opt(name, fn):
        v = _host_field(tree, name)
        return None if v is None else fn(v)

    vo.state = opt("state", lambda s: vo_state_from_numpy(s, dev))
    vo.initialized = bool(_host_field(tree, "initialized"))
    vo.f0 = opt("f0", lambda f: _build(f, FrameState, dev))
    vo.cur_xy = opt("cur_xy", lambda x: _to_tensor(x, dev))
    vo.kf_lk_pyr = opt("kf_lk_pyr",
                       lambda p: tuple(_to_tensor(x, dev) for x in p))
    vo.kf_T_cw = opt("kf_T_cw", lambda x: _to_tensor(x, dev))
    vo.fid = int(_host_field(tree, "fid"))
    vo.kf_count = int(_host_field(tree, "kf_count"))
    vo.trajectory = [_to_tensor(T, dev)
                     for T in _host_field(tree, "trajectory")]


def vocabulary_from_numpy(voc, device) -> bow.Vocabulary:
    """The reference's Vocabulary (or a dict with its fields: `levels`, a
    sequence of (k^l, 8) uint32 tables, `word_weights`, `branching`,
    `depth`, `levels_up`) as this package's, on `device`."""
    return bow.Vocabulary(
        levels=tuple(_to_tensor(t, device) for t in _field(voc, "levels")),
        word_weights=_to_tensor(_field(voc, "word_weights"), device),
        branching=int(_field(voc, "branching")),
        depth=int(_field(voc, "depth")),
        levels_up=int(_field(voc, "levels_up")))


def vocabulary_to_numpy(voc: bow.Vocabulary) -> dict:
    """The vocabulary's fields with numpy leaves, uint32 tables."""
    return dict(levels=tuple(bow.as_uint32(t) for t in voc.levels),
                word_weights=voc.word_weights.cpu().numpy(),
                branching=voc.branching, depth=voc.depth,
                levels_up=voc.levels_up)


def bow_database_from_numpy(db, voc: bow.Vocabulary, device):
    """The state of the reference's BowDatabase (`vectors`, `used`) or
    SparseBowDatabase (`words`, `weights`, `used`), given as an object or
    a dict, as this package's database over `voc`."""
    if (isinstance(db, dict) and "words" in db) or hasattr(db, "words"):
        words = _to_tensor(_field(db, "words"), device)
        out = bow.SparseBowDatabase(voc, width=words.shape[1],
                                    capacity=words.shape[0])
        out.words = words
        out.weights = _to_tensor(_field(db, "weights"), device)
    else:
        vectors = _to_tensor(_field(db, "vectors"), device)
        out = bow.BowDatabase(voc, capacity=vectors.shape[0])
        out.vectors = vectors
    out.used = int(_field(db, "used"))
    return out


def _problem(tree, cls, device):
    d = _as_dict(tree, cls)
    return cls(**{name: None if d.get(name) is None
                  else _to_tensor(d[name], device) for name in cls._fields})


def grouped_ba_problem_from_numpy(tree, device) -> local_ba.GroupedBAProblem:
    """The reference's GroupedBAProblem with numpy leaves (obs_ur may be
    None) as this package's."""
    return _problem(tree, local_ba.GroupedBAProblem, device)


def ba_problem_from_numpy(tree, device) -> local_ba.BAProblem:
    """The reference's flat BAProblem with numpy leaves (obs_ur may be
    None) as this package's."""
    return _problem(tree, local_ba.BAProblem, device)
