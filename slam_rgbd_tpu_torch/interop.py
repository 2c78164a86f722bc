"""Carry the JAX package's state into the port, as numpy arrays.

The system carries no weights: its state is the previous frame's pyramid,
the poses (world pose, motion prior, reference keyframe pose, trajectory
ring), the keyframe map, the pose-graph edge list, and per keyframe the
keypoints and descriptors. These helpers move that state between the two
packages, so that both can compute the same step from the same inputs. The
JAX side is handed over as numpy arrays (`np.asarray` of each field); this
module never imports it. Every `*_from_numpy` takes the device to build on:
there is no default, as there is none for the port's entry points' data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_rgbd_tpu_torch.backend.pose_graph import EdgeList
from slam_rgbd_tpu_torch.features.detect import Keypoints
from slam_rgbd_tpu_torch.features.orb import Descriptors
from slam_rgbd_tpu_torch.mapping.map import MapState

_TORCH_DTYPES = {
    "float32": torch.float32, "int32": torch.int32, "int8": torch.int8,
    "bool": torch.bool,
}


def _to_tensor(x, device) -> torch.Tensor:
    """numpy array -> tensor of the same kind; uint32 words keep their bits
    as int32."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.tensor(a, dtype=_TORCH_DTYPES[a.dtype.name], device=device)


def _fields_from(cls, src, device):
    """Build dataclass / namedtuple `cls` from `src`: a mapping or an object
    with the same field names, numpy (or array-like) values."""
    names = ([f.name for f in dataclasses.fields(cls)]
             if dataclasses.is_dataclass(cls) else cls._fields)
    get = src.__getitem__ if isinstance(src, dict) else (lambda k: getattr(src, k))
    return cls(**{k: _to_tensor(get(k), device) for k in names})


def pyramid_from_numpy(levels, device) -> tuple:
    """Sequence of per-level dicts of numpy arrays -> tuple of tensor dicts
    (float32, with `valid` as bool)."""
    out = []
    for level in levels:
        conv = {}
        for k, v in level.items():
            dtype = torch.bool if k == "valid" else torch.float32
            conv[k] = torch.tensor(np.asarray(v), dtype=dtype, device=device)
        out.append(conv)
    return tuple(out)


def pyramid_to_numpy(pyr) -> tuple:
    """Tuple of tensor dicts -> tuple of numpy dicts."""
    return tuple({k: v.cpu().numpy() for k, v in level.items()} for level in pyr)


def map_from_numpy(src, device) -> MapState:
    """A map state of the JAX package (the object, or a dict of its fields as
    numpy arrays) -> the port's `MapState`, every field."""
    return _fields_from(MapState, src, device)


def map_block_from_numpy(src, blk, device) -> MapState:
    """`map_from_numpy` of this rank's map block: every per-point field
    (`pt_*` with a point axis) cut to the rows of `blk` (a
    `parallel.mesh.Block`), the rest whole, as the map-block sharded
    session holds it."""
    get = src.__getitem__ if isinstance(src, dict) else (lambda k: getattr(src, k))
    rows = slice(blk.start, blk.start + blk.size)
    cut = {}
    for f in dataclasses.fields(MapState):
        a = np.asarray(get(f.name))
        cut[f.name] = a[rows] if f.name.startswith("pt_") and a.ndim >= 1 else a
    return map_from_numpy(cut, device)


def map_to_numpy(m: MapState) -> dict:
    """Every `MapState` field as a numpy array, by field name."""
    return {f.name: getattr(m, f.name).cpu().numpy()
            for f in dataclasses.fields(MapState)}


def edges_from_numpy(src, device) -> EdgeList:
    """An edge list of the JAX package (object or dict of numpy arrays) ->
    the port's `EdgeList`."""
    return _fields_from(EdgeList, src, device)


def edges_to_numpy(e: EdgeList) -> dict:
    return {f.name: getattr(e, f.name).cpu().numpy()
            for f in dataclasses.fields(EdgeList)}


def keypoints_from_numpy(src, device) -> Keypoints:
    """`Keypoints` of the JAX package (uv, response, angle, level, valid)."""
    return _fields_from(Keypoints, src, device)


def descriptors_from_numpy(src, device) -> Descriptors:
    """`Descriptors` of the JAX package; the packed uint32 words keep their
    bits as int32."""
    return _fields_from(Descriptors, src, device)


def state_from_numpy(session, *, T_world, motion, last_kf_T, prev_pyr=None,
                     traj_ts=(), traj_T=None, traj_kfT=None, traj_kf_idx=None,
                     map=None, edges=None, n_edges=None, n_kf=None,
                     last_kf_idx=None) -> None:
    """Load state into a `SLAMSession`: the poses, optionally the previous
    frame's pyramid (numpy dicts), the trajectory ring (timestamps,
    (n, 4, 4) poses and reference-keyframe poses, reference keyframe slot a
    frame: -1, the default, leaves a frame's pose as logged), and the map
    with its edge list and host-side keyframe count."""
    dev = session.device

    def pose(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    # in place: a session's pose state is static (its frame graph reads it)
    session.T_world.copy_(pose(T_world))
    session.motion.copy_(pose(motion))
    session.last_kf_T.copy_(pose(last_kf_T))
    if prev_pyr is not None:
        session.prev_pyr = pyramid_from_numpy(prev_pyr, dev)
    n = len(traj_ts)
    while session._traj_cap < n:
        session._grow_traj_ring()
    session._traj_ts = [float(t) for t in traj_ts]
    session._frame_kf_idx = ([-1] * n if traj_kf_idx is None
                             else [int(i) for i in traj_kf_idx])
    if n:
        session._traj_T[:n] = pose(traj_T)
        session._traj_kfT[:n] = pose(traj_kfT)
    if map is not None:
        session.map = map_from_numpy(map, dev)
        session._n_kf_host = int(np.asarray(map["n_kf"] if isinstance(map, dict)
                                            else map.n_kf)) if n_kf is None else int(n_kf)
        session.last_kf_idx = (session._n_kf_host - 1 if last_kf_idx is None
                               else int(last_kf_idx))
        session.state.keyframes = session._n_kf_host
    if edges is not None:
        session.edges = edges_from_numpy(edges, dev)
        session.n_edges = torch.tensor(int(n_edges), dtype=torch.int32, device=dev)


def _unstack(cls, src, n_seq: int, device) -> list:
    """A stacked state of the JAX package (every field with a leading B) ->
    one `cls` per sequence."""
    whole = _fields_from(cls, src, device)
    return [
        cls(**{f.name: getattr(whole, f.name)[b].clone()
               for f in dataclasses.fields(cls)})
        for b in range(n_seq)
    ]


def _stack(items) -> dict:
    """Per-sequence dataclasses -> one dict of numpy arrays with a leading B."""
    return {
        f.name: np.stack([getattr(x, f.name).cpu().numpy() for x in items])
        for f in dataclasses.fields(type(items[0]))
    }


def batch_state_from_numpy(session, *, maps, edges, n_edges, T_world, motion,
                           last_kf_T, n_kf, prev_pyr=None, frame_i=0,
                           last_kf_frame=None, last_loop_kf=None,
                           lost_streak=None) -> None:
    """Load the JAX package's batch state into a `BatchSession`: the stacked
    `MapState` and `EdgeList` (objects or dicts, every field with a leading
    B), `n_edges` (B,), the (B, 4, 4) poses, optionally the previous frames'
    pyramid (numpy dicts with a leading B), and the host counters (`n_kf`
    (B,), frame index, per-sequence last keyframe frame, last loop keyframe
    and lost streak; those left out keep a fresh session's values). The
    trajectory log stays as it is. On a session sharded over a mesh, B is
    the rank's block (`session.n_local`) and the arrays are that block's."""
    dev = session.device
    B = session.n_local

    def pose(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    session.maps = _unstack(MapState, maps, B, dev)
    session.edges = _unstack(EdgeList, edges, B, dev)
    session.n_edges = list(_to_tensor(np.asarray(n_edges), dev).unbind(0))
    session.T_world = pose(T_world)
    session.motion = pose(motion)
    session.last_kf_T = pose(last_kf_T)
    if prev_pyr is not None:
        session.prev_pyr = pyramid_from_numpy(prev_pyr, dev)
    session._n_kf = np.asarray(n_kf, np.int64).copy()
    session._frame_i = int(frame_i)
    for name, value in (("_last_kf_frame", last_kf_frame),
                        ("_last_loop_kf", last_loop_kf),
                        ("_lost_streak", lost_streak)):
        if value is not None:
            setattr(session, name, np.asarray(value, np.int64).copy())


def batch_state_to_numpy(session) -> dict:
    """The array state of a `BatchSession` in the JAX package's layout:
    `maps` and `edges` as dicts of arrays with a leading B, `n_edges`,
    `T_world`, `motion`, `last_kf_T`, `prev_pyr` (None before the first
    frame) and the host counters; on a sharded session, those of the rank's
    block of sequences."""
    return {
        "maps": _stack(session.maps),
        "edges": _stack(session.edges),
        "n_edges": np.stack([n.cpu().numpy() for n in session.n_edges]),
        "T_world": session.T_world.cpu().numpy(),
        "motion": session.motion.cpu().numpy(),
        "last_kf_T": session.last_kf_T.cpu().numpy(),
        "prev_pyr": (None if session.prev_pyr is None
                     else pyramid_to_numpy(session.prev_pyr)),
        "n_kf": session._n_kf.copy(),
        "frame_i": session._frame_i,
        "last_kf_frame": session._last_kf_frame.copy(),
        "last_loop_kf": session._last_loop_kf.copy(),
        "lost_streak": session._lost_streak.copy(),
    }
