"""Checkpoint / resume of the whole SLAM state.

Counterpart of `slam_rgbd_tpu/runtime/checkpoint.py`, in its format, so a
checkpoint written by either package restores into the other:

  * `state.npz` (compressed): `map.<field>` for every `MapState` field,
    `edges_{i}` for the `EdgeList` fields in declaration order (i, j,
    T_meas, weight, valid: the order in which the reference flattens its
    pytree), `n_edges`, `T_world`, `motion`, and the trajectory log
    `traj_ts`, `traj_T`, `frame_kf_idx`, `kf_T_at_frame`;
  * `meta.json`: frames, keyframes, loops, last_kf_idx, n_kf and
    `format_version` 2.

Arrays keep the reference's dtypes (float32 poses and times, int32 counts
and indices, bool masks; counts are 0-d). A version-1 checkpoint (positional
`map_{i}` keys, written before `kf_sig` existed) restores with the place
signatures recomputed from the descriptors.

A map-block sharded session (`SLAMSession(cfg, mesh=)`) checkpoints the
whole map: `save`, called on every rank of the `model` group, gathers the
blocks of the point table and the group's first rank writes the files;
`restore` reads them on every rank and keeps the rows of the rank's block.
So a checkpoint of a sharded session restores into an unsharded one and the
other way round.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import TYPE_CHECKING

import numpy as np
import torch

from slam_rgbd_tpu_torch.backend.pose_graph import EdgeList
from slam_rgbd_tpu_torch.parallel import mesh as pmesh

if TYPE_CHECKING:  # pragma: no cover
    from slam_rgbd_tpu_torch.runtime.session import SLAMSession


def _fields(obj) -> list[str]:
    """Field names in declaration order."""
    return [f.name for f in dataclasses.fields(obj)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _point_field(m, name: str) -> bool:
    """A field of the point table (sharded in a map-block session)."""
    return name.startswith("pt_") and getattr(m, name).dim() >= 1


def _flatten_state(session: "SLAMSession") -> dict:
    arrays: dict[str, np.ndarray] = {}
    blk = session._blk
    for name in _fields(session.map):
        x = getattr(session.map, name)
        if blk is not None and _point_field(session.map, name):
            x = pmesh.gather(x, blk.mesh, blk.axis)  # the whole table
        arrays[f"map.{name}"] = _np(x)
    for i, name in enumerate(_fields(session.edges)):
        arrays[f"edges_{i}"] = _np(getattr(session.edges, name))
    arrays["n_edges"] = _np(session.n_edges)
    arrays["T_world"] = _np(session.T_world)
    arrays["motion"] = _np(session.motion)
    ts, traj_T, kf_idx, kf_T = session._traj_arrays()
    arrays["traj_ts"] = ts
    arrays["traj_T"] = traj_T
    arrays["frame_kf_idx"] = kf_idx
    arrays["kf_T_at_frame"] = kf_T
    return arrays


def save(session: "SLAMSession", path: str) -> None:
    """Write the session's state to directory `path`. A sharded session:
    every rank of the `model` group calls it with the same path; the
    group's first rank writes, and every rank returns once it has."""
    session.flush_pipeline()  # the newest frames' decisions first
    arrays = _flatten_state(session)
    blk = session._blk
    if blk is not None and blk.index != 0:
        torch.distributed.barrier(group=blk.group)  # the writer is done
        return
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(os.path.join(path, "state.npz"), **arrays)
    meta = {
        "frames": session.state.frames,
        "keyframes": session.state.keyframes,
        "loops": session.state.loops,
        "last_kf_idx": session.last_kf_idx,
        "n_kf": session._n_kf_host,
        "format_version": 2,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    if blk is not None:
        torch.distributed.barrier(group=blk.group)


def restore(session: "SLAMSession", path: str) -> "SLAMSession":
    """Restore state in place into a freshly built session of the same
    configuration (capacities must match) and return it. A sharded session
    keeps its block of the point table."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dev = session.device
    with np.load(os.path.join(path, "state.npz")) as data:
        version = meta.get("format_version", 1)
        fields = _fields(session.map)
        if version >= 2:
            named = {name: data[f"map.{name}"] for name in fields}
        else:
            # positional map_{i} keys in field order, before `kf_sig`
            old_fields = [f for f in fields if f != "kf_sig"]
            n_old = len([k for k in data.files if k.startswith("map_")])
            if n_old != len(old_fields):
                raise ValueError(
                    f"unrecognized v1 checkpoint layout: {n_old} map leaves vs "
                    f"{len(old_fields)} known fields"
                )
            named = {name: data[f"map_{i}"] for i, name in enumerate(old_fields)}
        blk = session._blk
        for name, arr in named.items():
            want = tuple(getattr(session.map, name).shape)
            if blk is not None and _point_field(session.map, name):
                want = (blk.total,) + want[1:]
                if arr.shape == want:
                    named[name] = arr[blk.start: blk.start + blk.size]
            if arr.shape != want:
                raise ValueError(
                    f"checkpoint shape mismatch for map.{name}: {arr.shape} vs "
                    f"{want}: config capacities must match"
                )
        session.map = dataclasses.replace(session.map, **{
            name: torch.as_tensor(arr, device=dev) for name, arr in named.items()
        })
        if version < 2:
            from slam_rgbd_tpu_torch.backend.loop import place_signatures

            session.map = dataclasses.replace(session.map,
                                              kf_sig=place_signatures(session.map))
        edge_names = _fields(session.edges)
        session.edges = EdgeList(**{
            name: torch.as_tensor(data[f"edges_{i}"], device=dev)
            for i, name in enumerate(edge_names)
        })
        session.n_edges = torch.as_tensor(data["n_edges"], device=dev)
        # in place: the pose state is static (the frame graph reads it)
        session.T_world.copy_(torch.as_tensor(data["T_world"], device=dev))
        session.motion.copy_(torch.as_tensor(data["motion"], device=dev))
        session._restore_traj(data["traj_ts"], data["traj_T"], data["frame_kf_idx"],
                              data["kf_T_at_frame"])
    session.last_kf_idx = int(meta["last_kf_idx"])
    if session.last_kf_idx >= 0:
        session.last_kf_T.copy_(session.map.kf_pose[session.last_kf_idx])
    session.state.frames = meta["frames"]
    session.state.keyframes = meta["keyframes"]
    session.state.loops = meta["loops"]
    session._n_kf_host = meta.get("n_kf", meta["keyframes"])
    session._pending = None
    session._frame_i = meta["frames"]
    session._last_kf_frame_i = -(10 ** 9)
    session.prev_pyr = None  # the next frame anchors the tracking reference
    return session
