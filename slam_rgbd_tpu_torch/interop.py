"""Carry the JAX package's state into the port, as numpy arrays.

The tracking path carries no weights: its state is the previous frame's
pyramid and the poses (world pose, motion prior, reference keyframe pose,
trajectory ring). These helpers move that state between the two packages
so both can compute the same step from the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def pyramid_from_numpy(levels, device="cpu") -> tuple:
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


def state_from_numpy(session, *, T_world, motion, last_kf_T, prev_pyr=None,
                     traj_ts=(), traj_T=None, traj_kfT=None) -> None:
    """Load tracking state into a `TrackingSession`: the poses, optionally
    the previous frame's pyramid (numpy dicts), and the trajectory ring
    (timestamps, (n, 4, 4) poses and reference-keyframe poses)."""
    dev = session.device

    def pose(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    session.T_world = pose(T_world)
    session.motion = pose(motion)
    session.last_kf_T = pose(last_kf_T)
    if prev_pyr is not None:
        session.prev_pyr = pyramid_from_numpy(prev_pyr, dev)
    n = len(traj_ts)
    while session._traj_cap < n:
        session._grow_traj_ring()
    session._traj_ts = [float(t) for t in traj_ts]
    if n:
        session._traj_T[:n] = pose(traj_T)
        session._traj_kfT[:n] = pose(traj_kfT)
