"""Pose-graph edge list (the solver comes with the backend slice).

Counterpart of `EdgeList` in `slam_rgbd_tpu/backend/pose_graph.py`: a
fixed-capacity list of relative-pose constraints, the odometry chain the
keyframe insert writes and, later, the loop constraints.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class EdgeList:
    """Fixed-capacity relative-pose constraints."""

    i: torch.Tensor  # (E,) int32 source node
    j: torch.Tensor  # (E,) int32 target node
    T_meas: torch.Tensor  # (E, 4, 4) measured T_i^-1 T_j
    weight: torch.Tensor  # (E,) float32
    valid: torch.Tensor  # (E,) bool

    @classmethod
    def empty(cls, capacity: int, device="cpu") -> "EdgeList":
        return cls(
            i=torch.zeros(capacity, dtype=torch.int32, device=device),
            j=torch.zeros(capacity, dtype=torch.int32, device=device),
            T_meas=torch.eye(4, device=device).repeat(capacity, 1, 1),
            weight=torch.zeros(capacity, dtype=torch.float32, device=device),
            valid=torch.zeros(capacity, dtype=torch.bool, device=device),
        )

    def add(self, n_edges: torch.Tensor, i, j, T_meas, weight=1.0):
        """Append at slot `n_edges` (a () int32 tensor on the list's device),
        dropping silently when full. Returns (new list, new count); nothing
        is read back to the host."""
        E = self.i.shape[0]
        dev = self.i.device
        slot = torch.clamp(n_edges, max=E - 1).long().reshape(1)
        room = n_edges < E

        def put(old, value):
            if not isinstance(value, torch.Tensor):  # a fill, not a copy
                value = torch.full((), value, dtype=old.dtype, device=dev)
            row = torch.where(room, value.to(old.dtype), old.index_select(0, slot)[0])
            return old.index_copy(0, slot, row[None])

        new = EdgeList(
            i=put(self.i, i), j=put(self.j, j), T_meas=put(self.T_meas, T_meas),
            weight=put(self.weight, weight), valid=put(self.valid, True),
        )
        return new, n_edges + room.to(n_edges.dtype)
