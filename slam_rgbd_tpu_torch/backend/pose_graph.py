"""Pose-graph Gauss-Newton over keyframe poses (the loop-closure backend).

Counterpart of `slam_rgbd_tpu/backend/pose_graph.py` (without its
`psum_axis` argument, which belongs to the multi-device layer): a
fixed-capacity edge list (the odometry chain the keyframe insert writes, and
the loop constraints) and the solver. Residual per edge
r = log(T_meas^-1 T_i^-1 T_j) with the small-residual Jacobians J_j = I,
J_i = -Ad(T_j^-1 T_i) (right-multiplicative updates). The (6M, 6M) system
is assembled by block scatter-adds in a fixed order (`backend.ba.scatter_sum`)
and solved by a Jacobi-preconditioned conjugate gradient written out here,
in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from slam_rgbd_tpu_torch.backend.ba import scatter_sum
from slam_rgbd_tpu_torch.core import se3

CG_TOL = 1e-5
CG_MAXITER = 256
# the CG state stops changing once converged; the loop looks at the device's
# flag every this many iterations to leave early
_CG_CHECK_EVERY = 16


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


class PGResult(NamedTuple):
    poses: torch.Tensor  # (M, 4, 4) optimized
    rmse: torch.Tensor  # () residual RMSE over valid edges
    n_edges: torch.Tensor  # () valid edges


def conjugate_gradient(A: torch.Tensor, b: torch.Tensor, tol: float = CG_TOL,
                       maxiter: int = CG_MAXITER) -> torch.Tensor:
    """Solve the symmetric positive definite A x = b from a zero start, as
    `jax.scipy.sparse.linalg.cg` does: iterate while |r|^2 > tol^2 |b|^2, at
    most `maxiter` times. The iteration that finds the residual small enough
    freezes the state, so running past it changes nothing."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    gamma = torch.dot(r, r)
    atol2 = tol * tol * torch.dot(b, b)
    for k in range(maxiter):
        active = gamma > atol2
        if k % _CG_CHECK_EVERY == 0 and not bool(active):
            break
        Ap = A @ p
        alpha = gamma / torch.dot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        gamma_new = torch.dot(r_new, r_new)
        p_new = r_new + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
    return x


def _edge_residuals(T: torch.Tensor, edges: EdgeList):
    """(r (E, 6), T_i (E, 4, 4), T_j (E, 4, 4)) of every edge slot."""
    Ti = T[edges.i.long()]
    Tj = T[edges.j.long()]
    err = se3.inverse(edges.T_meas) @ se3.inverse(Ti) @ Tj
    return se3.log(err), Ti, Tj


def optimize_pose_graph(
    poses: torch.Tensor,  # (M, 4, 4) camera-to-world keyframe poses
    node_valid: torch.Tensor,  # (M,) bool
    edges: EdgeList,
    iters: int = 10,
    damping: float = 1e-6,
) -> PGResult:
    """Gauss-Newton with the first valid node fixed as gauge; invalid nodes
    and nodes without edges keep their poses."""
    M = poses.shape[0]
    D = 6 * M
    dev = poses.device
    nodes = torch.arange(M, device=dev)
    first = torch.where(node_valid, nodes, M).amin()
    free = node_valid & (nodes != first)
    fmask = free.repeat_interleave(6)
    fmask2 = fmask[:, None] & fmask[None, :]
    ew = (edges.weight * edges.valid.to(torch.float32))[:, None, None]
    ei, ej = edges.i.long(), edges.j.long()
    eye6 = torch.eye(6, device=dev)

    T = poses
    for _ in range(iters):
        r, Ti, Tj = _edge_residuals(T, edges)
        Ji = -se3.adjoint(se3.inverse(Tj) @ Ti)  # (E, 6, 6); J_j = I
        Jiw = Ji * ew
        Hii = Ji.transpose(-1, -2) @ Jiw
        Hjj = eye6 * ew
        Hij = Ji.transpose(-1, -2) * ew  # J_i^T w J_j
        gi = (Jiw.transpose(-1, -2) @ r[..., None])[..., 0]
        gj = r * ew[:, :, 0]

        Hb = scatter_sum(
            torch.cat([ei * M + ei, ej * M + ej, ei * M + ej, ej * M + ei]),
            torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]), M * M)
        g = scatter_sum(torch.cat([ei, ej]), torch.cat([gi, gj]), M)

        H = Hb.reshape(M, M, 6, 6).transpose(1, 2).reshape(D, D)
        H = torch.where(fmask2, H, 0.0)
        H = H + torch.diag(torch.where(fmask, damping, 1.0))
        gv = torch.where(fmask, g.reshape(D), 0.0)

        # Jacobi scaling, then CG: the damped GN system is symmetric positive
        # definite, and a GN step only needs an inexact solve
        d_scale = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(H), 1e-12))
        H_hat = H * d_scale[:, None] * d_scale[None, :]
        x = conjugate_gradient(H_hat, -gv * d_scale)
        d = (x * d_scale).reshape(M, 6)
        T = torch.where(free[:, None, None],
                        se3.normalize_rotation(T @ se3.exp(d)), T)

    r, _, _ = _edge_residuals(T, edges)
    n = edges.valid.sum()
    rmse = torch.sqrt(
        torch.sum(torch.where(edges.valid[:, None], r * r, 0.0))
        / torch.clamp_min(n, 1))
    return PGResult(poses=T, rmse=rmse, n_edges=n)
