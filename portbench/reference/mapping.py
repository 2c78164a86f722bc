"""A keyframe's association and insert in plain torch: the two-tier gated
Hamming match against the map's points (pixel radius and depth agreement at
the keyframe's pose; or a stricter descriptor threshold with a 3-D merge
radius), the spawn of new points into the free slots in ascending order,
and their world positions. A frozen copy of the port's semantics; the
products go through `precision`."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import se3
from portbench.reference.precision import mm

BIG = 1e9
PX_RADIUS = 6.0
Z_REL_TOL = 0.08
MERGE_MAX_DISTANCE = 40.0


def _f32(x: float) -> float:
    return float(np.float32(x))


def _first_argmin(d: torch.Tensor):
    best = d.min(dim=1, keepdim=True).values
    col = torch.arange(d.shape[1], device=d.device)
    idx = torch.where(d <= best, col, d.shape[1]).min(dim=1).values
    return best[:, 0], idx


def gated_match(signs, q_meta, pt_signs, p_meta, merge_radius: float):
    """Per query: the least Hamming distance and its first point index in
    each tier -> (d1, i1, d2, i2)."""
    px2, tol, mr2 = _f32(PX_RADIUS * PX_RADIUS), _f32(Z_REL_TOL), _f32(
        merge_radius * merge_radius)
    q = q_meta.unbind(1)
    p = p_meta.unbind(1)
    s = mm(signs.to(torch.float32), pt_signs.to(torch.float32).T)
    d = 0.5 * (signs.shape[-1] - s)
    d = torch.where((q[3][:, None] > 0.5) & (p[3][None, :] > 0.5), d, BIG)
    du = q[0][:, None] - p[0][None, :]
    dv = q[1][:, None] - p[1][None, :]
    z_ok = torch.abs(q[2][:, None] - p[2][None, :]) < (tol * torch.clamp_min(q[2], 0.3)[:, None])
    d1 = torch.where((du * du + dv * dv < px2) & z_ok, d, BIG)
    cross = (q[4][:, None] * p[4][None, :] + q[5][:, None] * p[5][None, :]
             + q[6][:, None] * p[6][None, :])
    dist2 = q[7][:, None] + p[7][None, :] - 2.0 * cross
    d2 = torch.where(dist2 < mr2, d, BIG)
    b1, i1 = _first_argmin(d1)
    b2, i2 = _first_argmin(d2)
    return b1, i1, b2, i2


def associate(pt_xyz, pt_signs, pt_valid, uv, signs, pts, ok, T_wc, cam,
              max_distance: float, merge_radius: float) -> torch.Tensor:
    """(K,) map-point id of each keypoint, -1 where none passes."""
    T_cw = se3.inverse(T_wc)
    p_c = mm(pt_xyz, T_cw[:3, :3].T) + T_cw[:3, 3]
    z = p_c[:, 2]
    z_safe = torch.clamp_min(z, 1e-6)
    pu = cam.fx * p_c[:, 0] / z_safe + cam.cx
    pv = cam.fy * p_c[:, 1] / z_safe + cam.cy
    proj_ok = pt_valid & (z > cam.min_depth) & (z < cam.max_depth)
    pts_w = mm(pts, T_wc[:3, :3].T) + T_wc[:3, 3]
    f32 = torch.float32
    q_meta = torch.cat([uv.to(f32), pts[:, 2:3].to(f32), ok[:, None].to(f32), pts_w,
                        (pts_w * pts_w).sum(dim=1, keepdim=True)], dim=1)
    p_meta = torch.cat([pu[:, None], pv[:, None], z[:, None], proj_ok[:, None].to(f32),
                        pt_xyz, (pt_xyz * pt_xyz).sum(dim=1, keepdim=True)], dim=1)
    d1, i1, d2, i2 = gated_match(signs, q_meta, pt_signs, p_meta, merge_radius)
    pid = torch.where(d1 < max_distance, i1, -1)
    return torch.where(pid >= 0, pid, torch.where(d2 < MERGE_MAX_DISTANCE, i2, -1))


def insert_ids(match_pid, ok, pt_valid) -> torch.Tensor:
    """The keyframe's observation row: matched ids, and for every other
    valid keypoint the free slot it spawns into (free slots in ascending
    order, in keypoint order; -1 once the table is full)."""
    P = pt_valid.shape[0]
    is_new = ok & (match_pid < 0)
    rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
    free_slots = torch.argsort(pt_valid.to(torch.uint8), stable=True)
    n_free = P - int(pt_valid.sum())
    can_spawn = is_new & (rank < n_free)
    new_slot = free_slots[torch.clamp(rank, 0, P - 1)]
    pid = torch.where(can_spawn, new_slot, match_pid.to(torch.int64))
    return torch.where(ok & (pid >= 0) & (pid < P), pid, -1)


def world_points(pts, T_wc) -> torch.Tensor:
    """Camera-frame keypoints (K, 3) into the world."""
    return mm(pts, T_wc[:3, :3].T) + T_wc[:3, 3]
