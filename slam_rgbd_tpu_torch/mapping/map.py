"""Keyframe map: fixed-capacity, masked state held as tensors on one device.

Counterpart of `slam_rgbd_tpu/mapping/map.py`. The map is one dataclass of
fixed-capacity tensors with validity masks: no allocation after `empty_map`,
every update a scatter, nothing read back to the host.

Layout:
  * Keyframes: poses (M, 4, 4) camera-to-world + per-keyframe feature arrays
    (K keypoints each: pixel coords, camera-frame 3-D, descriptors).
  * Map points: world positions (P, 3) + a representative descriptor.
  * Observations: `point_id[m, j]` is the map point that keyframe m's
    keypoint j observes (-1 = none): the bipartite observation graph.
  * Covisibility: (M, M) shared-observation counts, kept up on insertion.

Unlike the reference's immutable pytree, `insert_keyframe` writes the
keyframe's rows of the per-keyframe arrays in place (the descriptor store is
64 MB at full capacity) and returns a state that shares them: the state
passed in must not be used afterwards. The per-point arrays are made anew.

Map-block sharding (the reference's `SLAMSession(cfg, mesh=)`, where GSPMD
partitions the programs over a point table sharded on the `model` axis):
with a `parallel.mesh.Block` (`blk`), every per-point array (`pt_*`) is this
rank's block of the table, rows `blk.start ..`, while the keyframe arrays,
the observation graph (global point ids) and the scalars are whole on every
rank. Each function that reads or writes the point table then works on its
block and joins the blocks with the group's collectives: an exact gather of
rows from their owners (`parallel.mesh.gather_rows`), or a sum of integer
counts. Every replicated output is the same on every rank and equal bit for
bit to the unsharded function's. `blk=None` is the whole table.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from slam_rgbd_tpu_torch.core import se3
from slam_rgbd_tpu_torch.core.config import KeyframeConfig
from slam_rgbd_tpu_torch.ops.hamming import gated_match
from slam_rgbd_tpu_torch.parallel.mesh import Block, all_sum, exclusive_prefix, gather_rows


@dataclass
class MapState:
    # --- keyframes ---------------------------------------------------------
    kf_pose: torch.Tensor  # (M, 4, 4) T_world_cam
    kf_time: torch.Tensor  # (M,) float32 seconds
    kf_valid: torch.Tensor  # (M,) bool
    n_kf: torch.Tensor  # () int32: slots used (append-only)
    # --- per-keyframe features --------------------------------------------
    kp_uv: torch.Tensor  # (M, K, 2) float32
    kp_pts: torch.Tensor  # (M, K, 3) camera-frame 3-D
    kp_ok: torch.Tensor  # (M, K) bool: has valid depth + detection
    kp_signs: torch.Tensor  # (M, K, 256) int8 descriptors
    # (M, 256) L2-normalized mean-of-signs place signature per keyframe,
    # kept up on insert
    kf_sig: torch.Tensor
    # --- map points --------------------------------------------------------
    pt_xyz: torch.Tensor  # (P, 3) world positions
    pt_signs: torch.Tensor  # (P, 256) int8 representative descriptor
    pt_nobs: torch.Tensor  # (P,) int32 observation count
    pt_valid: torch.Tensor  # (P,) bool
    pt_first_kf: torch.Tensor  # (P,) int32 keyframe slot at spawn (-1 = never)
    pt_last_kf: torch.Tensor  # (P,) int32 keyframe slot of last observation
    n_pt: torch.Tensor  # () int32: number of VALID points (slots recycle)
    # --- capacity-pressure counters ----------------------------------------
    pt_dropped: torch.Tensor  # () int32: spawns dropped for lack of capacity
    kf_dropped: torch.Tensor  # () int32: keyframes dropped at capacity
    # --- observation graph -------------------------------------------------
    point_id: torch.Tensor  # (M, K) int32: map-point index or -1
    covis: torch.Tensor  # (M, M) int32 shared-point counts

    @property
    def capacity_kf(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def capacity_pt(self) -> int:
        return self.pt_xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.kf_pose.device


def _group(blk: Block | None):
    return None if blk is None else blk.group


def empty_map(cfg: KeyframeConfig, n_keypoints: int, device,
              blk: Block | None = None) -> MapState:
    """An empty map; with `blk`, this rank's block of its point table."""
    M, K = cfg.max_keyframes, n_keypoints
    P = cfg.max_map_points if blk is None else blk.size

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def scalar():
        return torch.zeros((), dtype=torch.int32, device=device)

    return MapState(
        kf_pose=torch.eye(4, device=device).repeat(M, 1, 1),
        kf_time=zeros((M,)),
        kf_valid=zeros((M,), torch.bool),
        n_kf=scalar(),
        kp_uv=zeros((M, K, 2)),
        kp_pts=zeros((M, K, 3)),
        kp_ok=zeros((M, K), torch.bool),
        kp_signs=zeros((M, K, 256), torch.int8),
        kf_sig=zeros((M, 256)),
        pt_xyz=zeros((P, 3)),
        pt_signs=zeros((P, 256), torch.int8),
        pt_nobs=zeros((P,), torch.int32),
        pt_valid=zeros((P,), torch.bool),
        pt_first_kf=torch.full((P,), -1, dtype=torch.int32, device=device),
        pt_last_kf=torch.full((P,), -1, dtype=torch.int32, device=device),
        n_pt=scalar(),
        pt_dropped=scalar(),
        kf_dropped=scalar(),
        point_id=torch.full((M, K), -1, dtype=torch.int32, device=device),
        covis=zeros((M, M), torch.int32),
    )


def should_insert_keyframe(
    T_world_cam: torch.Tensor,
    T_world_last_kf: torch.Tensor,
    inlier_ratio: torch.Tensor,
    cfg: KeyframeConfig,
) -> torch.Tensor:
    """Keyframe decision: enough motion since the last keyframe, or tracking
    quality dropping. Returns a () bool tensor on the poses' device, or (B,)
    for (B, 4, 4) poses and (B,) ratios."""
    D = se3.inverse(T_world_last_kf) @ T_world_cam
    trans = torch.linalg.norm(D[..., :3, 3], dim=-1)
    cos_r = torch.clamp(
        (D[..., 0, 0] + D[..., 1, 1] + D[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    rot = torch.arccos(cos_r)
    return (
        (trans > cfg.kf_min_trans)
        | (rot > math.radians(cfg.kf_min_rot_deg))
        | (inlier_ratio < cfg.kf_min_inlier_ratio)
    )


def _set_row(buf: torch.Tensor, slot: torch.Tensor, row: torch.Tensor,
             room: torch.Tensor) -> None:
    """buf[slot] = row where `room`, in place; `slot` is a (1,) index tensor,
    so nothing is read back to the host."""
    old = buf.index_select(0, slot)
    buf.index_copy_(0, slot, torch.where(room, row.to(buf.dtype)[None], old))


def insert_keyframe(
    m: MapState,
    T_world_cam: torch.Tensor,
    timestamp,
    kp_uv: torch.Tensor,  # (K, 2)
    kp_pts: torch.Tensor,  # (K, 3) camera-frame
    kp_ok: torch.Tensor,  # (K,)
    kp_signs: torch.Tensor,  # (K, 256) int8
    match_pid: torch.Tensor,  # (K,) int32: map-point id each keypoint matched
    #                           to (-1 => spawn a new map point)
    blk: Block | None = None,
) -> MapState:
    """Append a keyframe; register observations; spawn new map points.

    All scatters have fixed shapes. Freed point slots (from `cull_points`)
    are recycled: new points go into invalid slots in ascending-index order.
    When capacity is exhausted the excess is dropped and counted in
    `pt_dropped` / `kf_dropped`.

    Where two keypoints observe one map point, the point's descriptor is the
    one of the keypoint with the higher index (the reference's scatter lets
    either win).

    With `blk`, the free slots are taken in the same global order: a
    block's free slots are the run of that order that starts after the free
    slots of the blocks before it (one all-gather of the counts), the owner
    of each spawn contributes its slot (one all-reduce), and each rank
    writes the rows of its own block.
    """
    M, K, Pl = m.capacity_kf, m.kp_uv.shape[1], m.capacity_pt
    P = Pl if blk is None else blk.total
    start, group = (0, None) if blk is None else (blk.start, blk.group)
    dev = m.device
    i32 = torch.int32
    idx = torch.clamp(m.n_kf, max=M - 1)
    slot = idx.long().reshape(1)
    room = m.n_kf < M
    match_pid = match_pid.to(i32)

    # ---- new map points for unmatched valid keypoints ---------------------
    is_new = kp_ok & (match_pid < 0)
    rank = torch.cumsum(is_new.to(i32), 0, dtype=i32) - 1  # rank among new points
    # Free-slot recycling: a stable argsort of the validity mask puts invalid
    # slots first in ascending index order; new point r takes free slot r.
    free_slots = torch.argsort(m.pt_valid.to(torch.uint8), stable=True).to(i32)
    n_free_here = Pl - m.pt_valid.sum().to(i32)
    before, n_free = exclusive_prefix(n_free_here, group)
    can_spawn = is_new & (rank < n_free)
    mine = can_spawn & (rank >= before) & (rank < before + n_free_here)
    local_slot = free_slots[torch.clamp(rank - before, 0, Pl - 1).long()] + start
    new_slot = all_sum(torch.where(mine, local_slot, 0), group)
    pid = torch.where(can_spawn, new_slot, match_pid)  # (K,) final ids
    pid = torch.where(kp_ok & (pid >= 0) & (pid < P), pid, -1)
    n_spawn_dropped = (is_new & ~can_spawn).sum().to(i32)

    # world position of this keyframe's keypoints
    pts_world = kp_pts @ T_world_cam[:3, :3].T + T_world_cam[:3, 3]

    # scatter new points (only where can_spawn); index Pl = dump slot
    local = pid - start
    here = (pid >= 0) & (local < Pl) & (local >= 0)  # ids of this block
    scatter_idx = torch.where(can_spawn & here, local, Pl).long()
    obs_idx = torch.where(here, local, Pl).long()  # every observed pid

    def with_dump(x):
        return torch.cat([x, torch.zeros((1,) + x.shape[1:], dtype=x.dtype, device=dev)])

    pt_xyz = with_dump(m.pt_xyz).index_copy_(0, scatter_idx, pts_world)[:Pl]
    # The representative descriptor refreshes on EVERY observation (newest
    # wins). Among several keypoints on one point the highest index wins:
    # an order-free maximum picks it, then one gather a point.
    winner = torch.full((Pl + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, obs_idx, torch.arange(K, device=dev), reduce="amax")[:Pl]
    seen = winner >= 0
    pt_signs = torch.where(seen[:, None], kp_signs[winner.clamp_min(0)], m.pt_signs)
    spawned = with_dump(torch.zeros_like(m.pt_valid)).index_fill_(0, scatter_idx, True)[:Pl]
    pt_valid = m.pt_valid | spawned
    pt_first_kf = torch.where(spawned, idx, m.pt_first_kf)
    pt_last_kf = torch.where(seen, idx, m.pt_last_kf)

    # observation counts: recycled slots restart at zero, then +1 per obs
    pt_nobs = with_dump(torch.where(spawned, 0, m.pt_nobs))
    pt_nobs = pt_nobs.index_add_(0, obs_idx, torch.ones(K, dtype=i32, device=dev))[:Pl]

    # ---- covisibility with existing keyframes -----------------------------
    # shared[m'] = |{j : point_id[m', j] observed by the new keyframe}| via
    # an indicator over the (global) point ids + one gather: O(M*K), not
    # O(M*K^2). The ids are on every rank, so the indicator needs no traffic.
    ind = torch.zeros((P + 1,), dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(pid >= 0, pid, P).long(), True)[:P]
    ind = torch.cat([ind, torch.zeros(1, dtype=torch.bool, device=dev)])
    gathered = ind[torch.where(m.point_id >= 0, m.point_id, P).long()]  # (M, K)
    shared = torch.where(m.kf_valid, gathered.sum(dim=1).to(i32), 0)  # (M,)

    # place signature of this keyframe (see MapState.kf_sig)
    sig_w = kp_ok.to(torch.float32)[:, None]
    sig_mean = (kp_signs.to(torch.float32) * sig_w).sum(dim=0) / torch.clamp_min(
        sig_w.sum(), 1.0)
    sig_norm = torch.linalg.norm(sig_mean)
    kf_sig_row = torch.where(
        sig_norm > 1e-6, sig_mean / torch.clamp_min(sig_norm, 1e-6), 0.0)

    # ---- write: rows of the per-keyframe arrays in place, where there is
    # room; at capacity nothing changes but the drop counter -----------------
    ts = timestamp
    if not isinstance(ts, torch.Tensor):  # a fill, not a copy from the host
        ts = torch.full((), float(ts), dtype=torch.float32, device=dev)
    for buf, row in (
        (m.kf_pose, T_world_cam), (m.kf_time, ts),
        (m.kf_valid, torch.ones((), dtype=torch.bool, device=dev)),
        (m.kp_uv, kp_uv), (m.kp_pts, kp_pts), (m.kp_ok, kp_ok),
        (m.kp_signs, kp_signs), (m.kf_sig, kf_sig_row), (m.point_id, pid),
    ):
        _set_row(buf, slot, row, room)
    # row then column of the covisibility matrix, as the reference sets them
    _set_row(m.covis, slot, shared, room)
    m.covis.index_copy_(
        1, slot, torch.where(room, shared[:, None], m.covis.index_select(1, slot)))

    def pick(new, old):
        return torch.where(room, new, old)

    room_i = room.to(i32)
    return dataclasses.replace(
        m,
        n_kf=m.n_kf + room_i,
        pt_xyz=pick(pt_xyz, m.pt_xyz),
        pt_signs=pick(pt_signs, m.pt_signs),
        pt_valid=pick(pt_valid, m.pt_valid),
        pt_nobs=pick(pt_nobs, m.pt_nobs),
        pt_first_kf=pick(pt_first_kf, m.pt_first_kf),
        pt_last_kf=pick(pt_last_kf, m.pt_last_kf),
        n_pt=pick(all_sum(pt_valid.sum().to(i32), group), m.n_pt),
        pt_dropped=m.pt_dropped + n_spawn_dropped * room_i,
        kf_dropped=m.kf_dropped + (1 - room_i),
    )


# The tight tier's gates: reprojection pixel radius, relative depth tolerance.
PX_RADIUS = 6.0
Z_REL_TOL = 0.08


def match_against_map(
    m: MapState,
    signs: torch.Tensor,  # (K, 256) int8 query descriptors
    ok: torch.Tensor,  # (K,) bool
    kp_uv: torch.Tensor,  # (K, 2) query keypoint pixels
    kp_z: torch.Tensor,  # (K,) query keypoint depths (camera frame)
    T_world_cam: torch.Tensor,  # (4, 4) current pose estimate
    cam=None,  # CameraIntrinsics
    px_radius: float = PX_RADIUS,
    z_rel_tol: float = Z_REL_TOL,
    max_distance: float = 64.0,
    kp_pts: torch.Tensor | None = None,  # (K, 3) camera-frame 3-D (merge tier)
    merge_radius: float = 0.05,
    merge_max_distance: float = 40.0,
) -> torch.Tensor:
    """Associate query keypoints to existing map points.

    Two tiers over one Hamming pass against all P map points
    (`ops.hamming.gated_match`: the kernel on CUDA tensors, its plain
    version on CPU tensors):

      1. *Tight* (the BA-observation gate): reprojection pixel distance
         < px_radius plus relative depth agreement.
      2. *Merge / spawn-suppression* (only when `kp_pts` is given): a
         stricter descriptor threshold (`merge_max_distance`) plus a tight
         3-D world-distance gate (`merge_radius`). A keypoint that fails the
         pixel gate but sits on an existing point in 3-D with a
         near-identical descriptor is a reobservation of that point.

    The projection of the map points and the two gate-data arrays are plain
    torch, outside the kernel. Returns (K,) int32 map-point ids, -1 if
    unmatched.
    """
    d1, i1, d2, i2 = association_candidates(
        m.pt_xyz, m.pt_signs, m.pt_valid, signs, ok, kp_uv, kp_z, T_world_cam,
        cam, px_radius, z_rel_tol, kp_pts, merge_radius)
    return association_ids(d1, i1, d2, i2, max_distance, merge_max_distance,
                           kp_pts is not None)


def association_candidates(pt_xyz, pt_signs, pt_valid, signs, ok, kp_uv, kp_z,
                           T_world_cam, cam, px_radius: float, z_rel_tol: float,
                           kp_pts, merge_radius: float):
    """The two tiers' winners of `match_against_map` over a table of points
    (the whole map, or one rank's block of it): (d1, i1, d2, i2), each (K,),
    distances and first indices into the table as `gated_match` returns
    them; the merge tier is off where `kp_pts` is None."""
    args, kw = association_inputs(pt_xyz, pt_signs, pt_valid, signs, ok, kp_uv, kp_z,
                                  T_world_cam, cam, px_radius, z_rel_tol, kp_pts,
                                  merge_radius)
    return gated_match(*args, **kw)


def association_inputs(pt_xyz, pt_signs, pt_valid, signs, ok, kp_uv, kp_z,
                       T_world_cam, cam, px_radius: float, z_rel_tol: float,
                       kp_pts, merge_radius: float):
    """What `association_candidates` hands `gated_match`: (args, keywords),
    the query and point signs with their gate data (the points projected
    into the query camera, the keypoints lifted into the world)."""
    K = signs.shape[0]
    # project the points into the query camera
    T_cw = se3.inverse(T_world_cam)
    p_c = pt_xyz @ T_cw[:3, :3].T + T_cw[:3, 3]  # (P, 3)
    z = p_c[:, 2]
    z_safe = torch.clamp_min(z, 1e-6)
    pu = cam.fx * p_c[:, 0] / z_safe + cam.cx
    pv = cam.fy * p_c[:, 1] / z_safe + cam.cy
    proj_ok = pt_valid & (z > cam.min_depth) & (z < cam.max_depth)

    if kp_pts is not None:
        pts_w = kp_pts @ T_world_cam[:3, :3].T + T_world_cam[:3, 3]  # (K, 3)
    else:
        pts_w = torch.zeros((K, 3), dtype=torch.float32, device=signs.device)

    f32 = torch.float32
    q_meta = torch.cat([
        kp_uv.to(f32), kp_z[:, None].to(f32), ok[:, None].to(f32), pts_w,
        (pts_w * pts_w).sum(dim=1, keepdim=True),
    ], dim=1)
    p_meta = torch.cat([
        pu[:, None], pv[:, None], z[:, None], proj_ok[:, None].to(f32),
        pt_xyz, (pt_xyz * pt_xyz).sum(dim=1, keepdim=True),
    ], dim=1)
    return (signs, q_meta, pt_signs, p_meta), dict(
        px_radius=px_radius, z_rel_tol=z_rel_tol,
        merge_radius=(merge_radius if kp_pts is not None else -1.0),
    )


def association_ids(d1, i1, d2, i2, max_distance: float, merge_max_distance: float,
                    merge: bool) -> torch.Tensor:
    """Map-point ids from the tiers' winners: the tight tier's where its
    distance is under `max_distance`, else (with `merge`) the merge tier's
    where under `merge_max_distance`, else -1."""
    pid = torch.where(d1 < max_distance, i1, -1)
    if merge:
        merge_pid = torch.where(d2 < merge_max_distance, i2, -1)
        pid = torch.where(pid >= 0, pid, merge_pid)
    return pid


def cull_points(m: MapState, current_kf_slot, min_obs: int = 2,
                max_age_kf: int = 3, blk: Block | None = None):
    """Cull under-observed map points; freed slots are recycled on insert.

    A point observed fewer than `min_obs` times that has not been
    re-observed within `max_age_kf` keyframes of its last observation is
    dropped. Keyframe slots are chronological (append-only), so slot
    distance == keyframe-count distance.

    Clears `point_id` references to culled points. `covis` keeps its (now
    slightly stale) shared counts. Returns (new_map, n_culled () int32).
    With `blk`, each rank culls its block, and the references and counts
    are joined over the group.
    """
    group = _group(blk)
    cull = (
        m.pt_valid
        & (m.pt_nobs < min_obs)
        & (current_kf_slot - m.pt_last_kf >= max_age_kf)
    )
    n_culled = all_sum(cull.sum().to(torch.int32), group)
    pt_valid = m.pt_valid & ~cull
    # drop observation-graph references to culled points
    ref_culled = gather_rows(cull, m.point_id, blk)
    new = dataclasses.replace(
        m,
        pt_valid=pt_valid,
        pt_nobs=torch.where(cull, 0, m.pt_nobs),
        point_id=m.point_id.masked_fill(ref_culled, -1),
        n_pt=all_sum(pt_valid.sum().to(torch.int32), group),
    )
    return new, n_culled


def local_window(m: MapState, window: int):
    """Indices of the most recent `window` keyframes (fixed shape).

    Returns (idx (window,) int32, valid (window,) bool): the sliding window
    over which local BA runs.
    """
    last = m.n_kf - 1
    offs = torch.arange(window, dtype=torch.int32, device=m.device)
    idx = last - (window - 1) + offs
    valid = (idx >= 0) & (idx < m.n_kf)
    return torch.clamp(idx, 0, m.capacity_kf - 1), valid


def map_point_count(m: MapState, blk: Block | None = None) -> torch.Tensor:
    """Number of valid map points, a () tensor on the map's device (with
    `blk`, summed over the blocks)."""
    return all_sum(m.pt_valid.sum(), _group(blk))
