"""Sharded programs over the (data, model) mesh: BA assembly, batched
tracking, map association, pose graph and descriptor matching.

Counterpart of `slam_rgbd_tpu/parallel/dist.py`. JAX runs each as one
`shard_map` program over all devices; here each rank calls the program with
its block of every argument that JAX's `in_specs` shard (`mesh.shard` cuts
it), and the whole of every replicated one. An output that JAX replicates is
returned whole and bit-identical on every rank (it comes out of an
all-reduce or an all-gather); an output that JAX shards is returned as the
rank's block (`mesh.gather` puts the blocks together).

  * `sharded_local_ba` - observation columns over `model`: `local_ba` with
    the axis's process group, every observation sum all-reduced, the small
    reduced-camera solve replicated.
  * `batch_track` - sequences over `data`: `icp_align_batched` (one batched
    GN kernel launch an iteration) on the rank's sequences; no traffic.
  * `sharded_map_association` - map points over `model` in blocks: the two
    gated tiers of `match_against_map` on the rank's block (the `gated_match`
    kernel on CUDA tensors), the block winners all-gathered and the first
    block with the least distance taken, so ties go to the lowest global
    point index as in the unsharded association.
  * `sharded_pose_graph` - edge slots over `model`: `optimize_pose_graph`
    with the axis's group, the (M, M, 6, 6) blocks all-reduced.
  * `sharded_hamming_match` - query rows over `model`: `hamming_top2` on the
    rank's rows and the ratio test; no traffic.
  * `sharded_map_match` - map points over `model` in blocks (the map-block
    sharded session's relocalization): `hamming_top2` over the rank's block
    of the map, the blocks' (best, second, index) triples merged exactly,
    and the cross-check on the block.
"""

from __future__ import annotations

import torch

from slam_rgbd_tpu_torch.backend.ba import BAResult, local_ba
from slam_rgbd_tpu_torch.backend.pose_graph import EdgeList, PGResult, optimize_pose_graph
from slam_rgbd_tpu_torch.core.config import BAConfig, CameraIntrinsics, ICPConfig
from slam_rgbd_tpu_torch.mapping.map import association_candidates, association_ids
from slam_rgbd_tpu_torch.odometry.icp import icp_align_batched
from slam_rgbd_tpu_torch.ops.hamming import Matches, hamming_top2
from slam_rgbd_tpu_torch.parallel.mesh import Block, gather, gather_rows, shard


# --------------------------------------------------------------------- BA
def sharded_local_ba(
    mesh,
    poses_wc: torch.Tensor,  # (W, 4, 4) replicated
    window_valid: torch.Tensor,  # (W,) replicated
    pt_xyz: torch.Tensor,  # (P, 3) replicated
    obs_uv: torch.Tensor,  # (W, K / n, 2): this rank's columns
    obs_z: torch.Tensor,  # (W, K / n)
    obs_pid: torch.Tensor,  # (W, K / n)
    obs_ok: torch.Tensor,  # (W, K / n)
    cam: CameraIntrinsics,
    cfg: BAConfig,
    free_mask: torch.Tensor | None = None,
    model_axis: str = "model",
) -> BAResult:
    """Local BA with the observation columns sharded over `model_axis`
    (`shard(obs, mesh, model_axis, dim=1)`). Every rank assembles its partial
    point blocks, camera blocks, coupling tensor and cost, the all-reduce
    completes them, and every rank runs the same solve and takes the same LM
    decision: the replicated result equals `local_ba` up to the order of
    the sums."""
    return local_ba(poses_wc, window_valid, pt_xyz, obs_uv, obs_z, obs_pid, obs_ok,
                    cam, cfg, free_mask=free_mask, group=mesh.get_group(model_axis))


# ----------------------------------------------------------------- tracking
def batch_track(
    mesh,
    src_pyrs: tuple,  # pyramid levels, every leaf (B / n, ...): this rank's sequences
    tgt_pyrs: tuple,
    T_init: torch.Tensor,  # (B / n, 4, 4)
    cam: CameraIntrinsics,
    cfg: ICPConfig,
    data_axis: str = "data",
):
    """Track this rank's block of the B sequences sharded over `data_axis`:
    `icp_align_batched` on its B / n problems, each GN iteration one batched
    kernel launch. Nothing moves between ranks. Returns the rank's block of
    (T, inliers, rmse, valid_fraction); each problem's result is the one it
    gets in an unsharded call."""
    res = icp_align_batched(src_pyrs, tgt_pyrs, T_init, cam, cfg)
    return res.T, res.inliers, res.rmse, res.valid_fraction


# ------------------------------------------------------- map-block sharding
def _first_min(x: torch.Tensor) -> torch.Tensor:
    """Index along dim 0 of the first least entry, for every other index."""
    n = x.shape[0]
    rows = torch.arange(n, device=x.device).reshape((n,) + (1,) * (x.dim() - 1))
    return torch.where(x <= x.amin(dim=0, keepdim=True), rows, n).amin(dim=0)


def sharded_map_association(
    mesh,
    signs: torch.Tensor,  # (K, 256) query descriptors, replicated
    ok: torch.Tensor,  # (K,)
    kp_uv: torch.Tensor,  # (K, 2)
    kp_z: torch.Tensor,  # (K,)
    T_world_cam: torch.Tensor,  # (4, 4)
    pt_xyz: torch.Tensor,  # (P / n, 3): this rank's block of the map
    pt_signs: torch.Tensor,  # (P / n, 256)
    pt_valid: torch.Tensor,  # (P / n,)
    cam: CameraIntrinsics,
    px_radius: float = 6.0,
    z_rel_tol: float = 0.08,
    max_distance: float = 64.0,
    kp_pts: torch.Tensor | None = None,  # (K, 3) camera-frame (merge tier)
    merge_radius: float = 0.05,
    merge_max_distance: float = 40.0,
    model_axis: str = "model",
) -> torch.Tensor:
    """Map association with the map's point table sharded over `model_axis`
    in equal blocks (rank i holds points i * P/n .. (i+1) * P/n - 1).

    Each rank runs both tiers of `mapping.map.match_against_map` on its
    block (one `gated_match` call) and offsets the winners' indices by the
    block's start. One all-gather of the (2, K) block winners (distances and
    indices) follows, and every rank takes, per query and tier, the first
    block with the least distance: the lowest global index among equals,
    which is what the unsharded first-index argmin returns. Returns (K,)
    int32 global map-point ids, -1 if unmatched, the same on every rank and
    equal to `match_against_map` on the whole map. `mesh=None`: the table
    is whole, and this is `match_against_map`.
    """
    d1, i1, d2, i2 = association_candidates(
        pt_xyz, pt_signs, pt_valid, signs, ok, kp_uv, kp_z, T_world_cam, cam,
        px_radius, z_rel_tol, kp_pts, merge_radius)
    dist_all = torch.stack([d1, d2])[None]  # (n, 2, K)
    idx_all = torch.stack([i1, i2])[None]
    if mesh is not None:
        base = mesh.get_local_rank(model_axis) * pt_xyz.shape[0]
        dist_all = gather(dist_all, mesh, model_axis)
        idx_all = gather(idx_all + base, mesh, model_axis)
    which = _first_min(dist_all)[None]  # (1, 2, K): the winning block
    best = dist_all.gather(0, which)[0]
    idx = idx_all.gather(0, which)[0]
    return association_ids(best[0], idx[0], best[1], idx[1], max_distance,
                           merge_max_distance, kp_pts is not None)


# ------------------------------------------------------------- pose graph
def edge_block(edges: EdgeList, mesh, model_axis: str = "model") -> EdgeList:
    """This rank's block of the edge slots (every field sharded on axis 0)."""
    return EdgeList(i=shard(edges.i, mesh, model_axis), j=shard(edges.j, mesh, model_axis),
                    T_meas=shard(edges.T_meas, mesh, model_axis),
                    weight=shard(edges.weight, mesh, model_axis),
                    valid=shard(edges.valid, mesh, model_axis))


def sharded_pose_graph(
    mesh,
    poses: torch.Tensor,  # (M, 4, 4) replicated
    node_valid: torch.Tensor,  # (M,) replicated
    edges: EdgeList,  # this rank's block of the edge slots (`edge_block`)
    iters: int = 10,
    damping: float = 1e-6,
    model_axis: str = "model",
) -> PGResult:
    """Pose-graph Gauss-Newton with the edge slots sharded over `model_axis`:
    each rank assembles the (M, M, 6, 6) normal-equation blocks of its edges,
    the all-reduce completes the system, and the solve is replicated. Equal
    to `optimize_pose_graph` on all the edges up to the order of the sums,
    and the same on every rank."""
    return optimize_pose_graph(poses, node_valid, edges, iters=iters, damping=damping,
                               group=mesh.get_group(model_axis))


# ----------------------------------------------------------------- matching
def sharded_hamming_match(
    mesh,
    signs1: torch.Tensor,  # (K1 / n, 256): this rank's query rows
    valid1: torch.Tensor,  # (K1 / n,)
    signs2: torch.Tensor,  # (K2, 256) replicated
    valid2: torch.Tensor,  # (K2,)
    max_distance: float = 64.0,
    ratio: float = 0.9,
    model_axis: str = "model",
):
    """All-pairs Hamming matching with the query rows sharded over
    `model_axis`: `hamming_top2` on this rank's rows (the kernel on CUDA
    tensors), then the ratio test. Returns the rank's block of (idx2 int32,
    best distance, ok): idx2 is the first column at the least distance and
    `second` (the least over the other columns, a tie with the best
    included) is what `top_k(-d, 2)` gives second, so ok = best <
    max_distance & best < ratio * second & valid1 as in the JAX program.
    Nothing moves between ranks."""
    best, second, idx = hamming_top2(signs1, valid1, signs2, valid2)
    ok = (best < max_distance) & (best < ratio * second) & valid1
    return idx, best, ok


def sharded_map_match(
    blk: Block | None,
    signs1: torch.Tensor,  # (K1, 256) query descriptors, replicated
    valid1: torch.Tensor,  # (K1,)
    signs2: torch.Tensor,  # (P / n, 256): this rank's block of the map
    valid2: torch.Tensor,  # (P / n,)
    max_distance: float = 64.0,
    ratio: float = 0.9,
) -> Matches:
    """`features.match.match` (mutual nearest, ratio test) of the query rows
    against a point table sharded in blocks (`blk`), equal on every rank and
    to the unsharded match.

    Each rank runs `hamming_top2` on its block (the kernel on CUDA tensors);
    one all-gather of the blocks' (best, second, first index) follows. The
    global best is the first block with the least best (the lowest global
    index among equals, as the unsharded first-index argmin), and the
    second best is the least of the winner's second and the other blocks'
    bests: the least over every column but the argmin. The cross-check runs
    `hamming_top2` the other way on the block's rows (each map point's
    nearest query row), and the matched points' answers are gathered from
    their owners. Two launches a rank, as two a call unsharded. `blk=None`:
    the table is whole, and this is `features.match.match`."""
    best, second, idx = hamming_top2(signs1, valid1, signs2, valid2)
    d_all = torch.stack([best, second])[None]  # (n, 2, K1)
    i_all = idx[None]  # (n, K1)
    if blk is not None:
        d_all = gather(d_all, blk.mesh, blk.axis)
        i_all = gather(i_all + blk.start, blk.mesh, blk.axis)
    win = _first_min(d_all[:, 0])[None]  # (1, K1): the winning block
    best_g = d_all[:, 0].gather(0, win)[0]
    idx_g = i_all.gather(0, win)[0]
    blocks = torch.arange(d_all.shape[0], device=best.device)[:, None]
    others = torch.where(blocks == win, float("inf"), d_all[:, 0]).amin(dim=0)
    second_g = torch.minimum(d_all[:, 1].gather(0, win)[0], others)
    ok = (best_g < max_distance) & (best_g < ratio * second_g) & valid1
    rows = torch.arange(signs1.shape[0], device=signs1.device)
    _, _, idx_rev = hamming_top2(signs2, valid2, signs1, valid1)
    ok = ok & (gather_rows(idx_rev, idx_g, blk) == rows)
    return Matches(idx1=rows.to(torch.int32), idx2=idx_g, distance=best_g, valid=ok)
