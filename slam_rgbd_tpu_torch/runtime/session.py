"""SLAM session: per-frame tracking, keyframes, the backend, relocalization.

Counterpart of `slam_rgbd_tpu/runtime/session.py`:

    frame -> pyramid -> ICP track (dense, every frame)
          -> keyframe decision -> [features -> map match -> insert
          -> odometry edge -> cull -> backend pass]      (on a keyframe)
          -> lost? -> [features -> map-wide match -> 3D-3D solve]

Every keyframe runs the feature stage, associates its keypoints with the map
(`ops.hamming.gated_match`), inserts itself and its new points, appends the
odometry edge and culls under-observed points. Then a backend pass
(`backend.worker.backend_pass`): local BA, the loop search and verification
(`ops.hamming.hamming_top2`), the pose graph, and after an accepted loop
landmark fusion and a global BA. It runs inline, or with
`async_backend=True` on the worker thread, which on a CUDA device has its
own stream; its result merges at the start of a later frame
(`_apply_backend`). A lost frame is relocalized against the whole map
(`hamming_top2`, both directions, then a robust 3D-3D solve), on the first
lost frame and then every fourth.

Decision pipelining as in the reference: frame t queues its tracking and a
(4,) control summary on the device and starts an asynchronous copy of the
summary to pinned host memory, marked by a CUDA event. The decisions of
frame t are applied at the start of the next call, after that call's frame
has been uploaded and before it is tracked. The reference applies them once
the summary has landed, which on a local device is the next call, and
bounds the lag by `runtime.max_decision_lag` for a high-latency link; a
card has no such link, so the port waits for the summary instead. The host
thus runs at most one frame ahead of the card: with the frame graph it
queues a frame faster than the card runs one, and a decision that waited
for its summary to land by itself would fall up to the bound behind, where
the decisions computed before the newest insert resolved are suppressed and
keyframes thin out. The card idles only while the host resolves and queues
the replay. A keyframe insert does not wait on the device: the host mirrors
the keyframe count. A relocalization has one blocking fetch (its (4,)
stats), and so has the merge of a backend result (its guard's three
scalars); an inline backend pass has those of `backend_pass`.

On a CUDA device the steady-state frame (pyramid, track, control summary,
ring writes) is one CUDA graph replay (`runtime.frame_graph.FrameGraph`),
the counterpart of the reference's single jitted `_steady_step`; the eager
step is its plain version (the CPU's path, and the card's with
`cuda_graph=False`). The pose state it reads (`T_world`, `motion`,
`last_kf_T`) is written in place only. Under the same switch the feature
stage of a keyframe insert and of a relocalization (`_features`) is one
replay of a second graph (`runtime.frame_graph.FeatureGraph`), captured by
`warmup()` or else at the first insert, and kept by `reset()`; the replay
returns clones of its outputs, which a later replay does not overwrite.
`BatchSession` and `benchmarks.py` run the eager `_features`.

Map-block sharded mode (`mesh=` with a `model` axis above 1): each rank is
a process holding its block of the point table (every `pt_*` array; the
keyframe arrays and the scalars are whole on every rank) and runs the same
session on the same frames. The association, insert, cull, relocalization,
backend pass, merge and point count join the blocks over the `model` group
(`mapping.map`, `parallel.dist`), exactly, so every rank makes the same
decisions and the result equals the unsharded session's bit for bit. Each
rank resolves a frame at the next call, as the unsharded session does.

The threaded sharded session (`async_backend=True` with such a mesh) runs
each rank's worker on the rank's block. The worker's collectives go over a
process group of its own over the same ranks (`parallel.mesh.axis_group`,
with a timeout of `WORKER_TIMEOUT`), so they never interleave with the
frontend's. The ranks agree on every merge: while a job is in the worker,
each call starts one all-reduce (MIN) over a small gloo group of the same
ranks of whether this rank's pass has ended, and the next call reads it
(the all-reduce runs in between, so no call waits on the other ranks). Only
when every rank's pass had ended does any rank take its result, so every
rank merges at the same call; until then a rank whose pass ended early keeps
it pending, the worker looks busy on every rank, and every rank queues,
displaces and promotes the same jobs. The drain in `sync_backend` agrees
the same way at once, and a drain that times out on one rank raises on
every rank. The all-reduce runs on the host and never waits on the card.

Frames from the host (numpy arrays) go up through a ring of pinned buffers
(`runtime.staging.PinnedStaging`) without waiting for the device; frames
that are already tensors are used where they lie. With `metrics` (a
`runtime.profiling.MetricsLog`), every `runtime.metrics_every_frames` frames
the session logs a `frame_window` record and every merged backend result a
`backend` record, with the reference's keys. A `frame_window` record waits
for its map point count, copied from the device without blocking, and is
logged at the first call that finds the copy landed (on the CPU, at once).

Spans (`runtime.profiling.StageTimer`, the session's `timer`, which
outlives `reset()` as the metrics sink does): each call is a
`session.frame` span whose call id is the frame index, with the children
`session.upload`, `session.decide` (the previous frame's decisions: its
`session.wait` for the summary, and a keyframe's `session.insert`, whose
children are `session.insert.features` and `session.insert.map`, the
K3 association, insert and cull of `_kf_insert`) and `session.track` (the
graph replay or eager step); the backend worker records its
`worker.queue` into the same timer (`backend.worker`). A sink made with `MetricsLog(spans=True)` keeps
them; a recording `torch.profiler` sees them as host ranges.

Two faults of the reference arrive with the backend, and the port matches
both: the fusion thresholds are hard-coded (`backend.worker`), and
`_fuse_merge` clears every reference to a ghost duplicate instead of
re-pointing it at the landmark it duplicated. `_fuse_merge` also counts the
fused observations into `covis`, which retires the closed pair from
`find_loop_candidate` (its `max_covis` gate): the single session closes a
pair once, where the batch session, which has no fusion, closes it again
after every cooldown.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from slam_rgbd_tpu_torch.backend import worker as bworker
from slam_rgbd_tpu_torch.backend.pose_graph import EdgeList
from slam_rgbd_tpu_torch.core import camera, se3
from slam_rgbd_tpu_torch.core.config import (
    CameraIntrinsics, ICPConfig, KeyframeConfig, ORBConfig, SLAMConfig,
)
from slam_rgbd_tpu_torch.eval.trajectory import save_trajectory_tum
from slam_rgbd_tpu_torch.features import detect as fdetect
from slam_rgbd_tpu_torch.features import orb as forb
from slam_rgbd_tpu_torch.features.pose3d import solve_pose3d
from slam_rgbd_tpu_torch.mapping import map as smap
from slam_rgbd_tpu_torch.odometry.icp import track_frame
from slam_rgbd_tpu_torch.parallel import dist as pdist
from slam_rgbd_tpu_torch.parallel import mesh as pmesh
from slam_rgbd_tpu_torch.runtime.frame_graph import FeatureGraph, FrameGraph
from slam_rgbd_tpu_torch.runtime.profiling import StageTimer
from slam_rgbd_tpu_torch.runtime.staging import PinnedStaging, upload_plain

log = logging.getLogger("slam_rgbd_tpu_torch.session")


def _features(depth_raw, rgb, orb: ORBConfig, cam: CameraIntrinsics):
    """The whole feature stage: detect + describe + keypoint depth.
    -> (Keypoints, Descriptors, pts (K, 3), ok (K,))."""
    intensity = camera.rgb_to_intensity(rgb) / 255.0
    kp, pyr = fdetect.detect_pyramid(
        intensity,
        n_features=orb.n_features,
        n_levels=orb.n_levels,
        scale_factor=orb.scale_factor,
        threshold=orb.fast_threshold,
        min_threshold=orb.fast_min_threshold,
    )
    desc = forb.describe(kp, pyr, orb.scale_factor)
    depth_m = camera.depth_to_metres(depth_raw, cam)
    pts, ok = forb.keypoint_depth(kp, depth_m, cam)
    return kp, desc, pts, ok & kp.valid


def _frame_summary(T_world, last_kf_T, valid_fraction, rmse,
                   kcfg: KeyframeConfig) -> torch.Tensor:
    """The per-frame control scalars in one (4,) tensor: inlier fraction,
    ICP rmse, pose finiteness, keyframe decision."""
    finite = torch.isfinite(T_world).all()
    should = smap.should_insert_keyframe(T_world, last_kf_T, valid_fraction, kcfg)
    return torch.stack([
        valid_fraction.to(torch.float32), rmse.to(torch.float32),
        finite.to(torch.float32), should.to(torch.float32),
    ])


def _steady_step(
    prev_pyr, depth_raw, rgb, T_world, motion, last_kf_T,
    buf_T, buf_kfT, traj_i: torch.Tensor,
    cam: CameraIntrinsics, icp_cfg: ICPConfig, kcfg: KeyframeConfig,
):
    """One steady-state frame: pyramid, coarse-to-fine track, control
    summary, and the trajectory-ring writes at the device scalar `traj_i`
    (in place, as the reference donates its ring buffers and traces the
    slot). -> (pyramid, new T_world, new motion, summary)."""
    pyr = camera.build_frame_pyramid(depth_raw, cam, levels=icp_cfg.levels, rgb=rgb)
    T_world, motion, res = track_frame(prev_pyr, pyr, T_world, motion, cam, icp_cfg)
    summary = _frame_summary(T_world, last_kf_T, res.valid_fraction, res.rmse, kcfg)
    slot = traj_i.reshape(1)
    buf_T.index_copy_(0, slot, T_world[None])
    buf_kfT.index_copy_(0, slot, last_kf_T[None])
    return pyr, T_world, motion, summary


def _kf_insert(m, edges, n_edges, kp_uv, signs, pts, ok, T_pose, ts,
               prev_kf_idx: int, kf_idx: int, cfg: SLAMConfig, blk=None):
    """The keyframe-insert device stage: map association (two-tier gated
    match at the keyframe's own pose), keyframe / point insertion, the
    odometry edge, and point culling. Nothing is read back to the host.

    `prev_kf_idx < 0` (the bootstrap keyframe) has no map to match against
    and no edge to add; both indices are host integers, so that is a host
    branch. With `blk` (`m` holding this rank's block of the point table),
    the association joins the blocks' winners
    (`parallel.dist.sharded_map_association`) and the insert and cull work
    on the block.
    """
    kcfg = cfg.keyframes
    has_map = prev_kf_idx >= 0
    if has_map:
        match_pid = pdist.sharded_map_association(
            None if blk is None else blk.mesh, signs, ok, kp_uv, pts[:, 2], T_pose,
            m.pt_xyz, m.pt_signs, m.pt_valid, cfg.camera,
            max_distance=float(cfg.orb.match_threshold), kp_pts=pts,
            merge_radius=kcfg.merge_radius, model_axis=cfg.mesh.model_axis,
        )
    else:
        match_pid = torch.full((signs.shape[0],), -1, dtype=torch.int32,
                               device=signs.device)
    m = smap.insert_keyframe(m, T_pose, ts, kp_uv, pts, ok, signs, match_pid, blk=blk)
    last_kf_T = m.kf_pose[kf_idx].clone()

    if has_map:
        # odometry edge between consecutive keyframes
        T_rel = se3.inverse(m.kf_pose[prev_kf_idx]) @ T_pose
        edges, n_edges = edges.add(n_edges, prev_kf_idx, kf_idx, T_rel, 1.0)

    n_culled = torch.zeros((), dtype=torch.int32, device=signs.device)
    if kcfg.cull_min_obs > 0:
        m, n_culled = smap.cull_points(
            m, kf_idx, min_obs=kcfg.cull_min_obs, max_age_kf=kcfg.cull_max_age_kf,
            blk=blk,
        )
    return m, edges, n_edges, last_kf_T, n_culled


def _reloc(m, signs, ok, pts, T_est, cfg: SLAMConfig, generator=None, blk=None):
    """The relocalization solve: map-wide descriptor match, robust 3D-3D
    solve, consensus gate, and the implied rigid correction
    C = T_fixed T_est^-1. -> (T_fixed, C, stats (4,) = [accept, inliers,
    n_valid, |t(C)|]), all on the device. With `blk`, the match runs over
    the map's blocks and the matched points are gathered from their
    owners."""
    mt = pdist.sharded_map_match(blk, signs, ok, m.pt_signs, m.pt_valid,
                                 max_distance=float(cfg.orb.match_threshold))
    target = pmesh.gather_rows(m.pt_xyz, mt.idx2, blk)
    res = solve_pose3d(pts, target, mt.valid & ok, iters=8, generator=generator)
    # consensus gate: a relocalization that explains under half of its own
    # matches is an aliased solution (repeated texture)
    accept = res.ok & (res.inliers >= 0.5 * res.n_valid.to(torch.float32))
    T_fixed = se3.normalize_rotation(res.T)
    C = T_fixed @ se3.inverse(T_est)
    stats = torch.stack([
        accept.to(torch.float32),
        res.inliers.to(torch.float32),
        res.n_valid.to(torch.float32),
        torch.linalg.norm(C[:3, 3]),
    ])
    return T_fixed, C, stats


def _fuse_merge(m, snap: int, cand: int, fuse_row, ghost, delta, n_fused: int,
                blk=None):
    """Merge a loop's landmark fusion (`backend.worker._loop_fuse_program`)
    into the live map: re-point the query keyframe's observation row, clear
    every reference to a ghost duplicate (keyframes inserted after the
    snapshot may have re-observed one: the flag pass covers their rows too),
    update the observation counts, and count the fused observations into
    the pair's covisibility, which retires the pair from
    `find_loop_candidate`. Clearing rather than re-pointing the ghost
    references is the reference's behaviour, kept as it is. With `blk`,
    `ghost` and `delta` are this rank's block."""
    pid = m.point_id.clone()
    pid[snap] = fuse_row
    pid = pid.masked_fill(pmesh.gather_rows(ghost, pid, blk), -1)
    pt_valid = m.pt_valid & ~ghost
    nobs = torch.where(ghost, 0, torch.clamp_min(m.pt_nobs + delta, 0))
    covis = m.covis.clone()
    covis[snap, cand] += n_fused
    covis[cand, snap] += n_fused
    return dataclasses.replace(
        m, point_id=pid, pt_valid=pt_valid, pt_nobs=nobs,
        n_pt=pmesh.all_sum(pt_valid.sum().to(torch.int32),
                           None if blk is None else blk.group),
        covis=covis,
    )


def _traj_correct(buf_T: torch.Tensor, start: int, C: torch.Tensor) -> None:
    """Left-multiply the rigid correction C onto ring entries [start:), in
    place (a relocalization rewrites the poses logged since the lost
    frame)."""
    buf_T[start:] = C @ buf_T[start:]


@dataclass
class FrameStats:
    timestamp: float
    track_ms: float
    inlier_fraction: float
    icp_rmse: float
    is_keyframe: bool
    tracking_ok: bool
    ba_rmse_px: float = 0.0
    loop_closed: bool = False


@dataclass
class SessionState:
    """Host-visible session status."""

    frames: int = 0
    keyframes: int = 0
    loops: int = 0
    lost: int = 0
    relocalized: int = 0
    last_heartbeat: float = field(default_factory=time.monotonic)
    running: bool = True
    # frame count at which each loop-closure result merged into the live
    # state (threaded: the call that polled it)
    loop_merge_frames: list = field(default_factory=list)


@dataclass
class _PendingFrame:
    """A frame whose control decisions are still in flight."""

    summary: torch.Tensor  # (4,) on the host (pinned when the device is CUDA)
    event: "torch.cuda.Event | None"  # completes when `summary` has landed
    st: FrameStats
    ts: float
    depth_raw: torch.Tensor  # the frame, on the device: a keyframe insert
    rgb: torch.Tensor  # or a relocalization takes its features from it
    traj_i: int  # ring slot of this frame's logged pose
    frame_i: int
    # (4, 4) this frame's pose on the device; a relocalization composes its
    # correction onto it
    T: torch.Tensor

    def values(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return self.summary.tolist()


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the session was asked for a CUDA device but torch sees none; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class SLAMSession:
    """RGB-D SLAM session over one sequence.

    Call `process_frame(ts, depth_raw, rgb)` per frame, then `poses()` /
    `keyframe_poses()` / `save_trajectory()` and `stats`. The session runs
    on the CUDA device unless the caller asks for `device="cpu"`; without a
    card the default raises. On CUDA the session turns TF32 off for matrix
    products and cuDNN, since the 6x6 solves, pose products and the
    backend's Schur and CG products need full float32.

    `async_backend=False` runs the backend pass inline after each keyframe
    insert (deterministic); True hands it to a `BackendWorker` thread and
    merges its results at the start of later frames. Call `close()` (or
    `sync_backend()`) to drain it. `metrics`: an optional
    `runtime.profiling.MetricsLog` for the `frame_window` and `backend`
    records, and, if it keeps spans, those of `timer`.

    `cuda_graph`: run the steady-state frame and the keyframe's feature
    stage as CUDA graph replays (the default on a CUDA device; True on the
    CPU raises); False runs both eagerly. `mesh`: a `torch.distributed`
    `DeviceMesh` (`parallel.mesh.make_mesh`); with a `model` axis above 1
    the session holds this rank's block of the point table, and every rank
    of the axis must drive its session with the same frames and calls
    (map-block sharded mode), the backend inline or threaded. A mesh without a `model` axis, or with one
    of size 1, is the unsharded path.
    """

    # rows of the trajectory ring at the start; it doubles when full
    traj_capacity = 4096

    def __init__(self, config: SLAMConfig, async_backend: bool = False,
                 device="cuda", metrics=None, mesh=None, cuda_graph=None):
        self.cfg = config
        self.device = _resolve_device(device)
        self.metrics = metrics
        self.timer = StageTimer(metrics)
        self.mesh = mesh
        self._blk = None
        axis = config.mesh.model_axis
        if (mesh is not None and axis in (mesh.mesh_dim_names or ())
                and mesh.size(mesh.mesh_dim_names.index(axis)) > 1):
            self._blk = pmesh.model_block(mesh, config.keyframes.max_map_points, axis)
        # threaded and sharded: the worker's block (the session's with the
        # worker's own group) and the host group of the per-call agreement,
        # made once (`_worker_groups`) and kept by `reset()`
        self._worker_blk = None
        self._host_group = None
        if cuda_graph is None:
            cuda_graph = self.device.type == "cuda"
        elif cuda_graph and self.device.type != "cuda":
            raise ValueError(f"cuda_graph=True needs a CUDA device, not {self.device}")
        self._graph = FrameGraph(self.device) if cuda_graph else None
        self._feature_graph = FeatureGraph(self.device, functools.partial(
            _features, orb=config.orb, cam=config.camera)) if cuda_graph else None
        # host frames: the plain copy on the CPU; on a card a ring of two
        # pinned slots, one for the pending frame and one for the frame
        # uploaded before it resolves
        self._staging = None
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            self._staging = PinnedStaging(self.device, n_slots=2)
        self.async_backend = async_backend
        self.worker = None
        # the pose state and the trajectory ring (pose and reference-keyframe
        # pose per frame, fetched once in `poses()`, and the slot of the
        # frame being tracked): static tensors, written in place only (the
        # frame graph reads them), set by `_fresh`
        self.T_world, self.motion, self.last_kf_T = (
            torch.empty((4, 4), device=self.device) for _ in range(3))
        self._traj_cap = self.traj_capacity
        self._traj_T = torch.empty((self._traj_cap, 4, 4), device=self.device)
        self._traj_kfT = torch.empty_like(self._traj_T)
        self._traj_i = torch.empty((), dtype=torch.int64, device=self.device)
        self._fresh()

    def _fresh(self):
        """A fresh session's state: the map, the edges, the host-side
        bookkeeping and the backend worker anew, the static tensors set in
        place."""
        cfg = self.cfg
        self.state = SessionState()
        self.stats: list[FrameStats] = []
        self.map = smap.empty_map(cfg.keyframes, self._kp_capacity(), self.device,
                                  self._blk)
        self.edges = EdgeList.empty(4 * cfg.keyframes.max_keyframes, self.device)
        self.n_edges = torch.zeros((), dtype=torch.int32, device=self.device)
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        for T in (self.T_world, self.motion, self.last_kf_T):
            T.copy_(eye)
        self._traj_T.zero_()
        self._traj_kfT.zero_()
        self._traj_i.zero_()
        self._traj_ts: list[float] = []
        self._frame_kf_idx: list[int] = []  # reference keyframe slot per frame
        self.last_kf_idx = -1
        self.prev_pyr = None
        # Host mirror of the map's keyframe count: insertion drops at
        # capacity deterministically, so the host never reads `map.n_kf`
        # back from the device.
        self._n_kf_host = 0
        # Consecutive low-quality frames; relocalization is attempted on
        # the 1st and then every 4th (it has a blocking fetch, and the
        # odometry fallback is usually within centimetres anyway).
        self._lost_streak = 0
        self._pending: Optional[_PendingFrame] = None  # the previous frame
        self._frame_i = 0
        self._last_kf_frame_i = -(10 ** 9)
        # the backend: inline, or on the worker thread
        self.worker = None
        if self.async_backend:
            self._worker_groups()
            self.worker = bworker.BackendWorker(cfg, self.device, self._worker_blk,
                                                timer=self.timer)
        self._last_loop_kf = -(10 ** 9)
        # Loop-merge generation: bumped when a loop-closure result merges
        # (the pose graph rewrites every keyframe). Jobs are stamped with it;
        # a job or result of an older generation is dropped, since its
        # verbatim pose merge would revert the loop correction.
        self._loop_gen = 0
        # the job of the newest insert, submitted at the start of the next
        # frame: the insert and the backend pass land in different frame
        # slots, so no frame waits behind a whole keyframe burst
        self._deferred_job: Optional[bworker.BackendJob] = None
        # threaded and sharded: the agreement the last call started
        self._agreement = None
        # a frame_window record waiting for its map point count to land
        self._window = None

    def _worker_groups(self):
        """A threaded sharded session's process groups over its `model`
        ranks, unless it holds them already: the worker's (the backend's
        collectives, on the session's backend) and a gloo one for the
        per-call agreement. Collective over the whole world (`new_group`):
        every rank makes them at the same call."""
        if self._blk is None or self._worker_blk is not None:
            return
        axis = self._blk.axis
        group = pmesh.axis_group(self.mesh, axis, timeout=pmesh.WORKER_TIMEOUT)
        self._host_group = pmesh.axis_group(self.mesh, axis, backend="gloo")
        self._worker_blk = dataclasses.replace(self._blk, group=group)

    def _agreement_start(self):
        """Start the agreement of the threaded sharded session: a MIN
        all-reduce over the host group of this rank's (no pass in flight, a
        result pending, no result pending), in the background. -> what
        `_agreement_end` takes."""
        idle, pending = self.worker.ended()
        flags = torch.tensor([idle, pending, not pending], dtype=torch.int32)
        work = torch.distributed.all_reduce(
            flags, op=torch.distributed.ReduceOp.MIN, group=self._host_group,
            async_op=True)
        return work, flags, idle

    def _agreement_end(self, work, flags, idle_here: bool):
        """-> (every rank's pass had ended when the agreement started, the
        result to merge). A rank takes its result only when every rank's
        pass has ended (a pass that ended stays pending until taken, so it
        is still there); a result that some rank lacks (its pass failed) is
        dropped on every rank. `idle_here`: this rank's own flag."""
        work.wait()
        all_idle, all_pending, none_pending = flags.tolist()
        if not all_idle:
            if idle_here:
                log.debug("backend result held: a pass on another rank has not ended")
            return False, None
        r = self.worker.poll()
        if not (all_pending or none_pending):
            log.error("backend result dropped: the pass failed on another rank")
            self.worker.skipped += 1
            r = None
        return True, r

    def _agree_pending(self):
        """Merge what the agreement started at the previous call settled,
        if one was started."""
        started, self._agreement = self._agreement, None
        if started is not None:
            self._apply_backend(self._agreement_end(*started)[1])

    def _stop_worker(self):
        """Drain and stop the backend worker; its process groups stay."""
        if self.worker is not None:
            try:
                self.sync_backend()
            finally:
                self.worker.stop()
                self.worker = None

    # ------------------------------------------------------------- warmup
    def warmup(self):
        """Run every device path of the session once, up front: the backend
        programs (a pass without and with BA, fusion and its merge, the
        global BA, a loop-edge append), the kernel build, the tracking
        step, the keyframe insert with and without a map, the
        relocalization solve (whose batched SVD loads a solver library at
        first use), the trajectory correction, a backend merge, and on a
        card the pinned ring of host frames at the camera's shape and the
        captures of the frame graph and the feature graph (all kept by
        `reset()`). Must run on a fresh session; ends with `reset()`.
        """
        cfg = self.cfg
        cam = cfg.camera
        eye = torch.eye(4, device=self.device)
        blk = self._blk
        for n_kf in (0, 3):
            bworker.backend_pass(self.map, self.edges, self.n_edges, 0, cfg,
                                 n_kf=n_kf, allow_loop=True, blk=blk)
        pid, row, ghost, delta, _ = bworker._loop_fuse_program(self.map, 0, 0, eye, blk)
        _fuse_merge(self.map, 0, 0, row, ghost, delta, 0, blk)
        if cfg.ba.global_ba_iters > 0:
            bworker._global_ba_program(self.map.kf_pose, self.map.pt_xyz, pid,
                                       self.map, cfg, blk)
        self.edges.add(self.n_edges, 0, 1, eye, 5.0)
        # a textured sloped plane: valid geometry and FAST corners
        yy, xx = np.meshgrid(np.arange(cam.height), np.arange(cam.width), indexing="ij")
        depth = (1800.0 + 2.0 * xx + 1.5 * yy).astype(np.uint16)
        rgb = np.broadcast_to(
            (((xx // 8 + yy // 8) % 2) * 160 + 48).astype(np.uint8)[..., None],
            (cam.height, cam.width, 3),
        ).copy()
        depth_t, rgb_t = self._upload(depth), self._upload(rgb)
        self.process_frame(0.0, depth_t, rgb_t)  # bootstrap keyframe
        self.process_frame(1.0 / 30, depth_t, rgb_t)  # steady step (+ its capture)
        self.flush_pipeline()
        # keyframes against an existing map: association + merge tiers; the
        # third makes the backend pass run its BA
        for ts in (2.0 / 30, 3.0 / 30):
            self._keyframe(ts, depth_t, rgb_t, self.T_world)
            self.sync_backend()
        self._relocalize(depth_t, rgb_t)
        _traj_correct(self._traj_T, 0, eye)
        # a merge whose snapshot poses are the live ones: C = I
        self._apply_backend(bworker.BackendResult(
            snap_kf_idx=self.last_kf_idx, kf_pose=self.map.kf_pose,
            pt_xyz=self.map.pt_xyz,
            pt_adjusted=torch.zeros_like(self.map.pt_valid),
            generation=self._loop_gen))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reset()

    # -------------------------------------------------------------- utils
    def _kp_capacity(self) -> int:
        """Total keypoint slots after per-level budget rounding."""
        orb = self.cfg.orb
        return sum(fdetect._per_level_budget(
            orb.n_features, orb.n_levels, orb.scale_factor))

    def _features(self, depth_t, rgb_t):
        """The feature stage of a frame on the device: the feature graph's
        replay, or the eager `_features`."""
        if self._feature_graph is not None:
            return self._feature_graph.run(depth_t, rgb_t)
        return _features(depth_t, rgb_t, self.cfg.orb, self.cfg.camera)

    # ------------------------------------------------------------- inputs
    def _upload(self, x) -> torch.Tensor:
        """A frame array onto the session's device (uint16 depth as int32).
        A tensor stays where it is if it is there already; a host array on a
        card goes through the pinned ring and does not wait for the
        stream."""
        if isinstance(x, torch.Tensor) or self._staging is None:
            return upload_plain(x, self.device)
        return self._staging.upload(np.asarray(x))

    # ---------------------------------------------------------- main loop
    def process_frame(self, ts: float, depth_raw, rgb) -> FrameStats:
        """Track one frame (depth in sensor units, RGB uint8), after
        resolving the previous frame's decisions."""
        t0 = time.monotonic()
        with self.timer.section("session.frame", call=self._frame_i):
            st = self._process(ts, depth_raw, rgb)
        return self._finish(st, t0)

    def _process(self, ts: float, depth_raw, rgb) -> FrameStats:
        timer = self.timer
        # this frame goes up first, so that its copy is queued while the
        # host waits for the previous frame's summary
        with timer.section("session.upload"):
            depth_t = self._upload(depth_raw)
            rgb_t = self._upload(rgb)
        if self.worker is not None:
            # merge finished backend work first: a snapshot then holds every
            # earlier correction. `advance` promotes a waiting job after the
            # merge, so the generation gate sees the merged state; then the
            # deferred job of the last insert goes in. Sharded, a result
            # merges only once every rank's pass has ended, by the agreement
            # the previous call started; while a job is in the worker, each
            # call starts the next one (its all-reduce runs meanwhile, so
            # no call waits for the other ranks).
            if self._host_group is None:
                self._apply_backend(self.worker.poll())
            else:
                self._agree_pending()
            self.worker.advance(self._loop_gen, self._allow_loop)
            if self._deferred_job is not None:
                job, self._deferred_job = self._deferred_job, None
                self.worker.submit(job)
            if self._host_group is not None and self.worker.busy():
                self._agreement = self._agreement_start()
        with timer.section("session.decide"):
            self.flush_pipeline()  # the previous frame's decisions

        if self.prev_pyr is None:
            # first frame: bootstrap a keyframe at the current pose, unless
            # state was loaded into the session, where only the tracking
            # reference needs anchoring
            pyr = camera.build_frame_pyramid(
                depth_t, self.cfg.camera, levels=self.cfg.icp.levels, rgb=rgb_t
            )
            self.prev_pyr = pyr if self._graph is None else self._graph.adopt_pyramid(pyr)
            st = FrameStats(ts, 0.0, 1.0, 0.0, True, True)
            if self._n_kf_host == 0:
                self._last_kf_frame_i = self._frame_i
                self._keyframe(ts, depth_t, rgb_t, self.T_world)
            self._log_pose(ts)
            self._frame_i += 1
            return st

        traj_i = len(self._traj_ts)
        if traj_i >= self._traj_cap:
            self._grow_traj_ring()  # (the graph is captured again)
        self._traj_i.fill_(traj_i)
        with timer.section("session.track"):
            if self._graph is None:
                self.prev_pyr, T, motion, summary = self._step(self.prev_pyr, depth_t,
                                                               rgb_t)
                self.T_world.copy_(T)
                self.motion.copy_(motion)
            else:
                # the frame's own depth / rgb are copied into the graph's
                # input, and its pose cloned after the replay: later replays
                # overwrite neither
                summary = self._graph.run(
                    self._step, (depth_t, rgb_t),
                    (self.T_world, self.motion, self.last_kf_T),
                    (self._traj_T, self._traj_kfT), self._traj_i, self.prev_pyr)
                T = self.T_world.clone()
        self._traj_ts.append(ts)
        self._frame_kf_idx.append(self.last_kf_idx)
        st = FrameStats(ts, 0.0, -1.0, -1.0, False, True)  # until it lands
        self._pending = _PendingFrame(
            *self._fetch_async(summary), st=st, ts=ts, depth_raw=depth_t,
            rgb=rgb_t, traj_i=traj_i, frame_i=self._frame_i, T=T,
        )
        self._frame_i += 1
        return st

    def _step(self, prev_pyr, depth_t, rgb_t):
        """The eager steady-state frame on the session's state (what the
        frame graph captures): -> (pyramid, T_world, motion, summary)."""
        return _steady_step(
            prev_pyr, depth_t, rgb_t, self.T_world, self.motion, self.last_kf_T,
            self._traj_T, self._traj_kfT, self._traj_i,
            self.cfg.camera, self.cfg.icp, self.cfg.keyframes,
        )

    def _fetch_async(self, summary: torch.Tensor):
        """Start the summary's copy to the host; (host tensor, event)."""
        if self.device.type == "cpu":
            return summary, None
        host = torch.empty(summary.shape, dtype=summary.dtype, pin_memory=True)
        host.copy_(summary, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def _resolve_entry(self, e: _PendingFrame):
        """Apply one frame's control decisions."""
        with self.timer.section("session.wait"):
            vf, rmse, finite, should = e.values()
        e.st.inlier_fraction = vf
        e.st.icp_rmse = rmse
        e.st.tracking_ok = vf > 0.25 and finite > 0.5

        if not e.st.tracking_ok:
            self.state.lost += 1
            self._lost_streak += 1
            if self._lost_streak != 1 and self._lost_streak % 4 != 0:
                # odometry-only fallback between rate-limited reloc tries
                log.warning(
                    "tracking degraded at t=%.3f (inliers %.2f); integrating "
                    "odometry", e.ts, vf,
                )
                return
            log.warning(
                "tracking lost at t=%.3f (inliers %.2f); relocalizing", e.ts, vf
            )
            T_fixed, C = self._relocalize(e.depth_raw, e.rgb, T_est=e.T)
            if T_fixed is not None:
                self.state.relocalized += 1
                e.st.tracking_ok = True
                self._lost_streak = 0
                self.motion.copy_(torch.eye(4, device=self.device))
                # rigid correction from the lost frame's estimate; applies
                # to the live pose and the frame's logged one
                e.T = T_fixed
                self.T_world.copy_(se3.normalize_rotation(C @ self.T_world))
                _traj_correct(self._traj_T, e.traj_i, C)
                should = 1.0 if self._should_insert(vf) else 0.0
            # on a failed reloc we keep integrating (odometry-only fallback)
        else:
            self._lost_streak = 0

        gap_ok = (
            e.frame_i - self._last_kf_frame_i
            >= self.cfg.keyframes.kf_min_gap_frames
        )
        if e.st.tracking_ok and should > 0.5 and gap_ok:
            e.st.is_keyframe = True
            self._last_kf_frame_i = e.frame_i
            kf_stats = self._keyframe(e.ts, e.depth_raw, e.rgb, e.T)
            e.st.ba_rmse_px = kf_stats.get("ba_rmse", 0.0)
            e.st.loop_closed = kf_stats.get("loop", False)

    def _should_insert(self, inlier_ratio: float) -> bool:
        ratio = torch.full((), inlier_ratio, device=self.device)
        return bool(smap.should_insert_keyframe(
            self.T_world, self.last_kf_T, ratio, self.cfg.keyframes))

    # ----------------------------------------------------------- keyframe
    def _keyframe(self, ts, depth_t, rgb_t, T_pose) -> dict:
        """A keyframe: the insert, then its backend pass. -> {"ba_rmse",
        "loop"} of an inline pass, {} otherwise."""
        with self.timer.section("session.insert"):
            kf_idx = self._insert_keyframe(ts, depth_t, rgb_t, T_pose)
            return {} if kf_idx is None else self._backend(kf_idx)

    def _insert_keyframe(self, ts, depth_t, rgb_t, T_pose=None) -> Optional[int]:
        """Insert a keyframe observed at pose `T_pose` (the frame's own pose
        estimate: under decision pipelining the live `T_world` has already
        advanced past it); the device stage only, no backend pass. Returns
        the new keyframe's slot, or None at capacity."""
        if T_pose is None:
            T_pose = self.T_world
        M = self.cfg.keyframes.max_keyframes
        if self._n_kf_host >= M:
            log.warning("keyframe capacity %d reached; insert dropped", M)
            return None
        with self.timer.section("session.insert.features"):
            kp, desc, pts, ok = self._features(depth_t, rgb_t)
        prev_kf_idx = self.last_kf_idx
        kf_idx = self._n_kf_host
        with self.timer.section("session.insert.map"):
            self.map, self.edges, self.n_edges, last_kf_T, _n_culled = _kf_insert(
                self.map, self.edges, self.n_edges, kp.uv, desc.signs, pts, ok,
                T_pose, float(ts), prev_kf_idx, kf_idx, self.cfg, self._blk,
            )
            self.last_kf_T.copy_(last_kf_T)
        self._n_kf_host += 1
        self.last_kf_idx = kf_idx
        self.state.keyframes += 1
        return kf_idx

    # ------------------------------------------------------------ backend
    def _backend(self, kf_idx: int) -> dict:
        """The backend pass of the keyframe in slot `kf_idx`: inline, merged
        at once, or as a job for the worker, deferred to the next frame
        (its snapshot is a copy: the next insert writes the map in place)."""
        job = bworker.BackendJob(
            map=self.map, edges=self.edges, n_edges=self.n_edges, kf_idx=kf_idx,
            n_kf=self._n_kf_host, allow_loop=self._allow_loop(kf_idx),
            generation=self._loop_gen, call=self._frame_i,
        )
        if self.worker is not None:
            job.map, job.ready = bworker.snapshot(self.map)
            if self._deferred_job is not None:  # superseded before submit
                self.worker.skipped += 1
            self._deferred_job = job
            return {}
        res = bworker.backend_pass(
            job.map, job.edges, job.n_edges, job.kf_idx, self.cfg,
            n_kf=job.n_kf, allow_loop=job.allow_loop, blk=self._blk,
        )
        # an inline result is never stale: it carries the current generation
        res.generation = job.generation
        self._apply_backend(res)
        return {"ba_rmse": res.ba_rmse, "loop": res.loop_closed}

    def _apply_backend(self, r: Optional[bworker.BackendResult]):
        """Merge a finished backend pass into the live state.

        Keyframe slots up to the snapshot take the result's poses verbatim;
        everything anchored after it (the live pose, newer keyframes, points
        spawned since, pending frame estimates) takes the rigid correction
        C of the snapshot's newest keyframe. Points that existed at the
        snapshot take the result's rows where the pass adjusted them.
        """
        if r is None:
            return
        if r.generation < self._loop_gen:
            # computed from a snapshot older than a merged loop closure: its
            # poses would revert the pose-graph correction
            log.info("stale backend result (KF%d) dropped: snapshot predates loop "
                     "merge (gen %d < %d)", r.snap_kf_idx, r.generation, self._loop_gen)
            if self.worker is not None:
                self.worker.skipped += 1
            return
        snap = r.snap_kf_idx
        m = self.map
        C = se3.normalize_rotation(r.kf_pose[snap] @ se3.inverse(m.kf_pose[snap]))
        # bounded-merge guard: a result with non-finite poses or a rigid
        # correction far beyond plausible drift is dropped whole; the next
        # pass runs on an intact map
        c_finite, c_move, poses_finite = torch.stack([
            torch.isfinite(C).all().to(torch.float32), torch.linalg.norm(C[:3, 3]),
            torch.isfinite(r.kf_pose).all().to(torch.float32),
        ]).tolist()
        if c_finite < 0.5 or c_move > 2.0 or poses_finite < 0.5:
            log.error("backend result rejected: poses non-finite or correction "
                      "implausible (|t|=%.2f m); dropping merge",
                      c_move if c_finite > 0.5 else float("nan"))
            return

        slot = torch.arange(m.capacity_kf, device=self.device)
        kf_pose = torch.where((slot <= snap)[:, None, None], r.kf_pose, C @ m.kf_pose)
        existed = m.pt_first_kf <= snap
        # finite poses with a non-finite point row must not poison the map
        pt_finite = torch.isfinite(r.pt_xyz).all(dim=-1)
        use_ba = r.pt_adjusted & m.pt_valid & existed & pt_finite
        pt_xyz = torch.where(use_ba[:, None], r.pt_xyz, m.pt_xyz)
        spawned_after = m.pt_valid & ~existed
        pt_xyz = torch.where(spawned_after[:, None], pt_xyz @ C[:3, :3].T + C[:3, 3],
                             pt_xyz)
        self.map = dataclasses.replace(m, kf_pose=kf_pose, pt_xyz=pt_xyz)

        if r.loop_edge is not None:
            i, j, T_rel, weight = r.loop_edge
            self.edges, self.n_edges = self.edges.add(self.n_edges, i, j, T_rel,
                                                      weight=weight)
            if r.fuse_row is not None:
                self.map = _fuse_merge(self.map, snap, i, r.fuse_row, r.pt_invalidate,
                                       r.pt_nobs_delta, r.n_fused, self._blk)
            self.state.loops += 1
            self.state.loop_merge_frames.append(self.state.frames)
            self._last_loop_kf = max(self._last_loop_kf, snap)
            self._loop_gen += 1  # older snapshots can no longer merge
        self.T_world.copy_(se3.normalize_rotation(C @ self.T_world))
        # the pending estimate inherited the pre-merge anchor; a keyframe
        # inserted from it must land in the corrected frame
        if self._pending is not None:
            self._pending.T = C @ self._pending.T
        if self.last_kf_idx >= 0:
            self.last_kf_T.copy_(self.map.kf_pose[self.last_kf_idx])
        if self.metrics is not None:
            self.metrics.log(
                "backend", kf=snap, ba_rmse=round(r.ba_rmse, 3),
                backend_ms=round(r.backend_ms, 2), loop=r.loop_closed,
            )

    def _allow_loop(self, kf_idx: int) -> bool:
        """The loop-closure cooldown, against the current `_last_loop_kf`
        (evaluated again when a waiting job is promoted)."""
        return kf_idx - self._last_loop_kf >= self.cfg.ba.loop_cooldown_kf

    def sync_backend(self, timeout: float = 30.0, final_pass: bool = False):
        """Drain the pipeline and the backend worker, merging results.

        `final_pass=True` also runs one inline backend pass over the drained
        map: under replace-with-newest the last keyframes of a burst may
        otherwise never get a BA / loop pass. Threaded and sharded, every
        rank drains alike (an agreement for each job), and a pass that has
        not ended on some rank within `timeout` raises `TimeoutError` on
        every rank."""
        self.flush_pipeline()
        self._log_window()
        if self.worker is not None:
            if self._deferred_job is not None:
                job, self._deferred_job = self._deferred_job, None
                self.worker.submit(job)
            deadline = time.monotonic() + timeout
            if self._host_group is not None:
                self._drain_agreed(deadline, timeout)
            else:
                self._apply_backend(self.worker.poll())
                self.worker.advance(self._loop_gen, self._allow_loop)
                while self.worker.busy():
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        log.error("sync_backend drain timed out")
                        break
                    self._apply_backend(self.worker.flush(remaining))
                    self.worker.advance(self._loop_gen, self._allow_loop)
        if final_pass and self._n_kf_host >= 3:
            res = bworker.backend_pass(
                self.map, self.edges, self.n_edges, self.last_kf_idx, self.cfg,
                n_kf=self._n_kf_host, allow_loop=self._allow_loop(self.last_kf_idx),
                blk=self._blk,
            )
            res.generation = self._loop_gen
            self._apply_backend(res)

    def _drain_agreed(self, deadline: float, timeout: float):
        """The threaded sharded session's drain: every rank merges the same
        results at the same steps (the worker's state agrees across ranks,
        so the loop turns alike everywhere)."""
        self._agree_pending()
        while True:
            self.worker.wait(max(deadline - time.monotonic(), 0.0))
            ended, r = self._agreement_end(*self._agreement_start())
            if not ended:
                raise TimeoutError(
                    f"sync_backend: a rank's backend pass did not end within {timeout} s")
            self._apply_backend(r)
            self.worker.advance(self._loop_gen, self._allow_loop)
            if not self.worker.busy():
                return

    def close(self):
        """Stop the backend worker (its in-flight job is drained first), then
        leave the worker's process groups of a threaded sharded session. A
        waiting `frame_window` record is logged first."""
        self._log_window()
        try:
            self._stop_worker()
        finally:
            if self._worker_blk is not None:
                for group in (self._worker_blk.group, self._host_group):
                    torch.distributed.destroy_process_group(group)
                self._worker_blk = self._host_group = None

    def flush_pipeline(self):
        """Finalize the pending frame's decisions and stats."""
        e, self._pending = self._pending, None
        if e is not None:
            self._resolve_entry(e)

    def _finish(self, st: FrameStats, t0: float) -> FrameStats:
        st.track_ms = (time.monotonic() - t0) * 1e3
        self.state.frames += 1
        self.state.last_heartbeat = time.monotonic()
        self.stats.append(st)
        if self.metrics is not None:
            self._frame_window()
        return st

    def _frame_window(self):
        """Every `runtime.metrics_every_frames` frames, a `frame_window`
        record; it is logged once its map point count has landed."""
        if self._window is not None and self._window[2].query():
            self._log_window()
        every = self.cfg.runtime.metrics_every_frames
        if not every or self.state.frames % every:
            return
        self._log_window()  # (its count landed long ago)
        recent = self.stats[-every:]
        mean_ms = sum(s.track_ms for s in recent) / len(recent)
        # the newest frame's inlier fraction is still in flight
        # (placeholder -1): the mean is over the resolved ones
        inl = [s.inlier_fraction for s in recent if s.inlier_fraction >= 0]
        fields = dict(
            frames=self.state.frames,
            fps=round(1e3 / max(mean_ms, 1e-6), 2),
            mean_track_ms=round(mean_ms, 3),
            inlier_fraction=round(sum(inl) / max(len(inl), 1), 4),
            keyframes=self.state.keyframes,
            map_points=None,  # set when the count lands
            loops=self.state.loops,
            lost=self.state.lost,
        )
        count = smap.map_point_count(self.map, self._blk)
        self._window = (fields, *self._fetch_async(count))
        if self._window[2] is None:  # on the CPU the count is there
            self._log_window()

    def _log_window(self):
        """Log the waiting `frame_window` record with its map point count,
        waiting for the count if it has not landed."""
        w, self._window = self._window, None
        if w is not None:
            fields, count, event = w
            if event is not None:
                event.synchronize()
            fields["map_points"] = int(count)
            self.metrics.log("frame_window", **fields)

    def _grow_traj_ring(self):
        pad = torch.zeros((self._traj_cap, 4, 4), device=self.device)
        self._traj_T = torch.cat([self._traj_T, pad])
        self._traj_kfT = torch.cat([self._traj_kfT, pad])
        self._traj_cap *= 2

    def _log_pose(self, ts: float):
        i = len(self._traj_ts)
        if i >= self._traj_cap:
            self._grow_traj_ring()
        self._traj_ts.append(ts)
        self._frame_kf_idx.append(self.last_kf_idx)
        self._traj_T[i] = self.T_world
        self._traj_kfT[i] = self.last_kf_T

    # -------------------------------------------------------- reloc/reset
    def _relocalize(self, depth_t, rgb_t, T_est=None):
        """Match the frame's features against all map points; solve 3D-3D.

        Returns `(T_fixed, C)`, the relocalized camera-to-world pose and the
        rigid correction `C = T_fixed @ T_est^-1`, or `(None, None)` on
        failure. One host fetch, of the solve's packed gate scalars; the
        caller applies C. A single lost frame can only be centimetres off,
        so a relocalization demanding a metre-scale jump is an aliased
        solve and is rejected here."""
        if self._n_kf_host == 0:
            return None, None
        if T_est is None:
            T_est = self.T_world
        _, desc, pts, ok = self._features(self._upload(depth_t), self._upload(rgb_t))
        T_fixed, C, stats = _reloc(self.map, desc.signs, ok, pts, T_est, self.cfg,
                                   blk=self._blk)
        accept, inliers, n_valid, jump = stats.tolist()  # the one blocking fetch
        if accept < 0.5:
            return None, None
        if jump > 1.0:
            log.warning("relocalization rejected: implied %.2f m jump", jump)
            return None, None
        log.info("relocalized with %d/%d inliers", int(inliers), int(n_valid))
        return T_fixed, C

    def reset(self):
        """Full reset: a fresh session on the same config, backend mode,
        device, metrics sink, span recorder (`timer`), mesh (a sharded
        session keeps its blocks) and frame mode; the worker, if any, is
        drained and stopped first. What a session allocates once is kept:
        the pinned upload ring (a slot's event still guards its last copy),
        the frame graph with its memory pool, the static tensors it reads,
        which are set to a fresh session's values in place (a grown ring
        keeps its size), the feature graph, and the worker's process
        groups."""
        self._stop_worker()
        self._log_window()
        self._fresh()

    # ------------------------------------------------------------ outputs
    def _traj_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(timestamps, frame poses, reference keyframe slot a frame, that
        keyframe's pose when the frame was logged): the raw trajectory log,
        read back from the device ring."""
        n = len(self._traj_ts)
        return (
            np.asarray(self._traj_ts),
            self._traj_T[:n].cpu().numpy(),
            np.asarray(self._frame_kf_idx, dtype=np.int32),
            self._traj_kfT[:n].cpu().numpy(),
        )

    def _restore_traj(self, ts, T, kf_idx, kfT):
        """Inverse of `_traj_arrays` (checkpoint restore)."""
        n = len(ts)
        cap = self.traj_capacity
        while cap < n:
            cap *= 2
        self._traj_cap = cap
        self._traj_ts = [float(t) for t in ts]
        self._frame_kf_idx = [int(i) for i in kf_idx]
        self._traj_T = torch.zeros((cap, 4, 4), device=self.device)
        self._traj_kfT = torch.zeros((cap, 4, 4), device=self.device)
        self._traj_T[:n] = torch.as_tensor(np.asarray(T, np.float32), device=self.device)
        self._traj_kfT[:n] = torch.as_tensor(np.asarray(kfT, np.float32),
                                             device=self.device)

    def poses(self) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps (n,), camera-to-world poses (n, 4, 4)).

        The pipeline and the backend are drained first. Each frame pose is
        re-anchored to its reference keyframe's CURRENT (optimized) pose:
        T = T_kf_now @ (T_kf_then^-1 @ T_frame_then).
        """
        self.sync_backend()
        ts, traj_T, kf_idx, kf_T_then = self._traj_arrays()
        n = len(ts)
        if n == 0:
            return ts, np.zeros((0, 4, 4), np.float32)
        # batched rigid inverse of the reference-keyframe poses
        R = kf_T_then[:, :3, :3]
        t = kf_T_then[:, :3, 3]
        inv = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        inv[:, :3, :3] = R.transpose(0, 2, 1)
        inv[:, :3, 3] = -np.einsum("nji,nj->ni", R, t)
        kf_pose_now = self.map.kf_pose.cpu().numpy()
        anchor = kf_pose_now[np.maximum(kf_idx, 0)]
        out = np.einsum("nij,njk,nkl->nil", anchor, inv, traj_T)
        return ts, np.where((kf_idx >= 0)[:, None, None], out, traj_T)

    def keyframe_poses(self) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps (k,), camera-to-world poses (k, 4, 4)) of the
        keyframes inserted so far, after the backend has drained."""
        self.sync_backend()
        n = self._n_kf_host
        return (self.map.kf_time[:n].cpu().numpy(),
                self.map.kf_pose[:n].cpu().numpy())

    def map_point_count(self) -> int:
        """Number of valid map points (one fetch; sharded: a collective)."""
        return int(smap.map_point_count(self.map, self._blk))

    def save_trajectory(self, path: str):
        """TUM-format full trajectory (`SaveTrajectoryTUM` parity)."""
        ts, T = self.poses()
        save_trajectory_tum(path, ts, T)

    def save_keyframe_trajectory(self, path: str):
        """TUM-format keyframe trajectory (`SaveKeyFrameTrajectoryTUM`)."""
        ts, T = self.keyframe_poses()
        save_trajectory_tum(path, ts, T)


# the name the tracking-only slice gave the session
TrackingSession = SLAMSession
