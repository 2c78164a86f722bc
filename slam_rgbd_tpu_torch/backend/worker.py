"""Backend of the single session: local BA and loop closure, inline or on a
worker thread off the tracking path.

Counterpart of `slam_rgbd_tpu/backend/worker.py`. The frontend (per-frame
tracking and keyframe insertion) hands each new keyframe to a backend pass:
sliding-window local BA, the loop-candidate search, geometric verification,
the consistency gate, the pose graph with the per-anchor point correction,
and after an accepted loop the landmark fusion and a global BA. The pass
reads a map snapshot and returns a `BackendResult`; the session merges it
(`SLAMSession._apply_backend`). Inline and threaded modes run the same
`backend_pass`, so the thread changes latency, not the maths.

Queue discipline, as in the reference: at most one job in flight, one
latest waiting job (a newer submit replaces it and counts a skip), one
pending result; the frontend merges a finished result before it inserts the
next keyframe, and promotes the waiting job (`advance`) after the merge, so
a job stamped before the last loop merge is dropped instead of promoted.

What differs from the reference, and why:

  * Snapshots. The reference's map is an immutable pytree, so a snapshot
    is a reference. The port's `mapping.map.insert_keyframe` writes the
    keyframe-side tensors of the live map in place, so a threaded job owns
    a copy of the whole map (`snapshot`, a device copy of ~80 MB at the
    Astra profile's capacities). The inline pass needs none.
  * Streams. On a CUDA device the worker runs its passes on a stream of its
    own. A job carries an event recorded on the frontend's stream after its
    copy, and the worker's stream waits on it. A pass ends by synchronizing
    the worker's stream (it blocks the worker thread only), so a result is
    complete when the frontend takes it, and a job's tensors are read no
    more when they are dropped. `poll` / `flush` mark the result's tensors
    as used on the caller's stream (`record_stream`), so that their memory
    does not go back to the worker's stream while a frontend kernel may
    still read it.
  * One read-back a pass. The reference gates verification and the pose
    graph with `lax.cond` inside one program and reads back one packed (12,)
    stats vector. Here verification runs whenever the loop search is allowed
    and a candidate can exist at all (`kf_idx > loop_min_interval`), and its
    statistics are masked by the candidate gate on the device; the pass then
    reads the same packed vector once and branches on the host for the pose
    graph, as `runtime.batch_session._loop_close` does. Fusion and the
    global BA, after an accepted loop only, read back their own scalars as
    the reference does.
  * Random triples. Verification draws its triples from a CPU generator
    that every call seeds anew (`features.pose3d.solve_pose3d`'s default),
    so inline and threaded passes draw the same triples for the same job
    and no generator is shared between threads.
  * Sums whose result feeds an accept / reject (fusion's gain / lose counts)
    go through `backend.ba.scatter_sum`, which adds in a fixed order.

Map-block sharding (`SLAMSession(cfg, mesh=)`): with a
`parallel.mesh.Block`, the map's per-point arrays are this rank's block of
the point table, the keyframe arrays and the observation graph are whole on
every rank, and every rank runs the same pass. The windowed BA gathers the
compacted window's points from their blocks, solves them on every rank
alike and writes back the rows of its own block; fusion counts the
observation deltas and finds the ghosts on the block; the pose graph and
`ride_with_anchors` need no traffic (the graph is over keyframes, the ride
is elementwise a point). A result holds this rank's block. A worker given
a `Block` (the threaded sharded session) runs its passes on that block; the
session gives it a block whose `group` is a process group of the worker's
own over the same ranks, so that its collectives never interleave with the
frontend's.

The fusion thresholds are the reference's hard-coded ones (Hamming 64,
ratio 0.9, 6 cm); the port matches them and keeps no option for them.

A pass that raises is logged at ERROR with its traceback and its job is
dropped; the worker stays usable. No pass moves to the CPU or to a plain
version when a kernel or a stream call fails.

The worker records one span (`runtime.profiling.StageTimer`, the
session's): `worker.queue`, from a job's `submit` to the start of its pass,
with the call id of the frame that made the job. It crosses threads, so
its ends are read apart.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch

from slam_rgbd_tpu_torch.backend import ba as ba_mod
from slam_rgbd_tpu_torch.backend import loop as loop_mod
from slam_rgbd_tpu_torch.backend import pose_graph as pg_mod
from slam_rgbd_tpu_torch.core.config import SLAMConfig
from slam_rgbd_tpu_torch.features import match as fmatch
from slam_rgbd_tpu_torch.mapping import map as smap
from slam_rgbd_tpu_torch.parallel.mesh import Block, gather_rows
from slam_rgbd_tpu_torch.runtime.profiling import StageTimer

log = logging.getLogger("slam_rgbd_tpu_torch.backend")

_NO_TIMER = StageTimer()  # keeps nothing


@dataclass
class BackendJob:
    map: smap.MapState  # the pass's snapshot: a copy when it runs threaded
    edges: pg_mod.EdgeList
    n_edges: torch.Tensor
    kf_idx: int  # newest keyframe slot at snapshot time
    n_kf: int = -1  # host-mirrored keyframe count (-1 = read from device)
    allow_loop: bool = True  # session-side loop cooldown gate
    # Loop-merge generation at snapshot time. A pose-graph merge rewrites
    # every keyframe pose of the live map; a job snapshotted before it would
    # revert the loop correction through the verbatim slot <= snap merge,
    # so the session drops stale jobs and results.
    generation: int = 0
    # CUDA: recorded on the frontend's stream after the snapshot's copy
    ready: Optional[torch.cuda.Event] = None
    call: int = -1  # the session's frame that made the job
    submitted: float = 0.0  # `time.perf_counter` at `submit`


@dataclass
class BackendResult:
    snap_kf_idx: int
    kf_pose: torch.Tensor  # (M, 4, 4) snapshot poses after BA (+ pose graph)
    pt_xyz: torch.Tensor  # (P, 3)
    pt_adjusted: torch.Tensor  # (P,) bool: points BA actually re-estimated
    loop_edge: Optional[tuple] = None  # (i, j, T_rel, weight) to append
    loop_closed: bool = False
    ba_rmse: float = 0.0
    backend_ms: float = 0.0
    generation: int = 0  # copied from the job that produced it
    # global BA after an accepted loop: reprojection RMSE px, -1 = not run
    # or rejected
    global_ba_rmse: float = -1.0
    # landmark fusion across the accepted loop (`_loop_fuse_program`): the
    # query keyframe's re-pointed observation row, ghost duplicates to
    # invalidate and the observation-count delta; None when no loop closed
    fuse_row: Optional[torch.Tensor] = None  # (K,) int32
    pt_invalidate: Optional[torch.Tensor] = None  # (P,) bool
    pt_nobs_delta: Optional[torch.Tensor] = None  # (P,) int32
    n_fused: int = 0

    def tensors(self) -> list:
        """Every device tensor the result holds."""
        out = [self.kf_pose, self.pt_xyz, self.pt_adjusted, self.fuse_row,
               self.pt_invalidate, self.pt_nobs_delta]
        if self.loop_edge is not None:
            out.append(self.loop_edge[2])
        return [t for t in out if t is not None]


def snapshot(m: smap.MapState):
    """(a copy of every tensor of `m`, an event recorded after the copy on
    the current stream, or None on the CPU): what a threaded job reads."""
    copy = dataclasses.replace(
        m, **{f.name: getattr(m, f.name).clone() for f in dataclasses.fields(m)})
    ready = None
    if m.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(m.device))
    return copy, ready


def _backend_step(m: smap.MapState, edges: pg_mod.EdgeList, n_edges: torch.Tensor,
                  kf_idx: int, allow_loop: bool, cfg: SLAMConfig, run_ba: bool,
                  blk: Block | None = None):
    """Local BA, the loop-candidate search, verification and the
    consistency gate on the device, one read-back of the packed stats, then
    the pose graph and the per-anchor point correction where the loop
    closed.

    Returns (kf_pose, pt_xyz, pt_adjusted, T_rel, stats) with stats a host
    list = [ba_rmse, ba_nobs, n_dropped, cand_ok, cand_idx, cand_score,
    closed, ver_inliers, ver_nmatches, ver_ok, t_err_m, r_err_rad].
    """
    P, M = m.capacity_pt, m.capacity_kf
    dev = m.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    if run_ba:
        w = cfg.ba.window
        idx, valid = smap.local_window(m, 2 * w)
        idx = idx.long()
        free = torch.arange(2 * w, device=dev) >= w
        res = ba_mod._windowed_single(
            m.kf_pose[idx], valid, m.pt_xyz, m.kp_uv[idx], m.kp_pts[idx][..., 2],
            m.point_id[idx], m.kp_ok[idx] & valid[:, None], cfg.camera, cfg.ba, free,
            blk=blk,
        )
        # window slots before the first keyframe repeat slot 0: they write a
        # dump row, so only valid slots reach the pose table
        pad = torch.cat([m.kf_pose, torch.zeros((1, 4, 4), dtype=f32, device=dev)])
        poses = pad.index_copy(0, torch.where(valid, idx, M), res.kf_pose)[:M]
        # the solve's own compact selection: overflow points beyond the
        # window budget are not "adjusted"
        pt_adjusted = res.pt_solved
        ba_stats = [res.rmse_px, res.n_obs.to(f32), res.n_dropped.to(f32)]
        m = dataclasses.replace(m, kf_pose=poses, pt_xyz=res.pt_xyz)
    else:
        pt_adjusted = torch.zeros((P,), dtype=torch.bool, device=dev)
        ba_stats = [zero, zero, zero]

    cand = loop_mod.find_loop_candidate(
        m, kf_idx, min_interval=cfg.ba.loop_min_interval,
        min_score=cfg.ba.loop_min_score)
    eye = torch.eye(4, dtype=f32, device=dev)
    if allow_loop and kf_idx > cfg.ba.loop_min_interval:
        ver = loop_mod.verify_loop(m, kf_idx, cand.kf_idx)
        Ti = m.kf_pose.index_select(0, cand.kf_idx.reshape(1).long())[0]
        consistent, t_err, r_err = loop_mod.edge_consistency(
            ver.T_rel, Ti, m.kf_pose[kf_idx], cfg.ba.loop_max_residual_t,
            cfg.ba.loop_max_residual_deg)
        closed = ver.ok & consistent
        vstat = torch.where(cand.ok, torch.stack([
            closed.to(f32), ver.inliers.to(f32), ver.n_matches.to(f32),
            ver.ok.to(f32), t_err, r_err,
        ]), 0.0)
        T_rel = torch.where(cand.ok, ver.T_rel, eye)
    else:
        vstat = torch.zeros((6,), dtype=f32, device=dev)
        T_rel = eye
    stats = torch.cat([torch.stack([
        *ba_stats, cand.ok.to(f32), cand.kf_idx.to(f32), cand.score,
    ]), vstat]).tolist()  # the one blocking read-back of the pass

    kf_pose, pt_xyz = m.kf_pose, m.pt_xyz
    if stats[6] > 0.5:  # closed
        edges2, _ = edges.add(n_edges, int(stats[4]), kf_idx, T_rel, weight=5.0)
        pg = pg_mod.optimize_pose_graph(
            m.kf_pose, m.kf_valid, edges2, iters=cfg.ba.pg_iters,
            damping=cfg.ba.pg_damping)
        kf_pose, pt_xyz = pg.poses, pg_mod.ride_with_anchors(m, pg.poses)
        pt_adjusted = pt_adjusted | m.pt_valid
    return kf_pose, pt_xyz, pt_adjusted, T_rel, stats


def _loop_fuse_program(m: smap.MapState, query_idx: int, cand_idx: int,
                       T_rel: torch.Tensor, blk: Block | None = None):
    """Landmark fusion across an accepted loop (ORB-SLAM3's loop `Fuse`).

    The loop fired because map association failed on the revisit: the query
    keyframe spawned duplicates of the candidate's landmarks. Fusion
    re-points the query keyframe's verified matches at the candidate's map
    points, so that the two ends of the loop share observations and a global
    BA refines the closure instead of relaxing it away. Two `hamming_top2`
    launches on a CUDA map (the match and its cross-check).

    Returns (point_id_fused (M, K): the snapshot's observation graph with the
    query row re-pointed and ghost references cleared, for the global BA;
    fuse_row (K,) int32; ghost (P,) bool: duplicates spawned by the query
    whose only observation was just re-pointed; nobs_delta (P,) int32;
    n_fused () int). With `blk`, ghost and nobs_delta are this rank's
    block, counted on the block.
    """
    Pl = m.capacity_pt
    start = 0 if blk is None else blk.start
    mt = fmatch.match(m.kp_signs[query_idx], m.kp_ok[query_idx],
                      m.kp_signs[cand_idx], m.kp_ok[cand_idx],
                      max_distance=64.0, ratio=0.9)
    idx2 = mt.idx2.long()
    p1 = m.kp_pts[query_idx]
    p2 = m.kp_pts[cand_idx][idx2]
    # the match must agree with the verified loop transform to 6 cm, the
    # bound verification holds its rmse to
    pred = p1 @ T_rel[:3, :3].T + T_rel[:3, 3]
    inl = mt.valid & (torch.linalg.norm(pred - p2, dim=-1) < 0.06)
    q_row = m.point_id[query_idx]  # (K,)
    cand_pid = m.point_id[cand_idx][idx2]  # (K,)
    fuse = inl & (cand_pid >= 0) & (q_row != cand_pid)
    fuse_row = torch.where(fuse, cand_pid, q_row)

    def block_rows(ids, keep):
        """The rows of this block that `ids` name where `keep`, else the
        dump row Pl."""
        local = ids - start
        return torch.where(keep & (local >= 0) & (local < Pl), local, Pl).long()

    ones = torch.ones(fuse.shape, dtype=torch.int32, device=m.device)
    gain = ba_mod.scatter_sum(block_rows(cand_pid, fuse), ones, Pl + 1)[:Pl]
    lose = ba_mod.scatter_sum(block_rows(q_row, fuse & (q_row >= 0)), ones, Pl + 1)[:Pl]
    delta = gain - lose
    # ghosts: spawned by the query keyframe itself (the snapshot's newest:
    # nothing later can have observed them in the snapshot), now unobserved
    ghost = (m.pt_valid & (m.pt_first_kf == query_idx) & (lose > 0)
             & (m.pt_nobs + delta <= 0))
    pid = m.point_id.clone()
    pid[query_idx] = fuse_row
    pid = pid.masked_fill(gather_rows(ghost, pid, blk), -1)
    return pid, fuse_row, ghost, delta, fuse.sum()


def _global_ba_program(kf_pose: torch.Tensor, pt_xyz: torch.Tensor,
                       point_id: torch.Tensor, m: smap.MapState, cfg: SLAMConfig,
                       blk: Block | None = None):
    """BA over the newest `global_ba_window` keyframes after an accepted
    loop (ORB-SLAM3's GlobalBundleAdjustment, bounded), on the pose-graph
    state and the fused observation graph, the oldest valid keyframe of the
    window as gauge, `global_ba_iters` LM iterations and the
    `global_ba_points` budget. Trust region: the result is applied only if
    every pose is finite, the rmse is below 1e3 px and no keyframe moved
    more than `global_ba_max_move`; otherwise the pose-graph state passes
    through.

    Returns (kf_pose, pt_xyz, pt_solved, rmse_px, applied, max_move_m).
    """
    M = m.capacity_kf
    W = min(cfg.ba.global_ba_window, M)
    dev = m.device
    idx, wvalid = smap.local_window(m, W)
    idx = idx.long()
    gauge = ba_mod._first_true(wvalid)  # oldest valid position
    free = wvalid & (torch.arange(W, device=dev) != gauge)
    gcfg = dataclasses.replace(cfg.ba, iters=cfg.ba.global_ba_iters,
                               max_points_per_window=cfg.ba.global_ba_points)
    kf_win_in = kf_pose[idx]
    res = ba_mod._windowed_single(
        kf_win_in, wvalid, pt_xyz, m.kp_uv[idx], m.kp_pts[idx][..., 2], point_id[idx],
        m.kp_ok[idx] & wvalid[:, None], cfg.camera, gcfg, free, blk=blk,
    )
    pt_finite = torch.isfinite(res.pt_xyz).all(dim=-1)
    move = torch.linalg.norm(res.kf_pose[:, :3, 3] - kf_win_in[:, :3, 3], dim=-1)
    dmax = torch.where(wvalid, move, 0.0).amax()
    ok = (torch.isfinite(res.kf_pose).all() & (res.rmse_px < 1e3)
          & (dmax <= cfg.ba.global_ba_max_move))
    kf_win = torch.where((ok & wvalid)[:, None, None], res.kf_pose, kf_win_in)
    pad = torch.cat([kf_pose, torch.zeros((1, 4, 4), dtype=kf_pose.dtype, device=dev)])
    kf_out = pad.index_copy(0, torch.where(wvalid, idx, M), kf_win)[:M]
    solved = ok & res.pt_solved & pt_finite
    pt_out = torch.where(solved[:, None], res.pt_xyz, pt_xyz)
    return kf_out, pt_out, solved, res.rmse_px, ok, dmax


def backend_pass(m: smap.MapState, edges: pg_mod.EdgeList, n_edges: torch.Tensor,
                 kf_idx: int, cfg: SLAMConfig, n_kf: int = -1,
                 allow_loop: bool = True, blk: Block | None = None) -> BackendResult:
    """One backend iteration on a map snapshot: local BA, then a loop
    attempt (candidate, verification, consistency gate, pose graph), then,
    after an accepted loop, landmark fusion and the global BA. Pure in the
    snapshot; the caller merges the result. `n_kf` is the host-mirrored
    keyframe count; -1 reads it from the device. With `blk` (`m` holding
    this rank's block of the point table), every rank of the group calls
    it alike and gets its block of the result."""
    t0 = time.monotonic()
    if n_kf < 0:
        n_kf = int(m.n_kf)
    kf_pose, pt_xyz, pt_adjusted, T_rel, s = _backend_step(
        m, edges, n_edges, kf_idx, allow_loop, cfg, run_ba=n_kf >= 3, blk=blk)
    global_rmse = -1.0
    fuse_row = pt_invalidate = nobs_delta = None
    n_fused = 0
    if s[6] > 0.5:
        # landmark fusion across the accepted loop before any global
        # refinement: the two ends share no observations until the query's
        # verified matches are re-pointed at the candidate's landmarks
        pid_fused, fuse_row, pt_invalidate, nobs_delta, nf = _loop_fuse_program(
            m, kf_idx, int(s[4]), T_rel, blk)
        n_fused = int(nf)
        if cfg.ba.global_ba_iters > 0 and n_kf >= 3:
            kf_pose, pt_xyz, g_solved, g_rmse, g_ok, g_move = _global_ba_program(
                kf_pose, pt_xyz, pid_fused, m, cfg, blk)
            pt_adjusted = pt_adjusted | g_solved
            rmse, applied, move = torch.stack(
                [g_rmse, g_ok.to(torch.float32), g_move]).tolist()
            global_rmse = rmse if applied > 0.5 else -1.0
            if applied < 0.5:
                log.info("global BA rejected (max keyframe move %.2f m, rmse %.2f px); "
                         "keeping the pose-graph state", move, rmse)
    out = BackendResult(
        snap_kf_idx=kf_idx, kf_pose=kf_pose, pt_xyz=pt_xyz, pt_adjusted=pt_adjusted,
        ba_rmse=s[0], global_ba_rmse=global_rmse, fuse_row=fuse_row,
        pt_invalidate=pt_invalidate, pt_nobs_delta=nobs_delta, n_fused=n_fused,
    )
    if int(s[2]):
        log.info("BA window point budget overflow: %d points excluded", int(s[2]))
    if s[6] > 0.5:  # closed
        out.loop_edge = (int(s[4]), kf_idx, T_rel, 5.0)
        out.loop_closed = True
        log.info("loop closed: KF%d -> KF%d (%d inliers, %d landmarks fused); "
                 "global BA rmse %.2f px", kf_idx, int(s[4]), int(s[7]), n_fused,
                 global_rmse)
    elif s[9] > 0.5:  # verified, rejected by the consistency gate
        log.warning("loop edge KF%d -> KF%d rejected by consistency gate "
                    "(t %.2f m, rot %.1f deg)", int(s[4]), kf_idx, s[10],
                    s[11] * 180.0 / 3.141592653589793)
    out.backend_ms = (time.monotonic() - t0) * 1e3
    return out


class BackendWorker:
    """One backend thread, one in-flight job, one latest waiting job, one
    pending result.

    A pass that ended stays pending until the frontend takes it (`poll` /
    `flush`), whether it returned a result or failed: until then the worker
    is busy, and a failed pass is not mistaken for an idle worker.
    `completed` counts the passes that ended, failed ones included. With
    `blk`, every pass runs `backend_pass(..., blk=blk)`. The worker runs on
    the CUDA device unless the caller asks for `device="cpu"`; without a
    card the default raises, as the session's does. `timer`: the
    `StageTimer` its `worker.queue` spans go to (by default none is kept).

    `submit` never blocks: while a job is in flight or a result is
    unconsumed, a new job replaces the waiting one, and the displaced job is
    a recorded skip (sliding windows overlap, so the newest window covers a
    burst). Promotion of the waiting job lives in `advance`, which the
    frontend calls after merging (or dropping) a consumed result: a waiting
    job older than the last loop merge (`generation < min_generation`) is
    dropped there, and a job that died with an exception never strands the
    waiting one.
    """

    def __init__(self, cfg: SLAMConfig, device="cuda", blk: Block | None = None,
                 timer: StageTimer | None = None):
        from slam_rgbd_tpu_torch.runtime.session import _resolve_device

        self.cfg = cfg
        self.device = _resolve_device(device)
        self.blk = blk
        self.timer = _NO_TIMER if timer is None else timer
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._cv = threading.Condition()
        self._job: Optional[BackendJob] = None  # in flight on the thread
        self._next_job: Optional[BackendJob] = None  # latest waiting
        self._result: Optional[BackendResult] = None
        self._ended = False  # a pass ended and the frontend has not taken it
        self._stop = False
        self.skipped = 0
        self.completed = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="slam-backend")
        self._thread.start()

    # ------------------------------------------------------------- frontend
    def submit(self, job: BackendJob) -> bool:
        job.submitted = time.perf_counter()
        with self._cv:
            if self._job is None and not self._ended:
                if self._next_job is not None:
                    self.skipped += 1  # superseded by the newer snapshot
                    self._next_job = None
                self._job = job
                self._cv.notify_all()
                return True
            if self._next_job is not None:
                self.skipped += 1  # displaced by the newer snapshot
            self._next_job = job
            return False

    def _hand_over(self, r: Optional[BackendResult]) -> Optional[BackendResult]:
        """The result to the calling (frontend) thread: its tensors are
        marked as used on that thread's current stream."""
        if r is not None and self._stream is not None:
            stream = torch.cuda.current_stream(self.device)
            for t in r.tensors():
                t.record_stream(stream)
        return r

    def _take(self) -> Optional[BackendResult]:
        r, self._result, self._ended = self._result, None, False
        return r

    def poll(self) -> Optional[BackendResult]:
        """Take the pending result (non-blocking; never promotes: call
        `advance` after merging)."""
        with self._cv:
            r = self._take()
        return self._hand_over(r)

    def ended(self) -> tuple[bool, bool]:
        """(no job is in flight, a result is pending): what `poll` would
        find, without taking it."""
        with self._cv:
            return self._job is None, self._result is not None

    def wait(self, timeout: float) -> bool:
        """Wait up to `timeout` s for the in-flight job, if any, to end;
        nothing is taken. True if no job is in flight."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._job is not None and not self._stop:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=min(remaining, 0.5))
            return self._job is None

    def advance(self, min_generation: int = 0, allow_loop=None):
        """Promote the latest waiting job, if any and the worker is idle.
        A waiting job stamped before the last loop merge is dropped as a
        skip. `allow_loop(kf_idx) -> bool` re-evaluates the session's loop
        cooldown at start time."""
        with self._cv:
            if self._job is not None or self._ended:
                return
            if self._next_job is None:
                return
            job, self._next_job = self._next_job, None
            if job.generation < min_generation:
                self.skipped += 1
                log.info("waiting backend job (KF%d) dropped: snapshot predates "
                         "loop merge (gen %d < %d)", job.kf_idx, job.generation,
                         min_generation)
                return
            if allow_loop is not None:
                job.allow_loop = bool(allow_loop(job.kf_idx))
            self._job = job
            self._cv.notify_all()

    def busy(self) -> bool:
        """True while a job is in flight, waiting, or unconsumed."""
        with self._cv:
            return (self._job is not None or self._next_job is not None
                    or self._ended)

    def flush(self, timeout: float = 30.0) -> Optional[BackendResult]:
        """Wait for the in-flight job (if any) and return its result.
        Callers draining the worker loop `flush` + merge + `advance` while
        `busy()`."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._job is not None and not self._stop:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    log.error("backend flush timed out")
                    return None
                self._cv.wait(timeout=min(remaining, 0.5))
            r = self._take()
        return self._hand_over(r)

    def stop(self, timeout: float = 10.0):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    # -------------------------------------------------------------- backend
    def _pass(self, job: BackendJob) -> BackendResult:
        self.timer.span("worker.queue", job.submitted, time.perf_counter(), job.call)

        def run():
            return backend_pass(job.map, job.edges, job.n_edges, job.kf_idx,
                                self.cfg, n_kf=job.n_kf, allow_loop=job.allow_loop,
                                blk=self.blk)

        if self._stream is None:
            return run()
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            try:
                if job.ready is not None:
                    self._stream.wait_event(job.ready)
                return run()
            finally:
                # also after a failure: the job's tensors are dropped next
                self._stream.synchronize()

    def _run(self):
        while True:
            with self._cv:
                while self._job is None and not self._stop:
                    self._cv.wait(timeout=0.5)
                if self._stop:
                    return
                job = self._job
            try:
                result = self._pass(job)
                result.generation = job.generation
            except Exception:  # noqa: BLE001 - the thread must survive; logged
                log.exception("backend pass failed; dropping job")
                result = None
            with self._cv:
                self._result = result
                self._ended = True
                self._job = None
                self.completed += 1
                self._cv.notify_all()
