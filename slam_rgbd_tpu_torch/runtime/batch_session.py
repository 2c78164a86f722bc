"""Multi-sequence SLAM: N sequences tracked concurrently on one device or
over the `data` axis of a mesh.

Counterpart of `slam_rgbd_tpu/runtime/batch_session.py`. The state of N
independent SLAM sessions lives on one device; one synchronized frame per
sequence goes through `process_frames`. With a mesh (`parallel.mesh`), each
rank of the `data` axis holds N / size of the sequences, a consecutive block,
and runs the same steps on them alone: nothing moves between ranks in the
steady state (the JAX package's zero cross-device traffic). Only the
outputs that cover every sequence gather the blocks.

  * tracking: natively batched. The pyramids of all sequences are built with
    a leading B, and `odometry.icp.track_frame_batched` runs every GN
    iteration as one `ops.gn_reduce.gn_step_batched` call for all B
    sequences (22 a tracked step at the default ICP schedule: the three
    coarse starts of every sequence are problems of one call), so a step
    queues about as many device operations for B sequences as for one.
  * keyframes, backend, loop closure, relocalization: the reference masks
    these programs per sequence because its shapes are static; its masks are
    host arrays. Here each program runs for the sequences whose mask is set,
    one after the other, on that sequence's own `MapState` / `EdgeList`,
    through the single-sequence functions of `runtime.session` (map
    association through `gated_match`, relocalization through
    `hamming_top2`) and `backend.{ba,loop,pose_graph}`. A masked-out
    sequence's state is not touched.
  * loop closure keeps the reference's behaviour that a closed pair is never
    retired: after the cooldown the same region may close again.

The host keeps per-sequence counters (keyframe counts, frame indices, lost
streaks); everything else stays on the device. Each tracked step reads one
(B, 4) summary back to take the keyframe / lost decisions, as the reference
does.

Spans (`runtime.profiling.StageTimer`, the session's `timer`): each step is
a `batch.step` span whose call id is the step's index, with the children
`batch.upload` (the host's widening and the copy to the device),
`batch.track` (the batched tracking step), `batch.fetch` (the summary's
read-back) and `batch.insert`, whose children are `batch.features` and
`batch.ba`, each over every stream it serves. A `metrics` sink made with
`MetricsLog(spans=True)` keeps them; the batch session logs no records.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from slam_rgbd_tpu_torch.backend import ba as ba_mod
from slam_rgbd_tpu_torch.backend import loop as loop_mod
from slam_rgbd_tpu_torch.backend import pose_graph as pg_mod
from slam_rgbd_tpu_torch.core import camera, se3
from slam_rgbd_tpu_torch.core.config import SLAMConfig
from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse
from slam_rgbd_tpu_torch.features import detect as fdetect
from slam_rgbd_tpu_torch.mapping import map as smap
from slam_rgbd_tpu_torch.odometry.icp import track_frame_batched
from slam_rgbd_tpu_torch.parallel import mesh as pmesh
from slam_rgbd_tpu_torch.runtime.profiling import StageTimer
from slam_rgbd_tpu_torch.runtime.session import (
    _features, _kf_insert, _reloc, _resolve_device,
)


def _batch_steady(prev_pyr, depth, rgb, T_world, motion, last_kf_T,
                  cam, icp_cfg, kcfg):
    """One tracking step for every sequence: pyramids, coarse-to-fine GN and
    the (B, 4) keyframe-decision summary [inlier fraction, rmse, pose
    finite, should insert], all with a leading B."""
    pyr = camera.build_frame_pyramid(depth, cam, levels=icp_cfg.levels, rgb=rgb)
    T2, m2, res = track_frame_batched(prev_pyr, pyr, T_world, motion, cam, icp_cfg)
    should = smap.should_insert_keyframe(T2, last_kf_T, res.valid_fraction, kcfg)
    f32 = torch.float32
    summary = torch.stack([
        res.valid_fraction.to(f32), res.rmse.to(f32),
        torch.isfinite(T2).all(dim=(-2, -1)).to(f32), should.to(f32),
    ], dim=1)
    return pyr, T2, m2, summary


def _batch_features(depth, rgb, cam, orb, which):
    """The feature stage (detect + describe + keypoint depth) for the
    sequences in the host mask `which`: a list of (uv, signs, pts, ok) per
    sequence, None where the mask is off."""
    out = [None] * len(which)
    for b in np.flatnonzero(which):
        kp, desc, pts, ok = _features(depth[b], rgb[b], orb, cam)
        out[b] = (kp.uv, desc.signs, pts, ok)
    return out


def _batch_insert(maps, edges, n_edges, feats, T_pose, ts, kf_idx, do_insert, cfg):
    """Keyframe insert for the sequences in `do_insert`: map association (a
    sequence with `kf_idx > 0` has a map to match against), insertion, cull,
    and the odometry edge previous -> new keyframe with T_meas = T_prev^-1 T.
    Returns (maps, edges, n_edges, last_kf_T (B, 4, 4)): the reference
    keyframe pose is the new keyframe's for an inserting sequence and the
    previous keyframe's for the others."""
    maps, edges, n_edges = list(maps), list(edges), list(n_edges)
    last = []
    for b, do in enumerate(do_insert):
        ki = int(kf_idx[b])
        if do:
            uv, signs, pts, ok = feats[b]
            maps[b], edges[b], n_edges[b], kf_T, _ = _kf_insert(
                maps[b], edges[b], n_edges[b], uv, signs, pts, ok, T_pose[b],
                float(ts), ki - 1, ki, cfg)
        else:
            kf_T = maps[b].kf_pose[max(ki - 1, 0)]
        last.append(kf_T)
    return maps, edges, n_edges, torch.stack(last)


def _ba_merge(m, Tw, cfg):
    """Compacted windowed BA of one sequence over its newest 2w keyframes,
    the older half fixed, merged by the rigid correction C of the newest
    keyframe. The whole result is dropped unless it is finite and |t(C)| is
    under 2 m; points are written only where solved, valid and finite."""
    w = cfg.ba.window
    dev = m.device
    M = m.capacity_kf
    idx, valid = smap.local_window(m, 2 * w)
    idx = idx.long()
    free = torch.arange(2 * w, device=dev) >= w
    old = m.kf_pose[idx]
    res = ba_mod._windowed_single(
        old, valid, m.pt_xyz, m.kp_uv[idx], m.kp_pts[idx][..., 2],
        m.point_id[idx], m.kp_ok[idx] & valid[:, None], cfg.camera, cfg.ba, free,
    )
    # window slots before the first keyframe repeat index 0: they write a
    # dump row, so only valid slots reach the pose table
    pad = torch.cat([m.kf_pose, torch.zeros((1, 4, 4), device=dev)])
    poses = pad.index_copy(0, torch.where(valid, idx, M), res.kf_pose)[:M]
    snap = torch.clamp_min(m.n_kf - 1, 0).long().reshape(1)
    C = se3.normalize_rotation(
        poses.index_select(0, snap)[0] @ se3.inverse(m.kf_pose.index_select(0, snap)[0])
    )
    sane = (
        torch.isfinite(poses).all() & torch.isfinite(C).all()
        & (torch.linalg.norm(C[:3, 3]) < 2.0)
    )
    keep = res.pt_solved & m.pt_valid & torch.isfinite(res.pt_xyz).all(dim=-1)
    m2 = dataclasses.replace(
        m,
        kf_pose=torch.where(sane, poses, m.kf_pose),
        pt_xyz=torch.where(sane & keep[:, None], res.pt_xyz, m.pt_xyz),
    )
    Tw2 = torch.where(sane, se3.normalize_rotation(C @ Tw), Tw)
    return m2, Tw2, torch.where(sane, res.rmse_px, 0.0)


def _batch_ba(maps, T_world, do_ba, cfg):
    """The backend pass for the sequences in `do_ba`. Returns
    (maps, T_world (B, 4, 4), rmse_px (B,), 0 where no pass ran)."""
    maps = list(maps)
    Tw = list(T_world.unbind(0))
    rmse = [torch.zeros((), device=T_world.device)] * len(maps)
    for b in np.flatnonzero(do_ba):
        maps[b], Tw[b], rmse[b] = _ba_merge(maps[b], Tw[b], cfg)
    return maps, torch.stack(Tw), torch.stack(rmse)


def _batch_loop_candidates(maps, kf_idx, cfg, which):
    """Loop-candidate search for the sequences in `which`, one signature
    product each. Returns (B, 3) [ok, candidate keyframe, score] on the
    device, zero rows where the mask is off."""
    dev = maps[0].device
    rows = [torch.zeros(3, device=dev)] * len(maps)
    for b in np.flatnonzero(which):
        cand = loop_mod.find_loop_candidate(
            maps[b], int(kf_idx[b]), min_interval=cfg.ba.loop_min_interval,
            min_score=cfg.ba.loop_min_score)
        rows[b] = torch.stack([
            cand.ok.to(torch.float32), cand.kf_idx.to(torch.float32), cand.score])
    return torch.stack(rows)


def _loop_close(m, e, n, Tw, ki: int, ci: int, cfg):
    """One sequence's loop closure between keyframe `ki` and candidate `ci`:
    geometric verification, the consistency gate on the would-be edge
    residual, a weight-5 edge, the pose-graph solve, per-anchor point
    correction and the rigid correction of the live pose. State is replaced
    only where the loop closed and the result is finite with |t(C)| < 2 m.
    Returns (m, e, n, Tw, closed () bool)."""
    ver = loop_mod.verify_loop(m, ki, ci)
    Tj = m.kf_pose[ki]
    consistent, _, _ = loop_mod.edge_consistency(
        ver.T_rel, m.kf_pose[ci], Tj, cfg.ba.loop_max_residual_t,
        cfg.ba.loop_max_residual_deg)
    closed = ver.ok & consistent
    # the pose graph is the expensive part and changes nothing for a loop
    # that did not verify: one flag read decides whether to run it
    if not bool(closed):
        return m, e, n, Tw, closed
    e2, n2 = e.add(n, ci, ki, ver.T_rel, weight=5.0)
    pg = pg_mod.optimize_pose_graph(
        m.kf_pose, m.kf_valid, e2, iters=cfg.ba.pg_iters, damping=cfg.ba.pg_damping)
    pt_new = pg_mod.ride_with_anchors(m, pg.poses)
    C = se3.normalize_rotation(pg.poses[ki] @ se3.inverse(Tj))
    use = (
        torch.isfinite(pg.poses).all() & torch.isfinite(C).all()
        & (torch.linalg.norm(C[:3, 3]) < 2.0)
    )
    m2 = dataclasses.replace(
        m,
        kf_pose=torch.where(use, pg.poses, m.kf_pose),
        pt_xyz=torch.where(use, pt_new, m.pt_xyz),
    )
    e_out = pg_mod.EdgeList(**{
        f.name: torch.where(use, getattr(e2, f.name), getattr(e, f.name))
        for f in dataclasses.fields(pg_mod.EdgeList)
    })
    Tw2 = torch.where(use, se3.normalize_rotation(C @ Tw), Tw)
    return m2, e_out, torch.where(use, n2, n), Tw2, use


def _batch_loop_close(maps, edges, n_edges, T_world, kf_idx, cand_idx, do, cfg):
    """Loop closure for the sequences in `do`. Returns
    (maps, edges, n_edges, T_world, closed (B,) bool on the device)."""
    maps, edges, n_edges = list(maps), list(edges), list(n_edges)
    Tw = list(T_world.unbind(0))
    closed = [torch.zeros((), dtype=torch.bool, device=T_world.device)] * len(maps)
    for b in np.flatnonzero(do):
        maps[b], edges[b], n_edges[b], Tw[b], closed[b] = _loop_close(
            maps[b], edges[b], n_edges[b], Tw[b], int(kf_idx[b]),
            int(cand_idx[b]), cfg)
    return maps, edges, n_edges, torch.stack(Tw), torch.stack(closed)


def _batch_reloc(maps, depth, rgb, T_est, do, cfg):
    """Relocalization for the sequences in `do`: features, map-wide match
    and the 3D-3D solve with the single session's gates (consensus of at
    least half of the valid matches, |t(C)| <= 1 m). Returns
    (T_world (B, 4, 4), accepted (B,) bool on the device)."""
    Tw = list(T_est.unbind(0))
    accepted = [torch.zeros((), dtype=torch.bool, device=T_est.device)] * len(maps)
    for b in np.flatnonzero(do):
        _, desc, pts, ok = _features(depth[b], rgb[b], cfg.orb, cfg.camera)
        T_fixed, _, stats = _reloc(maps[b], desc.signs, ok, pts, Tw[b], cfg)
        accepted[b] = (stats[0] > 0.5) & (stats[3] <= 1.0)
        Tw[b] = torch.where(accepted[b], T_fixed, Tw[b])
    return torch.stack(Tw), torch.stack(accepted)


def _batch_traj_append(buf, i: int, T):
    """Write the (B, 4, 4) poses into slot i of the (B, cap, 4, 4) log, in
    place."""
    buf[:, i] = T
    return buf


@dataclass
class BatchState:
    frames: int = 0
    lost: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    loops: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    relocalized: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64)
    )


class BatchSession:
    """N concurrent SLAM sequences on one device, or sharded over a mesh.

    Feed one synchronized frame per sequence with
    `process_frames(ts, depth (B, H, W) u16, rgb (B, H, W, 3) u8)`; read
    per-sequence results with `poses()`, `keyframe_counts`,
    `map_point_counts()` and `state`. The session runs on the CUDA device
    unless the caller asks for `device="cpu"`; without a card the default
    raises. On CUDA it turns TF32 off for matrix products and cuDNN: the
    6x6 solves, the Schur products and the CG products need full float32.

    With `mesh` (a `DeviceMesh` from `parallel.mesh.make_mesh`), this rank
    holds the block of `n_seq / mesh[data]` sequences at its index along the
    data axis (`n_local` of them). `process_frames` takes the full batch on
    every rank and keeps that block. `poses()`, `keyframe_counts`,
    `map_point_counts()`, `ate_per_sequence()` and `state` return all
    `n_seq` sequences on every rank through one gather each: they are
    collectives, called by every rank of the data axis together. The array
    state (`maps`, `edges`, `T_world`, ...) is the rank's block.

    `metrics`: an optional `runtime.profiling.MetricsLog` that keeps the
    spans of `timer`, if it keeps spans.
    """

    def __init__(self, cfg: SLAMConfig, n_seq: int, device="cuda", mesh=None,
                 metrics=None):
        if n_seq < 1:
            raise ValueError(f"n_seq must be >= 1, got {n_seq}")
        self.cfg = cfg
        self.timer = StageTimer(metrics)
        self.B = n_seq
        self.mesh = mesh
        self._seqs = slice(0, n_seq)
        if mesh is not None:
            axis = cfg.mesh.data_axis
            ndev = mesh.size(mesh.mesh_dim_names.index(axis))
            if n_seq % ndev:
                raise ValueError(f"n_seq={n_seq} not divisible by data axis {ndev}")
            self._seqs = pmesh.block(n_seq, mesh, axis)
        self.n_local = n_local = self._seqs.stop - self._seqs.start
        self.device = dev = _resolve_device(device)
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        n_kp = sum(fdetect._per_level_budget(
            cfg.orb.n_features, cfg.orb.n_levels, cfg.orb.scale_factor))
        self.maps = [smap.empty_map(cfg.keyframes, n_kp, dev) for _ in range(n_local)]
        self.edges = [
            pg_mod.EdgeList.empty(4 * cfg.keyframes.max_keyframes, dev)
            for _ in range(n_local)
        ]
        self.n_edges = [
            torch.zeros((), dtype=torch.int32, device=dev) for _ in range(n_local)
        ]
        eye = torch.eye(4, device=dev).repeat(n_local, 1, 1)
        self.T_world = eye
        self.motion = eye.clone()
        self.last_kf_T = eye.clone()
        self.prev_pyr = None
        # pose log and reference-keyframe log (the pose the reference
        # keyframe had when the frame was logged, and its slot on the host):
        # `poses()` re-anchors each frame to that keyframe's current pose
        self._traj_cap = 1024
        self._traj = torch.zeros((n_local, self._traj_cap, 4, 4), device=dev)
        self._traj_kfT = torch.zeros((n_local, self._traj_cap, 4, 4), device=dev)
        self._frame_kf: list[np.ndarray] = []  # per frame: (B,) keyframe slot
        self._traj_ts: list[float] = []
        self._n_kf = np.zeros(n_local, np.int64)
        self._last_kf_frame = np.full(n_local, -(10 ** 9))
        self._last_loop_kf = np.full(n_local, -(10 ** 9))
        self._lost_streak = np.zeros(n_local, np.int64)
        self._frame_i = 0
        self._state = BatchState(
            lost=np.zeros(n_local, np.int64),
            loops=np.zeros(n_local, np.int64),
            relocalized=np.zeros(n_local, np.int64),
        )

    # ------------------------------------------------------------------ step
    def _upload(self, x) -> torch.Tensor:
        """A frame stack onto the session's device. uint16 depth becomes
        int32 on the host first: torch has few uint16 kernels."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        x = np.asarray(x)
        if x.dtype == np.uint16:
            x = x.astype(np.int32)
        return torch.tensor(x, device=self.device)

    def _insert(self, ts, depth, rgb, do_insert: np.ndarray):
        with self.timer.section("batch.insert"):
            self._insert_steps(ts, depth, rgb, do_insert)

    def _insert_steps(self, ts, depth, rgb, do_insert: np.ndarray):
        cfg = self.cfg
        with self.timer.section("batch.features"):
            feats = _batch_features(depth, rgb, cfg.camera, cfg.orb, do_insert)
        self.maps, self.edges, self.n_edges, self.last_kf_T = _batch_insert(
            self.maps, self.edges, self.n_edges, feats, self.T_world, ts,
            self._n_kf, do_insert, cfg)
        self._n_kf += do_insert.astype(np.int64)
        self._last_kf_frame = np.where(do_insert, self._frame_i, self._last_kf_frame)
        # backend: windowed BA for the sequences with enough keyframes
        do_ba = do_insert & (self._n_kf >= 3)
        if do_ba.any():
            with self.timer.section("batch.ba"):
                self.maps, self.T_world, _ = _batch_ba(self.maps, self.T_world, do_ba, cfg)
        # loop closure: the cheap candidate search on inserting sequences
        # past their cooldown; the closure itself only where a candidate
        # exists
        new_kf = np.maximum(self._n_kf - 1, 0).astype(np.int32)
        allow = (
            do_insert
            & (new_kf - self._last_loop_kf >= cfg.ba.loop_cooldown_kf)
            & (self._n_kf >= 3)
        )
        if allow.any():
            cand = _batch_loop_candidates(self.maps, new_kf, cfg, allow).cpu().numpy()
            do_loop = allow & (cand[:, 0] > 0.5)
            if do_loop.any():
                (self.maps, self.edges, self.n_edges, self.T_world,
                 closed) = _batch_loop_close(
                    self.maps, self.edges, self.n_edges, self.T_world, new_kf,
                    cand[:, 1].astype(np.int32), do_loop, cfg)
                closed = closed.cpu().numpy()
                self._state.loops += closed.astype(np.int64)
                self._last_loop_kf = np.where(closed, new_kf, self._last_loop_kf)
        if do_ba.any() or allow.any():
            self.last_kf_T = torch.stack(
                [m.kf_pose[int(i)] for m, i in zip(self.maps, new_kf)])

    def process_frames(self, ts: float, depth, rgb):
        """One synchronized frame for every sequence: depth (B, H, W) in
        sensor units, rgb (B, H, W, 3) uint8, as arrays or tensors; on a
        mesh every rank passes all B and keeps its own block."""
        if len(depth) != self.B or len(rgb) != self.B:
            raise ValueError(
                f"expected {self.B} sequences, got depth {np.shape(depth)}, "
                f"rgb {np.shape(rgb)}")
        with self.timer.section("batch.step", call=self._frame_i):
            self._step(ts, depth, rgb)

    def _step(self, ts: float, depth, rgb):
        timer = self.timer
        if self.mesh is not None:
            depth, rgb = depth[self._seqs], rgb[self._seqs]
        with timer.section("batch.upload"):
            depth = self._upload(depth)
            rgb = self._upload(rgb)
        cfg = self.cfg
        traj_i = len(self._traj_ts)
        if traj_i >= self._traj_cap:  # double the log
            pad = torch.zeros((self.n_local, self._traj_cap, 4, 4), device=self.device)
            self._traj = torch.cat([self._traj, pad], dim=1)
            self._traj_kfT = torch.cat([self._traj_kfT, pad], dim=1)
            self._traj_cap *= 2

        if self.prev_pyr is None:  # bootstrap: keyframe 0 for every sequence
            self.prev_pyr = camera.build_frame_pyramid(
                depth, cfg.camera, levels=cfg.icp.levels, rgb=rgb)
            self._insert(ts, depth, rgb, np.ones(self.n_local, bool))
            self._last_kf_frame[:] = 0
        else:
            with timer.section("batch.track"):
                self.prev_pyr, self.T_world, self.motion, summaries = _batch_steady(
                    self.prev_pyr, depth, rgb, self.T_world, self.motion,
                    self.last_kf_T, cfg.camera, cfg.icp, cfg.keyframes)
            with timer.section("batch.fetch"):
                s = summaries.cpu().numpy()  # (B, 4): the step's one fetch
            ok = (s[:, 0] > 0.25) & (s[:, 2] > 0.5)
            self._state.lost += (~ok).astype(np.int64)
            self._lost_streak = np.where(ok, 0, self._lost_streak + 1)
            # relocalization for lost sequences, rate-limited like the
            # single session: on the 1st frame of a streak, then every 4th
            attempt = (
                ~ok
                & ((self._lost_streak == 1) | (self._lost_streak % 4 == 0))
                & (self._n_kf >= 1)
            )
            if attempt.any():
                self.T_world, accepted = _batch_reloc(
                    self.maps, depth, rgb, self.T_world, attempt, cfg)
                # the bad velocity from before the loss must not seed the
                # next track of a relocalized sequence
                self.motion = torch.where(
                    accepted[:, None, None], torch.eye(4, device=self.device),
                    self.motion)
                accepted = accepted.cpu().numpy()
                self._state.relocalized += accepted.astype(np.int64)
                self._lost_streak = np.where(accepted, 0, self._lost_streak)
                ok = ok | accepted
            gap_ok = (
                self._frame_i - self._last_kf_frame >= cfg.keyframes.kf_min_gap_frames
            )
            room = self._n_kf < cfg.keyframes.max_keyframes
            do = ok & (s[:, 3] > 0.5) & gap_ok & room
            if do.any():
                self._insert(ts, depth, rgb, do)

        self._traj = _batch_traj_append(self._traj, traj_i, self.T_world)
        self._traj_kfT = _batch_traj_append(self._traj_kfT, traj_i, self.last_kf_T)
        self._frame_kf.append(np.maximum(self._n_kf - 1, 0).astype(np.int32))
        self._traj_ts.append(ts)
        self._frame_i += 1
        self._state.frames += 1

    # --------------------------------------------------------------- outputs
    def _all(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The rank's block of a per-sequence tensor -> every sequence's,
        along `dim` (the block itself without a mesh)."""
        if self.mesh is None:
            return x
        return pmesh.gather(x, self.mesh, self.cfg.mesh.data_axis, dim)

    def poses(self):
        """(ts (n,), trajectories (B, n, 4, 4)), loop- and BA-corrected.

        Each logged frame pose is re-anchored to its reference keyframe's
        current pose: T = T_kf_now @ T_kf_then^-1 @ T_then, so pose-graph
        rewrites and BA corrections reach the whole logged history. The
        gather and the products run on the device; one copy comes back."""
        n = len(self._traj_ts)
        ts = np.asarray(self._traj_ts)
        if n == 0:
            return ts, np.zeros((self.B, 0, 4, 4), np.float32)
        kf_idx = torch.tensor(np.stack(self._frame_kf, axis=1), device=self.device)
        kf_now = torch.stack([m.kf_pose for m in self.maps])  # (b, M, 4, 4)
        seq = torch.arange(self.n_local, device=self.device)[:, None]
        anchor = kf_now[seq, kf_idx.long()]  # (b, n, 4, 4)
        out = anchor @ se3.inverse(self._traj_kfT[:, :n]) @ self._traj[:, :n]
        return ts, self._all(out).cpu().numpy()

    def ate_per_sequence(self, gt: np.ndarray) -> np.ndarray:
        """ATE RMSE (metres) per sequence against (B, n, 4, 4) ground truth."""
        _, est = self.poses()
        return np.asarray([
            ate_rmse(est[b], gt[b][: est.shape[1]])[0] for b in range(self.B)
        ])

    @property
    def keyframe_counts(self) -> np.ndarray:
        if self.mesh is None:
            return self._n_kf.copy()
        return self._all(torch.tensor(self._n_kf, device=self.device)).cpu().numpy()

    def map_point_counts(self) -> np.ndarray:
        return self._all(torch.stack(
            [smap.map_point_count(m) for m in self.maps])).cpu().numpy()

    @property
    def state(self) -> BatchState:
        """Frames fed and per-sequence lost / loops / relocalized counts."""
        if self.mesh is None:
            return self._state
        st = self._state
        counts = self._all(torch.tensor(
            np.stack([st.lost, st.loops, st.relocalized]), device=self.device), 1)
        lost, loops, reloc = counts.cpu().numpy()
        return BatchState(frames=st.frames, lost=lost, loops=loops, relocalized=reloc)
