"""Tracking session: the per-frame tracking path of the SLAM session.

Counterpart of the tracking path of `slam_rgbd_tpu/runtime/session.py`
(`SLAMSession.process_frame`, `_steady_step`, `_frame_summary`, the
trajectory ring and the pending-decision queue):

    frame -> pyramid -> ICP track -> keyframe decision -> trajectory ring

A positive keyframe decision moves the reference keyframe pose to the
frame's pose. There is no map yet: features, map association, relocalization
and the BA / loop backend come with later slices, so a lost frame keeps
integrating odometry (the reference's fallback between relocalization
attempts).

Decision pipelining as in the reference: frame t queues its tracking and a
(4,) control summary on the device and starts an asynchronous copy of the
summary to pinned host memory, marked by a CUDA event. The decisions of
frame t are applied at the start of a later call, once the event has
completed, or forced when `runtime.max_decision_lag` frames are in flight.
Steady-state tracking never waits on the device.
"""

from __future__ import annotations

import collections
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from slam_rgbd_tpu.core.config import (
    CameraIntrinsics, ICPConfig, KeyframeConfig, SLAMConfig,
)
from slam_rgbd_tpu_torch.core import camera
from slam_rgbd_tpu_torch.eval.trajectory import save_trajectory_tum
from slam_rgbd_tpu_torch.mapping.map import should_insert_keyframe
from slam_rgbd_tpu_torch.odometry.icp import track_frame

log = logging.getLogger("slam_rgbd_tpu_torch.session")


def _frame_summary(T_world, last_kf_T, valid_fraction, rmse,
                   kcfg: KeyframeConfig) -> torch.Tensor:
    """The per-frame control scalars in one (4,) tensor: inlier fraction,
    ICP rmse, pose finiteness, keyframe decision."""
    finite = torch.isfinite(T_world).all()
    should = should_insert_keyframe(T_world, last_kf_T, valid_fraction, kcfg)
    return torch.stack([
        valid_fraction.to(torch.float32), rmse.to(torch.float32),
        finite.to(torch.float32), should.to(torch.float32),
    ])


def _steady_step(
    prev_pyr, depth_raw, rgb, T_world, motion, last_kf_T,
    buf_T, buf_kfT, traj_i: int,
    cam: CameraIntrinsics, icp_cfg: ICPConfig, kcfg: KeyframeConfig,
):
    """One steady-state frame: pyramid, coarse-to-fine track, control
    summary, and the trajectory-ring writes (in place, as the reference
    donates its ring buffers)."""
    pyr = camera.build_frame_pyramid(depth_raw, cam, levels=icp_cfg.levels, rgb=rgb)
    T_world, motion, res = track_frame(prev_pyr, pyr, T_world, motion, cam, icp_cfg)
    summary = _frame_summary(T_world, last_kf_T, res.valid_fraction, res.rmse, kcfg)
    buf_T[traj_i] = T_world
    buf_kfT[traj_i] = last_kf_T
    return pyr, T_world, motion, summary, buf_T, buf_kfT


@dataclass
class FrameStats:
    timestamp: float
    track_ms: float
    inlier_fraction: float
    icp_rmse: float
    is_keyframe: bool
    tracking_ok: bool


@dataclass
class SessionState:
    frames: int = 0
    keyframes: int = 0
    lost: int = 0


@dataclass
class _PendingFrame:
    """A frame whose control decisions are still in flight."""

    summary: torch.Tensor  # (4,) on the host (pinned when the device is CUDA)
    event: "torch.cuda.Event | None"  # completes when `summary` has landed
    st: FrameStats
    ts: float
    frame_i: int
    T: torch.Tensor  # (4, 4) this frame's pose on the device

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def values(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return self.summary.tolist()


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TrackingSession(device='cuda') but torch sees no CUDA device"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class TrackingSession:
    """Tracking-only RGB-D session over one sequence.

    Call `process_frame(ts, depth_raw, rgb)` per frame, then `poses()` /
    `save_trajectory()` and `stats`. `device` is "cpu" or "cuda"; asking
    for CUDA without a card raises. On CUDA the session turns TF32 off for
    matrix products and cuDNN, since the 6x6 solves and pose products need
    full float32.
    """

    def __init__(self, config: SLAMConfig, device="cpu"):
        self.cfg = config
        self.device = _resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.state = SessionState()
        self.stats: list[FrameStats] = []
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self.T_world = eye
        self.motion = eye
        self.last_kf_T = eye
        self.prev_pyr = None
        self._pending: collections.deque[_PendingFrame] = collections.deque()
        self._frame_i = 0
        self._last_kf_frame_i = -(10 ** 9)
        # frames dispatched before the newest keyframe resolved carry a
        # decision against the old reference pose; theirs are suppressed
        self._kf_ref_fresh_from = 0
        # device-side trajectory ring: pose and reference-keyframe pose per
        # frame, fetched once in `poses()`
        self._traj_ts: list[float] = []
        self._traj_cap = 4096
        self._traj_T = torch.zeros((self._traj_cap, 4, 4), device=self.device)
        self._traj_kfT = torch.zeros((self._traj_cap, 4, 4), device=self.device)

    # ------------------------------------------------------------- inputs
    def _upload(self, x) -> torch.Tensor:
        """A frame array onto the session's device. uint16 depth becomes
        int32 on the host first: torch has few uint16 kernels."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        x = np.asarray(x)
        if x.dtype == np.uint16:
            x = x.astype(np.int32)
        return torch.tensor(x, device=self.device)

    # ---------------------------------------------------------- main loop
    def process_frame(self, ts: float, depth_raw, rgb) -> FrameStats:
        """Track one frame (depth in sensor units, RGB uint8), after
        resolving the decisions of earlier frames that have landed."""
        t0 = time.monotonic()
        self._drain_pending(
            block=len(self._pending) >= self.cfg.runtime.max_decision_lag
        )
        depth_t = self._upload(depth_raw)
        rgb_t = self._upload(rgb)

        if self.prev_pyr is None:
            # first frame: bootstrap keyframe at the current pose
            self.prev_pyr = camera.build_frame_pyramid(
                depth_t, self.cfg.camera, levels=self.cfg.icp.levels, rgb=rgb_t
            )
            st = FrameStats(ts, 0.0, 1.0, 0.0, True, True)
            self._last_kf_frame_i = self._frame_i
            self._insert_keyframe(self.T_world)
            self._log_pose(ts)
            self._frame_i += 1
            return self._finish(st, t0)

        traj_i = len(self._traj_ts)
        if traj_i >= self._traj_cap:
            self._grow_traj_ring()
        (self.prev_pyr, self.T_world, self.motion, summary,
         self._traj_T, self._traj_kfT) = _steady_step(
            self.prev_pyr, depth_t, rgb_t, self.T_world, self.motion,
            self.last_kf_T, self._traj_T, self._traj_kfT, traj_i,
            self.cfg.camera, self.cfg.icp, self.cfg.keyframes,
        )
        self._traj_ts.append(ts)
        st = FrameStats(ts, 0.0, -1.0, -1.0, False, True)  # until it lands
        self._pending.append(_PendingFrame(
            *self._fetch_async(summary), st=st, ts=ts,
            frame_i=self._frame_i, T=self.T_world,
        ))
        self._frame_i += 1
        return self._finish(st, t0)

    def _fetch_async(self, summary: torch.Tensor):
        """Start the summary's copy to the host; (host tensor, event)."""
        if self.device.type == "cpu":
            return summary, None
        host = torch.empty(summary.shape, dtype=summary.dtype, pin_memory=True)
        host.copy_(summary, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def _drain_pending(self, block: bool = False):
        """Resolve every frame whose summary has landed, and (when `block`)
        the oldest one regardless."""
        while self._pending:
            if not block and not self._pending[0].ready():
                return
            block = False
            self._resolve_entry(self._pending.popleft())

    def _resolve_entry(self, e: _PendingFrame):
        """Apply one frame's control decisions."""
        vf, rmse, finite, should = e.values()
        e.st.inlier_fraction = vf
        e.st.icp_rmse = rmse
        e.st.tracking_ok = vf > 0.25 and finite > 0.5
        if not e.st.tracking_ok:
            self.state.lost += 1
            log.warning(
                "tracking degraded at t=%.3f (inliers %.2f); integrating "
                "odometry", e.ts, vf,
            )
            return
        gap_ok = (
            e.frame_i - self._last_kf_frame_i
            >= self.cfg.keyframes.kf_min_gap_frames
        )
        fresh = e.frame_i >= self._kf_ref_fresh_from
        if should > 0.5 and gap_ok and fresh:
            e.st.is_keyframe = True
            self._last_kf_frame_i = e.frame_i
            self._insert_keyframe(e.T)

    def _insert_keyframe(self, T_pose: torch.Tensor):
        self.last_kf_T = T_pose
        self._kf_ref_fresh_from = self._frame_i
        self.state.keyframes += 1

    def flush_pipeline(self):
        """Finalize every pending frame's decisions and stats."""
        while self._pending:
            self._resolve_entry(self._pending.popleft())

    def _finish(self, st: FrameStats, t0: float) -> FrameStats:
        st.track_ms = (time.monotonic() - t0) * 1e3
        self.state.frames += 1
        self.stats.append(st)
        return st

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
        self._traj_T[i] = self.T_world
        self._traj_kfT[i] = self.last_kf_T

    def reset(self):
        """Full reset: a fresh session on the same config and device."""
        self.__init__(self.cfg, self.device)

    # ------------------------------------------------------------ outputs
    def poses(self) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps (n,), camera-to-world poses (n, 4, 4)), one fetch.

        Without a map no keyframe pose is ever corrected, so each frame's
        pose is the tracked one as logged.
        """
        self.flush_pipeline()
        n = len(self._traj_ts)
        return np.asarray(self._traj_ts), self._traj_T[:n].cpu().numpy()

    def save_trajectory(self, path: str):
        """TUM-format full trajectory (`SaveTrajectoryTUM` parity)."""
        ts, T = self.poses()
        save_trajectory_tum(path, ts, T)
