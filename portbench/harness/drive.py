"""Drive the port over a cell's traffic: set-up, the measured window, and
what the output check and the metrics read afterwards.

Two drivers, one a kind of session in the configuration file:
  * `single`: `SLAMSession(cfg, async_backend=...)`, one stream, one
    `process_frame` a call; a recording ends with `flush_pipeline()` and
    `sync_backend(final_pass=True)`, and the next starts after `reset()`;
  * `batch`: `BatchSession(cfg, streams)`, one `process_frames` a call (a
    step of every stream); each recording is a new `BatchSession`.

Every call is timed by the host clock around it. The window holds whole
rounds: a round is one recording in each room (the single session), or one
recording (the batch, whose streams hold every room at once), each with
its drain. The window ends at the first round's end at or after
`--seconds`, so every window of a cell holds the same work, whatever the
seed and however many rounds fit; a `torch.cuda.synchronize()` closes it.
Frames are host arrays made before the window (the batch's per-step stacks
too); inside the window the harness hands them over and copies nothing.

The output check needs some of the program's own outputs from inside the
window. They are kept as references to tensors the program made, never
copied: the trajectory ring of each recording, and, for the check's fixed
keyframe and backend-job slots (the same at every seed, so the kept memory
is too), the map before and after the insert and the backend job's
snapshot with the result that merged. The wraps that keep them name the
program's private methods (`SLAMSession._insert_keyframe`, `._backend`,
`._apply_backend`, `BatchSession._insert` and the module's `_batch_ba`),
and read `_deferred_job`, `_n_kf_host`, `_traj_arrays`, `_n_kf`, `_state`,
`_traj` and `_traj_ts`: a change to the program that renames them has to
bring this file along.

Loop capture (the single session, only where the mix's `checks` name
`loop_gap_mm`; otherwise nothing below is wrapped or kept). The worker's
`BackendWorker._pass` is wrapped on each recording's worker: a pass that
ends keeps its job (the snapshot `map`, `edges`, `n_edges`, `kf_idx`,
`n_kf`) beside its result until `_apply_backend` takes that result, merged
or dropped, so at most one snapshot is kept beyond those the worker holds.
The `_apply_backend` wrap keeps, for the first `KEPT_LOOPS` passes of a
recording that merged a closed loop (`state.loops` rose), the job and the
result's `kf_pose`, `pt_xyz`, `pt_adjusted`, `loop_edge`, `fuse_row`,
`pt_invalidate`, `pt_nobs_delta`, `n_fused` and `global_ba_rmse`. The cap
is fixed, so the kept memory is the same at every seed. The drain's final
pass runs outside the worker and is never kept.

Spans and records: a traced run hands the session (each recording's
`BatchSession` too, not the warm-up's) a `MetricsLog(spans=True)`; set-up's
spans and records are cleared at its end, and the window's are copied into
the `Record` once the window has closed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.harness import traffic

KEPT_LOOPS = 2  # closing passes kept a recording, with loop capture


@dataclass
class Recording:
    frames: np.ndarray  # (calls, streams) frame index of each call
    est: np.ndarray | None = None  # (streams, n, 4, 4) the session's poses
    points: list = field(default_factory=list)  # valid map points a stream at the end
    ring: dict = field(default_factory=dict)  # raw logs for the check
    kf_captures: list = field(default_factory=list)
    ba_captures: dict = field(default_factory=dict)
    loop_captures: list = field(default_factory=list)
    completed: int = 0
    skipped: int = 0
    loops: int | None = None  # loops the single session merged


@dataclass
class Record:
    kind: str
    streams: int
    calls: list = field(default_factory=list)  # {"kind", "ms", "t", "traced"}
    recordings: list = field(default_factory=list)
    window_s: float = 0.0
    frames_done: int = 0
    backend_ms: list = field(default_factory=list)
    trace: dict | None = None
    t0: float = 0.0  # `time.perf_counter()` at the window's start
    spans: list = field(default_factory=list)  # the window's `Span`s, traced runs
    log: list = field(default_factory=list)  # the window's `MetricsLog` records


class _Driver:
    def __init__(self, cfg, conf: dict, depth: np.ndarray, rgb: np.ndarray, mix: dict,
                 device, sample, rooms: np.ndarray):
        self.cfg = cfg
        self.conf = conf
        self.depth = depth
        self.rgb = rgb
        self.mix = mix
        self.device = device
        self.sample = sample  # the check's seed-drawn sample (see check.Sample)
        self.streams = int(conf["streams"])
        self.fps = cfg.camera.fps
        self.rooms = rooms  # the seed's order of the rooms
        self.n_frames = int(mix["frames"])
        self.loops = "loop_gap_mm" in mix["checks"]  # keep closing passes
        self.metrics = None

    # recordings a round: every room once
    round_recordings = 1

    def offsets(self, r_i: int) -> np.ndarray:
        """(streams,) id offset of each stream's room in recording r_i."""
        raise NotImplementedError

    def run(self, seconds: float, tracer=None) -> Record:
        """Whole rounds of recordings, until the first round's end at or
        after `seconds`."""
        rec = Record(kind=self.conf["session"], streams=self.streams)
        frames = traffic.schedule(self.mix, self.streams, traffic.recording_calls(self.mix))
        t0 = rec.t0 = time.perf_counter()
        deadline = t0 + seconds
        r_i = 0
        while r_i % self.round_recordings or time.perf_counter() < deadline:
            offset = self.offsets(r_i)
            recording = Recording(frames=frames + offset)
            self.begin(recording, r_i)
            for t, row in enumerate(recording.frames):
                traced = tracer is not None and tracer.wants(time.perf_counter() - t0)
                c0 = time.perf_counter()
                kind = self.call(t, row)
                c1 = time.perf_counter()
                rec.calls.append({"kind": kind, "ms": (c1 - c0) * 1e3, "t": c0 - t0,
                                  "traced": traced})
                rec.frames_done += self.streams
            self.end(recording, rec)
            rec.recordings.append(recording)
            r_i += 1
        if tracer is not None:
            tracer.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rec.window_s = time.perf_counter() - t0
        self.finish(rec)
        if self.metrics is not None:
            rec.spans = list(self.metrics.spans or ())
            rec.log = list(self.metrics.records)
        return rec

    def _clear(self, metrics):
        """Forget set-up's spans and records (in place: the session's timer
        holds the list)."""
        if metrics is not None:
            metrics.records.clear()
            if metrics.spans is not None:
                metrics.spans.clear()


class SingleDriver(_Driver):
    """`SLAMSession` over one stream."""

    def setup(self, metrics=None):
        from slam_rgbd_tpu_torch.runtime.session import SLAMSession

        self.round_recordings = len(self.rooms)
        self.metrics = metrics
        self.sess = SLAMSession(self.cfg, async_backend=bool(self.conf["async_backend"]),
                                device=self.device, metrics=metrics)
        self.sess.warmup()
        warm = traffic.schedule(self.mix, 1, int(self.mix["warm_calls"])) + self.offsets(0)
        for t, f in enumerate(warm[:, 0]):
            self.sess.process_frame(t / self.fps, self.depth[f], self.rgb[f])
        self._drain()
        self.sess.reset()
        self._clear(metrics)
        self._hook()

    def offsets(self, r_i: int) -> np.ndarray:
        return np.array([self.rooms[r_i % len(self.rooms)] * self.n_frames])

    def _drain(self):
        self.sess.flush_pipeline()
        self.sess.sync_backend(timeout=60.0, final_pass=True)

    def _hook(self):
        """Wrap the session's insert, backend submit and merge, to keep
        references to the sampled keyframes' maps and backend jobs, and
        with loop capture on the closing passes that merged."""
        s = self.sess
        real_insert, real_backend, real_apply = (
            s._insert_keyframe, s._backend, s._apply_backend)
        self.merged = 0
        self.ended = {}  # id(result) -> (result, job): passes not yet merged

        def insert(ts, depth_t, rgb_t, T_pose=None):
            k = s._n_kf_host
            pre = s.map
            out = real_insert(ts, depth_t, rgb_t, T_pose)
            if out is not None and k in self.sample.keyframes:
                self.recording.kf_captures.append({"k": k, "ts": ts, "pre": pre, "post": s.map})
            return out

        def backend(kf_idx):
            out = real_backend(kf_idx)
            job = s._deferred_job
            if job is not None and job.kf_idx == kf_idx and kf_idx in self.sample.ba_jobs:
                m = job.map
                self.recording.ba_captures[kf_idx] = {
                    "n_kf": job.n_kf, "generation": job.generation,
                    "input": (m.kf_pose, m.pt_xyz, m.kp_uv, m.kp_pts, m.point_id, m.kp_ok)}
            return out

        def apply(r):
            if r is not None:
                self.merged += 1
                cap = self.recording.ba_captures.get(r.snap_kf_idx)
                if cap is not None and r.generation == cap["generation"]:
                    cap["result"] = (r.kf_pose, r.pt_xyz, r.pt_adjusted, r.loop_edge is not None)
            if not self.loops:
                return real_apply(r)
            ended = None if r is None else self.ended.pop(id(r), None)
            loops = s.state.loops
            out = real_apply(r)
            if (ended is not None and ended[0] is r and s.state.loops > loops
                    and len(self.recording.loop_captures) < KEPT_LOOPS):
                self._keep_loop(*ended)
            return out

        s._insert_keyframe, s._backend, s._apply_backend = insert, backend, apply

    def _hook_worker(self):
        """With loop capture, wrap this recording's worker's pass, to keep
        each job until its result is merged or dropped."""
        w = self.sess.worker
        if not self.loops or w is None:
            return
        real_pass = w._pass
        ended = self.ended

        def pass_(job):
            r = real_pass(job)
            ended[id(r)] = (r, job)  # (one dict store: safe from the worker's thread)
            return r

        w._pass = pass_

    def _keep_loop(self, r, job):
        e = job.edges
        i, j, T_rel, _ = r.loop_edge
        self.recording.loop_captures.append({
            "kf_idx": job.kf_idx, "n_kf": job.n_kf, "snapshot": job.map,
            "edges": (e.i, e.j, e.T_meas, e.weight, e.valid), "n_edges": int(job.n_edges),
            "result": {"kf_pose": r.kf_pose, "pt_xyz": r.pt_xyz, "pt_adjusted": r.pt_adjusted,
                       "loop_edge": (i, j, T_rel), "fuse_row": r.fuse_row,
                       "pt_invalidate": r.pt_invalidate, "pt_nobs_delta": r.pt_nobs_delta,
                       "n_fused": r.n_fused, "global_ba_rmse": r.global_ba_rmse}})

    def begin(self, recording, r_i):
        if r_i:
            self.sess.reset()
        self.ended.clear()
        self.recording = recording
        self._hook_worker()

    def call(self, t, frames):
        s = self.sess
        kf, merged = s.state.keyframes, self.merged
        f = frames[0]
        s.process_frame(t / self.fps, self.depth[f], self.rgb[f])
        inserted, merged = s.state.keyframes > kf, self.merged > merged
        return ("insert+merge" if inserted and merged else "insert" if inserted
                else "merge" if merged else "tracked")

    def end(self, recording, rec):
        s = self.sess
        self._drain()
        # copies: on the CPU the arrays would share the ring that reset() zeroes
        _, T, kf_idx, kfT = (np.array(x) for x in s._traj_arrays())
        recording.ring = {"T": T, "kf_idx": kf_idx, "kfT": kfT, "n_kf": s._n_kf_host,
                          "ok": np.array([st.inlier_fraction > 0.25 for st in s.stats])}
        recording.est = s.poses()[1][None]
        recording.points = [int(s.map.pt_valid.sum())]
        recording.loops = s.state.loops
        if s.worker is not None:
            recording.completed, recording.skipped = s.worker.completed, s.worker.skipped

    def finish(self, rec):
        if self.metrics is not None:
            rec.backend_ms = [r["backend_ms"] for r in self.metrics.by_kind("backend")]

    def close(self):
        self.sess.close()
        self.sess = None


class BatchDriver(_Driver):
    """`BatchSession` over `streams` sequences in lockstep; the per-step
    stacks of frames are assembled in set-up."""

    def setup(self, metrics=None):
        from slam_rgbd_tpu_torch.runtime.batch_session import BatchSession
        from slam_rgbd_tpu_torch.runtime.session import SLAMSession

        self.BatchSession = BatchSession
        n_rec = traffic.recording_calls(self.mix)
        sched = traffic.schedule(self.mix, self.streams, min(n_rec, traffic.period(self.mix)))
        sched = sched + self.offsets(0)
        self.steps = [(np.ascontiguousarray(self.depth[row]), np.ascontiguousarray(self.rgb[row]))
                      for row in sched]
        scratch = SLAMSession(self.cfg, device=self.device)
        try:
            scratch.warmup()  # the keyframe and BA programs at these shapes
        finally:
            scratch.close()
        warm = self.BatchSession(self.cfg, self.streams, device=self.device)
        for t in range(int(self.mix["warm_calls"])):
            d, c = self.steps[t % len(self.steps)]
            warm.process_frames(t / self.fps, d, c)
        del warm
        self.metrics = metrics
        self._clear(metrics)

    def offsets(self, r_i: int) -> np.ndarray:
        """Stream b stays in the b-th room of the order in every recording,
        so the step stacks are assembled once."""
        b = np.arange(self.streams)
        return self.rooms[b % len(self.rooms)] * self.n_frames

    def begin(self, recording, r_i):
        self.bs = None
        self.bs = self.BatchSession(self.cfg, self.streams, device=self.device,
                                    metrics=self.metrics)
        self.corrected, self.lost = [], []
        self.recording = recording
        self._hook()

    def _hook(self):
        """Wrap the session's keyframe step and its BA pass, to keep
        references to the sampled keyframes' maps before and after."""
        from slam_rgbd_tpu_torch.runtime import batch_session

        bs = self.bs
        real_insert = bs._insert
        real_ba = batch_session._batch_ba

        def insert(ts, depth, rgb, do_insert):
            n_kf, pre, T_pose = bs._n_kf.copy(), list(bs.maps), bs.T_world

            def ba(maps, T_world, do_ba, cfg):
                out = real_ba(maps, T_world, do_ba, cfg)
                for b in np.flatnonzero(do_ba):
                    k = int(bs._n_kf[b]) - 1
                    if k in self.sample.ba_jobs and b in self.sample.streams:
                        m = maps[b]
                        self.recording.ba_captures[(int(b), k)] = {
                            "n_kf": k + 1, "generation": 0,
                            "input": (m.kf_pose, m.pt_xyz, m.kp_uv, m.kp_pts, m.point_id,
                                      m.kp_ok),
                            "valid": m.pt_valid,
                            "result": (out[0][b].kf_pose, out[0][b].pt_xyz, None, False)}
                return out

            batch_session._batch_ba = ba
            try:
                real_insert(ts, depth, rgb, do_insert)
            finally:
                batch_session._batch_ba = real_ba
            for b in np.flatnonzero(do_insert):
                k = int(n_kf[b])
                if k in self.sample.keyframes and b in self.sample.streams:
                    self.recording.kf_captures.append({
                        "k": k, "ts": ts, "stream": int(b), "pre": pre[b], "post": bs.maps[b],
                        "T_pose": T_pose[b], "moved_by_ba": k >= 2})

        bs._insert = insert

    def call(self, t, frames):
        bs = self.bs
        n_kf, lost = bs._n_kf.copy(), bs._state.lost.copy()
        d, c = self.steps[t % len(self.steps)]
        bs.process_frames(t / self.fps, d, c)
        ins = bs._n_kf > n_kf
        # an insert with a BA pass (or a loop) corrects the step's pose
        self.corrected.append(ins & (bs._n_kf >= 3))
        self.lost.append(bs._state.lost > lost)
        return "insert" if ins.any() else "tracked"

    def end(self, recording, rec):
        bs = self.bs
        n = len(bs._traj_ts)
        recording.ring = {"T": np.array(bs._traj[:, :n].cpu()), "n_kf_streams": bs._n_kf.copy(),
                          "corrected": np.array(self.corrected), "lost": np.array(self.lost)}
        recording.est = bs.poses()[1]
        recording.points = torch.stack([m.pt_valid.sum() for m in bs.maps]).tolist()

    def finish(self, rec):
        pass

    def close(self):
        self.bs = None
