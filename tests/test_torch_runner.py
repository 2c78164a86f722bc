"""The port's pipeline runner, control menu, watchdog and span recorder on
the CPU.

`run(threads=False)` equals the session driven directly; a threaded run
accounts for every frame as processed or dropped; SHUTDOWN ends an endless
run (waited for by its frame count, not a fixed sleep); a scripted
`ControlMenu` records a tee and resets; the ATE of a run that dropped frames,
paired by timestamp and by position; the watchdog; the sessions' spans, by
frame and by backend job, in the metrics sink and in a profiler's events.
"""

import io
import threading
import time

import numpy as np
import pytest
import torch

from slam_rgbd_tpu_torch.core.config import (
    CameraIntrinsics, ICPConfig, KeyframeConfig, ORBConfig, RuntimeConfig, SLAMConfig,
    StreamConfig,
)
from slam_rgbd_tpu_torch.eval.trajectory import ate_by_timestamp, ate_rmse
from slam_rgbd_tpu_torch.io import stream as st
from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence
from slam_rgbd_tpu_torch.runtime.batch_session import BatchSession
from slam_rgbd_tpu_torch.runtime.profiling import MetricsLog
from slam_rgbd_tpu_torch.runtime.runner import ControlMenu, PipelineRunner
from slam_rgbd_tpu_torch.runtime.session import SLAMSession
from slam_rgbd_tpu_torch.runtime.watchdog import GracefulShutdown, Watchdog

torch.set_num_threads(1)

CAM = CameraIntrinsics(fx=90.0, fy=90.0, cx=47.5, cy=35.5, width=96, height=72)


def small_config(**kw) -> SLAMConfig:
    return SLAMConfig(
        camera=CAM,
        icp=ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2)),
        orb=ORBConfig(n_features=128, n_levels=4),
        keyframes=KeyframeConfig(max_keyframes=16, max_map_points=2048),
        runtime=RuntimeConfig(metrics_every_frames=4),
        **kw,
    )


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(16, CAM, device="cpu")
    return list(seq), seq.groundtruth()


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def test_unthreaded_run_equals_direct_calls(frames):
    seq, _ = frames
    cfg = small_config()
    runner = PipelineRunner(cfg, iter(seq[:8]), async_backend=False, device="cpu")
    sess = runner.run(threads=False)
    direct = SLAMSession(cfg, device="cpu")
    for f in seq[:8]:
        direct.process_frame(*f)
    (ts1, p1), (ts2, p2) = sess.poses(), direct.poses()
    np.testing.assert_array_equal(ts1, ts2)
    np.testing.assert_array_equal(p1, p2)
    assert sess.state.keyframes == direct.state.keyframes
    assert sess.metrics is runner.metrics
    assert len(runner.metrics.by_kind("frame_window")) == 2  # frames 4 and 8
    rec = runner.metrics.by_kind("frame_window")[-1]
    assert rec["frames"] == 8 and rec["map_points"] == direct.map_point_count()
    assert len(sess.stats) == 8
    assert runner.metrics.spans is None and sess.timer.report() == {}  # none kept


def test_threaded_run_accounts_for_every_frame(frames):
    seq, _ = frames
    runner = PipelineRunner(small_config(stream=StreamConfig(queue_capacity=4, queue_drop_to=2)),
                            iter(seq), device="cpu")
    sess = runner.run(threads=True)
    assert sess.state.frames + runner.queue.dropped == len(seq)
    assert sess.state.frames >= 2 and not sess.state.running
    assert sess.worker is None  # closed by stop()
    assert runner.metrics.by_kind("queue") or sess.state.frames < 4


def test_shutdown_verb_ends_an_endless_run(frames):
    seq, _ = frames

    def endless():
        i = 0
        while True:
            yield (i / 30.0,) + tuple(seq[i % 4][1:])
            i += 1
            time.sleep(0.005)

    runner = PipelineRunner(small_config(), endless(), device="cpu")
    t = threading.Thread(target=runner.run)
    t.start()
    _wait(lambda: runner.session.state.frames > 0)
    runner.control.send(st.ControlCommand.SHUTDOWN)
    t.join(timeout=30)
    assert not t.is_alive()
    assert runner.session.state.frames > 0 and not runner.shutdown.forced


def test_scripted_control_menu(frames, tmp_path):
    """s, 1 <tee>, 2, r, an unknown verb and q, each once the run reaches a
    frame count: a status line, a tee that reads back as frames of the
    source, a reset, and a shutdown before the source ends."""
    seq, _ = frames
    tee = tmp_path / "tee.rgbd"

    def slow():
        for i in range(400):
            yield (i / 30.0,) + tuple(seq[i % len(seq)][1:])
            time.sleep(0.01)

    runner = PipelineRunner(small_config(), slow(), device="cpu")
    frames_now = lambda: runner.session.state.frames  # noqa: E731
    seen = {}

    def lines():
        for at, line in ((1, "s"), (2, f"1 {tee}"), (5, "2"), (6, "r")):
            _wait(lambda at=at: frames_now() >= at)
            seen["before_reset"] = frames_now()
            yield line + "\n"
        # the consumer resets between two frames: the count starts again
        _wait(lambda: frames_now() < seen["before_reset"])
        seen["reset"] = True
        yield "?\n"
        _wait(lambda: frames_now() >= 2)
        yield "q\n"

    out = io.StringIO()
    menu = ControlMenu(runner, infile=lines(), outfile=out)
    menu.start()
    runner.run(threads=True)
    menu._thread.join(timeout=10)
    text = out.getvalue()
    assert "menu:" in text and "status: frames=" in text and "recording -> " in text
    assert "recording stopped" in text and "reset requested" in text
    assert "shutting down" in text and not runner.shutdown.forced
    teed = list(st.StreamReader(str(tee)))
    assert len(teed) >= 1
    for ts, d, c in teed:
        src = seq[round(ts * 30) % len(seq)]
        np.testing.assert_array_equal(d, src[1])
        np.testing.assert_array_equal(c, src[2])
    assert seen.get("reset") and runner.session.state.frames < 400


def test_ate_of_a_run_with_drops_pairs_by_timestamp(frames):
    """A slow consumer behind a fast producer: the queue drops frames, so
    estimate i is no longer frame i. Paired by timestamp the ATE is the
    tracker's; paired by position (the reference's `gt[:len(est)]`) it
    compares estimates with the wrong poses."""
    # a slow orbit, so that the frames left after a drop still track
    seq = SyntheticSequence(30, CAM, step_t=0.005, step_r=0.004, device="cpu")
    source = list(seq)
    gt = seq.groundtruth()
    cfg = small_config(stream=StreamConfig(queue_capacity=4, queue_drop_to=2))
    runner = PipelineRunner(cfg, st.paced(iter(source), 30.0), async_backend=False,
                            device="cpu")
    real = runner.session.process_frame

    def slow(*a):
        time.sleep(0.05)
        return real(*a)

    runner.session.process_frame = slow
    sess = runner.run(threads=True)
    ts, est = sess.poses()
    assert runner.queue.dropped > 0 and len(est) + runner.queue.dropped == 30
    assert sess.state.lost == 0
    by_time = ate_by_timestamp(ts, est, seq.timestamps, gt)
    by_position = ate_rmse(est, gt[: len(est)])[0]
    print(f"dropped {runner.queue.dropped}: ATE by time {by_time:.5f} m, by position "
          f"{by_position:.5f} m")
    assert by_time < 0.02
    assert by_position > 2 * by_time


def test_watchdog_detects_a_stall():
    beat = {"t": time.monotonic()}
    stalls = []
    wd = Watchdog(lambda: beat["t"], stall_timeout_s=0.2, period_s=0.05,
                  on_stall=stalls.append).start()
    _wait(lambda: wd.stalls >= 1, timeout=5.0)
    wd.stop()
    assert stalls and wd.stalls == 1  # once a stall, not once a poll


def test_watchdog_no_false_stall():
    beat = {"t": time.monotonic()}
    stop = threading.Event()

    def beater():
        while not stop.is_set():
            beat["t"] = time.monotonic()
            time.sleep(0.02)

    t = threading.Thread(target=beater)
    t.start()
    wd = Watchdog(lambda: beat["t"], stall_timeout_s=0.2, period_s=0.05).start()
    time.sleep(0.5)
    wd.stop()
    stop.set()
    t.join(timeout=5)
    assert wd.stalls == 0


def test_graceful_shutdown_forces_a_stuck_worker():
    ev = threading.Event()
    forced = []
    t = threading.Thread(target=lambda: ev.wait(5.0), name="stuck")
    t.start()
    gs = GracefulShutdown(timeout_s=0.3, on_force=lambda: forced.append(True))
    assert not gs.request([t]) and gs.forced and forced
    ev.set()
    t.join(timeout=5)
    done = threading.Thread(target=lambda: None)
    done.start()
    assert GracefulShutdown(timeout_s=1.0).request([done])


def _open_and_close(timer, name):
    with timer.section(name):
        pass


def test_profiling_tools(tmp_path):
    from slam_rgbd_tpu.runtime import profiling as jprof
    from slam_rgbd_tpu_torch.runtime import profiling as tprof

    timers = [tprof.StageTimer(tprof.MetricsLog(spans=True)), jprof.StageTimer()]
    for dt in (0.004, 0.002, 0.006):
        timers[0].span("track", 0.0, dt)
        timers[1].add("track", dt)
    assert timers[0].report() == timers[1].report()
    log = tprof.MetricsLog(str(tmp_path / "m.jsonl"))
    log.log("queue", depth=3, dropped=0)
    log.close()
    rec = [__import__("json").loads(ln) for ln in open(tmp_path / "m.jsonl")]
    assert rec[0]["kind"] == "queue" and log.by_kind("queue")[0]["depth"] == 3

    # spans: nested by thread, the call id inherited; kept only by a sink
    # that keeps spans, and otherwise a section does nothing
    log = tprof.MetricsLog(spans=True)
    for t in (tprof.StageTimer(), tprof.StageTimer(tprof.MetricsLog()),
              tprof.StageTimer(log)):
        with t.section("a", call=7) as a:
            with t.section("a.b"):
                pass
        other = threading.Thread(target=_open_and_close, args=(t, "c"))
        other.start()
        other.join()
        t.span("x", 1.0, 2.0, call=3)
        assert (a is None) == (t.sink is None or t.sink.spans is None)
    me = threading.get_native_id()
    got = {s.name: s for s in log.spans}
    assert [s.name for s in log.spans] == ["a.b", "a", "c", "x"]
    assert got["a.b"][3:] == (me, "a", 7) and got["a"][3:] == (me, None, 7)
    assert got["a"].start <= got["a.b"].start <= got["a.b"].end <= got["a"].end
    assert got["c"].thread != me and got["c"][4:] == (None, -1)
    assert got["x"][1:] == (1.0, 2.0, me, None, 3)
    assert list(tprof.StageTimer(log).report()) == ["a.b", "a", "c", "x"]


def test_session_spans_nest_by_frame_and_job(frames):
    """A threaded session with a sink: a `session.frame` span a call, its
    stages nested under it with the frame's call id, and a `worker.queue`
    span for each job that ran, with the call id of the frame that made
    it; `track_ms` covers the frame span."""
    seq, _ = frames
    log = MetricsLog(spans=True)
    sess = SLAMSession(small_config(), async_backend=True, device="cpu", metrics=log)
    try:
        for f in seq[:6]:
            sess.process_frame(*f)
        sess.sync_backend()
        completed = sess.worker.completed
    finally:
        sess.close()
    me = threading.get_native_id()
    spans = log.spans
    frames_ = [s for s in spans if s.name == "session.frame"]
    assert [s.call for s in frames_] == list(range(6))
    assert all(s.thread == me and s.parent is None for s in frames_)
    assert all(s.end - s.start <= st.track_ms / 1e3 + 1e-6
               for s, st in zip(frames_, sess.stats))
    by_call = {s.call: s for s in frames_}
    nest = {"session.upload": "session.frame", "session.decide": "session.frame",
            "session.track": "session.frame", "session.wait": "session.decide",
            "session.insert": "session.decide", "session.insert.features": "session.insert",
            "session.insert.map": "session.insert"}
    for s in spans:
        if s.name in nest and s.call >= 0:  # (the drain's spans belong to no call)
            f = by_call[s.call]
            # frame 0's keyframe is the bootstrap, inserted by the call itself
            want = "session.frame" if (s.name, s.call) == ("session.insert", 0) else nest[s.name]
            assert s.parent == want and s.thread == me
            assert f.start <= s.start <= s.end <= f.end
    assert set(nest) <= {s.name for s in spans}
    jobs = {s.call for s in spans if s.name == "session.insert"}
    queued = [s for s in spans if s.name == "worker.queue"]
    assert queued and len(queued) == completed and {s.call for s in queued} <= jobs
    assert all(s.parent is None and s.end >= s.start for s in queued)
    merges = [r["backend_ms"] for r in log.by_kind("backend")]
    assert merges and all(ms >= 0 for ms in merges)


class _Landing:
    """A stand-in for a CUDA event whose copy lands at the `after`-th
    query."""

    def __init__(self, after):
        self.after = after

    def query(self):
        self.after -= 1
        return self.after < 0

    def synchronize(self):
        self.after = -1


@pytest.mark.parametrize("end", ["sync_backend", "close"])
def test_frame_window_waits_for_its_point_count(frames, end):
    """A `frame_window` record waits, without blocking, for its map point
    count: it is logged by the first call that finds the copy landed, with
    the count of its own frame, and a drain or a close logs a waiting
    one."""
    seq, _ = frames
    log = MetricsLog()
    sess = SLAMSession(small_config(), device="cpu", metrics=log)
    sess._fetch_async = lambda t: (t, _Landing(1))  # as on a card
    counts = []
    for f in seq[:9]:
        sess.process_frame(*f)
        counts.append(sess.map_point_count())
        if sess.state.frames in (4, 5):
            assert not log.by_kind("frame_window")  # frame 4's count is in flight
    assert [r["frames"] for r in log.by_kind("frame_window")] == [4]
    getattr(sess, end)()
    recs = log.by_kind("frame_window")
    assert [r["frames"] for r in recs] == [4, 8]
    assert [r["map_points"] for r in recs] == [counts[3], counts[7]]


def test_batch_spans_nest_by_step(frames):
    """A batch session with a sink: a `batch.step` span a step with the
    step's index as call id, its stages nested under it, and the keyframe
    stages under `batch.insert`, the bootstrap's among them."""
    seq, _ = frames
    log = MetricsLog(spans=True)
    batch = BatchSession(small_config(), 2, device="cpu", metrics=log)
    for t in range(3):
        batch.process_frames(t / 30, np.stack([seq[t][1], seq[t + 1][1]]),
                             np.stack([seq[t][2], seq[t + 1][2]]))
    steps = {s.call: s for s in log.spans if s.name == "batch.step"}
    assert sorted(steps) == [0, 1, 2] and all(s.parent is None for s in steps.values())
    nest = {"batch.upload": "batch.step", "batch.track": "batch.step",
            "batch.fetch": "batch.step", "batch.insert": "batch.step",
            "batch.features": "batch.insert", "batch.ba": "batch.insert"}
    for s in log.spans:
        if s.name in nest:
            assert s.parent == nest[s.name]
            assert steps[s.call].start <= s.start <= s.end <= steps[s.call].end
    assert {s.call for s in log.spans if s.name == "batch.track"} == {1, 2}
    inserts = [s.call for s in log.spans if s.name == "batch.insert"]
    assert inserts[0] == 0 and inserts == [
        s.call for s in log.spans if s.name == "batch.features"]


def test_spans_are_ranges_in_the_profiler(frames):
    """While a profiler records, the spans of `SLAMSession` frames and of a
    `BatchSession` step are host ranges among its events, none of them a
    user annotation (which the profiler would mirror onto the device)."""
    seq, _ = frames
    cfg = small_config()
    sess = SLAMSession(cfg, device="cpu")
    batch = BatchSession(cfg, 2, device="cpu")
    depth = np.stack([seq[0][1], seq[1][1]])
    rgb = np.stack([seq[0][2], seq[1][2]])
    batch.process_frames(0.0, depth, rgb)
    sess.process_frame(*seq[0])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for f in seq[1:3]:
            sess.process_frame(*f)
        batch.process_frames(1 / 30, depth, rgb)
    events = prof.profiler.kineto_results.events()
    names = {e.name() for e in events}
    assert not any(e.is_user_annotation() for e in events if "." in e.name())
    assert {"session.frame", "session.upload", "session.decide", "session.wait",
            "session.track"} <= names
    assert {"batch.step", "batch.upload", "batch.track", "batch.fetch"} <= names
