"""Threaded pipeline runner: source -> bounded queue -> SLAM consumer.

Counterpart of `slam_rgbd_tpu/runtime/runner.py`:

    producer thread:  the frame source (dataset, synthetic, replay, camera),
                      the recording tee, playback, the control verbs
    bounded queue:    `StreamConfig`'s capacity / drop-to policy
    consumer thread:  `SLAMSession.process_frame` a frame
    watchdog thread:  the session's heartbeat
    control channel:  START/STOP_RECORD, START/STOP_PLAYBACK, RESET, SHUTDOWN

The session is built on the caller's thread and driven from the consumer
thread; its backend, when `async_backend`, runs on a worker thread of its
own (with its own CUDA stream on a card). `run(threads=False)` drives the
same session from the caller's thread. RESET is carried out by the consumer
between two frames (the reference resets from the producer thread, under a
frame in flight).

With `mesh=`, the session is map-block sharded (`SLAMSession(cfg, mesh=)`,
inline or threaded backend as `async_backend` says), and every rank of the
mesh runs a runner over the same source. The threaded pipeline's queue then
drops no frame (the producer waits for room): each rank's drops would differ,
and every rank must process the same frames.
"""

from __future__ import annotations

import logging
import threading
from typing import Iterable, Optional

import numpy as np
import torch

from slam_rgbd_tpu_torch.core.config import SLAMConfig
from slam_rgbd_tpu_torch.io import stream as st
from slam_rgbd_tpu_torch.runtime.profiling import MetricsLog
from slam_rgbd_tpu_torch.runtime.session import SLAMSession
from slam_rgbd_tpu_torch.runtime.watchdog import GracefulShutdown, Watchdog

log = logging.getLogger("slam_rgbd_tpu_torch.runner")


def _host(x) -> np.ndarray:
    """A frame array on the host (a device tensor is brought back)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class PipelineRunner:
    def __init__(self, config: SLAMConfig, source: Iterable[st.Frame],
                 async_backend: bool = True, device="cuda", mesh=None):
        self.cfg = config
        self.source = source
        # one metrics sink: the session logs "frame_window" and "backend"
        # records into it, the runner "queue" records
        self.metrics = MetricsLog()
        self.session = SLAMSession(config, async_backend=async_backend,
                                   device=device, metrics=self.metrics, mesh=mesh)
        self.queue = st.BoundedFrameQueue(
            config.stream.queue_capacity, config.stream.queue_drop_to,
            lossless=self.session._blk is not None,
        )
        self.control = st.ControlChannel()
        self.recorder = None
        self.playback_source: Optional[Iterable] = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._reset = threading.Event()
        self.shutdown = GracefulShutdown(config.runtime.shutdown_timeout_s)
        self.watchdog = Watchdog(
            lambda: self.session.state.last_heartbeat,
            stall_timeout_s=max(10.0, 50 * 1.0 / config.camera.fps),
            period_s=config.runtime.watchdog_period_s,
        )

    # ---------------------------------------------------------------- control
    def _handle_control(self):
        cmd = self.control.poll()
        if cmd is None:
            return
        verb, arg = cmd
        if verb == st.ControlCommand.START_RECORD:
            if self.recorder is None and arg:
                self.recorder = st.open_recorder(arg)
                log.info("recording to %s", arg)
        elif verb == st.ControlCommand.STOP_RECORD:
            if self.recorder is not None:
                self.recorder.close()
                self.recorder = None
        elif verb == st.ControlCommand.START_PLAYBACK:
            if arg:
                # playback replaces the live source until it ends
                self.playback_source = st.paced(
                    iter(st.open_reader(arg, prefetch=self.cfg.stream.prefetch)),
                    self.cfg.stream.paced_fps,
                )
                log.info("playback from %s", arg)
        elif verb == st.ControlCommand.STOP_PLAYBACK:
            self.playback_source = None
        elif verb == st.ControlCommand.RESET:
            # the consumer resets the session between two frames: a reset
            # from this thread would rebuild the session under a frame
            self._reset.set()
        elif verb == st.ControlCommand.SHUTDOWN:
            self._stop.set()

    def _tee(self, ts, depth, rgb):
        if self.recorder is not None:
            self.recorder.write(ts, _host(depth), _host(rgb))

    # ---------------------------------------------------------------- threads
    def _producer(self):
        src = iter(self.source)
        while not self._stop.is_set():
            self._handle_control()
            active = self.playback_source if self.playback_source is not None else src
            try:
                frame = next(active)
            except StopIteration:
                if self.playback_source is not None:
                    self.playback_source = None
                    continue
                break
            self._tee(*frame)
            self.queue.put(frame)
        self.queue.close()

    def _consumer(self):
        while True:
            item = self.queue.get()
            if item is None:
                return
            ts, depth, rgb = item
            if self._reset.is_set():
                self._reset.clear()
                self.session.reset()
            self.session.process_frame(ts, depth, rgb)
            if self.session.state.frames % self.cfg.runtime.metrics_every_frames == 0:
                self.metrics.log(
                    "queue", depth=len(self.queue), dropped=self.queue.dropped
                )

    # ------------------------------------------------------------------- run
    def run(self, threads: bool = True) -> SLAMSession:
        if not threads:
            for ts, depth, rgb in self.source:
                self._tee(ts, depth, rgb)
                self.session.process_frame(ts, depth, rgb)
            return self.session

        self.watchdog.start()
        prod = threading.Thread(target=self._producer, name="slam-producer")
        cons = threading.Thread(target=self._consumer, name="slam-consumer")
        self._threads = [prod, cons]
        prod.start()
        cons.start()
        try:
            while cons.is_alive():
                cons.join(timeout=0.2)
        finally:
            self.stop()
        return self.session

    def stop(self):
        self._stop.set()
        self.queue.close()
        clean = self.shutdown.request(self._threads)
        self.watchdog.stop()
        if self.recorder is not None:
            self.recorder.close()
        self.session.close()  # drain and stop the backend worker
        self.session.state.running = False
        return clean


class ControlMenu:
    """Interactive control, the reference's stdin menu, issuing the verbs
    through the `ControlChannel`:

        1 <file>   start recording        2   stop recording
        3 <file>   start playback         4   stop playback
        r          reset SLAM system      s   status line
        q          quit (graceful shutdown)

    `infile` / `outfile` are injectable, so a test or a script can drive it.
    """

    def __init__(self, runner: PipelineRunner, infile=None, outfile=None):
        import sys

        self.runner = runner
        self._in = infile if infile is not None else sys.stdin
        self._out = outfile if outfile is not None else sys.stdout
        self._thread: Optional[threading.Thread] = None

    def _print(self, msg: str):
        try:
            self._out.write(msg + "\n")
            self._out.flush()
        except ValueError:  # stream closed during shutdown
            pass

    def banner(self):
        self._print(
            "menu: 1 <file>=record  2=stop-record  3 <file>=playback  "
            "4=stop-playback  r=reset  s=status  q=quit"
        )

    def _dispatch(self, line: str) -> bool:
        """Handle one command line; False on quit."""
        ctl, sess = self.runner.control, self.runner.session
        parts = line.strip().split(maxsplit=1)
        if not parts:
            return True
        verb, arg = parts[0], (parts[1] if len(parts) > 1 else None)
        if verb == "1":
            if not arg:
                self._print("usage: 1 <output.rgbd>")
            else:
                ctl.send(st.ControlCommand.START_RECORD, arg)
                self._print(f"recording -> {arg}")
        elif verb == "2":
            ctl.send(st.ControlCommand.STOP_RECORD)
            self._print("recording stopped")
        elif verb == "3":
            if not arg:
                self._print("usage: 3 <input.rgbd>")
            else:
                ctl.send(st.ControlCommand.START_PLAYBACK, arg)
                self._print(f"playback <- {arg}")
        elif verb == "4":
            ctl.send(st.ControlCommand.STOP_PLAYBACK)
            self._print("playback stopped")
        elif verb == "r":
            ctl.send(st.ControlCommand.RESET)
            self._print("reset requested")
        elif verb == "s":
            s = sess.state
            self._print(
                f"status: frames={s.frames} keyframes={s.keyframes} "
                f"map_points={sess.map_point_count()} loops={s.loops} "
                f"lost={s.lost} queue={len(self.runner.queue)}"
            )
        elif verb == "q":
            ctl.send(st.ControlCommand.SHUTDOWN)
            self._print("shutting down")
            return False
        else:
            self.banner()
        return True

    def _loop(self):
        self.banner()
        for line in self._in:
            if not self._dispatch(line):
                return
            if self.runner._stop.is_set():
                return

    def start(self) -> threading.Thread:
        self._thread = threading.Thread(
            target=self._loop, name="slam-menu", daemon=True
        )
        self._thread.start()
        return self._thread
