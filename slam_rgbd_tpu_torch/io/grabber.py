"""Pluggable live-sensor grabber interface.

Counterpart of `slam_rgbd_tpu/io/grabber.py`, the port's own copy:

  * `FrameGrabber`: the adapter a camera backend implements (open / grab /
    close, optional intrinsics);
  * `GrabberSource`: any `FrameGrabber` as a frame-source iterator of host
    `(ts, depth_u16, rgb)` tuples, with the reference's retry / reinit
    policy (`stream.RetryingSource`) and optional pacing;
  * `resolve_grabber`: a grabber factory from "module.path:attr" (the CLI's
    `run grabber:pkg.mod:make` input);
  * `SyntheticGrabber`: the implementation over the raycast scene, and the
    test double of a flaky camera.
"""

from __future__ import annotations

import abc
from typing import Callable, Iterator, Optional

from slam_rgbd_tpu_torch.core.config import CameraIntrinsics, StreamConfig
from slam_rgbd_tpu_torch.io import stream as st


class FrameGrabber(abc.ABC):
    """Live-sensor adapter: what a hardware backend must implement.

    Lifecycle: `open()` may raise (transient — the runtime retries with
    backoff, `sensorModule.c:50-67` semantics); `grab()` returns one
    `(timestamp_s, depth_u16 (H, W), rgb_u8 (H, W, 3))` frame or raises
    (the runtime reinitializes after `max_consecutive_errors` failures,
    `sensorModule.c:216-239`); `close()` must be idempotent.
    """

    @abc.abstractmethod
    def open(self) -> None:
        """Acquire the device; raise on failure (will be retried)."""

    @abc.abstractmethod
    def grab(self) -> st.Frame:
        """Return the next (ts, depth_u16, rgb_u8) frame; raise on error."""

    @abc.abstractmethod
    def close(self) -> None:
        """Release the device (idempotent)."""

    @property
    def intrinsics(self) -> Optional[CameraIntrinsics]:
        """Calibration reported by the device, if it has any."""
        return None

    # context-manager sugar
    def __enter__(self) -> "FrameGrabber":
        self.open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _GrabIter:
    """Resumable per-grab iterator over an opened grabber (an exception
    from `grab()` leaves it usable — unlike a generator)."""

    def __init__(self, g: "FrameGrabber", max_frames: int):
        self.g = g
        self.max = max_frames
        self.n = 0

    def __iter__(self) -> "_GrabIter":
        return self

    def __next__(self) -> st.Frame:
        if self.max and self.n >= self.max:
            self.g.close()
            raise StopIteration
        try:
            f = self.g.grab()
        except StopIteration:
            self.g.close()
            raise
        self.n += 1
        return f


class GrabberSource:
    """A `FrameGrabber` as a fault-tolerant frame-source iterator.

    Wraps the grabber in the reference sensor loop's policy: up to
    `init_retries` open attempts with backoff, teardown + reopen after
    `max_consecutive_errors` consecutive grab failures, optional ~fps
    pacing (`usleep(33333)` semantics, `sensorModule.c:242-243`). The
    iterator ends when the grabber raises `StopIteration` (finite
    sources / tests) — a live camera simply never does.
    """

    def __init__(
        self,
        factory: Callable[[], FrameGrabber],
        stream_cfg: StreamConfig = StreamConfig(),
        max_frames: int = 0,  # 0 = unbounded (live camera)
    ):
        self.factory = factory
        self.cfg = stream_cfg
        self.max_frames = max_frames
        self.grabbers: list[FrameGrabber] = []  # for teardown/reinit stats

        def make_iter() -> Iterator[st.Frame]:
            # teardown-then-reinit semantics (`sensorModule.c:216-239`):
            # any previous instance is closed before the replacement opens
            while self.grabbers:
                self.grabbers.pop().close()
            g = factory()
            g.open()
            self.grabbers.append(g)
            # NOT a generator: `RetryingSource` resumes the iterator
            # after a raised read error, and a generator dies on its
            # first exception
            return _GrabIter(g, max_frames)

        self._retrying = st.RetryingSource(
            make_iter,
            init_retries=stream_cfg.init_retries,
            max_consecutive_errors=stream_cfg.max_consecutive_errors,
        )

    @property
    def reinit_count(self) -> int:
        return self._retrying.reinit_count

    def __iter__(self) -> Iterator[st.Frame]:
        it = iter(self._retrying)
        if self.cfg.paced_fps > 0:
            it = st.paced(it, self.cfg.paced_fps)
        return it


class SyntheticGrabber(FrameGrabber):
    """A `FrameGrabber` over the raycast scene, and the test double of a
    camera: frames are rendered by the port's `SyntheticSequence` on
    `device` and handed out as host arrays, as a camera does; `fail_at`
    injects grab failures and `fail_open` initial open failures, to drive
    the retry / reinit policy as a flaky camera would."""

    def __init__(self, cam: CameraIntrinsics, n_frames: int = 0,
                 fail_at: tuple = (), fail_open: int = 0, fps: float = 30.0,
                 device="cuda"):
        from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence

        self.cam = cam
        self.seq = SyntheticSequence(max(n_frames, 1024), cam, fps=fps, device=device)
        self.n_frames = n_frames
        self.fail_at = set(fail_at)
        self.fail_open = fail_open
        self._i = 0
        self._open = False
        self.open_attempts = 0

    def open(self) -> None:
        self.open_attempts += 1
        if self.open_attempts <= self.fail_open:
            raise st.SourceError("synthetic open failure")
        self._open = True

    def grab(self) -> st.Frame:
        if not self._open:
            raise st.SourceError("grab on closed grabber")
        if self.n_frames and self._i >= self.n_frames:
            raise StopIteration
        i = self._i
        self._i += 1
        if i in self.fail_at:
            raise st.SourceError(f"injected grab failure at frame {i}")
        return self.seq.frame(i % len(self.seq))

    def close(self) -> None:
        self._open = False

    @property
    def intrinsics(self) -> CameraIntrinsics:
        return self.cam


def resolve_grabber(spec: str) -> Callable[[], FrameGrabber]:
    """Import a grabber factory from "module.path:attr".

    The factory is any zero-arg callable returning a `FrameGrabber` —
    how a vendor adapter plugs into `run grabber:...` without this
    package importing (or even knowing about) the vendor SDK.
    """
    import importlib

    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise ValueError(
            f"grabber spec {spec!r} must be 'module.path:factory'"
        )
    mod = importlib.import_module(mod_name)
    factory = getattr(mod, attr)
    if not callable(factory):
        raise TypeError(f"{spec!r} is not callable")
    return factory
