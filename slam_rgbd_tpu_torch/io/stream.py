"""Frame streams: record / replay, bounded queues, pacing, control verbs.

Counterpart of `slam_rgbd_tpu/io/stream.py`, kept as the port's own copy
(the port imports nothing of the JAX package). The same `.rgbd` format, drop
policy, pacing and control verbs:

  * `.rgbd` v2: the magic `RGBDTPU2`, then per frame a little-endian header
    (u64 frame_id, u64 ts_us, u32 type, u32 w, u32 h, u32 depth_bytes,
    u32 color_bytes, u32 CRC32 of depth + color), the uint16 depth and the
    uint8 colour; an EOF record ends the file. v1 (`RGBDTPU1`, no CRC)
    still reads.
  * `BoundedFrameQueue`: warn above `capacity`, drop the oldest frames down
    to `drop_to`.
  * `paced`: an iterator at a fixed rate.
  * `ControlChannel`: START/STOP_RECORD, START/STOP_PLAYBACK, RESET,
    SHUTDOWN.
  * `RetryingSource`: init retries, and re-initialization after a run of
    consecutive read errors.

The native C++ codec (`io.native`, built from `native/slamio.cpp`) writes
the same bytes; `open_recorder` / `open_reader` take it when it builds and
fall back to the Python codec with a WARNING when it does not.
"""

from __future__ import annotations

import collections
import enum
import logging
import queue
import struct
import threading
import time
import zlib
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

log = logging.getLogger("slam_rgbd_tpu_torch.stream")

MAGIC = b"RGBDTPU2"
MAGIC_V1 = b"RGBDTPU1"  # no payload checksum
_FRAME_HDR = struct.Struct("<QQIIIIII")
_FRAME_HDR_V1 = struct.Struct("<QQIIIII")
FRAME_TYPE_SENSOR = 1
FRAME_TYPE_EOF = 2

Frame = Tuple[float, np.ndarray, np.ndarray]  # (ts_s, depth u16 HxW, rgb u8 HxWx3)


class StreamRecorder:
    """Append frames to a `.rgbd` file; an EOF record on close. Each frame is
    one header + depth + colour write, flushed, so a recording cut short
    replays up to its last whole frame."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._frame_id = 0
        self._lock = threading.Lock()
        self.closed = False

    def write(self, ts: float, depth: np.ndarray, rgb: np.ndarray) -> None:
        depth = np.ascontiguousarray(depth, dtype=np.uint16)
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        h, w = depth.shape
        crc = zlib.crc32(rgb.tobytes(), zlib.crc32(depth.tobytes()))
        hdr = _FRAME_HDR.pack(
            self._frame_id, int(ts * 1e6), FRAME_TYPE_SENSOR, w, h,
            depth.nbytes, rgb.nbytes, crc,
        )
        with self._lock:
            self._f.write(hdr)
            self._f.write(depth.tobytes())
            self._f.write(rgb.tobytes())
            self._f.flush()
            self._frame_id += 1

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            self._f.write(
                _FRAME_HDR.pack(self._frame_id, 0, FRAME_TYPE_EOF, 0, 0, 0, 0, 0)
            )
            self._f.flush()
            self._f.close()
            self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StreamReader:
    """Sequential `.rgbd` reader: sizes are checked, the CRC of a v2 frame is
    checked, and reading stops at the EOF record or at a truncation."""

    def __init__(self, path: str, max_frame_bytes: int = 64 << 20):
        self._f = open(path, "rb")
        self.max_frame_bytes = max_frame_bytes
        magic = self._f.read(len(MAGIC))
        if magic == MAGIC:
            self._hdr = _FRAME_HDR
        elif magic == MAGIC_V1:
            self._hdr = _FRAME_HDR_V1
        else:
            self._f.close()
            raise ValueError(f"{path}: bad magic {magic!r}")

    def __iter__(self) -> Iterator[Frame]:
        while True:
            hdr = self._f.read(self._hdr.size)
            if len(hdr) < self._hdr.size:
                log.warning("recording truncated (no EOF marker)")
                return
            fid, ts_us, ftype, w, h, dbytes, cbytes, *rest = self._hdr.unpack(hdr)
            if ftype == FRAME_TYPE_EOF:
                return
            if ftype != FRAME_TYPE_SENSOR or not (
                0 < dbytes <= self.max_frame_bytes and 0 < cbytes <= self.max_frame_bytes
                and dbytes == w * h * 2 and cbytes == w * h * 3
            ):
                raise ValueError(f"corrupt frame {fid}: type={ftype} {w}x{h} d={dbytes} c={cbytes}")
            draw = self._f.read(dbytes)
            craw = self._f.read(cbytes)
            if rest:  # v2: payload integrity
                crc = zlib.crc32(craw, zlib.crc32(draw))
                if crc != rest[0]:
                    raise ValueError(
                        f"corrupt frame {fid}: payload CRC mismatch "
                        f"(got {crc:#010x}, recorded {rest[0]:#010x})"
                    )
            depth = np.frombuffer(draw, dtype=np.uint16).reshape(h, w)
            rgb = np.frombuffer(craw, dtype=np.uint8).reshape(h, w, 3)
            yield ts_us / 1e6, depth, rgb

    def close(self) -> None:
        self._f.close()


class BoundedFrameQueue:
    """Thread-safe frame queue with the reference's backpressure policy.

    `put` never blocks the producer: above `capacity` frames it warns and
    drops the oldest down to `drop_to`, keeping the freshest data (bounded
    latency over lossless delivery, as a real-time tracker wants).
    `lossless=True` drops nothing: `put` waits while `capacity` frames are
    queued (for consumers that must see every frame, as the ranks of a
    sharded session must see the same ones).
    """

    def __init__(self, capacity: int = 10, drop_to: int = 5, lossless: bool = False):
        if drop_to > capacity:
            raise ValueError(f"drop_to {drop_to} above capacity {capacity}")
        self.capacity = capacity
        self.drop_to = drop_to
        self.lossless = lossless
        self._dq: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self.dropped = 0
        self._closed = False

    def put(self, item) -> None:
        with self._cv:
            while self.lossless and len(self._dq) >= self.capacity and not self._closed:
                self._cv.wait()
            self._dq.append(item)
            if len(self._dq) > self.capacity:
                n = len(self._dq) - self.drop_to
                for _ in range(n):
                    self._dq.popleft()
                self.dropped += n
                log.warning("frame queue over capacity; dropped %d (total %d)", n, self.dropped)
            self._cv.notify()

    def get(self, timeout: Optional[float] = None):
        """Pop the oldest frame; None when closed and drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._dq:
                if self._closed:
                    return None
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("frame queue get timed out")
                self._cv.wait(remaining)
            self._cv.notify_all()  # a lossless producer may wait for room
            return self._dq.popleft()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self) -> int:
        with self._cv:
            return len(self._dq)


def paced(frames: Iterator[Frame], fps: float) -> Iterator[Frame]:
    """Pace an iterator at `fps` (0 or less: unpaced)."""
    if fps <= 0:
        yield from frames
        return
    period = 1.0 / fps
    next_t = time.monotonic()
    for f in frames:
        now = time.monotonic()
        if now < next_t:
            time.sleep(next_t - now)
        next_t = max(next_t + period, now)
        yield f


def open_recorder(path: str, prefer_native: bool = True):
    """The native C++ recorder when it builds, else the Python one. Both
    write the same bytes; the native one writes without the interpreter
    lock."""
    if prefer_native:
        from slam_rgbd_tpu_torch.io import native

        if native.native_available():
            return native.NativeStreamRecorder(path)
        log.warning("native recorder unavailable; using the Python codec")
    return StreamRecorder(path)


def open_reader(path: str, prefer_native: bool = True, prefetch: int = 0):
    """The native reader when it builds, else the Python one. `prefetch` > 0
    takes the native prefetcher: a C++ thread that decodes up to that many
    frames ahead of the consumer."""
    if prefer_native:
        from slam_rgbd_tpu_torch.io import native

        if native.native_available():
            if prefetch > 0:
                return native.NativePrefetcher(path, capacity=prefetch)
            return native.NativeStreamReader(path)
        log.warning("native reader unavailable; using the Python codec")
    return StreamReader(path)


class ControlCommand(enum.Enum):
    """The reference's control verbs."""

    START_RECORD = 1
    STOP_RECORD = 2
    START_PLAYBACK = 3
    STOP_PLAYBACK = 4
    RESET = 5
    SHUTDOWN = 6


class ControlChannel:
    """In-process control queue: the consumer polls without blocking; a
    command carries an optional file name."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()

    def send(self, cmd: ControlCommand, arg: Optional[str] = None) -> None:
        self._q.put((cmd, arg))

    def poll(self):
        """(cmd, arg), or None when the queue is empty."""
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None


class SourceError(RuntimeError):
    pass


class RetryingSource:
    """A frame-source factory with init retries and re-initialization.

      * init: up to `init_retries` attempts with a growing backoff;
      * run: after `max_consecutive_errors` consecutive read failures the
        source is torn down and initialized again.
    """

    def __init__(
        self,
        factory: Callable[[], Iterator[Frame]],
        init_retries: int = 3,
        max_consecutive_errors: int = 5,
        backoff_s: float = 0.05,
    ):
        self._factory = factory
        self.init_retries = init_retries
        self.max_consecutive_errors = max_consecutive_errors
        self.backoff_s = backoff_s
        self.reinit_count = 0
        self.error_count = 0

    def _init(self) -> Iterator[Frame]:
        last = None
        for attempt in range(self.init_retries):
            try:
                return self._factory()
            except Exception as e:  # noqa: BLE001 — the retry boundary
                last = e
                log.warning("source init attempt %d/%d failed: %s", attempt + 1,
                            self.init_retries, e)
                time.sleep(self.backoff_s * (attempt + 1))
        raise SourceError(f"source init failed after {self.init_retries} attempts") from last

    def __iter__(self) -> Iterator[Frame]:
        src = self._init()
        consecutive = 0
        while True:
            try:
                item = next(src)
                consecutive = 0
                yield item
            except StopIteration:
                return
            except Exception as e:  # noqa: BLE001 — a read error is counted, not fatal
                consecutive += 1
                self.error_count += 1
                log.warning("source read error %d/%d: %s", consecutive,
                            self.max_consecutive_errors, e)
                if consecutive >= self.max_consecutive_errors:
                    log.warning("too many consecutive errors — reinitializing source")
                    self.reinit_count += 1
                    src = self._init()
                    consecutive = 0
