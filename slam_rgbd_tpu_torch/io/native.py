"""ctypes bindings for the native IO library, built from `native/slamio.cpp`.

Counterpart of `slam_rgbd_tpu/io/native.py`. The library is compiled with
g++ at first use into `build/native/` at the root of the checkout, named by
a hash of the source and flags (as `ops/_build.py` names the kernel
library), so a changed source builds anew. A prebuilt `native/*.so` is never
loaded or rebuilt. The bindings:

  * `NativeStreamRecorder` / `NativeStreamReader`: the `.rgbd` codec of
    `io.stream`, the same bytes on disk;
  * `NativeFrameQueue`: the bounded drop-oldest ring in C++;
  * `NativePrefetcher`: a C++ thread that decodes a recording ahead of the
    consumer, without the interpreter lock.

`native_available()` is False when the build or the load fails (a WARNING
says why); `io.stream` then uses its Python codec.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

log = logging.getLogger("slam_rgbd_tpu_torch.native")

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")
_HDR_BYTES = 24  # u64 frame_id, u64 ts_us, u32 w, u32 h

_build_lock = threading.Lock()


def build_library(source: str) -> Optional[Path]:
    """Compile `native/<source>` into `build/native/` (once per source hash)
    and return the library's path; None, with a WARNING, when there is no
    compiler or the build fails."""
    src = NATIVE_SRC / source
    try:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src.read_bytes())
    except OSError as e:
        log.warning("native build of %s failed: no source (%s)", source, e)
        return None
    lib = BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"
    with _build_lock:
        if lib.exists():
            return lib
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            log.warning("native build of %s failed: no C++ compiler (g++)", source)
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)], check=True,
                           capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", "") or ""
            log.warning("native build of %s failed: %s %s", source, e, detail.strip())
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
        return lib


_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = build_library("slamio.cpp")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("native load failed: %s", e)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.slamio_writer_open.restype = ctypes.c_void_p
        lib.slamio_writer_open.argtypes = [ctypes.c_char_p]
        lib.slamio_writer_write.restype = ctypes.c_int64
        lib.slamio_writer_write.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
            u8p, u8p,
        ]
        lib.slamio_writer_close.restype = ctypes.c_int
        lib.slamio_writer_close.argtypes = [ctypes.c_void_p]
        lib.slamio_reader_open.restype = ctypes.c_void_p
        lib.slamio_reader_open.argtypes = [ctypes.c_char_p]
        lib.slamio_reader_next.restype = ctypes.c_int
        lib.slamio_reader_next.argtypes = [
            ctypes.c_void_p, u8p, u8p, ctypes.c_uint64, u8p, ctypes.c_uint64,
        ]
        lib.slamio_reader_close.restype = ctypes.c_int
        lib.slamio_reader_close.argtypes = [ctypes.c_void_p]
        lib.slamio_queue_create.restype = ctypes.c_void_p
        lib.slamio_queue_create.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
        lib.slamio_queue_push.restype = ctypes.c_int
        lib.slamio_queue_push.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_uint32, u8p, u8p,
        ]
        lib.slamio_queue_pop.restype = ctypes.c_int
        lib.slamio_queue_pop.argtypes = [
            ctypes.c_void_p, u8p, u8p, ctypes.c_uint64, u8p, ctypes.c_uint64,
            ctypes.c_int,
        ]
        lib.slamio_queue_dropped.restype = ctypes.c_uint64
        lib.slamio_queue_dropped.argtypes = [ctypes.c_void_p]
        lib.slamio_queue_depth.restype = ctypes.c_uint64
        lib.slamio_queue_depth.argtypes = [ctypes.c_void_p]
        lib.slamio_queue_close.restype = None
        lib.slamio_queue_close.argtypes = [ctypes.c_void_p]
        lib.slamio_queue_destroy.restype = None
        lib.slamio_queue_destroy.argtypes = [ctypes.c_void_p]
        lib.slamio_prefetch_open.restype = ctypes.c_void_p
        lib.slamio_prefetch_open.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.slamio_prefetch_next.restype = ctypes.c_int
        lib.slamio_prefetch_next.argtypes = lib.slamio_queue_pop.argtypes
        lib.slamio_prefetch_close.restype = None
        lib.slamio_prefetch_close.argtypes = [ctypes.c_void_p]
        lib.slamio_version.restype = ctypes.c_char_p
        lib.slamio_version.argtypes = []
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _need_lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("libslamio unavailable (see the WARNING of its build)")
    return lib


class _FrameBuffers:
    """Decode buffers for the largest frame and the unpacking of one."""

    def __init__(self, max_w: int, max_h: int):
        self._dbuf = np.empty(max_w * max_h * 2, np.uint8)
        self._cbuf = np.empty(max_w * max_h * 3, np.uint8)
        self._hdr = np.empty(_HDR_BYTES, np.uint8)

    def _args(self):
        return (_u8(self._hdr), _u8(self._dbuf), self._dbuf.nbytes,
                _u8(self._cbuf), self._cbuf.nbytes)

    def _frame(self) -> Tuple[float, np.ndarray, np.ndarray]:
        _, ts_us = np.frombuffer(self._hdr[:16], np.uint64)
        w, h = (int(x) for x in np.frombuffer(self._hdr[16:24], np.uint32))
        depth = self._dbuf[: w * h * 2].view(np.uint16).reshape(h, w).copy()
        rgb = self._cbuf[: w * h * 3].reshape(h, w, 3).copy()
        return float(ts_us) / 1e6, depth, rgb


class NativeStreamRecorder:
    """C++ `.rgbd` writer (the format of `io.stream.StreamRecorder`)."""

    def __init__(self, path: str):
        self._lib = _need_lib()
        self._h = self._lib.slamio_writer_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")
        self.closed = False

    def write(self, ts: float, depth: np.ndarray, rgb: np.ndarray) -> int:
        depth = np.ascontiguousarray(depth, dtype=np.uint16)
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        h, w = depth.shape
        if rgb.shape != (h, w, 3):
            raise ValueError(f"rgb {rgb.shape} does not match depth {depth.shape}")
        fid = self._lib.slamio_writer_write(
            self._h, int(ts * 1e6), w, h, _u8(depth.view(np.uint8)), _u8(rgb)
        )
        if fid < 0:
            raise OSError("native write failed")
        return fid

    def close(self):
        if not self.closed:
            self._lib.slamio_writer_close(self._h)
            self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeStreamReader(_FrameBuffers):
    """C++ `.rgbd` reader; iterates (ts_s, depth u16, rgb u8)."""

    def __init__(self, path: str, max_w: int = 1920, max_h: int = 1080):
        self._lib = _need_lib()
        self._h = self._lib.slamio_reader_open(path.encode())
        if not self._h:
            raise ValueError(f"cannot open {path} (missing or bad magic)")
        super().__init__(max_w, max_h)
        self._open = True

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        while True:
            rc = self._lib.slamio_reader_next(self._h, *self._args())
            if rc == 0:
                return
            if rc < 0:
                raise ValueError("corrupt .rgbd frame (native reader)")
            yield self._frame()

    def close(self):
        if self._open:
            self._lib.slamio_reader_close(self._h)
            self._open = False


class NativeFrameQueue(_FrameBuffers):
    """C++ bounded drop-oldest frame ring."""

    def __init__(self, capacity: int = 10, drop_to: int = 5,
                 max_w: int = 1920, max_h: int = 1080):
        self._lib = _need_lib()
        self._h = self._lib.slamio_queue_create(capacity, drop_to)
        super().__init__(max_w, max_h)

    def put(self, ts: float, depth: np.ndarray, rgb: np.ndarray, frame_id: int = 0):
        depth = np.ascontiguousarray(depth, dtype=np.uint16)
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        h, w = depth.shape
        self._lib.slamio_queue_push(
            self._h, frame_id, int(ts * 1e6), w, h,
            _u8(depth.view(np.uint8)), _u8(rgb),
        )

    def get(self, timeout_ms: int = -1):
        """(ts, depth, rgb); None when closed; raises TimeoutError."""
        rc = self._lib.slamio_queue_pop(self._h, *self._args(), timeout_ms)
        if rc == 0:
            return None
        if rc == -2:
            raise TimeoutError("native queue pop timed out")
        if rc < 0:
            raise ValueError("native queue pop failed")
        return self._frame()

    @property
    def dropped(self) -> int:
        return int(self._lib.slamio_queue_dropped(self._h))

    def __len__(self) -> int:
        return int(self._lib.slamio_queue_depth(self._h))

    def close(self):
        self._lib.slamio_queue_close(self._h)

    def destroy(self):
        self._lib.slamio_queue_destroy(self._h)


class NativePrefetcher(_FrameBuffers):
    """C++ reader thread that decodes a `.rgbd` recording ahead of the
    consumer."""

    def __init__(self, path: str, capacity: int = 8,
                 max_w: int = 1920, max_h: int = 1080):
        self._lib = _need_lib()
        self._h = self._lib.slamio_prefetch_open(path.encode(), capacity, 0)
        if not self._h:
            raise ValueError(f"cannot open {path}")
        super().__init__(max_w, max_h)
        self._open = True

    def __iter__(self):
        while True:
            rc = self._lib.slamio_prefetch_next(self._h, *self._args(), -1)
            if rc == 0:
                return
            if rc < 0:
                raise ValueError("corrupt .rgbd frame (native prefetcher)")
            yield self._frame()

    def close(self):
        if self._open:
            self._lib.slamio_prefetch_close(self._h)
            self._open = False
