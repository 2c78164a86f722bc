"""ctypes bindings for the native software viewer, built from
`native/viewer.cpp`.

Counterpart of `slam_rgbd_tpu/viz/native.py`: a headless C++ rasterizer on
the host. `NativeViewer.render(points, colors)` returns an (H, W, 3) uint8
frame; `orbit` / `zoom` follow the reference viewer's mouse semantics;
`backproject` is the native back-projection of one frame. The library is
built with g++ into `build/native/` at first use, as `io.native` builds
`slamio.cpp`; `native_available()` is False when it cannot be built.
"""

from __future__ import annotations

import ctypes
import logging
import threading

import numpy as np

from slam_rgbd_tpu_torch.io.native import build_library

log = logging.getLogger("slam_rgbd_tpu_torch.viz.native")

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = build_library("viewer.cpp")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("cannot load %s: %s", path, e)
            return None
        lib.viewer_create.restype = ctypes.c_void_p
        lib.viewer_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.viewer_destroy.argtypes = [ctypes.c_void_p]
        lib.viewer_orbit.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_float]
        lib.viewer_zoom.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.viewer_set_target.argtypes = [ctypes.c_void_p] + [ctypes.c_float] * 3
        lib.viewer_set_point_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        lib.viewer_render.argtypes = [
            ctypes.c_void_p, f32p, u8p, ctypes.c_int64, u8p
        ]
        for name in ("viewer_destroy", "viewer_orbit", "viewer_zoom",
                     "viewer_set_target", "viewer_set_point_size", "viewer_render"):
            getattr(lib, name).restype = None
        lib.viewer_backproject.restype = ctypes.c_int64
        lib.viewer_backproject.argtypes = [
            u16p, u8p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, f32p, u8p,
        ]
        lib.viewer_write_ppm.restype = ctypes.c_int
        lib.viewer_write_ppm.argtypes = [
            ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def backproject(depth_mm: np.ndarray, rgb: np.ndarray, cam,
                T_cw: np.ndarray | None = None):
    """(points (n, 3) f32, colors (n, 3) u8) from one RGB-D frame."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native viewer unavailable (see the WARNING of its build)")
    depth_mm = np.ascontiguousarray(depth_mm, np.uint16)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = depth_mm.shape
    xyz = np.empty((h * w, 3), np.float32)
    col = np.empty((h * w, 3), np.uint8)
    t_arg = None
    if T_cw is not None:
        t_buf = np.ascontiguousarray(T_cw, np.float32)
        t_arg = t_buf.ctypes.data_as(ctypes.c_void_p)
    n = lib.viewer_backproject(
        depth_mm, rgb.reshape(-1), w, h,
        cam.fx, cam.fy, cam.cx, cam.cy, t_arg, xyz.reshape(-1), col.reshape(-1),
    )
    return xyz[:n], col[:n]


class NativeViewer:
    """Headless orbit-camera point-cloud renderer (RAII like C10)."""

    def __init__(self, width: int = 960, height: int = 720):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native viewer unavailable (see the WARNING of its build)")
        self.width = width
        self.height = height
        self._ctx = self._lib.viewer_create(width, height)

    def close(self):
        if self._ctx:
            self._lib.viewer_destroy(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def orbit(self, dx_px: float, dy_px: float):
        self._lib.viewer_orbit(self._ctx, dx_px, dy_px)

    def zoom(self, steps: int):
        self._lib.viewer_zoom(self._ctx, steps)

    def set_target(self, x: float, y: float, z: float):
        self._lib.viewer_set_target(self._ctx, x, y, z)

    def set_point_size(self, px: int):
        self._lib.viewer_set_point_size(self._ctx, px)

    def render(self, points: np.ndarray, colors: np.ndarray) -> np.ndarray:
        """(n, 3) f32 world points + (n, 3) u8 colors -> (H, W, 3) u8."""
        points = np.ascontiguousarray(points, np.float32)
        colors = np.ascontiguousarray(colors, np.uint8)
        out = np.empty((self.height, self.width, 3), np.uint8)
        self._lib.viewer_render(
            self._ctx, points.reshape(-1), colors.reshape(-1),
            points.shape[0], out.reshape(-1),
        )
        return out

    def write_ppm(self, path: str, frame: np.ndarray):
        frame = np.ascontiguousarray(frame, np.uint8)
        rc = self._lib.viewer_write_ppm(
            path.encode(), frame.reshape(-1), frame.shape[1], frame.shape[0]
        )
        if rc != 0:
            raise IOError(f"PPM write failed: {path}")
