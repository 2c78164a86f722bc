"""ICL-NUIM RGB-D dataset loader (living room / office scenes), in numpy.

Counterpart of `slam_rgbd_tpu/io/icl_nuim.py`. Both layouts of the dataset:

1. TUM-compatible: `rgb.txt` / `depth.txt` / `groundtruth.txt` and 16-bit
   depth PNGs scaled by 5000, read by `TUMSequence` with the ICL camera
   (fx=481.20, fy=480.0, cx=319.5, cy=239.5, 640x480).
2. Raw POV-Ray output: per frame `scene_NN_FFFF.depth` text files of the
   euclidean ray length to the surface, `scene_NN_FFFF.png` colour. Ray
   length becomes planar depth, z = r / ||[(u-cx)/fx, (v-cy)/fy, 1]||, then
   uint16 millimetres. Ground truth comes from a `*.gt.freiburg` file (TUM
   rows indexed by frame number) beside the frames or one level up.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from slam_rgbd_tpu_torch.core.config import CameraIntrinsics
from slam_rgbd_tpu_torch.io.tum import TUMSequence, _read_list, _read_png, quat_to_matrix


def icl_nuim_camera() -> CameraIntrinsics:
    """The ICL-NUIM render camera (both living-room and office scenes)."""
    return CameraIntrinsics(
        fx=481.20, fy=480.0, cx=319.5, cy=239.5, width=640, height=480
    )


def ray_to_planar_depth(ray: np.ndarray, cam: CameraIntrinsics) -> np.ndarray:
    """Euclidean ray length (H, W) -> planar z (same units)."""
    h, w = ray.shape
    u = np.arange(w, dtype=np.float64)[None, :]
    v = np.arange(h, dtype=np.float64)[:, None]
    x = (u - cam.cx) / cam.fx
    y = (v - cam.cy) / cam.fy
    norm = np.sqrt(x * x + y * y + 1.0)
    return (ray / norm).astype(np.float32)


def _read_raw_depth(path: str, cam: CameraIntrinsics) -> np.ndarray:
    """One `.depth` text file -> u16 depth in millimetres."""
    ray = np.loadtxt(path, dtype=np.float64).reshape(cam.height, cam.width)
    z_m = ray_to_planar_depth(ray, cam)
    z_mm = np.clip(np.round(z_m * 1000.0), 0, 65535).astype(np.uint16)
    return z_mm


class ICLNUIMSequence:
    """An ICL-NUIM sequence directory, either layout, loader-protocol shaped.

    Yields `(timestamp_s, depth_u16_mm, rgb_u8)` like `TUMSequence` /
    `SyntheticSequence`, so the SLAM session and CLI consume it unchanged.
    """

    def __init__(self, root: str, cam: CameraIntrinsics | None = None,
                 fps: float = 30.0):
        self.cam = cam or icl_nuim_camera()
        self.fps = fps
        self._tum = None
        self._gt = None

        if os.path.exists(os.path.join(root, "depth.txt")):
            # TUM-compatible layout
            self._tum = TUMSequence(root, self.cam)
            self.timestamps = self._tum.timestamps
            self._gt = self._tum.groundtruth()
            return

        depth_files = sorted(
            glob.glob(os.path.join(root, "*.depth")),
            key=lambda p: _frame_number(p),
        )
        if not depth_files:
            raise FileNotFoundError(
                f"{root}: neither TUM-compatible (depth.txt) nor raw "
                f"POV-Ray (*.depth) ICL-NUIM layout found"
            )
        self._depth_files = depth_files
        self._rgb_files = [os.path.splitext(p)[0] + ".png" for p in depth_files]
        self.timestamps = (
            np.array([_frame_number(p) for p in depth_files], dtype=np.float64)
            / fps
        )

        gt_candidates = glob.glob(os.path.join(root, "*.gt.freiburg")) + glob.glob(
            os.path.join(root, "..", "*.gt.freiburg")
        )
        if gt_candidates:
            rows = _read_list(gt_candidates[0])
            by_idx = {int(ts): fields for ts, fields in rows}
            poses = []
            ok = True
            for p in depth_files:
                k = _frame_number(p)
                if k not in by_idx:
                    ok = False
                    break
                tx, ty, tz, qx, qy, qz, qw = map(float, by_idx[k][:7])
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = quat_to_matrix(qx, qy, qz, qw)
                T[:3, 3] = (tx, ty, tz)
                poses.append(T)
            if ok and poses:
                self._gt = np.stack(poses)

    def __len__(self) -> int:
        if self._tum is not None:
            return len(self._tum)
        return len(self._depth_files)

    def frame(self, i: int):
        if self._tum is not None:
            return self._tum.frame(i)
        depth = _read_raw_depth(self._depth_files[i], self.cam)
        if os.path.exists(self._rgb_files[i]):
            rgb = _read_png(self._rgb_files[i])
            if rgb.ndim == 2:
                rgb = np.stack([rgb] * 3, axis=-1)
            rgb = rgb[..., :3].astype(np.uint8)
        else:
            rgb = np.zeros((self.cam.height, self.cam.width, 3), np.uint8)
        return float(self.timestamps[i]), depth, rgb

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)

    def groundtruth(self):
        return self._gt


def _frame_number(path: str) -> int:
    """Trailing integer in an ICL-NUIM raw filename (scene_00_0017.depth)."""
    m = re.findall(r"(\d+)", os.path.basename(path))
    if not m:
        raise ValueError(f"no frame number in {path}")
    return int(m[-1])
