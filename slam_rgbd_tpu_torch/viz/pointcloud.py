"""Point-cloud export: PLY files and JSON payloads for the web viewer.

Counterpart of `slam_rgbd_tpu/viz/pointcloud.py`. `frame_to_pointcloud`
back-projects a frame with the port's `core.camera` on `device` (the CUDA
device unless the caller asks for the CPU) and reads the result back to the
host once; `map_to_pointcloud` reads a map's valid points back once (a
map-block sharded map: gathered from the blocks first).
`save_ply` / `load_ply` and `pointcloud_json` are numpy, byte for byte the
reference's.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from slam_rgbd_tpu_torch.core import camera
from slam_rgbd_tpu_torch.core.config import CameraIntrinsics
from slam_rgbd_tpu_torch.parallel.mesh import gather


def frame_to_pointcloud(
    depth_raw,
    rgb,
    cam: CameraIntrinsics,
    stride: int = 1,
    T_world_cam: np.ndarray | None = None,
    device="cuda",
):
    """(N, 3) float32 positions + (N, 3) uint8 colours from one RGB-D frame.

    Invalid-depth pixels are dropped; `stride` subsamples; points are in the
    world frame when a pose is given, else in the camera frame.
    """
    if not isinstance(depth_raw, torch.Tensor):
        depth_raw = torch.from_numpy(np.asarray(depth_raw).astype(np.int32))
    depth_m = camera.depth_to_metres(depth_raw.to(device), cam)
    verts = camera.backproject(depth_m, cam)
    verts = verts[::stride, ::stride].cpu().numpy()  # the one read-back
    valid = verts[..., 2] > 0
    pts = verts[valid]
    if rgb is not None:
        rgb = rgb.cpu().numpy() if isinstance(rgb, torch.Tensor) else np.asarray(rgb)
        colors = rgb[::stride, ::stride][valid]
    else:
        colors = np.full((len(pts), 3), 200, np.uint8)
    if T_world_cam is not None:
        T = np.asarray(T_world_cam)
        pts = pts @ T[:3, :3].T + T[:3, 3]
    return pts.astype(np.float32), colors.astype(np.uint8)


def map_to_pointcloud(map_state, blk=None) -> tuple[np.ndarray, np.ndarray]:
    """The valid map points of a `MapState` as a cloud of one colour. With
    `blk` (a `parallel.mesh.Block`: the map holds this rank's block of the
    point table) every rank of the group calls it and gets the whole
    cloud."""
    xyz, valid = map_state.pt_xyz, map_state.pt_valid
    if blk is not None:
        xyz = gather(xyz, blk.mesh, blk.axis)
        valid = gather(valid, blk.mesh, blk.axis)
    pts = xyz[valid].cpu().numpy()
    colors = np.full((len(pts), 3), (120, 180, 255), np.uint8)
    return pts.astype(np.float32), colors


def save_ply(path: str, pts: np.ndarray, colors: np.ndarray | None = None,
             binary: bool = True) -> None:
    """Write a point cloud as PLY (binary_little_endian or ascii)."""
    n = len(pts)
    has_color = colors is not None
    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header += [f"element vertex {n}",
               "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_color:
                rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
                rec["xyz"] = pts
                rec["rgb"] = colors
                f.write(rec.tobytes())
            else:
                f.write(pts.astype("<f4").tobytes())
        else:
            for i in range(n):
                row = f"{pts[i,0]:.5f} {pts[i,1]:.5f} {pts[i,2]:.5f}"
                if has_color:
                    row += f" {colors[i,0]} {colors[i,1]} {colors[i,2]}"
                f.write((row + "\n").encode())


def load_ply(path: str):
    """Read back a PLY written by `save_ply`."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(h for h in header if h.startswith("element vertex")).split()[-1])
        binary = any("binary" in h for h in header)
        has_color = any("red" in h for h in header)
        if binary:
            if has_color:
                rec = np.frombuffer(
                    f.read(n * 15), dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)]
                )
                return rec["xyz"].copy(), rec["rgb"].copy()
            return np.frombuffer(f.read(n * 12), dtype="<f4").reshape(n, 3).copy(), None
        pts, cols = [], []
        for _ in range(n):
            parts = f.readline().split()
            pts.append([float(x) for x in parts[:3]])
            if has_color:
                cols.append([int(x) for x in parts[3:6]])
        return (np.asarray(pts, np.float32),
                np.asarray(cols, np.uint8) if cols else None)


def pointcloud_json(pts: np.ndarray, colors: np.ndarray | None = None,
                    max_points: int = 100_000) -> str:
    """JSON payload of the web viewer: {positions, colors} flat arrays
    (colours as floats in [0, 1]), evenly subsampled to `max_points`."""
    if len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[idx]
        colors = colors[idx] if colors is not None else None
    payload = {"positions": np.round(pts, 4).flatten().tolist()}
    if colors is not None:
        payload["colors"] = (colors.astype(np.float32) / 255.0).round(4).flatten().tolist()
    return json.dumps(payload)
