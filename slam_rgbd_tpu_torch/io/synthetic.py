"""Synthetic RGB-D sequences with exact ground truth, rendered in torch.

Counterpart of `slam_rgbd_tpu/io/synthetic.py` (without the sensor-noise
model, which comes later): an analytic raycast of a box room cluttered with
spheres and cuboids, coloured by a procedural 3D texture, seen along a
smooth orbit. Rendering runs on any torch device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from slam_rgbd_tpu.core.config import CameraIntrinsics
from slam_rgbd_tpu_torch.core import se3


@dataclass(frozen=True)
class SceneSpec:
    """Box room [-half, half]^3 cluttered with spheres and cuboids (the
    clutter keeps point-to-plane ICP well conditioned from any viewpoint)."""

    room_half: float = 3.0
    n_spheres: int = 16
    sphere_min_r: float = 0.15
    sphere_max_r: float = 0.5
    n_boxes: int = 12
    box_min_half: float = 0.12
    box_max_half: float = 0.6
    seed: int = 7
    tex_freq: float = 2.1
    checker_freq: float = 1.7

    def spheres(self) -> np.ndarray:
        """(n, 4) array of (cx, cy, cz, r), deterministic from seed."""
        rng = np.random.default_rng(self.seed)
        c = rng.uniform(-self.room_half * 0.6, self.room_half * 0.6, size=(self.n_spheres, 3))
        r = rng.uniform(self.sphere_min_r, self.sphere_max_r, size=(self.n_spheres, 1))
        return np.concatenate([c, r], axis=1).astype(np.float32)

    def boxes(self) -> np.ndarray:
        """(n, 6) array of (cx, cy, cz, hx, hy, hz) axis-aligned cuboids."""
        rng = np.random.default_rng(self.seed + 1)
        c = rng.uniform(-self.room_half * 0.7, self.room_half * 0.7, size=(self.n_boxes, 3))
        h = rng.uniform(self.box_min_half, self.box_max_half, size=(self.n_boxes, 3))
        return np.concatenate([c, h], axis=1).astype(np.float32)


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(d) < 1e-9, torch.sign(d) * 1e-9 + 1e-12, d)


def _ray_box_interior(origin, dirs, half: float):
    """Exit distance of rays starting inside [-half, half]^3 (slab method)."""
    inv = _safe_inv(dirs)
    t1 = (-half - origin) * inv
    t2 = (half - origin) * inv
    return torch.amin(torch.maximum(t1, t2), dim=-1)


def _ray_spheres(origin, dirs, spheres):
    """Nearest positive hit over all spheres; inf where none."""
    oc = origin - spheres[:, :3]  # (n, 3)
    r = spheres[:, 3]
    d = dirs[..., None, :]  # (..., 1, 3)
    a = torch.sum(d * d, dim=-1)
    b = 2.0 * torch.sum(d * oc, dim=-1)
    cc = torch.sum(oc * oc, dim=-1) - r * r
    disc = b * b - 4.0 * a * cc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    t = torch.where(t0 > 1e-4, t0, t1)
    t = torch.where((disc > 0) & (t > 1e-4), t, torch.inf)
    return torch.amin(t, dim=-1)


def _ray_aabbs(origin, dirs, boxes):
    """Nearest positive entering hit over solid axis-aligned boxes."""
    c = boxes[:, :3]
    h = boxes[:, 3:]
    inv = _safe_inv(dirs[..., None, :])  # (..., 1, 3)
    oc = origin - c
    t1 = (-h - oc) * inv
    t2 = (h - oc) * inv
    t_near = torch.amax(torch.minimum(t1, t2), dim=-1)
    t_far = torch.amin(torch.maximum(t1, t2), dim=-1)
    t = torch.where((t_near > 1e-4) & (t_near <= t_far), t_near, torch.inf)
    return torch.amin(t, dim=-1)


def _texture(p: torch.Tensor, spec: SceneSpec) -> torch.Tensor:
    """Procedural RGB in [0, 1] from world position (..., 3)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    f = spec.checker_freq
    checker = torch.remainder(
        torch.floor(x * f) + torch.floor(y * f) + torch.floor(z * f), 2.0
    )
    g = spec.tex_freq
    s1 = 0.5 + 0.5 * torch.sin(x * g * 3.1 + y * g * 1.7)
    s2 = 0.5 + 0.5 * torch.sin(y * g * 2.3 + z * g * 2.9)
    s3 = 0.5 + 0.5 * torch.sin(z * g * 3.7 + x * g * 1.3)
    fine = 0.5 + 0.5 * torch.sin(x * 11.0) * torch.sin(y * 13.0) * torch.sin(z * 9.0)
    base = torch.stack([s1, s2, s3], dim=-1)
    return torch.clamp(
        0.15 + 0.55 * base * (0.4 + 0.6 * checker[..., None]) + 0.25 * fine[..., None],
        0.0, 1.0,
    )


def render_frame(T_wc, cam: CameraIntrinsics, spec: SceneSpec = SceneSpec(),
                 device=None):
    """Render (depth_raw, rgb) from camera-to-world pose T_wc (4, 4).

    depth_raw is z-depth in sensor units (uint16 values, held as int32:
    torch has few uint16 kernels); rgb is (H, W, 3) uint8. Both lie on
    `device` (default: T_wc's device).
    """
    T_wc = torch.as_tensor(T_wc, dtype=torch.float32, device=device)
    dev = T_wc.device
    h, w = cam.height, cam.width
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    # unnormalized camera ray with dz = 1, so t is z-depth
    d_cam = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                         torch.ones_like(u)], dim=-1)
    origin = T_wc[:3, 3]
    d_world = d_cam @ T_wc[:3, :3].T

    spheres = torch.from_numpy(spec.spheres()).to(dev)
    boxes = torch.from_numpy(spec.boxes()).to(dev)
    t = torch.minimum(
        torch.minimum(_ray_box_interior(origin, d_world, spec.room_half),
                      _ray_spheres(origin, d_world, spheres)),
        _ray_aabbs(origin, d_world, boxes),
    )
    rgb = _texture(origin + t[..., None] * d_world, spec)
    depth_raw = torch.clamp(t * cam.depth_scale, 0, 65535).to(torch.int32)
    rgb_u8 = torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)
    return depth_raw, rgb_u8


def orbit_trajectory(n_frames: int, spec: SceneSpec = SceneSpec(),
                     radius: float = 0.8, step_t: float = 0.012,
                     step_r: float = 0.01, seed: int = 3,
                     sweep: bool = False) -> np.ndarray:
    """Smooth ground-truth trajectory: (n, 4, 4) float32 camera-to-world.

    A gentle orbit + bob inside the room (~1 cm / 0.5 deg per frame).
    `sweep=True` reverses yaw and forward drift halfway, so the second half
    returns through the views of the first.
    """
    poses = []
    T = torch.eye(4, dtype=torch.float32)
    T[2, 3] = -radius
    for i in range(n_frames):
        a = i * step_r
        direction = -1.0 if (sweep and i >= n_frames // 2) else 1.0
        xi = torch.tensor([
            step_t * np.sin(a * 3.0),
            step_t * 0.5 * np.cos(a * 5.0),
            direction * step_t * np.cos(a * 2.0),
            step_r * 0.3 * np.sin(a * 4.0),
            direction * step_r * 1.0,
            step_r * 0.2 * np.cos(a * 3.0),
        ], dtype=torch.float32)
        poses.append(T.clone())
        T = se3.normalize_rotation(T @ se3.exp(xi))
    return torch.stack(poses).numpy()


class SyntheticSequence:
    """Iterable RGB-D sequence with ground truth, rendered on `device`."""

    def __init__(self, n_frames: int, cam: CameraIntrinsics,
                 spec: SceneSpec = SceneSpec(), fps: float = 30.0,
                 device="cpu", **traj_kw):
        self.cam = cam
        self.spec = spec
        self.fps = fps
        self.device = torch.device(device)
        self.poses = orbit_trajectory(n_frames, spec, **traj_kw)
        self.timestamps = np.arange(n_frames, dtype=np.float64) / fps

    def __len__(self) -> int:
        return len(self.poses)

    def frame(self, i: int):
        """(timestamp_s, depth_raw uint16 (H, W), rgb uint8 (H, W, 3))."""
        depth, rgb = render_frame(self.poses[i], self.cam, self.spec, self.device)
        return (self.timestamps[i], depth.cpu().numpy().astype(np.uint16),
                rgb.cpu().numpy())

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)

    def groundtruth(self) -> np.ndarray:
        """(n, 4, 4) camera-to-world poses."""
        return self.poses
