"""Synthetic RGB-D sequences with exact ground truth, rendered in torch.

Counterpart of `slam_rgbd_tpu/io/synthetic.py`: an analytic raycast of a
box room cluttered with spheres and cuboids, coloured by a procedural 3D
texture, seen along a smooth orbit, and optionally corrupted like a real
structured-light sensor (`NoiseSpec`). Rendering and noise run on any torch
device.

The noise is split in two. `apply_sensor_noise` is deterministic: it takes
its random draws as tensors (`NoiseDraws`), so the same draws give the
reference's result. `draw_noise` makes the draws from a `torch.Generator`
on the frame's device, seeded from `NoiseSpec.seed` and the frame index;
its bits are not those of `jax.random`, only their distributions are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from slam_rgbd_tpu_torch.core.config import CameraIntrinsics
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


@dataclass(frozen=True)
class NoiseSpec:
    """Kinect-class RGB-D sensor noise (the reference's Astra operating
    point): axial depth noise sigma_z = `depth_sigma_rel2` * z^2, dropout at
    depth silhouettes plus uniform dropout, a per-frame RGB gain (flicker)
    and per-pixel shot noise; optionally motion blur along the frame's
    image flow and a slow sinusoidal exposure drift."""

    depth_sigma_rel2: float = 1.4e-3  # m of std per m^2 of range
    edge_dropout: float = 0.6  # P(drop) where the depth edge test fires
    edge_rel_tol: float = 0.02  # neighbour depth ratio that counts as edge
    random_dropout: float = 0.002  # uniform missing-return probability
    rgb_sigma: float = 2.0  # shot noise, 0..255 units
    flicker: float = 0.03  # max |gain - 1| per frame
    seed: int = 11
    # RGB box blur along the dominant image flow, scaled by the frame's
    # motion (0 disables; 1.0 blurs over the full inter-frame flow)
    motion_blur: float = 0.0
    # sinusoidal global gain drift of this amplitude on top of the flicker
    exposure_drift: float = 0.0
    exposure_period_s: float = 4.0


class NoiseDraws(NamedTuple):
    """The random draws of one frame's noise, float32 on its device."""

    depth_normal: torch.Tensor  # (H, W) standard normal: axial noise
    edge_uniform: torch.Tensor  # (H, W) U[0, 1): silhouette dropout
    drop_uniform: torch.Tensor  # (H, W) U[0, 1): random dropout
    rgb_normal: torch.Tensor  # (H, W, 3) standard normal: shot noise
    gain_uniform: torch.Tensor  # () U[0, 1): flicker


def draw_noise(h: int, w: int, spec: "NoiseSpec", index: int, device) -> NoiseDraws:
    """The draws of frame `index`, from a generator on `device` seeded from
    `spec.seed` and the index: the same frame gets the same draws on the
    same kind of device."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    # one 32-bit seed mixed from both (the CPU generator reads 32 bits)
    gen.manual_seed(int(np.random.SeedSequence([spec.seed, index]).generate_state(1)[0]))

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    return NoiseDraws(normal(h, w), uniform(h, w), uniform(h, w), normal(h, w, 3),
                      uniform())


def apply_sensor_noise(depth_raw, rgb, draws: NoiseDraws, cam: CameraIntrinsics,
                       spec: "NoiseSpec" = NoiseSpec(), flow_px=None, t_s=None):
    """Corrupt a clean frame like a real structured-light sensor, with the
    given draws, in the reference's order of operations.

    depth_raw (H, W) in sensor units (any integer type), rgb (H, W, 3)
    uint8; `flow_px` the frame's dominant image flow (u, v) in px a frame,
    `t_s` its time in seconds (the exposure drift's phase). Returns depth as
    int32 holding uint16 values and rgb as uint8; both casts clip as the
    reference's do.
    """
    f32 = torch.float32
    # metres by the float32 reciprocal of the scale, as the reference's
    # compiled program computes it: the edge test below sits exactly on its
    # threshold on quantized planes, so the last bit of z decides a dropout
    z = depth_raw.to(f32) * np.float32(1.0 / cam.depth_scale)
    if spec.motion_blur > 0.0 and flow_px is not None:
        # 5-tap box blur along the flow: integer-shifted rolls, the shifts
        # rounded half to even in float32 as the reference rounds them
        flow = np.asarray(flow_px, np.float32)
        acc = torch.zeros(rgb.shape, dtype=f32, device=rgb.device)
        for frac in (-0.5, -0.25, 0.0, 0.25, 0.5):
            off = np.float32(spec.motion_blur * frac) * flow
            dx, dy = (int(v) for v in np.round(off))
            acc = acc + torch.roll(rgb.to(f32), shifts=(dy, dx), dims=(0, 1))
        rgb = (acc / 5.0).to(torch.uint8)

    sigma = spec.depth_sigma_rel2 * z * z
    z_noisy = z + sigma * draws.depth_normal
    # silhouette dropout: a 4-neighbour differing by more than
    # edge_rel_tol * max(z, 0.5)
    edge = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    for dim, s in ((0, 1), (0, -1), (1, 1), (1, -1)):
        edge = edge | (torch.abs(torch.roll(z, s, dims=dim) - z)
                       > spec.edge_rel_tol * torch.clamp_min(z, 0.5))
    drop = (edge & (draws.edge_uniform < spec.edge_dropout)) | (
        draws.drop_uniform < spec.random_dropout)
    z_noisy = torch.where(drop, 0.0, z_noisy)
    depth_out = torch.clamp(z_noisy * cam.depth_scale, 0, 65535).to(torch.int32)

    gain = 1.0 + spec.flicker * (2.0 * draws.gain_uniform - 1.0)
    if spec.exposure_drift > 0.0 and t_s is not None:
        t = torch.tensor(t_s, dtype=f32, device=z.device)
        gain = gain * (1.0 + spec.exposure_drift * torch.sin(
            2.0 * np.pi * t / spec.exposure_period_s))
    rgb_f = rgb.to(f32) * gain + spec.rgb_sigma * draws.rgb_normal
    rgb_out = torch.clamp(rgb_f, 0, 255).to(torch.uint8)
    return depth_out, rgb_out


def frame_flow(poses: np.ndarray, i: int, cam: CameraIntrinsics) -> tuple[float, float]:
    """Dominant image flow (u, v) in px of frame i's motion, as the
    reference's sequence computes it: rotational terms dominate handheld
    flow, u ~ fx |w_y|, v ~ fy |w_x|, from the twist into frame i (frame 0
    takes frame 1's)."""
    j = max(i - 1, 0)
    rel = np.linalg.inv(poses[j]) @ poses[min(j + 1, len(poses) - 1)]
    xi = se3.log(torch.from_numpy(rel.astype(np.float32))).tolist()
    return (float(np.float32(cam.fx * abs(xi[4]))), float(np.float32(cam.fy * abs(xi[3]))))


def noisy_frame(depth_raw, rgb, i: int, poses: np.ndarray, cam: CameraIntrinsics,
                spec: "NoiseSpec", fps: float = 30.0):
    """Frame i of a sequence along `poses` through the sensor model, on the
    frame's device: its draws, its flow and its time i / fps."""
    draws = draw_noise(depth_raw.shape[0], depth_raw.shape[1], spec, i, depth_raw.device)
    return apply_sensor_noise(depth_raw, rgb, draws, cam, spec,
                              flow_px=frame_flow(poses, i, cam), t_s=i / fps)


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
    """Iterable RGB-D sequence with ground truth, rendered on `device`: the
    CUDA device unless the caller asks for "cpu"; without a card the default
    raises. With `noise`, every frame goes through the sensor model."""

    def __init__(self, n_frames: int, cam: CameraIntrinsics,
                 spec: SceneSpec = SceneSpec(), fps: float = 30.0,
                 noise: NoiseSpec | None = None, device="cuda", **traj_kw):
        self.cam = cam
        self.spec = spec
        self.fps = fps
        self.noise = noise
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SyntheticSequence was asked for a CUDA device but torch sees "
                "none; pass device='cpu' to render on the CPU")
        self.poses = orbit_trajectory(n_frames, spec, **traj_kw)
        self.timestamps = np.arange(n_frames, dtype=np.float64) / fps

    def __len__(self) -> int:
        return len(self.poses)

    def frame(self, i: int):
        """(timestamp_s, depth_raw uint16 (H, W), rgb uint8 (H, W, 3))."""
        depth, rgb = render_frame(self.poses[i], self.cam, self.spec, self.device)
        if self.noise is not None:
            depth, rgb = noisy_frame(depth, rgb, i, self.poses, self.cam, self.noise,
                                     self.fps)
        return (self.timestamps[i], depth.cpu().numpy().astype(np.uint16),
                rgb.cpu().numpy())

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)

    def groundtruth(self) -> np.ndarray:
        """(n, 4, 4) camera-to-world poses."""
        return self.poses
