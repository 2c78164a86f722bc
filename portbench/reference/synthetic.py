"""The benchmark's sensor: an analytic raycast of a box room cluttered with
spheres and cuboids, coloured by a procedural texture, along the port's
out-and-back orbit, in plain torch on any device.

A frozen copy of the port's synthetic room (`io/synthetic.py`), so that a
change to the program cannot move the inputs. A room's number draws its
clutter layout and texture; the counts of spheres and cuboids, the
trajectory, its pace and its length are the same in every room. Clutter is
drawn again where it would come
within `CLEARANCE` of the camera's path (the port's own room keeps 0.31 m),
so that no seed puts the camera inside or right against an object: at
0.3 m some seeds lost tracking a frame or two where clutter came close.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.camera import Camera

CLEARANCE = 0.5  # metres between the camera's path and any clutter


@dataclass(frozen=True)
class Room:
    spheres: np.ndarray  # (n, 4) centre, radius
    boxes: np.ndarray  # (n, 6) centre, half sizes
    tex_freq: float
    checker_freq: float
    phase: np.ndarray  # (3,) texture phases
    room_half: float = 3.0


def _twist_exp(xi: np.ndarray) -> np.ndarray:
    """se(3) exp in float64 of a (v, w) twist."""
    v, w = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-9:
        R, V = np.eye(3) + W, np.eye(3) + 0.5 * W
    else:
        a, b = np.sin(th) / th, (1 - np.cos(th)) / th ** 2
        c = (th - np.sin(th)) / th ** 3
        R, V = np.eye(3) + a * W + b * W @ W, np.eye(3) + b * W + c * W @ W
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, V @ v
    return T


def orbit(n_frames: int, radius: float = 0.8, step_t: float = 0.012,
          step_r: float = 0.01) -> np.ndarray:
    """(n, 4, 4) float32 camera-to-world poses: a gentle orbit and bob,
    ~1 cm and 0.57 deg a frame, yaw and forward drift reversed halfway so
    that the second half returns through the first half's views."""
    T = np.eye(4)
    T[2, 3] = -radius
    poses = []
    for i in range(n_frames):
        a = i * step_r
        s = -1.0 if i >= n_frames // 2 else 1.0
        xi = np.array([step_t * np.sin(a * 3.0), step_t * 0.5 * np.cos(a * 5.0),
                       s * step_t * np.cos(a * 2.0), step_r * 0.3 * np.sin(a * 4.0),
                       s * step_r, step_r * 0.2 * np.cos(a * 3.0)])
        poses.append(T.copy())
        T = T @ _twist_exp(xi)
        U, _, Vt = np.linalg.svd(T[:3, :3])
        T[:3, :3] = U @ Vt
    return np.stack(poses).astype(np.float32)


def _clear(path: np.ndarray, sphere=None, box=None) -> bool:
    if sphere is not None:
        d = np.linalg.norm(path - sphere[:3], axis=1) - sphere[3]
    else:
        q = np.maximum(np.abs(path - box[:3]) - box[3:], 0.0)
        d = np.linalg.norm(q, axis=1)
    return bool(d.min() > CLEARANCE)


def seeded_room(number: int, path: np.ndarray, n_spheres: int = 16,
                n_boxes: int = 12, room_half: float = 3.0) -> Room:
    """Room `number`: 16 spheres (r 0.15-0.5 m) and 12 cuboids (half sizes
    0.12-0.6 m) kept `CLEARANCE` off the camera positions `path` (n, 3),
    and the texture's frequencies and phases."""
    rng = np.random.default_rng(np.random.SeedSequence([number, 0x5EED]))
    spheres, boxes = [], []
    while len(spheres) < n_spheres:
        s = np.concatenate([rng.uniform(-0.6 * room_half, 0.6 * room_half, 3),
                            rng.uniform(0.15, 0.5, 1)])
        if _clear(path, sphere=s):
            spheres.append(s)
    while len(boxes) < n_boxes:
        b = np.concatenate([rng.uniform(-0.7 * room_half, 0.7 * room_half, 3),
                            rng.uniform(0.12, 0.6, 3)])
        if _clear(path, box=b):
            boxes.append(b)
    return Room(spheres=np.stack(spheres).astype(np.float32),
                boxes=np.stack(boxes).astype(np.float32),
                tex_freq=float(rng.uniform(1.7, 2.5)),
                checker_freq=float(rng.uniform(1.4, 2.0)),
                phase=rng.uniform(0.0, 2.0 * np.pi, 3), room_half=room_half)


def _safe_inv(d):
    return 1.0 / torch.where(torch.abs(d) < 1e-9, torch.sign(d) * 1e-9 + 1e-12, d)


def _texture(p: torch.Tensor, room: Room) -> torch.Tensor:
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    f, g = room.checker_freq, room.tex_freq
    ph = [float(v) for v in room.phase]
    checker = torch.remainder(torch.floor(x * f) + torch.floor(y * f) + torch.floor(z * f), 2.0)
    s1 = 0.5 + 0.5 * torch.sin(x * g * 3.1 + y * g * 1.7 + ph[0])
    s2 = 0.5 + 0.5 * torch.sin(y * g * 2.3 + z * g * 2.9 + ph[1])
    s3 = 0.5 + 0.5 * torch.sin(z * g * 3.7 + x * g * 1.3 + ph[2])
    fine = 0.5 + 0.5 * torch.sin(x * 11.0) * torch.sin(y * 13.0) * torch.sin(z * 9.0)
    base = torch.stack([s1, s2, s3], dim=-1)
    return torch.clamp(0.15 + 0.55 * base * (0.4 + 0.6 * checker[..., None])
                       + 0.25 * fine[..., None], 0.0, 1.0)


def render(T_wc: np.ndarray, cam: Camera, room: Room, device):
    """(depth in sensor units as int32 holding uint16 values, rgb uint8)
    of cameras at `T_wc`, (4, 4) or (n, 4, 4), on `device`."""
    T = torch.as_tensor(np.asarray(T_wc), dtype=torch.float32, device=device)
    one = T.dim() == 2
    T = T.reshape(-1, 4, 4)
    h, w = cam.height, cam.width
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    d_cam = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, torch.ones_like(u)],
                        dim=-1)
    o = T[:, None, None, :3, 3]  # (n, 1, 1, 3)
    # d_cam @ R^T, elementwise
    d = (d_cam[None, :, :, None, :] * T[:, None, None, :3, :3]).sum(-1)  # (n, h, w, 3)
    sp = torch.as_tensor(room.spheres, device=device)
    bx = torch.as_tensor(room.boxes, device=device)

    inv = _safe_inv(d)
    t_room = torch.amin(torch.maximum((-room.room_half - o) * inv, (room.room_half - o) * inv),
                        dim=-1)
    oc = o[..., None, :] - sp[:, :3]  # (n, 1, 1, k, 3)
    dd = d[..., None, :]
    a = torch.sum(dd * dd, dim=-1)
    b = 2.0 * torch.sum(dd * oc, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - sp[:, 3] ** 2
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0, t1 = (-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a)
    ts = torch.where(t0 > 1e-4, t0, t1)
    t_sph = torch.amin(torch.where((disc > 0) & (ts > 1e-4), ts, torch.inf), dim=-1)
    invb = _safe_inv(dd)
    ob = o[..., None, :] - bx[:, :3]
    t1b = (-bx[:, 3:] - ob) * invb
    t2b = (bx[:, 3:] - ob) * invb
    near = torch.amax(torch.minimum(t1b, t2b), dim=-1)
    far = torch.amin(torch.maximum(t1b, t2b), dim=-1)
    t_box = torch.amin(torch.where((near > 1e-4) & (near <= far), near, torch.inf), dim=-1)

    t = torch.minimum(torch.minimum(t_room, t_sph), t_box)
    rgb = _texture(o + t[..., None] * d, room)
    depth = torch.clamp(t * cam.depth_scale, 0, 65535).to(torch.int32)
    rgb = torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)
    return (depth[0], rgb[0]) if one else (depth, rgb)


def render_frames(poses: np.ndarray, cam: Camera, room: Room, device, depth: np.ndarray,
                  rgb: np.ndarray, ids, chunk: int = 8) -> None:
    """Frames `ids` of `poses`, as the sensor gives them (uint16 depth,
    uint8 rgb), into the host arrays `depth` (n, H, W) and `rgb`
    (n, H, W, 3), `chunk` frames a pass on `device`."""
    ids = list(ids)
    for i in range(0, len(ids), chunk):
        part = ids[i:i + chunk]
        d, c = render(poses[part], cam, room, device)
        depth[part] = d.cpu().numpy().astype(np.uint16)
        rgb[part] = c.cpu().numpy()
