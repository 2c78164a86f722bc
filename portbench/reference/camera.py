"""Pinhole camera and the tracker's frame pyramid in plain torch: a frozen
copy of the port's conventions (bilateral filter that wraps, central
differences with a zeroed border, 2x2 valid-average depth pooling)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    depth_scale: float
    min_depth: float = 0.2
    max_depth: float = 8.0
    fps: float = 30.0

    @classmethod
    def from_dict(cls, d: dict) -> "Camera":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def scaled(self, factor: float) -> "Camera":
        """Intrinsics of an image downscaled by `factor`."""
        return dataclasses.replace(
            self, fx=self.fx / factor, fy=self.fy / factor,
            cx=(self.cx + 0.5) / factor - 0.5, cy=(self.cy + 0.5) / factor - 0.5,
            width=int(self.width / factor), height=int(self.height / factor))


def pixel_grid(h: int, w: int, device):
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return u.expand(h, w), v.expand(h, w)


def depth_to_metres(depth_raw: torch.Tensor, cam: Camera) -> torch.Tensor:
    return depth_raw.to(torch.float32) / cam.depth_scale


def backproject(depth_m: torch.Tensor, cam: Camera) -> torch.Tensor:
    h, w = depth_m.shape[-2:]
    u, v = pixel_grid(h, w, depth_m.device)
    ok = (depth_m > cam.min_depth) & (depth_m < cam.max_depth)
    z = torch.where(ok, depth_m, 0.0)
    return torch.stack([(u - cam.cx) * z / cam.fx, (v - cam.cy) * z / cam.fy, z], dim=-1)


def _interior(h: int, w: int, device) -> torch.Tensor:
    u, v = pixel_grid(h, w, device)
    return (u > 0) & (u < w - 1) & (v > 0) & (v < h - 1)


def normal_map(vertices: torch.Tensor) -> torch.Tensor:
    right = torch.roll(vertices, -1, dims=-2)
    left = torch.roll(vertices, 1, dims=-2)
    down = torch.roll(vertices, -1, dims=-3)
    up = torch.roll(vertices, 1, dims=-3)
    n = torch.linalg.cross(right - left, down - up, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp_min(norm, 1e-12)
    n = n * torch.where(n[..., 2:3] > 0, -1.0, 1.0)
    h, w = vertices.shape[-3:-1]
    valid = ((vertices[..., 2] > 0) & (right[..., 2] > 0) & (left[..., 2] > 0)
             & (down[..., 2] > 0) & (up[..., 2] > 0) & (norm[..., 0] > 1e-12)
             & _interior(h, w, vertices.device))
    return torch.where(valid[..., None], n, 0.0)


def downsample_depth(d: torch.Tensor) -> torch.Tensor:
    h, w = d.shape[-2:]
    x = d.reshape(d.shape[:-2] + (h // 2, 2, w // 2, 2))
    valid = (x > 0).to(d.dtype)
    s = torch.sum(x * valid, dim=(-3, -1))
    c = torch.sum(valid, dim=(-3, -1))
    return torch.where(c > 0, s / torch.clamp_min(c, 1.0), 0.0)


def downsample_intensity(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2:]
    return img.reshape(img.shape[:-2] + (h // 2, 2, w // 2, 2)).mean(dim=(-3, -1))


def bilateral_depth_filter(depth_m, radius: int = 2, sigma_space: float = 1.5,
                           sigma_depth: float = 0.05):
    k = 2 * radius + 1
    h, w = depth_m.shape[-2:]
    padded = F.pad(depth_m.reshape(-1, 1, h, w), (radius,) * 4, mode="circular")
    taps = padded.unfold(2, k, 1).unfold(3, k, 1).reshape(depth_m.shape + (k, k))
    off = torch.arange(-radius, radius + 1, device=depth_m.device) ** 2
    w_space = torch.exp(-(off[:, None] + off[None, :]).to(torch.float32)
                        / (2.0 * sigma_space * sigma_space))
    center = depth_m[..., None, None]
    diff = taps - center
    w_depth = torch.exp(-(diff * diff) / (2.0 * sigma_depth * sigma_depth))
    wgt = torch.where((taps > 0) & (center > 0), w_space * w_depth, 0.0)
    acc = torch.sum(wgt * taps, dim=(-2, -1))
    wacc = torch.sum(wgt, dim=(-2, -1))
    return torch.where(wacc > 1e-12, acc / torch.clamp_min(wacc, 1e-12), 0.0)


def image_gradients(img: torch.Tensor) -> torch.Tensor:
    gx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    gy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    h, w = img.shape[-2:]
    return torch.where(_interior(h, w, img.device)[..., None],
                       torch.stack([gx, gy], dim=-1), 0.0)


def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
    c = rgb.to(torch.float32)
    return 0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2]


def frame_pyramid(depth_raw: torch.Tensor, rgb: torch.Tensor, cam: Camera, levels: int):
    """Levels finest first: vertices, normals, valid, intensity in [0, 1]
    and its gradients."""
    d = bilateral_depth_filter(depth_to_metres(depth_raw, cam))
    intensity = rgb_to_intensity(rgb) / 255.0
    pyr, level_cam = [], cam
    for k in range(levels):
        verts = backproject(d, level_cam)
        norms = normal_map(verts)
        valid = (verts[..., 2] > 0) & (torch.sum(norms * norms, dim=-1) > 0.5)
        pyr.append({"vertices": verts, "normals": norms, "valid": valid,
                    "intensity": intensity, "grad": image_gradients(intensity)})
        if k + 1 < levels:
            d = downsample_depth(d)
            intensity = downsample_intensity(intensity)
            level_cam = cam.scaled(2.0 ** (k + 1))
    return tuple(pyr)
