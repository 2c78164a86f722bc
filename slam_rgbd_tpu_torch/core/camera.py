"""Pinhole camera ops in torch: back-projection, normals, frame pyramids.

Counterpart of `slam_rgbd_tpu/core/camera.py`. Images keep the reference's
layout: (H, W) planes and (H, W, 3) vertex / normal maps, float32, with
invalid depth held as 0 and tracked by boolean masks. Every function follows
its input's device.

Borders follow the reference exactly: the bilateral filter wraps around the
image (its stencil is a roll), while `normal_map` and `image_gradients` zero
their one-pixel border.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from slam_rgbd_tpu_torch.core.config import CameraIntrinsics


def depth_to_metres(depth_raw: torch.Tensor, cam: CameraIntrinsics) -> torch.Tensor:
    """Integer depth image (sensor units) -> float32 metres; 0 stays 0."""
    return depth_raw.to(torch.float32) / cam.depth_scale


def valid_depth_mask(depth_m: torch.Tensor, cam: CameraIntrinsics) -> torch.Tensor:
    return (depth_m > cam.min_depth) & (depth_m < cam.max_depth)


def pixel_grid(height: int, width: int, device=None):
    """(u, v) float32 coordinate grids, shape (H, W) each."""
    v = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    u = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    return u.expand(height, width), v.expand(height, width)


def backproject(depth_m: torch.Tensor, cam: CameraIntrinsics) -> torch.Tensor:
    """Depth (H, W) metres -> vertex map (H, W, 3); invalid pixels give 0."""
    h, w = depth_m.shape
    u, v = pixel_grid(h, w, depth_m.device)
    z = torch.where(valid_depth_mask(depth_m, cam), depth_m, 0.0)
    x = (u - cam.cx) * z / cam.fx
    y = (v - cam.cy) * z / cam.fy
    return torch.stack([x, y, z], dim=-1)


def _interior(h: int, w: int, device) -> torch.Tensor:
    u, v = pixel_grid(h, w, device)
    return (u > 0) & (u < w - 1) & (v > 0) & (v < h - 1)


def normal_map(vertices: torch.Tensor) -> torch.Tensor:
    """Central-difference unit normals (H, W, 3), facing the camera (-z).

    Zero where any stencil vertex is invalid and on the one-pixel border.
    """
    right = torch.roll(vertices, -1, dims=1)
    left = torch.roll(vertices, 1, dims=1)
    down = torch.roll(vertices, -1, dims=0)
    up = torch.roll(vertices, 1, dims=0)
    n = torch.linalg.cross(right - left, down - up, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp_min(norm, 1e-12)
    n = n * torch.where(n[..., 2:3] > 0, -1.0, 1.0)
    h, w = vertices.shape[:2]
    valid = (
        (vertices[..., 2] > 0)
        & (right[..., 2] > 0)
        & (left[..., 2] > 0)
        & (down[..., 2] > 0)
        & (up[..., 2] > 0)
        & (norm[..., 0] > 1e-12)
        & _interior(h, w, vertices.device)
    )
    return torch.where(valid[..., None], n, 0.0)


def downsample_depth(depth_m: torch.Tensor) -> torch.Tensor:
    """2x halve a depth map, averaging only the valid pixels of each 2x2."""
    h, w = depth_m.shape
    d = depth_m.reshape(h // 2, 2, w // 2, 2)
    valid = (d > 0).to(depth_m.dtype)
    s = torch.sum(d * valid, dim=(1, 3))
    c = torch.sum(valid, dim=(1, 3))
    return torch.where(c > 0, s / torch.clamp_min(c, 1.0), 0.0)


def downsample_intensity(img: torch.Tensor) -> torch.Tensor:
    """2x average-pool an intensity image (H, W)."""
    h, w = img.shape
    return img.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))


def bilateral_depth_filter(
    depth_m: torch.Tensor,
    radius: int = 2,
    sigma_space: float = 1.5,
    sigma_depth: float = 0.05,
) -> torch.Tensor:
    """Edge-preserving depth smoothing over a (2r+1)^2 window that wraps.

    The reference sums rolled copies, so a border pixel mixes with the
    opposite edge; circular padding reproduces that. All (2r+1)^2 taps are
    evaluated in one pass over an unfolded view instead of one pass each.
    Invalid (0) depth neither contributes nor gets filled.
    """
    k = 2 * radius + 1
    padded = F.pad(depth_m[None, None], (radius,) * 4, mode="circular")[0, 0]
    # taps[v, u, i, j] = depth[(v + i - r) mod H, (u + j - r) mod W]
    taps = padded.unfold(0, k, 1).unfold(1, k, 1)
    off = torch.arange(-radius, radius + 1, device=depth_m.device) ** 2
    w_space = torch.exp(
        -(off[:, None] + off[None, :]).to(torch.float32)
        / (2.0 * sigma_space * sigma_space)
    )
    center = depth_m[..., None, None]
    diff = taps - center
    w_depth = torch.exp(-(diff * diff) / (2.0 * sigma_depth * sigma_depth))
    wgt = torch.where((taps > 0) & (center > 0), w_space * w_depth, 0.0)
    acc = torch.sum(wgt * taps, dim=(-2, -1))
    wacc = torch.sum(wgt, dim=(-2, -1))
    return torch.where(wacc > 1e-12, acc / torch.clamp_min(wacc, 1e-12), 0.0)


def image_gradients(img: torch.Tensor) -> torch.Tensor:
    """Central-difference gradients (H, W, 2) = (d/du, d/dv); zero border."""
    gx = 0.5 * (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1))
    gy = 0.5 * (torch.roll(img, -1, dims=0) - torch.roll(img, 1, dims=0))
    h, w = img.shape
    return torch.where(
        _interior(h, w, img.device)[..., None], torch.stack([gx, gy], dim=-1), 0.0
    )


def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
    """RGB888 (H, W, 3) -> float32 grayscale in [0, 255]."""
    c = rgb.to(torch.float32)
    return 0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2]


def build_frame_pyramid(
    depth_raw: torch.Tensor,
    cam: CameraIntrinsics,
    levels: int = 3,
    filter_depth: bool = True,
    rgb: torch.Tensor | None = None,
):
    """Depth (+ optional RGB) image -> tuple of per-level dicts, finest first.

    Each level has depth (m), vertices, normals, valid and, with `rgb`,
    intensity in [0, 1] and its (du, dv) gradients: the keys of the
    reference's pyramid. Level k is (H/2^k, W/2^k).
    """
    depth_m = depth_to_metres(depth_raw, cam)
    if filter_depth:
        depth_m = bilateral_depth_filter(depth_m)
    intensity = None if rgb is None else rgb_to_intensity(rgb) / 255.0
    pyr = []
    d = depth_m
    level_cam = cam
    for k in range(levels):
        verts = backproject(d, level_cam)
        norms = normal_map(verts)
        valid = (verts[..., 2] > 0) & (torch.sum(norms * norms, dim=-1) > 0.5)
        level = {"depth": d, "vertices": verts, "normals": norms, "valid": valid}
        if intensity is not None:
            level["intensity"] = intensity
            level["grad"] = image_gradients(intensity)
        pyr.append(level)
        if k + 1 < levels:
            d = downsample_depth(d)
            if intensity is not None:
                intensity = downsample_intensity(intensity)
            level_cam = cam.scaled(2.0 ** (k + 1))
    return tuple(pyr)
