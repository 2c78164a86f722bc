"""ORB-class descriptors: intensity-centroid orientation + steered BRIEF-256.

Counterpart of `slam_rgbd_tpu/features/orb.py`:

  * Patches for all K keypoints are gathered bilinearly from the smoothed
    pyramid level of each keypoint: a (K, P, P) tensor, fixed shapes.
  * The BRIEF point-pair pattern is generated once from a fixed seed
    (isotropic Gaussian, sigma = patch / 5) and rotated per keypoint by its
    orientation (steered BRIEF).
  * Descriptors come both bit-packed ((K, 8) words) and as a sign matrix
    ((K, 256) int8 in {-1, +1}), the operand of the matching kernels.

The reference extracts and samples patches with one-hot matrix products; the
port gathers directly and keeps the products' edge rule: a tap outside the
image weighs zero (it is not clamped to the border).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from slam_rgbd_tpu_torch.features.detect import Keypoints, _per_level_budget

PATCH = 31  # ORB patch diameter
_HALF = PATCH // 2
N_BITS = 256


@functools.lru_cache()
def brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) float32: (x1, y1, x2, y2) sample offsets, sigma = PATCH/5.

    Deterministic Gaussian point pairs clipped to the patch, the original
    BRIEF-II construction.
    """
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 4))
    return np.clip(pts, -_HALF + 1, _HALF - 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _brief_pattern_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(brief_pattern()).to(device)


def smooth(img: torch.Tensor) -> torch.Tensor:
    """5-tap binomial blur (separable); wraps at the border."""
    taps = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
    for ax in (0, 1):
        acc = torch.zeros_like(img)
        for i, w in enumerate(taps):
            acc = acc + w * torch.roll(img, i - 2, dims=ax)
        img = acc
    return img


def extract_patches(img: torch.Tensor, uv: torch.Tensor, patch: int = PATCH) -> torch.Tensor:
    """Bilinear (K, patch, patch) patch extraction around `uv`.

    The sample grid of a keypoint is `uv + offs` with integer offsets, so
    the fractional part is one per keypoint and the interpolation separates:
    rows first, then columns. One (K, patch+1, patch+1) gather of the taps;
    a tap outside the image reads zero.
    """
    h, w = img.shape
    half = patch // 2
    u0f = torch.floor(uv[:, 0] - half)
    v0f = torch.floor(uv[:, 1] - half)
    fu = (uv[:, 0] - half - u0f)[:, None, None]
    fv = (uv[:, 1] - half - v0f)[:, None, None]
    taps = torch.arange(patch + 1, device=img.device)
    rows = v0f.long()[:, None] + taps  # (K, patch+1)
    cols = u0f.long()[:, None] + taps
    inside = (((rows >= 0) & (rows < h))[:, :, None]
              & ((cols >= 0) & (cols < w))[:, None, :])
    g = img[rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
    g = torch.where(inside, g, 0.0)
    tmp = (1.0 - fv) * g[:, :-1, :] + fv * g[:, 1:, :]
    return (1.0 - fu) * tmp[:, :, :-1] + fu * tmp[:, :, 1:]


class Descriptors(NamedTuple):
    # (K, 8) int32 holding the bits of the reference's uint32 words: bit b of
    # word w is descriptor bit w * 32 + b (view as uint32 in numpy)
    packed: torch.Tensor
    signs: torch.Tensor  # (K, 256) int8 in {-1, +1}: the matching operand
    angle: torch.Tensor  # (K,) float32 orientation used


def orientation(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per patch (K, P, P) -> (K,) radians.

    theta = atan2(m01, m10) over a circular mask of radius PATCH/2.
    """
    p = patches.shape[-1]
    c = (p - 1) / 2.0
    ax = torch.arange(p, dtype=torch.float32, device=patches.device) - c
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    w = torch.where(xx * xx + yy * yy <= c * c, 1.0, 0.0)
    m10 = torch.sum(patches * (xx * w), dim=(-2, -1))
    m01 = torch.sum(patches * (yy * w), dim=(-2, -1))
    return torch.arctan2(m01, m10)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool -> (K, 8) int32 words, bit b of word w = bits[w*32+b]."""
    k = bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(k, 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    # keep the low 32 bits as a signed word
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def describe(kp: Keypoints, pyramid: tuple, scale_factor: float = 1.2) -> Descriptors:
    """Oriented BRIEF-256 descriptors for fixed-K keypoints.

    `pyramid` is the per-level intensity tuple from `detect_pyramid`.
    Keypoints are level-contiguous in `detect_pyramid`'s budget order, so
    each level extracts only its own slice.
    """
    K = kp.uv.shape[0]
    pat = _brief_pattern_on(kp.uv.device)  # (256, 4)

    budgets = _per_level_budget(K, len(pyramid), scale_factor)
    chunks, off = [], 0
    for l, img in enumerate(pyramid):
        k_l = budgets[l]
        s = scale_factor**l
        # keypoint position in this level's pixel coords (pixel-centre conv.)
        uv_l = (kp.uv[off: off + k_l] + 0.5) / s - 0.5
        chunks.append(extract_patches(smooth(img), uv_l))
        off += k_l
    patches = torch.cat(chunks, dim=0)  # (K, P, P)

    theta = orientation(patches)
    ct, st = torch.cos(theta)[:, None], torch.sin(theta)[:, None]

    # rotate the pattern offsets per keypoint and sample within the patch
    # (patch centre at (_HALF, _HALF), axis-aligned in level coords)
    def rot(x, y):
        return ct * x[None] - st * y[None], st * x[None] + ct * y[None]

    x1, y1 = rot(pat[:, 0], pat[:, 1])  # (K, 256)
    x2, y2 = rot(pat[:, 2], pat[:, 3])
    flat = patches.reshape(K, PATCH * PATCH)

    def sample_patch(x, y):
        """Bilinear in-patch sampling at (K, B) rotated positions: rows
        first, then columns, as four gathered taps."""
        u = torch.clamp(x + _HALF, 0.0, PATCH - 1.001)
        v = torch.clamp(y + _HALF, 0.0, PATCH - 1.001)
        u0 = torch.floor(u)
        v0 = torch.floor(v)
        fu, fv = u - u0, v - v0
        base = v0.long() * PATCH + u0.long()

        def tap(dv, du):
            return torch.gather(flat, 1, base + (dv * PATCH + du))

        left = (1.0 - fv) * tap(0, 0) + fv * tap(1, 0)
        right = (1.0 - fv) * tap(0, 1) + fv * tap(1, 1)
        return (1.0 - fu) * left + fu * right

    bits = sample_patch(x1, y1) < sample_patch(x2, y2)  # (K, 256) bool
    signs = torch.where(bits, 1, -1).to(torch.int8)
    return Descriptors(packed=pack_bits(bits), signs=signs, angle=theta)


def keypoint_depth(kp: Keypoints, depth_m: torch.Tensor, cam,
                   edge_rel_tol: float = 0.06):
    """3-D camera-frame points for keypoints from the depth map.

    Returns ((K, 3) points, (K,) valid). Corners often sit on depth
    discontinuities, where the depth pixel may belong to either surface, so
    a keypoint whose 3x3 depth window spans more than `edge_rel_tol * z` (or
    holds invalid depth) is rejected.
    """
    h, w = depth_m.shape
    u = torch.clamp(torch.round(kp.uv[:, 0]).long(), 1, w - 2)
    v = torch.clamp(torch.round(kp.uv[:, 1]).long(), 1, h - 2)
    z = depth_m[v, u]
    zmin = torch.full_like(z, torch.inf)
    zmax = torch.zeros_like(z)
    for dv in (-1, 0, 1):
        for du in (-1, 0, 1):
            zn = depth_m[v + dv, u + du]
            zmin = torch.minimum(zmin, zn)
            zmax = torch.maximum(zmax, zn)
    flat = (zmin > 0) & ((zmax - zmin) < edge_rel_tol * torch.clamp_min(z, 0.3))
    ok = kp.valid & (z > cam.min_depth) & (z < cam.max_depth) & flat
    x = (kp.uv[:, 0] - cam.cx) * z / cam.fx
    y = (kp.uv[:, 1] - cam.cy) * z / cam.fy
    pts = torch.stack([x, y, z], dim=-1)
    return torch.where(ok[:, None], pts, 0.0), ok
