"""FAST corner detection + Harris ranking + NMS + fixed top-K.

Counterpart of `slam_rgbd_tpu/features/detect.py`:

  * The FAST segment test (>= 9 contiguous of 16 circle pixels all brighter
    or all darker than the centre +/- t) is evaluated for every pixel from 16
    shifted image differences.
  * Ranking uses a dense Harris response with a box window.
  * Non-max suppression compares with the 3x3 neighbourhood; selection is a
    stable descending sort of the masked response, so that among equal
    responses the lower pixel index comes first (synthetic frames have exact
    plateaus). Outputs have a fixed K with a validity mask.

The stencils are `torch.roll`s and wrap at the image border, as the
reference's do: the wrap defines the values inside the 16-pixel border that
`detect_level` masks out.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# Bresenham circle of radius 3 (the FAST-16 ring), clockwise from 12
# o'clock, as (dv, du) image offsets.
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (struct of tensors, masked)."""

    uv: torch.Tensor  # (K, 2) float32: level-0 pixel coords (u, v)
    response: torch.Tensor  # (K,) float32
    angle: torch.Tensor  # (K,) float32 radians (filled by orb.describe)
    level: torch.Tensor  # (K,) int32 pyramid level
    valid: torch.Tensor  # (K,) bool


def _ring_diffs(img: torch.Tensor) -> torch.Tensor:
    """(16, H, W) of I(circle_i) - I(centre)."""
    return torch.stack(
        [torch.roll(img, (-dv, -du), dims=(0, 1)) - img for dv, du in _CIRCLE]
    )


def _has_arc(m: torch.Tensor) -> torch.Tensor:
    """(16, H, W) bool -> (H, W): some 9 consecutive (cyclic) ring entries
    are all set. Runs of 2, 4 and 8 by doubling, then one more entry."""
    a2 = m & torch.roll(m, -1, dims=0)
    a4 = a2 & torch.roll(a2, -2, dims=0)
    a8 = a4 & torch.roll(a4, -4, dims=0)
    return (a8 & torch.roll(m, -8, dims=0)).any(dim=0)


def _fast_from_diffs(d: torch.Tensor, threshold: float):
    bright = d > threshold
    dark = d < -threshold
    is_corner = _has_arc(bright) | _has_arc(dark)
    terms = torch.where(bright | dark, torch.abs(d), 0.0)
    score = terms[0]
    for i in range(1, terms.shape[0]):  # ring order, as a sequential sum
        score = score + terms[i]
    return is_corner, score


def fast_score(img: torch.Tensor, threshold: float):
    """FAST-16 segment test + continuity.

    Returns (is_corner (H, W) bool, sad_score (H, W) float32). The score is
    the sum of |diff| over circle pixels exceeding the threshold.
    """
    return _fast_from_diffs(_ring_diffs(img), threshold)


def harris_response(img: torch.Tensor, k: float = 0.04, window: int = 3) -> torch.Tensor:
    """Dense Harris corner response with a box window (separable sums)."""
    gx = 0.5 * (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1))
    gy = 0.5 * (torch.roll(img, -1, dims=0) - torch.roll(img, 1, dims=0))

    def box(x):
        for ax in (0, 1):
            acc = x
            for s in range(1, window + 1):
                acc = acc + torch.roll(x, s, dims=ax) + torch.roll(x, -s, dims=ax)
            x = acc
        return x

    sxx = box(gx * gx)
    syy = box(gy * gy)
    sxy = box(gx * gy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def nms_mask(score: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """True where score is >= every neighbour in its (2r+1)^2 window.

    Ties survive (both pixels fire): exact plateaus happen on synthetic
    imagery, and duplicates are preferable to dropping a whole plateau.
    """
    neigh = torch.full_like(score, -torch.inf)
    for dv in range(-radius, radius + 1):
        for du in range(-radius, radius + 1):
            if dv == 0 and du == 0:
                continue
            neigh = torch.maximum(neigh, torch.roll(score, (dv, du), dims=(0, 1)))
    return score >= neigh


def detect_level(img: torch.Tensor, k: int, threshold: float,
                 min_threshold: float, border: int = 16):
    """Detect up to `k` FAST corners on one intensity image (H, W) in [0,1].

    Thresholds are in 0..255 intensity units; the image is scaled
    internally. Returns (uv (k, 2) f32, response (k,), valid (k,)).
    """
    x = img * 255.0
    h, w = x.shape
    d = _ring_diffs(x)
    is_strong, _ = _fast_from_diffs(d, threshold)
    is_weak, sad = _fast_from_diffs(d, min_threshold)

    # NMS on the FAST SAD score restricted to corner pixels, then Harris
    # *ranking* (Harris peaks inside blobs, not at FAST corners).
    sad_masked = torch.where(is_weak, sad, -torch.inf)
    survives = is_weak & nms_mask(sad_masked)

    u = torch.arange(w, device=x.device)[None, :]
    v = torch.arange(h, device=x.device)[:, None]
    interior = (u >= border) & (u < w - border) & (v >= border) & (v < h - border)

    # any strong corner outranks every weak-only corner; within a class,
    # higher Harris wins
    harris = harris_response(x)
    resp = torch.where(is_strong, 1e6, 0.0) + harris
    resp = torch.where(survives & interior, resp, -torch.inf)

    # stable: the lower pixel index first among equal responses
    top_resp, idx = torch.sort(resp.reshape(-1), descending=True, stable=True)
    top_resp, idx = top_resp[:k], idx[:k]
    uu = (idx % w).to(torch.float32)
    vv = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    valid = torch.isfinite(top_resp)
    harris_at = harris.reshape(-1)[idx]
    return (torch.stack([uu, vv], dim=-1),
            torch.where(valid, harris_at, 0.0), valid)


def _level_shapes(height: int, width: int, n_levels: int, scale: float):
    shapes = []
    for l in range(n_levels):
        s = scale**l
        shapes.append((max(int(round(height / s)), 32), max(int(round(width / s)), 32)))
    return tuple(shapes)


def _per_level_budget(k_total: int, n_levels: int, scale: float):
    """Split the feature budget across levels proportional to image area
    (geometric decay, like ORB's per-level distribution)."""
    weights = [(1.0 / scale**2) ** l for l in range(n_levels)]
    total = sum(weights)
    ks = [max(int(round(k_total * w / total)), 8) for w in weights]
    ks[0] += k_total - sum(ks)  # pad/trim to exactly k_total
    return tuple(ks)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of a linear resize with antialiasing.

    The triangle kernel is widened by the shrink factor and each output's
    weights are normalised to sum to one: the weights `jax.image.resize(...,
    method="linear")` applies, computed in float32 in the same order.
    """
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = f32(max(float(inv_scale), 1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    wgt = np.maximum(f32(0.0), f32(1.0) - x)
    total = wgt.sum(axis=0, keepdims=True, dtype=f32)
    wgt = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                   wgt / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], wgt, f32(0.0)).T.astype(f32))


@functools.lru_cache(maxsize=None)
def _resize_weights_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """`_resize_weights` as a tensor on `device`, uploaded once."""
    return torch.from_numpy(_resize_weights(n_in, n_out)).to(device)


def resize_linear(img: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Antialiased linear resize of (H, W) to `shape`: one small weight
    matrix a dimension, rows then columns."""
    h, w = img.shape
    out = img
    if shape[0] != h:
        out = _resize_weights_on(h, shape[0], img.device) @ out
    if shape[1] != w:
        out = out @ _resize_weights_on(w, shape[1], img.device).T
    return out


def build_pyramid(intensity: torch.Tensor, n_levels: int, scale_factor: float) -> tuple:
    """The intensity pyramid: each level resized from the one above it."""
    shapes = _level_shapes(*intensity.shape, n_levels, scale_factor)
    pyr, img = [], intensity
    for shape in shapes:
        if shape != tuple(img.shape):
            img = resize_linear(img, shape)
        pyr.append(img)
    return tuple(pyr)


def detect_pyramid(intensity: torch.Tensor, n_features: int = 1024,
                   n_levels: int = 8, scale_factor: float = 1.2,
                   threshold: float = 20.0,
                   min_threshold: float = 7.0) -> tuple[Keypoints, tuple]:
    """Multi-scale FAST detection over a 1.2x scale pyramid.

    Returns (Keypoints with uv in level-0 coordinates, the intensity pyramid
    as a tuple of per-level images for the descriptor stage).
    """
    budgets = _per_level_budget(n_features, n_levels, scale_factor)
    pyr = build_pyramid(intensity, n_levels, scale_factor)
    dev = intensity.device

    uvs, resps, levels, valids = [], [], [], []
    for l, img in enumerate(pyr):
        uv, resp, valid = detect_level(img, budgets[l], threshold, min_threshold)
        s = scale_factor**l
        # pixel-centre convention: u0 = (u_l + 0.5) * s - 0.5
        uvs.append((uv + 0.5) * s - 0.5)
        resps.append(resp)
        levels.append(torch.full((budgets[l],), l, dtype=torch.int32, device=dev))
        valids.append(valid)

    kp = Keypoints(
        uv=torch.cat(uvs),
        response=torch.cat(resps),
        angle=torch.zeros(sum(budgets), dtype=torch.float32, device=dev),
        level=torch.cat(levels),
        valid=torch.cat(valids),
    )
    return kp, tuple(pyr)
