"""ORB features in plain torch: FAST-16 with Harris ranking and 3x3 NMS on
an antialiased 1.2x pyramid, intensity-centroid orientation, steered
BRIEF-256 as signs, and keypoint depth with its edge gate. A frozen copy of
the port's feature stage; the pyramid's resize products go through
`precision.mm`."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.precision import mm


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
    weights are normalised to sum to one (antialiased linear resampling),
    computed in float32 in the port's order.
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
        out = mm(_resize_weights_on(h, shape[0], img.device), out)
    if shape[1] != w:
        out = mm(out, _resize_weights_on(w, shape[1], img.device).T)
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
    # (K, 8) int32 holding the bits of uint32 words: bit b of
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


def keyframe_features(depth_raw: torch.Tensor, rgb: torch.Tensor, orb: dict, cam):
    """The whole feature stage of a keyframe: (uv (K, 2), signs (K, 256)
    int8, camera-frame points (K, 3), ok (K,)), `orb` the configuration's
    `orb` group."""
    intensity = (0.299 * rgb[..., 0].float() + 0.587 * rgb[..., 1].float()
                 + 0.114 * rgb[..., 2].float()) / 255.0
    kp, pyr = detect_pyramid(intensity, n_features=orb["n_features"],
                             n_levels=orb["n_levels"], scale_factor=orb["scale_factor"],
                             threshold=orb["fast_threshold"],
                             min_threshold=orb["fast_min_threshold"])
    desc = describe(kp, pyr, orb["scale_factor"])
    pts, ok = keypoint_depth(kp, depth_raw.to(torch.float32) / cam.depth_scale, cam)
    return kp.uv, desc.signs, pts, ok & kp.valid
