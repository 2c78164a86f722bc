"""SE(3) in plain torch, float32: poses are 4x4 [[R, t], [0, 1]], twists
(v, w) with the translation first. Frozen copy of the port's conventions;
every matrix product goes through `precision.mm`."""

from __future__ import annotations

import torch

from portbench.reference.precision import mm


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) vectors -> (..., 3, 3) skew-symmetric matrices."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(w.shape[:-1] + (3, 3))


def _sinc_terms(theta_sq: torch.Tensor):
    """(sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3), Taylor-safe."""
    ts = torch.clamp_min(theta_sq, 1e-8)
    theta = torch.sqrt(ts)
    small = theta_sq < 1e-8
    sin_t = torch.sin(theta)
    a = torch.where(small, 1.0 - theta_sq / 6.0, sin_t / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / ts)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (theta - sin_t) / (ts * theta))
    return a, b, c


def _assemble(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bottom = _eye(4, R)[3:].expand(R.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([R, t], dim=-1), bottom], dim=-2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (v, w) -> [[exp(w), J_l(w) v], [0, 1]]."""
    v, w = xi[..., :3], xi[..., 3:]
    a, b, c = _sinc_terms((w * w).sum(dim=-1))
    W = hat(w)
    WW = mm(W, W)
    eye3 = _eye(3, xi)
    R = eye3 + a[..., None, None] * W + b[..., None, None] * WW
    t = mm(eye3 + b[..., None, None] * W + c[..., None, None] * WW, v[..., None])
    return _assemble(R, t)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _assemble(Rt, -mm(Rt, T[..., :3, 3:]))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """One T (4, 4) applied to (..., 3) points."""
    return mm(pts, T[:3, :3].T) + T[:3, 3]


def normalize_rotation(T: torch.Tensor) -> torch.Tensor:
    """R <- R (3I - R^T R) / 2, twice."""
    R = T[..., :3, :3]
    eye3 = _eye(3, T)
    for _ in range(2):
        R = mm(R, 1.5 * eye3 - 0.5 * mm(R.transpose(-1, -2), R))
    out = T.clone()
    out[..., :3, :3] = R
    return out
