"""SE(3) Lie-group operations in torch, float32.

Counterpart of `slam_rgbd_tpu/core/se3.py`, with the same conventions:

  * Poses are 4x4 homogeneous matrices T = [[R, t], [0, 1]].
  * Twists are 6-vectors xi = (v, w): translation first, rotation last.
  * `exp` / `log` use closed-form Rodrigues with Taylor branches near 0.

Every function takes one element or any number of leading batch dimensions
(`exp` of (B, 6) twists gives (B, 4, 4) poses) and follows its input's
device. No function copies data to or from the host, so a pose update never
waits on the device.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _sq_norm(w: torch.Tensor) -> torch.Tensor:
    return (w * w).sum(dim=-1)


def _scale(s: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """(...) scalars times (..., n, m) matrices."""
    return s[..., None, None] * M


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) vectors -> (..., 3, 3) skew-symmetric matrices."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [o, -z, y, z, o, -x, -y, x, o], dim=-1
    ).reshape(w.shape[:-1] + (3, 3))


def vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew-symmetric matrices -> (..., 3) vectors."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_terms(theta_sq: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor-safe."""
    ts = torch.clamp_min(theta_sq, _EPS)
    theta = torch.sqrt(ts)
    small = theta_sq < 1e-8
    sin_t = torch.sin(theta)
    a = torch.where(small, 1.0 - theta_sq / 6.0, sin_t / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / ts)
    c = torch.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (theta - sin_t) / (ts * theta)
    )
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> rotation matrix (Rodrigues)."""
    a, b, _ = _sinc_terms(_sq_norm(w))
    W = hat(w)
    return _eye(3, w) + _scale(a, W) + _scale(b, W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector, with the theta ~ pi branch."""
    Rt = R.transpose(-1, -2)
    trace = torch.clamp(R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], -1.0, 3.0)
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)[..., None]
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    v = vee(R - Rt)
    w_generic = v * torch.where(
        torch.abs(sin_theta) < 1e-6,
        0.5,
        theta / (2.0 * torch.clamp_min(sin_theta, 1e-20)),
    )
    w_small = v * 0.5 * (1.0 + theta * theta / 6.0)

    # near pi: |w_i| from the diagonal, signs from the symmetric part
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    w_sq = torch.clamp_min(
        (diag - cos_theta) / torch.clamp_min(1.0 - cos_theta, 1e-12), 0.0
    )
    w_abs = theta * torch.sqrt(w_sq)
    S = 0.5 * (R + Rt)
    one = torch.ones_like(trace)
    s01, s02, s12 = (torch.sign(S[..., 0, 1]), torch.sign(S[..., 0, 2]),
                     torch.sign(S[..., 1, 2]))
    signs_all = torch.stack([
        torch.stack([one, s01, s02], dim=-1),
        torch.stack([s01, one, s12], dim=-1),
        torch.stack([s02, s12, one], dim=-1),
    ], dim=-2)
    # the row of the largest |w_i| (the first one among equals)
    k = torch.argmax(w_abs, dim=-1)[..., None, None].expand(w_abs.shape[:-1] + (1, 3))
    signs = torch.gather(signs_all, -2, k)[..., 0, :]
    signs = torch.where(signs == 0.0, 1.0, signs)
    w_pi = w_abs * signs

    return torch.where(
        theta < 1e-4, w_small, torch.where(theta > 3.0, w_pi, w_generic)
    )


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(w)."""
    _, b, c = _sinc_terms(_sq_norm(w))
    W = hat(w)
    return _eye(3, w) + _scale(b, W) + _scale(c, W @ W)


def left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse SO(3) left Jacobian (used by `log`)."""
    theta_sq = _sq_norm(w)
    theta = torch.sqrt(torch.clamp_min(theta_sq, _EPS))
    W = hat(w)
    half = 0.5 * theta
    cot_term = torch.where(
        theta_sq < 1e-8,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp_min(torch.sin(half), 1e-20))
        / torch.clamp_min(theta_sq, _EPS),
    )
    return _eye(3, w) - 0.5 * W + _scale(cot_term, W @ W)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (v, w) -> 4x4 transform [[exp(w), J_l(w) v], [0, 1]]."""
    v, w = xi[..., :3], xi[..., 3:]
    a, b, c = _sinc_terms(_sq_norm(w))
    W = hat(w)
    WW = W @ W
    eye3 = _eye(3, xi)
    R = eye3 + _scale(a, W) + _scale(b, WW)
    t = (eye3 + _scale(b, W) + _scale(c, WW)) @ v[..., None]
    return _assemble(R, t)


def _assemble(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations and (..., 3, 1) translations -> (..., 4, 4)."""
    bottom = _eye(4, R)[3:].expand(R.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([R, t], dim=-1), bottom], dim=-2)


def log(T: torch.Tensor) -> torch.Tensor:
    """4x4 transform -> twist (v, w)."""
    w = so3_log(T[..., :3, :3])
    v = (left_jacobian_inv(w) @ T[..., :3, 3:])[..., 0]
    return torch.cat([v, w], dim=-1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _assemble(Rt, -(Rt @ T[..., :3, 3:]))


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """6x6 adjoint of T for twist transport: Ad_T xi^ = T xi^ T^-1.

    With the (v, w) ordering: Ad = [[R, hat(t) R], [0, R]].
    """
    R = T[..., :3, :3]
    top = torch.cat([R, hat(T[..., :3, 3]) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply one T (4, 4) to an (..., 3) array of points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation of T to (..., 3) vectors (normals)."""
    return vecs @ T[:3, :3].T


def normalize_rotation(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block: R <- R (3I - R^T R) / 2, twice.

    The same SVD-free projection as the reference, so both drift alike.
    """
    R = T[..., :3, :3]
    eye3 = _eye(3, T)
    for _ in range(2):
        R = R @ (1.5 * eye3 - 0.5 * (R.transpose(-1, -2) @ R))
    out = T.clone()
    out[..., :3, :3] = R
    return out
