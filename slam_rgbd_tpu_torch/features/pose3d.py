"""Robust SE(3) from matched 3D-3D correspondences (hypothesize + IRLS).

Counterpart of `slam_rgbd_tpu/features/pose3d.py`, used for feature-based
relocalization. A fixed batch of minimal (3-point) hypotheses is fitted with
batched closed-form Kabsch, every hypothesis is scored against all
correspondences at once (one (H, N) distance evaluation), and the best is
polished with fixed-count Huber IRLS.

The reference draws its triples from `jax.random`; the port draws them from
a `torch.Generator` (fixed seed by default), which gives other triples, so
the two agree on the result for scenes with a clear consensus and not on
the hypotheses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pose3DResult(NamedTuple):
    T: torch.Tensor  # (4, 4): maps frame-1 points onto frame-2 points
    inliers: torch.Tensor  # () int32 under `inlier_thresh`
    rmse: torch.Tensor  # () float32 over inliers
    ok: torch.Tensor  # () bool: enough inliers and finite solution
    n_valid: torch.Tensor  # () int32 candidate correspondences


def _weighted_kabsch(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Closed-form weighted rigid alignment T with T @ p ~= q.

    p, q: (..., N, 3); w: (..., N) nonnegative weights -> (..., 4, 4).
    """
    wsum = torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    mu_p = (p * w[..., None]).sum(dim=-2) / wsum
    mu_q = (q * w[..., None]).sum(dim=-2) / wsum
    pc = p - mu_p[..., None, :]
    qc = q - mu_q[..., None, :]
    C = (qc * w[..., None]).transpose(-1, -2) @ pc  # (..., 3, 3) cross-covariance
    U, _, Vt = torch.linalg.svd(C)
    det = torch.linalg.det(U @ Vt)
    S = torch.ones(det.shape + (3,), dtype=p.dtype, device=p.device)
    S[..., 2] = torch.sign(det)
    R = (U * S[..., None, :]) @ Vt
    t = mu_q - (R @ mu_p[..., None])[..., 0]
    T = torch.eye(4, dtype=p.dtype, device=p.device).repeat(det.shape + (1, 1))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def _residuals(T: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(pts1 @ T[:3, :3].T + T[:3, 3] - pts2, dim=-1)


def sample_triples(valid: torch.Tensor, n_hypotheses: int,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """(H, 3) distinct valid indices a hypothesis, by Gumbel top-k: a
    fixed-shape draw without replacement. The noise is drawn on the CPU, so
    a generator state gives the same triples on every device; without one
    the draw is that of a generator seeded 0."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    n = valid.shape[0]
    u = torch.rand((n_hypotheses, n), generator=generator).clamp_(1e-20, 1.0)
    gumbel = -torch.log((-torch.log(u)).clamp_min(1e-20)).to(valid.device)
    g = gumbel + torch.where(valid, 0.0, -1e9)[None, :]
    # stable: the lower index first among equal values
    return torch.sort(g, dim=1, descending=True, stable=True).indices[:, :3]


def polish(pts1, pts2, valid, w0, T0, huber: float = 0.05,
           inlier_thresh: float = 0.10, min_inliers: int = 12,
           iters: int = 6) -> Pose3DResult:
    """Huber IRLS from weights `w0` (and T0 when `iters` is 0), then the
    inlier count, rmse and acceptance of the result."""
    valid_f = valid.to(torch.float32)
    w, T = w0, T0
    for _ in range(iters):
        T = _weighted_kabsch(pts1, pts2, w)
        r = _residuals(T, pts1, pts2)
        w = torch.where(r <= huber, 1.0, huber / torch.clamp_min(r, 1e-12)) * valid_f
    r = _residuals(T, pts1, pts2)
    inl = valid & (r < inlier_thresh)
    n_inl = inl.sum()
    rmse = torch.sqrt(torch.where(inl, r * r, 0.0).sum() / torch.clamp_min(n_inl, 1))
    ok = (n_inl >= min_inliers) & torch.isfinite(T).all()
    return Pose3DResult(T=T, inliers=n_inl.to(torch.int32), rmse=rmse, ok=ok,
                        n_valid=valid.sum().to(torch.int32))


def solve_pose3d(pts1: torch.Tensor, pts2: torch.Tensor, valid: torch.Tensor,
                 huber: float = 0.05, inlier_thresh: float = 0.10,
                 min_inliers: int = 12, iters: int = 6, n_hypotheses: int = 64,
                 generator: torch.Generator | None = None) -> Pose3DResult:
    """Robust rigid alignment: returns T with T @ pts1 ~= pts2.

    pts1, pts2 (N, 3), valid (N,) bool. Batched minimal-hypothesis search
    followed by a Huber IRLS polish seeded from the best hypothesis' inlier
    set. Fixed shapes; deterministic for a given generator state.
    """
    idx = sample_triples(valid, n_hypotheses, generator)
    tri1 = pts1[idx]  # (H, 3, 3)
    tri2 = pts2[idx]
    ones3 = torch.ones((n_hypotheses, 3), dtype=pts1.dtype, device=pts1.device)
    T_h = _weighted_kabsch(tri1, tri2, ones3)

    # score every hypothesis against every correspondence
    p1h = torch.einsum("hij,nj->hni", T_h[:, :3, :3], pts1) + T_h[:, None, :3, 3]
    r_h = torch.linalg.norm(p1h - pts2[None], dim=-1)  # (H, N)
    inl_h = (r_h < inlier_thresh) & valid[None, :]
    score = inl_h.sum(dim=1)
    # non-finite hypotheses (degenerate triples) score 0
    finite = torch.isfinite(T_h.reshape(n_hypotheses, -1)).all(dim=1)
    score = torch.where(finite, score, 0)
    # first index of the best score
    best = torch.where(score >= score.max(),
                       torch.arange(n_hypotheses, device=score.device),
                       n_hypotheses).min().reshape(1)
    T0 = T_h.index_select(0, best)[0]
    w0 = inl_h.index_select(0, best)[0].to(torch.float32)
    # fall back to all-valid seeding if the hypothesis search found nothing
    w0 = torch.where(score.index_select(0, best)[0] >= 3, w0,
                     valid.to(torch.float32))
    return polish(pts1, pts2, valid, w0, T0, huber, inlier_thresh,
                  min_inliers, iters)
