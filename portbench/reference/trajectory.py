"""Absolute trajectory error: each recording's estimated positions aligned
to its ground truth by the least-squares rigid motion (Horn's method, by
SVD), then the RMS of the position errors. numpy, float64."""

from __future__ import annotations

import numpy as np


def horn_align(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The rigid T (4, 4) with T @ src ~= dst for (n, 3) point sets."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    U, _, Vt = np.linalg.svd((dst - mu_d).T @ (src - mu_s))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_d - R @ mu_s
    return T


def aligned_errors(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(n,) position errors in metres of (n, 4, 4) estimates against
    (n, 4, 4) ground truth, after Horn's alignment."""
    p_est = np.asarray(est, np.float64)[:, :3, 3]
    p_gt = np.asarray(gt, np.float64)[:, :3, 3]
    T = horn_align(p_est, p_gt)
    return np.linalg.norm(p_est @ T[:3, :3].T + T[:3, 3] - p_gt, axis=1)


def ate_rms(recordings) -> float:
    """RMS over every frame of several recordings, each aligned on its own:
    `recordings` is a list of (est, gt) pose arrays."""
    sq = np.concatenate([aligned_errors(e, g) ** 2 for e, g in recordings])
    return float(np.sqrt(sq.mean()))
