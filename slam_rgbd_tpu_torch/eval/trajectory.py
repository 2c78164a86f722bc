"""Trajectory export + accuracy metrics (TUM format, ATE, RPE), in numpy.

Counterpart of `slam_rgbd_tpu/eval/trajectory.py` with the quaternion
helpers of `slam_rgbd_tpu/io/tum.py`. It is a copy rather than an import
because those modules pull in jax (`io/tum.py` imports `core/se3`), and the
port runs where jax is not installed. TUM format is
`timestamp tx ty tz qx qy qz qw`, camera-to-world, one pose per line.
"""

from __future__ import annotations

import numpy as np


def quat_to_matrix(qx, qy, qz, qw) -> np.ndarray:
    q = np.array([qx, qy, qz, qw], dtype=np.float64)
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def matrix_to_quat(R: np.ndarray):
    """Rotation matrix -> (qx, qy, qz, qw), w >= 0."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q
    if w < 0:
        x, y, z, w = -x, -y, -z, -w
    return x, y, z, w


def save_trajectory_tum(path: str, timestamps, poses) -> None:
    """Write camera-to-world poses in TUM format."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, T in zip(timestamps, poses):
            t = T[:3, 3]
            qx, qy, qz, qw = matrix_to_quat(np.asarray(T[:3, :3], dtype=np.float64))
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n"
            )


def load_trajectory_tum(path: str):
    """Read a TUM trajectory -> (timestamps (n,), poses (n, 4, 4))."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = vals[1:4]
            T[:3, :3] = quat_to_matrix(*vals[4:8])
            ts.append(vals[0])
            poses.append(T)
    return np.asarray(ts), np.stack(poses)


def horn_align(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares SE(3) T with T @ src ~= dst for (n, 3) point sets."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    W = (dst - mu_d).T @ (src - mu_s)
    U, _, Vt = np.linalg.svd(W.astype(np.float64))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_d - R @ mu_s
    return T


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True):
    """Absolute trajectory error RMSE (metres) after optional SE(3) alignment.

    Returns (rmse, aligned_est_translations, gt_translations).
    """
    p_est = np.asarray(est_poses)[:, :3, 3]
    p_gt = np.asarray(gt_poses)[:, :3, 3]
    if align:
        T = horn_align(p_est, p_gt)
        p_est = p_est @ T[:3, :3].T + T[:3, 3]
    err = p_est - p_gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1)))), p_est, p_gt


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over frame gap `delta` -> (trans_rmse_m, rot_rmse_rad)."""
    est = np.asarray(est_poses, dtype=np.float64)
    gt = np.asarray(gt_poses, dtype=np.float64)
    terrs, rerrs = [], []
    for i in range(len(est) - delta):
        e = np.linalg.inv(np.linalg.inv(gt[i]) @ gt[i + delta]) @ (
            np.linalg.inv(est[i]) @ est[i + delta]
        )
        terrs.append(np.linalg.norm(e[:3, 3]))
        rerrs.append(np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)))
    return (float(np.sqrt(np.mean(np.square(terrs)))),
            float(np.sqrt(np.mean(np.square(rerrs)))))
