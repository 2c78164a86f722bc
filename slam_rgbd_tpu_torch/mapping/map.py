"""Keyframe map, torch port: for now only the keyframe decision.

Counterpart of `slam_rgbd_tpu/mapping/map.py`. The map state, insertion,
association and culling come with the keyframe slice.
"""

from __future__ import annotations

import math

import torch

from slam_rgbd_tpu.core.config import KeyframeConfig
from slam_rgbd_tpu_torch.core import se3


def should_insert_keyframe(
    T_world_cam: torch.Tensor,
    T_world_last_kf: torch.Tensor,
    inlier_ratio: torch.Tensor,
    cfg: KeyframeConfig,
) -> torch.Tensor:
    """Keyframe decision: enough motion since the last keyframe, or tracking
    quality dropping. Returns a () bool tensor on the poses' device."""
    D = se3.inverse(T_world_last_kf) @ T_world_cam
    trans = torch.linalg.norm(D[:3, 3])
    cos_r = torch.clamp((D[0, 0] + D[1, 1] + D[2, 2] - 1.0) * 0.5, -1.0, 1.0)
    rot = torch.arccos(cos_r)
    return (
        (trans > cfg.kf_min_trans)
        | (rot > math.radians(cfg.kf_min_rot_deg))
        | (inlier_ratio < cfg.kf_min_inlier_ratio)
    )
