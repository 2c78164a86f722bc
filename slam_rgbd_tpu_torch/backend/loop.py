"""Loop closure: binary-descriptor place recognition + geometric verification.

Counterpart of `slam_rgbd_tpu/backend/loop.py`:

  * Place signature: a keyframe's keypoint sign-descriptors averaged into a
    256-d vector and L2-normalized; the cosine similarity of one keyframe
    with all others is one product against the (M, 256) signature matrix
    (`MapState.kf_sig`, kept up on insert).
  * Candidate gating: temporal separation (`min_interval` keyframes), not
    covisible with the query, similarity above `min_score`.
  * Verification: descriptor matching between the two keyframes through
    `features.match.match` (`ops.hamming.hamming_top2`, the hand-written
    kernel on a CUDA device) followed by the robust 3D-3D solve of
    `features.pose3d`. Depth gives metric scale, so the solve is rigid.

The query index is a host integer; a candidate index may also be a () tensor
on the map's device, the candidate search's own output, so that verification
can follow the search without a read-back. Every result is a tensor on the
map's device and nothing is read back here. The caller decides on the host
whether to commit the loop edge and run the pose graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

import math

from slam_rgbd_tpu_torch.core import se3
from slam_rgbd_tpu_torch.features import match as fmatch
from slam_rgbd_tpu_torch.features.pose3d import solve_pose3d
from slam_rgbd_tpu_torch.mapping.map import MapState


def place_signatures(m: MapState) -> torch.Tensor:
    """(M, 256) L2-normalized mean-of-signs signatures of all keyframes,
    recomputed from the descriptor store: the oracle for `MapState.kf_sig`."""
    w = m.kp_ok.to(torch.float32)[..., None]
    mean = (m.kp_signs.to(torch.float32) * w).sum(dim=1) / torch.clamp_min(
        w.sum(dim=1), 1.0)
    norm = torch.linalg.norm(mean, dim=-1, keepdim=True)
    return torch.where(norm > 1e-6, mean / torch.clamp_min(norm, 1e-6), 0.0)


class LoopCandidate(NamedTuple):
    kf_idx: torch.Tensor  # () int32 best candidate keyframe
    score: torch.Tensor  # () float32 cosine similarity
    ok: torch.Tensor  # () bool: passed the gates


def find_loop_candidate(m: MapState, query_idx: int, min_interval: int = 20,
                        min_score: float = 0.20, max_covis: int = 5) -> LoopCandidate:
    """Best loop candidate for keyframe `query_idx`, gated on the device."""
    sig = m.kf_sig
    sim = sig @ sig[query_idx]  # (M,)
    idx = torch.arange(m.capacity_kf, device=m.device)
    eligible = (
        m.kf_valid & (idx < query_idx - min_interval)
        & (m.covis[query_idx] <= max_covis)
    )
    sim = torch.where(eligible, sim, -1.0)
    top = sim.amax()
    best = torch.where(sim == top, idx, m.capacity_kf).amin()  # first maximum
    return LoopCandidate(kf_idx=best.to(torch.int32), score=top, ok=top > min_score)


class LoopVerification(NamedTuple):
    T_rel: torch.Tensor  # (4, 4): query-camera points -> candidate camera
    inliers: torch.Tensor
    n_matches: torch.Tensor
    ok: torch.Tensor


def _row(x: torch.Tensor, i) -> torch.Tensor:
    """x[i] for a host integer or a () index tensor (no read-back)."""
    if isinstance(i, torch.Tensor):
        return x.index_select(0, i.reshape(1).long())[0]
    return x[i]


def verify_loop(m: MapState, query_idx: int, cand_idx,
                max_distance: float = 64.0, min_matches: int = 25,
                generator: torch.Generator | None = None) -> LoopVerification:
    """Descriptor-match the two keyframes and solve the relative pose.

    T_rel maps query-camera coordinates into candidate-camera coordinates:
    the measurement of a pose-graph edge candidate -> query.
    """
    mt = fmatch.match(
        m.kp_signs[query_idx], m.kp_ok[query_idx],
        _row(m.kp_signs, cand_idx), _row(m.kp_ok, cand_idx),
        max_distance=max_distance, ratio=0.9,
    )
    p1 = m.kp_pts[query_idx]  # (K, 3) query-camera frame
    p2 = _row(m.kp_pts, cand_idx)[mt.idx2.long()]  # matched candidate-camera points
    res = solve_pose3d(p1, p2, mt.valid, iters=8, generator=generator)
    n_m = mt.valid.sum()
    # acceptance needs consensus, not a count: the solve must explain at
    # least half of all matches, tightly (rmse < 6 cm), which an aliased
    # match set on repeating texture does not
    consensus = res.inliers >= 0.5 * n_m.to(torch.float32)
    return LoopVerification(
        T_rel=res.T,
        inliers=res.inliers,
        n_matches=n_m,
        ok=res.ok & (n_m >= min_matches) & consensus & (res.rmse < 0.06),
    )


def edge_consistency(T_rel: torch.Tensor, Ti: torch.Tensor, Tj: torch.Tensor,
                     max_t: float, max_deg: float):
    """The consistency gate of a verified loop edge i -> j against the
    current poses: the residual log(T_rel^-1 Ti^-1 Tj) must be finite and
    within plausible accumulated drift (geometric verification can pass an
    aliased match set, and one inconsistent weight-5 edge bends the whole
    trajectory). -> (consistent () bool, t_err () m, r_err () rad)."""
    resid = se3.log(se3.inverse(T_rel) @ se3.inverse(Ti) @ Tj)
    t_err = torch.linalg.norm(resid[:3])
    r_err = torch.linalg.norm(resid[3:])
    consistent = (
        torch.isfinite(resid).all() & (t_err <= max_t) & (r_err <= math.radians(max_deg))
    )
    return consistent, t_err, r_err
