"""Dense projective ICP odometry (point-to-plane + photometric) in torch.

Counterpart of `slam_rgbd_tpu/odometry/icp.py`. Every GN iteration at every
level is one call of `ops.gn_reduce.gn_reduce`: the hand-written kernel on a
CUDA tensor, its plain torch version on a CPU tensor. The dominant-flow
shift, the damped 6x6 solve and the pose products are plain torch, as they
are plain XLA in the reference.

The dominant-flow (mu) schedule is the reference's on its kernel path
(`icp.py:316-373`): at the coarsest level mu is re-estimated every GN
iteration, at the finer levels once per level. A level the reference would
not send through its kernel (radius > 8 or min(h, w) < 32,
`_pallas_level`) re-estimates mu every iteration too, as the reference's
stencil path does.

`icp_align_batched` / `track_frame_batched` are the same solve for B
independent problems with a leading B on every pose and pyramid leaf: one
`ops.gn_reduce.gn_reduce_batched` call per GN iteration for all B, one
batched 6x6 factorization, and per-problem flow shifts, start selection and
motion clamp. B sequences so queue about as many device operations as one.

Nothing here copies to the host, so tracking a frame queues its work on
the device and returns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_rgbd_tpu_torch.core.config import CameraIntrinsics, ICPConfig
from slam_rgbd_tpu_torch.core import se3
from slam_rgbd_tpu_torch.core.camera import pixel_grid
from slam_rgbd_tpu_torch.ops import gn_reduce as gn_ops


class ICPResult(NamedTuple):
    """Pose + diagnostics from one ICP solve (all device scalars)."""

    T: torch.Tensor  # (4, 4) source camera -> target camera
    inliers: torch.Tensor  # () int32, associated pixels at the finest level
    rmse: torch.Tensor  # () float32, robust residual RMSE at the finest level
    valid_fraction: torch.Tensor  # () float32, inliers / valid source pixels


def flow_shift(up: torch.Tensor, vp: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Dominant flow: the rounded masked mean of the projective flow.

    Returns (2,) float32 (mu_u, mu_v), integer valued, rounded half to even
    as `jnp.round` is; (B, 2) for (B, h, w) projections.
    """
    u, v = pixel_grid(h, w, up.device)
    mm = ((up > 0) & (up < w - 1) & (vp > 0) & (vp < h - 1)).to(up.dtype)
    msum = torch.clamp_min(torch.sum(mm, dim=(-2, -1)), 1.0)
    return torch.round(torch.stack([
        torch.sum((up - u) * mm, dim=(-2, -1)),
        torch.sum((vp - v) * mm, dim=(-2, -1)),
    ], dim=-1) / msum[..., None])


def _project_level(T: torch.Tensor, src_verts: torch.Tensor, cam: CameraIntrinsics):
    """Transform + pinhole-project source vertices (h, w, 3) under pose T
    (4, 4), or (B, h, w, 3) vertices under (B, 4, 4) poses."""
    if T.dim() == 3:
        y = src_verts @ T[:, None, :3, :3].transpose(-1, -2) + T[:, None, None, :3, 3]
    else:
        y = se3.transform_points(T, src_verts)
    z_safe = torch.clamp_min(y[..., 2], 1e-6)
    up = cam.fx * y[..., 0] / z_safe + cam.cx
    vp = cam.fy * y[..., 1] / z_safe + cam.cy
    return y, up, vp, z_safe


def level_planes(level: dict) -> torch.Tensor:
    """(10, H, W) channel-first planes of a pyramid level: vertices (3),
    normals (3), valid, intensity, gradient (2). The first 8 are the
    kernel's source planes, all 10 its target planes. A level with a leading
    B gives (B, 10, H, W)."""
    valid = level["valid"]
    zeros = torch.zeros(valid.shape, dtype=torch.float32, device=valid.device)
    inten = level.get("intensity", zeros)
    grad = level.get("grad")
    grad = torch.stack([zeros, zeros], -1) if grad is None else grad
    return torch.cat([
        level["vertices"].movedim(-1, -3),
        level["normals"].movedim(-1, -3),
        valid.to(torch.float32).unsqueeze(-3),
        inten.unsqueeze(-3),
        grad.movedim(-1, -3),
    ], dim=-3).contiguous()


def _apply_update(T, H, g, inliers, cfg: ICPConfig) -> torch.Tensor:
    """Damped 6x6 GN solve and left-multiplicative pose update.

    A failed factorization, a non-finite step or too few inliers gives the
    identity step, decided on the device; with a leading B, per problem.
    """
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    Hd = H + torch.diag_embed(cfg.damping * torch.clamp_min(diag, 1.0))
    L, info = torch.linalg.cholesky_ex(Hd)
    delta = torch.cholesky_solve(-g[..., None], L)[..., 0]
    ok = torch.isfinite(delta).all(dim=-1) & (info == 0) & (inliers > 6)
    delta = torch.where(ok[..., None], delta, 0.0)
    return se3.normalize_rotation(se3.exp(delta) @ T)


def _per_level_mu(radius: int, h: int, w: int) -> bool:
    """May mu stay fixed over this level's iterations? The reference's
    `_pallas_level` condition on its kernel path."""
    return radius <= 8 and min(h, w) >= 32


def icp_align(
    src_pyr: tuple,
    tgt_pyr: tuple,
    T_init: torch.Tensor,
    cam: CameraIntrinsics,
    cfg: ICPConfig,
) -> ICPResult:
    """Coarse-to-fine point-to-plane + photometric alignment.

    `src_pyr` / `tgt_pyr` are `build_frame_pyramid` outputs (finest level
    first). Returns T mapping source-camera coordinates into target-camera
    coordinates.
    """
    levels = len(src_pyr)
    dev = T_init.device

    def run_level(T, inliers, sq_sum, k, src_p, tgt_p):
        level_cam = cam.scaled(2.0 ** k)
        n_iters, radius = _level_schedule(cfg, levels, k)
        h, w = tgt_pyr[k]["valid"].shape
        verts = src_pyr[k]["vertices"]
        per_iter_mu = k == levels - 1 or not _per_level_mu(radius, h, w)
        if not per_iter_mu:
            _, up, vp, _ = _project_level(T, verts, level_cam)
            mu = flow_shift(up, vp, h, w)
        for _ in range(n_iters):
            if per_iter_mu:
                _, up, vp, _ = _project_level(T, verts, level_cam)
                mu = flow_shift(up, vp, h, w)
            H, g, inliers, sq_sum = gn_ops.gn_reduce(
                T, mu, src_p, tgt_p, level_cam, cfg, radius
            )
            T = _apply_update(T, H, g, inliers, cfg)
        return T, inliers, sq_sum

    planes = [
        (level_planes(s)[: gn_ops.SRC_CHANNELS], level_planes(t))
        for s, t in zip(src_pyr, tgt_pyr)
    ]
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)

    # Coarsest level from up to three starts (motion prior, identity,
    # reversed prior); the one with most inliers seeds the finer levels.
    k0 = levels - 1
    n_hyp = min(max(cfg.hypotheses, 1), 3)
    cands = [
        T_init,
        torch.eye(4, dtype=T_init.dtype, device=dev),
        se3.normalize_rotation(se3.inverse(T_init)),
    ][:n_hyp]
    outs = [run_level(c, zero_i, zero_f, k0, *planes[k0]) for c in cands]
    if n_hyp > 1:
        inl = torch.stack([o[1] for o in outs])
        best = torch.argmax(inl)  # first maximum, as jnp.argmax
        T = torch.stack([o[0] for o in outs])[best]
        inliers = inl[best]
        sq_sum = torch.stack([o[2] for o in outs])[best]
    else:
        T, inliers, sq_sum = outs[0]
    for k in range(levels - 2, -1, -1):
        T, inliers, sq_sum = run_level(T, inliers, sq_sum, k, *planes[k])

    valid_src = torch.sum(src_pyr[0]["valid"])
    return ICPResult(
        T=T,
        inliers=inliers,
        rmse=torch.sqrt(sq_sum / torch.clamp_min(inliers, 1)),
        valid_fraction=inliers / torch.clamp_min(valid_src, 1),
    )


def _level_schedule(cfg: ICPConfig, levels: int, k: int):
    """(GN iterations, window radius) of pyramid level k; the config's
    tuples run coarse to fine."""
    ci = min(levels - 1 - k, len(cfg.iters) - 1)  # 0 = coarsest
    return cfg.iters[ci], cfg.window_px[min(ci, len(cfg.window_px) - 1)]


def icp_align_batched(
    src_pyr: tuple,
    tgt_pyr: tuple,
    T_init: torch.Tensor,  # (B, 4, 4)
    cam: CameraIntrinsics,
    cfg: ICPConfig,
) -> ICPResult:
    """`icp_align` for B independent problems: every pyramid leaf and every
    result leads with B. Each GN iteration is one `gn_reduce_batched` call
    and one batched 6x6 solve; the flow shift, the choice among the coarse
    starts (most inliers, the first among equals) and the identity step on a
    degenerate system are taken per problem, on the device.
    """
    levels = len(src_pyr)
    dev = T_init.device
    n_b = T_init.shape[0]

    def run_level(T, inliers, sq_sum, k, src_p, tgt_p):
        level_cam = cam.scaled(2.0 ** k)
        n_iters, radius = _level_schedule(cfg, levels, k)
        h, w = tgt_pyr[k]["valid"].shape[-2:]
        verts = src_pyr[k]["vertices"]
        per_iter_mu = k == levels - 1 or not _per_level_mu(radius, h, w)
        if not per_iter_mu:
            _, up, vp, _ = _project_level(T, verts, level_cam)
            mu = flow_shift(up, vp, h, w)
        for _ in range(n_iters):
            if per_iter_mu:
                _, up, vp, _ = _project_level(T, verts, level_cam)
                mu = flow_shift(up, vp, h, w)
            H, g, inliers, sq_sum = gn_ops.gn_reduce_batched(
                T, mu, src_p, tgt_p, level_cam, cfg, radius
            )
            T = _apply_update(T, H, g, inliers, cfg)
        return T, inliers, sq_sum

    planes = [
        (level_planes(s)[:, : gn_ops.SRC_CHANNELS].contiguous(), level_planes(t))
        for s, t in zip(src_pyr, tgt_pyr)
    ]
    zero_i = torch.zeros((n_b,), dtype=torch.int32, device=dev)
    zero_f = torch.zeros((n_b,), dtype=torch.float32, device=dev)

    k0 = levels - 1
    n_hyp = min(max(cfg.hypotheses, 1), 3)
    cands = [
        T_init,
        torch.eye(4, dtype=T_init.dtype, device=dev).expand(n_b, 4, 4).contiguous(),
        se3.normalize_rotation(se3.inverse(T_init)),
    ][:n_hyp]
    outs = [run_level(c, zero_i, zero_f, k0, *planes[k0]) for c in cands]
    if n_hyp > 1:
        inl = torch.stack([o[1] for o in outs])  # (n_hyp, B)
        order = torch.arange(n_hyp, device=dev)[:, None]
        # per problem the first start with the most inliers, as jnp.argmax
        best = torch.where(inl == inl.amax(dim=0), order, n_hyp).amin(dim=0)
        col = torch.arange(n_b, device=dev)
        T = torch.stack([o[0] for o in outs])[best, col]
        inliers = inl[best, col]
        sq_sum = torch.stack([o[2] for o in outs])[best, col]
    else:
        T, inliers, sq_sum = outs[0]
    for k in range(levels - 2, -1, -1):
        T, inliers, sq_sum = run_level(T, inliers, sq_sum, k, *planes[k])

    valid_src = torch.sum(src_pyr[0]["valid"], dim=(-2, -1))
    return ICPResult(
        T=T,
        inliers=inliers,
        rmse=torch.sqrt(sq_sum / torch.clamp_min(inliers, 1)),
        valid_fraction=inliers / torch.clamp_min(valid_src, 1),
    )


def track_frame_batched(
    prev_pyr: tuple,
    curr_pyr: tuple,
    T_world_prev: torch.Tensor,  # (B, 4, 4)
    T_motion_prior: torch.Tensor,  # (B, 4, 4)
    cam: CameraIntrinsics,
    cfg: ICPConfig,
):
    """`track_frame` for B sequences at once: the same motion clamp and
    constant-velocity composition, applied per sequence."""
    res = icp_align_batched(curr_pyr, prev_pyr, T_motion_prior, cam, cfg)
    dt = torch.linalg.norm(res.T[:, :3, 3], dim=-1)
    ok_step = (dt <= cfg.max_step_m) & torch.isfinite(res.T).all(dim=(-2, -1))
    eye = torch.eye(4, dtype=res.T.dtype, device=res.T.device)
    T_rel = torch.where(ok_step[:, None, None], res.T, eye)
    if cfg.drift_xi:  # fault injection (see ICPConfig.drift_xi)
        xi = torch.tensor(cfg.drift_xi, dtype=torch.float32).to(res.T.device)
        T_rel = se3.normalize_rotation(T_rel @ se3.exp(xi))
    res = res._replace(
        T=T_rel, valid_fraction=torch.where(ok_step, res.valid_fraction, 0.0)
    )
    return se3.normalize_rotation(T_world_prev @ T_rel), T_rel, res


def track_frame(
    prev_pyr: tuple,
    curr_pyr: tuple,
    T_world_prev: torch.Tensor,
    T_motion_prior: torch.Tensor,
    cam: CameraIntrinsics,
    cfg: ICPConfig,
):
    """One odometry step: align the current frame against the previous one.

    The previous frame-to-frame motion seeds the solve. Returns
    (T_world_curr, T_motion, ICPResult), with T_world_curr =
    T_world_prev @ T_prev_curr. A step longer than `cfg.max_step_m` or not
    finite is rejected: the pose holds and the frame's quality is zeroed.
    """
    res = icp_align(curr_pyr, prev_pyr, T_motion_prior, cam, cfg)
    dt = torch.linalg.norm(res.T[:3, 3])
    ok_step = (dt <= cfg.max_step_m) & torch.isfinite(res.T).all()
    eye = torch.eye(4, dtype=res.T.dtype, device=res.T.device)
    T_rel = torch.where(ok_step, res.T, eye)
    if cfg.drift_xi:  # fault injection (see ICPConfig.drift_xi)
        xi = torch.tensor(cfg.drift_xi, dtype=torch.float32).to(res.T.device)
        T_rel = se3.normalize_rotation(T_rel @ se3.exp(xi))
    res = res._replace(
        T=T_rel, valid_fraction=torch.where(ok_step, res.valid_fraction, 0.0)
    )
    return se3.normalize_rotation(T_world_prev @ T_rel), T_rel, res
