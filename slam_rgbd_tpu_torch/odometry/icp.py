"""Dense projective ICP odometry (point-to-plane + photometric) in torch.

Counterpart of `slam_rgbd_tpu/odometry/icp.py`. Every GN iteration at every
level is one call of `ops.gn_reduce.gn_step` / `gn_step_batched`: on a CUDA
tensor one launch of the hand-written kernel, which reduces the normal
equations and goes on to the damped 6x6 solve and the pose update; on a CPU
tensor the plain reduction followed by `_apply_update`. The up to three
starts of the coarsest level are problems of one batched call over shared
planes, so the default schedule (iters (10, 7, 5), 3 starts) is 10 + 7 + 5
= 22 calls a frame. The dominant-flow shift is plain torch, as it is plain
XLA in the reference.

The dominant-flow (mu) schedule is the reference's on its kernel path
(`icp.py:316-373`): at the coarsest level mu is re-estimated every GN
iteration, at the finer levels once per level. A level the reference would
not send through its kernel (radius > 8 or min(h, w) < 32,
`_pallas_level`) re-estimates mu every iteration too, as the reference's
stencil path does.

`icp_align_batched` / `track_frame_batched` are the same solve for B
independent problems with a leading B on every pose and pyramid leaf: one
`gn_step_batched` call per GN iteration for all B (at the coarsest level for
all 3 x B starts, the three of a sequence sharing its planes), and
per-problem flow shifts, start selection and motion clamp. B sequences so
queue about as many device operations as one.

Nothing here copies to the host, so tracking a frame queues its work on
the device and returns.
"""

from __future__ import annotations

import functools
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
    """Damped 6x6 GN solve and left-multiplicative pose update: the plain
    version of what the kernel does at the end of a `gn_step` launch.

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


def _kernel_planes(src_level: dict, tgt_level: dict):
    """(src, tgt) of one pyramid level as `ops.gn_reduce` takes them: the
    source's first 8 planes and the target's 10."""
    src_p = level_planes(src_level)[..., : gn_ops.SRC_CHANNELS, :, :].contiguous()
    return src_p, level_planes(tgt_level)


def _run_level(T, inliers, sq_sum, k: int, levels: int, verts, src_p, tgt_p,
               cam: CameraIntrinsics, cfg: ICPConfig):
    """All GN iterations of pyramid level k from pose(s) T -> (T, inliers,
    sq_sum) of the last one (the ones passed in where the level has no
    iteration). T (4, 4) is one problem; T (P, 4, 4) are P problems over the
    G plane sets that `src_p` / `tgt_p` lead with (see
    `ops.gn_reduce`), and `verts` then holds each problem's source vertices,
    (P, h, w, 3)."""
    level_cam = cam.scaled(2.0 ** k)
    n_iters, radius = _level_schedule(cfg, levels, k)
    h, w = tgt_p.shape[-2:]
    step = gn_ops.gn_step_batched if T.dim() == 3 else gn_ops.gn_step
    per_iter_mu = k == levels - 1 or not _per_level_mu(radius, h, w)
    if not per_iter_mu:
        _, up, vp, _ = _project_level(T, verts, level_cam)
        mu = flow_shift(up, vp, h, w)
    if n_iters == 0 and inliers is None:
        inliers = torch.zeros(T.shape[:-2], dtype=torch.int32, device=T.device)
        sq_sum = torch.zeros(T.shape[:-2], dtype=torch.float32, device=T.device)
    for _ in range(n_iters):
        if per_iter_mu:
            _, up, vp, _ = _project_level(T, verts, level_cam)
            mu = flow_shift(up, vp, h, w)
        T, _, _, inliers, sq_sum = step(T, mu, src_p, tgt_p, level_cam, cfg, radius)
    return T, inliers, sq_sum


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
    planes = [_kernel_planes(s, t) for s, t in zip(src_pyr, tgt_pyr)]

    # Coarsest level from up to three starts (motion prior, identity,
    # reversed prior), all in one batched call an iteration over the one
    # set of planes; the start with most inliers (the first among equals,
    # as jnp.argmax) seeds the finer levels.
    k0 = levels - 1
    n_hyp = min(max(cfg.hypotheses, 1), 3)
    if n_hyp > 1:
        cands = torch.stack([
            T_init,
            torch.eye(4, dtype=T_init.dtype, device=dev),
            se3.normalize_rotation(se3.inverse(T_init)),
        ][:n_hyp])
        shared = [x.expand((n_hyp,) + x.shape) for x in planes[k0]]
        Ts, inl, sq = _run_level(
            cands, None, None, k0, levels, src_pyr[k0]["vertices"], *shared, cam, cfg)
        # index_select, not indexing by a 0-dim tensor, which reads the
        # index back to the host
        best = torch.argmax(inl).reshape(1)
        T, inliers, sq_sum = (x.index_select(0, best)[0] for x in (Ts, inl, sq))
    else:
        T, inliers, sq_sum = _run_level(
            T_init, None, None, k0, levels, src_pyr[k0]["vertices"], *planes[k0],
            cam, cfg)
    for k in range(levels - 2, -1, -1):
        T, inliers, sq_sum = _run_level(
            T, inliers, sq_sum, k, levels, src_pyr[k]["vertices"], *planes[k], cam, cfg)

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
    planes = [_kernel_planes(s, t) for s, t in zip(src_pyr, tgt_pyr)]

    # The coarsest level's starts as problems b * n_hyp + s of one call: the
    # n_hyp starts of sequence b read plane set b.
    k0 = levels - 1
    n_hyp = min(max(cfg.hypotheses, 1), 3)
    cands = torch.stack([
        T_init,
        torch.eye(4, dtype=T_init.dtype, device=dev).expand(n_b, 4, 4),
        se3.normalize_rotation(se3.inverse(T_init)),
    ][:n_hyp], dim=1).reshape(n_b * n_hyp, 4, 4)
    verts = src_pyr[k0]["vertices"]
    if n_hyp > 1:
        verts = verts.repeat_interleave(n_hyp, dim=0)
    T, inliers, sq_sum = _run_level(
        cands, None, None, k0, levels, verts, *planes[k0], cam, cfg)
    if n_hyp > 1:
        inl = inliers.view(n_b, n_hyp)
        order = torch.arange(n_hyp, device=dev)
        # per problem the first start with the most inliers, as jnp.argmax
        best = torch.where(inl == inl.amax(dim=1, keepdim=True), order, n_hyp).amin(dim=1)
        pick = torch.arange(n_b, device=dev) * n_hyp + best
        T, inliers, sq_sum = T[pick], inliers[pick], sq_sum[pick]
    for k in range(levels - 2, -1, -1):
        T, inliers, sq_sum = _run_level(
            T, inliers, sq_sum, k, levels, src_pyr[k]["vertices"], *planes[k], cam, cfg)

    valid_src = torch.sum(src_pyr[0]["valid"], dim=(-2, -1))
    return ICPResult(
        T=T,
        inliers=inliers,
        rmse=torch.sqrt(sq_sum / torch.clamp_min(inliers, 1)),
        valid_fraction=inliers / torch.clamp_min(valid_src, 1),
    )


@functools.lru_cache(maxsize=None)
def _drift_twist(xi: tuple, device: torch.device) -> torch.Tensor:
    """The injected drift twist on `device`, made once: a copy from the host
    inside a captured frame would not be captured."""
    return torch.tensor(xi, dtype=torch.float32).to(device)


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
        xi = _drift_twist(cfg.drift_xi, res.T.device)
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
        xi = _drift_twist(cfg.drift_xi, res.T.device)
        T_rel = se3.normalize_rotation(T_rel @ se3.exp(xi))
    res = res._replace(
        T=T_rel, valid_fraction=torch.where(ok_step, res.valid_fraction, 0.0)
    )
    return se3.normalize_rotation(T_world_prev @ T_rel), T_rel, res
