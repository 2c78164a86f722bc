"""Sliding-window local bundle adjustment: Schur complement, dense, in torch.

Counterpart of `slam_rgbd_tpu/backend/ba.py` (without its `psum_axis`
argument, which belongs to the multi-device layer).

Formulation (standard local BA):
  * Variables: window keyframe poses T_w (W, 4, 4) and map-point positions
    X (P, 3). Cameras outside `free_mask`, and a gauge anchor, keep their
    poses but still constrain the points.
  * Residuals: 3-D per observation over the (W, K) grid from
    `MapState.point_id`: pixel reprojection (u, v) plus the measured depth,
    r_z = (z_pred - z_obs) * fx / z_obs, masked, fixed shape.
  * Normal equations in block form:
        [ Hcc  Hcp ] [ dc ]   [ -gc ]
        [ Hcp' Hpp ] [ dp ] = [ -gp ]
    with Hpp block-diagonal (3x3 a point). The reduced camera system
        S = Hcc - Hcp Hpp^-1 Hcp',   b = -gc + Hcp Hpp^-1 gp
    is (6W, 6W); dp back-substitutes per point.
  * Levenberg-Marquardt with Tukey weights, damping relative to each block's
    scale, a Jacobi-scaled dense solve, and accept / reject on the robust
    cost (lambda x0.3 on accept, x8 on reject).

Per-point blocks are summed into a table with one dump row for masked
observations by `index_put_(accumulate=True)`, which on a CUDA device sorts
the indices and adds each row's terms in a fixed order. (`index_add_` there
is float atomics: the order of the sum, the last bits of a result and now
and then an LM accept `cost_new < cost` changed from run to run, and two
sequences fed the same frames drifted centimetres apart.) Nothing is read
back to the host: accept / reject, the gauge and every gate are `where`s on
the device.

Pose twists use the left-multiplicative (v, w) convention of `core.se3`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_rgbd_tpu_torch.core import se3
from slam_rgbd_tpu_torch.core.config import BAConfig, CameraIntrinsics


class BAResult(NamedTuple):
    kf_pose: torch.Tensor  # (W, 4, 4) refined camera-to-world poses
    pt_xyz: torch.Tensor  # (P, 3) refined points (only observed ones move)
    rmse_px: torch.Tensor  # () reprojection RMSE over inliers, pixels
    n_obs: torch.Tensor  # () active observations
    pt_solved: torch.Tensor | None = None  # (P,) bool: points the solve took
    # () int32: observed points beyond the per-window compaction budget
    n_dropped: torch.Tensor | None = None


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of batched 3x3 blocks (..., 3, 3).

    Callers pass damped blocks, so the determinant is bounded away from 0.
    """
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    ca = e * i - f * h
    cb = c * h - b * i
    cc = b * f - c * e
    cd = f * g - d * i
    ce = a * i - c * g
    cf = c * d - a * f
    cg = d * h - e * g
    ch = b * g - a * h
    ci = a * e - b * d
    det = a * ca + b * cd + c * cg
    inv_det = 1.0 / det
    adj = torch.stack([ca, cb, cc, cd, ce, cf, cg, ch, ci], dim=-1)
    return adj.reshape(M.shape) * inv_det[..., None, None]


def _reproj_residuals(poses_wc, pt_xyz, obs_uv, obs_z, obs_pid, obs_ok,
                      cam: CameraIntrinsics):
    """Residuals + Jacobians for all (W, K) observations.

    Returns r (W, K, 3), Jc (W, K, 3, 6), Jx (W, K, 3, 3), mask (W, K). The
    pose Jacobian is for a left twist d on T_cw (camera from world):
    p_c = exp(d) T_cw X  =>  dp_c/dd = [I | -hat(p_c)].
    """
    P = pt_xyz.shape[0]
    X = pt_xyz[torch.clamp(obs_pid, 0, P - 1).long()]  # (W, K, 3)
    T_cw = se3.inverse(poses_wc)  # (W, 4, 4)
    R_cw = T_cw[:, :3, :3]
    p_c = X @ R_cw.transpose(-1, -2) + T_cw[:, None, :3, 3]
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    z_safe = torch.clamp_min(z, 1e-3)
    u = cam.fx * x / z_safe + cam.cx
    v = cam.fy * y / z_safe + cam.cy
    zw = cam.fx / torch.clamp_min(obs_z, 0.1)  # metres -> pixel-equivalent
    r = torch.stack(
        [u - obs_uv[..., 0], v - obs_uv[..., 1], (z - obs_z) * zw], dim=-1
    )
    mask = obs_ok & (obs_pid >= 0) & (z > 0.05) & (obs_z > 0.05)

    # d(u, v, rz) / d p_c
    zero = torch.zeros_like(z_safe)
    zz = z_safe * z_safe
    duv_dp = torch.stack([
        cam.fx / z_safe, zero, -cam.fx * x / zz,
        zero, cam.fy / z_safe, -cam.fy * y / zz,
        zero, zero, zw,
    ], dim=-1).reshape(z.shape + (3, 3))
    eye3 = torch.eye(3, dtype=p_c.dtype, device=p_c.device)
    dp_dd = torch.cat([eye3.expand(p_c.shape[:-1] + (3, 3)), -se3.hat(p_c)], dim=-1)
    Jc = duv_dp @ dp_dd  # (W, K, 3, 6)
    Jx = duv_dp @ R_cw[:, None]  # dp_c/dX = R_cw -> (W, K, 3, 3)
    return r, Jc, Jx, mask


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of a 1-D mask (its length when none)."""
    n = mask.shape[0]
    return torch.where(mask, torch.arange(n, device=mask.device), n).amin()


def scatter_sum(index: torch.Tensor, values: torch.Tensor, rows: int) -> torch.Tensor:
    """Sum `values` (N, ...) into a zero table of `rows` rows at `index`, in
    an order that does not change from run to run (see the module's note)."""
    out = torch.zeros((rows,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_put_((index,), values, accumulate=True)


def _make_lm(window_valid, obs_uv, obs_z, obs_pid, obs_ok, cam, cfg: BAConfig,
             free_mask, P: int):
    """The LM machinery over a fixed observation set: (cost_fn, lm_iter)."""
    W, K = obs_pid.shape
    D = 6 * W
    dev = obs_pid.device
    obs_ok = obs_ok & window_valid[:, None]
    if free_mask is None:
        free_mask = window_valid
    # gauge: at least one valid camera is anchored; if every valid camera is
    # free, the first valid one is pinned
    any_fixed_valid = (window_valid & ~free_mask).any()
    cam_free = window_valid & free_mask & (
        any_fixed_valid | (torch.arange(W, device=dev) != _first_true(window_valid))
    )
    free = cam_free.repeat_interleave(6)
    free2 = free[:, None] & free[None, :]
    cam_col = torch.arange(W, device=dev)[:, None]
    eye3 = torch.eye(3, device=dev)
    c_tukey = cfg.reject_px

    def cost_fn(poses, X):
        """Tukey rho-cost over the observations (for LM accept / reject)."""
        r, _, _, mask = _reproj_residuals(poses, X, obs_uv, obs_z, obs_pid, obs_ok, cam)
        rn = torch.linalg.norm(r, dim=-1)
        t2 = torch.clamp((rn / c_tukey) ** 2, 0.0, 1.0)
        rho = (c_tukey * c_tukey / 6.0) * (1.0 - (1.0 - t2) ** 3)
        return torch.sum(torch.where(mask, rho, 0.0))

    def lm_iter(state):
        poses, X, lam, cost = state
        r, Jc, Jx, mask = _reproj_residuals(poses, X, obs_uv, obs_z, obs_pid, obs_ok, cam)
        # Tukey IRLS weights: zero beyond c_tukey, the hard gate included
        rn = torch.linalg.norm(r, dim=-1)
        t = torch.clamp(rn / c_tukey, 0.0, 1.0)
        w = torch.where(mask, (1.0 - t * t) ** 2, 0.0)  # (W, K)
        mask = mask & (w > 0.0)
        pid_safe = torch.where(mask, obs_pid, P).long()  # dump slot P
        flat = pid_safe.reshape(-1)
        wJx = Jx * w[..., None, None]
        wJc = Jc * w[..., None, None]

        # point blocks Hpp (P, 3, 3), gp (P, 3)
        JxT_Jx = Jx.transpose(-1, -2) @ wJx
        JxT_r = (wJx.transpose(-1, -2) @ r[..., None])[..., 0]
        Hpp = scatter_sum(flat, JxT_Jx.reshape(-1, 3, 3), P + 1)[:P]
        gp = scatter_sum(flat, JxT_r.reshape(-1, 3), P + 1)[:P]
        observed = scatter_sum(
            flat, torch.ones(flat.shape, dtype=torch.int32, device=dev), P + 1)[:P] > 0

        # damped inverse of each block, the damping relative to its scale
        tr = (Hpp[:, 0, 0] + Hpp[:, 1, 1] + Hpp[:, 2, 2]) / 3.0
        Hpp = Hpp + (lam * tr + 1e-5)[:, None, None] * eye3
        Hpp_inv = torch.where(observed[:, None, None], _inv3x3(Hpp), 0.0)

        # camera blocks Hcc (W, 6, 6), gc (W, 6)
        Hcc_blocks = torch.sum(Jc.transpose(-1, -2) @ wJc, dim=1)
        gc = torch.sum((wJc.transpose(-1, -2) @ r[..., None])[..., 0], dim=1)

        # coupling: per-observation Jc^T Jx (6, 3) summed into (P, W, 6, 3)
        JcT_Jx = Jc.transpose(-1, -2) @ wJx
        A = scatter_sum(
            (pid_safe * W + cam_col).reshape(-1), JcT_Jx.reshape(-1, 6, 3),
            (P + 1) * W).reshape(P + 1, W, 6, 3)[:P]

        # Schur: S = Hcc - sum_p A_p Hpp_p^-1 A_p^T
        AH = torch.einsum("pwab,pbc->pwac", A, Hpp_inv)
        S = torch.block_diag(*Hcc_blocks.unbind(0)) - torch.einsum(
            "pwac,pvbc->wavb", AH, A).reshape(D, D)
        b = -gc.reshape(D) + torch.einsum("pwac,pc->wa", AH, gp).reshape(D)

        # gauge + invalid cameras: their 6-blocks become identity rows; the
        # camera damping scales with the diagonal too
        S = torch.where(free2, S, 0.0)
        s_diag = torch.diagonal(S)
        S = S + torch.diag(torch.where(
            free, lam * torch.clamp_min(s_diag, 1.0) + 1e-5, 1.0))
        b = torch.where(free, b, 0.0)

        # Jacobi scaling: the raw system mixes rotation (~1e6) and
        # translation (~1e3) scales, too much for a float32 LU
        d_scale = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(S), 1e-8))
        S_hat = S * d_scale[:, None] * d_scale[None, :]
        dc = torch.linalg.solve_ex(S_hat, (b * d_scale)[:, None])[0][:, 0] * d_scale
        dc_blocks = dc.reshape(W, 6)

        # back-substitute the points: dp = Hpp^-1 (-gp - A^T dc)
        Atdc = torch.einsum("pwab,wa->pb", A, dc_blocks)
        dp = (Hpp_inv @ (-gp - Atdc)[..., None])[..., 0]
        dp = torch.where(observed[:, None], dp, 0.0)

        # left twist on T_cw  =>  T_wc_new = T_wc exp(-d)
        moved = se3.normalize_rotation(poses @ se3.exp(-dc_blocks))
        poses_new = torch.where(cam_free[:, None, None], moved, poses)
        X_new = X + dp

        # keep the step only if the robust cost drops
        cost_new = cost_fn(poses_new, X_new)
        accept = (cost_new < cost) & torch.isfinite(dc).all() & torch.isfinite(dp).all()
        return (
            torch.where(accept, poses_new, poses),
            torch.where(accept, X_new, X),
            torch.clamp(torch.where(accept, lam * 0.3, lam * 8.0), 1e-6, 1e3),
            torch.where(accept, cost_new, cost),
        )

    return cost_fn, lm_iter


def _final_stats(poses, X, obs_uv, obs_z, obs_pid, obs_ok, cam):
    """(rmse over the active observations, their number)."""
    r, _, _, mask = _reproj_residuals(poses, X, obs_uv, obs_z, obs_pid, obs_ok, cam)
    rn2 = torch.sum(r * r, dim=-1)
    n = torch.sum(mask)
    rmse = torch.sqrt(torch.sum(torch.where(mask, rn2, 0.0)) / torch.clamp_min(n, 1))
    return rmse, n


def local_ba(
    poses_wc: torch.Tensor,  # (W, 4, 4) window keyframe poses (cam -> world)
    window_valid: torch.Tensor,  # (W,) bool
    pt_xyz: torch.Tensor,  # (P, 3) map points (world)
    obs_uv: torch.Tensor,  # (W, K, 2) observed pixels
    obs_z: torch.Tensor,  # (W, K) measured depth at the observation (metres)
    obs_pid: torch.Tensor,  # (W, K) int32 point ids (-1 none)
    obs_ok: torch.Tensor,  # (W, K) bool
    cam: CameraIntrinsics,
    cfg: BAConfig,
    free_mask: torch.Tensor | None = None,  # (W,) bool: poses to optimize
) -> BAResult:
    """Local BA over a fixed camera set, `cfg.iters` LM iterations.

    Cameras with `free_mask` False (plus a gauge anchor) contribute
    residuals, constraining the points, but their poses do not move. When
    `free_mask` is None every valid camera except the first is free. Points
    that the camera set does not observe are untouched.
    """
    cost_fn, lm_iter = _make_lm(
        window_valid, obs_uv, obs_z, obs_pid, obs_ok, cam, cfg, free_mask,
        pt_xyz.shape[0],
    )
    lam = torch.full((), cfg.damping, dtype=torch.float32, device=pt_xyz.device)
    state = (poses_wc, pt_xyz, lam, cost_fn(poses_wc, pt_xyz))
    for _ in range(cfg.iters):
        state = lm_iter(state)
    poses_out, X_out = state[:2]
    rmse, n = _final_stats(poses_out, X_out, obs_uv, obs_z, obs_pid,
                           obs_ok & window_valid[:, None], cam)
    return BAResult(kf_pose=poses_out, pt_xyz=X_out, rmse_px=rmse, n_obs=n)


def _win_compact(window_valid, pt_xyz, obs_uv, obs_z, obs_pid, obs_ok,
                 cam: CameraIntrinsics, cfg: BAConfig):
    """Compaction stage of the windowed solve: pick the per-window point
    budget (most observations first, ties toward the higher, newer id) and
    remap the observation grid onto it. Returns
    (sel, pid_c, ok_c, pt_c, n_observed)."""
    P = pt_xyz.shape[0]
    C = min(cfg.max_points_per_window, P)
    dev = pt_xyz.device
    ok = obs_ok & window_valid[:, None] & (obs_pid >= 0)
    pid_safe = torch.where(ok, obs_pid, P).long()
    flat = pid_safe.reshape(-1)
    n_obs_pt = scatter_sum(
        flat, torch.ones(flat.shape, dtype=torch.int32, device=dev), P + 1)[:P]
    observed = n_obs_pt > 0
    n_observed = observed.sum().to(torch.int32)
    # counts clamped so that the rank stays exact in float32 (< 2^24)
    rank = torch.where(
        observed,
        torch.clamp(n_obs_pt, max=255).to(torch.float32) * (P + 1)
        + torch.arange(P, device=dev),
        -1.0,
    )
    # ranks are distinct except the -1 of unobserved points: a stable sort
    # keeps those in index order, as the reference's top_k does
    sel = torch.sort(rank, descending=True, stable=True).indices[:C]
    sel = torch.where(observed[sel], sel, P)  # pad the unobserved slots
    lookup = torch.full((P + 1,), -1, dtype=torch.int32, device=dev)
    lookup[sel] = torch.arange(C, dtype=torch.int32, device=dev)
    lookup[P] = -1  # the pad writes above land on row P: restore it
    pt_pad = torch.cat([pt_xyz, torch.zeros((1, 3), dtype=pt_xyz.dtype, device=dev)])
    pt_c = pt_pad[sel]  # (C, 3)
    pid_c = lookup[pid_safe]  # (W, K): compact id, -1 if masked or overflow
    return sel, pid_c, ok & (pid_c >= 0), pt_c, n_observed


def _scatter_back(sel, X, pt_xyz, n_observed, poses, rmse, n) -> BAResult:
    """The compact solution back into the full table (pad slots of `sel`
    write the dump row P)."""
    P, C = pt_xyz.shape[0], X.shape[0]
    dev = pt_xyz.device
    pt_pad = torch.cat([pt_xyz, torch.zeros((1, 3), dtype=pt_xyz.dtype, device=dev)])
    pt_new = pt_pad.index_copy(0, sel, X)[:P]
    pt_solved = torch.zeros((P + 1,), dtype=torch.bool, device=dev).index_fill_(
        0, sel, True)[:P]
    return BAResult(
        kf_pose=poses, pt_xyz=pt_new, rmse_px=rmse, n_obs=n, pt_solved=pt_solved,
        n_dropped=torch.clamp_min(n_observed - C, 0),
    )


def _windowed_single(poses_wc, window_valid, pt_xyz, obs_uv, obs_z, obs_pid,
                     obs_ok, cam: CameraIntrinsics, cfg: BAConfig,
                     free_mask=None) -> BAResult:
    """Windowed solve in one go (see `windowed_local_ba`)."""
    sel, pid_c, ok_c, pt_c, n_observed = _win_compact(
        window_valid, pt_xyz, obs_uv, obs_z, obs_pid, obs_ok, cam, cfg)
    res = local_ba(poses_wc, window_valid, pt_c, obs_uv, obs_z, pid_c, ok_c,
                   cam, cfg, free_mask=free_mask)
    return _scatter_back(sel, res.pt_xyz, pt_xyz, n_observed, res.kf_pose,
                         res.rmse_px, res.n_obs)


def windowed_local_ba(
    poses_wc: torch.Tensor,  # (W, 4, 4)
    window_valid: torch.Tensor,  # (W,)
    pt_xyz: torch.Tensor,  # (P, 3) the full map point table
    obs_uv: torch.Tensor,  # (W, K, 2)
    obs_z: torch.Tensor,  # (W, K)
    obs_pid: torch.Tensor,  # (W, K) ids into the full table
    obs_ok: torch.Tensor,  # (W, K)
    cam: CameraIntrinsics,
    cfg: BAConfig,
    free_mask: torch.Tensor | None = None,
    dispatch_iters: int | None = None,
) -> BAResult:
    """Local BA over the full map table, with the solve compacted to the
    window's observed points (`cfg.max_points_per_window` slots): the
    observed ids are gathered into a compact table, the observation grid is
    remapped, `local_ba`'s solver runs on it, and the refined points are
    scattered back. If the window observes more distinct points than the
    budget, the least-observed ones are left out of this pass and counted
    in `BAResult.n_dropped`.

    `dispatch_iters=k` is the reference's way to send the LM iterations in
    chunks of k dispatches so that a caller can interleave other work. Here
    every iteration queues its own device operations anyway and the LM state
    stays on the device between them, so the argument is checked and the
    result is the one-go result.
    """
    if dispatch_iters is not None and dispatch_iters < 1:
        raise ValueError(f"dispatch_iters must be >= 1, got {dispatch_iters}")
    return _windowed_single(poses_wc, window_valid, pt_xyz, obs_uv, obs_z,
                            obs_pid, obs_ok, cam, cfg, free_mask)
