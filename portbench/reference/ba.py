"""Sliding-window local BA in plain torch: the reduced camera system by the
Schur complement, Levenberg-Marquardt with Tukey weights and a Jacobi-scaled
dense solve, on the window's most observed points. A frozen copy of the
port's solver; products go through `precision`."""

from __future__ import annotations


import torch

from portbench.reference import se3
from portbench.reference.precision import einsum, mm


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
                      cam):
    """Residuals + Jacobians for all (W, K) observations.

    Returns r (W, K, 3), Jc (W, K, 3, 6), Jx (W, K, 3, 3), mask (W, K). The
    pose Jacobian is for a left twist d on T_cw (camera from world):
    p_c = exp(d) T_cw X  =>  dp_c/dd = [I | -hat(p_c)].
    """
    P = pt_xyz.shape[0]
    X = pt_xyz[torch.clamp(obs_pid, 0, P - 1).long()]  # (W, K, 3)
    T_cw = se3.inverse(poses_wc)  # (W, 4, 4)
    R_cw = T_cw[:, :3, :3]
    p_c = mm(X, R_cw.transpose(-1, -2)) + T_cw[:, None, :3, 3]
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
    Jc = mm(duv_dp, dp_dd)  # (W, K, 3, 6)
    Jx = mm(duv_dp, R_cw[:, None])  # dp_c/dX = R_cw -> (W, K, 3, 3)
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


def _make_lm(window_valid, obs_uv, obs_z, obs_pid, obs_ok, cam, cfg, free_mask, P: int):
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
        JxT_Jx = mm(Jx.transpose(-1, -2), wJx)
        JxT_r = mm(wJx.transpose(-1, -2), r[..., None])[..., 0]
        Hpp = scatter_sum(flat, JxT_Jx.reshape(-1, 3, 3), P + 1)[:P]
        gp = scatter_sum(flat, JxT_r.reshape(-1, 3), P + 1)[:P]
        observed = scatter_sum(
            flat, torch.ones(flat.shape, dtype=torch.int32, device=dev), P + 1)[:P] > 0

        # damped inverse of each block, the damping relative to its scale
        tr = (Hpp[:, 0, 0] + Hpp[:, 1, 1] + Hpp[:, 2, 2]) / 3.0
        Hpp = Hpp + (lam * tr + 1e-5)[:, None, None] * eye3
        Hpp_inv = torch.where(observed[:, None, None], _inv3x3(Hpp), 0.0)

        # camera blocks Hcc (W, 6, 6), gc (W, 6)
        Hcc_blocks = torch.sum(mm(Jc.transpose(-1, -2), wJc), dim=1)
        gc = torch.sum(mm(wJc.transpose(-1, -2), r[..., None])[..., 0], dim=1)

        # coupling: per-observation Jc^T Jx (6, 3) summed into (P, W, 6, 3)
        JcT_Jx = mm(Jc.transpose(-1, -2), wJx)
        A = scatter_sum(
            (pid_safe * W + cam_col).reshape(-1), JcT_Jx.reshape(-1, 6, 3),
            (P + 1) * W).reshape(P + 1, W, 6, 3)[:P]

        # Schur: S = Hcc - sum_p A_p Hpp_p^-1 A_p^T
        AH = einsum("pwab,pbc->pwac", A, Hpp_inv)
        S = torch.block_diag(*Hcc_blocks.unbind(0)) - einsum(
            "pwac,pvbc->wavb", AH, A).reshape(D, D)
        b = -gc.reshape(D) + einsum("pwac,pc->wa", AH, gp).reshape(D)

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
        Atdc = einsum("pwab,wa->pb", A, dc_blocks)
        dp = mm(Hpp_inv, (-gp - Atdc)[..., None])[..., 0]
        dp = torch.where(observed[:, None], dp, 0.0)

        # left twist on T_cw  =>  T_wc_new = T_wc exp(-d)
        moved = se3.normalize_rotation(mm(poses, se3.exp(-dc_blocks)))
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


def window_ba(kf_pose, n_kf: int, pt_xyz, kp_uv, kp_pts, point_id, kp_ok, cam, ba: dict):
    """The backend pass's local BA on a map: the newest 2 x window keyframes,
    the older half fixed, at most `max_points_per_window` of the most
    observed points (ties to the higher id), `iters` LM iterations.
    -> (keyframe poses (M, 4, 4), points (P, 3), which points it solved)."""
    w = ba["window"]
    dev = kf_pose.device
    M, P = kf_pose.shape[0], pt_xyz.shape[0]
    offs = torch.arange(2 * w, device=dev)
    idx = n_kf - 2 * w + offs
    valid = (idx >= 0) & (idx < n_kf)
    idx = torch.clamp(idx, 0, M - 1)
    free = offs >= w
    obs_pid = point_id[idx]
    obs_ok = kp_ok[idx] & valid[:, None]
    obs_uv, obs_z = kp_uv[idx], kp_pts[idx][..., 2]

    # the window's point budget: most observations first, ties to the
    # higher id; the rest keep their rows
    C = min(ba["max_points_per_window"], P)
    ok = obs_ok & (obs_pid >= 0)
    pid_safe = torch.where(ok, obs_pid, P).long()
    flat = pid_safe.reshape(-1)
    n_obs = scatter_sum(flat, torch.ones(flat.shape, dtype=torch.int32, device=dev),
                        P + 1)[:P]
    observed = n_obs > 0
    rank = torch.where(observed, torch.clamp(n_obs, max=255).to(torch.float32) * (P + 1)
                       + torch.arange(P, device=dev), -1.0)
    sel = torch.sort(rank, descending=True, stable=True).indices[:C]
    sel = torch.where(observed[sel], sel, P)
    lookup = torch.full((P + 1,), -1, dtype=torch.int64, device=dev)
    lookup[sel] = torch.arange(C, device=dev)
    lookup[P] = -1
    pt_c = torch.cat([pt_xyz, torch.zeros((1, 3), device=dev)])[sel]
    pid_c = lookup[pid_safe]
    ok_c = ok & (pid_c >= 0)

    cfg = _Settings(ba)
    cost_fn, lm_iter = _make_lm(valid, obs_uv, obs_z, pid_c, ok_c, cam, cfg, free, C)
    lam = torch.full((), cfg.damping, dtype=torch.float32, device=dev)
    state = (kf_pose[idx], pt_c, lam, cost_fn(kf_pose[idx], pt_c))
    for _ in range(cfg.iters):
        state = lm_iter(state)
    poses_w, X = state[:2]

    pad = torch.cat([kf_pose, torch.zeros((1, 4, 4), device=dev)])
    poses = pad.index_copy(0, torch.where(valid, idx, M), poses_w)[:M]
    pts = torch.cat([pt_xyz, torch.zeros((1, 3), device=dev)]).index_copy(0, sel, X)[:P]
    solved = torch.zeros((P + 1,), dtype=torch.bool, device=dev).index_fill_(0, sel, True)[:P]
    return poses, pts, solved


class _Settings:
    """The BA group of the configuration, as attributes."""

    def __init__(self, ba: dict):
        self.__dict__.update(ba)
