"""Frame-to-frame dense ICP (point-to-plane + photometric) in plain torch.

A frozen copy of the port's tracker in its plain form: three pyramid
levels coarse to fine with the configured GN iterations, the coarsest level
solved from three starts (the motion prior, the identity, the reversed
prior) and the start with most inliers kept, the dominant-flow shift
(re-estimated every iteration at the coarsest level, once a level below),
the windowed bilinear association with its two 0.999 gates, Huber weights,
the damped 6x6 Cholesky step, and the motion clamp. Float32; the products
go through `precision`.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference import se3
from portbench.reference.camera import Camera, frame_pyramid, pixel_grid
from portbench.reference.precision import mm

SRC_CHANNELS = 8
TGT_CHANNELS = 10


def _f32(x: float) -> float:
    return float(np.float32(x))


def icp_params(icp: dict) -> SimpleNamespace:
    """The tracker's settings from the configuration's `icp` group."""
    return SimpleNamespace(**icp)


def flow_shift(up, vp, h: int, w: int) -> torch.Tensor:
    """The rounded masked mean of the projective flow, (2,) or (B, 2)."""
    u, v = pixel_grid(h, w, up.device)
    mm_ = ((up > 0) & (up < w - 1) & (vp > 0) & (vp < h - 1)).to(up.dtype)
    msum = torch.clamp_min(torch.sum(mm_, dim=(-2, -1)), 1.0)
    return torch.round(torch.stack([
        torch.sum((up - u) * mm_, dim=(-2, -1)),
        torch.sum((vp - v) * mm_, dim=(-2, -1)),
    ], dim=-1) / msum[..., None])


def project(T, verts, cam: Camera):
    """Source vertices (h, w, 3) under T (4, 4), or (P, h, w, 3) under
    (P, 4, 4), projected: (u, v)."""
    if T.dim() == 3:
        y = mm(verts, T[:, None, :3, :3].transpose(-1, -2)) + T[:, None, None, :3, 3]
    else:
        y = se3.transform_points(T, verts)
    z = torch.clamp_min(y[..., 2], 1e-6)
    return cam.fx * y[..., 0] / z + cam.cx, cam.fy * y[..., 1] / z + cam.cy


def level_planes(level: dict) -> torch.Tensor:
    """(10, H, W): vertices, normals, valid, intensity, gradient."""
    return torch.cat([
        level["vertices"].movedim(-1, -3), level["normals"].movedim(-1, -3),
        level["valid"].to(torch.float32).unsqueeze(-3), level["intensity"].unsqueeze(-3),
        level["grad"].movedim(-1, -3),
    ], dim=-3).contiguous()


def _corner_weight(df, d, base, radius: int, extent: int):
    t = base + d
    ok = (d >= -radius) & (d <= radius + 1) & (t >= 0) & (t < extent)
    return torch.where(ok, torch.clamp_min(1.0 - torch.abs(df - d), 0.0), 0.0)


def gn_reduce(T, mu, src, tgt, cam: Camera, cfg, radius: int):
    """One GN reduction at one level -> (H (6, 6), g (6,), inliers, sq_sum)."""
    c = dict(fx=_f32(cam.fx), fy=_f32(cam.fy), cx=_f32(cam.cx), cy=_f32(cam.cy),
             min_depth=_f32(cam.min_depth), max_dist_sq=_f32(cfg.max_dist * cfg.max_dist),
             cos_thresh=_f32(math.cos(math.radians(cfg.max_normal_angle_deg))),
             huber=_f32(cfg.huber_delta), rgb_w=_f32(cfg.rgb_weight),
             rgb_huber=_f32(cfg.rgb_huber))
    _, h, w = src.shape
    dev = src.device
    t = T.reshape(16)
    mu_u, mu_v = mu[0], mu[1]
    px, py, pz, snx, sny, snz, sval, sint = src.unbind(0)
    yx = t[0] * px + t[1] * py + t[2] * pz + t[3]
    yy = t[4] * px + t[5] * py + t[6] * pz + t[7]
    yz = t[8] * px + t[9] * py + t[10] * pz + t[11]
    rnx = t[0] * snx + t[1] * sny + t[2] * snz
    rny = t[4] * snx + t[5] * sny + t[6] * snz
    rnz = t[8] * snx + t[9] * sny + t[10] * snz
    inv_z = torch.reciprocal(torch.clamp_min(yz, 1e-6))
    up = c["fx"] * yx * inv_z + c["cx"]
    vp = c["fy"] * yy * inv_z + c["cy"]
    in_front = yz > c["min_depth"]

    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    du_f = up - u - mu_u
    dv_f = vp - v - mu_v
    du0 = torch.floor(du_f)
    dv0 = torch.floor(dv_f)
    ubase = u + mu_u
    vbase = v + mu_v
    wu0 = _corner_weight(du_f, du0, ubase, radius, w)
    wu1 = _corner_weight(du_f, du0 + 1.0, ubase, radius, w)
    wv0 = _corner_weight(dv_f, dv0, vbase, radius, h)
    wv1 = _corner_weight(dv_f, dv0 + 1.0, vbase, radius, h)
    wsum = (wu0 + wu1) * (wv0 + wv1)
    tu = (ubase + du0).long()
    tv = (vbase + dv0).long()
    flat = tgt.reshape(TGT_CHANNELS, h * w)
    acc = None
    for wgt, dv, du in ((wu0 * wv0, 0, 0), (wu1 * wv0, 0, 1),
                        (wu0 * wv1, 1, 0), (wu1 * wv1, 1, 1)):
        idx = (tv + dv).clamp(0, h - 1) * w + (tu + du).clamp(0, w - 1)
        term = wgt * flat[:, idx.reshape(-1)].reshape(TGT_CHANNELS, h, w)
        acc = term if acc is None else acc + term
    samp_ok = (wsum > _f32(0.999)) & (acc[6] > _f32(0.999))

    n_norm = torch.clamp_min(torch.sqrt(acc[3] * acc[3] + acc[4] * acc[4] + acc[5] * acc[5]),
                             1e-9)
    nx, ny, nz = acc[3] / n_norm, acc[4] / n_norm, acc[5] / n_norm
    dx, dy, dz = yx - acc[0], yy - acc[1], yz - acc[2]
    dist_ok = dx * dx + dy * dy + dz * dz < c["max_dist_sq"]
    angle_ok = nx * rnx + ny * rny + nz * rnz > c["cos_thresh"]
    mask = (sval > 0.5) & in_front & samp_ok & dist_ok & angle_ok

    def huber_weight(res, delta, scale):
        a = torch.abs(res)
        num = torch.full((), delta, dtype=torch.float32, device=dev)
        wt = torch.where(a <= delta, 1.0, num / torch.clamp_min(a, 1e-12))
        return torch.where(mask, wt * scale, 0.0)

    r = nx * dx + ny * dy + nz * dz
    a_rows = torch.stack([nx, ny, nz, yy * nz - yz * ny, yz * nx - yx * nz,
                          yx * ny - yy * nx, r]).reshape(7, -1)
    wg = huber_weight(r, c["huber"], 1.0).reshape(1, -1)
    ri = acc[7] - sint
    ga = acc[8] * c["fx"] * inv_z
    gb = acc[9] * c["fy"] * inv_z
    gc = -(ga * yx + gb * yy) * inv_z
    b_rows = torch.stack([ga, gb, gc, yy * gc - yz * gb, yz * ga - yx * gc,
                          yx * gb - yy * ga, ri]).reshape(7, -1)
    wp = huber_weight(ri, c["rgb_huber"], c["rgb_w"]).reshape(1, -1)
    m_geo = mm(a_rows * wg, a_rows.T)
    m_pho = mm(b_rows * wp, b_rows.T)
    m = m_geo + m_pho
    upper = torch.triu(m[:6, :6])
    h_mat = upper + torch.triu(upper, 1).T
    return h_mat, m[:6, 6], mask.sum().to(torch.int32), m_geo[6, 6]


def apply_update(T, H, g, inliers, damping: float):
    """Damped Cholesky step and left-multiplicative update; the identity
    step where the system is degenerate."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    Hd = H + torch.diag_embed(damping * torch.clamp_min(diag, 1.0))
    L, info = torch.linalg.cholesky_ex(Hd)
    delta = torch.cholesky_solve(-g[..., None], L)[..., 0]
    ok = torch.isfinite(delta).all(dim=-1) & (info == 0) & (inliers > 6)
    delta = torch.where(ok[..., None], delta, 0.0)
    return se3.normalize_rotation(mm(se3.exp(delta), T))


def _schedule(cfg, levels: int, k: int):
    ci = min(levels - 1 - k, len(cfg.iters) - 1)
    return cfg.iters[ci], cfg.window_px[min(ci, len(cfg.window_px) - 1)]


def _run_level(T, inliers, sq_sum, k: int, levels: int, verts, src, tgt, cam: Camera, cfg):
    """GN iterations of level k for one pose (4, 4) or P poses over one
    shared plane set."""
    level_cam = cam.scaled(2.0 ** k)
    n_iters, radius = _schedule(cfg, levels, k)
    h, w = tgt.shape[-2:]
    per_iter_mu = k == levels - 1 or not (radius <= 8 and min(h, w) >= 32)
    batched = T.dim() == 3

    def step(T, mu):
        if not batched:
            H, g, inl, sq = gn_reduce(T, mu, src, tgt, level_cam, cfg, radius)
            return apply_update(T, H, g, inl, cfg.damping), inl, sq
        outs = [gn_reduce(T[p], mu[p], src, tgt, level_cam, cfg, radius)
                for p in range(T.shape[0])]
        H, g, inl, sq = (torch.stack(x) for x in zip(*outs))
        return apply_update(T, H, g, inl, cfg.damping), inl, sq

    if not per_iter_mu:
        mu = flow_shift(*project(T, verts, level_cam), h, w)
    for _ in range(n_iters):
        if per_iter_mu:
            mu = flow_shift(*project(T, verts, level_cam), h, w)
        T, inliers, sq_sum = step(T, mu)
    return T, inliers, sq_sum


def icp_align(src_pyr, tgt_pyr, T_init, cam: Camera, cfg):
    """Coarse to fine; T maps source-camera points into the target camera.
    -> (T, inliers at the finest level, valid fraction)."""
    levels = len(src_pyr)
    planes = [(level_planes(s)[:SRC_CHANNELS].contiguous(), level_planes(t))
              for s, t in zip(src_pyr, tgt_pyr)]
    k0 = levels - 1
    n_hyp = min(max(cfg.hypotheses, 1), 3)
    cands = torch.stack([
        T_init, torch.eye(4, dtype=T_init.dtype, device=T_init.device),
        se3.normalize_rotation(se3.inverse(T_init)),
    ][:n_hyp])
    verts = src_pyr[k0]["vertices"].expand((n_hyp,) + src_pyr[k0]["vertices"].shape)
    Ts, inl, sq = _run_level(cands, None, None, k0, levels, verts, *planes[k0], cam, cfg)
    best = int(torch.argmax(inl))  # the first of equals
    T, inliers, sq_sum = Ts[best], inl[best], sq[best]
    for k in range(levels - 2, -1, -1):
        T, inliers, sq_sum = _run_level(T, inliers, sq_sum, k, levels,
                                        src_pyr[k]["vertices"], *planes[k], cam, cfg)
    valid_src = torch.sum(src_pyr[0]["valid"])
    return T, inliers, inliers / torch.clamp_min(valid_src, 1)


def track(prev_frame, frame, prior, cam: Camera, cfg):
    """One tracked frame: (depth, rgb) of the previous and current frame on
    the device, the motion prior (4, 4) -> the relative pose T_prev_curr
    (identity where the step is longer than `max_step_m` or not finite)."""
    levels = cfg.levels
    prev = frame_pyramid(*prev_frame, cam, levels)
    curr = frame_pyramid(*frame, cam, levels)
    T, _, _ = icp_align(curr, prev, prior, cam, cfg)
    ok = (torch.linalg.norm(T[:3, 3]) <= cfg.max_step_m) & torch.isfinite(T).all()
    return torch.where(ok, T, torch.eye(4, dtype=T.dtype, device=T.device))
