"""Fused Gauss-Newton reduction of dense ICP: plain torch version + kernel.

Counterpart of `slam_rgbd_tpu/ops/icp_pallas.gn_reduce`. One call evaluates
one GN iteration of projective point-to-plane + photometric alignment at one
pyramid level and returns (H (6, 6), g (6,), inliers () int32, sq_sum ()).

Planes are channel-first float32 at the level's own size, with no padding:

  src (8, H, W):  vx vy vz  nx ny nz  valid  intensity
  tgt (10, H, W): vx vy vz  nx ny nz  valid  intensity  gx gy

`T` (4, 4) maps source-camera points into the target camera, and `mu`
(2,) holds the integer dominant flow (mu_u, mu_v) removed before the
association window. Both stay on the device: the kernel reads them there.

Association semantics are the reference's windowed bilinear sampling: the
four bilinear corners are taken at the absolute projected point, a corner
counts only where its offset from (u + mu_u, v + mu_v) lies in [-R, R+1]
and inside the image, and a pixel is kept only where the sum of those 1-D
weights' product (`wsum`) and the weighted validity both exceed 0.999
(`icp_pallas.py:263,305`). A corner of weight below 0.001 may therefore be
invalid and still let the pixel pass; its channels are then sampled with
that weight, as in the reference.

`gn_reduce` dispatches on the device of `src`: a CPU tensor goes to
`gn_reduce_reference`, a CUDA tensor to the hand-written kernel in
`csrc/gn_reduce.cu`, and any error there raises.

`gn_reduce_batched` (counterpart of `icp_pallas.gn_reduce_batched`) does the
same for B independent problems, every argument with a leading B, in one
launch of the same kernel with the problem index on the grid. Problem b of
its result equals a single `gn_reduce` call on that problem's inputs bit for
bit, on the card as in the plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_rgbd_tpu_torch.core.config import CameraIntrinsics, ICPConfig

SRC_CHANNELS = 8
TGT_CHANNELS = 10


def _f32(x: float) -> float:
    """Round a Python float to the nearest float32, as the kernel sees it."""
    return float(np.float32(x))


def _constants(cam: CameraIntrinsics, cfg: ICPConfig) -> dict:
    return {
        "fx": _f32(cam.fx), "fy": _f32(cam.fy),
        "cx": _f32(cam.cx), "cy": _f32(cam.cy),
        "min_depth": _f32(cam.min_depth),
        "max_dist_sq": _f32(cfg.max_dist * cfg.max_dist),
        "cos_thresh": _f32(math.cos(math.radians(cfg.max_normal_angle_deg))),
        "huber": _f32(cfg.huber_delta),
        "rgb_w": _f32(cfg.rgb_weight),
        "rgb_huber": _f32(cfg.rgb_huber),
    }


def _corner_weight(df, d, base, radius: int, extent: int):
    """1-D bilinear weight of integer offset `d`, zero outside the window
    [-R, R+1] or the image (`base + d` is the absolute coordinate)."""
    t = base + d
    ok = (d >= -radius) & (d <= radius + 1) & (t >= 0) & (t < extent)
    return torch.where(ok, torch.clamp_min(1.0 - torch.abs(df - d), 0.0), 0.0)


def gn_reduce_reference(T, mu, src, tgt, cam: CameraIntrinsics,
                        cfg: ICPConfig, radius: int):
    """Plain torch version of the kernel, op for op in the same order.

    Every product and sum rounds as the kernel's (built without FMA
    contraction) does, so the per-pixel values and gates agree exactly and
    only the order of the final reduction differs.
    """
    _check_inputs(T, mu, src, tgt, radius)
    c = _constants(cam, cfg)
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

    # direct gather of the four corners, (v0,u0) (v0,u1) (v1,u0) (v1,u1);
    # a corner outside the window has weight 0 and a clamped address
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

    n_norm = torch.clamp_min(
        torch.sqrt(acc[3] * acc[3] + acc[4] * acc[4] + acc[5] * acc[5]), 1e-9
    )
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

    # geometric point-to-plane rows
    r = nx * dx + ny * dy + nz * dz
    a_rows = torch.stack([
        nx, ny, nz, yy * nz - yz * ny, yz * nx - yx * nz, yx * ny - yy * nx, r,
    ]).reshape(7, -1)
    wg = huber_weight(r, c["huber"], 1.0).reshape(1, -1)

    # photometric rows
    ri = acc[7] - sint
    ga = acc[8] * c["fx"] * inv_z
    gb = acc[9] * c["fy"] * inv_z
    gc = -(ga * yx + gb * yy) * inv_z
    b_rows = torch.stack([
        ga, gb, gc, yy * gc - yz * gb, yz * ga - yx * gc, yx * gb - yy * ga, ri,
    ]).reshape(7, -1)
    wp = huber_weight(ri, c["rgb_huber"], c["rgb_w"]).reshape(1, -1)

    m_geo = (a_rows * wg) @ a_rows.T
    m_pho = (b_rows * wp) @ b_rows.T
    m = m_geo + m_pho
    upper = torch.triu(m[:6, :6])
    h_mat = upper + torch.triu(upper, 1).T
    return h_mat, m[:6, 6], mask.sum().to(torch.int32), m_geo[6, 6]


def _check_inputs(T, mu, src, tgt, radius: int, batched: bool = False) -> None:
    """Raise on what the kernel does not take. `batched`: every tensor has
    one leading problem axis of the same length."""
    fn = "gn_reduce_batched" if batched else "gn_reduce"
    for name, x in (("T", T), ("mu", mu), ("src", src), ("tgt", tgt)):
        if x.device != src.device:
            raise ValueError(f"{fn}: {name} on {x.device}, src on {src.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    lead = tuple(src.shape[:1]) if batched else ()
    if src.dim() != len(lead) + 3 or src.shape[-3] != SRC_CHANNELS:
        raise ValueError(
            f"{fn}: src must be {'(B, ' if batched else '('}8, H, W), "
            f"got {tuple(src.shape)}")
    if tuple(T.shape) != lead + (4, 4) or tuple(mu.shape) != lead + (2,):
        raise ValueError(f"{fn}: T {tuple(T.shape)}, mu {tuple(mu.shape)}")
    want = lead + (TGT_CHANNELS,) + tuple(src.shape[-2:])
    if tuple(tgt.shape) != want:
        raise ValueError(f"{fn}: tgt must be {want}, got {tuple(tgt.shape)}")
    if batched and not 1 <= lead[0] <= 65535:
        raise ValueError(f"{fn}: 1 to 65535 problems a launch, got {lead[0]}")
    if radius < 0:
        raise ValueError(f"{fn}: radius must be >= 0, got {radius}")


def gn_reduce(T, mu, src, tgt, cam: CameraIntrinsics, cfg: ICPConfig,
              radius: int):
    """One fused GN reduction -> (H (6,6), g (6,), inliers, sq_sum).

    CPU tensors take `gn_reduce_reference`. CUDA tensors launch the kernel
    on the current stream (no host sync) and count one in
    `gn_reduce.launches`; a CUDA error raises.
    """
    if src.device.type == "cpu":
        return gn_reduce_reference(T, mu, src, tgt, cam, cfg, radius)
    if src.device.type != "cuda":
        raise ValueError(f"gn_reduce: no kernel for device {src.device}")
    _check_inputs(T, mu, src, tgt, radius)
    from slam_rgbd_tpu_torch.ops import _build

    lib = _build.load()
    _, h, w = src.shape
    c = _constants(cam, cfg)
    scal = torch.cat([T.reshape(16), mu])
    scratch = torch.empty(
        lib.gn_reduce_scratch_floats(h, w), dtype=torch.float32, device=src.device
    )
    out = torch.empty(43, dtype=torch.float32, device=src.device)
    inliers = torch.empty((), dtype=torch.int32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.gn_reduce_launch(
            scal.data_ptr(), src.data_ptr(), tgt.data_ptr(), h, w, radius,
            c["fx"], c["fy"], c["cx"], c["cy"], c["min_depth"],
            c["max_dist_sq"], c["cos_thresh"], c["huber"], c["rgb_w"],
            c["rgb_huber"], scratch.data_ptr(), out.data_ptr(),
            inliers.data_ptr(), stream,
        )
    _build.check(err, "gn_reduce launch")
    gn_reduce.launches += 1
    return out[:36].view(6, 6), out[36:42], inliers, out[42]


gn_reduce.launches = 0


def gn_reduce_batched_reference(T, mu, src, tgt, cam: CameraIntrinsics,
                                cfg: ICPConfig, radius: int):
    """Plain torch version of the batched kernel: `gn_reduce_reference` on
    each problem in turn, so that problem b equals the single plain version
    on its inputs exactly."""
    _check_inputs(T, mu, src, tgt, radius, batched=True)
    outs = [gn_reduce_reference(T[b], mu[b], src[b], tgt[b], cam, cfg, radius)
            for b in range(src.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def gn_reduce_batched(T, mu, src, tgt, cam: CameraIntrinsics, cfg: ICPConfig,
                      radius: int):
    """B fused GN reductions in one launch: T (B, 4, 4), mu (B, 2), src
    (B, 8, H, W), tgt (B, 10, H, W) -> (H (B, 6, 6), g (B, 6), inliers (B,)
    int32, sq_sum (B,)).

    CPU tensors take `gn_reduce_batched_reference`. CUDA tensors launch the
    kernel once for all B problems on the current stream (no host sync) and
    count one in `gn_reduce_batched.launches`; a CUDA error raises.
    """
    if src.device.type == "cpu":
        return gn_reduce_batched_reference(T, mu, src, tgt, cam, cfg, radius)
    if src.device.type != "cuda":
        raise ValueError(f"gn_reduce_batched: no kernel for device {src.device}")
    _check_inputs(T, mu, src, tgt, radius, batched=True)
    from slam_rgbd_tpu_torch.ops import _build

    lib = _build.load()
    n_b, _, h, w = src.shape
    c = _constants(cam, cfg)
    scal = torch.cat([T.reshape(n_b, 16), mu], dim=1)
    scratch = torch.empty(
        lib.gn_reduce_batched_scratch_floats(n_b, h, w), dtype=torch.float32,
        device=src.device,
    )
    out = torch.empty((n_b, 43), dtype=torch.float32, device=src.device)
    inliers = torch.empty((n_b,), dtype=torch.int32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.gn_reduce_batched_launch(
            scal.data_ptr(), src.data_ptr(), tgt.data_ptr(), n_b, h, w, radius,
            c["fx"], c["fy"], c["cx"], c["cy"], c["min_depth"],
            c["max_dist_sq"], c["cos_thresh"], c["huber"], c["rgb_w"],
            c["rgb_huber"], scratch.data_ptr(), out.data_ptr(),
            inliers.data_ptr(), stream,
        )
    _build.check(err, "gn_reduce_batched launch")
    gn_reduce_batched.launches += 1
    return out[:, :36].view(n_b, 6, 6), out[:, 36:42], inliers, out[:, 42]


gn_reduce_batched.launches = 0
