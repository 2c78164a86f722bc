"""Fused Gauss-Newton iteration of dense ICP: plain torch versions + kernel.

Counterpart of `slam_rgbd_tpu/ops/icp_pallas.gn_reduce` / `gn_reduce_batched`.
`gn_reduce` evaluates one GN reduction of projective point-to-plane +
photometric alignment at one pyramid level and returns (H (6, 6), g (6,),
inliers () int32, sq_sum ()). `gn_step` is the same call followed by what
`odometry/icp._apply_update` does with the result (damped 6x6 Cholesky
solve, identity step on a degenerate system, se3 exp, product with T,
rotation normalisation) and returns (T_next (4, 4), H, g, inliers, sq_sum).

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

Every entry point dispatches on the device of `src`: a CPU tensor goes to
the plain version (`*_reference`), a CUDA tensor to the hand-written kernel
in `csrc/gn_reduce.cu`, and any error there raises. On the card a call is
one kernel launch and no other device operation: the reduction across
thread blocks and, for `gn_step`, the pose update happen inside it.

`gn_reduce_batched` / `gn_step_batched` do the same for B independent
problems in one launch: T (B, 4, 4), mu (B, 2) and results with a leading
B. The planes lead with G sets, G dividing B, and problem b reads set
b // (B // G): G = B gives every problem its own planes, G = 1 (or a batch
made by `expand`) one set for all, and G = B / 3 lets the three coarse
starts of each sequence share that sequence's planes. Problem b of the
result equals a single call on that problem's inputs bit for bit, on the
card as in the plain versions.

Only the inner (C, H, W) of the planes and the inner (4, 4) / (2,) of T and
mu must be contiguous; the kernel takes the stride between problems. All
results of one call are views of one freshly allocated tensor, which no
later call writes.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from slam_rgbd_tpu_torch.core.config import CameraIntrinsics, ICPConfig
from slam_rgbd_tpu_torch.ops.workspace import workspace

SRC_CHANNELS = 8
TGT_CHANNELS = 10

_OUT_FLOATS = 64   # a problem: H 36, g 6, sq_sum, inliers, T_next 16, 4 unused
_PARTIAL_ROW = 29  # a block's partials: 28 sums and the count
_BLOCK_PIXELS = 1024  # pixels a thread block takes: 256 threads, 4 each


def _f32(x: float) -> float:
    """Round a Python float to the nearest float32, as the kernel sees it."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
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
        "damping": _f32(cfg.damping),
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
    """Raise on what the kernel does not take. `batched`: T and mu lead with
    the problems, the planes with the plane sets."""
    fn = "gn_reduce_batched" if batched else "gn_reduce"
    lead = 1 if batched else 0
    for name, x in (("T", T), ("mu", mu), ("src", src), ("tgt", tgt)):
        if x.device != src.device:
            raise ValueError(f"{fn}: {name} on {x.device}, src on {src.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {x.dtype}")
        if x.dim() <= lead or not (x[0] if batched else x).is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous within a problem")
    if src.dim() != lead + 3 or src.shape[-3] != SRC_CHANNELS:
        raise ValueError(
            f"{fn}: src must be {'(G, ' if batched else '('}8, H, W), "
            f"got {tuple(src.shape)}")
    sets = tuple(src.shape[:lead])
    hw = tuple(src.shape[-2:])
    problems = tuple(T.shape[:lead])
    if tuple(T.shape) != problems + (4, 4) or tuple(mu.shape) != problems + (2,):
        raise ValueError(f"{fn}: T {tuple(T.shape)}, mu {tuple(mu.shape)}")
    if tuple(tgt.shape) != sets + (TGT_CHANNELS,) + hw:
        raise ValueError(
            f"{fn}: tgt must be {sets + (TGT_CHANNELS,) + hw}, got {tuple(tgt.shape)}")
    if batched:
        if not 1 <= problems[0] <= 65535:
            raise ValueError(f"{fn}: 1 to 65535 problems a launch, got {problems[0]}")
        if sets[0] < 1 or problems[0] % sets[0]:
            raise ValueError(
                f"{fn}: {sets[0]} plane sets do not divide {problems[0]} problems")
    if radius < 0:
        raise ValueError(f"{fn}: radius must be >= 0, got {radius}")


# ---- the kernel's launch ---------------------------------------------------


class _Params(ctypes.Structure):
    """`GnParams` of csrc/gn_reduce.cu."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("height", "width", "radius")] + [
        (n, ctypes.c_float) for n in
        ("fx", "fy", "cx", "cy", "min_depth", "max_dist_sq", "cos_thresh",
         "huber", "rgb_w", "rgb_huber", "damping")]


@functools.lru_cache(maxsize=None)
def _params(cam: CameraIntrinsics, cfg: ICPConfig, radius: int, h: int, w: int):
    """(launch parameters, thread blocks a problem), made once for a
    (cam, cfg) pair at a level. The block count, like the kernel's map from
    pixels to threads, depends on (H, W) only: problem b of a batched launch
    must sum as a single launch does."""
    return _Params(h, w, radius, **_constants(cam, cfg)), -(-h * w // _BLOCK_PIXELS)


def _launch(T, mu, src, tgt, cam, cfg, radius, batched: bool, step: bool):
    """One launch of the kernel on the current stream (no host sync) ->
    the (B, 64) or (64,) tensor it wrote."""
    if src.device.type != "cuda":
        raise ValueError(f"gn_reduce: no kernel for device {src.device}")
    _check_inputs(T, mu, src, tgt, radius, batched)
    from slam_rgbd_tpu_torch.ops import _build

    lib = _build.load()
    dev = src.device
    h, w = src.shape[-2:]
    params, n_blocks = _params(cam, cfg, radius, h, w)
    if batched:
        n_b = T.shape[0]
        share = n_b // src.shape[0]
        strides = (T.stride(0), mu.stride(0), src.stride(0), tgt.stride(0))
        out = torch.empty((n_b, _OUT_FLOATS), dtype=torch.float32, device=dev)
    else:
        n_b, share, strides = 1, 1, (0, 0, 0, 0)
        out = torch.empty(_OUT_FLOATS, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch, counters = workspace(dev, stream, n_b * n_blocks * _PARTIAL_ROW, n_b)
        err = lib.gn_reduce_launch(
            ctypes.byref(params), T.data_ptr(), strides[0], mu.data_ptr(), strides[1],
            src.data_ptr(), strides[2], tgt.data_ptr(), strides[3],
            n_b, share, int(step), n_blocks, scratch.data_ptr(), counters.data_ptr(),
            out.data_ptr(), stream,
        )
    _build.check(err, "gn_reduce launch")
    return out


def _reduction(out):
    """(H, g, inliers, sq_sum) views of a launch's output."""
    return (out[..., :36].view(out.shape[:-1] + (6, 6)), out[..., 36:42],
            out[..., 43].view(torch.int32), out[..., 42])


def _pose(out):
    return out[..., 44:60].view(out.shape[:-1] + (4, 4))


def gn_reduce(T, mu, src, tgt, cam: CameraIntrinsics, cfg: ICPConfig,
              radius: int):
    """One fused GN reduction -> (H (6,6), g (6,), inliers, sq_sum).

    CPU tensors take `gn_reduce_reference`. CUDA tensors launch the kernel
    on the current stream (no host sync) and count one in
    `gn_reduce.launches`; a CUDA error raises.
    """
    if src.device.type == "cpu":
        return gn_reduce_reference(T, mu, src, tgt, cam, cfg, radius)
    out = _launch(T, mu, src, tgt, cam, cfg, radius, False, False)
    gn_reduce.launches += 1
    return _reduction(out)


gn_reduce.launches = 0


def gn_step(T, mu, src, tgt, cam: CameraIntrinsics, cfg: ICPConfig,
            radius: int):
    """One GN iteration -> (T_next (4,4), H, g, inliers, sq_sum): `gn_reduce`
    and the damped solve and pose update of `odometry/icp._apply_update` in
    the same launch. Counts in `gn_reduce.launches`."""
    if src.device.type == "cpu":
        return gn_step_reference(T, mu, src, tgt, cam, cfg, radius)
    out = _launch(T, mu, src, tgt, cam, cfg, radius, False, True)
    gn_reduce.launches += 1
    return (_pose(out),) + _reduction(out)


def gn_step_reference(T, mu, src, tgt, cam: CameraIntrinsics, cfg: ICPConfig,
                      radius: int):
    """Plain version of `gn_step`: the plain reduction, then
    `odometry/icp._apply_update`."""
    from slam_rgbd_tpu_torch.odometry.icp import _apply_update

    H, g, inliers, sq_sum = gn_reduce_reference(T, mu, src, tgt, cam, cfg, radius)
    return _apply_update(T, H, g, inliers, cfg), H, g, inliers, sq_sum


def _each_problem(fn, T, mu, src, tgt, cam, cfg, radius):
    """`fn` on each problem of a batch in turn, so that problem b equals the
    single plain version on its inputs exactly."""
    _check_inputs(T, mu, src, tgt, radius, batched=True)
    share = T.shape[0] // src.shape[0]
    outs = [fn(T[b], mu[b], src[b // share], tgt[b // share], cam, cfg, radius)
            for b in range(T.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def gn_reduce_batched_reference(T, mu, src, tgt, cam: CameraIntrinsics,
                                cfg: ICPConfig, radius: int):
    """Plain torch version of the batched kernel: `gn_reduce_reference` on
    each problem in turn."""
    return _each_problem(gn_reduce_reference, T, mu, src, tgt, cam, cfg, radius)


def gn_step_batched_reference(T, mu, src, tgt, cam: CameraIntrinsics,
                              cfg: ICPConfig, radius: int):
    """Plain version of `gn_step_batched`: `gn_step_reference` on each
    problem in turn."""
    return _each_problem(gn_step_reference, T, mu, src, tgt, cam, cfg, radius)


def gn_reduce_batched(T, mu, src, tgt, cam: CameraIntrinsics, cfg: ICPConfig,
                      radius: int):
    """B fused GN reductions in one launch: T (B, 4, 4), mu (B, 2), src
    (G, 8, H, W), tgt (G, 10, H, W), G dividing B -> (H (B, 6, 6), g (B, 6),
    inliers (B,) int32, sq_sum (B,)).

    CPU tensors take `gn_reduce_batched_reference`. CUDA tensors launch the
    kernel once for all B problems on the current stream (no host sync) and
    count one in `gn_reduce_batched.launches`; a CUDA error raises.
    """
    if src.device.type == "cpu":
        return gn_reduce_batched_reference(T, mu, src, tgt, cam, cfg, radius)
    out = _launch(T, mu, src, tgt, cam, cfg, radius, True, False)
    gn_reduce_batched.launches += 1
    return _reduction(out)


gn_reduce_batched.launches = 0


def gn_step_batched(T, mu, src, tgt, cam: CameraIntrinsics, cfg: ICPConfig,
                    radius: int):
    """B GN iterations in one launch -> (T_next (B, 4, 4), H, g, inliers,
    sq_sum): `gn_reduce_batched` and, per problem, the solve and pose update.
    Counts in `gn_reduce_batched.launches`."""
    if src.device.type == "cpu":
        return gn_step_batched_reference(T, mu, src, tgt, cam, cfg, radius)
    out = _launch(T, mu, src, tgt, cam, cfg, radius, True, True)
    gn_reduce_batched.launches += 1
    return (_pose(out),) + _reduction(out)


# ---- the kernel's pose update, written out ----------------------------------


def solve_update_written_out(T, H, g, inliers, damping: float) -> torch.Tensor:
    """The arithmetic of the kernel's pose update, scalar by scalar in the
    kernel's order, on tensors with any leading dimensions: damping
    `H + diag(damping * max(diag H, 1))`, a 6x6 Cholesky factorization and
    two triangular solves, the identity step where a pivot is not positive,
    the step is not finite or `inliers <= 6`, se3 exp with its Taylor branch,
    the product with T and two passes of rotation normalisation.

    It computes what `odometry/icp._apply_update` computes, with every sum
    in a stated order: the kernel's `T_next` is held against it on the card,
    and it against `_apply_update` in the CPU tests.
    """
    A = [[H[..., i, j] for j in range(6)] for i in range(6)]
    for i in range(6):
        A[i][i] = A[i][i] + damping * torch.clamp_min(A[i][i], 1.0)
    ok = inliers > 6
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = A[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        ok = ok & (s > 0.0)  # a pivot that is not positive (or NaN) fails
        d = torch.sqrt(s)
        L[j][j] = d
        for i in range(j + 1, 6):
            r = A[i][j]
            for k in range(j):
                r = r - L[i][k] * L[j][k]
            L[i][j] = r / d
    y, x = [None] * 6, [None] * 6
    for i in range(6):  # L y = -g
        s = -g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    for i in range(5, -1, -1):  # L^T x = y
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    for i in range(6):
        ok = ok & torch.isfinite(x[i])
    x = [torch.where(ok, xi, 0.0) for xi in x]

    # se3 exp of (v, w) = (x[0:3], x[3:6])
    wx, wy, wz = x[3], x[4], x[5]
    tsq = wx * wx + wy * wy + wz * wz
    ts = torch.clamp_min(tsq, 1e-8)
    theta = torch.sqrt(ts)
    small = tsq < 1e-8
    sin_t = torch.sin(theta)
    ca = torch.where(small, 1.0 - tsq / 6.0, sin_t / theta)
    cb = torch.where(small, 0.5 - tsq / 24.0, (1.0 - torch.cos(theta)) / ts)
    cc = torch.where(small, 1.0 / 6.0 - tsq / 120.0, (theta - sin_t) / (ts * theta))
    zero = torch.zeros_like(wx)
    W = [[zero, -wz, wy], [wz, zero, -wx], [-wy, wx, zero]]
    E = [[None] * 4 for _ in range(4)]
    for i in range(3):
        V = [None] * 3
        for j in range(3):
            ww = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j]
            eye = 1.0 if i == j else 0.0
            E[i][j] = eye + ca * W[i][j] + cb * ww
            V[j] = eye + cb * W[i][j] + cc * ww
        E[i][3] = V[0] * x[0] + V[1] * x[1] + V[2] * x[2]
    E[3] = [zero, zero, zero, zero + 1.0]

    N = [[E[i][0] * T[..., 0, j] + E[i][1] * T[..., 1, j] + E[i][2] * T[..., 2, j]
          + E[i][3] * T[..., 3, j] for j in range(4)] for i in range(4)]
    for _ in range(2):  # R <- R (1.5 I - 0.5 R^T R)
        Q = [[(1.5 if i == j else 0.0)
              - 0.5 * (N[0][i] * N[0][j] + N[1][i] * N[1][j] + N[2][i] * N[2][j])
              for j in range(3)] for i in range(3)]
        R = [[N[i][0] * Q[0][j] + N[i][1] * Q[1][j] + N[i][2] * Q[2][j]
              for j in range(3)] for i in range(3)]
        for i in range(3):
            N[i][:3] = R[i]
    return torch.stack([torch.stack(row, dim=-1) for row in N], dim=-2)
