"""A backend pass that closed a loop, in plain torch, float32: from the
job's own snapshot and edge list, local BA, the pose graph with the loop
edge, each point riding with its anchor keyframe, landmark fusion across
the loop, and the bounded global BA with its trust region.

Verification draws random triples, so the loop edge itself (the candidate
slot and the relative pose `T_rel`) is an input, the program's verified
edge, as the tracking check takes the program's motion prior. Everything
after it is worked out again here. The maths follow the port's
(`backend/worker.py`, `backend/pose_graph.py`); no step departs from it:

  * the pose graph is Gauss-Newton with a Jacobi-scaled conjugate gradient
    solve from a zero start (tolerance 1e-5, at most 256 iterations): the
    port's inexact step. A dense solve in its place reads about 1e-4 mm
    apart on the CPU test's loop scene, so either would pass; the CG keeps
    the sound reading at the rounding of the sums;
  * fusion matches the query and candidate keyframes by the least Hamming
    distance (the first index among equal distances), Lowe's ratio 0.9,
    the absolute threshold 64 and a mutual cross-check, and keeps a match
    that the loop transform carries to within 6 cm; the gain and loss of
    observations are integer sums;
  * the global BA takes the newest `global_ba_window` keyframes with the
    oldest valid one as gauge, the `global_ba_points` most observed points
    of the fused observation graph (ties to the higher id),
    `global_ba_iters` LM iterations, and is kept only if every pose is
    finite, the rmse is under 1e3 px and no keyframe moved more than
    `global_ba_max_move`.

Every matrix product goes through `precision`, so that the check's control
is this same code with TF32 products."""

from __future__ import annotations

import torch

from portbench.reference import ba as ref_ba
from portbench.reference import se3
from portbench.reference.precision import mm

LOOP_EDGE_WEIGHT = 5.0
FUSE_MAX_DISTANCE = 64.0
FUSE_RATIO = 0.9
FUSE_RADIUS_M = 0.06
CG_TOL = 1e-5
CG_MAXITER = 256
BIG = 1e9


# ---------------------------------------------------------------- SE(3)
def _vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector, with the branch near pi."""
    Rt = R.transpose(-1, -2)
    trace = torch.clamp(R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], -1.0, 3.0)
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)[..., None]
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    v = _vee(R - Rt)
    w_generic = v * torch.where(torch.abs(sin_theta) < 1e-6, 0.5,
                                theta / (2.0 * torch.clamp_min(sin_theta, 1e-20)))
    w_small = v * 0.5 * (1.0 + theta * theta / 6.0)
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    w_sq = torch.clamp_min((diag - cos_theta) / torch.clamp_min(1.0 - cos_theta, 1e-12), 0.0)
    w_abs = theta * torch.sqrt(w_sq)
    S = 0.5 * (R + Rt)
    one = torch.ones_like(trace)
    s01, s02, s12 = (torch.sign(S[..., 0, 1]), torch.sign(S[..., 0, 2]),
                     torch.sign(S[..., 1, 2]))
    signs_all = torch.stack([torch.stack([one, s01, s02], dim=-1),
                             torch.stack([s01, one, s12], dim=-1),
                             torch.stack([s02, s12, one], dim=-1)], dim=-2)
    k = torch.argmax(w_abs, dim=-1)[..., None, None].expand(w_abs.shape[:-1] + (1, 3))
    signs = torch.gather(signs_all, -2, k)[..., 0, :]
    signs = torch.where(signs == 0.0, 1.0, signs)
    return torch.where(theta < 1e-4, w_small, torch.where(theta > 3.0, w_abs * signs,
                                                          w_generic))


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta_sq = (w * w).sum(dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta_sq, 1e-8))
    W = se3.hat(w)
    half = 0.5 * theta
    cot = torch.where(theta_sq < 1e-8, 1.0 / 12.0 + theta_sq / 720.0,
                      (1.0 - half * torch.cos(half) / torch.clamp_min(torch.sin(half), 1e-20))
                      / torch.clamp_min(theta_sq, 1e-8))
    eye3 = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye3 - 0.5 * W + cot[..., None, None] * mm(W, W)


def log(T: torch.Tensor) -> torch.Tensor:
    """4x4 transform -> twist (v, w)."""
    w = _so3_log(T[..., :3, :3])
    v = mm(_left_jacobian_inv(w), T[..., :3, 3:])[..., 0]
    return torch.cat([v, w], dim=-1)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """[[R, hat(t) R], [0, R]] for (v, w) twists."""
    R = T[..., :3, :3]
    top = torch.cat([R, mm(se3.hat(T[..., :3, 3]), R)], dim=-1)
    return torch.cat([top, torch.cat([torch.zeros_like(R), R], dim=-1)], dim=-2)


# ----------------------------------------------------------- pose graph
def _cg(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A x = b from x = 0 while |r|^2 > tol^2 |b|^2, at most CG_MAXITER
    iterations."""
    x = torch.zeros_like(b)
    r, p = b.clone(), b.clone()
    gamma = torch.dot(r, r)
    atol2 = CG_TOL * CG_TOL * torch.dot(b, b)
    for _ in range(CG_MAXITER):
        if not bool(gamma > atol2):
            break
        Ap = mm(A, p)
        alpha = gamma / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = torch.dot(r, r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
    return x


def pose_graph(poses, node_valid, ei, ej, T_meas, weight, iters: int, damping: float):
    """Gauss-Newton over the keyframe poses, the first valid node as gauge:
    residual log(T_meas^-1 T_i^-1 T_j) an edge, J_j = I,
    J_i = -Ad(T_j^-1 T_i), right-multiplied updates. `weight` is 0 on an
    unused edge slot. -> (M, 4, 4)."""
    M = poses.shape[0]
    D = 6 * M
    dev = poses.device
    nodes = torch.arange(M, device=dev)
    first = torch.where(node_valid, nodes, M).amin()
    free = node_valid & (nodes != first)
    fmask = free.repeat_interleave(6)
    ew = weight[:, None, None]
    eye6 = torch.eye(6, device=dev)
    T = poses
    for _ in range(iters):
        Ti, Tj = T[ei], T[ej]
        r = log(mm(mm(se3.inverse(T_meas), se3.inverse(Ti)), Tj))
        Ji = -adjoint(mm(se3.inverse(Tj), Ti))
        Jiw = Ji * ew
        Hii = mm(Ji.transpose(-1, -2), Jiw)
        Hij = Ji.transpose(-1, -2) * ew
        gi = mm(Jiw.transpose(-1, -2), r[..., None])[..., 0]
        gj = r * ew[:, :, 0]
        Hb = ref_ba.scatter_sum(
            torch.cat([ei * M + ei, ej * M + ej, ei * M + ej, ej * M + ei]),
            torch.cat([Hii, eye6 * ew, Hij, Hij.transpose(-1, -2)]), M * M)
        g = ref_ba.scatter_sum(torch.cat([ei, ej]), torch.cat([gi, gj]), M)
        H = Hb.reshape(M, M, 6, 6).transpose(1, 2).reshape(D, D)
        H = torch.where(fmask[:, None] & fmask[None, :], H, 0.0)
        H = H + torch.diag(torch.where(fmask, damping, 1.0))
        gv = torch.where(fmask, g.reshape(D), 0.0)
        s = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(H), 1e-12))
        d = (_cg(H * s[:, None] * s[None, :], -gv * s) * s).reshape(M, 6)
        T = torch.where(free[:, None, None], se3.normalize_rotation(mm(T, se3.exp(d))), T)
    return T


def ride_with_anchors(kf_old, kf_new, pt_xyz, pt_valid, pt_first_kf):
    """Each valid point moves with its first-observing keyframe."""
    anchor = torch.clamp(pt_first_kf, 0, kf_old.shape[0] - 1).long()
    delta = mm(kf_new[anchor], se3.inverse(kf_old[anchor]))
    moved = mm(delta[:, :3, :3], pt_xyz[..., None])[..., 0] + delta[:, :3, 3]
    return torch.where(pt_valid[:, None], moved, pt_xyz)


# --------------------------------------------------------------- fusion
def _top2(s1, ok1, s2, ok2):
    """Per row of set 1: (least distance, second least, first index of the
    least) against set 2; invalid pairs are BIG."""
    d = 0.5 * (s1.shape[-1] - mm(s1.to(torch.float32), s2.to(torch.float32).T))
    d = torch.where(ok1[:, None] & ok2[None, :], d, BIG)
    best = d.min(dim=1, keepdim=True).values
    col = torch.arange(d.shape[1], device=d.device)
    idx = torch.where(d <= best, col, d.shape[1]).min(dim=1).values
    second = torch.where(col == idx[:, None], BIG, d).min(dim=1).values
    return best[:, 0], second, idx


def fuse(snap, query: int, cand: int, T_rel):
    """Landmark fusion across the loop. -> (fused observation graph (M, K),
    the query's new row (K,), ghost points (P,), observation-count change
    (P,), fused observations)."""
    P = snap.pt_xyz.shape[0]
    s_q, ok_q = snap.kp_signs[query], snap.kp_ok[query]
    s_c, ok_c = snap.kp_signs[cand], snap.kp_ok[cand]
    best, second, idx = _top2(s_q, ok_q, s_c, ok_c)
    rows = torch.arange(s_q.shape[0], device=s_q.device)
    _, _, back = _top2(s_c, ok_c, s_q, ok_q)
    ok = ((best < FUSE_MAX_DISTANCE) & (best < FUSE_RATIO * second) & ok_q
          & (back[idx] == rows))
    p1, p2 = snap.kp_pts[query], snap.kp_pts[cand][idx]
    pred = mm(p1, T_rel[:3, :3].T) + T_rel[:3, 3]
    inl = ok & (torch.linalg.norm(pred - p2, dim=-1) < FUSE_RADIUS_M)
    q_row = snap.point_id[query].long()
    c_pid = snap.point_id[cand].long()[idx]
    fused = inl & (c_pid >= 0) & (q_row != c_pid)
    row = torch.where(fused, c_pid, q_row)

    def count(ids, keep):
        out = torch.zeros(P + 1, dtype=torch.int64, device=ids.device)
        return out.index_add_(0, torch.where(keep, ids, P), torch.ones_like(ids))[:P]

    gain, lose = count(c_pid, fused), count(q_row, fused & (q_row >= 0))
    delta = gain - lose
    ghost = (snap.pt_valid & (snap.pt_first_kf.long() == query) & (lose > 0)
             & (snap.pt_nobs.long() + delta <= 0))
    pid = snap.point_id.long().clone()
    pid[query] = row
    pid = torch.where(ghost[pid.clamp_min(0)] & (pid >= 0), -1, pid)
    return pid, row, ghost, delta, int(fused.sum())


# ------------------------------------------------------------ global BA
def _window_solve(kf_pose, idx, valid, free, pt_xyz, kp_uv, kp_pts, point_id, kp_ok, cam,
                  settings, budget: int, iters: int):
    """LM over the keyframes `idx` (`free` ones move) and their `budget`
    most observed points. -> (window poses, points (P, 3), solved (P,),
    rmse px over the active observations)."""
    dev = kf_pose.device
    P = pt_xyz.shape[0]
    obs_pid, obs_ok = point_id[idx], kp_ok[idx] & valid[:, None]
    obs_uv, obs_z = kp_uv[idx], kp_pts[idx][..., 2]
    C = min(budget, P)
    ok = obs_ok & (obs_pid >= 0)
    pid_safe = torch.where(ok, obs_pid, P).long()
    flat = pid_safe.reshape(-1)
    n_obs = ref_ba.scatter_sum(flat, torch.ones(flat.shape, dtype=torch.int32, device=dev),
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
    settings.iters = iters
    cost_fn, lm_iter = ref_ba._make_lm(valid, obs_uv, obs_z, pid_c, ok_c, cam, settings,
                                       free, C)
    lam = torch.full((), settings.damping, dtype=torch.float32, device=dev)
    state = (kf_pose[idx], pt_c, lam, cost_fn(kf_pose[idx], pt_c))
    for _ in range(iters):
        state = lm_iter(state)
    poses_w, X = state[:2]
    r, _, _, mask = ref_ba._reproj_residuals(poses_w, X, obs_uv, obs_z, pid_c,
                                             ok_c & valid[:, None], cam)
    n = mask.sum()
    rmse = torch.sqrt(torch.where(mask, (r * r).sum(dim=-1), 0.0).sum()
                      / torch.clamp_min(n, 1))
    pts = torch.cat([pt_xyz, torch.zeros((1, 3), device=dev)]).index_copy(0, sel, X)[:P]
    solved = torch.zeros((P + 1,), dtype=torch.bool, device=dev).index_fill_(0, sel, True)[:P]
    return poses_w, pts, solved, rmse


def global_ba(kf_pose, pt_xyz, point_id, snap, n_kf: int, cam, ba: dict):
    """The bounded global BA on the pose-graph state. -> (poses (M, 4, 4),
    points (P, 3), solved (P,), applied)."""
    M = kf_pose.shape[0]
    W = min(ba["global_ba_window"], M)
    dev = kf_pose.device
    idx = n_kf - W + torch.arange(W, device=dev)
    valid = (idx >= 0) & (idx < n_kf)
    idx = torch.clamp(idx, 0, M - 1)
    gauge = ref_ba._first_true(valid)
    free = valid & (torch.arange(W, device=dev) != gauge)
    win_in = kf_pose[idx]
    poses_w, pts, solved, rmse = _window_solve(
        kf_pose, idx, valid, free, pt_xyz, snap.kp_uv, snap.kp_pts, point_id, snap.kp_ok,
        cam, ref_ba._Settings(ba), ba["global_ba_points"], ba["global_ba_iters"])
    move = torch.where(valid, torch.linalg.norm(poses_w[:, :3, 3] - win_in[:, :3, 3],
                                                dim=-1), 0.0).amax()
    applied = bool(torch.isfinite(poses_w).all() & (rmse < 1e3)
                   & (move <= ba["global_ba_max_move"]))
    if not applied:
        return kf_pose, pt_xyz, torch.zeros_like(solved), False
    pad = torch.cat([kf_pose, torch.zeros((1, 4, 4), device=dev)])
    poses = pad.index_copy(0, torch.where(valid, idx, M), poses_w)[:M]
    solved = solved & torch.isfinite(pts).all(dim=-1)
    return poses, torch.where(solved[:, None], pts, pt_xyz), solved, True


# ------------------------------------------------------------ the pass
def closing_pass(snap, edges: tuple, n_edges: int, kf_idx: int, n_kf: int, cand: int,
                 T_rel, cam, ba: dict) -> dict:
    """The pass that closed the loop cand -> kf_idx with the measurement
    `T_rel`, from the job's snapshot `snap` (an object with the map's
    tensors as attributes: `kf_pose`, `kf_valid`, `kp_uv`, `kp_pts`,
    `kp_ok`, `kp_signs`, `pt_xyz`, `pt_valid`, `pt_first_kf`, `pt_nobs`,
    `point_id`) and its edge list `edges` = (i, j, T_meas, weight, valid)
    with `n_edges` in use. -> {kf_pose, pt_xyz, pt_adjusted, fuse_row,
    pt_invalidate, pt_nobs_delta, n_fused, global_applied}."""
    kf_pose, pt_xyz = snap.kf_pose, snap.pt_xyz
    P = pt_xyz.shape[0]
    dev = kf_pose.device
    adjusted = torch.zeros((P,), dtype=torch.bool, device=dev)
    if n_kf >= 3:
        kf_pose, pt_xyz, adjusted = ref_ba.window_ba(
            kf_pose, n_kf, pt_xyz, snap.kp_uv, snap.kp_pts, snap.point_id, snap.kp_ok, cam, ba)

    ei, ej, T_meas, weight, valid = (t.clone() for t in edges)
    if n_edges < ei.shape[0]:  # a full list drops the edge, as the program's does
        ei[n_edges], ej[n_edges], T_meas[n_edges] = cand, kf_idx, T_rel
        weight[n_edges], valid[n_edges] = LOOP_EDGE_WEIGHT, True
    w = torch.where(valid, weight, 0.0)
    pg = pose_graph(kf_pose, snap.kf_valid, ei.long(), ej.long(), T_meas, w,
                    ba["pg_iters"], ba["pg_damping"])
    pt_xyz = ride_with_anchors(kf_pose, pg, pt_xyz, snap.pt_valid, snap.pt_first_kf)
    adjusted = adjusted | snap.pt_valid
    kf_pose = pg

    pid, row, ghost, delta, n_fused = fuse(snap, kf_idx, cand, T_rel)
    applied = False
    if ba["global_ba_iters"] > 0 and n_kf >= 3:
        kf_pose, pt_xyz, solved, applied = global_ba(kf_pose, pt_xyz, pid, snap, n_kf, cam, ba)
        adjusted = adjusted | solved
    return {"kf_pose": kf_pose, "pt_xyz": pt_xyz, "pt_adjusted": adjusted, "fuse_row": row,
            "pt_invalidate": ghost, "pt_nobs_delta": delta, "n_fused": n_fused,
            "global_applied": applied}

