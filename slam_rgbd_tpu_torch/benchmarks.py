"""Benchmark suite: the full SLAM session on one device, its legs, and the
kernels against the card's peaks.

Counterpart of `slam_rgbd_tpu/benchmarks.py`, run as

    python -m slam_rgbd_tpu_torch benchmark [--frames N] [--no-legs] [--device cpu]

It prints ONE JSON line: `metric` (frames/s of the threaded session at
640x480, odometry plus mapping), `value`, `unit`, `vs_baseline` (against
the reference's 30 fps), and

  * `session_*`, `keyframes`, `map_points`, `loops`, `backend_jobs`: the
    threaded `SLAMSession` over an out-and-back sweep, the better of two
    runs by wall clock (`bench_session`);
  * `tracking_*`: the tracked frame alone, as the session replays it (one
    CUDA graph a frame on a card) and eagerly (`bench_tracking`);
  * `kernel_sol`: the four kernels' device times against the card's peaks
    (`bench_kernels`; skipped off the card);
  * `ba_*`: local BA ms an iteration on the backend's window shape
    (`bench_ba`);
  * `scaling`: batched tracking at B = 1, 2, 4, 8 on one device;
  * `degraded_leg` and `loop_leg`: the sweep through the sensor model, and
    a sweep under injected odometry drift with the loop search off and on;
  * `kernel_launches`: the kernels' launches over the whole run but the
    kernel timings; `device` and `power_limit_w`: the card's name and power
    limit.

On a card every call time comes from CUDA events between calls and every
kernel time from `runtime.profiling.device_ms`; on the CPU (`device="cpu"`,
for tests) times are the host clock's and the kernel roofline is skipped.
The JAX package's link workarounds (`_time_device`, `_time_device_chain`,
`_trace_device_us`, `measure_rig`, the fraction cap, the compile cache) have
no counterpart: events on a queued stream see every call.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from slam_rgbd_tpu_torch.core.config import SLAMConfig, astra_default_config
from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse
from slam_rgbd_tpu_torch.io.synthetic import (
    NoiseSpec, SceneSpec, noisy_frame, orbit_trajectory, render_frame,
)
from slam_rgbd_tpu_torch.runtime import profiling
from slam_rgbd_tpu_torch.runtime.session import SLAMSession, _resolve_device

BASELINE_FPS = 30.0  # the reference's real-time operating target
STEADY_FROM = 10  # calls before this warm up (the graph's capture, allocator)
KERNEL_TIMING_CALLS = 50  # calls a kernel's device median is taken over
# the loop leg: a constant twist composed onto every tracked relative pose
LOOP_LEG_DRIFT = (0.006, 0.0, 0.003, 0.0, 0.003, 0.0)
METRIC = "slam_session_fps_640x480_odometry_plus_mapping"


def _note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------- workloads
def _render_sequence(cfg: SLAMConfig, n_frames: int, return_gt: bool = False,
                     noise: NoiseSpec | None = None, device="cuda"):
    """The out-and-back sweep rendered on `device`: a list of (ts, depth,
    rgb), and with `return_gt` the (n, 4, 4) ground-truth poses. The second
    half revisits the first half's views. With `noise`, every frame goes
    through the port's sensor model on the device (`io.synthetic.
    noisy_frame`); its draws come from torch generators seeded per frame,
    not from `jax.random`, so a degraded frame is not the JAX package's bit
    for bit. Frames stay on the device, as in the JAX package's bench."""
    dev = _resolve_device(device)
    cam = cfg.camera
    poses = orbit_trajectory(n_frames, SceneSpec(), sweep=True)
    frames = []
    for i in range(n_frames):
        d, c = render_frame(poses[i], cam, SceneSpec(), device=dev)
        if noise is not None:
            d, c = noisy_frame(d, c, i, poses, cam, noise, cam.fps)
        frames.append((i / cam.fps, d, c))
    if return_gt:
        return frames, poses
    return frames


def ba_workload(cfg: SLAMConfig, seed: int = 0) -> dict:
    """The backend's local-BA shape with consistent geometry, as numpy
    arrays (the JAX package's `bench_ba` draws, in its order): W = 2 x window
    keyframes, K = n_features observations each, the full P-point table,
    ids drawn from a window-sized subset of it (points recur across
    keyframes), sub-pixel noise; the older half of the window fixed."""
    cam = cfg.camera
    W = 2 * cfg.ba.window
    K = cfg.orb.n_features
    P = cfg.keyframes.max_map_points
    img_w, img_h = 2.0 * cam.cx, 2.0 * cam.cy  # principal point at center

    rng = np.random.default_rng(seed)
    pts = np.stack(
        [
            rng.uniform(-2.0, 2.0, P),
            rng.uniform(-1.5, 1.5, P),
            rng.uniform(1.0, 4.0, P),
        ],
        axis=1,
    ).astype(np.float32)

    poses = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    for i in range(W):
        a = 0.02 * i
        ca, sa = np.cos(a), np.sin(a)
        poses[i, :3, :3] = np.array(
            [[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32
        )
        poses[i, :3, 3] = [0.05 * i, 0.0, -0.02 * i]

    window_ids = rng.choice(P, cfg.ba.max_points_per_window, replace=False)
    pid = window_ids[rng.integers(0, len(window_ids), (W, K))].astype(np.int32)
    obs_uv = np.zeros((W, K, 2), np.float32)
    obs_z = np.zeros((W, K), np.float32)
    obs_ok = np.zeros((W, K), bool)
    for i in range(W):
        T_cw = np.linalg.inv(poses[i])
        p_c = pts[pid[i]] @ T_cw[:3, :3].T + T_cw[:3, 3]
        z = p_c[:, 2]
        u = cam.fx * p_c[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * p_c[:, 1] / np.maximum(z, 1e-6) + cam.cy
        obs_uv[i, :, 0] = u + rng.normal(0, 0.5, K)
        obs_uv[i, :, 1] = v + rng.normal(0, 0.5, K)
        obs_z[i] = z
        obs_ok[i] = (z > 0.1) & (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)

    return {"poses": poses, "valid": np.ones((W,), bool), "pts": pts,
            "obs_uv": obs_uv, "obs_z": obs_z, "pid": pid, "obs_ok": obs_ok,
            "free": np.arange(W) >= cfg.ba.window}


def loop_leg_config(cfg: SLAMConfig, loop_on: bool) -> SLAMConfig:
    """The loop leg's settings: drift injected into every tracked relative
    pose, a keyframe every 6 cm, a loop candidate every 5 keyframes with a
    cooldown of 3; with the search off, a score no candidate reaches."""
    return cfg.replace(
        icp=dataclasses.replace(cfg.icp, drift_xi=LOOP_LEG_DRIFT),
        keyframes=dataclasses.replace(cfg.keyframes, kf_min_trans=0.06),
        ba=dataclasses.replace(
            cfg.ba, loop_min_interval=5, loop_cooldown_kf=3,
            loop_min_score=(cfg.ba.loop_min_score if loop_on else 2.0),
        ),
    )


def tracking_only_config(cfg: SLAMConfig) -> SLAMConfig:
    """`cfg` with the keyframe thresholds out of reach: every call after the
    bootstrap only tracks."""
    never = dataclasses.replace(cfg.keyframes, kf_min_trans=1e9, kf_min_rot_deg=1e9,
                                kf_min_inlier_ratio=0.0)
    return dataclasses.replace(cfg, keyframes=never)


# ------------------------------------------------------------------- timing
def sweep(sess: SLAMSession, frames, fps: float, merges: list | None = None,
          pass_ms: list | None = None):
    """Drive `sess` over (depth, rgb) frames. -> (ms of every call, which
    calls inserted a keyframe, wall seconds). On a card a call's ms comes
    from CUDA events recorded between calls; on the CPU from the host
    clock. A frame's keyframe decision is applied in a later call, so the
    insert is charged to the call that made it. With `merges`, it gets one
    flag a call: the call merged a backend result; with `pass_ms`, the host
    ms of each merged result's pass (`BackendResult.backend_ms`)."""
    cuda = sess.device.type == "cuda"
    if cuda:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(frames) + 1)]
    else:
        marks = [0.0] * (len(frames) + 1)

    def mark(i):
        if cuda:
            marks[i].record()
        else:
            marks[i] = time.perf_counter()

    kf_calls = []
    applied = [0]
    real_apply = sess._apply_backend

    def apply(r):
        applied[0] += r is not None
        if r is not None and pass_ms is not None:
            pass_ms.append(r.backend_ms)
        return real_apply(r)

    sess._apply_backend = apply
    mark(0)
    wall0 = time.perf_counter()
    try:
        for i, (depth, rgb) in enumerate(frames):
            before, merged = sess.state.keyframes, applied[0]
            sess.process_frame(i / fps, depth, rgb)
            mark(i + 1)
            kf_calls.append(sess.state.keyframes > before)
            if merges is not None:
                merges.append(applied[0] > merged)
        sess.flush_pipeline()
        if cuda:
            torch.cuda.synchronize(sess.device)
    finally:
        del sess._apply_backend
    wall = time.perf_counter() - wall0
    if cuda:
        ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(len(frames))]
    else:
        ms = [1e3 * (marks[i + 1] - marks[i]) for i in range(len(frames))]
    return np.array(ms), np.array(kf_calls), wall


def _pairs(frames) -> list:
    return [(d, c) for _, d, c in frames]


def _percentiles(ms) -> tuple:
    """(p50, p99) of some call times; (None, None) for none."""
    if len(ms) == 0:
        return None, None
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


# ------------------------------------------------------------------ benches
def bench_tracking(cfg: SLAMConfig, frames, iters: int = 120) -> dict:
    """The steady-state tracked frame alone: a session whose keyframe
    thresholds are out of reach over the first eight frames, back and forth
    (each call one frame's motion; the tracker's reversed start takes the
    turns), `iters` tracked calls. Once as the session runs on its device
    (one frame-graph replay a call on a card) and once with
    `cuda_graph=False`; the two give the same poses bit for bit. frames/s
    and p50 / p99 over the calls from STEADY_FROM on."""
    never = tracking_only_config(cfg)
    k = min(8, len(frames))
    period = max(2 * (k - 1), 1)
    order = [i % period if i % period < k else period - i % period
             for i in range(iters + 1)]
    seq = [(frames[i][1], frames[i][2]) for i in order]
    out, poses = {}, []
    for graph in (True, False):
        dev = frames[0][1].device
        sess = SLAMSession(never, device=dev, cuda_graph=(None if graph else False))
        try:
            ms, _, _ = sweep(sess, seq, cfg.camera.fps)
            if sess.state.keyframes != 1:
                raise RuntimeError(f"the tracking bench inserted {sess.state.keyframes - 1} "
                                   "keyframes")
            if sess._graph is not None and sess._graph.captures != 1:
                raise RuntimeError(f"the frame graph captured {sess._graph.captures} times")
            poses.append(sess.poses()[1])
        finally:
            sess.close()
        steady = ms[STEADY_FROM:]
        fps = len(steady) / float(steady.sum() / 1e3)
        if graph:
            p50, p99 = _percentiles(steady)
            out.update(tracking_fps=fps, tracking_p50_ms=p50, tracking_p99_ms=p99)
        else:
            out["tracking_fps_eager"] = fps
    if not np.array_equal(poses[0], poses[1]):
        raise RuntimeError("the session's tracked frames and the eager step give other poses "
                           f"(largest difference {np.abs(poses[0] - poses[1]).max():.3e})")
    return out


# The work of each kernel's call for its bound: (bytes read and written
# once, float32 operations, int8 operations), as `profiling.roofline` takes
# them.
def gn_work(n_b: int, n_sets: int, n_px: int) -> tuple[float, float, float]:
    """The work of a GN launch: each plane set, pose and
    flow read once, 60 values a problem written (H, g, sq_sum, inliers, the
    next pose); ~300 operations a pixel (projection, four-corner sampling of
    ten channels, two 7-vector outer products) and ~500 a problem for the
    pose update."""
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg

    n_bytes = 4.0 * (n_sets * (tg.SRC_CHANNELS + tg.TGT_CHANNELS) * n_px + n_b * (18 + 60))
    return n_bytes, n_b * (300.0 * n_px + 500.0), 0.0


def top2_work(n1: int, n2: int, pairs: float) -> tuple[float, float, float]:
    """The work of `hamming_top2`: both sign tables and validity masks read
    once, 12 bytes a query written; 256 multiply-adds a pair that this run's
    masks leave."""
    return (n1 + n2) * (256 + 1) + n1 * 12, 0.0, 2.0 * 256 * pairs


def gated_work(k1: int, k2: int, pairs: float) -> tuple[float, float, float]:
    """The work of `gated_match`: signs and gate data read once, 16 bytes a
    query written; the sign product of every valid query x valid point, and
    ~17 float operations a pair for the two gates."""
    return (k1 + k2) * (256 + 32) + k1 * 16, 17.0 * pairs, 2.0 * 256 * pairs


def full_map(m, seed: int = 0):
    """`m` with every free point slot filled: each takes the descriptor of a
    valid point (cyclically) with eight of its bits flipped and the point's
    position moved by up to 3 cm, so that every slot is valid, near copies
    tie and the gates see a crowded map."""
    free = (~m.pt_valid).nonzero()[:, 0]
    src = m.pt_valid.nonzero()[:, 0]
    pick = src[torch.arange(len(free), device=src.device) % len(src)]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    signs, xyz = m.pt_signs.clone(), m.pt_xyz.clone()
    flips = torch.rand((len(free), 256), generator=gen).argsort(dim=1)[:, :8]
    row = signs[pick]
    row.scatter_(1, flips.to(row.device), -row.gather(1, flips.to(row.device)))
    signs[free] = row
    xyz[free] = m.pt_xyz[pick] + 0.03 * (
        2 * torch.rand((len(free), 3), generator=gen) - 1).to(xyz.device)
    return dataclasses.replace(m, pt_signs=signs, pt_xyz=xyz,
                               pt_valid=torch.ones_like(m.pt_valid))


def gated_match_args(m, desc, ok, kp, pts, T, cfg: SLAMConfig):
    """The arguments `match_against_map` hands `gated_match` for this query
    against map `m` -> (args, keywords, the point ids it returns)."""
    from slam_rgbd_tpu_torch.mapping import map as smap

    args, kw = smap.association_inputs(
        m.pt_xyz, m.pt_signs, m.pt_valid, desc.signs, ok, kp.uv, pts[:, 2], T,
        cfg.camera, smap.PX_RADIUS, smap.Z_REL_TOL, pts, cfg.keyframes.merge_radius)
    pid = smap.match_against_map(
        m, desc.signs, ok, kp.uv, pts[:, 2], T, cam=cfg.camera,
        max_distance=float(cfg.orb.match_threshold), kp_pts=pts,
        merge_radius=cfg.keyframes.merge_radius)
    return args, kw, pid


def hamming_top2_library(signs1, valid1, signs2, valid2):
    """What PyTorch's library gives for `hamming_top2`: a bf16 matrix
    product of the signs (exact: every product sum is an integer in
    [-256, 256]), the distances 0.5 (256 - s) with invalid pairs at 1e9, and
    `torch.topk(k=2, largest=False)`. -> (best, second, index of best); the
    index may differ from the kernel's first index where distances tie."""
    s = torch.matmul(signs1.to(torch.bfloat16), signs2.to(torch.bfloat16).T)
    d = torch.where(valid1[:, None] & valid2[None, :],
                    0.5 * (signs1.shape[1] - s.float()), 1e9)
    vals, idx = torch.topk(d, 2, dim=1, largest=False)
    return vals[:, 0], vals[:, 1], idx[:, 0]


def bench_kernels(cfg: SLAMConfig, frames) -> dict:
    """The four kernels' device medians against the card's peaks, at the
    shapes the main path gives them: K1 on the finest level of two rendered
    frames with the flow shift applied, K1b on four such pairs, K3 with a
    rendered frame's 1024 keypoints against a map of rendered keyframes
    with every slot filled, K2 on random signs (all valid) with the library
    comparator beside it. Off the card: skipped."""
    dev = frames[0][1].device
    if dev.type != "cuda":
        return {"kernel_sol": "skipped (no CUDA device)"}
    from slam_rgbd_tpu_torch.core import camera
    from slam_rgbd_tpu_torch.features import detect as fdetect
    from slam_rgbd_tpu_torch.mapping import map as smap
    from slam_rgbd_tpu_torch.odometry import icp
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg
    from slam_rgbd_tpu_torch.ops import hamming as th
    from slam_rgbd_tpu_torch.runtime import session as rs

    cam, icfg, kcfg = cfg.camera, cfg.icp, cfg.keyframes
    card = torch.cuda.get_device_name(dev)
    n = KERNEL_TIMING_CALLS
    out = {}

    def entry(fn, n_bytes, f32_ops=0.0, int8_ops=0.0, **extra):
        ms, busy = profiling.device_ms(fn, n)
        return {**profiling.roofline(n_bytes, ms / 1e3, f32_ops, int8_ops, card),
                "busy_share": busy, **extra}

    # ---- K1 / K1b: the finest level, frames (i, i + 1), pose I, the flow
    # shift applied as the tracker applies it
    b = 4
    depth = torch.stack([frames[i][1] for i in range(b + 1)])
    rgb = torch.stack([frames[i][2] for i in range(b + 1)])
    pyr = camera.build_frame_pyramid(depth, cam, levels=icfg.levels, rgb=rgb)
    _, radius = icp._level_schedule(icfg, icfg.levels, 0)
    planes = icp.level_planes(pyr[0])
    src = planes[:b, : tg.SRC_CHANNELS].contiguous()
    tgt = planes[1:].contiguous()
    T = torch.eye(4, device=dev).repeat(b, 1, 1)
    _, up, vp, _ = icp._project_level(T, pyr[0]["vertices"][:b], cam)
    mu = icp.flow_shift(up, vp, cam.height, cam.width)
    n_px = cam.height * cam.width
    one = (T[0], mu[0], src[0], tgt[0], cam, icfg, radius)
    step_ms, _ = profiling.device_ms(lambda: tg.gn_step(*one), n)
    out[f"gn_reduce_{cam.width}x{cam.height}"] = entry(
        lambda: tg.gn_reduce(*one), *gn_work(1, 1, n_px), step_us=step_ms * 1e3)
    batch = (T, mu, src, tgt, cam, icfg, radius)
    step_ms, _ = profiling.device_ms(lambda: tg.gn_step_batched(*batch), n)
    out[f"gn_reduce_batched_{cam.width}x{cam.height}_b{b}"] = entry(
        lambda: tg.gn_reduce_batched(*batch), *gn_work(b, b, n_px), step_us=step_ms * 1e3)

    # ---- K3: a map of rendered keyframes (every 12th frame of the sweep's
    # first 72) at their true poses, every free slot then filled; the query
    # a frame between two of them, at a pose 1 cm off
    gt = orbit_trajectory(len(frames), SceneSpec(), sweep=True)
    rel = (np.linalg.inv(gt[0]) @ gt).astype(np.float32)
    n_kp = sum(fdetect._per_level_budget(cfg.orb.n_features, cfg.orb.n_levels,
                                         cfg.orb.scale_factor))
    m = smap.empty_map(kcfg, n_kp, dev)
    none = torch.full((n_kp,), -1, dtype=torch.int32, device=dev)
    for i in range(0, min(72, len(frames)), 12):
        kp, desc, pts, ok = rs._features(frames[i][1], frames[i][2], cfg.orb, cam)
        m = smap.insert_keyframe(m, torch.from_numpy(rel[i]).to(dev), frames[i][0],
                                 kp.uv, pts, ok, desc.signs, none)
    crowd = full_map(m)
    q = min(30, len(frames) - 1)
    kp, desc, pts, ok = rs._features(frames[q][1], frames[q][2], cfg.orb, cam)
    T_q = torch.from_numpy(rel[q]).to(dev).clone()
    T_q[0, 3] += 0.01
    g_args, g_kw, _ = gated_match_args(crowd, desc, ok, kp, pts, T_q, cfg)
    k1, k2 = g_args[0].shape[0], g_args[2].shape[0]
    pairs = float(g_args[1][:, 3].sum()) * float(g_args[3][:, 3].sum())
    out[f"gated_match_{k1}x{k2}"] = entry(
        lambda: th.gated_match(*g_args, **g_kw), *gated_work(k1, k2, pairs),
        unmasked_pairs=pairs)

    # ---- K2: random signs, every row valid (the JAX bench's draws)
    K1, K2 = cfg.orb.n_features, kcfg.max_map_points
    rng = np.random.default_rng(0)
    s1 = torch.from_numpy(rng.choice([-1, 1], (K1, 256)).astype(np.int8)).to(dev)
    s2 = torch.from_numpy(rng.choice([-1, 1], (K2, 256)).astype(np.int8)).to(dev)
    v1 = torch.ones(K1, dtype=torch.bool, device=dev)
    v2 = torch.ones(K2, dtype=torch.bool, device=dev)
    args = (s1, v1, s2, v2)
    kernel, library = th.hamming_top2(*args), hamming_top2_library(*args)
    for i, name in ((0, "best"), (1, "second")):
        if not torch.equal(kernel[i], library[i]):
            raise RuntimeError(f"hamming_top2 and the library comparator give other {name} "
                               "distances")
    lib_ms, _ = profiling.device_ms(lambda: hamming_top2_library(*args), n)
    e = entry(lambda: th.hamming_top2(*args), *top2_work(K1, K2, float(K1) * K2))
    e.update(library_us=lib_ms * 1e3, speedup_vs_library=lib_ms * 1e3 / e["measured_us"])
    out[f"hamming_top2_{K1}x{K2}"] = e
    out["method"] = (
        f"device median of {n} calls, each between two CUDA events, a spin kernel "
        "holding the card while the host queues them (runtime.profiling.device_ms); "
        "bound: the largest of the bytes read and written once over the memory rate "
        "and each type's operations over its peak (runtime.profiling.sol_s, "
        f"CARD_PEAKS); "
        f"{profiling.card_and_power()}")
    return {"kernel_sol": out}


def bench_ba(cfg: SLAMConfig, timing_iters: int = 30, device="cuda") -> dict:
    """Local-BA ms an iteration on the backend's own window shape
    (`ba_workload`), `windowed_local_ba` with the older half fixed: the
    median call over `timing_iters` calls / `cfg.ba.iters`. The busy share
    says whether the card or the host's queueing set the time (a call is
    many small operations)."""
    from slam_rgbd_tpu_torch.backend.ba import windowed_local_ba

    dev = _resolve_device(device)
    w = {k: torch.from_numpy(v).to(dev) for k, v in ba_workload(cfg).items()}

    def call():
        return windowed_local_ba(w["poses"], w["valid"], w["pts"], w["obs_uv"],
                                 w["obs_z"], w["pid"], w["obs_ok"], cfg.camera, cfg.ba,
                                 free_mask=w["free"])

    if dev.type == "cuda":
        ms, busy = profiling.device_ms(call, timing_iters)
    else:
        ms, busy = profiling.host_ms(call, timing_iters), None
    return {
        "ba_ms_per_iter": ms / cfg.ba.iters,
        "ba_window_kf": int(w["poses"].shape[0]),
        "ba_obs": int(w["obs_ok"].sum()),
        "ba_busy_share": busy,
    }


def bench_session(cfg: SLAMConfig, frames, gt_poses=None) -> dict:
    """The full pipeline: `SLAMSession(cfg, async_backend=True)` (tracking,
    features, map, the backend's BA and loop search on its worker), warmed
    up on a scratch session, then two timed runs drained with a final
    backend pass; the better run by wall clock is reported. Call ms between
    calls (the bootstrap call left out), and apart those of calls that
    inserted a keyframe; ATE of the same run."""
    dev = frames[0][1].device
    pairs = _pairs(frames)
    scratch = SLAMSession(cfg, async_backend=True, device=dev)
    try:
        scratch.warmup()
    finally:
        scratch.close()

    def run_once() -> tuple[float, dict]:
        sess = SLAMSession(cfg, async_backend=True, device=dev)
        try:
            t0 = time.perf_counter()
            ms, kf_calls, _ = sweep(sess, pairs, cfg.camera.fps)
            sess.sync_backend(timeout=60.0, final_pass=True)
            wall = time.perf_counter() - t0
            jobs = {"completed": sess.worker.completed, "skipped": sess.worker.skipped}
            _, est = sess.poses()
            st = sess.state
            calls, inserts = ms[1:], ms[1:][kf_calls[1:]]
            p50, p99 = _percentiles(calls)
            ins50, ins99 = _percentiles(inserts)
            out = {
                "session_fps": len(frames) / wall,
                "session_mean_ms": float(calls.mean()),
                "session_p50_ms": p50,
                "session_p99_ms": p99,
                "session_max_ms": float(calls.max()),
                "session_insert_p50_ms": ins50,
                "session_insert_p99_ms": ins99,
                "keyframes": st.keyframes,
                "map_points": sess.map_point_count(),
                "loops": st.loops,
                "backend_jobs": jobs,
            }
        finally:
            sess.close()
        if gt_poses is not None:
            # the accuracy of the timed run itself: <= 5 cm at >= 30 fps is
            # one joint target
            out["session_ate_cm"] = ate_rmse(est, gt_poses[: len(est)])[0] * 100
        return wall, out

    best_wall, best = min((run_once() for _ in range(2)), key=lambda r: r[0])
    best["notes"] = {
        "loops": (
            "0 loop closures on the clean sweep is the healthy outcome: revisits "
            "are re-associated against the map, so drift never accumulates. The "
            "loop pipeline is forced and measured in this run's loop_leg block"
        ),
    }
    return best


def bench_degraded(cfg: SLAMConfig, n_frames: int = 240, device="cuda") -> dict:
    """The sweep through the sensor model and the threaded session, drained
    with a final pass. Labelled as synthetic: no real camera footage."""
    noise = NoiseSpec(motion_blur=1.0, exposure_drift=0.08)
    frames, gt = _render_sequence(cfg, n_frames, return_gt=True, noise=noise,
                                  device=device)
    sess = SLAMSession(cfg, async_backend=True, device=frames[0][1].device)
    try:
        t0 = time.perf_counter()
        sweep(sess, _pairs(frames), cfg.camera.fps)
        sess.sync_backend(timeout=60.0, final_pass=True)
        wall = time.perf_counter() - t0
        _, est = sess.poses()
        st = sess.state
    finally:
        sess.close()
    return {"degraded_leg": {
        "fps": len(frames) / wall,
        "ate_cm": ate_rmse(est, gt[: len(est)])[0] * 100,
        "keyframes": st.keyframes,
        "lost_frames": st.lost,
        "relocalized": st.relocalized,
        "degradations": (
            "axial depth noise sigma~z^2 (Kinect model), silhouette + random depth "
            "dropout, RGB shot noise + exposure flicker, motion blur along per-frame "
            "flow, slow auto-exposure drift"
        ),
        "data": (
            "synthetic raycast scene WITH the degradation model - NOT real TUM "
            "footage (no dataset is reachable from the build; the fr1/desk <=5 cm "
            "target remains unverified on real camera data)"
        ),
    }}


def bench_loop_leg(cfg: SLAMConfig, n_frames: int = 120, device="cuda") -> dict:
    """The loop pipeline forced on the timed path: the sweep under injected
    odometry drift (`loop_leg_config`), so that recovery must go through
    candidate, verification, pose graph, fusion and merge; ATE with the
    loop search off and on over the same frames. The backend runs inline
    (deterministic, and each closure's cost lands on the call that closes
    it: `merge_frame_ms`, from CUDA events on a card)."""
    frames, gt = _render_sequence(cfg, n_frames, return_gt=True, device=device)
    dev = frames[0][1].device
    out = {"n_frames": n_frames, "drift_xi": list(LOOP_LEG_DRIFT)}
    for label, loop_on in (("loop_off", False), ("loop_on", True)):
        c = loop_leg_config(cfg, loop_on)
        scratch = SLAMSession(c, device=dev)
        scratch.warmup()
        scratch.close()
        sess = SLAMSession(c, device=dev)
        ms, _, wall = sweep(sess, _pairs(frames), cfg.camera.fps)
        _, est = sess.poses()
        st = sess.state
        entry = {
            "ate_cm": ate_rmse(est, gt[: len(est)])[0] * 100,
            "loops": st.loops,
            "keyframes": st.keyframes,
            "fps": len(frames) / wall,
            "p99_ms": float(np.percentile(ms[1:], 99)),
        }
        if loop_on:
            # inline, a loop merges in the call that closed it (the state's
            # frame count is the number of calls before it)
            mf = [i for i in st.loop_merge_frames if i < len(ms)]
            entry["loop_merge_frames"] = mf
            entry["merge_frame_ms"] = [float(ms[i]) for i in mf]
        out[label] = entry
    if out["loop_on"]["loops"]:
        out["ate_recovery"] = out["loop_on"]["ate_cm"] / max(out["loop_off"]["ate_cm"], 1e-9)
    return {"loop_leg": out}


def _launch_counters() -> dict:
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg
    from slam_rgbd_tpu_torch.ops import hamming as th

    return {"gn_reduce": tg.gn_reduce, "gn_reduce_batched": tg.gn_reduce_batched,
            "gated_match": th.gated_match, "hamming_top2": th.hamming_top2}


def main(cfg: SLAMConfig | None = None, n_frames: int = 240, legs: bool = True,
         device="cuda", scaling_iters: int = 10) -> dict:
    """Run every bench on `device` and print the ONE JSON line; returns its
    dict. A bench that raises stops the run. `scaling_iters`: timed steps a
    batch size."""
    from slam_rgbd_tpu_torch.parallel.scaling import batch_scaling

    cfg = cfg or astra_default_config()
    dev = _resolve_device(device)
    cam = cfg.camera
    counters = _launch_counters()
    launches = dict.fromkeys(counters, 0)

    def counted(fn, *args, **kw):
        """`fn`'s result; its kernel launches join `launches`."""
        for c in counters.values():
            c.launches = 0
        try:
            return fn(*args, **kw)
        finally:
            for k, c in counters.items():
                launches[k] += c.launches

    _note(f"rendering {n_frames} frames at {cam.width}x{cam.height} on {dev}")
    frames, gt_poses = _render_sequence(cfg, n_frames, return_gt=True, device=dev)
    extras = {}
    _note("tracking-only bench")
    extras.update(counted(bench_tracking, cfg, frames))
    _note("kernel roofline bench")
    extras.update(bench_kernels(cfg, frames))  # its launches are timings
    _note("local-BA ms/iteration bench")
    extras.update(counted(bench_ba, cfg, device=dev))
    _note("batch-scaling bench (B concurrent sequences on one device)")
    hardware = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    extras["scaling"] = {
        "hardware": hardware,
        "batch_scaling_1chip": counted(batch_scaling, cam, cfg.icp, batches=(1, 2, 4, 8),
                                       iters=scaling_iters, device=dev),
        "note": (
            "B concurrent sequences tracked on ONE device through the batched GN "
            "kernel (one launch an iteration for all B); marginal_ms_per_seq is the "
            "step time each added sequence costs"
        ),
    }
    _note("full-session bench (threaded backend, warmup on a scratch session)")
    session = counted(bench_session, cfg, frames, gt_poses=gt_poses)
    extras.update(session)
    del frames
    if legs:
        _note("degraded-sensor leg (noise + blur + exposure drift)")
        extras.update(counted(bench_degraded, cfg, n_frames=n_frames, device=dev))
        _note("forced loop-closure leg (injected odometry drift)")
        extras.update(counted(bench_loop_leg, cfg, n_frames=min(n_frames, 120), device=dev))
    extras["kernel_launches"] = launches
    extras["device"] = hardware
    extras["power_limit_w"] = (
        float(profiling.card_and_power().split(",")[1].split()[0])
        if dev.type == "cuda" else None)

    fps = session["session_fps"]
    result = {
        "metric": METRIC,
        "value": fps,
        "unit": "frames/sec",
        "vs_baseline": fps / BASELINE_FPS,
        **extras,
    }
    print(json.dumps(result), flush=True)
    return result
