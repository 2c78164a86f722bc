#!/usr/bin/env python3
"""Drive the port's SLAM sessions once on one CUDA card and check them.

    python3 chip_smoke.py [--control] [--profile]

Run from the root of a checkout. `--control` adds two tracking-only sweeps
to the main phase, one before and one after the measured sweep, to show how
far the host's speed moves within the process. `--profile` adds a
`torch.profiler` trace of a few tracked batch steps at B = 4 and B = 1 to the
batch phase (device operations a step, their device time, the card's busy
share). Phases, each fatal on failure:

  1. device  - a CUDA card is required; prints its name and power limit.
  2. build   - compiles the kernels from `slam_rgbd_tpu_torch/ops/csrc/`
               with nvcc for sm_90a (one nvcc a source, in parallel).
  3. kernels - each CUDA kernel against its plain torch version on the card:
               `gn_reduce` on a rendered 640x480 frame pair at the three
               pyramid levels the tracker uses; `gated_match` (1024 x 16384)
               and `hamming_top2` (1024 x 16384 and 16384 x 1024) on the
               descriptors and geometry of rendered 640x480 keyframes in a
               full-capacity map, with seeded ties and masked rows, all
               outputs exactly equal. Median device times of kernel and
               plain version over 50 calls (CUDA events), and the least time
               the card could take for the same work.
               `gn_reduce_batched` with 8, 4 and 1 problems (frame pairs at
               different poses) at the same three shapes: equal to its plain
               version, two launches identical, and each problem identical
               bit for bit to a single `gn_reduce` launch on its slice.
  4. small   - a 160x120 sequence through the session on the card and on the
               CPU (plain path): poses, keyframes and map agree.
  5. main    - a 240-frame 640x480 out-and-back orbit (the JAX package's
               bench scene) through `SLAMSession(device="cuda")` at full
               width (1024 features, 8 levels, 256 keyframes, 16384 map
               points): every GN reduction a kernel launch (42 a tracked
               frame), one `gated_match` launch a keyframe insert that had a
               map, no lost frame, ATE within 5 cm, the TUM export reloads;
               frames/s and per-frame p50/p99 from CUDA events.
  6. reloc   - on the map the main phase built, `_relocalize` of a sweep
               frame from an estimate off by 5 cm / 2 deg: accepted, back
               within 3 cm, exactly two `hamming_top2` launches.
  7. lost    - twelve 640x480 frames through `process_frame`, one with its
               depth blanked outside a central window: frames are lost and
               relocalized against the map (two `hamming_top2` launches a
               try), tracking comes back, ATE within 5 cm.
  8. small batch - two different 160x120 sequences through
               `BatchSession` on the card and on the CPU: poses, keyframes
               and maps agree.
  9. batch   - `BatchSession(cfg, 4)` at full width over 120 frames of
               640x480 under injected odometry drift (the JAX bench's loop
               leg): sequences 0 and 1 the out-and-back sweep, 2 and 3
               forward orbits. 42 `gn_reduce_batched` launches a tracked
               step and no single `gn_reduce` launch, one `gated_match`
               launch an insert with a map, `hamming_top2` launches from
               loop verification, all poses finite, the sweep sequences
               close a loop each, and their ATE is below that of the same
               sweep with the loop search off.

The line before the last holds the kernel table as JSON; the last line is
`{"ok": true, "device": {...}}`. Any failure exits non-zero without it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_FRAMES = 240
SMALL_FRAMES = 12
ATE_LIMIT_M = 0.05  # BASELINE.md target
STEADY_FROM = 10  # frames before this warm up (allocator, cuBLAS handles)
TIMING_LAUNCHES = 50
RELOC_FRAME = 120
LOST_FRAMES = 12  # the lost phase: a short run with one damaged frame
LOST_AT = 6
BATCH_B = 4
BATCH_FRAMES = 120
KERNEL_B = (8, 4, 1)  # problems a launch in the batched kernel's phase
# the loop leg of the JAX package's bench: a constant twist composed onto
# every tracked relative pose, denser keyframes, a shorter loop interval
LOOP_LEG_DRIFT = (0.006, 0.0, 0.003, 0.0, 0.003, 0.0)
MATCHED_SHARE_MIN = 0.5  # of a later keyframe's valid keypoints, see main_phase

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): device
# memory, float32 outside the tensor cores, int8 in the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_INT8_S = 1979e12


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_ms(fn, n: int = TIMING_LAUNCHES) -> tuple[float, float]:
    """(median device ms of one `fn()` call over n calls, share of the
    timed span the device was busy).

    A spin kernel holds the card while the host queues all n calls, so the
    event pairs bracket device work and not the host's launch overhead
    (which exceeds it for these small calls). The busy share is the sum of
    the pairs over the span from the first to the last event: near 1 when
    the queue never ran dry."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(n)]
    torch.cuda._sleep(int(2.0 * enqueue_s * 2.0e9) + 1_000_000)  # ~2x at <= 2 GHz
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in pairs]
    span = pairs[0][0].elapsed_time(pairs[-1][1])
    return float(np.median(times)), float(sum(times) / span)


def bound(n_bytes: float, f32_ops: float = 0.0, int8_ops: float = 0.0):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes moved once over the memory rate and the operations over the
    peak rate of their type."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = f32_ops / PEAK_F32_S + int8_ops / PEAK_INT8_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def host_ms(fn, n: int = 5) -> float:
    """Median host-clock ms of one `fn()` call that ends synchronised: what
    a stage of many small device ops costs, launch overhead included."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def device_phase() -> str:
    phase("device")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def build_phase() -> None:
    phase("build")
    from slam_rgbd_tpu_torch.ops import _build

    lib_path = _build.library_path()
    seconds = _build.build(lib_path)
    _build.load()
    print(f"built {lib_path.name} in {seconds:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def gn_kernel_phase(cfg) -> dict:
    """gn_reduce vs gn_reduce_reference at the tracker's three level shapes."""
    phase("kernels: gn_reduce")
    from slam_rgbd_tpu_torch.core import camera
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory, render_frame
    from slam_rgbd_tpu_torch.odometry import icp
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg

    dev = torch.device("cuda", 0)
    cam, icfg = cfg.camera, cfg.icp
    poses = orbit_trajectory(2, sweep=True)
    pyrs = []
    for p in poses:
        depth, rgb = render_frame(p, cam, device=dev)
        pyrs.append(camera.build_frame_pyramid(depth, cam, levels=icfg.levels, rgb=rgb))
    T = torch.from_numpy(np.linalg.inv(poses[0]) @ poses[1]).to(dev)
    worst, rows = 0.0, []
    for k in range(icfg.levels - 1, -1, -1):
        lcam = cam.scaled(2.0 ** k)
        ci = min(icfg.levels - 1 - k, len(icfg.iters) - 1)
        radius = icfg.window_px[min(ci, len(icfg.window_px) - 1)]
        src = icp.level_planes(pyrs[1][k])[: tg.SRC_CHANNELS].contiguous()
        tgt = icp.level_planes(pyrs[0][k])
        _, up, vp, _ = icp._project_level(T, pyrs[1][k]["vertices"], lcam)
        mu = icp.flow_shift(up, vp, lcam.height, lcam.width)
        args = (T, mu, src, tgt, lcam, icfg, radius)

        k1 = tg.gn_reduce(*args)
        k2 = tg.gn_reduce(*args)
        ref = tg.gn_reduce_reference(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              "two kernel runs differ")
        H1, g1, i1, s1 = (x.cpu().numpy() for x in k1)
        H0, g0, i0, s0 = (x.cpu().numpy() for x in ref)
        h_scale = max(1.0, float(np.abs(H0).max()))
        g_scale = max(1.0, float(np.abs(g0).max()))
        err_h = float(np.abs(H1 - H0).max()) / h_scale
        err_g = float(np.abs(g1 - g0).max()) / g_scale
        err_s = abs(float(s1) - float(s0)) / max(abs(float(s0)), 1e-30)
        d_inl = int(i1) - int(i0)
        shape = f"{lcam.height}x{lcam.width}/R{radius}"
        print(f"{shape}: mu={mu.tolist()} inliers kernel {int(i1)} plain "
              f"{int(i0)}; H err/scale {err_h:.2e} (<= 2e-6), g err/scale "
              f"{err_g:.2e} (<= 5e-5), sq_sum rel err {err_s:.2e} (<= 1e-4)")
        check(err_h <= 2e-6 and err_g <= 5e-5 and err_s <= 1e-4,
              f"{shape}: kernel disagrees with plain version")
        check(int(i1) > 1000, f"{shape}: only {int(i1)} inliers")
        if d_inl != 0:
            # per-pixel arithmetic rounds alike in both, so a difference can
            # only come from a gate that the final float sums do not touch
            print(f"  inliers differ by {d_inl}: a pixel on a gate threshold")
        check(abs(d_inl) <= 2, f"{shape}: inliers differ by {d_inl}")
        worst = max(worst, err_h, err_g)
        ms, busy = device_ms(lambda: tg.gn_reduce(*args))
        plain_ms, plain_busy = device_ms(lambda: tg.gn_reduce_reference(*args))
        print(f"  device median of {TIMING_LAUNCHES}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (queue busy share {busy:.3f} / {plain_busy:.3f})")
        # inputs read once (8 + 10 planes, T and mu), 44 values written;
        # ~300 float operations a pixel (projection, four-corner sampling of
        # ten channels, two 7-vector outer products)
        n_px = lcam.height * lcam.width
        b_ms, b_by = bound(4.0 * ((tg.SRC_CHANNELS + tg.TGT_CHANNELS) * n_px + 18 + 44),
                           f32_ops=300.0 * n_px)
        print(f"  bound {b_ms:.4f} ms by {b_by}")
        rows.append({"shape": shape, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
    return {"max_err": worst, "rows": rows}


def gn_batched_kernel_phase(cfg) -> dict:
    """gn_reduce_batched vs its plain version and vs single gn_reduce
    launches, at the tracker's three level shapes, for frame pairs of the
    sweep at eight different poses."""
    phase("kernels: gn_reduce_batched")
    from slam_rgbd_tpu_torch.core import camera
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory, render_frame
    from slam_rgbd_tpu_torch.odometry import icp
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg

    dev = torch.device("cuda", 0)
    cam, icfg = cfg.camera, cfg.icp
    n_max = max(KERNEL_B)
    gt = orbit_trajectory(N_FRAMES, sweep=True)
    first = [i * (N_FRAMES // n_max) for i in range(n_max)]  # pairs (i, i + 1)

    def pyramid(idx):
        depth, rgb = (torch.stack(x) for x in zip(
            *(render_frame(gt[i], cam, device=dev) for i in idx)))
        return camera.build_frame_pyramid(depth, cam, levels=icfg.levels, rgb=rgb)

    tgt_pyr = pyramid(first)
    src_pyr = pyramid([i + 1 for i in first])
    T = torch.from_numpy(np.stack(
        [np.linalg.inv(gt[i]) @ gt[i + 1] for i in first]).astype(np.float32)).to(dev)
    worst, rows = 0.0, []
    for k in range(icfg.levels - 1, -1, -1):
        lcam = cam.scaled(2.0 ** k)
        _, radius = icp._level_schedule(icfg, icfg.levels, k)
        src = icp.level_planes(src_pyr[k])[:, : tg.SRC_CHANNELS].contiguous()
        tgt = icp.level_planes(tgt_pyr[k])
        _, up, vp, _ = icp._project_level(T, src_pyr[k]["vertices"], lcam)
        mu = icp.flow_shift(up, vp, lcam.height, lcam.width)
        shape = f"{lcam.height}x{lcam.width}/R{radius}"
        n_px = lcam.height * lcam.width
        for n_b in KERNEL_B:
            args = (T[:n_b].contiguous(), mu[:n_b].contiguous(), src[:n_b].contiguous(),
                    tgt[:n_b].contiguous(), lcam, icfg, radius)
            k1 = tg.gn_reduce_batched(*args)
            k2 = tg.gn_reduce_batched(*args)
            singles = [tg.gn_reduce(*(a[b] for a in args[:4]), lcam, icfg, radius)
                       for b in range(n_b)]
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
                  f"{shape} B={n_b}: two batched launches differ")
            check(all(torch.equal(a[b], c) for b in range(n_b)
                      for a, c in zip(k1, singles[b])),
                  f"{shape} B={n_b}: a problem differs from its single launch")
            ms, busy = device_ms(lambda: tg.gn_reduce_batched(*args))
            # each problem's planes, pose and flow read once, 44 values written
            b_ms, b_by = bound(
                4.0 * n_b * ((tg.SRC_CHANNELS + tg.TGT_CHANNELS) * n_px + 18 + 44),
                f32_ops=300.0 * n_b * n_px)
            row = {"shape": shape, "B": n_b, "ms": ms, "bound_ms": b_ms, "bound_by": b_by}
            if n_b in (n_max, BATCH_B):
                ref = tg.gn_reduce_batched_reference(*args)
                torch.cuda.synchronize()
                H1, g1, i1, s1 = (x.cpu().numpy() for x in k1)
                H0, g0, i0, s0 = (x.cpu().numpy() for x in ref)
                h_scale = np.maximum(1.0, np.abs(H0).max(axis=(1, 2)))
                g_scale = np.maximum(1.0, np.abs(g0).max(axis=1))
                err_h = float((np.abs(H1 - H0).max(axis=(1, 2)) / h_scale).max())
                err_g = float((np.abs(g1 - g0).max(axis=1) / g_scale).max())
                err_s = float((np.abs(s1 - s0) / np.maximum(np.abs(s0), 1e-30)).max())
                print(f"{shape} B={n_b}: mu={mu[:n_b].tolist()} inliers {i1.tolist()} "
                      f"(plain: equal {bool((i1 == i0).all())}); H err/scale {err_h:.2e} "
                      f"(<= 2e-6), g err/scale {err_g:.2e} (<= 5e-5), sq_sum rel err "
                      f"{err_s:.2e} (<= 1e-4); two launches identical; every problem "
                      f"bit-identical to its single gn_reduce launch")
                check(err_h <= 2e-6 and err_g <= 5e-5 and err_s <= 1e-4,
                      f"{shape} B={n_b}: kernel disagrees with plain version")
                check(bool((i1 == i0).all()) and int(i1.min()) > 1000,
                      f"{shape} B={n_b}: inliers {i1.tolist()} vs plain {i0.tolist()}")
                check(len(set(i1.tolist())) == n_b, "the problems do not differ")
                worst = max(worst, err_h, err_g)
                row["plain_ms"], _ = device_ms(
                    lambda: tg.gn_reduce_batched_reference(*args), n=5)
            print(f"  {shape} B={n_b}: device median of {TIMING_LAUNCHES}: kernel "
                  f"{ms:.4f} ms (queue busy share {busy:.3f})"
                  + (f", plain {row['plain_ms']:.4f} ms" if "plain_ms" in row else "")
                  + f"; bound {b_ms:.4f} ms by {b_by}")
            rows.append(row)
    return {"max_err": worst, "rows": rows}


def _assert_exact(name: str, kernel_out, again, plain_out) -> float:
    """Every output equal to the plain version's and to a second launch's;
    returns the largest absolute difference found (0.0 when it passes)."""
    worst = 0.0
    for k, a, b, c in zip(range(len(kernel_out)), kernel_out, again, plain_out):
        check(a.dtype == c.dtype and a.shape == c.shape,
              f"{name}: output {k} has another type or shape than the plain version's")
        check(torch.equal(a, b), f"{name}: two kernel runs differ in output {k}")
        worst = max(worst, float((a.double() - c.double()).abs().max()))
        check(torch.equal(a, c), f"{name}: output {k} differs from the plain version")
    return worst


def hamming_kernel_phase(cfg) -> dict:
    """gated_match and hamming_top2 vs their plain versions, exactly, at the
    shapes the session gives them: 1024 query keypoints of a rendered
    640x480 frame against a 16384-slot map built from earlier frames."""
    phase("kernels: gated_match, hamming_top2")
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory, render_frame
    from slam_rgbd_tpu_torch.mapping import map as smap
    from slam_rgbd_tpu_torch.ops import hamming as th
    from slam_rgbd_tpu_torch.runtime import session as rs

    dev = torch.device("cuda", 0)
    cam, kcfg = cfg.camera, cfg.keyframes
    gt = orbit_trajectory(N_FRAMES, sweep=True)
    rel = (np.linalg.inv(gt[0]) @ gt).astype(np.float32)
    # a map of six keyframes at true poses, 12 frames apart, no association:
    # every valid keypoint spawns a point
    n_kp = sum(rs.fdetect._per_level_budget(
        cfg.orb.n_features, cfg.orb.n_levels, cfg.orb.scale_factor))
    m = smap.empty_map(kcfg, n_kp, dev)
    none = torch.full((n_kp,), -1, dtype=torch.int32, device=dev)
    for i in range(0, 72, 12):
        depth, rgb = render_frame(gt[i], cam, device=dev)
        kp, desc, pts, ok = rs._features(depth, rgb, cfg.orb, cam)
        m = smap.insert_keyframe(m, torch.from_numpy(rel[i]).to(dev), i / cam.fps,
                                 kp.uv, pts, ok, desc.signs, none)
    n_pt = int(m.n_pt)
    check(2000 < n_pt <= kcfg.max_map_points - 256, f"map of {n_pt} points")
    # seeded ties: the first 128 points once more in free slots further on,
    # so the first index must win; the remaining free slots stay zero rows,
    # masked by pt_valid
    dup = slice(kcfg.max_map_points - 192, kcfg.max_map_points - 64)
    m.pt_signs[dup] = m.pt_signs[:128]
    m.pt_xyz[dup] = m.pt_xyz[:128]
    m.pt_valid[dup] = True
    check(bool((m.pt_signs[~m.pt_valid] == 0).all()), "free slots are not zero rows")

    # the query: a frame between two of the keyframes, at a pose 1 cm off
    q = 30
    depth, rgb = render_frame(gt[q], cam, device=dev)
    kp, desc, pts, ok = rs._features(depth, rgb, cfg.orb, cam)
    T = torch.from_numpy(rel[q]).to(dev).clone()
    T[0, 3] += 0.01
    captured = {}
    real = smap.gated_match

    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return real(*args, **kw)

    smap.gated_match = capture
    try:
        pid = smap.match_against_map(
            m, desc.signs, ok, kp.uv, pts[:, 2], T, cam=cam,
            max_distance=float(cfg.orb.match_threshold), kp_pts=pts,
            merge_radius=kcfg.merge_radius)
    finally:
        smap.gated_match = real
    g_args, g_kw = captured["args"], captured["kw"]
    feat_ms = host_ms(lambda: rs._features(depth, rgb, cfg.orb, cam))
    assoc_ms = host_ms(lambda: smap.match_against_map(
        m, desc.signs, ok, kp.uv, pts[:, 2], T, cam=cam,
        max_distance=float(cfg.orb.match_threshold), kp_pts=pts,
        merge_radius=kcfg.merge_radius))
    print(f"keyframe stages at 640x480 (host clock, synchronised, median of 5): "
          f"feature stage {feat_ms:.2f} ms, map association (projection, gate "
          f"data, gated_match) {assoc_ms:.2f} ms")
    k1, k2 = g_args[0].shape[0], g_args[2].shape[0]
    check((k1, k2) == (cfg.orb.n_features, kcfg.max_map_points), f"shapes {k1} x {k2}")
    out = {}

    # ---- gated_match
    a = th.gated_match(*g_args, **g_kw)
    b = th.gated_match(*g_args, **g_kw)
    ref = th.gated_match_reference(*g_args, **g_kw)
    torch.cuda.synchronize()
    err = _assert_exact("gated_match", a, b, ref)
    n_ok = int(ok.sum())
    matched = int((pid >= 0).sum())
    ties = int(((a[1] < 128) & (a[0] < 64)).sum())
    print(f"gated_match {k1} x {k2}: d1 i1 d2 i2 equal the plain version exactly; "
          f"{matched} of {n_ok} valid keypoints matched, {ties} on the tied block, "
          f"{int(m.pt_valid.sum())} valid map points")
    check(matched > 0.3 * n_ok, "the gates let too few matches through")
    off = th.gated_match(*g_args, **dict(g_kw, merge_radius=-1.0))
    off_ref = th.gated_match_reference(*g_args, **dict(g_kw, merge_radius=-1.0))
    err = max(err, _assert_exact("gated_match (merge tier off)", off, off, off_ref))
    check(bool((off[2] == 1e9).all()), "merge tier off still matched")
    ms, busy = device_ms(lambda: th.gated_match(*g_args, **g_kw))
    plain_ms, _ = device_ms(lambda: th.gated_match_reference(*g_args, **g_kw), n=10)
    # the pairs whose distance this run's data needs: valid query x valid
    # point; 256 multiply-adds a pair for the sign product, ~17 float
    # operations a pair for the two gates
    pairs = float(g_args[1][:, 3].sum()) * float(g_args[3][:, 3].sum())
    b_ms, b_by = bound((k1 + k2) * (256 + 32) + k1 * 16,
                       f32_ops=17.0 * pairs, int8_ops=2.0 * 256 * pairs)
    print(f"  device median of {TIMING_LAUNCHES}: kernel {ms:.4f} ms (queue busy "
          f"share {busy:.3f}), plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
          f"({pairs:.0f} unmasked pairs)")
    out["gated_match"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "max_abs_err": err}

    # ---- hamming_top2, both directions of the relocalization match
    s1, v1, s2, v2 = desc.signs, ok, m.pt_signs, m.pt_valid
    rows, err = [], 0.0
    for name, args in (("1024 x 16384", (s1, v1, s2, v2)),
                       ("16384 x 1024", (s2, v2, s1, v1))):
        a = th.hamming_top2(*args)
        b = th.hamming_top2(*args)
        ref = th.hamming_top2_reference(*args)
        torch.cuda.synchronize()
        err = max(err, _assert_exact(f"hamming_top2 {name}", a, b, ref))
        tied = int(((a[0] == a[1]) & (a[0] < 1e9)).sum())
        ms, busy = device_ms(lambda: th.hamming_top2(*args))
        plain_ms, _ = device_ms(lambda: th.hamming_top2_reference(*args), n=10)
        n1, n2 = args[0].shape[0], args[2].shape[0]
        pairs = float(args[1].sum()) * float(args[3].sum())
        b_ms, b_by = bound((n1 + n2) * (256 + 1) + n1 * 12, int8_ops=2.0 * 256 * pairs)
        print(f"hamming_top2 {name}: best second idx equal the plain version "
              f"exactly ({tied} rows with second == best)")
        print(f"  device median of {TIMING_LAUNCHES}: kernel {ms:.4f} ms (queue busy "
              f"share {busy:.3f}), plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by}")
        rows.append({"shape": name, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
    mt = th.match_kernel(s1, v1, s2, v2, max_distance=float(cfg.orb.match_threshold))
    print(f"match_kernel: {int(mt.valid.sum())} mutual matches of {n_ok} keypoints")
    check(int(mt.valid.sum()) > 50, "too few mutual matches for a relocalization")
    out["hamming_top2"] = dict(rows[0], max_abs_err=err, rows=rows)
    return out


def small_phase(cfg) -> None:
    """The same short sequence on the card and on the CPU (plain path)."""
    phase("small")
    import dataclasses

    from slam_rgbd_tpu_torch import SLAMSession
    from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence

    cam = cfg.camera.scaled(4.0)  # 160x120
    # a keyframe every few frames of the ~1.3 cm/frame orbit
    small = dataclasses.replace(
        cfg, camera=cam,
        keyframes=dataclasses.replace(cfg.keyframes, kf_min_trans=0.03))
    frames = list(SyntheticSequence(SMALL_FRAMES, cam, sweep=True))
    out = {}
    for dev in ("cpu", "cuda"):
        sess = SLAMSession(small, device=dev)
        for f in frames:
            sess.process_frame(*f)
        poses = sess.poses()[1]
        check(np.isfinite(poses).all(), f"{dev}: non-finite poses")
        out[dev] = (poses, sess.state.keyframes, sess.map_point_count(),
                    sess.map.point_id.cpu().numpy())
    (p_cpu, kf_cpu, n_cpu, pid_cpu), (p_gpu, kf_gpu, n_gpu, pid_gpu) = out["cpu"], out["cuda"]
    err = float(np.abs(p_gpu - p_cpu).max())
    # the observation graph: which keypoint of which keyframe observes a map
    # point at all (the two devices round features otherwise, so a keypoint
    # may differ and every later slot number with it: ids are compared as a
    # share, the mask is held to 95%)
    seen_same = float(((pid_cpu >= 0) == (pid_gpu >= 0))[:kf_cpu].mean())
    id_same = float((pid_cpu == pid_gpu)[:kf_cpu].mean())
    print(f"160x120, {SMALL_FRAMES} frames: card vs CPU max pose diff {err:.2e} "
          f"(<= 1e-4); keyframes {kf_gpu} / {kf_cpu}, map points {n_gpu} / {n_cpu} "
          f"(within 5%), point_id observed-mask agreement {seen_same:.4f} "
          f"(>= 0.95), equal ids {id_same:.4f}")
    check(err <= 1e-4, "card and CPU sessions disagree")
    check(kf_gpu == kf_cpu > 1, "card and CPU sessions insert other keyframes")
    check(n_cpu > 0 and abs(n_gpu - n_cpu) <= 0.05 * n_cpu, "map sizes differ")
    check(seen_same >= 0.95, "observation graphs differ")


def _sweep(sess, frames, fps: float):
    """Drive `sess` over the frames. -> (device ms of every call from CUDA
    events, which calls inserted a keyframe, wall seconds). A frame's
    keyframe decision is applied in a later call, so the insert is charged
    to the call that made it."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(frames) + 1)]
    kf_calls = []
    marks[0].record()
    wall0 = time.perf_counter()
    for i, (depth, rgb) in enumerate(frames):
        before = sess.state.keyframes
        sess.process_frame(i / fps, depth, rgb)
        marks[i + 1].record()
        kf_calls.append(sess.state.keyframes > before)
    sess.flush_pipeline()
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    ms = np.array([marks[i].elapsed_time(marks[i + 1]) for i in range(len(frames))])
    return ms, np.array(kf_calls), wall


def _control_sweep(cfg, frames) -> np.ndarray:
    """Steady-state call times of a session that only tracks: the same
    configuration with the keyframe thresholds out of reach, so that no call
    after the bootstrap runs the feature stage or touches the map."""
    import dataclasses

    from slam_rgbd_tpu_torch import SLAMSession

    never = dataclasses.replace(cfg.keyframes, kf_min_trans=1e9, kf_min_rot_deg=1e9,
                                kf_min_inlier_ratio=0.0)
    sess = SLAMSession(dataclasses.replace(cfg, keyframes=never))
    ms, _, _ = _sweep(sess, frames, cfg.camera.fps)
    check(sess.state.keyframes == 1, "the control inserted keyframes")
    return ms[STEADY_FROM:]


def main_phase(cfg, with_control: bool = False) -> dict:
    phase("main")
    from slam_rgbd_tpu_torch import SLAMSession
    from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse, load_trajectory_tum
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory, render_frame
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg
    from slam_rgbd_tpu_torch.ops import hamming as th

    dev = torch.device("cuda", 0)
    cam = cfg.camera
    t0 = time.perf_counter()
    gt = orbit_trajectory(N_FRAMES, sweep=True)
    # frames stay on the card, as in the JAX package's bench
    frames = [render_frame(p, cam, device=dev) for p in gt]
    torch.cuda.synchronize()
    print(f"rendered {N_FRAMES} frames {cam.width}x{cam.height} in "
          f"{time.perf_counter() - t0:.1f} s")

    # the host's speed moves within one process, so the optional control runs
    # in this one, before and after the sweep that is measured
    control = [_control_sweep(cfg, frames)] if with_control else []

    sess = SLAMSession(cfg)  # the default device: the card
    check(sess.device.type == "cuda", f"default device is {sess.device}")
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    tg.gn_reduce.launches = th.gated_match.launches = th.hamming_top2.launches = 0
    all_ms, kf_calls, wall = _sweep(sess, frames, cam.fps)
    launches = tg.gn_reduce.launches
    gated_launches, top2_launches = th.gated_match.launches, th.hamming_top2.launches
    peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 2**20
    ts, est = sess.poses()
    if with_control:
        control.append(_control_sweep(cfg, frames))

    per_frame = all_ms[STEADY_FROM:]
    fps = (N_FRAMES - STEADY_FROM) / (per_frame.sum() / 1e3)
    ate, _, _ = ate_rmse(est, gt)
    keyframes = sess.state.keyframes
    is_kf = kf_calls[STEADY_FROM:]
    kf_ms, plain_frame_ms = per_frame[is_kf], per_frame[~is_kf]
    m = sess.map
    n_pt, dropped = sess.map_point_count(), int(m.pt_dropped)
    # share of the valid keypoints of later keyframes that observe a point
    # older than their keyframe: a lower bound on what the association
    # matched (culled points and recycled slots count as unmatched)
    pid = m.point_id[1:keyframes].long()
    older = m.pt_first_kf[pid.clamp_min(0)] < torch.arange(
        1, keyframes, device=m.device)[:, None]
    ok = m.kp_ok[1:keyframes]
    matched_share = float(((pid >= 0) & older & ok).sum()) / max(float(ok.sum()), 1.0)
    print(f"gn_reduce launches {launches} (expected 42 x {N_FRAMES - 1} = "
          f"{42 * (N_FRAMES - 1)}), gated_match launches {gated_launches} (one a "
          f"keyframe insert with a map: keyframes - 1 = {keyframes - 1}), "
          f"hamming_top2 launches {top2_launches} (no frame lost: 0)")
    print(f"lost {sess.state.lost}, keyframes {keyframes} of "
          f"{cfg.keyframes.max_keyframes}, map points {n_pt} of "
          f"{cfg.keyframes.max_map_points}, spawns dropped {dropped}, edges "
          f"{int(sess.n_edges)}, matched share of later keyframes' valid keypoints "
          f"{matched_share:.3f} (>= {MATCHED_SHARE_MIN}), peak device memory of the "
          f"run {peak_mb:.1f} MiB")
    print(f"ATE {ate * 100:.3f} cm (limit {ATE_LIMIT_M * 100:.0f} cm)")
    print(f"steady state (frames {STEADY_FROM}-{N_FRAMES - 1}): {fps:.2f} frames/s, "
          f"p50 {np.percentile(per_frame, 50):.3f} ms, p99 "
          f"{np.percentile(per_frame, 99):.3f} ms; whole run {wall:.2f} s wall")
    print(f"calls without a keyframe insert ({len(plain_frame_ms)}): "
          f"{1e3 / plain_frame_ms.mean():.2f} frames/s, p50 "
          f"{np.percentile(plain_frame_ms, 50):.3f} ms; calls with one ({len(kf_ms)}): "
          f"p50 {np.percentile(kf_ms, 50):.3f} ms, p99 {np.percentile(kf_ms, 99):.3f} ms")
    if with_control:
        print("tracking-only control in this process (keyframe thresholds out of "
              "reach), before / after: " + " / ".join(
                  f"{1e3 / c.mean():.2f} frames/s, p50 {np.percentile(c, 50):.3f} ms"
                  for c in control))

    check(launches == 42 * (N_FRAMES - 1), "main path did not run the kernel 42x a frame")
    check(keyframes > 1 and keyframes == int(m.n_kf), f"keyframes {keyframes}")
    check(gated_launches == keyframes - 1,
          f"{gated_launches} gated_match launches for {keyframes} keyframes")
    check(top2_launches == 0, "a relocalization ran though no frame was lost")
    check(0 < n_pt < cfg.keyframes.max_map_points and dropped == 0,
          f"map points {n_pt}, dropped {dropped}")
    check(int(sess.n_edges) == keyframes - 1, "odometry edges do not chain the keyframes")
    check(matched_share >= MATCHED_SHARE_MIN, "keyframes hardly reobserve the map")
    check(sess.state.lost == 0, f"{sess.state.lost} frames lost")
    check(est.shape == (N_FRAMES, 4, 4) and np.isfinite(est).all(),
          f"poses: shape {est.shape} or non-finite")
    check(ate <= ATE_LIMIT_M, f"ATE {ate:.4f} m above {ATE_LIMIT_M} m")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "traj.txt")
        sess.save_trajectory(path)
        ts2, est2 = load_trajectory_tum(path)
    check(np.allclose(ts2, ts, atol=1e-6) and np.allclose(est2, est, atol=1e-5),
          "TUM export does not reload to the same poses")
    return {"launches": launches, "gated_launches": gated_launches, "fps": fps,
            "ate": ate, "session": sess, "frames": frames, "gt": gt}


def lost_phase(cfg, run: dict) -> dict:
    """The serving route of a relocalization, on the card: the first frames
    of the sweep through `process_frame`, one of them with its depth blanked
    outside a central window. That frame and the one tracked against it
    fall under the inlier gate, so `_resolve_entry` relocalizes each against
    the map (two `hamming_top2` launches a try), corrects the logged and the
    pending poses in place and goes on tracking."""
    phase("lost")
    from slam_rgbd_tpu_torch import SLAMSession
    from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg
    from slam_rgbd_tpu_torch.ops import hamming as th

    cam = cfg.camera
    frames = list(run["frames"][:LOST_FRAMES])
    depth, rgb = frames[LOST_AT]
    h, w = depth.shape
    window = torch.zeros_like(depth)
    rows, cols = slice(h // 4, 3 * h // 4), slice(5 * w // 16, 11 * w // 16)
    window[rows, cols] = depth[rows, cols]
    frames[LOST_AT] = (window, rgb)

    sess = SLAMSession(cfg)
    tg.gn_reduce.launches = th.gated_match.launches = th.hamming_top2.launches = 0
    _sweep(sess, frames, cam.fps)
    launches = th.hamming_top2.launches
    st = sess.state
    ts, est = sess.poses()
    ate, _, _ = ate_rmse(est, run["gt"][:LOST_FRAMES])
    print(f"{LOST_FRAMES} frames, frame {LOST_AT} with depth in a central window only: "
          f"lost {st.lost}, relocalized {st.relocalized}, hamming_top2 launches "
          f"{launches} (two a try), gated_match launches {th.gated_match.launches} "
          f"for {st.keyframes} keyframes, ATE {ate * 100:.3f} cm")
    check(st.lost >= 1, "the windowed frame was not lost")
    check(st.relocalized >= 1, "no lost frame was relocalized")
    check(launches % 2 == 0 and 2 * st.relocalized <= launches <= 2 * st.lost,
          f"{launches} hamming_top2 launches for {st.lost} lost frames")
    check(th.gated_match.launches == st.keyframes - 1,
          f"{th.gated_match.launches} gated_match launches for {st.keyframes} keyframes")
    check(tg.gn_reduce.launches == 42 * (LOST_FRAMES - 1), "gn_reduce launches")
    check(sess.stats[-1].tracking_ok, "tracking did not come back")
    check(est.shape == (LOST_FRAMES, 4, 4) and np.isfinite(est).all(), "poses")
    check(ate <= ATE_LIMIT_M, f"ATE {ate:.4f} m above {ATE_LIMIT_M} m")
    return {"launches": launches}


def reloc_phase(run: dict) -> dict:
    """Relocalize a sweep frame against the map the main phase built, from
    an estimate off by 5 cm / 2 deg (as `warmup` exercises it)."""
    phase("reloc")
    from slam_rgbd_tpu_torch.core import se3
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg
    from slam_rgbd_tpu_torch.ops import hamming as th

    sess, frames = run["session"], run["frames"]
    dev = sess.device
    own = torch.from_numpy(sess.poses()[1][RELOC_FRAME]).to(dev)
    off = se3.exp(torch.tensor([0.05, 0.0, 0.0, 0.0, 0.035, 0.0], device=dev))
    T_est = own @ off
    depth, rgb = frames[RELOC_FRAME]
    times = []
    for attempt in range(2):  # the first call loads the solver library
        tg.gn_reduce.launches = th.gated_match.launches = th.hamming_top2.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T_fixed, C = sess._relocalize(depth, rgb, T_est=T_est)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        launches = th.hamming_top2.launches
        check(T_fixed is not None, "relocalization was not accepted")
        check(launches == 2, f"{launches} hamming_top2 launches, expected 2")
        dist = float(torch.linalg.norm(T_fixed[:3, 3] - own[:3, 3]))
        check(dist <= 0.03, f"relocalized pose {dist:.3f} m from the session's own")
    print(f"frame {RELOC_FRAME}: estimate off by 5 cm / 2 deg, relocalized to "
          f"{dist * 100:.2f} cm of the session's own pose (<= 3 cm), 2 hamming_top2 "
          f"launches; {times[0]:.1f} ms the first call, {times[1]:.1f} ms the second "
          f"(host clock, synchronised)")
    return {"launches": launches, "ms": times[1]}


def _batch_frames(seqs_gt, cam, dev):
    """Per step (depth (B, H, W), rgb (B, H, W, 3)) on the card; sequences
    that share a trajectory share their rendered frames."""
    from slam_rgbd_tpu_torch.io.synthetic import render_frame

    rendered = {}
    for gt in seqs_gt:
        if id(gt) not in rendered:
            rendered[id(gt)] = [render_frame(p, cam, device=dev) for p in gt]
    n = len(seqs_gt[0])
    return [tuple(torch.stack([rendered[id(gt)][i][c] for gt in seqs_gt])
                  for c in (0, 1)) for i in range(n)]


def small_batch_phase(cfg) -> None:
    """Two different short sequences through BatchSession on the card and on
    the CPU (plain path)."""
    phase("small batch")
    import dataclasses

    from slam_rgbd_tpu_torch import BatchSession
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory

    # the first LU solve of a process loads a solver library: outside every
    # timed window, and timed here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.linalg.solve_ex(torch.eye(96, device="cuda") * 2.0, torch.ones(96, 1, device="cuda"))
    torch.cuda.synchronize()
    print(f"first torch.linalg.solve_ex of the process: "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms (host clock, synchronised)")

    cam = cfg.camera.scaled(4.0)  # 160x120
    small = dataclasses.replace(
        cfg, camera=cam,
        orb=dataclasses.replace(cfg.orb, n_features=256, n_levels=4),
        keyframes=dataclasses.replace(cfg.keyframes, kf_min_trans=0.03,
                                      max_keyframes=16, max_map_points=2048),
        ba=dataclasses.replace(cfg.ba, window=4, iters=3, max_points_per_window=512))
    gts = [orbit_trajectory(SMALL_FRAMES, step_t=0.012 + 0.004 * b,
                            step_r=0.01 + 0.002 * b, seed=b) for b in range(2)]
    frames = _batch_frames(gts, cam, torch.device("cuda", 0))
    out = {}
    for dev in ("cpu", "cuda"):
        bs = BatchSession(small, 2, device=dev)
        for i, (depth, rgb) in enumerate(frames):
            bs.process_frames(i / cam.fps, depth, rgb)
        poses = bs.poses()[1]
        check(np.isfinite(poses).all(), f"{dev}: non-finite poses")
        out[dev] = (poses, bs.keyframe_counts, bs.map_point_counts(), bs.state.lost)
    (p_cpu, kf_cpu, n_cpu, lost_cpu), (p_gpu, kf_gpu, n_gpu, lost_gpu) = out["cpu"], out["cuda"]
    err = float(np.abs(p_gpu - p_cpu).max())
    print(f"160x120, B=2, {SMALL_FRAMES} frames: card vs CPU max pose diff {err:.2e} "
          f"(<= 1e-3: the float32 sums of the tracked frames and of the BA "
          f"run in another order on the card); keyframes "
          f"{kf_gpu.tolist()} / {kf_cpu.tolist()}, map points {n_gpu.tolist()} / "
          f"{n_cpu.tolist()} (within 5%), lost {lost_gpu.tolist()} / {lost_cpu.tolist()}")
    check(err <= 1e-3, "card and CPU batch sessions disagree")
    check((kf_gpu == kf_cpu).all() and (kf_cpu >= 3).all(),
          "card and CPU batch sessions insert other keyframes")
    check((np.abs(n_gpu - n_cpu) <= 0.05 * n_cpu).all(), "map sizes differ")
    check(not lost_gpu.any() and not lost_cpu.any(), "frames lost")


class _Stopwatch:
    """Host-clock times (synchronised) of every call of some functions,
    swapped in for the duration of a `with` block."""

    def __init__(self, *targets):
        self.targets = targets  # (module, function name)
        self.ms = {name: [] for _, name in targets}

    def __enter__(self):
        self._real = [(mod, name, getattr(mod, name)) for mod, name in self.targets]
        for mod, name, fn in self._real:
            setattr(mod, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._real:
            setattr(mod, name, fn)

    def _timed(self, name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.ms[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    def report(self, name: str) -> str:
        v = self.ms[name]
        return (f"{name} {len(v)} calls, median {np.median(v):.1f} ms, max "
                f"{max(v):.1f} ms" if v else f"{name} 0 calls")


def _batch_run(cfg, frames, n_seq: int):
    """Drive a BatchSession over the frames -> (session, device ms of every
    step from CUDA events, which steps inserted a keyframe)."""
    from slam_rgbd_tpu_torch import BatchSession

    bs = BatchSession(cfg, n_seq)  # the default device: the card
    check(bs.device.type == "cuda", f"default device is {bs.device}")
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(frames) + 1)]
    inserted = []
    marks[0].record()
    for i, (depth, rgb) in enumerate(frames):
        before = bs.keyframe_counts.sum()
        bs.process_frames(i / cfg.camera.fps, depth[:n_seq], rgb[:n_seq])
        marks[i + 1].record()
        inserted.append(bs.keyframe_counts.sum() > before)
    torch.cuda.synchronize()
    ms = np.array([marks[i].elapsed_time(marks[i + 1]) for i in range(len(frames))])
    return bs, ms, np.array(inserted)


def _profile_tracked_steps(cfg, frames, n_seq: int, n_steps: int = 5) -> None:
    """Trace `n_steps` tracked steps (keyframe thresholds out of reach, so
    no step inserts) of a BatchSession of `n_seq` sequences and print what
    the device did a step."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from slam_rgbd_tpu_torch import BatchSession

    never = dataclasses.replace(cfg.keyframes, kf_min_trans=1e9, kf_min_rot_deg=1e9,
                                kf_min_inlier_ratio=0.0)
    bs = BatchSession(dataclasses.replace(cfg, keyframes=never), n_seq)
    step = lambda i: bs.process_frames(i / cfg.camera.fps, frames[i][0][:n_seq],
                                       frames[i][1][:n_seq])
    for i in range(STEADY_FROM):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STEADY_FROM, STEADY_FROM + n_steps):
        step(i)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(STEADY_FROM + n_steps, STEADY_FROM + 2 * n_steps):
            step(i)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    dev_us, dev_ops, launches = 0.0, 0, 0
    for ev in prof.key_averages():
        # device-side events (kernels, copies, fills) only: a host-side op
        # event carries its kernels' time a second time
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            dev_us += ev.self_cuda_time_total if us is None else us
            dev_ops += ev.count
        elif ev.key == "cudaLaunchKernel":
            launches += ev.count
    check(dev_us > 0, "the profiler recorded no device time")
    print(f"profile, B={n_seq}, {n_steps} tracked steps: {dev_ops / n_steps:.0f} device "
          f"operations a step ({launches / n_steps:.0f} cudaLaunchKernel), device time "
          f"{dev_us / 1e3 / n_steps:.3f} ms a step, step {traced_ms:.2f} ms under the "
          f"profiler ({plain_ms:.2f} ms without): device busy share "
          f"{dev_us / 1e3 / n_steps / traced_ms:.4f}")


def batch_phase(cfg, with_profile: bool = False) -> dict:
    """BatchSession at full width under the loop leg's settings."""
    phase("batch")
    import dataclasses

    from slam_rgbd_tpu_torch.backend import pose_graph as pg_mod
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg
    from slam_rgbd_tpu_torch.ops import hamming as th
    from slam_rgbd_tpu_torch.runtime import batch_session as tbs

    dev = torch.device("cuda", 0)
    cam = cfg.camera
    leg = dataclasses.replace(
        cfg,
        icp=dataclasses.replace(cfg.icp, drift_xi=LOOP_LEG_DRIFT),
        keyframes=dataclasses.replace(cfg.keyframes, kf_min_trans=0.06),
        ba=dataclasses.replace(cfg.ba, loop_min_interval=5, loop_cooldown_kf=3))
    t0 = time.perf_counter()
    sweep = orbit_trajectory(BATCH_FRAMES, sweep=True)
    gts = [sweep, sweep] + [
        orbit_trajectory(BATCH_FRAMES, step_t=0.012 + 0.004 * b,
                         step_r=0.01 + 0.002 * b, seed=b) for b in (2, 3)]
    frames = _batch_frames(gts, cam, dev)
    torch.cuda.synchronize()
    print(f"rendered 3 x {BATCH_FRAMES} frames {cam.width}x{cam.height} in "
          f"{time.perf_counter() - t0:.1f} s (sequences 0 and 1 share the sweep)")

    counters = (tg.gn_reduce_batched, tg.gn_reduce, th.gated_match, th.hamming_top2)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    watch = _Stopwatch((tbs, "_batch_ba"), (tbs, "_batch_loop_close"),
                       (pg_mod, "optimize_pose_graph"), (tbs, "_batch_features"))
    # how far each BA pass moved each sequence's live pose (the rigid
    # correction of its newest keyframe), kept on the card until the end
    ba_moves = []
    real_ba = tbs._batch_ba

    def ba_probe(maps, T_world, do_ba, cfg):
        out = real_ba(maps, T_world, do_ba, cfg)
        ba_moves.append(torch.linalg.norm(out[1][:, :3, 3] - T_world[:, :3, 3], dim=-1))
        return out

    tbs._batch_ba = ba_probe
    try:
        with watch:
            bs, ms, inserted = _batch_run(leg, frames, BATCH_B)
    finally:
        tbs._batch_ba = real_ba
    ba_move_cm = (100 * torch.stack(ba_moves).amax(dim=0)).tolist()
    batched, single, gated, top2 = (c.launches for c in counters)
    peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 2**20
    _, est = bs.poses()
    gt = np.stack(gts)
    ate = bs.ate_per_sequence(gt)
    kf, n_pt = bs.keyframe_counts, bs.map_point_counts()
    steady = slice(STEADY_FROM, None)
    step_ms, ins = ms[steady], inserted[steady]
    tracked, with_insert = step_ms[~ins], step_ms[ins]
    steps_s = len(step_ms) / (step_ms.sum() / 1e3)
    print(f"gn_reduce_batched launches {batched} (expected 42 x {BATCH_FRAMES - 1} = "
          f"{42 * (BATCH_FRAMES - 1)}), single gn_reduce launches {single} (0), "
          f"gated_match launches {gated} (one an insert with a map: "
          f"{int((kf - 1).sum())}), hamming_top2 launches {top2} (two a loop "
          f"verification or relocalization)")
    print(f"keyframes {kf.tolist()}, map points {n_pt.tolist()}, loops "
          f"{bs.state.loops.tolist()}, lost {bs.state.lost.tolist()}, relocalized "
          f"{bs.state.relocalized.tolist()}, edges {[int(n) for n in bs.n_edges]}, "
          f"peak device memory of the run {peak_mb:.1f} MiB")
    twin_diff = float(np.abs(est[0] - est[1]).max())
    print(f"per-sequence ATE {[round(100 * float(a), 3) for a in ate]} cm; sequences 0 "
          f"and 1 (the same frames) differ by at most {twin_diff:.2e} in their poses "
          f"(<= 1e-4: every sum of the path has a fixed order)")
    print(f"steady state (steps {STEADY_FROM}-{BATCH_FRAMES - 1}), B={BATCH_B}: "
          f"{steps_s:.2f} batch steps/s = {BATCH_B * steps_s:.2f} sequence-frames/s; "
          f"tracked steps ({len(tracked)}): p50 {np.percentile(tracked, 50):.3f} ms, p99 "
          f"{np.percentile(tracked, 99):.3f} ms; steps with an insert "
          f"({len(with_insert)}): p50 {np.percentile(with_insert, 50):.3f} ms, p99 "
          f"{np.percentile(with_insert, 99):.3f} ms")
    print(f"largest move of a sequence's live pose by one BA pass "
          f"{[round(x, 2) for x in ba_move_cm]} cm")
    print("host clock, synchronised: " + "; ".join(
        watch.report(n) for n in ("_batch_features", "_batch_ba", "_batch_loop_close",
                                  "optimize_pose_graph")))

    check(batched == 42 * (BATCH_FRAMES - 1),
          "the batch session did not run the batched kernel 42x a tracked step")
    check(single == 0, f"{single} single gn_reduce launches from the batch session")
    check(gated == int((kf - 1).sum()), f"{gated} gated_match launches for keyframes {kf}")
    check(top2 > 0 and top2 % 2 == 0, f"{top2} hamming_top2 launches")
    check(est.shape == (BATCH_B, BATCH_FRAMES, 4, 4) and np.isfinite(est).all(),
          f"poses: shape {est.shape} or non-finite")
    check(twin_diff <= 1e-4, "two sequences fed the same frames ended apart")
    check(bs.state.loops[0] >= 1 and bs.state.loops[1] >= 1,
          f"loops closed {bs.state.loops.tolist()}: a sweep sequence closed none")
    check(len({(int(kf[b]), int(n_pt[b])) for b in (0, 2, 3)}) == 3,
          "unlike sequences ended with the same keyframes and map points")
    check((kf >= 3).all() and (n_pt > 100).all(), f"keyframes {kf}, map points {n_pt}")

    # the same sweep with the loop search off (no candidate can score 2.0)
    off_cfg = dataclasses.replace(
        leg, ba=dataclasses.replace(leg.ba, loop_min_score=2.0))
    off, off_ms, _ = _batch_run(off_cfg, frames, 1)
    ate_off = float(off.ate_per_sequence(gt[:1])[0])
    print(f"sweep with loops off, B=1: ATE {100 * ate_off:.3f} cm, loops "
          f"{off.state.loops.tolist()}, keyframes {off.keyframe_counts.tolist()}; B=1 "
          f"steps p50 {np.percentile(off_ms[steady], 50):.3f} ms; with loops on ATE "
          f"{100 * float(ate[0]):.3f} / {100 * float(ate[1]):.3f} cm")
    check(off.state.loops[0] == 0, "a loop closed with the search off")
    check(ate[0] < ate_off and ate[1] < ate_off,
          f"ATE with loops on {ate[:2]} not below loops off {ate_off}")
    if with_profile:
        for n_seq in (BATCH_B, 1):
            _profile_tracked_steps(leg, frames, n_seq)
    return {"batched": batched, "gated": gated, "top2": top2}


def main() -> int:
    flags = set(sys.argv[1:])
    check(flags <= {"--control", "--profile"}, f"unknown arguments {sys.argv[1:]}")
    with_control, with_profile = "--control" in flags, "--profile" in flags
    card = device_phase()
    from slam_rgbd_tpu_torch import astra_default_config

    cfg = astra_default_config()
    build_phase()
    gn = gn_kernel_phase(cfg)
    gnb = gn_batched_kernel_phase(cfg)
    ham = hamming_kernel_phase(cfg)
    small_phase(cfg)
    run = main_phase(cfg, with_control)
    reloc = reloc_phase(run)
    lost = lost_phase(cfg, run)
    main_launches, gated_launches = run["launches"], run["gated_launches"]
    del run  # the sweep's frames and map
    torch.cuda.empty_cache()
    small_batch_phase(cfg)
    batch = batch_phase(cfg, with_profile)
    full_res = f"{cfg.camera.height}x{cfg.camera.width}"
    full = next(r for r in gn["rows"] if r["shape"].startswith(full_res))
    # the batch phase's shape: BATCH_B problems at full resolution
    full_b = next(r for r in gnb["rows"]
                  if r["shape"].startswith(full_res) and r["B"] == BATCH_B)
    csrc = "slam_rgbd_tpu_torch/ops/csrc/"
    timing = ("ms", "plain_ms", "bound_ms", "bound_by")
    kernels = [
        dict(name="gn_reduce", route="cuda", source=csrc + "gn_reduce.cu",
             replaces="slam_rgbd_tpu/ops/icp_pallas.py:413",
             launches=main_launches, max_abs_err=gn["max_err"],
             **{k: full[k] for k in timing}, library_ms=None),
        dict(name="gn_reduce_batched", route="cuda", source=csrc + "gn_reduce.cu",
             replaces="slam_rgbd_tpu/ops/icp_pallas.py:493",
             launches=batch["batched"], max_abs_err=gnb["max_err"],
             **{k: full_b[k] for k in timing}, library_ms=None),
        dict(name="gated_match", route="cuda", source=csrc + "hamming.cu",
             replaces="slam_rgbd_tpu/ops/hamming_pallas.py:291",
             launches=gated_launches + batch["gated"],
             max_abs_err=ham["gated_match"]["max_abs_err"],
             **{k: ham["gated_match"][k] for k in timing}, library_ms=None),
        dict(name="hamming_top2", route="cuda", source=csrc + "hamming.cu",
             replaces="slam_rgbd_tpu/ops/hamming_pallas.py:119",
             launches=lost["launches"] + reloc["launches"] + batch["top2"],
             max_abs_err=ham["hamming_top2"]["max_abs_err"],
             **{k: ham["hamming_top2"][k] for k in timing}, library_ms=None),
    ]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
