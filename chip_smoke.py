#!/usr/bin/env python3
"""Drive the port's tracking path once on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each fatal on failure:

  1. device  - a CUDA card is required; prints its name and power limit.
  2. build   - compiles the kernels from `slam_rgbd_tpu_torch/ops/csrc/`
               with nvcc for sm_90a.
  3. kernels - `gn_reduce` (the CUDA kernel) against `gn_reduce_reference`
               (plain torch) on the card, on a rendered 640x480 frame pair at
               the three pyramid levels the tracker uses; median device
               times of both over 50 calls (CUDA events).
  4. small   - a 160x120 sequence tracked on the card and on the CPU (plain
               path): the poses agree.
  5. main    - a 240-frame 640x480 out-and-back orbit (the JAX package's
               bench scene) through `TrackingSession(device="cuda")`: every
               GN reduction a kernel launch (42 a tracked frame), no lost
               frame, ATE against ground truth within 5 cm, the TUM export
               reloads; frames/s and per-frame p50/p99 from CUDA events.

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
SMALL_FRAMES = 6
ATE_LIMIT_M = 0.05  # BASELINE.md target
STEADY_FROM = 10  # frames before this warm up (allocator, cuBLAS handles)
TIMING_LAUNCHES = 50


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


def kernel_phase(cfg) -> dict:
    """gn_reduce vs gn_reduce_reference at the tracker's three level shapes."""
    phase("kernels")
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
        rows.append({"shape": shape, "ms": ms, "plain_ms": plain_ms})
    return {"max_err": worst, "rows": rows}


def small_phase(cfg) -> None:
    """The same short sequence on the card and on the CPU (plain path)."""
    phase("small")
    import dataclasses

    from slam_rgbd_tpu_torch import TrackingSession
    from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence

    cam = cfg.camera.scaled(4.0)  # 160x120
    small = dataclasses.replace(cfg, camera=cam)
    frames = list(SyntheticSequence(SMALL_FRAMES, cam, sweep=True))
    out = {}
    for dev in ("cpu", "cuda"):
        sess = TrackingSession(small, device=dev)
        for f in frames:
            sess.process_frame(*f)
        out[dev] = sess.poses()[1]
        check(np.isfinite(out[dev]).all(), f"{dev}: non-finite poses")
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    print(f"160x120, {SMALL_FRAMES} frames: card vs CPU max pose diff {err:.2e} (<= 1e-4)")
    check(err <= 1e-4, "card and CPU sessions disagree")


def main_phase(cfg) -> dict:
    phase("main")
    from slam_rgbd_tpu_torch import TrackingSession
    from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse, load_trajectory_tum
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory, render_frame
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg

    dev = torch.device("cuda", 0)
    cam = cfg.camera
    t0 = time.perf_counter()
    gt = orbit_trajectory(N_FRAMES, sweep=True)
    # frames stay on the card, as in the JAX package's bench
    frames = [render_frame(p, cam, device=dev) for p in gt]
    torch.cuda.synchronize()
    print(f"rendered {N_FRAMES} frames {cam.width}x{cam.height} in "
          f"{time.perf_counter() - t0:.1f} s")

    sess = TrackingSession(cfg, device="cuda")
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(N_FRAMES + 1)]
    tg.gn_reduce.launches = 0
    marks[0].record()
    wall0 = time.perf_counter()
    for i, (depth, rgb) in enumerate(frames):
        sess.process_frame(i / cam.fps, depth, rgb)
        marks[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    launches = tg.gn_reduce.launches
    ts, est = sess.poses()

    per_frame = np.array([marks[i].elapsed_time(marks[i + 1])
                          for i in range(STEADY_FROM, N_FRAMES)])
    steady_s = marks[STEADY_FROM].elapsed_time(marks[N_FRAMES]) / 1e3
    fps = (N_FRAMES - STEADY_FROM) / steady_s
    ate, _, _ = ate_rmse(est, gt)
    keyframes = sess.state.keyframes
    print(f"launches {launches} (expected 42 x {N_FRAMES - 1} = {42 * (N_FRAMES - 1)}), "
          f"lost {sess.state.lost}, keyframes {keyframes}")
    print(f"ATE {ate * 100:.3f} cm (limit {ATE_LIMIT_M * 100:.0f} cm)")
    print(f"steady state (frames {STEADY_FROM}-{N_FRAMES - 1}): {fps:.2f} frames/s, "
          f"p50 {np.percentile(per_frame, 50):.3f} ms, p99 "
          f"{np.percentile(per_frame, 99):.3f} ms; whole run {wall:.2f} s wall")

    check(launches == 42 * (N_FRAMES - 1), "main path did not run the kernel 42x a frame")
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
    return {"launches": launches, "fps": fps, "ate": ate}


def main() -> int:
    card = device_phase()
    from slam_rgbd_tpu_torch import astra_default_config

    cfg = astra_default_config()
    build_phase()
    kern = kernel_phase(cfg)
    small_phase(cfg)
    run = main_phase(cfg)
    full = next(r for r in kern["rows"] if r["shape"].startswith(
        f"{cfg.camera.height}x{cfg.camera.width}"))
    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "gn_reduce",
        "route": "cuda",
        "source": "slam_rgbd_tpu_torch/ops/csrc/gn_reduce.cu",
        "replaces": "slam_rgbd_tpu/ops/icp_pallas.py:413",
        "launches": run["launches"],
        "max_abs_err": kern["max_err"],
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
