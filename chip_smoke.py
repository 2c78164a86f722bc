#!/usr/bin/env python3
"""Drive the port's SLAM sessions once on one CUDA card and check them.

    python3 chip_smoke.py [--control] [--profile]

Run from the root of a checkout. `--control` adds two tracking-only sweeps
to the main phase, one before and one after the measured sweep, to show how
far the host's speed moves within the process, and after them the same sweep
with the backend inline, to show what the worker thread takes off the
keyframe calls. `--profile` adds a
`torch.profiler` trace of a few tracked frames of the single session and of
a few tracked batch steps at B = 4 and B = 1 (device operations a frame or
step, their device time, the card's busy share, and the flow shift's part of
them). Phases, each fatal on failure:

  1. device  - a CUDA card is required; prints its name and power limit.
  2. build   - compiles the kernels from `slam_rgbd_tpu_torch/ops/csrc/`
               with nvcc for sm_90a (one nvcc a source, in parallel).
  3. kernels - the time of an empty kernel launch (`launch_floor_ms`), then
               each CUDA kernel against its plain torch version on the card:
               `gn_reduce` and `gn_step` (the same launch, which goes on to
               the damped solve and the pose update) on a rendered 640x480
               frame pair at the three pyramid levels the tracker uses,
               `gn_step`'s next pose against `solve_update_written_out` and
               `_apply_update`, a degenerate system included;
               `gated_match` (1024 x 16384, merge tier on and off)
               and `hamming_top2` (1024 x 16384 and 16384 x 1024) on the
               descriptors and geometry of rendered 640x480 keyframes in a
               16384-slot map, with seeded ties and masked rows, both again
               on that map with every slot filled, and `hamming_top2` at
               1024 x 1024 on two keyframes' descriptors (a loop
               verification), all outputs exactly equal to the plain
               version's and to a second launch. Median device times of kernel and
               plain version over 50 calls (CUDA events), and the least time
               the card could take for the same work.
               `gn_reduce_batched` / `gn_step_batched` with 8, 4 and 1
               problems (frame pairs at different poses) at the same three
               shapes, and at the coarsest the tracker's stacked starts: three
               poses over one shared set of planes (the single session) and
               3 x 4 poses over 4 sets, three a set (the batch session):
               equal to the plain version, two launches identical,
               and each problem identical bit for bit to a single launch on
               its slice.
  4. small   - a 160x120 sequence through the session on the card and on the
               CPU (plain path): poses, keyframes and map agree.
  5. small backend - a 160x120 out-and-back sweep under injected odometry
               drift through the session with its backend inline (BA, loop
               search, verification, pose graph, fusion, global BA), on the
               card and on the CPU: keyframes, loops and the frames the
               loop merges land on equal, poses within 1e-3 m.
  6. main    - a 240-frame 640x480 out-and-back orbit (the JAX package's
               bench scene) through `SLAMSession(async_backend=True)` on
               the card at full width (1024 features, 8 levels, 256
               keyframes, 16384 map points), drained with
               `sync_backend(final_pass=True)` as the JAX package's
               `bench_session` runs it: every GN iteration one kernel launch
               (10 batched ones for the three coarse starts and 7 + 5
               single ones a tracked frame), one `gated_match` launch a
               keyframe insert that had a map, the backend's passes on its
               worker thread and stream (`hamming_top2` for loop
               verification and fusion), no lost frame, ATE within 5 cm, no
               ERROR record from the port's loggers, the TUM export
               reloads; frames/s and p50/p99 of tracked calls, insert calls
               and calls that merged a backend result from CUDA events.
  7. reloc   - on the map the main phase built, `_relocalize` of a sweep
               frame from an estimate off by 5 cm / 2 deg: accepted, back
               within 3 cm, exactly two `hamming_top2` launches.
  8. lost    - twelve 640x480 frames through `process_frame`, one with its
               depth blanked outside a central window: frames are lost and
               relocalized against the map (two `hamming_top2` launches a
               try), tracking comes back, ATE within 5 cm.
  9. degraded - the main phase's 240 frames through the sensor model
               (`NoiseSpec(motion_blur=1.0, exposure_drift=0.08)`, applied
               on the card) and the threaded session: all poses finite,
               ATE within 5 cm; lost and relocalized frames.
 10. pipeline - the reference's `run` / `play` path from host frames: the
               first 120 sweep frames brought to the host and recorded with
               the native `.rgbd` codec (read back bit for bit); the host ms
               of a frame's upload, plain and through the session's pinned
               ring, idle and behind queued device work (the pinned upload
               returns with the stream busy, both equal bit for bit); the
               clip played through the threaded `PipelineRunner` (native
               prefetcher paced at 30 fps, backend on its worker) with a live
               `PointCloudServer` fetched during the run (processed + dropped
               = 120, ATE within 5 cm paired by timestamp, metrics records,
               no watchdog stall, points served); a scripted `ControlMenu`
               (s, record, stop, q before the clip ends: shutdown in time, the
               tee reads back); `checkpoint.save` at frame 60, `restore` into a
               fresh session bit for bit, frames 60-119 on it; and
               `python -m slam_rgbd_tpu_torch run tests/data/tum_golden --tum`
               and `eval` as subprocesses on the card.
 11. loop leg - the JAX package's `bench_loop_leg` at full width: 120
               frames of the sweep under injected drift, the backend
               inline, loops off and on: no loop off, at least one on, ATE
               on below ATE off.
 12. small batch - two different 160x120 sequences through
               `BatchSession` on the card and on the CPU: poses, keyframes
               and maps agree.
 13. batch  - `BatchSession(cfg, 4)` at full width over 120 frames of
               640x480 under injected odometry drift (the JAX bench's loop
               leg): sequences 0 and 1 the out-and-back sweep, 2 and 3
               forward orbits. 22 `gn_reduce_batched` launches a tracked
               step and no single `gn_reduce` launch, one `gated_match`
               launch an insert with a map, `hamming_top2` launches from
               loop verification, all poses finite, the sweep sequences
               close a loop each, and their ATE is below that of the same
               sweep with the loop search off.
  14. parallel - the parallel layer (`slam_rgbd_tpu_torch/parallel/`) at full
               width: this process as one NCCL rank (mesh (1, 1)) runs the
               five sharded programs of `parallel.dist` (`sharded_local_ba`
               on the main phase's newest BA window, `batch_track` on the
               batch phase's first step of four sequences, K1b;
               `sharded_map_association` at 1024 x 16384 on the kernels
               phase's map, merge tier on and off, K3; `sharded_pose_graph`
               on the loop leg's keyframes and edges; `sharded_hamming_match`
               at 1024 x 16384, K2), each against the unsharded port (BA
               poses 5e-5 / points 5e-4, pose graph 1e-5, the rest exact);
               then two ranks share the card over gloo: the same programs
               on a (1, 2) mesh (blocks of 8192 points, 512 query rows;
               replicated outputs equal on both ranks), and
               `BatchSession(cfg, 4, mesh=)` on a (2, 1) mesh over the batch
               phase's first 30 frames, whose poses, keyframes, loops, lost
               frames and map points equal an unsharded `BatchSession` on
               the same frames; the ranks' K1b / K2 / K3 launches join the
               kernel table; then `SLAMSession(cfg, mesh=)` (each rank half
               of the point table) over 62 sweep frames at 640x480, one of
               them damaged, inline against the unsharded session bit for
               bit, and threaded (`async_backend=True`): forced by
               `sync_backend()` each call against the threaded unsharded
               session bit for bit, and free-running with the ranks equal
               to each other bit for bit and the ATE within 5 cm; their
               launches join the table too. Then `scaling.batch_scaling` at B = 1 / 2 / 4 /
               8 and `python -m slam_rgbd_tpu_torch benchmark --scaling` as
               a subprocess (the report names the card, one device).

The line before the last holds the kernel table as JSON; the last line is
`{"ok": true, "device": {...}}`. Any failure exits non-zero without it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
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
PAR_FRAMES = 30  # the sharded batch session's frames: the batch phase's first
PAR_RANKS = 2  # ranks that share the card in the parallel phase (gloo)
SCALING_ITERS = 50  # timed steps a batch size in the parallel phase's batch_scaling
SHARD_FRAMES = 60  # the sharded session's clean frames (the sweep's first); then
#                    one damaged (a relocalization) and one more
AGREE_CALLS = 200  # timed calls of the threaded sharded session's agreement
KERNEL_B = (8, 4, 1)  # problems a launch in the batched kernel's phase
# the loop leg of the JAX package's bench: a constant twist composed onto
# every tracked relative pose, denser keyframes, a shorter loop interval
LOOP_LEG_DRIFT = (0.006, 0.0, 0.003, 0.0, 0.003, 0.0)
MATCHED_SHARE_MIN = 0.5  # of a later keyframe's valid keypoints, see main_phase
LOOP_FRAMES = 120  # the loop leg's sweep (`bench_loop_leg`'s n_frames)
SMALL_BACKEND_FRAMES = 100
PIPE_FRAMES = 120  # the pipeline phase's clip: the first frames of the sweep
PIPE_FPS = 30.0  # its playback pace, the sensor's rate
UPLOAD_SPIN_MS = 5.0  # device work queued ahead of a timed upload
ROOT = os.path.dirname(os.path.abspath(__file__))
# the JAX package's results on these legs, from its TPU bench
# (`BENCH_r05.json`): accuracy only, printed beside the card's as the
# reference's
REFERENCE_ANCHORS = ("reference (JAX package, BENCH_r05.json, a TPU run): clean "
                     "sweep ATE 1.679 cm with 20 keyframes; loop leg ATE 23.2 cm "
                     "off -> 8.1 cm on; degraded ATE 1.73 cm, 1 lost, 1 relocalized")

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): device
# memory, float32 outside the tensor cores, int8 in the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_INT8_S = 1979e12


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


class _Errors(logging.Handler):
    """Every ERROR record of the port's loggers (a failed backend pass, a
    merge the guard dropped, a drain that timed out): a phase that drives a
    session fails on any."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(record)


ERRORS = _Errors()


def check_no_errors(what: str) -> None:
    msgs = [f"{r.name}: {r.getMessage()}" for r in ERRORS.records]
    ERRORS.records.clear()
    check(not msgs, f"{what}: ERROR records {msgs}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_ms(fn, n: int = TIMING_LAUNCHES) -> tuple[float, float]:
    """(median device ms of one `fn()` call over n calls, share of the
    timed span the device was busy).

    A spin kernel holds the card while the host queues all n calls, so the
    event pairs bracket device work and not the host's launch overhead
    (which exceeds it for these small calls). A pass in which the host took
    longer to queue them than the spin lasts is taken once more with a
    longer spin (a call of many operations fills the launch queue and waits
    for the spin to end whatever its length: its time is the host's). The
    busy share is the sum of the pairs over the span from the first to the
    last event: near 1 when the queue never ran dry."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    spin_s = 3.0 * enqueue_s + 1e-3
    for _ in range(2):
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(n)]
        t0 = time.perf_counter()
        torch.cuda._sleep(int(spin_s * 2.0e9))  # cycles; the clock is below 2 GHz
        for a, b in pairs:
            a.record()
            fn()
            b.record()
        queued_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if queued_s < spin_s:
            break
        spin_s = 2.0 * queued_s  # the host fell behind the spin: again, longer
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


def launch_floor_phase() -> float:
    """Device time of an empty kernel launch: what no call can go below."""
    phase("kernels: launch floor")
    from slam_rgbd_tpu_torch.ops import _build

    lib = _build.load()

    def empty():
        _build.check(lib.gn_reduce_empty_launch(torch.cuda.current_stream().cuda_stream),
                     "empty launch")

    ms, busy = device_ms(empty)
    print(f"launch_floor_ms {ms:.4f} (an empty kernel between two events, device "
          f"median of {TIMING_LAUNCHES}, queue busy share {busy:.3f})")
    return ms


def _gn_errors(got, ref) -> tuple[float, float, float, int]:
    """(H err / scale, g err / scale, sq_sum relative err, inlier difference)
    of one problem's (H, g, inliers, sq_sum) against the plain version's."""
    H1, g1, i1, s1 = (x.cpu().numpy() for x in got)
    H0, g0, i0, s0 = (x.cpu().numpy() for x in ref)
    h_scale = max(1.0, float(np.abs(H0).max()))
    g_scale = max(1.0, float(np.abs(g0).max()))
    return (float(np.abs(H1 - H0).max()) / h_scale, float(np.abs(g1 - g0).max()) / g_scale,
            abs(float(s1) - float(s0)) / max(abs(float(s0)), 1e-30), int(i1) - int(i0))


def _gn_bound(tg, n_b: int, n_sets: int, n_px: int):
    """Each plane set, pose and flow read once, 60 values a problem written
    (H, g, sq_sum, inliers, the next pose); ~300 float operations a pixel
    (projection, four-corner sampling of ten channels, two 7-vector outer
    products) and ~500 a problem for the pose update."""
    return bound(4.0 * (n_sets * (tg.SRC_CHANNELS + tg.TGT_CHANNELS) * n_px + n_b * (18 + 60)),
                 f32_ops=n_b * (300.0 * n_px + 500.0))


def gn_kernel_phase(cfg) -> dict:
    """gn_reduce / gn_step vs their plain versions at the tracker's three
    level shapes."""
    phase("kernels: gn_reduce, gn_step")
    from slam_rgbd_tpu_torch.core import camera, se3
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
        _, radius = icp._level_schedule(icfg, icfg.levels, k)
        src = icp.level_planes(pyrs[1][k])[: tg.SRC_CHANNELS].contiguous()
        tgt = icp.level_planes(pyrs[0][k])
        _, up, vp, _ = icp._project_level(T, pyrs[1][k]["vertices"], lcam)
        mu = icp.flow_shift(up, vp, lcam.height, lcam.width)
        args = (T, mu, src, tgt, lcam, icfg, radius)

        k1 = tg.gn_reduce(*args)
        k2 = tg.gn_reduce(*args)
        s1 = tg.gn_step(*args)
        s2 = tg.gn_step(*args)
        ref = tg.gn_reduce_reference(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)), "two kernel runs differ")
        check(all(torch.equal(a, b) for a, b in zip(s1, s2)), "two gn_step runs differ")
        check(all(torch.equal(a, b) for a, b in zip(k1, s1[1:])),
              "gn_step's reduction differs from gn_reduce's")
        err_h, err_g, err_s, d_inl = _gn_errors(k1, ref)
        shape = f"{lcam.height}x{lcam.width}/R{radius}"
        print(f"{shape}: mu={mu.tolist()} inliers kernel {int(k1[2])} plain "
              f"{int(ref[2])}; H err/scale {err_h:.2e} (<= 2e-6), g err/scale "
              f"{err_g:.2e} (<= 5e-5), sq_sum rel err {err_s:.2e} (<= 1e-4)")
        check(err_h <= 2e-6 and err_g <= 5e-5 and err_s <= 1e-4,
              f"{shape}: kernel disagrees with plain version")
        check(int(k1[2]) > 1000, f"{shape}: only {int(k1[2])} inliers")
        if d_inl != 0:
            # per-pixel arithmetic rounds alike in both, so a difference can
            # only come from a gate that the final float sums do not touch
            print(f"  inliers differ by {d_inl}: a pixel on a gate threshold")
        check(abs(d_inl) <= 2, f"{shape}: inliers differ by {d_inl}")
        worst = max(worst, err_h, err_g)

        # the pose update of the same launch: against its own arithmetic
        # written out in torch (sin / cos may differ in the last bit) and
        # against the tracker's plain step (library Cholesky and products)
        T_next, H, g, inl, _ = s1
        written = tg.solve_update_written_out(T, H, g, inl, icfg.damping)
        applied = icp._apply_update(T, H, g, inl, icfg)
        err_w = float((T_next - written).abs().max())
        err_a = float((T_next - applied).abs().max())
        # no valid source pixel: no inliers, the identity step
        dead = src.clone()
        dead[6] = 0.0
        T_dead, _, _, inl_dead, _ = tg.gn_step(T, mu, dead, tgt, lcam, icfg, radius)
        err_d = float((T_dead - se3.normalize_rotation(T)).abs().max())
        print(f"  gn_step: T_next vs solve_update_written_out {err_w:.2e} (<= 1e-6), vs "
              f"_apply_update {err_a:.2e} (<= 1e-5), moved the pose by "
              f"{float((T_next - T).abs().max()):.2e}; all-invalid source: inliers "
              f"{int(inl_dead)}, identity step to {err_d:.2e} (<= 1e-6)")
        check(err_w <= 1e-6 and err_a <= 1e-5, f"{shape}: gn_step's pose update disagrees")
        check(float((T_next - T).abs().max()) > 1e-6, f"{shape}: gn_step did not move the pose")
        check(int(inl_dead) == 0 and err_d <= 1e-6, f"{shape}: no identity step")
        worst = max(worst, err_w)

        reduce_ms, _ = device_ms(lambda: tg.gn_reduce(*args))
        ms, busy = device_ms(lambda: tg.gn_step(*args))
        plain_ms, plain_busy = device_ms(lambda: tg.gn_step_reference(*args))
        b_ms, b_by = _gn_bound(tg, 1, 1, lcam.height * lcam.width)
        print(f"  device median of {TIMING_LAUNCHES}: gn_reduce {reduce_ms:.4f} ms, gn_step "
              f"{ms:.4f} ms, plain gn_step "
              f"{plain_ms:.4f} ms (queue busy share {busy:.3f} / {plain_busy:.3f}); bound "
              f"{b_ms:.4f} ms by {b_by}")
        rows.append({"shape": shape, "ms": ms, "reduce_ms": reduce_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
    return {"max_err": worst, "rows": rows}


def _sweep_pairs(cfg):
    """max(KERNEL_B) frame pairs (i, i + 1) spread over the sweep, as
    batched pyramids on the card -> (T (B, 4, 4) true relative poses,
    source pyramid, target pyramid)."""
    from slam_rgbd_tpu_torch.core import camera
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory, render_frame

    dev = torch.device("cuda", 0)
    cam, icfg = cfg.camera, cfg.icp
    n_max = max(KERNEL_B)
    gt = orbit_trajectory(N_FRAMES, sweep=True)
    first = [i * (N_FRAMES // n_max) for i in range(n_max)]

    def pyramid(idx):
        depth, rgb = (torch.stack(x) for x in zip(
            *(render_frame(gt[i], cam, device=dev) for i in idx)))
        return camera.build_frame_pyramid(depth, cam, levels=icfg.levels, rgb=rgb)

    T = torch.from_numpy(np.stack(
        [np.linalg.inv(gt[i]) @ gt[i + 1] for i in first]).astype(np.float32)).to(dev)
    return T, pyramid([i + 1 for i in first]), pyramid(first)


def gn_batched_kernel_phase(cfg) -> dict:
    """gn_reduce_batched / gn_step_batched vs their plain versions and vs
    single launches, at the tracker's three level shapes, for frame pairs of
    the sweep at eight different poses; and the tracker's stacked coarse
    starts: three poses over one shared set of planes, and three poses a
    plane set over BATCH_B sets."""
    phase("kernels: gn_reduce_batched, gn_step_batched")
    from slam_rgbd_tpu_torch.core import se3
    from slam_rgbd_tpu_torch.odometry import icp
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg

    dev = torch.device("cuda", 0)
    cam, icfg = cfg.camera, cfg.icp
    n_max = max(KERNEL_B)
    T, src_pyr, tgt_pyr = _sweep_pairs(cfg)
    worst, rows = 0.0, []

    def one_case(shape, n_b, args, n_sets, with_plain, n_px):
        """Checks and times of one batched launch shape -> its row."""
        nonlocal worst
        lcam, radius = args[4], args[6]
        sets = lambda b: b // (n_b // n_sets)
        k1 = tg.gn_step_batched(*args)
        k2 = tg.gn_step_batched(*args)
        r1 = tg.gn_reduce_batched(*args)
        singles = [tg.gn_step(args[0][b], args[1][b], args[2][sets(b)], args[3][sets(b)],
                              lcam, icfg, radius) for b in range(n_b)]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              f"{shape} B={n_b}: two batched launches differ")
        check(all(torch.equal(a, b) for a, b in zip(k1[1:], r1)),
              f"{shape} B={n_b}: gn_step_batched's reduction differs from gn_reduce_batched's")
        check(all(torch.equal(a[b], c) for b in range(n_b) for a, c in zip(k1, singles[b])),
              f"{shape} B={n_b}: a problem differs from its single launch")
        written = tg.solve_update_written_out(args[0], k1[1], k1[2], k1[3], icfg.damping)
        err_w = float((k1[0] - written).abs().max())
        check(err_w <= 1e-6, f"{shape} B={n_b}: pose update off by {err_w:.2e}")
        worst = max(worst, err_w)
        reduce_ms, _ = device_ms(lambda: tg.gn_reduce_batched(*args))
        ms, busy = device_ms(lambda: tg.gn_step_batched(*args))
        b_ms, b_by = _gn_bound(tg, n_b, n_sets, n_px)
        row = {"shape": shape, "B": n_b, "sets": n_sets, "ms": ms, "reduce_ms": reduce_ms,
               "bound_ms": b_ms, "bound_by": b_by}
        if with_plain:
            ref = tg.gn_step_batched_reference(*args)
            torch.cuda.synchronize()
            errs = [_gn_errors([x[b] for x in k1[1:]], [x[b] for x in ref[1:]])
                    for b in range(n_b)]
            err_h, err_g, err_s = (max(e[i] for e in errs) for i in range(3))
            err_t = float((k1[0] - ref[0]).abs().max())
            inl = k1[3].tolist()
            print(f"{shape} B={n_b} over {n_sets} plane set(s): inliers {inl} (plain: equal "
                  f"{all(e[3] == 0 for e in errs)}); H err/scale {err_h:.2e} (<= 2e-6), g "
                  f"err/scale {err_g:.2e} (<= 5e-5), sq_sum rel err {err_s:.2e} (<= 1e-4), "
                  f"T_next vs plain gn_step {err_t:.2e} (<= 1e-5), vs its arithmetic "
                  f"written out {err_w:.2e} (<= 1e-6); two launches identical; every "
                  f"problem bit-identical to its single launch")
            check(err_h <= 2e-6 and err_g <= 5e-5 and err_s <= 1e-4 and err_t <= 1e-5,
                  f"{shape} B={n_b}: kernel disagrees with plain version")
            check(all(e[3] == 0 for e in errs) and min(inl) > 1000,
                  f"{shape} B={n_b}: inliers {inl} differ from the plain version's")
            check(len(torch.unique(k1[1].reshape(n_b, -1), dim=0)) == n_b,
                  "the problems do not differ")
            worst = max(worst, err_h, err_g)
            row["plain_ms"], _ = device_ms(lambda: tg.gn_step_batched_reference(*args), n=5)
        print(f"  {shape} B={n_b}: device median of {TIMING_LAUNCHES}: gn_reduce_batched "
              f"{reduce_ms:.4f} ms, gn_step_batched {ms:.4f} ms (queue busy share {busy:.3f})"
              + (f", plain {row['plain_ms']:.4f} ms" if "plain_ms" in row else "")
              + f"; bound {b_ms:.4f} ms by {b_by}")
        return row

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
            args = (T[:n_b], mu[:n_b], src[:n_b], tgt[:n_b], lcam, icfg, radius)
            rows.append(one_case(shape, n_b, args, n_b, n_b in (n_max, BATCH_B), n_px))
        if k == icfg.levels - 1:
            # the tracker's coarse starts: prior, identity, reversed prior
            # over the planes of pair 0, the batch made by `expand`
            starts = torch.stack([T[0], torch.eye(4, device=dev),
                                  se3.normalize_rotation(se3.inverse(T[0]))])
            verts = src_pyr[k]["vertices"][0]
            _, up, vp, _ = icp._project_level(starts, verts, lcam)
            mu3 = icp.flow_shift(up, vp, lcam.height, lcam.width)
            args = (starts, mu3, src[0].expand(3, -1, -1, -1), tgt[0].expand(3, -1, -1, -1),
                    lcam, icfg, radius)
            rows.append(one_case(shape, 3, args, 1, True, n_px))
            # the batch tracker's: the same three starts for each of BATCH_B
            # pairs, problem b * 3 + s reading plane set b
            n_s = BATCH_B
            starts = torch.stack([T[:n_s], torch.eye(4, device=dev).expand(n_s, 4, 4),
                                  se3.normalize_rotation(se3.inverse(T[:n_s]))],
                                 dim=1).reshape(3 * n_s, 4, 4)
            verts = src_pyr[k]["vertices"][:n_s].repeat_interleave(3, dim=0)
            _, up, vp, _ = icp._project_level(starts, verts, lcam)
            mu_s = icp.flow_shift(up, vp, lcam.height, lcam.width)
            args = (starts, mu_s, src[:n_s], tgt[:n_s], lcam, icfg, radius)
            rows.append(one_case(shape, 3 * n_s, args, n_s, True, n_px))
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


def _full_map(m, seed: int = 0):
    """`m` with every free point slot filled: each takes the descriptor of a
    valid point (cyclically) with eight of its bits flipped and the point's
    position moved by up to 3 cm, so that all 16384 slots are valid, near
    copies tie and the gates see a crowded map."""
    import dataclasses

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


def _gated_args(smap, m, desc, ok, kp, pts, T, cfg):
    """The arguments `match_against_map` hands `gated_match` for this query
    against map `m`, and the point ids it returns."""
    captured = {}
    real = smap.gated_match

    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return real(*args, **kw)

    smap.gated_match = capture
    try:
        pid = smap.match_against_map(
            m, desc.signs, ok, kp.uv, pts[:, 2], T, cam=cfg.camera,
            max_distance=float(cfg.orb.match_threshold), kp_pts=pts,
            merge_radius=cfg.keyframes.merge_radius)
    finally:
        smap.gated_match = real
    return captured["args"], captured["kw"], pid


def _gated_case(th, name: str, g_args, g_kw):
    """gated_match on one input set: equal to the plain version and to a
    second launch, timed, with its bound. -> (its row, the outputs)."""
    a = th.gated_match(*g_args, **g_kw)
    b = th.gated_match(*g_args, **g_kw)
    ref = th.gated_match_reference(*g_args, **g_kw)
    torch.cuda.synchronize()
    err = _assert_exact(f"gated_match {name}", a, b, ref)
    ms, busy = device_ms(lambda: th.gated_match(*g_args, **g_kw))
    plain_ms, _ = device_ms(lambda: th.gated_match_reference(*g_args, **g_kw), n=10)
    k1, k2 = g_args[0].shape[0], g_args[2].shape[0]
    # the pairs whose distance this run's data needs: valid query x valid
    # point; 256 multiply-adds a pair for the sign product, ~17 float
    # operations a pair for the two gates
    pairs = float(g_args[1][:, 3].sum()) * float(g_args[3][:, 3].sum())
    b_ms, b_by = bound((k1 + k2) * (256 + 32) + k1 * 16,
                       f32_ops=17.0 * pairs, int8_ops=2.0 * 256 * pairs)
    print(f"gated_match {name}: d1 i1 d2 i2 equal the plain version and a second "
          f"launch exactly; tier 1 matched {int((a[0] < 64).sum())}, tier 2 "
          f"{int((a[2] < 1e9).sum())} of {k1} queries")
    print(f"  device median of {TIMING_LAUNCHES}: kernel {ms:.4f} ms (queue busy "
          f"share {busy:.3f}), plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
          f"({pairs:.0f} unmasked pairs)")
    return {"shape": name, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err}, a


def _top2_case(th, name: str, args) -> dict:
    """hamming_top2 on one input set, as `_gated_case`. -> its row."""
    a = th.hamming_top2(*args)
    b = th.hamming_top2(*args)
    ref = th.hamming_top2_reference(*args)
    torch.cuda.synchronize()
    err = _assert_exact(f"hamming_top2 {name}", a, b, ref)
    tied = int(((a[0] == a[1]) & (a[0] < 1e9)).sum())
    ms, busy = device_ms(lambda: th.hamming_top2(*args))
    plain_ms, _ = device_ms(lambda: th.hamming_top2_reference(*args), n=10)
    n1, n2 = args[0].shape[0], args[2].shape[0]
    pairs = float(args[1].sum()) * float(args[3].sum())
    b_ms, b_by = bound((n1 + n2) * (256 + 1) + n1 * 12, int8_ops=2.0 * 256 * pairs)
    print(f"hamming_top2 {name}: best second idx equal the plain version and a second "
          f"launch exactly ({tied} rows with second == best, {int(args[1].sum())} valid "
          f"queries, {int(args[3].sum())} valid columns)")
    print(f"  device median of {TIMING_LAUNCHES}: kernel {ms:.4f} ms (queue busy "
          f"share {busy:.3f}), plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by}")
    return {"shape": name, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err}


def hamming_kernel_phase(cfg) -> dict:
    """gated_match and hamming_top2 vs their plain versions, exactly, at the
    shapes the sessions give them: 1024 query keypoints of a rendered
    640x480 frame against a 16384-slot map built from earlier frames (most
    slots free) and against the same map with every slot filled, both
    directions of the relocalization match, and two keyframes' 1024
    descriptors against each other as `backend.loop.verify_loop` matches
    them."""
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
    full = _full_map(m)

    # the query: a frame between two of the keyframes, at a pose 1 cm off
    q = 30
    depth, rgb = render_frame(gt[q], cam, device=dev)
    kp, desc, pts, ok = rs._features(depth, rgb, cfg.orb, cam)
    T = torch.from_numpy(rel[q]).to(dev).clone()
    T[0, 3] += 0.01
    g_args, g_kw, pid = _gated_args(smap, m, desc, ok, kp, pts, T, cfg)
    g_full, g_full_kw, _ = _gated_args(smap, full, desc, ok, kp, pts, T, cfg)
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
    check(bool(full.pt_valid.all()), "the full map has free slots")

    # ---- gated_match: the built map, the merge tier off, the full map
    n_ok = int(ok.sum())
    built, a = _gated_case(th, "1024 x 16384 built map", g_args, g_kw)
    matched = int((pid >= 0).sum())
    ties = int(((a[1] < 128) & (a[0] < 64)).sum())
    print(f"  {matched} of {n_ok} valid keypoints matched, {ties} on the tied block, "
          f"{int(m.pt_valid.sum())} valid map points")
    check(matched > 0.3 * n_ok, "the gates let too few matches through")
    off_kw = dict(g_kw, merge_radius=-1.0)
    off, a_off = _gated_case(th, "1024 x 16384 built map, merge tier off", g_args, off_kw)
    check(bool((a_off[2] == 1e9).all()), "merge tier off still matched")
    crowd, _ = _gated_case(th, "1024 x 16384 full map", g_full, g_full_kw)
    g_rows = [built, off, crowd]
    err = max(r["max_abs_err"] for r in g_rows)
    out = {"gated_match": dict(built, max_abs_err=err, rows=g_rows)}

    # ---- hamming_top2: both directions of the relocalization match on the
    # built and the full map, and a loop verification's keyframe pair
    s1, v1 = desc.signs, ok
    t_rows = [_top2_case(th, name, args) for name, args in (
        ("1024 x 16384 built map", (s1, v1, m.pt_signs, m.pt_valid)),
        ("16384 x 1024 built map", (m.pt_signs, m.pt_valid, s1, v1)),
        ("1024 x 16384 full map", (s1, v1, full.pt_signs, full.pt_valid)),
        ("16384 x 1024 full map", (full.pt_signs, full.pt_valid, s1, v1)),
        ("1024 x 1024 keyframes 5 / 2", (m.kp_signs[5], m.kp_ok[5],
                                         m.kp_signs[2], m.kp_ok[2])),
    )]
    mt = th.match_kernel(s1, v1, m.pt_signs, m.pt_valid,
                         max_distance=float(cfg.orb.match_threshold))
    print(f"match_kernel: {int(mt.valid.sum())} mutual matches of {n_ok} keypoints")
    check(int(mt.valid.sum()) > 50, "too few mutual matches for a relocalization")
    err = max(r["max_abs_err"] for r in t_rows)
    out["hamming_top2"] = dict(t_rows[0], max_abs_err=err, rows=t_rows)
    # the parallel phase's map association and matching run on this map and
    # this query
    out["inputs"] = {"map": m, "signs": desc.signs, "ok": ok, "uv": kp.uv,
                     "z": pts[:, 2].contiguous(), "pts": pts, "T": T}
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


def _drift_sweep_config(cfg):
    """The 160x120 drift sweep of the CPU parity test
    (`tests/test_torch_backend_session.py`): the loop settings of
    `tests/test_runtime.py:272-283`, keyframes ~1 in 10 frames, every
    decision resolved at the next call (`max_decision_lag=1`), so that the
    card and the CPU take the same decisions whatever the card's timing."""
    import dataclasses

    from slam_rgbd_tpu_torch.core.config import BAConfig, ICPConfig, RuntimeConfig

    return dataclasses.replace(
        cfg, camera=dataclasses.replace(cfg.camera, fx=120.0, fy=120.0, cx=79.5, cy=59.5,
                                        width=160, height=120),
        orb=dataclasses.replace(cfg.orb, n_features=256, n_levels=4),
        icp=ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2), drift_xi=LOOP_LEG_DRIFT),
        keyframes=dataclasses.replace(cfg.keyframes, max_keyframes=64, max_map_points=8192,
                                      kf_min_trans=0.2, kf_min_rot_deg=30.0),
        ba=BAConfig(window=4, iters=4, loop_min_interval=4, loop_cooldown_kf=2),
        runtime=RuntimeConfig(max_decision_lag=1))


def small_backend_phase(cfg) -> dict:
    """The session with its backend inline on the card and on the CPU."""
    phase("small backend")
    from slam_rgbd_tpu_torch import SLAMSession
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory, render_frame
    from slam_rgbd_tpu_torch.ops import hamming as th

    small = _drift_sweep_config(cfg)
    dev = torch.device("cuda", 0)
    gt = orbit_trajectory(SMALL_BACKEND_FRAMES, step_t=0.015, step_r=0.012, sweep=True)
    card = [render_frame(p, small.camera, device=dev) for p in gt]
    out = {}
    for where in ("cpu", "cuda"):
        frames = card if where == "cuda" else [(d.cpu(), c.cpu()) for d, c in card]
        th.hamming_top2.launches = 0
        t0 = time.perf_counter()
        sess = SLAMSession(small, device=where)
        for i, (d, c) in enumerate(frames):
            sess.process_frame(i / small.camera.fps, d, c)
        poses = sess.poses()[1]
        seconds = time.perf_counter() - t0
        check(np.isfinite(poses).all(), f"{where}: non-finite poses")
        st = sess.state
        out[where] = (poses, st.keyframes, st.loops, list(st.loop_merge_frames),
                      [i for i, x in enumerate(sess.stats) if x.is_keyframe],
                      th.hamming_top2.launches, seconds)
    check_no_errors("small backend")
    (p_cpu, kf_cpu, loops_cpu, mf_cpu, flags_cpu, _, s_cpu) = out["cpu"]
    (p_gpu, kf_gpu, loops_gpu, mf_gpu, flags_gpu, top2, s_gpu) = out["cuda"]
    err = float(np.abs(p_gpu[:, :3, 3] - p_cpu[:, :3, 3]).max())
    print(f"160x120, {SMALL_BACKEND_FRAMES} frames under drift, backend inline: keyframes "
          f"{kf_gpu} / {kf_cpu} (card / CPU), loops {loops_gpu} / {loops_cpu} merged at "
          f"frames {mf_gpu} / {mf_cpu}, max pose diff {err:.2e} m (<= 1e-3), "
          f"hamming_top2 launches on the card {top2}; {s_gpu:.1f} s / {s_cpu:.1f} s "
          f"(host clock)")
    check(kf_gpu == kf_cpu and flags_gpu == flags_cpu, "card and CPU insert other keyframes")
    check(loops_gpu == loops_cpu >= 1 and mf_gpu == mf_cpu,
          "card and CPU close other loops (or none)")
    check(err <= 1e-3, "card and CPU poses differ")
    check(top2 > 0 and top2 % 2 == 0, f"{top2} hamming_top2 launches")
    return {"top2": top2}


def _sweep(sess, frames, fps: float, merges: list | None = None,
           pass_ms: list | None = None):
    """Drive `sess` over the frames. -> (device ms of every call from CUDA
    events, which calls inserted a keyframe, wall seconds). A frame's
    keyframe decision is applied in a later call, so the insert is charged
    to the call that made it. With `merges`, it gets one flag a call: the
    call merged a backend result; with `pass_ms`, the host ms of each merged
    result's pass (`BackendResult.backend_ms`)."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(frames) + 1)]
    kf_calls = []
    applied = [0]
    real_apply = sess._apply_backend

    def apply(r):
        applied[0] += r is not None
        if r is not None and pass_ms is not None:
            pass_ms.append(r.backend_ms)
        return real_apply(r)

    sess._apply_backend = apply
    marks[0].record()
    wall0 = time.perf_counter()
    for i, (depth, rgb) in enumerate(frames):
        before, merged = sess.state.keyframes, applied[0]
        sess.process_frame(i / fps, depth, rgb)
        marks[i + 1].record()
        kf_calls.append(sess.state.keyframes > before)
        if merges is not None:
            merges.append(applied[0] > merged)
    sess.flush_pipeline()
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    del sess._apply_backend
    ms = np.array([marks[i].elapsed_time(marks[i + 1]) for i in range(len(frames))])
    return ms, np.array(kf_calls), wall


def _p(ms) -> str:
    """'n calls: p50 / p99 ms' of some call times."""
    if len(ms) == 0:
        return "0 calls"
    return (f"{len(ms)} calls: p50 {np.percentile(ms, 50):.3f} ms, p99 "
            f"{np.percentile(ms, 99):.3f} ms")


def _control_sweep(cfg, frames, cuda_graph: bool = True):
    """Steady-state call times of a session that only tracks: the same
    configuration with the keyframe thresholds out of reach, so that no call
    after the bootstrap runs the feature stage or touches the map. ->
    (call ms from frame STEADY_FROM on, poses, the session's frame graph)."""
    from slam_rgbd_tpu_torch import SLAMSession

    sess = SLAMSession(_never_a_keyframe(cfg), cuda_graph=cuda_graph)
    ms, _, _ = _sweep(sess, frames, cfg.camera.fps)
    check(sess.state.keyframes == 1, "the control inserted keyframes")
    return ms[STEADY_FROM:], sess.poses()[1], sess._graph


def _graph_vs_eager(cfg, frames) -> dict:
    """The tracking-only sweep with each tracked frame one CUDA graph replay
    against the same sweep eagerly (`cuda_graph=False`), in turns (eager,
    graph, graph, eager): poses bit for bit alike in all four, one capture a
    graph run; tracked-call p50 / p99 and frames/s of each mode over its two
    runs (CUDA events)."""
    runs, poses = {False: [], True: []}, []
    for graph in (False, True, True, False):
        ms, T, fg = _control_sweep(cfg, frames, cuda_graph=graph)
        runs[graph].append(ms)
        poses.append(T)
        if graph:
            check(fg.captures == 1 and fg.replays == len(frames) - 2,
                  f"{fg.captures} captures, {fg.replays} replays")
    for T in poses[1:]:
        check(np.array_equal(T, poses[0]), "graph replays and the eager step give other "
              f"poses (largest difference {np.abs(T - poses[0]).max():.3e})")
    out = {}
    for graph, name in ((False, "eager"), (True, "graph")):
        ms = np.concatenate(runs[graph])
        out[name] = ms
        print(f"tracking-only sweep, {name} ({'one CUDA graph replay a tracked frame' if graph else 'cuda_graph=False'}), "
              f"2 runs of frames {STEADY_FROM}-{len(frames) - 1}: {len(ms) / (ms.sum() / 1e3):.2f} "
              f"frames/s, tracked calls {_p(ms)} (CUDA events; runs p50 "
              f"{' / '.join(f'{np.percentile(m, 50):.3f}' for m in runs[graph])} ms)")
    print(f"graph replays equal the eager step bit for bit over {len(frames)} frames "
          f"(4 runs: eager, graph, graph, eager); p50 eager / graph "
          f"{np.percentile(out['eager'], 50) / np.percentile(out['graph'], 50):.2f}x")
    return out


def _inline_control(cfg, frames, gt) -> None:
    """The main sweep with the backend inline: each insert call also runs
    its backend pass."""
    from slam_rgbd_tpu_torch import SLAMSession
    from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse

    sess = SLAMSession(cfg)
    pass_ms = []
    ms, kf_calls, _ = _sweep(sess, frames, cfg.camera.fps, pass_ms=pass_ms)
    _, est = sess.poses()
    check_no_errors("inline control")
    ms, kf_calls = ms[STEADY_FROM:], kf_calls[STEADY_FROM:]
    print(f"backend inline control in this process: keyframes {sess.state.keyframes}, "
          f"ATE {100 * ate_rmse(est, gt)[0]:.3f} cm; {len(ms) / (ms.sum() / 1e3):.2f} "
          f"frames/s (frames {STEADY_FROM}-{len(frames) - 1}), all calls {_p(ms)}; "
          f"tracked calls {_p(ms[~kf_calls])}; calls with an insert and its pass "
          f"{_p(ms[kf_calls])}; a pass median {np.median(pass_ms):.1f} ms (host clock)")


def main_phase(cfg, with_control: bool = False, with_profile: bool = False) -> dict:
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
    control = [_control_sweep(cfg, frames)[0]] if with_control else []

    # the threaded backend, as the JAX package's bench_session runs it
    sess = SLAMSession(cfg, async_backend=True)  # the default device: the card
    check(sess.device.type == "cuda", f"default device is {sess.device}")
    check_no_errors("before the main phase")
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    tg.gn_reduce.launches = tg.gn_reduce_batched.launches = 0
    th.gated_match.launches = th.hamming_top2.launches = 0
    merges, pass_ms = [], []
    all_ms, kf_calls, wall = _sweep(sess, frames, cam.fps, merges, pass_ms)
    t0 = time.perf_counter()
    sess.sync_backend(timeout=120.0, final_pass=True)
    drain_s = time.perf_counter() - t0
    launches, stacked_launches = tg.gn_reduce.launches, tg.gn_reduce_batched.launches
    gated_launches, top2_launches = th.gated_match.launches, th.hamming_top2.launches
    peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 2**20
    ts, est = sess.poses()
    worker = sess.worker
    completed, skipped = worker.completed, worker.skipped
    check_no_errors("main phase")
    graph_vs_eager = _graph_vs_eager(cfg, frames)
    if with_control:
        control.append(_control_sweep(cfg, frames)[0])
        _inline_control(cfg, frames, gt)

    per_frame = all_ms[STEADY_FROM:]
    fps = (N_FRAMES - STEADY_FROM) / (per_frame.sum() / 1e3)
    ate, _, _ = ate_rmse(est, gt)
    keyframes, loops = sess.state.keyframes, sess.state.loops
    is_kf = kf_calls[STEADY_FROM:]
    merged = np.array(merges)[STEADY_FROM:]
    kf_ms, plain_frame_ms = per_frame[is_kf], per_frame[~is_kf & ~merged]
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
    print(f"gn_reduce launches {launches} (expected 12 x {N_FRAMES - 1} = "
          f"{12 * (N_FRAMES - 1)}), gn_reduce_batched launches {stacked_launches} (the "
          f"three coarse starts stacked: 10 x {N_FRAMES - 1} = {10 * (N_FRAMES - 1)}), "
          f"gated_match launches {gated_launches} (one a "
          f"keyframe insert with a map: keyframes - 1 = {keyframes - 1}), "
          f"hamming_top2 launches {top2_launches} (two a loop verification and two a "
          f"fusion, on the backend's stream; no frame lost)")
    print(f"backend: {completed} passes completed on the worker, {skipped} jobs "
          f"skipped (completed + skipped >= keyframes - 1 = {keyframes - 1}), loops "
          f"{loops} merged at frames {sess.state.loop_merge_frames}; a pass on the "
          f"worker thread: median {np.median(pass_ms):.1f} ms, max {max(pass_ms):.1f} ms "
          f"(host clock, {len(pass_ms)} merged during the sweep); drain with the final "
          f"pass {drain_s:.2f} s (host clock)")
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
    print(f"tracked calls (no insert, no merge; {1e3 / plain_frame_ms.mean():.2f} "
          f"frames/s): {_p(plain_frame_ms)}; calls with an insert: {_p(kf_ms)}; calls "
          f"that merged a backend result: {_p(per_frame[merged])}")
    print(REFERENCE_ANCHORS)
    if with_control:
        print("tracking-only control in this process (keyframe thresholds out of "
              "reach), before / after: " + " / ".join(
                  f"{1e3 / c.mean():.2f} frames/s, p50 {np.percentile(c, 50):.3f} ms"
                  for c in control))

    check(launches == 12 * (N_FRAMES - 1) and stacked_launches == 10 * (N_FRAMES - 1),
          "main path did not run the kernel 10 + 12 times a frame")
    check(keyframes > 1 and keyframes == int(m.n_kf), f"keyframes {keyframes}")
    check(gated_launches == keyframes - 1,
          f"{gated_launches} gated_match launches for {keyframes} keyframes")
    check(top2_launches % 2 == 0, f"{top2_launches} hamming_top2 launches")
    check(0 < n_pt < cfg.keyframes.max_map_points and dropped == 0,
          f"map points {n_pt}, dropped {dropped}")
    check(int(sess.n_edges) == keyframes - 1 + loops,
          "edges are not the odometry chain and the loop edges")
    check(completed >= 1 and completed + skipped >= keyframes - 1,
          f"backend: {completed} completed, {skipped} skipped for {keyframes} keyframes")
    check(not worker.busy(), "the backend did not drain")
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
    if with_profile:
        _profile_tracked_frames(cfg, frames)
    return {"launches": launches, "stacked_launches": stacked_launches,
            "gated_launches": gated_launches, "top2_launches": top2_launches,
            "fps": fps, "ate": ate, "session": sess, "frames": frames, "gt": gt,
            "graph_vs_eager": graph_vs_eager}


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
    tg.gn_reduce.launches = tg.gn_reduce_batched.launches = 0
    th.gated_match.launches = th.hamming_top2.launches = 0
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
    check(tg.gn_reduce.launches == 12 * (LOST_FRAMES - 1)
          and tg.gn_reduce_batched.launches == 10 * (LOST_FRAMES - 1), "gn_reduce launches")
    check(sess.stats[-1].tracking_ok, "tracking did not come back")
    check(est.shape == (LOST_FRAMES, 4, 4) and np.isfinite(est).all(), "poses")
    check(ate <= ATE_LIMIT_M, f"ATE {ate:.4f} m above {ATE_LIMIT_M} m")
    return {"launches": launches}


def degraded_phase(cfg, run: dict) -> dict:
    """The JAX package's `bench_degraded`: the sweep through the sensor
    model, applied on the card, and the threaded session."""
    phase("degraded")
    from slam_rgbd_tpu_torch import SLAMSession
    from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse
    from slam_rgbd_tpu_torch.io.synthetic import NoiseSpec, noisy_frame
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg
    from slam_rgbd_tpu_torch.ops import hamming as th

    cam, gt = cfg.camera, run["gt"]
    spec = NoiseSpec(motion_blur=1.0, exposure_drift=0.08)
    t0 = time.perf_counter()
    frames = [noisy_frame(d, c, i, gt, cam, spec, cam.fps)
              for i, (d, c) in enumerate(run["frames"])]
    torch.cuda.synchronize()
    print(f"sensor model on {len(frames)} frames on the card in "
          f"{time.perf_counter() - t0:.1f} s (host clock; frame 0: "
          f"{float((frames[0][0] == 0).float().mean()):.4f} of depth dropped)")
    counters = (tg.gn_reduce, tg.gn_reduce_batched, th.gated_match, th.hamming_top2)
    for c in counters:
        c.launches = 0
    sess = SLAMSession(cfg, async_backend=True)
    try:
        ms, kf_calls, wall = _sweep(sess, frames, cam.fps)
        sess.sync_backend(timeout=120.0, final_pass=True)
        _, est = sess.poses()
        st, w = sess.state, sess.worker
        completed, skipped = w.completed, w.skipped
    finally:
        sess.close()
    check_no_errors("degraded")
    launches = {c.__name__: c.launches for c in counters}
    ate, _, _ = ate_rmse(est, gt)
    print(f"NoiseSpec(motion_blur=1.0, exposure_drift=0.08), threaded backend: ATE "
          f"{100 * ate:.3f} cm (limit {ATE_LIMIT_M * 100:.0f} cm), lost {st.lost}, "
          f"relocalized {st.relocalized}, keyframes {st.keyframes}, loops {st.loops}, "
          f"backend {completed} completed / {skipped} skipped; "
          f"{(len(frames) - STEADY_FROM) / (ms[STEADY_FROM:].sum() / 1e3):.2f} frames/s "
          f"(frames {STEADY_FROM}-{len(frames) - 1}), {_p(ms[STEADY_FROM:])}; launches "
          f"{launches}")
    check(est.shape == (len(frames), 4, 4) and np.isfinite(est).all(), "poses not finite")
    check(ate <= ATE_LIMIT_M, f"ATE {ate:.4f} m above {ATE_LIMIT_M} m")
    return launches


def loop_leg_phase(cfg) -> dict:
    """The JAX package's `bench_loop_leg` at full width: drift injected into
    every tracked relative pose, denser keyframes, a shorter candidate
    interval, the backend inline (deterministic, and every closure's cost
    lands on the frame that closes it), loops off then on."""
    phase("loop leg")
    import dataclasses

    from slam_rgbd_tpu_torch import SLAMSession
    from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory, render_frame
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg
    from slam_rgbd_tpu_torch.ops import hamming as th

    dev = torch.device("cuda", 0)
    cam = cfg.camera
    gt = orbit_trajectory(LOOP_FRAMES, sweep=True)
    frames = [render_frame(p, cam, device=dev) for p in gt]
    counters = (tg.gn_reduce, tg.gn_reduce_batched, th.gated_match, th.hamming_top2)
    launches = {c.__name__: 0 for c in counters}
    out = {}
    for label, on in (("off", False), ("on", True)):
        leg = dataclasses.replace(
            cfg,
            icp=dataclasses.replace(cfg.icp, drift_xi=LOOP_LEG_DRIFT),
            keyframes=dataclasses.replace(cfg.keyframes, kf_min_trans=0.06),
            ba=dataclasses.replace(cfg.ba, loop_min_interval=5, loop_cooldown_kf=3,
                                   loop_min_score=cfg.ba.loop_min_score if on else 2.0))
        for c in counters:
            c.launches = 0
        sess = SLAMSession(leg)
        ms, kf_calls, wall = _sweep(sess, frames, cam.fps)
        _, est = sess.poses()
        for c in counters:
            launches[c.__name__] += c.launches
        ate, _, _ = ate_rmse(est, gt)
        st = sess.state
        if on:  # the parallel phase's pose graph: this session's keyframes and edges
            launches["graph"] = {"poses": sess.map.kf_pose, "node_valid": sess.map.kf_valid,
                                 **{f: getattr(sess.edges, f)
                                    for f in ("i", "j", "T_meas", "weight", "valid")}}
        # inline, a loop merges in the call that closed it (state.frames
        # counts the calls before it)
        merge_ms = [round(float(ms[i]), 1) for i in st.loop_merge_frames]
        out[label] = (ate, st.loops)
        print(f"loops {label}: ATE {100 * ate:.3f} cm, loops {st.loops}, keyframes "
              f"{st.keyframes}, lost {st.lost}; {len(frames) / wall:.1f} frames/s wall, "
              f"p99 {np.percentile(ms[1:], 99):.1f} ms; loop merges at frames "
              f"{st.loop_merge_frames}, merge_frame_ms {merge_ms} (CUDA events)")
        check(np.isfinite(est).all(), f"loops {label}: non-finite poses")
    check_no_errors("loop leg")
    (ate_off, loops_off), (ate_on, loops_on) = out["off"], out["on"]
    print(f"ATE on / off {ate_on / ate_off:.3f}")
    check(loops_off == 0, "a loop closed with the search off")
    check(loops_on >= 1, "no loop closed under injected drift")
    check(ate_on < ate_off, f"ATE with loops on {ate_on:.4f} m not below off {ate_off:.4f} m")
    return launches


def _upload_ms(frames, dev, spin_ms: float) -> dict:
    """Host ms a frame (depth + colour) of the plain upload and of the pinned
    ring, each behind `spin_ms` of queued device work (0: an idle stream),
    medians over the frames; and whether a staged upload returned while the
    stream was still busy."""
    from slam_rgbd_tpu_torch.runtime.staging import PinnedStaging, upload_plain

    staging = PinnedStaging(dev, n_slots=4)
    stream = torch.cuda.current_stream(dev)
    out, busy_after = {}, []
    for name, up in (("plain", lambda x: upload_plain(x, dev)), ("pinned", staging.upload)):
        times = []
        for _, depth, rgb in frames:
            torch.cuda.synchronize()
            if spin_ms > 0:
                torch.cuda._sleep(int(spin_ms * 1e-3 * 2.0e9))
            t0 = time.perf_counter()
            d, c = up(depth), up(rgb)
            times.append(1e3 * (time.perf_counter() - t0))
            if name == "pinned" and spin_ms > 0:
                busy_after.append(not stream.query())
            torch.cuda.synchronize()
            same = torch.equal(d, upload_plain(depth, dev)) and torch.equal(
                c, upload_plain(rgb, dev))
            check(same, f"{name} upload differs from the plain upload")
        out[name] = float(np.median(times[2:]))
    out["returned_busy"] = all(busy_after)
    return out


def _timed_calls(sess):
    """Wrap `sess.process_frame` so each call is bracketed by a pair of CUDA
    events on the calling thread's stream. -> list of (start, end) pairs."""
    pairs = []
    real = sess.process_frame

    def timed(ts, depth, rgb):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        st = real(ts, depth, rgb)
        b.record()
        pairs.append((a, b))
        return st

    sess.process_frame = timed
    return pairs


def _fetch(port: int, path: str) -> tuple[int, bytes]:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, r.read()


def _scripted_menu(runner, lines):
    """Menu input: each (frames, line) is given once the producer has read
    that many frames of the clip (processed, dropped or still queued)."""
    def read():
        return runner.session.state.frames + runner.queue.dropped + len(runner.queue)

    for at, line in lines:
        deadline = time.monotonic() + 60.0
        while read() < at and time.monotonic() < deadline:
            time.sleep(0.01)
        yield line + "\n"


def pipeline_phase(cfg, run: dict) -> dict:
    """The reference's `run` / `play` path from host frames: record a clip,
    replay it through the threaded `PipelineRunner` with a live viewer, a
    scripted control menu, checkpoint / resume, and the CLI in a
    subprocess."""
    phase("pipeline")
    import io
    import threading

    from slam_rgbd_tpu_torch import SLAMSession
    from slam_rgbd_tpu_torch.eval.trajectory import ate_by_timestamp, load_trajectory_tum
    from slam_rgbd_tpu_torch.io import native
    from slam_rgbd_tpu_torch.io import stream as st
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg
    from slam_rgbd_tpu_torch.ops import hamming as th
    from slam_rgbd_tpu_torch.runtime import checkpoint
    from slam_rgbd_tpu_torch.runtime.runner import ControlMenu, PipelineRunner
    from slam_rgbd_tpu_torch.viz.pointcloud import map_to_pointcloud
    from slam_rgbd_tpu_torch.viz.server import PointCloudServer

    dev = torch.device("cuda", 0)
    cam = cfg.camera
    gt = run["gt"][:PIPE_FRAMES]
    # the sweep's frames brought to the host, as a camera or a file gives them
    host = [(i / cam.fps, d.cpu().numpy().astype(np.uint16), c.cpu().numpy())
            for i, (d, c) in enumerate(run["frames"][:PIPE_FRAMES])]
    gt_ts = np.array([f[0] for f in host])
    counters = (tg.gn_reduce, tg.gn_reduce_batched, th.gated_match, th.hamming_top2)
    launches = {c.__name__: 0 for c in counters}

    def count():
        for c in counters:
            launches[c.__name__] += c.launches
            c.launches = 0

    for c in counters:
        c.launches = 0
    up_idle = _upload_ms(host[:12], dev, 0.0)
    up_busy = _upload_ms(host[:12], dev, UPLOAD_SPIN_MS)
    print(f"upload of a host frame (depth + colour), host ms, median: idle stream plain "
          f"{up_idle['plain']:.3f} / pinned {up_idle['pinned']:.3f}; behind "
          f"{UPLOAD_SPIN_MS:.0f} ms of queued device work plain {up_busy['plain']:.3f} / "
          f"pinned {up_busy['pinned']:.3f} (returned with the stream busy: "
          f"{up_busy['returned_busy']}); both equal to the plain upload bit for bit")
    check(up_busy["returned_busy"], "a pinned upload waited for the stream")

    with tempfile.TemporaryDirectory() as tmp:
        # ---- record: the native codec, read back bit for bit
        check(native.native_available(), "the native IO library did not build")
        clip = os.path.join(tmp, "clip.rgbd")
        rec = st.open_recorder(clip)
        check(isinstance(rec, native.NativeStreamRecorder), f"recorder {type(rec)}")
        t0 = time.perf_counter()
        with rec:
            for f in host:
                rec.write(*f)
        rec_s = time.perf_counter() - t0
        for reader in (st.StreamReader(clip), st.open_reader(clip, prefetch=4)):
            back = list(reader)
            reader.close()
            # timestamps are kept to the microsecond
            check(len(back) == len(host) and all(
                b[0] == int(a[0] * 1e6) / 1e6 and np.array_equal(a[1], b[1])
                and np.array_equal(a[2], b[2]) for a, b in zip(host, back)),
                f"{type(reader).__name__}: the clip does not read back bit for bit")
        print(f"recorded {len(host)} frames {cam.width}x{cam.height} with the native codec "
              f"in {rec_s:.2f} s ({os.path.getsize(clip) / 2**20:.1f} MiB); the Python "
              f"reader and the native prefetcher read them back bit for bit")

        # ---- play: the threaded runner, the native prefetcher paced at 30 fps,
        # a live viewer on an ephemeral port
        runner = PipelineRunner(cfg, st.paced(
            st.open_reader(clip, prefetch=cfg.stream.prefetch), PIPE_FPS))
        sess = runner.session
        check(sess.device.type == "cuda", f"runner session on {sess.device}")
        calls = _timed_calls(sess)
        server = PointCloudServer(lambda: map_to_pointcloud(runner.session.map),
                                  port=0).start()
        result = {}
        worker = threading.Thread(
            target=lambda: result.setdefault("session", runner.run(threads=True)),
            name="pipeline-run")
        t0 = time.perf_counter()
        worker.start()
        fetched = {}
        try:
            deadline = time.monotonic() + 120.0
            while (sess.state.keyframes < 2 or sess.state.frames < 30) and worker.is_alive() \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            check(sess.state.keyframes >= 1, "no keyframe during the run")
            for path in ("/healthz", "/pointcloud", "/native/frame"):
                fetched[path] = _fetch(server.port, path)
            fetched_at = sess.state.frames
            worker.join(timeout=300)
        finally:
            server.stop()
        wall = time.perf_counter() - t0
        check(not worker.is_alive(), "the runner did not finish")
        sess.sync_backend(timeout=120.0, final_pass=True)
        count()
        ts, est = sess.poses()
        check_no_errors("pipeline play")
        processed, dropped = sess.state.frames, runner.queue.dropped
        torch.cuda.synchronize()
        ms = np.array([a.elapsed_time(b) for a, b in calls])
        steady = ms[STEADY_FROM:]
        ate = ate_by_timestamp(ts, est, gt_ts, gt)
        kinds = {k: len(runner.metrics.by_kind(k)) for k in ("frame_window", "queue", "backend")}
        status = {p: s for p, (s, _) in fetched.items()}
        cloud = json.loads(fetched["/pointcloud"][1])
        n_cloud = len(cloud["positions"]) // 3
        overflowed = "never" if dropped == 0 else "at least once"
        print(f"play (threaded runner, native prefetcher paced at {PIPE_FPS:.0f} fps, "
              f"backend on its worker): processed {processed}, dropped {dropped} (the "
              f"queue passed {cfg.stream.queue_capacity} frames {overflowed}), keyframes "
              f"{sess.state.keyframes}, loops {sess.state.loops}, lost {sess.state.lost}, "
              f"relocalized {sess.state.relocalized}; ATE {100 * ate:.3f} cm paired by "
              f"timestamp (limit {ATE_LIMIT_M * 100:.0f} cm); watchdog stalls "
              f"{runner.watchdog.stalls}; records {kinds}")
        print(f"play: {processed / wall:.2f} frames/s processed over {wall:.2f} s wall "
              f"(paced at {PIPE_FPS:.0f}); calls (frames {STEADY_FROM}-{len(ms) - 1}, CUDA "
              f"events on the consumer thread): {len(steady) / (steady.sum() / 1e3):.2f} "
              f"frames/s of call time, {_p(steady)}; launches {dict(launches)}")
        print(f"viewer during the run (frame {fetched_at}): {status}, /pointcloud "
              f"{n_cloud} points, /native/frame {len(fetched['/native/frame'][1])} bytes of PNG")
        check(processed + dropped == len(host),
              f"processed {processed} + dropped {dropped} != {len(host)}")
        check(ate <= ATE_LIMIT_M, f"ATE {ate:.4f} m above {ATE_LIMIT_M} m")
        check(kinds["frame_window"] >= 1 and kinds["queue"] >= 1,
              f"metrics records {kinds}")
        check(runner.watchdog.stalls == 0, f"{runner.watchdog.stalls} watchdog stalls")
        check(all(s == 200 for s in status.values()), f"viewer answered {status}")
        check(n_cloud > 0, "/pointcloud held no points after a keyframe")
        check(fetched["/native/frame"][1][:8] == b"\x89PNG\r\n\x1a\n", "/native/frame is no PNG")
        check(launches["gn_reduce"] == 12 * (processed - 1)
              and launches["gn_reduce_batched"] == 10 * (processed - 1),
              f"launches {launches} for {processed} frames")
        check(launches["gated_match"] == sess.state.keyframes - 1,
              f"{launches['gated_match']} gated_match launches")

        # ---- menu: s, 1 <tee>, 2, q before the clip ends
        tee = os.path.join(tmp, "tee.rgbd")
        runner = PipelineRunner(cfg, st.paced(
            st.open_reader(clip, prefetch=cfg.stream.prefetch), PIPE_FPS))
        out = io.StringIO()
        q_at = {}
        script = [(5, "s"), (10, f"1 {tee}"), (40, "2"), (60, "q")]

        def lines():
            for line in _scripted_menu(runner, script):
                if line.startswith("q"):
                    q_at["t"] = time.perf_counter()
                yield line

        menu = ControlMenu(runner, infile=lines(), outfile=out)
        menu.start()
        runner.run(threads=True)
        shut_s = time.perf_counter() - q_at.get("t", time.perf_counter())
        menu._thread.join(timeout=10)
        count()
        check_no_errors("pipeline menu")
        teed = list(st.StreamReader(tee))
        # a frame's index from its timestamp (i / fps, kept to the microsecond)
        tee_ok = all(np.array_equal(d, host[round(t * cam.fps)][1])
                     and np.array_equal(c, host[round(t * cam.fps)][2]) for t, d, c in teed)
        menu_frames = runner.session.state.frames
        print(f"menu (s, 1 <tee>, 2, q): processed {menu_frames} of {len(host)} frames, "
              f"shutdown {shut_s:.2f} s after q (limit {cfg.runtime.shutdown_timeout_s:.0f} s, "
              f"forced {runner.shutdown.forced}), tee {len(teed)} frames equal to the clip's: "
              f"{tee_ok}; status line: "
              f"{[ln for ln in out.getvalue().splitlines() if ln.startswith('status')]}")
        check("t" in q_at and shut_s <= cfg.runtime.shutdown_timeout_s
              and not runner.shutdown.forced, f"shutdown took {shut_s:.2f} s")
        check(menu_frames < len(host), "q did not stop the run before the clip ended")
        check(len(teed) > 0 and tee_ok, f"tee: {len(teed)} frames, equal {tee_ok}")
        check("status: frames=" in out.getvalue(), "no status line")

        # ---- checkpoint: save an inline session at frame 60, restore, go on
        half = len(host) // 2
        sess = SLAMSession(cfg)
        for f in host[:half]:
            sess.process_frame(*f)
        ck = os.path.join(tmp, "ck")
        checkpoint.save(sess, ck)
        saved_kf = sess.state.keyframes
        restored = checkpoint.restore(SLAMSession(cfg), ck)
        check(restored.device.type == "cuda", "restored session off the card")
        same = {}
        for f in dataclasses.fields(sess.map):
            same[f"map.{f.name}"] = torch.equal(getattr(sess.map, f.name),
                                                getattr(restored.map, f.name))
        for f in dataclasses.fields(sess.edges):
            same[f"edges.{f.name}"] = torch.equal(getattr(sess.edges, f.name),
                                                  getattr(restored.edges, f.name))
        for name in ("n_edges", "T_world", "motion"):
            same[name] = torch.equal(getattr(sess, name), getattr(restored, name))
        for i, (a, b) in enumerate(zip(sess._traj_arrays(), restored._traj_arrays())):
            same[f"traj_{i}"] = a.dtype == b.dtype and np.array_equal(a, b)
        differ = [k for k, v in same.items() if not v]
        for f in host[half:]:
            restored.process_frame(*f)
        count()
        ts2, est2 = restored.poses()
        check_no_errors("pipeline checkpoint")
        ate2 = ate_by_timestamp(ts2, est2, gt_ts, gt)
        print(f"checkpoint at frame {half}: {len(same)} arrays restored, bit for bit "
              f"{len(same) - len(differ)}; keyframes {saved_kf} saved -> "
              f"{restored.state.keyframes} after frames {half}-{len(host) - 1}, ATE "
              f"{100 * ate2:.3f} cm over all {len(ts2)} frames")
        check(not differ, f"restored arrays differ: {differ}")
        check(restored.state.keyframes > saved_kf
              and int(restored.map.n_kf) == restored.state.keyframes,
              "the keyframe count did not continue from the saved one")
        check(len(ts2) == len(host) and ate2 <= ATE_LIMIT_M,
              f"resumed run: {len(ts2)} poses, ATE {ate2:.4f} m")

        # ---- the CLI in a subprocess on the card: run on the golden TUM
        # directory, then eval its trajectory
        traj = os.path.join(tmp, "traj.txt")
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "slam_rgbd_tpu_torch", "run", "tests/data/tum_golden",
             "--tum", "--traj", traj], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0, f"CLI run failed ({cli.returncode}): {cli.stderr[-2000:]}")
        ts3, est3 = load_trajectory_tum(traj)
        ev = subprocess.run(
            [sys.executable, "-m", "slam_rgbd_tpu_torch", "eval", traj,
             "tests/data/tum_golden/groundtruth.txt"], cwd=ROOT, capture_output=True,
            text=True, timeout=300)
        check(ev.returncode == 0, f"CLI eval failed: {ev.stderr[-2000:]}")
        ev_json = json.loads(ev.stdout.strip().splitlines()[-1])
        print(f"CLI `run tests/data/tum_golden --tum --traj` in {cli_s:.1f} s: "
              f"{[ln for ln in cli.stdout.splitlines() if ln.startswith(('frames=', 'ATE'))]}; "
              f"`eval`: {ev_json}")
        check(est3.shape == (3, 4, 4) and np.isfinite(est3).all(),
              f"CLI trajectory {est3.shape}")
        check(ev_json["frames"] == 3, f"eval {ev_json}")
    return launches


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


def _traced(fn):
    """Run `fn()` under torch.profiler -> (device ms, device operations,
    launches from the host: cudaLaunchKernel and cudaGraphLaunch calls,
    host ms of the traced span, the GN kernel's device ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms_ = 1e3 * (time.perf_counter() - t0)
    dev_us, dev_ops, launches, gn_us = 0.0, 0, 0, 0.0
    for ev in prof.key_averages():
        # device-side events (kernels, copies, fills) only: a host-side op
        # event carries its kernels' time a second time
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            us = ev.self_cuda_time_total if us is None else us
            dev_us += us
            dev_ops += ev.count
            if "gn_kernel" in ev.key:
                gn_us += us
        elif ev.key in ("cudaLaunchKernel", "cudaGraphLaunch"):
            launches += ev.count
    check(dev_us > 0, "the profiler recorded no device time")
    return dev_us / 1e3, dev_ops, launches, host_ms_, gn_us / 1e3


def _profile_tracked(label: str, step, what: str, n_steps: int = 5) -> None:
    """Warm `step(i)` up, time `n_steps` calls without the profiler, trace
    `n_steps` more and print what the device did a call."""
    for i in range(STEADY_FROM):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STEADY_FROM, STEADY_FROM + n_steps):
        step(i)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / n_steps

    def traced_steps():
        for i in range(STEADY_FROM + n_steps, STEADY_FROM + 2 * n_steps):
            step(i)

    dev_ms, dev_ops, launches, traced_ms, gn_ms = (x / n_steps for x in _traced(traced_steps))
    print(f"profile, {label}, {n_steps} tracked {what}s: {dev_ops:.0f} device "
          f"operations a {what} ({launches:.0f} kernel or graph launches from the host), device time "
          f"{dev_ms:.3f} ms a {what} (the GN kernel {gn_ms:.3f} ms of it), {what} "
          f"{traced_ms:.2f} ms under the profiler ({plain_ms:.2f} ms without): device "
          f"busy share {dev_ms / traced_ms:.4f}")


def _never_a_keyframe(cfg):
    """`cfg` with the keyframe thresholds out of reach: every call after the
    bootstrap only tracks."""
    import dataclasses

    never = dataclasses.replace(cfg.keyframes, kf_min_trans=1e9, kf_min_rot_deg=1e9,
                                kf_min_inlier_ratio=0.0)
    return dataclasses.replace(cfg, keyframes=never)


def _profile_tracked_frames(cfg, frames) -> None:
    """Trace tracked frames of a single session, and beside them the flow
    shift of the coarsest level as a tracked frame runs it (ten times, for
    the three stacked starts)."""
    from slam_rgbd_tpu_torch import SLAMSession
    from slam_rgbd_tpu_torch.core import camera
    from slam_rgbd_tpu_torch.odometry import icp

    for graph in (True, False):
        sess = SLAMSession(_never_a_keyframe(cfg), cuda_graph=graph)
        _profile_tracked(f"single session, {'CUDA graph' if graph else 'eager'}",
                         lambda i: sess.process_frame(i / cfg.camera.fps, *frames[i]),
                         "frame")
    icfg = cfg.icp
    k0 = icfg.levels - 1
    lcam = cfg.camera.scaled(2.0 ** k0)
    pyr = camera.build_frame_pyramid(frames[0][0], cfg.camera, levels=icfg.levels,
                                     rgb=frames[0][1])
    verts = pyr[k0]["vertices"]
    starts = torch.eye(4, device=verts.device).repeat(3, 1, 1)

    def flow_shifts():
        for _ in range(icfg.iters[0]):
            _, up, vp, _ = icp._project_level(starts, verts, lcam)
            icp.flow_shift(up, vp, lcam.height, lcam.width)

    flow_shifts()
    dev_ms, dev_ops, _, host, _ = _traced(flow_shifts)
    print(f"profile, the coarsest level's flow shift as a tracked frame runs it "
          f"({icfg.iters[0]} x `_project_level` + `flow_shift` for 3 starts at "
          f"{lcam.height}x{lcam.width}): {dev_ops} device operations, device time "
          f"{dev_ms:.3f} ms, {host:.2f} ms of host time under the profiler")


def _profile_tracked_steps(cfg, frames, n_seq: int) -> None:
    """Trace tracked steps of a BatchSession of `n_seq` sequences."""
    from slam_rgbd_tpu_torch import BatchSession

    bs = BatchSession(_never_a_keyframe(cfg), n_seq)
    _profile_tracked(f"B={n_seq}", lambda i: bs.process_frames(
        i / cfg.camera.fps, frames[i][0][:n_seq], frames[i][1][:n_seq]), "step")


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
    print(f"gn_reduce_batched launches {batched} (expected 22 x {BATCH_FRAMES - 1} = "
          f"{22 * (BATCH_FRAMES - 1)}), single gn_reduce launches {single} (0), "
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

    check(batched == 22 * (BATCH_FRAMES - 1),
          "the batch session did not run the batched kernel 22x a tracked step")
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
    return {"batched": batched, "gated": gated, "top2": top2, "frames": frames[:PAR_FRAMES],
            "leg": leg, "gts": [g[:PAR_FRAMES] for g in gts],
            "steps_s": steps_s, "tracked_p50": float(np.percentile(tracked, 50))}


# ---- parallel: the mesh, the sharded programs, the sharded batch session ------
PAR_EDGE_FIELDS = ("i", "j", "T_meas", "weight", "valid")


def _ba_window(m, cfg) -> dict:
    """The newest BA window of map `m` as the backend's windowed solve hands
    it to `local_ba`: 2 x window keyframes (the older half fixed), their
    observation columns, and the points compacted to the window's budget."""
    from slam_rgbd_tpu_torch.backend import ba as ba_mod
    from slam_rgbd_tpu_torch.mapping import map as smap

    w = cfg.ba.window
    idx, valid = smap.local_window(m, 2 * w)
    idx = idx.long()
    uv, z = m.kp_uv[idx].contiguous(), m.kp_pts[idx][..., 2].contiguous()
    ok = m.kp_ok[idx] & valid[:, None]
    _, pid, ok_c, pts, _ = ba_mod._win_compact(valid, m.pt_xyz, uv, z, m.point_id[idx],
                                              ok, cfg.camera, cfg.ba)
    return {"ba_poses": m.kf_pose[idx].clone(), "ba_valid": valid, "ba_pts": pts,
            "ba_uv": uv, "ba_z": z, "ba_pid": pid, "ba_ok": ok_c,
            "ba_free": torch.arange(2 * w, device=m.device) >= w}


def _par_inputs(ham_inputs: dict, ba_window: dict, graph: dict, frames) -> dict:
    """The parallel phase's inputs, one flat dict of tensors on the card: the
    kernels phase's map (16384 slots) and query (1024 keypoints), the main
    phase's BA window, the loop leg's keyframes and edge list, and the first
    two steps of the batch phase's four sequences."""
    m = ham_inputs["map"]
    x = {"pt_xyz": m.pt_xyz, "pt_signs": m.pt_signs, "pt_valid": m.pt_valid,
         **{f"q_{k}": ham_inputs[k] for k in ("signs", "ok", "uv", "z", "pts", "T")},
         **ba_window,
         "pg_poses": graph["poses"], "pg_node_valid": graph["node_valid"],
         **{f"pg_{f}": graph[f] for f in PAR_EDGE_FIELDS},
         "tk_depth": torch.stack([frames[0][0], frames[1][0]]),
         "tk_rgb": torch.stack([frames[0][1], frames[1][1]])}
    return {k: v.contiguous() for k, v in x.items()}


def _par_track_pair(x, cfg):
    """(src, tgt) pyramids of the batch phase's first tracked step, B = 4."""
    from slam_rgbd_tpu_torch.core import camera

    pyr = lambda i: camera.build_frame_pyramid(x["tk_depth"][i], cfg.camera,
                                               levels=cfg.icp.levels, rgb=x["tk_rgb"][i])
    return pyr(1), pyr(0)


def _par_programs(mesh, x: dict, cfg) -> dict:
    """The five programs of `parallel.dist` on this rank's blocks of the
    inputs (observation columns, map points, edge slots and query rows over
    `model`; sequences over `data`) -> their outputs as numpy arrays."""
    from slam_rgbd_tpu_torch.backend.pose_graph import EdgeList
    from slam_rgbd_tpu_torch.parallel import dist as pdist
    from slam_rgbd_tpu_torch.parallel import mesh as pmesh

    sh = lambda name, dim=0: pmesh.shard(x[name], mesh, "model", dim)
    cam = cfg.camera
    out = {}
    res = pdist.sharded_local_ba(
        mesh, x["ba_poses"], x["ba_valid"], x["ba_pts"],
        *(sh(f"ba_{k}", dim=1) for k in ("uv", "z", "pid", "ok")), cam, cfg.ba,
        free_mask=x["ba_free"])
    out["ba_pose"], out["ba_pts"], out["ba_n"] = res.kf_pose, res.pt_xyz, res.n_obs
    src, tgt = (tuple({k: pmesh.shard(v, mesh, "data") for k, v in lvl.items()} for lvl in p)
                for p in _par_track_pair(x, cfg))
    T0 = pmesh.shard(torch.eye(4, device=x["tk_depth"].device).repeat(BATCH_B, 1, 1),
                     mesh, "data")
    for k, v in zip(("T", "inl", "rmse", "vf"), pdist.batch_track(mesh, src, tgt, T0, cam,
                                                                  cfg.icp)):
        out[f"tk_{k}"] = v
    for merge in (True, False):
        out[f"assoc_{merge}"] = pdist.sharded_map_association(
            mesh, x["q_signs"], x["q_ok"], x["q_uv"], x["q_z"], x["q_T"], sh("pt_xyz"),
            sh("pt_signs"), sh("pt_valid"), cam, max_distance=float(cfg.orb.match_threshold),
            kp_pts=x["q_pts"] if merge else None, merge_radius=cfg.keyframes.merge_radius)
    edges = EdgeList(**{f: x[f"pg_{f}"] for f in PAR_EDGE_FIELDS})
    pg = pdist.sharded_pose_graph(mesh, x["pg_poses"], x["pg_node_valid"],
                                  pdist.edge_block(edges, mesh), iters=cfg.ba.pg_iters,
                                  damping=cfg.ba.pg_damping)
    out["pg_poses"], out["pg_n"] = pg.poses, pg.n_edges
    out["hm_idx"], out["hm_best"], out["hm_ok"] = pdist.sharded_hamming_match(
        mesh, sh("q_signs"), sh("q_ok"), x["pt_signs"], x["pt_valid"],
        max_distance=float(cfg.orb.match_threshold))
    torch.cuda.synchronize()
    return {k: v.cpu().numpy() for k, v in out.items()}


def _par_unsharded(x: dict, m, cfg) -> dict:
    """What `_par_programs` computes, through the port's unsharded functions
    on the whole arrays (one card, no process group)."""
    from slam_rgbd_tpu_torch.backend import ba as ba_mod
    from slam_rgbd_tpu_torch.backend import pose_graph as pg_mod
    from slam_rgbd_tpu_torch.mapping import map as smap
    from slam_rgbd_tpu_torch.odometry.icp import icp_align_batched
    from slam_rgbd_tpu_torch.ops import hamming as th

    cam = cfg.camera
    out = {}
    res = ba_mod.local_ba(x["ba_poses"], x["ba_valid"], x["ba_pts"], x["ba_uv"], x["ba_z"],
                          x["ba_pid"], x["ba_ok"], cam, cfg.ba, free_mask=x["ba_free"])
    out["ba_pose"], out["ba_pts"], out["ba_n"] = res.kf_pose, res.pt_xyz, res.n_obs
    src, tgt = _par_track_pair(x, cfg)
    T0 = torch.eye(4, device=x["tk_depth"].device).repeat(BATCH_B, 1, 1)
    r = icp_align_batched(src, tgt, T0, cam, cfg.icp)
    out["tk_T"], out["tk_inl"], out["tk_rmse"], out["tk_vf"] = (
        r.T, r.inliers, r.rmse, r.valid_fraction)
    for merge in (True, False):
        out[f"assoc_{merge}"] = smap.match_against_map(
            m, x["q_signs"], x["q_ok"], x["q_uv"], x["q_z"], x["q_T"], cam=cam,
            max_distance=float(cfg.orb.match_threshold),
            kp_pts=x["q_pts"] if merge else None, merge_radius=cfg.keyframes.merge_radius)
    edges = pg_mod.EdgeList(**{f: x[f"pg_{f}"] for f in PAR_EDGE_FIELDS})
    pg = pg_mod.optimize_pose_graph(x["pg_poses"], x["pg_node_valid"], edges,
                                    iters=cfg.ba.pg_iters, damping=cfg.ba.pg_damping)
    out["pg_poses"], out["pg_n"] = pg.poses, pg.n_edges
    best, second, idx = th.hamming_top2(x["q_signs"], x["q_ok"], x["pt_signs"], x["pt_valid"])
    out["hm_idx"], out["hm_best"] = idx, best
    out["hm_ok"] = (best < float(cfg.orb.match_threshold)) & (best < 0.9 * second) & x["q_ok"]
    torch.cuda.synchronize()
    return {k: v.cpu().numpy() for k, v in out.items()}


def _par_check(label: str, got: dict, want: dict, rows: slice) -> tuple[float, float]:
    """One run of the programs against the unsharded port: BA poses 5e-5,
    points 5e-4, pose-graph poses 1e-5 (the sums run in another order; the
    tolerances of tests/test_parallel.py), every count equal, everything
    else exact. `rows`: the query rows the run's matching held. -> (largest
    BA pose difference, largest pose-graph difference)."""
    ba = float(np.abs(got["ba_pose"] - want["ba_pose"]).max())
    pts = float(np.abs(got["ba_pts"] - want["ba_pts"]).max())
    pg = float(np.abs(got["pg_poses"] - want["pg_poses"]).max())
    check(ba <= 5e-5 and pts <= 5e-4, f"{label}: BA off by {ba:.2e} / {pts:.2e}")
    check(pg <= 1e-5, f"{label}: pose graph off by {pg:.2e}")
    for k in ("ba_n", "pg_n", "tk_T", "tk_inl", "tk_rmse", "tk_vf", "assoc_True", "assoc_False"):
        check(np.array_equal(got[k], want[k]), f"{label}: {k} differs from the unsharded port")
    for k in ("hm_idx", "hm_best", "hm_ok"):
        check(np.array_equal(got[k], want[k][rows]), f"{label}: {k} differs")
    print(f"{label}: BA poses within {ba:.2e}, points within {pts:.2e} (n_obs "
          f"{int(got['ba_n'])}), pose graph within {pg:.2e} ({int(got['pg_n'])} edges); "
          f"batch_track, map association (merge tier on, off: "
          f"{int((got['assoc_True'] >= 0).sum())}, {int((got['assoc_False'] >= 0).sum())} "
          f"matched) and the Hamming match ({int(got['hm_ok'].sum())} of "
          f"{len(got['hm_ok'])} rows) exactly equal to the unsharded port")
    return ba, pg


def _par_counters():
    from slam_rgbd_tpu_torch.ops import gn_reduce as tg
    from slam_rgbd_tpu_torch.ops import hamming as th

    return {"gn_reduce_batched": tg.gn_reduce_batched, "gn_reduce": tg.gn_reduce,
            "gated_match": th.gated_match, "hamming_top2": th.hamming_top2}


def _shard_leg_config(cfg):
    """The sharded session leg's configuration: decisions at the next call,
    a (1, PAR_RANKS) mesh (which only a session given a mesh uses)."""
    from slam_rgbd_tpu_torch.core.config import MeshConfig

    return dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, max_decision_lag=1),
        mesh=MeshConfig(data=1, model=PAR_RANKS))


def _shard_leg_frames(cfg):
    """The sharded session leg's frames on the card: the sweep's first
    SHARD_FRAMES, then the next one with its depth in a central window only
    (lost, then relocalized), then one more. -> (frames, ground truth)."""
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory, render_frame

    dev = torch.device("cuda", torch.cuda.current_device())
    gt = orbit_trajectory(N_FRAMES, sweep=True)[:SHARD_FRAMES + 2]
    frames = [render_frame(p, cfg.camera, device=dev) for p in gt]
    depth, rgb = frames[SHARD_FRAMES]
    h, w = depth.shape
    window = torch.zeros_like(depth)
    rows, cols = slice(h // 4, 3 * h // 4), slice(5 * w // 16, 11 * w // 16)
    window[rows, cols] = depth[rows, cols]
    frames[SHARD_FRAMES] = (window, rgb)
    return frames, gt


def _map_digest(m, blk) -> dict:
    """sha256 of every field of a map, the point table gathered from its
    blocks: two maps with the same digests are equal bit for bit."""
    import hashlib

    from slam_rgbd_tpu_torch.parallel import mesh as pmesh

    out = {}
    for f in dataclasses.fields(m):
        x = getattr(m, f.name)
        if blk is not None and f.name.startswith("pt_") and x.dim():
            x = pmesh.gather(x, blk.mesh, blk.axis)
        out[f.name] = hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()
    return out


def _merge_log(sess) -> list:
    """(frame count, snapshot keyframe) of every backend result `sess`
    merges from now on. The wrapper holds the session weakly: a reference
    cycle would keep a finished session, frame graph and all, for the
    garbage collector."""
    import weakref

    merged = []
    ref = weakref.ref(sess)

    def logged(r):
        s = ref()
        if r is not None:
            merged.append((s.state.frames, r.snap_kf_idx))
        type(s)._apply_backend(s, r)

    sess._apply_backend = logged
    return merged


def _shard_session_run(sess, frames, fps: float, synced: bool = False) -> dict:
    """Drive a session of the leg over its frames -> what the leg compares:
    poses, keyframe poses, host counts, the map's digests, call ms (CUDA
    events around each call), the kernels' launches (counted from 0), and
    of a threaded session the merges, loop-merge frames and the worker's
    completed and skipped passes. `synced`: `sync_backend()` after every
    call (outside its timing), the forced merge schedule."""
    counters = _par_counters()
    for c in counters.values():
        c.launches = 0
    merged = _merge_log(sess)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(2)] for _ in frames]
    inserted = []
    for i, (depth, rgb) in enumerate(frames):
        before = sess.state.keyframes
        marks[i][0].record()
        sess.process_frame(i / fps, depth, rgb)
        marks[i][1].record()
        inserted.append(sess.state.keyframes > before)
        if synced:
            sess.sync_backend()
    sess.flush_pipeline()  # the last decisions: the damaged frame's included
    poses, kf_poses = sess.poses()[1], sess.keyframe_poses()[1]  # drained
    torch.cuda.synchronize()
    st = sess.state
    out = {
        "poses": poses, "kf_poses": kf_poses,
        "counts": [st.keyframes, st.lost, st.relocalized, st.loops,
                   sess.map_point_count()],
        "digest": _map_digest(sess.map, sess._blk),
        "ms": [a.elapsed_time(b) for a, b in marks],
        "inserted": inserted,
        "launches": {k: c.launches for k, c in counters.items()},
        "block_rows": int(sess.map.pt_xyz.shape[0]),
    }
    if sess.worker is not None:
        out["backend"] = {"merges": merged, "loop_merge_frames": list(st.loop_merge_frames),
                          "completed": sess.worker.completed,
                          "skipped": sess.worker.skipped}
    return out


def _parallel_rank(rank: int, world: int, path: str, cfg, leg, gts) -> dict:
    """One of the ranks sharing the card over gloo: the five programs on a
    (1, world) mesh, then `BatchSession(leg, 4, mesh=)` on a (world, 1) mesh
    over the batch phase's first frames (rendered here). Returns the
    programs' outputs, the session's, a checksum of its frames, its timings
    and its kernel launches (counted from 0 in this process)."""
    from slam_rgbd_tpu_torch import BatchSession
    from slam_rgbd_tpu_torch.core.config import MeshConfig
    from slam_rgbd_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.load(path, map_location=dev)
    counters = _par_counters()
    for c in counters.values():
        c.launches = 0
    mesh = pmesh.make_mesh(MeshConfig(data=1, model=world), "cuda")
    t0 = time.perf_counter()
    out = {"programs": _par_programs(mesh, x, cfg)}
    out["programs_ms"] = 1e3 * (time.perf_counter() - t0)
    out["program_launches"] = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    _par_programs(mesh, x, cfg)  # once more, warm: its launches are not counted
    out["programs_ms_again"] = 1e3 * (time.perf_counter() - t0)
    for c in counters.values():
        c.launches = 0
    mesh = pmesh.make_mesh(MeshConfig(data=world, model=1), "cuda")
    frames = _batch_frames(gts, leg.camera, dev)
    out["frames_sum"] = [int(sum(f[c].sum(dtype=torch.int64) for f in frames))
                         for c in (0, 1)]
    bs = BatchSession(leg, BATCH_B, mesh=mesh)
    check(bs.n_local == BATCH_B // world, f"{bs.n_local} sequences on rank {rank}")
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(frames) + 1)]
    inserted = []
    marks[0].record()
    for i, (depth, rgb) in enumerate(frames):
        before = int(bs._n_kf.sum())  # this rank's sequences only: no collective
        bs.process_frames(i / leg.camera.fps, depth, rgb)
        marks[i + 1].record()
        inserted.append(int(bs._n_kf.sum()) > before)
    torch.cuda.synchronize()
    out["step_ms"] = [marks[i].elapsed_time(marks[i + 1]) for i in range(len(frames))]
    out["inserted"] = inserted
    out["session_launches"] = {k: c.launches for k, c in counters.items()}
    out["poses"] = bs.poses()[1]
    out["kf"], out["loops"] = bs.keyframe_counts, bs.state.loops
    out["lost"], out["pts"] = bs.state.lost, bs.map_point_counts()
    del bs, frames

    # the map-block sharded session: each rank holds half of the point table
    from slam_rgbd_tpu_torch import SLAMSession
    from slam_rgbd_tpu_torch.runtime import checkpoint

    t0 = time.perf_counter()
    leg_cfg = _shard_leg_config(cfg)
    frames, _ = _shard_leg_frames(cfg)
    mesh = pmesh.make_mesh(leg_cfg.mesh, "cuda")
    sess = SLAMSession(leg_cfg, mesh=mesh)
    out["shard"] = _shard_session_run(sess, frames, cfg.camera.fps)
    checkpoint.save(sess, os.path.join(os.path.dirname(path), "shard_ckpt"))
    out["shard"]["leg_s"] = time.perf_counter() - t0
    del sess

    # the threaded sharded session on the same frames: forced by
    # `sync_backend()` after every call, then free-running
    for name, synced in (("shard_forced", True), ("shard_free", False)):
        t0 = time.perf_counter()
        sess = SLAMSession(leg_cfg, async_backend=True, mesh=mesh)
        try:
            out[name] = _shard_session_run(sess, frames, cfg.camera.fps, synced=synced)
            out[name]["leg_s"] = time.perf_counter() - t0
            # one blocking agreement (the drain's round trip over the host
            # group; a call starts one and reads it at the next): host clock
            t0 = time.perf_counter()
            for _ in range(AGREE_CALLS):
                sess._agreement_end(*sess._agreement_start())
            out[name]["agree_ms"] = 1e3 * (time.perf_counter() - t0) / AGREE_CALLS
        finally:
            sess.close()
        del sess
    return out


def _shard_reference(cfg) -> dict:
    """The sharded leg's frames through the unsharded session in this
    process, inline, and threaded under the forced schedule
    (`sync_backend()` after every call)."""
    from slam_rgbd_tpu_torch import SLAMSession

    frames, gt = _shard_leg_frames(cfg)
    t0 = time.perf_counter()
    out = _shard_session_run(SLAMSession(_shard_leg_config(cfg)), frames, cfg.camera.fps)
    out["s"], out["gt"] = time.perf_counter() - t0, gt
    sess = SLAMSession(_shard_leg_config(cfg), async_backend=True)
    try:
        out["forced"] = _shard_session_run(sess, frames, cfg.camera.fps, synced=True)
    finally:
        sess.close()
    return out


def _check_threaded_shard_leg(cfg, ranks, card: str, ref: dict) -> None:
    """The threaded sharded session on both ranks: forced, equal to the
    threaded unsharded session under the same schedule bit for bit (poses,
    keyframe poses, counts, the whole map, the merges and the worker's
    counts) with its kernel launches; free-running, the two ranks equal to
    each other bit for bit and the ATE within ATE_LIMIT_M. Prints the
    free-running tracked calls' p50 / p99 beside the inline leg's."""
    from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse

    want = ref["forced"]
    kf = want["counts"][0]
    n_tracked = len(want["ms"]) - 1
    check(len(want["backend"]["merges"]) >= 3, f"forced merges {want['backend']}")
    for r, res in enumerate(ranks):
        for name in ("shard_forced", "shard_free"):
            got = res[name]
            check(got["launches"]["gated_match"] == got["counts"][0] - 1,
                  f"rank {r} {name}: gated_match launches {got['launches']} for "
                  f"{got['counts'][0]} keyframes")
            check(got["launches"]["gn_reduce"] == 12 * n_tracked
                  and got["launches"]["gn_reduce_batched"] == 10 * n_tracked,
                  f"rank {r} {name}: gn launches {got['launches']}")
        got = res["shard_forced"]
        for k in ("poses", "kf_poses"):
            check(np.array_equal(got[k], want[k]), f"rank {r}: threaded {k} differ from the "
                  f"threaded unsharded session's by {np.abs(got[k] - want[k]).max():.3e}")
        for k in ("counts", "backend", "launches"):
            check(got[k] == want[k], f"rank {r}: threaded {k} {got[k]} != {want[k]}")
        diff = [k for k in want["digest"] if got["digest"][k] != want["digest"][k]]
        check(not diff, f"rank {r}: threaded map fields {diff} differ from the unsharded "
                        f"threaded session's")
    free = [res["shard_free"] for res in ranks]
    for k in ("poses", "kf_poses"):
        check(np.array_equal(free[0][k], free[1][k]), f"free-running ranks' {k} differ by "
              f"{np.abs(free[0][k] - free[1][k]).max():.3e}")
    for k in ("counts", "backend", "launches", "digest"):
        check(free[0][k] == free[1][k], f"free-running ranks' {k} differ: {free[0][k]} / "
                                        f"{free[1][k]}")
    ate = ate_rmse(free[0]["poses"], ref["gt"])[0]
    ate_inline = ate_rmse(ref["poses"], ref["gt"])[0]
    check(ate <= ATE_LIMIT_M, f"threaded sharded ATE {ate:.4f} m above {ATE_LIMIT_M} m")
    steady = slice(STEADY_FROM, None)

    def tracked(run):
        return np.asarray(run["ms"])[steady][~np.asarray(run["inserted"])[steady]]

    fb = free[0]["backend"]
    print(f"SLAMSession(cfg, async_backend=True, mesh=) over {PAR_RANKS} gloo ranks sharing "
          f"one card, the same {len(want['ms'])} frames: forced by sync_backend() each call, "
          f"every pose, the whole map, the {len(want['backend']['merges'])} merges and the "
          f"worker's counts equal to the threaded unsharded session's bit for bit on both "
          f"ranks (keyframes {kf}); free-running, the ranks equal bit for bit: keyframes "
          f"{free[0]['counts'][0]}, lost {free[0]['counts'][1]}, relocalized "
          f"{free[0]['counts'][2]}, loops {free[0]['counts'][3]}, {len(fb['merges'])} merges, "
          f"{fb['completed']} passes completed, {fb['skipped']} skipped; ATE "
          f"{100 * ate:.3f} cm (inline leg {100 * ate_inline:.3f} cm)")
    print(f"  tracked calls (frames {STEADY_FROM}-, CUDA events) p50 / p99: threaded "
          f"{' , '.join(f'{np.percentile(tracked(f), 50):.3f} / {np.percentile(tracked(f), 99):.3f}' for f in free)} "
          f"ms on the ranks, inline leg "
          f"{' , '.join(f'{np.percentile(tracked(res['shard']), 50):.3f} / {np.percentile(tracked(res['shard']), 99):.3f}' for res in ranks)} "
          f"ms; insert calls p50 threaded "
          f"{' / '.join(f'{np.percentile(np.asarray(f['ms'])[np.asarray(f['inserted'])], 50):.3f}' for f in free)} "
          f"ms; a blocking agreement (a MIN all-reduce of 3 int32 over the gloo host "
          f"group, the drain's round trip, host clock, mean of {AGREE_CALLS}) "
          f"{' / '.join(f'{f['agree_ms']:.4f}' for f in free)} ms on the ranks; "
          f"launches a rank free-running {free[0]['launches']}; the legs "
          f"{max(res['shard_forced']['leg_s'] for res in ranks):.1f} s forced, "
          f"{max(res['shard_free']['leg_s'] for res in ranks):.1f} s free-running ({card})")


def _check_shard_leg(cfg, ranks, card: str, ref: dict, ckpt_dir: str) -> None:
    """Both ranks' sharded session against the unsharded one: keyframes,
    lost / relocalized counts, every pose and the whole map bit for bit; a
    rank's K3 launches one an insert with a map and its K2 launches those of
    the unsharded relocalization (two a try, the match and its cross-check);
    the ranks' checkpoint restored into an unsharded session."""
    from slam_rgbd_tpu_torch import SLAMSession
    from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse
    from slam_rgbd_tpu_torch.runtime import checkpoint

    kf, lost, reloc = ref["counts"][:3]
    check(lost >= 1 and reloc >= 1, f"the damaged frame was not relocalized: {ref['counts']}")
    for r, res in enumerate(ranks):
        got = res["shard"]
        check(got["block_rows"] == cfg.keyframes.max_map_points // PAR_RANKS,
              f"rank {r} holds {got['block_rows']} point rows")
        check(got["counts"] == ref["counts"], f"rank {r}: counts {got['counts']} != "
              f"{ref['counts']} (keyframes, lost, relocalized, loops, map points)")
        for k in ("poses", "kf_poses"):
            check(np.array_equal(got[k], ref[k]), f"rank {r}: {k} differ from the unsharded "
                  f"session's by {np.abs(got[k] - ref[k]).max():.3e}")
        diff = [k for k in ref["digest"] if got["digest"][k] != ref["digest"][k]]
        check(not diff, f"rank {r}: map fields {diff} differ from the unsharded session's")
        check(got["launches"]["gated_match"] == ref["launches"]["gated_match"] == kf - 1,
              f"rank {r}: gated_match launches {got['launches']} for {kf} keyframes")
        check(got["launches"]["hamming_top2"] == ref["launches"]["hamming_top2"] >= 2,
              f"rank {r}: hamming_top2 launches {got['launches']} against "
              f"{ref['launches']}")
        n_tracked = len(ref["ms"]) - 1
        check(got["launches"]["gn_reduce"] == 12 * n_tracked
              and got["launches"]["gn_reduce_batched"] == 10 * n_tracked,
              f"rank {r}: gn launches {got['launches']}")
    restored = checkpoint.restore(SLAMSession(_shard_leg_config(cfg)), ckpt_dir)
    check(_map_digest(restored.map, None) == ref["digest"],
          "the ranks' checkpoint restored unsharded is not the unsharded session's map")
    check(np.array_equal(restored.keyframe_poses()[1], ref["kf_poses"]),
          "the restored keyframe poses differ")
    ate = ate_rmse(ref["poses"], ref["gt"])[0]
    steady = slice(STEADY_FROM, None)
    tracked = [np.asarray(res["shard"]["ms"])[steady][~np.asarray(res["shard"]["inserted"])[steady]]
               for res in ranks]
    ref_tracked = np.asarray(ref["ms"])[steady][~np.asarray(ref["inserted"])[steady]]
    print(f"SLAMSession(cfg, mesh=) map-block sharded over {PAR_RANKS} gloo ranks sharing one "
          f"card, {cfg.camera.width}x{cfg.camera.height}, {cfg.keyframes.max_map_points} "
          f"points ({cfg.keyframes.max_map_points // PAR_RANKS} a rank), "
          f"{cfg.orb.n_features} features, inline backend, max_decision_lag=1, "
          f"{len(ref['ms'])} frames (frame {SHARD_FRAMES} damaged): keyframes {kf}, lost "
          f"{lost}, relocalized {reloc}, map points {ref['counts'][4]}, every pose and the "
          f"whole map equal to the unsharded session's bit for bit on both ranks; ATE "
          f"{100 * ate:.3f} cm")
    print(f"  launches a rank {ranks[0]['shard']['launches']} (unsharded "
          f"{ref['launches']}); checkpoint from the ranks restored unsharded: map equal")
    print(f"  tracked calls (frames {STEADY_FROM}-, CUDA events) p50 "
          f"{' / '.join(f'{np.percentile(t, 50):.3f}' for t in tracked)} ms on the ranks, "
          f"{np.percentile(ref_tracked, 50):.3f} ms unsharded; insert calls p50 "
          f"{' / '.join(f'{np.percentile(np.asarray(res['shard']['ms'])[np.asarray(res['shard']['inserted'])], 50):.3f}' for res in ranks)} "
          f"ms on the ranks, {np.percentile(np.asarray(ref['ms'])[np.asarray(ref['inserted'])], 50):.3f} "
          f"ms unsharded; the leg {max(res['shard']['leg_s'] for res in ranks):.1f} s on "
          f"the ranks (rendering included), {ref['s']:.1f} s unsharded ({card})")


def parallel_phase(cfg, card: str, ham: dict, ba_window: dict, leg_graph: dict,
                   batch: dict) -> dict:
    """The parallel layer on the card: the five sharded programs on one NCCL
    rank (mesh (1, 1)) and on two gloo ranks sharing the card (mesh (1, 2)),
    each against the unsharded port; `BatchSession(cfg, 4, mesh=)` on the
    two ranks (mesh (2, 1)) against the unsharded session on the same
    frames; `scaling.batch_scaling`; and `benchmark --scaling` as a
    subprocess."""
    phase("parallel")
    import torch.distributed as tdist

    from slam_rgbd_tpu_torch.core.config import MeshConfig
    from slam_rgbd_tpu_torch.parallel import mesh as pmesh
    from slam_rgbd_tpu_torch.parallel import scaling

    t_phase = time.perf_counter()
    leg, frames = batch["leg"], batch["frames"]
    x = _par_inputs(ham["inputs"], ba_window, leg_graph, frames)
    counters = _par_counters()
    launches = dict.fromkeys(counters, 0)
    _par_unsharded(x, ham["inputs"]["map"], cfg)  # warm-up, outside the timings

    # ---- one rank over NCCL, mesh (1, 1)
    with tempfile.TemporaryDirectory() as tmp:
        pmesh.initialize_distributed(f"file://{os.path.join(tmp, 'store')}", 1, 0,
                                     device="cuda")
        try:
            check(tdist.get_backend() == "nccl", f"backend {tdist.get_backend()}")
            mesh = pmesh.make_mesh(MeshConfig(), "cuda")
            check(tuple(mesh.shape) == (1, 1), f"mesh {tuple(mesh.shape)}")
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            one = _par_programs(mesh, x, cfg)
            one_ms = 1e3 * (time.perf_counter() - t0)
            for k, c in counters.items():
                launches[k] += c.launches
            nccl_launches = {k: c.launches for k, c in counters.items()}
            t0 = time.perf_counter()
            _par_programs(mesh, x, cfg)  # once more, warm: its launches are not counted
            again_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            tdist.destroy_process_group()
    t0 = time.perf_counter()
    want = _par_unsharded(x, ham["inputs"]["map"], cfg)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    k1 = x["q_signs"].shape[0]
    _par_check(f"mesh (1, 1), NCCL", one, want, slice(0, k1))
    print(f"  the five programs on the mesh {one_ms:.1f} ms the first time (NCCL's set-up "
          f"at the first collective included), {again_ms:.1f} ms the second; unsharded "
          f"{plain_ms:.1f} ms (host clock, synchronised, warm; {card}); kernel launches "
          f"{nccl_launches}")
    check(nccl_launches == {"gn_reduce_batched": 22, "gn_reduce": 0, "gated_match": 2,
                            "hamming_top2": 1}, f"launches {nccl_launches}")

    # ---- two ranks sharing the card over gloo
    ref_bs, ref_ms, ref_ins = _batch_run(leg, frames, BATCH_B)
    ref_poses = ref_bs.poses()[1]
    shard_ref = _shard_reference(cfg)
    tmp = tempfile.mkdtemp(prefix="slam_par_")
    ckpt_dir = os.path.join(tmp, "shard_ckpt")
    try:
        path = os.path.join(tmp, "inputs.pt")
        torch.save({k: v.cpu() for k, v in x.items()}, path)
        t0 = time.perf_counter()
        ranks = pmesh.spawn(_parallel_rank, PAR_RANKS, args=(path, cfg, leg, batch["gts"]),
                            backend="gloo", device="cuda")
        ranks_s = time.perf_counter() - t0
    finally:
        os.remove(os.path.join(tmp, "inputs.pt"))
    block = k1 // PAR_RANKS
    for r, res in enumerate(ranks):
        _par_check(f"mesh (1, 2), gloo, rank {r}", res["programs"], want,
                   slice(r * block, (r + 1) * block))
        for k in ("ba_pose", "ba_pts", "ba_n", "pg_poses", "pg_n", "tk_T", "tk_inl",
                  "assoc_True", "assoc_False"):
            check(np.array_equal(res["programs"][k], ranks[0]["programs"][k]),
                  f"rank {r}: replicated output {k} differs from rank 0's")
        check(res["program_launches"] == nccl_launches,
              f"rank {r} program launches {res['program_launches']}")
        want_sum = [int(sum(f[c].sum(dtype=torch.int64) for f in frames)) for c in (0, 1)]
        check(res["frames_sum"] == want_sum, f"rank {r} rendered other frames")
        check(np.array_equal(res["poses"], ref_poses),
              f"rank {r}: the sharded session's poses differ from the unsharded session's "
              f"by {np.abs(res['poses'] - ref_poses).max():.2e}")
        for k, want_k in (("kf", ref_bs.keyframe_counts), ("loops", ref_bs.state.loops),
                          ("lost", ref_bs.state.lost), ("pts", ref_bs.map_point_counts())):
            check(np.array_equal(res[k], want_k), f"rank {r}: {k} {res[k]} != {want_k}")
        for k in counters:
            launches[k] += res["program_launches"][k] + res["session_launches"][k]
    steady = slice(STEADY_FROM, None)
    rank_ms = [np.asarray(res["step_ms"])[steady] for res in ranks]
    tracked = [m[~np.asarray(res["inserted"])[steady]] for m, res in zip(rank_ms, ranks)]
    ref_tracked = ref_ms[steady][~ref_ins[steady]]
    print(f"BatchSession(cfg, {BATCH_B}, mesh=) over 2 gloo ranks sharing one card, "
          f"{len(frames)} frames at {leg.camera.width}x{leg.camera.height}: poses, "
          f"keyframes {ranks[0]['kf'].tolist()}, loops {ranks[0]['loops'].tolist()}, lost "
          f"{ranks[0]['lost'].tolist()} and map points {ranks[0]['pts'].tolist()} equal "
          f"the unsharded BatchSession's on every rank")
    print(f"  2 ranks sharing one card ({card}): steps {STEADY_FROM}-{len(frames) - 1} p50 "
          f"{' / '.join(f'{np.percentile(m, 50):.3f}' for m in rank_ms)} ms (rank 0 / 1, "
          f"2 sequences each, CUDA events), {BATCH_B * len(rank_ms[0]) / (max(m.sum() for m in rank_ms) / 1e3):.2f} "
          f"sequence-frames/s; steps without an insert on the rank "
          f"({' / '.join(str(len(t)) for t in tracked)}) p50 "
          f"{' / '.join(f'{np.percentile(t, 50):.3f}' if len(t) else '-' for t in tracked)} ms; "
          f"the unsharded session in this process p50 "
          f"{np.percentile(ref_ms[steady], 50):.3f} ms, steps without an insert "
          f"({len(ref_tracked)}) p50 "
          f"{np.percentile(ref_tracked, 50) if len(ref_tracked) else float('nan'):.3f} ms, "
          f"{BATCH_B * len(ref_ms[steady]) / (ref_ms[steady].sum() / 1e3):.2f} sequence-frames/s; "
          f"the two ranks' programs {ranks[0]['programs_ms']:.1f} / "
          f"{ranks[1]['programs_ms']:.1f} ms the first time, "
          f"{ranks[0]['programs_ms_again']:.1f} / {ranks[1]['programs_ms_again']:.1f} ms "
          f"the second; start to end {ranks_s:.1f} s")
    print(f"  rank launches (programs + session): "
          f"{[{k: res['program_launches'][k] + res['session_launches'][k] for k in counters} for res in ranks]}")
    for res in ranks:
        check(res["session_launches"]["gn_reduce_batched"] == 22 * (len(frames) - 1),
              f"session launches {res['session_launches']}")
        check(res["session_launches"]["gn_reduce"] == 0, "a single gn_reduce launch")
    for r, res in enumerate(ranks):
        own = res["kf"][r * (BATCH_B // PAR_RANKS): (r + 1) * (BATCH_B // PAR_RANKS)]
        check(res["session_launches"]["gated_match"] == int((own - 1).sum()),
              f"rank {r} gated_match launches {res['session_launches']}")

    # ---- the map-block sharded session on the two ranks, inline and threaded
    for r, res in enumerate(ranks):
        for k in counters:
            launches[k] += sum(res[leg]["launches"][k]
                               for leg in ("shard", "shard_forced", "shard_free"))
    _check_shard_leg(cfg, ranks, card, shard_ref, ckpt_dir)
    _check_threaded_shard_leg(cfg, ranks, card, shard_ref)
    shutil.rmtree(tmp, ignore_errors=True)

    # ---- batch scaling on the card
    for c in counters.values():
        c.launches = 0
    rows = scaling.batch_scaling(cfg.camera, cfg.icp, iters=SCALING_ITERS)
    for k, c in counters.items():
        launches[k] += c.launches
    for r in rows:
        print(f"batch_scaling {cfg.camera.width}x{cfg.camera.height} B={r['batch']}: "
              f"{r['frames_per_s']:.2f} frames/s, step {r['step_ms']:.3f} ms, efficiency "
              f"{r['efficiency']:.3f}" + (f", marginal {r['marginal_ms_per_seq']:.3f} ms a "
                                          f"sequence" if "marginal_ms_per_seq" in r else "")
              + f" (CUDA events, mean of {SCALING_ITERS}; {card})")
    check([r["batch"] for r in rows] == [1, 2, 4, 8] and all(
        r["frames_per_s"] > 0 for r in rows), f"batch scaling rows {rows}")
    check(counters["gn_reduce_batched"].launches == 22 * (SCALING_ITERS + 2) * 4,
          f"batch_scaling launches {counters['gn_reduce_batched'].launches}")

    # ---- the verb, as a user runs it
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "scaling.json")
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "slam_rgbd_tpu_torch", "benchmark", "--scaling",
             "--iters", "5", "--out", out], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0, f"benchmark --scaling failed ({cli.returncode}): "
                                   f"{cli.stderr[-2000:]}")
        with open(out) as f:
            rep = json.load(f)
    check(rep["hardware"] == torch.cuda.get_device_name(0) and rep["n_devices"] == 1
          and rep["platform"] == "cuda", f"report {rep}")
    check([r["mesh_data"] for r in rep["mesh_scaling"]] == [1]
          and len(rep["batch_scaling_1dev"]) == 4, f"report tables {rep}")
    print(f"`benchmark --scaling --iters 5` in {cli_s:.1f} s: {rep['hardware']}, "
          f"n_devices {rep['n_devices']}, mesh_scaling "
          f"{[(r['mesh_data'], round(r['frames_per_s'], 2)) for r in rep['mesh_scaling']]} "
          f"frames/s, batch_scaling_1dev "
          f"{[(r['batch'], round(r['frames_per_s'], 2)) for r in rep['batch_scaling_1dev']]} "
          f"frames/s ({card})")
    print(f"parallel phase {time.perf_counter() - t_phase:.1f} s (host clock)")
    return launches


def main() -> int:
    flags = set(sys.argv[1:])
    check(flags <= {"--control", "--profile"}, f"unknown arguments {sys.argv[1:]}")
    with_control, with_profile = "--control" in flags, "--profile" in flags
    card = device_phase()
    logging.getLogger("slam_rgbd_tpu_torch").addHandler(ERRORS)
    from slam_rgbd_tpu_torch import astra_default_config

    cfg = astra_default_config()
    build_phase()
    launch_floor_phase()
    gn = gn_kernel_phase(cfg)
    gnb = gn_batched_kernel_phase(cfg)
    ham = hamming_kernel_phase(cfg)
    small_phase(cfg)
    small_backend = small_backend_phase(cfg)
    run = main_phase(cfg, with_control, with_profile)
    ba_window = _ba_window(run["session"].map, cfg)
    reloc = reloc_phase(run)
    lost = lost_phase(cfg, run)
    run["session"].close()
    degraded = degraded_phase(cfg, run)
    pipe = pipeline_phase(cfg, run)
    main_launches, gated_launches = run["launches"], run["gated_launches"]
    stacked_launches, main_top2 = run["stacked_launches"], run["top2_launches"]
    del run  # the sweep's frames and map
    torch.cuda.empty_cache()
    leg = loop_leg_phase(cfg)
    small_batch_phase(cfg)
    batch = batch_phase(cfg, with_profile)
    check_no_errors("batch phases")
    par = parallel_phase(cfg, card, ham, ba_window, leg["graph"], batch)
    batch_launches = {k: batch[k] for k in ("batched", "gated", "top2")}
    del batch
    check_no_errors("parallel phase")
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
             launches=(main_launches + degraded["gn_reduce"] + pipe["gn_reduce"]
                       + leg["gn_reduce"] + par["gn_reduce"]),
             max_abs_err=gn["max_err"],
             **{k: full[k] for k in timing}, library_ms=None),
        dict(name="gn_reduce_batched", route="cuda", source=csrc + "gn_reduce.cu",
             replaces="slam_rgbd_tpu/ops/icp_pallas.py:493",
             launches=(stacked_launches + degraded["gn_reduce_batched"]
                       + pipe["gn_reduce_batched"] + leg["gn_reduce_batched"]
                       + batch_launches["batched"] + par["gn_reduce_batched"]),
             max_abs_err=gnb["max_err"],
             **{k: full_b[k] for k in timing}, library_ms=None),
        dict(name="gated_match", route="cuda", source=csrc + "hamming.cu",
             replaces="slam_rgbd_tpu/ops/hamming_pallas.py:291",
             launches=(gated_launches + degraded["gated_match"] + pipe["gated_match"]
                       + leg["gated_match"] + batch_launches["gated"]
                       + par["gated_match"]),
             max_abs_err=ham["gated_match"]["max_abs_err"],
             **{k: ham["gated_match"][k] for k in timing}, library_ms=None),
        dict(name="hamming_top2", route="cuda", source=csrc + "hamming.cu",
             replaces="slam_rgbd_tpu/ops/hamming_pallas.py:119",
             launches=(main_top2 + reloc["launches"] + lost["launches"]
                       + degraded["hamming_top2"] + pipe["hamming_top2"]
                       + leg["hamming_top2"]
                       + small_backend["top2"] + batch_launches["top2"]
                       + par["hamming_top2"]),
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
