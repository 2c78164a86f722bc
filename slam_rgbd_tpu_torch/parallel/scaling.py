"""Scaling harness: frames/s against the number of sequences on one device
and against the mesh size.

Counterpart of `slam_rgbd_tpu/parallel/scaling.py`. The workload that
parallelizes without traffic is multi-sequence odometry (`dist.batch_track`:
B sequences over the `data` axis, the multi-sequence batch mode).

  * `batch_scaling` - frames/s at B = 1, 2, 4, 8 sequences on ONE device
    (`icp_align_batched`, one batched GN launch an iteration for all B):
    how many sequences one device tracks before its time grows with B.
  * `mesh_scaling` - frames/s of `dist.batch_track` at mesh sizes 1, 2, 4,
    ... up to the number of cards, one rank (a process) a card and one
    sequence a rank.

Each row reports frames/s and efficiency = fps(n) / (n * fps(1)). Times on
a card come from CUDA events (one device) or the host clock around
synchronised work (across ranks); on the CPU from the host clock, and the
report says so.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as tdist

from slam_rgbd_tpu_torch.core import camera
from slam_rgbd_tpu_torch.core.config import CameraIntrinsics, ICPConfig, MeshConfig
from slam_rgbd_tpu_torch.parallel import dist
from slam_rgbd_tpu_torch.parallel.mesh import make_mesh, spawn
from slam_rgbd_tpu_torch.runtime.session import _resolve_device


def _make_pair(cam: CameraIntrinsics, cfg: ICPConfig, device):
    """One (src, tgt) pyramid pair of two rendered frames 1.5 cm / 0.7 deg
    apart, every leaf with a leading batch axis of 1."""
    from slam_rgbd_tpu_torch.io.synthetic import SceneSpec, orbit_trajectory, render_frame

    spec = SceneSpec()
    poses = orbit_trajectory(2, spec, step_t=0.015, step_r=0.012)
    pyrs = []
    for p in poses:
        depth, rgb = render_frame(p, cam, spec, device=device)
        pyrs.append(camera.build_frame_pyramid(depth[None], cam, levels=cfg.levels,
                                               rgb=rgb[None]))
    return pyrs[0], pyrs[1]


def _tile(pyr, b: int):
    """A batch-1 pyramid repeated to batch b."""
    return tuple({k: v.expand((b,) + v.shape[1:]).contiguous() for k, v in lvl.items()}
                 for lvl in pyr)


def _step_ms(fn, iters: int, dev: torch.device) -> float:
    """Mean ms of one `fn()` over `iters` calls after two warm-up calls:
    CUDA events around the calls on a card, the host clock on the CPU."""
    for _ in range(2):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def batch_scaling(cam: CameraIntrinsics, cfg: ICPConfig, batches=(1, 2, 4, 8),
                  iters: int = 20, device="cuda") -> list[dict]:
    """Frames/s at batch sizes B on ONE device: `icp_align_batched` with B
    copies of one frame pair, each GN iteration one batched launch.

    Rows: batch, frames_per_s, step_ms, efficiency (fps(B) / (B * fps(1)))
    and, from the second row on, marginal_ms_per_seq: the step time each
    added sequence costs. Near 0 while one problem leaves the device idle;
    near step_ms(1) once one problem fills it."""
    from slam_rgbd_tpu_torch.odometry.icp import icp_align_batched

    dev = _resolve_device(device)
    src1, tgt1 = _make_pair(cam, cfg, dev)
    rows = []
    for b in batches:
        src, tgt = _tile(src1, b), _tile(tgt1, b)
        T0 = torch.eye(4, device=dev).repeat(b, 1, 1)
        ms = _step_ms(lambda: icp_align_batched(src, tgt, T0, cam, cfg), iters, dev)
        rows.append({"batch": b, "frames_per_s": 1e3 * b / ms, "step_ms": ms})
    base = rows[0]["frames_per_s"]
    for prev, r in zip([None] + rows, rows):
        r["efficiency"] = r["frames_per_s"] / (r["batch"] * base)
        if prev is not None:
            r["marginal_ms_per_seq"] = (
                (r["step_ms"] - prev["step_ms"]) / (r["batch"] - prev["batch"]))
    return rows


def _mesh_rank(rank: int, world: int, cam, cfg, iters: int, device_type: str) -> float:
    """One rank of `mesh_scaling`: its sequence through `batch_track` on a
    (world, 1) mesh; returns the slowest rank's seconds for `iters` steps."""
    dev = _resolve_device(device_type)
    mesh = make_mesh(MeshConfig(data=world, model=1), device_type=dev.type)
    src, tgt = _make_pair(cam, cfg, dev)
    T0 = torch.eye(4, device=dev)[None]

    def step():
        dist.batch_track(mesh, src, tgt, T0, cam, cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        tdist.all_reduce(torch.zeros(1, device=dev))

    for _ in range(2):
        step()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    sync()
    dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=dev)
    tdist.all_reduce(dt, op=tdist.ReduceOp.MAX)
    return float(dt)


def n_devices(device) -> int:
    """Cards torch sees for a CUDA device; 1 (the host) for the CPU."""
    return torch.cuda.device_count() if _resolve_device(device).type == "cuda" else 1


def mesh_scaling(cam: CameraIntrinsics, cfg: ICPConfig, mesh_sizes=None,
                 iters: int = 10, device="cuda") -> list[dict]:
    """Frames/s of `dist.batch_track` at mesh sizes n (default 1, 2, 4, 8 up
    to `n_devices`): n ranks started by `mesh.spawn` (NCCL on cards, one
    card a rank; gloo on the CPU), one sequence a rank, timed over `iters`
    steps by the host clock of the slowest rank around synchronised work."""
    dev_type = _resolve_device(device).type
    if mesh_sizes is None:
        mesh_sizes = [n for n in (1, 2, 4, 8) if n <= n_devices(device)]
    rows = []
    for n in mesh_sizes:
        dt = spawn(_mesh_rank, n, args=(cam, cfg, iters, dev_type), device=dev_type)[0]
        rows.append({"mesh_data": n, "frames_per_s": n * iters / dt})
    base = rows[0]["frames_per_s"]
    for r in rows:
        r["efficiency"] = r["frames_per_s"] / (r["mesh_data"] * base)
    return rows


def scaling_report(cam: CameraIntrinsics | None = None, cfg: ICPConfig | None = None,
                   iters: int = 10, width: int | None = None,
                   height: int | None = None, device="cuda") -> dict:
    """The report of `benchmark --scaling`: platform, hardware (the card's
    name, or `cpu`), device count, resolution, mesh scaling and one-device
    batch scaling; a note where ranks share a device."""
    from slam_rgbd_tpu_torch.core.config import astra_default_config

    base = astra_default_config()
    cam = cam or base.camera
    if width and height:
        cam = dataclasses.replace(cam, width=width, height=height,
                                  cx=width / 2 - 0.5, cy=height / 2 - 0.5)
    cfg = cfg or base.icp
    dev = _resolve_device(device)
    n_dev = n_devices(device)
    mesh_rows = mesh_scaling(cam, cfg, iters=iters, device=device)
    report = {
        "platform": dev.type,
        "hardware": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n_devices": n_dev,
        "resolution": f"{cam.width}x{cam.height}",
        "mesh_scaling": mesh_rows,
        "batch_scaling_1dev": batch_scaling(cam, cfg, iters=iters, device=dev),
    }
    if dev.type == "cpu" or any(r["mesh_data"] > n_dev for r in mesh_rows):
        report["note"] = (
            "ranks share a device (the CPU's cores, or one card): mesh efficiency "
            "here checks the sharded program, not scaling across devices")
    return report
