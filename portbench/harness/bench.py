"""One run of one cell: set-up, the window, the metrics, the output check,
and the result line."""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time

import numpy as np
import torch

from portbench.harness import check, drive, spec, traffic
from portbench.harness.trace import Tracer
from portbench.reference.camera import Camera
from portbench.reference.synthetic import orbit, render_frames, seeded_room
from portbench.reference.trajectory import ate_rms

FORBIDDEN = ("jax", "jaxlib", "flax", "slam_rgbd_tpu")


def p95(values) -> float:
    """The 95th percentile by linear interpolation between order statistics
    (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def forbidden_modules() -> list:
    """Top-level names in `sys.modules` that the run must not load, compared
    whole: `slam_rgbd_tpu_torch` is not `slam_rgbd_tpu`."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def end_to_end(rec: drive.Record, gt: np.ndarray, setup_s: float) -> dict:
    """The cell's end-to-end metrics from its untraced window."""
    recs = [(r.est[b], gt[r.frames[: r.est.shape[1], b] % len(gt)])
            for r in rec.recordings for b in range(r.est.shape[0]) if r.est.shape[1]]
    return {
        "frames_per_s": rec.frames_done / rec.window_s,
        "call_ms_p95": p95([c["ms"] for c in rec.calls]),
        "ate_cm": 100.0 * ate_rms(recs),
        "setup_s": setup_s,
    }


def lost_frames(r: drive.Recording) -> int:
    """Frames (stream-frames in a batch) whose tracking was lost."""
    return int((~r.ring["ok"]).sum()) if "ok" in r.ring else int(r.ring["lost"].sum())


def keyframes(r: drive.Recording) -> list:
    """Keyframes each stream of a recording inserted."""
    if "n_kf" in r.ring:
        return [r.ring["n_kf"]]
    return r.ring["n_kf_streams"].tolist()


def window_shares(rec: drive.Record) -> dict:
    """{call kind: (calls, share of the window's wall time in them)}, and
    under "between" the share outside every call (new sessions, resets,
    drains)."""
    out, inside = {}, 0.0
    for c in rec.calls:
        n, ms = out.get(c["kind"], (0, 0.0))
        out[c["kind"]] = (n + 1, ms + c["ms"])
        inside += c["ms"]
    shares = {k: (n, ms / (10.0 * rec.window_s)) for k, (n, ms) in sorted(out.items())}
    shares["between"] = (0, 100.0 - inside / (10.0 * rec.window_s))
    return shares


def span_rows(rec: drive.Record) -> list:
    """The window's spans, each {name, parent, thread, call, start_s, end_s
    (seconds of the window), traced (it overlaps the profiler's slice)}."""
    lo, hi = (rec.trace or {}).get("slice_s", (float("inf"), float("-inf")))
    rows = []
    for s in rec.spans:
        a, b = s.start - rec.t0, s.end - rec.t0
        rows.append({"name": s.name, "parent": s.parent, "thread": s.thread, "call": s.call,
                     "start_s": a, "end_s": b, "traced": a < hi and b > lo})
    return rows


def span_median_ms(record: dict, name: str) -> float | None:
    """Median ms of the spans called `name` outside the traced slice; None
    where there is none."""
    ms = [1e3 * (s["end_s"] - s["start_s"]) for s in record["spans"]
          if s["name"] == name and not s["traced"]]
    return statistics.median(ms) if ms else None


def layer_record(rec: drive.Record, conf: dict, card: str) -> dict:
    """What the per-layer readers read: the window's calls (host clock),
    the backend passes' `backend_ms`, the worker's counts, the trace's
    summary, the program's spans (`span_rows`) and its log records (as
    `MetricsLog.records` holds them)."""
    return {
        "session": rec.kind, "streams": rec.streams, "calls": rec.calls,
        "backend_ms": rec.backend_ms,
        "worker": {"completed": sum(r.completed for r in rec.recordings),
                   "skipped": sum(r.skipped for r in rec.recordings)},
        "trace": rec.trace, "config": conf["slam"], "card": card,
        "spans": span_rows(rec), "log": rec.log,
    }


def prepare(cell: spec.Cell, seed: int, device, traced: bool, process_age) -> dict:
    """Set-up: the inputs rendered from the seed, the check's sample, and the
    driver with its session built and warmed up."""
    conf, mix = cell.config, cell.mix
    from slam_rgbd_tpu_torch.core.config import SLAMConfig

    split = {"import_s": process_age()}
    slam = SLAMConfig.from_dict(conf["slam"])
    cam = Camera.from_dict(conf["slam"]["camera"])
    t = time.perf_counter()
    n = int(mix["frames"])
    poses = orbit(n)
    rooms = traffic.room_order(mix, seed)
    used = np.unique(traffic.schedule(mix, int(conf["streams"]), traffic.period(mix)))
    depth = np.zeros((len(rooms) * n, cam.height, cam.width), np.uint16)
    rgb = np.zeros((len(rooms) * n, cam.height, cam.width, 3), np.uint8)
    for k in range(len(rooms)):
        room = seeded_room(k, poses[:, :3, 3])
        render_frames(poses, cam, room, device, depth[k * n:(k + 1) * n],
                      rgb[k * n:(k + 1) * n], used)
    split["render_s"] = time.perf_counter() - t
    sample = check.draw_sample(seed, int(conf["streams"]))
    Driver = {"single": drive.SingleDriver, "batch": drive.BatchDriver}[conf["session"]]
    drv = Driver(slam, conf, depth, rgb, mix, device, sample, rooms)
    metrics = None
    if traced:
        from slam_rgbd_tpu_torch.runtime.profiling import MetricsLog

        metrics = MetricsLog(spans=True)
    t = time.perf_counter()
    drv.setup(metrics)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # what set-up made stays: the window's full collections then scan only
    # what the window makes, the same at every seed
    gc.collect()
    gc.freeze()
    split["warm_s"] = time.perf_counter() - t
    split["setup_s"] = process_age()
    return {"poses": poses, "depth": depth, "rgb": rgb, "sample": sample, "drv": drv,
            "split": split}


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             process_age) -> tuple[dict, list]:
    """-> (the result line's object, the check's rows (name, value, limit))."""
    conf, mix = cell.config, cell.mix
    st = prepare(cell, seed, device, traced, process_age)
    poses, depth, rgb, sample, drv = (st[k] for k in ("poses", "depth", "rgb", "sample", "drv"))
    setup_s = st["split"]["setup_s"]
    print(json.dumps({"setup_split": st["split"]}), flush=True)

    tracer = Tracer(float(mix["trace_after_s"]), float(mix["trace_s"]), device) if traced else None
    rec = drv.run(seconds, tracer)
    if tracer is not None:
        rec.trace = tracer.summary
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    mem = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    drv.close()
    del drv, st
    gc.unfreeze()
    gc.collect()

    lost = sum(lost_frames(r) for r in rec.recordings)
    if traced:
        record = layer_record(rec, conf, card)
        metrics_out = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](record)
            if v is not None:
                metrics_out[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = end_to_end(rec, poses, setup_s)
        metrics_out = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end}

    t = time.perf_counter()
    checker = check.Checker(conf, depth, rgb, device, int(mix["check_tracked"]))
    numbers = checker.numbers(rec, sample)
    print(f"portbench: window {rec.window_s:.3f} s, {len(rec.calls)} calls, "
          f"{len(rec.recordings)} recordings; check {time.perf_counter() - t:.1f} s "
          f"({numbers['_counts']})", file=sys.stderr)
    print("portbench: window by call kind (calls, % of the window): " + ", ".join(
        f"{k} {n} {share:.2f}%" for k, (n, share) in window_shares(rec).items()),
        file=sys.stderr)
    print("portbench: recordings (room ids, keyframes a stream, map points a stream, frames "
          "lost, loops merged): " + "; ".join(
              f"{sorted(set((r.frames[0] // len(poses)).tolist()))} "
              f"{keyframes(r)} {r.points} {lost_frames(r)} "
              f"{'-' if r.loops is None else r.loops}"
              for r in rec.recordings), file=sys.stderr)
    if rec.trace is not None:
        t = rec.trace
        print(f"portbench: trace of {sum(c['traced'] for c in rec.calls)} calls over {t['host_span_s']:.3f} s "
              f"(profiler start {t['start_s']:.2f} s): {t['n_device_events']} device and "
              f"{t['n_host_events']} host events, slice {t['window_s']:.3f} s, events over "
              f"{(t['first_last_ns'][1] - t['first_last_ns'][0]) / 1e9:.3f} s, reduced in "
              f"{t['reduce_s']:.1f} s", file=sys.stderr)
    correct, rows = check.verdict(numbers, cell.limits, mix["checks"])
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules that the run must not load are loaded: {bad}")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": card,
           "count": cell.chips, "memory_peak_bytes": int(mem)}
    out = {"correct": bool(correct), "attempted": rec.frames_done, "failed": lost,
           "metrics": metrics_out, "device": dev}
    if traced and rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    out["check"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    out["check"]["compared"] = numbers["_counts"]
    return out, rows

