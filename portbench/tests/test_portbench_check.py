"""The output check, driven through whole runs at a small size on the CPU:
the result line, the control (the reference in TF32 in the program's place)
failing where the program passes, and `correct` coming out false with the
timed path broken underneath, once for each fault the cells can have. The
`cuda` test reads the control at a cell's own size on the card.

    python -m pytest portbench/tests -q"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from portbench.harness import bench, check, spec
from portbench.reference import tracker as ref_track
from portbench.reference.camera import Camera
from portbench.reference.synthetic import orbit, render, seeded_room

CPU = torch.device("cpu")


def small(name: str, calls: int = 40, streams: int = 3) -> spec.Cell:
    """The cell at 128x96 on a shorter trajectory in two rooms, with holds
    of 24 calls a recording, for the CPU."""
    cell = spec.load_cell(name)
    cam = cell.config["slam"]["camera"]
    f = 5.0
    cam.update(fx=cam["fx"] / f, fy=cam["fy"] / f, cx=(cam["cx"] + 0.5) / f - 0.5,
               cy=(cam["cy"] + 0.5) / f - 0.5, width=int(cam["width"] / f),
               height=int(cam["height"] / f))
    m = cell.mix
    if m["span"] == m["frames"]:  # a sweep over the whole trajectory
        m.update(recording_calls=calls, span=60)
    else:
        m.update(recording_calls=24)
    m.update(frames=60, rooms=2, warm_calls=6, check_tracked=4, trace_after_s=0.5, trace_s=1.0)
    if cell.config["streams"] > 1:
        cell.config["streams"] = streams
        m.update(stream_start=min(m["stream_start"], 3), stream_phase=min(m["stream_phase"], 3))
    return cell


def run_small(cell, seconds: float, traced: bool = False, seed: int = 2 ** 31 + 9):
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    out, _ = bench.run_cell(cell, seed, seconds, traced, CPU, lambda: time.perf_counter() - t0)
    return out


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line(traced):
    cell = small("astra_session.hold")
    out = run_small(cell, 3.0, traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if traced else []) + ["check"]
    assert out["correct"] is True
    names = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(out["metrics"]) <= names
    if not traced:
        assert set(out["metrics"]) == names
    assert set(out["check"]) == set(cell.mix["checks"]) | {"compared"}
    assert out["device"]["count"] == 1


def test_the_reference_tracker_follows_the_port():
    from slam_rgbd_tpu_torch.core import camera as port_cam
    from slam_rgbd_tpu_torch.core.config import astra_default_config
    from slam_rgbd_tpu_torch.odometry.icp import track_frame

    cfg = astra_default_config()
    pcam = cfg.camera.scaled(5.0)
    cam = Camera(fx=pcam.fx, fy=pcam.fy, cx=pcam.cx, cy=pcam.cy, width=pcam.width,
                 height=pcam.height, depth_scale=pcam.depth_scale)
    poses = orbit(10)
    room = seeded_room(3, poses[:, :3, 3])
    frames = [render(poses[i], cam, room, "cpu") for i in (0, 1)]
    pyr = [port_cam.build_frame_pyramid(d, pcam, levels=3, rgb=c) for d, c in frames]
    eye = torch.eye(4)
    _, port, _ = track_frame(pyr[0], pyr[1], eye, eye, pcam, cfg.icp)
    ref = ref_track.track(frames[0], frames[1], eye, cam,
                          ref_track.icp_params(dataclasses.asdict(cfg.icp)))
    assert check.pose_gap_mm(port.numpy(), ref.numpy()) < 1e-3


def test_the_control_fails_where_the_program_passes():
    cell = small("astra_session.sweep")
    t0 = time.perf_counter()
    st = bench.prepare(cell, 77, CPU, False, lambda: time.perf_counter() - t0)
    rec = st["drv"].run(8.0)
    st["drv"].close()
    # the window holds whole rounds: every room's recording, each whole
    assert len(rec.recordings) % cell.mix["rooms"] == 0
    assert len(rec.calls) == len(rec.recordings) * cell.mix["recording_calls"]
    assert sorted(r.frames[0, 0] // 60 for r in rec.recordings[:2]) == [0, 1]
    checker = check.Checker(cell.config, st["depth"], st["rgb"], CPU, 4)
    prog = checker.numbers(rec, check.draw_sample(77))
    ctrl = checker.numbers(rec, check.draw_sample(77), control=True)
    for name in ("track_gap_mm", "kf_mismatch", "kf_point_gap_mm"):
        assert prog[name] <= cell.limits[name] < ctrl[name], name
    if prog["ba_gap_mm"] is not None:
        assert prog["ba_gap_mm"] <= cell.limits["ba_gap_mm"] < ctrl["ba_gap_mm"]


# ---- faults planted in the program ------------------------------------------


def _state_unchanged(mp):
    from slam_rgbd_tpu_torch.runtime import session

    real = session.track_frame

    def track_frame(prev_pyr, pyr, T_world, motion, cam, cfg):
        _, T_rel, res = real(prev_pyr, pyr, T_world, motion, cam, cfg)
        return T_world.clone(), torch.eye(4, device=T_world.device), res

    mp.setattr(session, "track_frame", track_frame)


def _pose_altered(mp):
    from slam_rgbd_tpu_torch.runtime import session

    real = session.track_frame

    def track_frame(*args):
        T, T_rel, res = real(*args)
        shift = torch.zeros_like(T)
        shift[0, 3] = 1e-3
        return T + shift, T_rel, res

    mp.setattr(session, "track_frame", track_frame)


def _association_altered(mp):
    # the session's insert reaches it through `parallel/dist.py`, which
    # imports it by name
    from slam_rgbd_tpu_torch.mapping import map as smap
    from slam_rgbd_tpu_torch.parallel import dist

    real = smap.association_ids

    def association_ids(*args):
        pid = real(*args).clone()
        hit = (pid >= 0).nonzero()
        if len(hit):
            pid[hit[0, 0]] += 1
        return pid

    mp.setattr(smap, "association_ids", association_ids)
    mp.setattr(dist, "association_ids", association_ids)


def _ba_altered(mp):
    from slam_rgbd_tpu_torch.backend import ba

    real = ba._windowed_single

    def windowed(*args, **kw):
        res = real(*args, **kw)
        poses = res.kf_pose.clone()
        poses[-1, 0, 3] += 1e-3
        return res._replace(kf_pose=poses)

    mp.setattr(ba, "_windowed_single", windowed)


def _half_the_batch_left_out(mp):
    from slam_rgbd_tpu_torch.runtime import batch_session

    real = batch_session.track_frame_batched

    def track(prev_pyr, pyr, T_prev, motion, cam, cfg):
        T, m, res = real(prev_pyr, pyr, T_prev, motion, cam, cfg)
        half = T.shape[0] // 2
        T, m = T.clone(), m.clone()
        T[half:] = T_prev[half:]
        m[half:] = torch.eye(4, device=T.device)
        return T, m, res

    mp.setattr(batch_session, "track_frame_batched", track)


@pytest.mark.parametrize("fault, cell_name", [
    (_state_unchanged, "astra_session.hold"),
    (_pose_altered, "astra_session.hold"),
    (_association_altered, "astra_session.sweep"),
    (_ba_altered, "astra_session.sweep"),
    (_half_the_batch_left_out, "tum_fleet.hold"),
])
def test_a_fault_in_the_timed_path_makes_correct_false(monkeypatch, fault, cell_name):
    cell = small(cell_name)
    fault(monkeypatch)
    out = run_small(cell, 8.0 if cell_name.endswith("sweep") else 3.0)
    assert out["correct"] is False, out["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["astra_session.sweep", "astra_session.hold"])
def test_the_control_fails_at_the_cells_own_size_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = spec.load_cell(name)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    st = bench.prepare(cell, 5, dev, False, lambda: time.perf_counter() - t0)
    rec = st["drv"].run(5.0)
    st["drv"].close()
    checker = check.Checker(cell.config, st["depth"], st["rgb"], dev, 4)
    prog = checker.numbers(rec, check.draw_sample(5, cell.config["streams"]))
    ctrl = checker.numbers(rec, check.draw_sample(5, cell.config["streams"]), control=True)
    correct, _ = check.verdict(prog, cell.limits, cell.mix["checks"])
    control_correct, _ = check.verdict(ctrl, cell.limits, cell.mix["checks"])
    assert correct and not control_correct
