"""The output check of a backend pass that closed a loop, on a small loop
scene built with the port's own map on the CPU: the plain reference
(`reference/loop.py`) against the port's `backend_pass`, the control (the
reference in TF32) and planted faults failing, and the drivers keeping no
loop captures for the committed mixes.

    python -m pytest portbench/tests -q"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness import check, drive

LIMIT_MM = 0.05  # the order of the BA check's limit; the cells set their own
K = 64  # keypoints a keyframe


def _cfg():
    from slam_rgbd_tpu_torch.core import config as tc

    cam = tc.CameraIntrinsics(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
    return tc.SLAMConfig(
        camera=cam, orb=tc.ORBConfig(n_features=K, n_levels=2),
        keyframes=tc.KeyframeConfig(max_keyframes=16, max_map_points=512),
        ba=tc.BAConfig(window=4, iters=4, global_ba_iters=8, global_ba_points=512,
                       loop_min_interval=1))


def _exp(xi):
    from slam_rgbd_tpu_torch.core import se3

    return se3.exp(torch.tensor(np.asarray(xi, np.float32)))


def _observe(cam, T_wc, pts_w):
    T_cw = torch.linalg.inv(T_wc)
    pc = pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = pc[:, 2]
    u = cam.fx * pc[:, 0] / z + cam.cx
    v = cam.fy * pc[:, 1] / z + cam.cy
    ok = (z > 0.3) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    return torch.stack([u, v], 1), pc, ok


@pytest.fixture(scope="module")
def scene():
    """Candidate KF0, two far keyframes, then the query KF3 revisiting KF0
    with the same descriptors but duplicates of its landmarks (the
    association failed), inserted at a pose 4 cm / 1 deg off its truth: the
    loop scene of the port's worker tests, built with the port's own map.
    -> (cfg, map, edges, n_edges)."""
    from slam_rgbd_tpu_torch.backend import pose_graph as pg
    from slam_rgbd_tpu_torch.mapping import map as smap

    cfg = _cfg()
    rng = np.random.default_rng(1)
    pts_w = torch.tensor(np.stack([rng.uniform(-1.5, 1.5, K), rng.uniform(-1.0, 1.0, K),
                                   rng.uniform(2.0, 4.0, K)], axis=1).astype(np.float32))

    def signs():
        return torch.tensor(rng.choice(np.array([-1, 1], np.int8), size=(K, 256)))

    room = signs()
    none = torch.full((K,), -1, dtype=torch.int32)
    m = smap.empty_map(cfg.keyframes, K, "cpu")
    poses = []

    def insert(m, T_map, T_true, desc):
        uv, pc, ok = _observe(cfg.camera, T_true, pts_w)
        m = smap.insert_keyframe(m, T_map, float(len(poses)), uv, pc, ok, desc, none)
        poses.append(T_map)
        return m

    T = torch.eye(4)
    m = insert(m, T, T, room)
    for _ in (1, 2):
        T = T @ _exp([0.5, 0, 0, 0, 0.6, 0])
        m = insert(m, T, T, signs())
    Tq = _exp([0.02, 0, 0.01, 0, 0.008, 0])
    m = insert(m, Tq @ _exp([0.03, -0.02, 0.015, 0.01, -0.012, 0.006]), Tq, room)
    e = pg.EdgeList.empty(4 * cfg.keyframes.max_keyframes, "cpu")
    n = torch.zeros((), dtype=torch.int32)
    for i in range(len(poses) - 1):
        e, n = e.add(n, i, i + 1, torch.linalg.inv(poses[i]) @ poses[i + 1])
    return cfg, m, e, n


def _capture(scene, r):
    """What the single driver keeps of a closing pass on this job."""
    cfg, m, e, n = scene
    i, j, T_rel, _ = r.loop_edge
    return {"kf_idx": 3, "n_kf": 4, "snapshot": m,
            "edges": (e.i, e.j, e.T_meas, e.weight, e.valid), "n_edges": int(n),
            "result": {"kf_pose": r.kf_pose, "pt_xyz": r.pt_xyz, "pt_adjusted": r.pt_adjusted,
                       "loop_edge": (i, j, T_rel), "fuse_row": r.fuse_row,
                       "pt_invalidate": r.pt_invalidate, "pt_nobs_delta": r.pt_nobs_delta,
                       "n_fused": r.n_fused, "global_ba_rmse": r.global_ba_rmse}}


def _loop_gap(scene, control=False, fault=None, monkeypatch=None):
    """loop_gap_mm of the port's closing pass (with `fault` planted in it)
    through the checker, and the pass."""
    from slam_rgbd_tpu_torch.backend import worker

    cfg, m, e, n = scene
    if fault is not None:
        fault(monkeypatch)
    r = worker.backend_pass(m, e, n, 3, cfg, n_kf=4, allow_loop=True)
    assert r.loop_closed and r.loop_edge[:2] == (0, 3)
    rec = drive.Record(kind="single", streams=1)
    rec.recordings = [drive.Recording(frames=np.zeros((1, 1), int),
                                      loop_captures=[_capture(scene, r)])]
    checker = check.Checker({"slam": dataclasses.asdict(cfg)}, None, None, m.device, 0)
    gap, n_loops = checker.loops(rec, control)
    assert n_loops == 1
    return gap, r


CPU = torch.device("cpu")


def test_the_loop_reference_follows_the_port(scene):
    """Local BA, pose graph, the ride, fusion and the global BA of the
    reference agree with the port's pass to well inside the limit, and the
    pass did each: the pose graph moved the query, fusion re-pointed
    observations, the global BA was kept."""
    gap, r = _loop_gap(scene)
    assert gap <= LIMIT_MM
    assert r.n_fused > 20 and r.global_ba_rmse >= 0
    moved = check.pose_gap_mm(r.kf_pose[3].numpy(), scene[1].kf_pose[3].numpy())
    assert moved > 10.0


def test_the_control_fails_the_loop_gap(scene):
    gap, _ = _loop_gap(scene, control=True)
    assert gap > LIMIT_MM


def _pose_graph_altered(mp):
    from slam_rgbd_tpu_torch.backend import pose_graph

    real = pose_graph.optimize_pose_graph

    def optimize(*args, **kw):
        res = real(*args, **kw)
        poses = res.poses.clone()
        poses[2, 0, 3] += 1e-3
        return res._replace(poses=poses)

    mp.setattr(pose_graph, "optimize_pose_graph", optimize)


def _fusion_altered(mp):
    from slam_rgbd_tpu_torch.backend import worker

    real = worker._loop_fuse_program

    def fuse(*args, **kw):
        pid, row, ghost, delta, n = real(*args, **kw)
        row = row.clone()
        row[int((row >= 0).nonzero()[0, 0])] = -1
        return pid, row, ghost, delta, n

    mp.setattr(worker, "_loop_fuse_program", fuse)


def _global_ba_altered(mp):
    from slam_rgbd_tpu_torch.backend import worker

    real = worker._global_ba_program

    def global_ba(*args, **kw):
        kf, pts, solved, rmse, ok, move = real(*args, **kw)
        pts = pts.clone()
        pts[int(solved.nonzero()[0, 0]), 2] += 1e-3
        return kf, pts, solved, rmse, ok, move

    mp.setattr(worker, "_global_ba_program", global_ba)


@pytest.mark.parametrize("fault", [_pose_graph_altered, _fusion_altered, _global_ba_altered])
def test_an_altered_closing_pass_fails_the_loop_gap(scene, monkeypatch, fault):
    gap, _ = _loop_gap(scene, fault=fault, monkeypatch=monkeypatch)
    assert gap > LIMIT_MM


@pytest.mark.cuda
def test_the_loop_check_on_card(scene):
    """The same scene on the card: the port's pass with its kernels (the
    fusion's two `hamming_top2` launches) against the reference, and the
    control."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg, m, e, n = scene
    on_card = (cfg, dataclasses.replace(m, **{f.name: getattr(m, f.name).to(dev)
                                              for f in dataclasses.fields(m)}),
               dataclasses.replace(e, **{f.name: getattr(e, f.name).to(dev)
                                         for f in dataclasses.fields(e)}), n.to(dev))
    sound, r = _loop_gap(on_card)
    control, _ = _loop_gap(on_card, control=True)
    print(f"loop_gap_mm on card: sound {sound}, control {control}")
    assert sound <= LIMIT_MM < control
    assert r.n_fused > 20 and r.global_ba_rmse >= 0


def test_the_reference_does_not_touch_the_snapshot(scene):
    cfg, m, e, n = scene
    before = {f.name: getattr(m, f.name).clone() for f in dataclasses.fields(m)}
    _loop_gap(scene)
    assert all(torch.equal(before[k], getattr(m, k)) for k in before)
