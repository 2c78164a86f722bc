"""The port's backend pass (`backend.worker`) and its merge vs the JAX package,
and the `BackendWorker`'s queue semantics.

The scenes are those of `tests/test_map_backend.py:492-700`, built with numpy
from a seed: a map where every keyframe re-observes one point set (BA and
global BA), and a loop map whose query keyframe revisits the first one but
spawned duplicates of its landmarks (verification, fusion, the merge). Each
JAX reference is computed once per module and shared. Integer outputs
(fusion, the fused merge, decisions) are held exactly; LM and GN results to
the tolerances stated where they are asserted (sums in another order).

The queue tests replace `backend_pass` by a stub that waits on an event, so
each state of the worker is reached on purpose.
"""

import dataclasses
import logging
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.backend import worker as jworker
from slam_rgbd_tpu.backend.pose_graph import EdgeList as JEdgeList
from slam_rgbd_tpu.core import config as jc
from slam_rgbd_tpu.core import se3 as jse3
from slam_rgbd_tpu.mapping import map as jmap
from slam_rgbd_tpu.runtime import session as jsess
from slam_rgbd_tpu_torch import interop
from slam_rgbd_tpu_torch.backend import worker as tworker
from slam_rgbd_tpu_torch.core import config as tc
from slam_rgbd_tpu_torch.core import se3 as tse3
from slam_rgbd_tpu_torch.mapping import map as tmap
from slam_rgbd_tpu_torch.runtime import session as tsess
from test_torch_priority import below_the_jax_files  # noqa: F401 (autouse)

torch.set_num_threads(1)

K = 64  # keypoints a keyframe
FIELDS = [f.name for f in dataclasses.fields(tmap.MapState)]


def _cfg(pkg, **ba_kw):
    cam = pkg.CameraIntrinsics(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
    ba = dict(window=4, iters=4, global_ba_iters=8, global_ba_points=512,
              loop_min_interval=1)
    ba.update(ba_kw)
    return pkg.SLAMConfig(
        camera=cam, orb=pkg.ORBConfig(n_features=K, n_levels=2),
        keyframes=pkg.KeyframeConfig(max_keyframes=16, max_map_points=512),
        ba=pkg.BAConfig(**ba))


JCFG, TCFG = _cfg(jc), _cfg(tc)
CAM = TCFG.camera


def _exp(xi):
    return np.asarray(jse3.exp(jnp.asarray(np.asarray(xi, np.float32))))


def _world(rng):
    return np.stack([rng.uniform(-1.5, 1.5, K), rng.uniform(-1.0, 1.0, K),
                     rng.uniform(2.0, 4.0, K)], axis=1).astype(np.float32)


def _observe(T_wc, pts_w):
    T_cw = np.linalg.inv(T_wc)
    pc = pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = pc[:, 2]
    u = CAM.fx * pc[:, 0] / z + CAM.cx
    v = CAM.fy * pc[:, 1] / z + CAM.cy
    ok = (z > 0.3) & (u >= 0) & (u < CAM.width) & (v >= 0) & (v < CAM.height)
    return np.stack([u, v], 1).astype(np.float32), pc.astype(np.float32), ok


def _insert(m, T, ts, pts_w, signs, match):
    uv, pc, ok = _observe(T, pts_w)
    return jmap.insert_keyframe(m, jnp.asarray(T), float(ts), jnp.asarray(uv),
                                jnp.asarray(pc), jnp.asarray(ok), jnp.asarray(signs),
                                jnp.asarray(match))


def _chain(poses):
    """Odometry edges i -> i + 1 from the map's poses, as the inserts make
    them."""
    e, n = JEdgeList.empty(4 * JCFG.keyframes.max_keyframes), jnp.int32(0)
    for i in range(len(poses) - 1):
        e, n = e.add(n, i, i + 1, jnp.asarray(np.linalg.inv(poses[i]) @ poses[i + 1]))
    return e, n


@pytest.fixture(scope="module")
def rich():
    """Six keyframes re-observing one point set; keyframes 1-5 and the
    points start perturbed. -> (JAX map, edges, n_edges, true poses)."""
    rng = np.random.default_rng(0)
    m = jmap.empty_map(JCFG.keyframes, K)
    pts_w = _world(rng)
    signs = rng.choice(np.array([-1, 1], np.int8), size=(K, 256))
    T, poses, pid0 = np.eye(4, dtype=np.float32), [], None
    for i in range(6):
        poses.append(T.copy())
        ok = _observe(T, pts_w)[2]
        match = (np.full(K, -1, np.int32) if pid0 is None
                 else np.where(ok, pid0, -1).astype(np.int32))
        m = _insert(m, T, i, pts_w, signs, match)
        if pid0 is None:
            pid0 = np.asarray(m.point_id[0])
        T = T @ _exp([0.06, 0.01, 0.02, 0.008, 0.025, 0.004])
    kf = np.asarray(m.kf_pose).copy()
    for w in range(1, 6):
        kf[w] = kf[w] @ _exp(rng.normal(size=6) * np.array([0.02] * 3 + [0.008] * 3))
    pt = np.asarray(m.pt_xyz) + rng.normal(size=(m.capacity_pt, 3)).astype(np.float32) * 0.02
    m = m.replace(kf_pose=jnp.asarray(kf), pt_xyz=jnp.asarray(pt))
    e, n = _chain(kf)
    return m, e, n, np.stack(poses)


@pytest.fixture(scope="module")
def loop_map():
    """Candidate KF0, two far filler keyframes, then query KF3 revisiting
    KF0 with the same descriptors but duplicates of its landmarks (the
    association failed), inserted at a pose 4 cm / 1 deg off its truth (the
    drift a loop corrects). -> (JAX map, edges, n_edges, true T_rel)."""
    rng = np.random.default_rng(1)
    m = jmap.empty_map(JCFG.keyframes, K)
    pts_w = _world(rng)
    signs = rng.choice(np.array([-1, 1], np.int8), size=(K, 256))
    none = np.full(K, -1, np.int32)
    T0 = np.eye(4, dtype=np.float32)
    m = _insert(m, T0, 0.0, pts_w, signs, none)
    poses, T = [T0], T0.copy()
    for i in (1, 2):
        T = T @ _exp([0.5, 0, 0, 0, 0.6, 0])
        poses.append(T.copy())
        m = _insert(m, T, i, pts_w, rng.choice(np.array([-1, 1], np.int8), size=(K, 256)),
                    none)
    Tq = T0 @ _exp([0.02, 0, 0.01, 0, 0.008, 0])
    Tq_est = Tq @ _exp([0.03, -0.02, 0.015, 0.01, -0.012, 0.006])
    # the query observes from its true pose, but the map holds the estimate
    uv, pc, ok = _observe(Tq, pts_w)
    m = jmap.insert_keyframe(m, jnp.asarray(Tq_est), 3.0, jnp.asarray(uv), jnp.asarray(pc),
                             jnp.asarray(ok), jnp.asarray(signs), jnp.asarray(none))
    poses.append(Tq_est)
    e, n = _chain(poses)
    return m, e, n, (np.linalg.inv(T0) @ Tq).astype(np.float32)


def _port(m, e=None, n=None):
    """The JAX state on the port's side (CPU)."""
    tm = interop.map_from_numpy(m, "cpu")
    if e is None:
        return tm
    return tm, interop.edges_from_numpy(e, "cpu"), torch.tensor(int(n), dtype=torch.int32)


def _assert_poses(got, want, t_tol, r_tol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got[..., :3, 3] - want[..., :3, 3]).max() <= t_tol
    rel = np.linalg.inv(want) @ got
    rot = tse3.log(torch.tensor(rel.astype(np.float32))).numpy()[..., 3:]
    assert np.linalg.norm(rot, axis=-1).max() <= r_tol


# ---------------------------------------------------------------- parity

@pytest.fixture(scope="module")
def ba_pass(rich):
    m, e, n, _ = rich
    want = jworker.backend_pass(m, e, n, 5, JCFG, n_kf=6, allow_loop=False)
    got = tworker.backend_pass(*_port(m, e, n), 5, TCFG, n_kf=6, allow_loop=False)
    return want, got


def test_backend_pass_ba_only_matches_jax(rich, ba_pass):
    """Local BA over the window, older half fixed: poses to 1e-4 m and
    1e-4 rad, points to 1e-3 m, rmse to 1e-3 px, the adjusted set exactly."""
    m = rich[0]
    want, got = ba_pass
    assert not got.loop_closed and got.loop_edge is None and got.fuse_row is None
    _assert_poses(got.kf_pose, want.kf_pose, 1e-4, 1e-4)
    np.testing.assert_allclose(got.pt_xyz.numpy(), np.asarray(want.pt_xyz), atol=1e-3)
    assert np.array_equal(got.pt_adjusted.numpy(), np.asarray(want.pt_adjusted))
    assert abs(got.ba_rmse - want.ba_rmse) <= 1e-3
    # the solve did something: keyframes 2-5 moved, 0-1 are the fixed half
    moved = np.abs(np.asarray(want.kf_pose) - np.asarray(m.kf_pose)).max(axis=(1, 2))
    assert (moved[:2] == 0).all() and (moved[2:6] > 1e-4).all()
    assert got.pt_adjusted.sum() > 30 and got.snap_kf_idx == 5


def test_closing_pass_matches_jax(loop_map):
    """Candidate, verification, gate, pose graph, fusion and global BA: the
    decisions and the candidate equal, T_rel to 1e-3 (the 3D-3D solve
    draws other triples), the fused landmark count equal."""
    m, e, n, T_true = loop_map
    want = jworker.backend_pass(m, e, n, 3, JCFG, n_kf=4, allow_loop=True)
    got = tworker.backend_pass(*_port(m, e, n), 3, TCFG, n_kf=4, allow_loop=True)
    assert want.loop_closed and got.loop_closed
    assert got.loop_edge[:2] == (want.loop_edge[0], 3) == (0, 3)
    np.testing.assert_allclose(got.loop_edge[2].numpy(), np.asarray(want.loop_edge[2]),
                               atol=1e-3)
    np.testing.assert_allclose(got.loop_edge[2].numpy(), T_true, atol=1e-3)
    assert got.n_fused == want.n_fused > 20
    assert (got.global_ba_rmse < 0) == (want.global_ba_rmse < 0)
    # the loop correction moved the query keyframe back toward its truth
    _assert_poses(got.kf_pose[:4], want.kf_pose[:4], 2e-3, 2e-3)
    assert got.pt_adjusted.sum() == int(np.asarray(m.pt_valid).sum())


def test_loop_not_allowed_skips_verification(loop_map):
    """`allow_loop=False` (the cooldown): the candidate is found, nothing
    verified or closed, as in the reference."""
    m, e, n, _ = loop_map
    want = jworker.backend_pass(m, e, n, 3, JCFG, n_kf=4, allow_loop=False)
    got = tworker.backend_pass(*_port(m, e, n), 3, TCFG, n_kf=4, allow_loop=False)
    assert not got.loop_closed and not want.loop_closed
    _assert_poses(got.kf_pose, want.kf_pose, 1e-4, 1e-4)


@pytest.fixture(scope="module")
def fusion(loop_map):
    m, _, _, T_true = loop_map
    want = jworker._loop_fuse_program(m, jnp.int32(3), jnp.int32(0), jnp.asarray(T_true))
    got = tworker._loop_fuse_program(_port(m), 3, 0, torch.tensor(T_true))
    return want, got


@pytest.mark.parametrize("k, name", list(enumerate(
    ["point_id", "fuse_row", "ghost", "nobs_delta", "n_fused"])))
def test_loop_fusion_matches_jax_exactly(fusion, k, name):
    want, got = fusion
    w, g = np.asarray(want[k]), got[k].numpy()
    assert g.dtype == w.dtype or (g.dtype.kind == w.dtype.kind == "i"), name
    assert np.array_equal(g.astype(w.dtype), w), name


def test_loop_fusion_repoints_the_query(fusion, loop_map):
    m = loop_map[0]
    pid, row, ghost, delta, n_fused = fusion[1]
    n_fused = int(n_fused)
    assert n_fused > 20 and int(ghost.sum()) == n_fused
    before = np.asarray(m.point_id[3])
    cand = np.asarray(m.point_id[0])
    moved = row.numpy() != before
    assert np.array_equal(row.numpy()[moved], cand[moved])
    assert int(delta.sum()) == 0  # every gain is a loss elsewhere


def test_fuse_merge_matches_jax_exactly(fusion, loop_map):
    m = loop_map[0]
    (_, row, ghost, delta, nf), _ = fusion
    want = jsess._fuse_merge(m, jnp.int32(3), jnp.int32(0), row, ghost, delta, nf)
    got = tsess._fuse_merge(_port(m), 3, 0, *(torch.tensor(np.asarray(x))
                                              for x in (row, ghost, delta)), int(nf))
    out = interop.map_to_numpy(got)
    for name in FIELDS:
        assert np.array_equal(out[name], np.asarray(getattr(want, name))), name
    assert int(got.n_pt) == int(np.asarray(m.n_pt)) - int(nf)
    assert int(got.covis[3, 0]) >= int(nf) and int(got.covis[0, 3]) >= int(nf)


@pytest.mark.parametrize("reject", [False, True])
def test_global_ba_matches_jax(rich, reject):
    """The global solve on the rich map from perturbed poses: applied equal;
    poses to 1e-4, points to 1e-3, rmse to 1e-3 px. With a trust region of
    1e-6 m both reject and pass the input poses through untouched."""
    m, _, _, poses_gt = rich
    kw = dict(global_ba_max_move=1e-6) if reject else {}
    jcfg, tcfg = _cfg(jc, **kw), _cfg(tc, **kw)
    kf = np.asarray(m.kf_pose)
    want = jworker._global_ba_program(m.kf_pose, m.pt_xyz, m.point_id, m, jcfg)
    tm = _port(m)
    got = tworker._global_ba_program(tm.kf_pose, tm.pt_xyz, tm.point_id, tm, tcfg)
    applied = bool(got[4])
    assert applied == bool(want[4]) == (not reject)
    _assert_poses(got[0], want[0], 1e-4, 1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-3)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert abs(float(got[3]) - float(want[3])) <= 1e-3
    if reject:
        assert np.array_equal(got[0].numpy(), kf) and not bool(got[2].any())
    else:
        err0 = np.linalg.norm(kf[1:6, :3, 3] - poses_gt[1:6, :3, 3], axis=-1).mean()
        err1 = np.linalg.norm(got[0].numpy()[1:6, :3, 3] - poses_gt[1:6, :3, 3], axis=-1).mean()
        assert err1 < 0.25 * err0


def _sessions(m, n_kf):
    """A JAX and a port session (CPU) holding map `m` with `n_kf` keyframes,
    the live pose 3 cm past the newest keyframe."""
    js = jsess.SLAMSession(JCFG)
    ts = tsess.SLAMSession(TCFG, device="cpu")
    T_live = np.asarray(m.kf_pose[n_kf - 1]) @ _exp([0.03, 0, 0, 0, 0.01, 0])
    js.map, js._n_kf_host, js.last_kf_idx = m, n_kf, n_kf - 1
    js.T_world, js.last_kf_T = jnp.asarray(T_live), m.kf_pose[n_kf - 1]
    ts.map, ts._n_kf_host, ts.last_kf_idx = _port(m), n_kf, n_kf - 1
    ts.T_world, ts.last_kf_T = torch.tensor(T_live), ts.map.kf_pose[n_kf - 1].clone()
    return js, ts


def _port_result(r: jworker.BackendResult) -> tworker.BackendResult:
    return tworker.BackendResult(
        snap_kf_idx=r.snap_kf_idx, kf_pose=torch.tensor(np.asarray(r.kf_pose)),
        pt_xyz=torch.tensor(np.asarray(r.pt_xyz)),
        pt_adjusted=torch.tensor(np.asarray(r.pt_adjusted)), ba_rmse=r.ba_rmse)


@pytest.mark.parametrize("guard", [False, True])
def test_apply_backend_matches_jax(rich, ba_pass, guard, caplog):
    """The merge of the BA pass's result: map and live pose to 1e-5. With the
    snapshot keyframe moved 3 m (an implausible correction) both drop the
    merge and log an error."""
    m = rich[0]
    r = ba_pass[0]
    if guard:
        kf = np.asarray(r.kf_pose).copy()
        kf[5, 0, 3] += 3.0
        r = dataclasses.replace(r, kf_pose=jnp.asarray(kf))
    js, ts = _sessions(m, 6)
    T0 = ts.T_world.clone()
    js._apply_backend(r)
    with caplog.at_level(logging.ERROR, logger="slam_rgbd_tpu_torch.session"):
        ts._apply_backend(_port_result(r))
    np.testing.assert_allclose(ts.map.kf_pose.numpy(), np.asarray(js.map.kf_pose), atol=1e-5)
    np.testing.assert_allclose(ts.map.pt_xyz.numpy(), np.asarray(js.map.pt_xyz), atol=1e-5)
    np.testing.assert_allclose(ts.T_world.numpy(), np.asarray(js.T_world), atol=1e-5)
    np.testing.assert_allclose(ts.last_kf_T.numpy(), np.asarray(js.last_kf_T), atol=1e-5)
    if guard:
        assert torch.equal(ts.T_world, T0) and torch.equal(ts.map.kf_pose, _port(m).kf_pose)
        assert any("rejected" in rec.message for rec in caplog.records)
    else:
        assert (ts.T_world - T0).abs().max() > 1e-4  # the correction landed


def test_apply_backend_of_a_loop_matches_jax(loop_map):
    """A closing result merged: the loop edge, the fused map, the loop count
    and generation; poses to 1e-5 (both sides merge the same result)."""
    m, e, n, _ = loop_map
    r = jworker.backend_pass(m, e, n, 3, JCFG, n_kf=4, allow_loop=True)
    js, ts = _sessions(m, 4)
    js.edges, js.n_edges = e, n
    ts.edges, ts.n_edges = interop.edges_from_numpy(e, "cpu"), torch.tensor(int(n))
    tr = _port_result(r)
    i, j, T_rel, w = r.loop_edge
    tr = dataclasses.replace(
        tr, loop_edge=(i, j, torch.tensor(np.asarray(T_rel)), w), loop_closed=True,
        fuse_row=torch.tensor(np.asarray(r.fuse_row)),
        pt_invalidate=torch.tensor(np.asarray(r.pt_invalidate)),
        pt_nobs_delta=torch.tensor(np.asarray(r.pt_nobs_delta)), n_fused=r.n_fused)
    js._apply_backend(r)
    ts._apply_backend(tr)
    assert ts.state.loops == js.state.loops == 1 and ts._loop_gen == js._loop_gen == 1
    assert ts._last_loop_kf == js._last_loop_kf == 3
    out = interop.map_to_numpy(ts.map)
    for name in FIELDS:
        want = np.asarray(getattr(js.map, name))
        if want.dtype == np.float32:
            np.testing.assert_allclose(out[name], want, atol=1e-5, err_msg=name)
        else:
            assert np.array_equal(out[name], want), name
    assert int(ts.n_edges) == int(js.n_edges) == int(n) + 1
    np.testing.assert_allclose(ts.T_world.numpy(), np.asarray(js.T_world), atol=1e-5)


# ---------------------------------------------------------------- the queue

class _Gate:
    """A stand-in for `backend_pass`: each job waits for `release(kf)`;
    `fail` makes a job raise."""

    def __init__(self):
        self.events = {}
        self.started = []
        self.fail = set()

    def event(self, kf):
        return self.events.setdefault(kf, threading.Event())

    def release(self, kf):
        self.event(kf).set()

    def __call__(self, m, edges, n_edges, kf_idx, cfg, n_kf=-1, allow_loop=True, blk=None):
        self.started.append((kf_idx, allow_loop))
        assert self.event(kf_idx).wait(10), "never released"
        if kf_idx in self.fail:
            raise RuntimeError(f"pass of KF{kf_idx} broke")
        return tworker.BackendResult(snap_kf_idx=kf_idx, kf_pose=torch.eye(4),
                                     pt_xyz=torch.zeros(1, 3),
                                     pt_adjusted=torch.zeros(1, dtype=torch.bool))


@pytest.fixture()
def gate(monkeypatch):
    g = _Gate()
    monkeypatch.setattr(tworker, "backend_pass", g)
    yield g
    for ev in g.events.values():  # no pass stays blocked after a failure
        ev.set()


@pytest.fixture()
def worker():
    w = tworker.BackendWorker(TCFG, "cpu")
    yield w
    w.stop(timeout=10)


def _job(kf, generation=0):
    return tworker.BackendJob(map=None, edges=None, n_edges=None, kf_idx=kf, n_kf=kf + 1,
                              generation=generation)


def _wait(cond, timeout=10.0):
    ev = threading.Event()
    for _ in range(int(timeout / 0.01)):
        if cond():
            return True
        ev.wait(0.01)
    return False


def test_replace_with_newest_counts_skips(gate, worker):
    assert worker.submit(_job(1))  # starts at once
    assert _wait(lambda: gate.started == [(1, True)])
    assert not worker.submit(_job(2))  # waits
    assert not worker.submit(_job(3))  # displaces 2
    assert worker.skipped == 1 and worker.busy()
    gate.release(1)
    r = worker.flush(10)
    assert r.snap_kf_idx == 1 and r.generation == 0 and worker.completed == 1
    assert worker.busy()  # job 3 is waiting: a result is taken, not promoted
    worker.advance(0)
    gate.release(3)
    assert worker.flush(10).snap_kf_idx == 3
    assert [kf for kf, _ in gate.started] == [1, 3] and not worker.busy()
    assert worker.completed == 2 and worker.skipped == 1


def test_waiting_job_of_an_older_generation_is_dropped(gate, worker):
    worker.submit(_job(1, generation=0))
    assert _wait(lambda: len(gate.started) == 1)
    worker.submit(_job(2, generation=0))
    gate.release(1)
    worker.flush(10)
    worker.advance(min_generation=1)  # a loop merged in between
    assert worker.skipped == 1 and not worker.busy()
    assert [kf for kf, _ in gate.started] == [1]


def test_advance_reevaluates_the_loop_cooldown(gate, worker):
    worker.submit(_job(1))
    assert _wait(lambda: len(gate.started) == 1)
    worker.submit(_job(2))
    gate.release(1)
    worker.flush(10)
    gate.release(2)
    worker.advance(0, allow_loop=lambda kf: False)
    assert worker.flush(10).snap_kf_idx == 2
    assert gate.started == [(1, True), (2, False)]


def test_stale_result_is_dropped_at_the_merge():
    """A result whose snapshot predates the last loop merge changes nothing
    and counts a skip."""
    sess = tsess.SLAMSession(TCFG, async_backend=True, device="cpu")
    try:
        sess._loop_gen = 1
        before = interop.map_to_numpy(sess.map)
        T0 = sess.T_world.clone()
        r = tworker.BackendResult(
            snap_kf_idx=0, kf_pose=sess.map.kf_pose + 1.0, pt_xyz=sess.map.pt_xyz + 1.0,
            pt_adjusted=torch.ones_like(sess.map.pt_valid), generation=0)
        sess._apply_backend(r)
        after = interop.map_to_numpy(sess.map)
        assert all(np.array_equal(before[k], after[k]) for k in FIELDS)
        assert torch.equal(sess.T_world, T0) and sess.worker.skipped == 1
    finally:
        sess.close()


def test_flush_returns_the_in_flight_result(gate, worker):
    worker.submit(_job(4))
    assert _wait(lambda: len(gate.started) == 1)
    threading.Timer(0.2, gate.release, args=(4,)).start()
    r = worker.flush(10)
    assert r is not None and r.snap_kf_idx == 4 and not worker.busy()
    assert worker.poll() is None


def test_stop_joins_the_thread():
    w = tworker.BackendWorker(TCFG, "cpu")
    assert w._thread.is_alive()
    w.stop(timeout=10)
    assert not w._thread.is_alive()


def test_a_failing_pass_is_logged_and_the_worker_goes_on(gate, worker, caplog):
    gate.fail.add(1)
    with caplog.at_level(logging.ERROR, logger="slam_rgbd_tpu_torch.backend"):
        worker.submit(_job(1))
        gate.release(1)
        assert worker.flush(10) is None
    errors = [rec for rec in caplog.records if rec.levelno == logging.ERROR]
    assert errors and "backend pass failed" in errors[0].message and errors[0].exc_info
    assert worker.completed == 1 and not worker.busy()
    worker.submit(_job(2))
    gate.release(2)
    assert worker.flush(10).snap_kf_idx == 2 and worker.completed == 2


def test_a_job_snapshot_is_unchanged_by_a_later_insert():
    """`insert_keyframe` writes the live map's keyframe rows in place; the
    snapshot a threaded job owns does not see it."""
    rng = np.random.default_rng(2)
    m = tmap.empty_map(TCFG.keyframes, K, "cpu")
    pts_w = _world(rng)

    def insert(m, i):
        T = _exp([0.05 * i, 0, 0, 0, 0.02 * i, 0])
        uv, pc, ok = _observe(T, pts_w)
        signs = rng.choice(np.array([-1, 1], np.int8), size=(K, 256))
        return tmap.insert_keyframe(
            m, torch.tensor(T), float(i), torch.tensor(uv), torch.tensor(pc),
            torch.tensor(ok), torch.tensor(signs), torch.full((K,), -1, dtype=torch.int32))

    for i in range(3):
        m = insert(m, i)
    snap, ready = tworker.snapshot(m)
    assert ready is None  # a CPU map: no stream to order
    frozen = interop.map_to_numpy(snap)
    live = insert(m, 3)
    assert all(np.array_equal(frozen[k], v) for k, v in interop.map_to_numpy(snap).items())
    assert int(snap.n_kf) == 3 and int(live.n_kf) == 4
    assert not torch.equal(live.kp_signs[3], snap.kp_signs[3])
    assert live.kp_signs.data_ptr() != snap.kp_signs.data_ptr()


def test_a_threaded_sessions_job_owns_its_map():
    """The job an async session defers holds copies of the map's tensors."""
    sess = tsess.SLAMSession(TCFG, async_backend=True, device="cpu")
    try:
        sess._backend(0)
        job = sess._deferred_job
        for name in FIELDS:
            assert getattr(job.map, name).data_ptr() != getattr(sess.map, name).data_ptr()
            assert torch.equal(getattr(job.map, name), getattr(sess.map, name))
        assert job.ready is None and job.kf_idx == 0
    finally:
        sess.close()
