"""The port on a CUDA card: the hand-written kernels (`gn_reduce` / `gn_step`,
`gn_reduce_batched` / `gn_step_batched`, `gated_match`, `hamming_top2`)
against their plain torch versions, and the sessions on the card against the
same sessions on the CPU.

Every test here needs a card and skips without one. The file imports no jax
(the machine with the card has none), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from slam_rgbd_tpu_torch import BatchSession, SLAMSession
from slam_rgbd_tpu_torch.core.config import (
    BAConfig, CameraIntrinsics, ICPConfig, KeyframeConfig, ORBConfig, SLAMConfig,
)
from slam_rgbd_tpu_torch.core import camera
from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence, render_frame
from slam_rgbd_tpu_torch.odometry import icp
from slam_rgbd_tpu_torch.ops import gn_reduce as tg
from slam_rgbd_tpu_torch.ops import hamming as th

CAM = CameraIntrinsics(fx=142.6, fy=142.6, cx=79.5, cy=59.5, width=160, height=120)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [2, 4, 8])
def test_kernel_matches_reference_on_card(cuda_device, radius):
    """Kernel vs plain version on one rendered frame pair at each radius.
    Tolerances of tests/test_icp_pallas.py:60-71 (sums in another order);
    inliers exact, since per-pixel arithmetic rounds alike; repeated
    launches give identical output (no atomics)."""
    seq = SyntheticSequence(2, CAM, device=cuda_device)
    pyrs = []
    for pose in seq.poses:
        depth, rgb = render_frame(pose, CAM, device=cuda_device)
        pyrs.append(camera.build_frame_pyramid(depth, CAM, levels=1, rgb=rgb))
    T = torch.from_numpy(np.linalg.inv(seq.poses[0]) @ seq.poses[1]).to(cuda_device)
    src = icp.level_planes(pyrs[1][0])[: tg.SRC_CHANNELS].contiguous()
    tgt = icp.level_planes(pyrs[0][0])
    _, up, vp, _ = icp._project_level(T, pyrs[1][0]["vertices"], CAM)
    mu = icp.flow_shift(up, vp, CAM.height, CAM.width)
    cfg = ICPConfig()
    before = tg.gn_reduce.launches
    k1 = tg.gn_reduce(T, mu, src, tgt, CAM, cfg, radius)
    k2 = tg.gn_reduce(T, mu, src, tgt, CAM, cfg, radius)
    ref = tg.gn_reduce_reference(T, mu, src, tgt, CAM, cfg, radius)
    torch.cuda.synchronize()
    assert tg.gn_reduce.launches == before + 2
    for a, b in zip(k1, k2):
        assert torch.equal(a, b)
    H1, g1, i1, s1 = (x.cpu().numpy() for x in k1)
    H0, g0, i0, s0 = (x.cpu().numpy() for x in ref)
    assert int(i1) == int(i0) > 1000
    h_scale = max(1.0, float(np.abs(H0).max()))
    np.testing.assert_allclose(H1 / h_scale, H0 / h_scale, atol=2e-6)
    g_scale = max(1.0, float(np.abs(g0).max()))
    np.testing.assert_allclose(g1 / g_scale, g0 / g_scale, atol=5e-5)
    np.testing.assert_allclose(float(s1), float(s0), rtol=1e-4)


@pytest.mark.cuda
def test_kernel_rejects_bad_input_on_card(cuda_device):
    src = torch.zeros((8, 12, 16), device=cuda_device)
    tgt = torch.zeros((10, 12, 16), device=cuda_device)
    T = torch.eye(4, device=cuda_device)
    mu = torch.zeros(2, device=cuda_device)
    with pytest.raises(ValueError):
        tg.gn_reduce(T.cpu(), mu, src, tgt, CAM, ICPConfig(), 2)
    with pytest.raises(ValueError):
        tg.gn_reduce(T, mu, src[:, :, ::2], tgt, CAM, ICPConfig(), 2)
    H, g, inl, sq = tg.gn_reduce(T, mu, src, tgt, CAM, ICPConfig(), 2)
    assert int(inl) == 0 and float(sq) == 0.0 and not H.any()


def _descriptor_sets(rng, k1, k2):
    """Random sign descriptors with what the selection must get right:
    queries that are noisy copies of columns, a column duplicated further
    on (a tie: the first index must win, and second == best), zero rows
    (empty map slots) that are masked, and an all-invalid query."""
    s2 = rng.choice(np.array([-1, 1], np.int8), size=(k2, 256))
    s1 = rng.choice(np.array([-1, 1], np.int8), size=(k1, 256))
    src = rng.integers(0, k2 // 2, size=k1)
    for q in range(0, k1, 2):  # every other query: a column with <= 20 flips
        s1[q] = s2[src[q]]
        s1[q, rng.choice(256, size=rng.integers(0, 21), replace=False)] *= -1
    s2[k2 // 2 + 5: k2 // 2 + 45] = s2[5:45]  # duplicated columns
    v1 = rng.random(k1) > 0.1
    v2 = rng.random(k2) > 0.2
    s2[-64:] = 0  # zero rows, always masked
    v2[-64:] = False
    v2[5:45] = True
    v2[k2 // 2 + 5: k2 // 2 + 45] = True
    return s1, v1, s2, v2, src


def _variant(rng, k1, k2, case):
    """`_descriptor_sets` with one of the cases the kernels must get right:
      random     - as made;
      full       - every column valid, no zero rows (a full map);
      last_tile  - only the last 32 columns valid (a sparse map whose points
                   all lie in the last column tile), half of them copied
                   into queries;
      masked_rows - the first 256 queries and every fifth invalid: two query
                   tiles with nothing valid give (1e9, 0, 1e9);
      ties       - queries 0-63 exact copies of columns 5-44, which recur
                   k2 / 2 further on: the best distance 0 in two column
                   tiles, the first index wins, second == best;
      zero_row   - a valid query of zeros and a valid column of zeros, each
                   at distance 128 from everything."""
    s1, v1, s2, v2, src = _descriptor_sets(rng, k1, k2)
    v1[3] = True
    signs = np.array([-1, 1], np.int8)
    if case == "full":
        s2[-64:] = rng.choice(signs, size=(64, 256))
        v2[:] = True
    elif case == "last_tile":
        s2[-32:] = rng.choice(signs, size=(32, 256))
        v2[:] = False
        v2[-32:] = True
        src[:64:2] = np.arange(k2 - 32, k2)
        s1[:64:2] = s2[-32:]
    elif case == "masked_rows":
        v1[:256] = False
        v1[::5] = False
    elif case == "ties":
        src[:64] = 5 + np.arange(64) % 40
        s1[:64] = s2[src[:64]]
        v1[:64] = True
    elif case == "zero_row":
        s1[7] = 0
        v1[7] = True
        s2[100] = 0
        v2[100] = True
    return s1, v1, s2, v2, src


_CASES = [(1024, 16384, "random"), (16384, 1024, "random"), (100, 333, "random"),
          (1024, 1024, "random"), (1024, 16384, "full"), (1024, 16384, "last_tile"),
          (1024, 16384, "masked_rows"), (1024, 16384, "ties"), (1024, 16384, "zero_row")]


@pytest.mark.cuda
@pytest.mark.parametrize("k1,k2,case", _CASES)
def test_hamming_top2_kernel_matches_reference_on_card(cuda_device, k1, k2, case):
    """All three outputs equal the plain version's exactly (distances are
    integers, ties go to the first index), twice alike."""
    rng = np.random.default_rng(k1 + k2)
    s1, v1, s2, v2, src = _variant(rng, k1, k2, case)
    args = [torch.tensor(x, device=cuda_device) for x in (s1, v1, s2, v2)]
    before = th.hamming_top2.launches
    out = th.hamming_top2(*args)
    again = th.hamming_top2(*args)
    ref = th.hamming_top2_reference(*args)
    torch.cuda.synchronize()
    assert th.hamming_top2.launches == before + 2
    for a, b, c in zip(out, again, ref):
        assert a.dtype == c.dtype and torch.equal(a, c) and torch.equal(a, b)
    best, second, idx = (x.cpu().numpy() for x in out)
    assert (best[~v1] == 1e9).all() and (idx[~v1] == 0).all() and (second[~v1] == 1e9).all()
    assert (best[v1] < 1e9).all() and (best <= second).all()
    if case == "ties":
        assert (best[:64] == 0).all() and (second[:64] == 0).all()
        np.testing.assert_array_equal(idx[:64], src[:64])
    elif case == "zero_row":
        assert best[7] == 128 and second[7] == 128 and idx[7] == np.flatnonzero(v2)[0]
    elif case == "last_tile":
        assert (idx[v1] >= k2 - 32).all() and (best[:64:2][v1[:64:2]] == 0).all()
    m = th.match_kernel(*args)
    assert int(m.valid.sum()) > 0 and not bool(m.valid[~args[1]].any())


@pytest.mark.cuda
@pytest.mark.parametrize("k1,k2,case", _CASES[:1] + _CASES[2:])
@pytest.mark.parametrize("merge_radius", [0.05, -1.0])
def test_gated_match_kernel_matches_reference_on_card(cuda_device, k1, k2, case,
                                                      merge_radius):
    """d1, i1, d2, i2 equal the plain version's exactly: the gate arithmetic
    rounds alike in both (no contraction), so no margin is needed."""
    rng = np.random.default_rng(k1 + k2)
    s1, v1, s2, v2, src = _variant(rng, k1, k2, case)
    p_xyz = rng.uniform(-2, 2, size=(k2, 3)).astype(np.float32)
    p_xyz[:, 2] = rng.uniform(0.5, 4.0, size=k2)
    p_xyz[k2 // 2 + 5: k2 // 2 + 45] = p_xyz[5:45]
    p_uv = np.stack([570.3 * p_xyz[:, 0] / p_xyz[:, 2] + 319.5,
                     570.3 * p_xyz[:, 1] / p_xyz[:, 2] + 239.5], 1).astype(np.float32)
    q_xyz = p_xyz[src] + rng.normal(0, 0.02, size=(k1, 3)).astype(np.float32)
    q_uv = p_uv[src] + rng.normal(0, 3.0, size=(k1, 2)).astype(np.float32)

    def meta(uv, xyz, ok):
        return np.concatenate([uv, xyz[:, 2:3], ok[:, None].astype(np.float32), xyz,
                               (xyz * xyz).sum(1, keepdims=True)], 1).astype(np.float32)

    args = [torch.tensor(x, device=cuda_device)
            for x in (s1, meta(q_uv, q_xyz, v1), s2, meta(p_uv, p_xyz, v2))]
    kw = dict(px_radius=6.0, z_rel_tol=0.08, merge_radius=merge_radius)
    before = th.gated_match.launches
    out = th.gated_match(*args, **kw)
    again = th.gated_match(*args, **kw)
    ref = th.gated_match_reference(*args, **kw)
    torch.cuda.synchronize()
    assert th.gated_match.launches == before + 2
    for a, b, c in zip(out, again, ref):
        assert a.dtype == c.dtype and torch.equal(a, c) and torch.equal(a, b)
    d1, i1, d2, i2 = (x.cpu().numpy() for x in out)
    assert (d1[~v1] == 1e9).all() and (i1[~v1] == 0).all()
    if case == "last_tile":
        hit = d1 < 1e9
        assert hit.sum() > 0 and (i1[hit] >= k2 - 32).all()
    else:
        assert (d1 < 64).sum() > k1 // 8  # the gates let real matches through
    if case == "ties":
        tied = d1[:64] == 0
        assert tied.sum() > 32 and (i1[:64][tied] == src[:64][tied]).all()
    if merge_radius < 0:
        assert (d2 == 1e9).all() and (i2 == 0).all()
    elif case != "last_tile":
        assert (d2 < 40).sum() > k1 // 16


@pytest.mark.cuda
def test_hamming_kernels_reject_bad_input_on_card(cuda_device):
    s = torch.ones((16, 256), dtype=torch.int8, device=cuda_device)
    v = torch.ones(16, dtype=torch.bool, device=cuda_device)
    meta = torch.zeros((16, 8), device=cuda_device)
    with pytest.raises(ValueError):
        th.hamming_top2(s, v, s.float(), v)
    with pytest.raises(ValueError):
        th.hamming_top2(s, v, s.cpu(), v.cpu())
    with pytest.raises(ValueError):
        th.hamming_top2(s, v[:8], s, v)
    with pytest.raises(ValueError):
        th.gated_match(s, meta[:, :7].contiguous(), s, meta)
    with pytest.raises(ValueError):
        th.gated_match(s[:, :128].contiguous(), meta, s, meta)


@pytest.mark.cuda
def test_session_on_card_matches_cpu(cuda_device):
    """Six frames of the sweep at the default three-level ICP, with the
    kernels on the card and with the plain path on the CPU. Each session's
    own launches: 10 `gn_reduce_batched` (the three coarse starts stacked)
    and 7 + 5 `gn_reduce` a tracked frame and one `gated_match` a keyframe
    insert that had a map on the card, none on the CPU; no frame
    lost, so no `hamming_top2`. Poses agree to 1e-4 (float32 sums in another
    order, compounded over five GN-tracked frames); both sessions insert the
    same keyframes, and their map sizes agree to 5% (a descriptor bit or a
    gate can flip under the devices' different float rounding)."""
    cfg = SLAMConfig(
        camera=CAM,
        keyframes=KeyframeConfig(kf_min_trans=0.03, max_keyframes=8,
                                 max_map_points=2048),
        orb=ORBConfig(n_features=256),
    )
    seq = SyntheticSequence(6, CAM, sweep=True, device=cuda_device)
    frames = list(seq)
    counters = (tg.gn_reduce_batched, tg.gn_reduce, th.gated_match, th.hamming_top2)
    out, sessions = {}, {}
    for dev in ("cpu", cuda_device):
        sess = SLAMSession(cfg, device=dev)
        before = [c.launches for c in counters]
        for f in frames:
            sess.process_frame(*f)
        ts, T = sess.poses()
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert T.shape == (6, 4, 4) and np.isfinite(T).all()
        assert sess.state.lost == 0
        assert sess.state.keyframes > 1
        if dev == "cpu":
            assert launched == [0, 0, 0, 0]
        else:
            tracked = len(frames) - 1
            assert launched == [10 * tracked, 12 * tracked, sess.state.keyframes - 1, 0]
        out[str(dev)] = T
        sessions[str(dev)] = sess
    np.testing.assert_allclose(out[str(cuda_device)], out["cpu"], atol=1e-4)
    a, b = sessions["cpu"], sessions[str(cuda_device)]
    assert a.state.keyframes == b.state.keyframes
    na, nb = a.map_point_count(), b.map_point_count()
    assert na > 0 and abs(na - nb) <= 0.05 * na


def _graph_config() -> SLAMConfig:
    """The small session of these tests, at the default runtime settings."""
    return SLAMConfig(
        camera=CAM,
        keyframes=KeyframeConfig(kf_min_trans=0.03, max_keyframes=16,
                                 max_map_points=2048),
        orb=ORBConfig(n_features=256),
    )


def _sweep_with_a_lost_frame(device, n: int, lost: int = 6) -> list:
    """n frames of the sweep on `device`, frame `lost` with its depth
    blanked outside a central window (it falls under the inlier gate)."""
    frames = [list(f) for f in SyntheticSequence(n, CAM, sweep=True, device=device)]
    depth = frames[lost][1]
    window = np.zeros_like(depth)
    window[30:90, 50:110] = depth[30:90, 50:110]
    frames[lost][1] = window
    return frames


@pytest.mark.cuda
def test_frame_graph_equals_the_eager_step_on_card(cuda_device):
    """30 frames of the sweep, one of them damaged so that it is lost and
    relocalized, keyframes inserted along the way: the session whose tracked
    frame is one CUDA graph replay against the same session with
    `cuda_graph=False`. Keyframes, lost and relocalized counts, every frame
    and keyframe pose bit for bit; one capture, a replay a tracked frame
    after it, and 12 `gn_reduce` + 10 `gn_reduce_batched` launches counted
    for every tracked frame, replays included."""
    cfg = _graph_config()
    frames = _sweep_with_a_lost_frame(cuda_device, 30)
    out = {}
    for graph in (False, True):
        sess = SLAMSession(cfg, device=cuda_device, cuda_graph=graph)
        deltas = []
        for f in frames:
            before = (tg.gn_reduce.launches, tg.gn_reduce_batched.launches)
            sess.process_frame(*f)
            deltas.append((tg.gn_reduce.launches - before[0],
                           tg.gn_reduce_batched.launches - before[1]))
        out[graph] = (sess.poses()[1], sess.keyframe_poses()[1], sess.state.keyframes,
                      sess.state.lost, sess.state.relocalized, deltas, sess._graph)
    eager, graph = out[False], out[True]
    assert eager[6] is None and graph[6].captures == 1
    assert graph[6].replays == len(frames) - 2
    assert graph[2] == eager[2] >= 3
    assert graph[3:5] == eager[3:5] and graph[4] >= 1
    assert np.array_equal(graph[0], eager[0]) and np.array_equal(graph[1], eager[1])
    for run in (eager, graph):
        assert run[5] == [(0, 0)] + [(12, 10)] * (len(frames) - 1)


@pytest.mark.cuda
def test_pending_frames_keep_their_frame_and_pose_across_replays_on_card(cuda_device,
                                                                         monkeypatch):
    """Host frames (numpy, through the pinned ring) into a graph session
    and an eager one, with keyframes along the way: each frame's decisions
    resolve at the next call, before that call's replay, at the default
    `max_decision_lag`; until then the pending entry keeps its own uploaded
    depth and rgb (the next frame is uploaded before it resolves) and its
    own pose (not the live pose's storage, which the next replay writes),
    equal to the eager session's entry; keyframes and poses are the eager
    session's."""
    frames = list(SyntheticSequence(12, CAM, sweep=True, device=cuda_device))
    real_resolve = SLAMSession._resolve_entry
    runs = {}
    for graph in (False, True):
        sess = SLAMSession(_graph_config(), device=cuda_device, cuda_graph=graph)
        resolved = []

        def watched(self, e):
            n = self._graph.replays if self._graph is not None else None
            resolved.append((e, e.depth_raw.cpu(), e.rgb.cpu(), e.T.clone(), n))
            return real_resolve(self, e)

        monkeypatch.setattr(SLAMSession, "_resolve_entry", watched)
        for f in frames:
            sess.process_frame(*f)
            assert sess._pending is not None or sess._frame_i == 1
        runs[graph] = (sess, resolved, sess.poses()[1])
    sess, resolved, poses = runs[True]
    assert sess.state.keyframes >= 3
    assert [r[0].frame_i for r in resolved] == list(range(1, len(frames)))
    for (e, depth, rgb, T, replays), eager in zip(resolved, runs[False][1]):
        _, d, c = frames[e.frame_i]
        assert torch.equal(depth, torch.from_numpy(d.astype(np.int32)))
        assert torch.equal(rgb, torch.from_numpy(c))
        assert torch.equal(T, eager[3]) and e.T.data_ptr() != sess.T_world.data_ptr()
        # frame 1 is captured, not replayed; frame i > 1 is replay i - 1
        assert replays == e.frame_i - 1
    assert runs[False][0].state.keyframes == sess.state.keyframes
    assert np.array_equal(poses, runs[False][2])


@pytest.mark.cuda
def test_capture_keeps_the_count_of_a_kernel_another_thread_launches_on_card(
        cuda_device, monkeypatch):
    """A thread launches `hamming_top2` on its own stream, as the backend
    worker does, while this thread captures the frame graph: the kernel's
    count grows by exactly the thread's launches (some of them made during
    the capture), and replays add none of it; K1 / K1b still count 12 / 10
    a tracked frame."""
    import threading

    from slam_rgbd_tpu_torch.runtime.frame_graph import FrameGraph

    rng = np.random.default_rng(0)
    signs = torch.from_numpy(rng.choice([-1, 1], size=(512, 256)).astype(np.int8)).to(
        cuda_device)
    valid = torch.ones(512, dtype=torch.bool, device=cuda_device)
    th.hamming_top2(signs, valid, signs, valid)  # builds
    torch.cuda.synchronize()
    capturing, stop = threading.Event(), threading.Event()
    launched, during = [0], [0]

    def launch():
        with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
            while not stop.is_set():
                th.hamming_top2(signs, valid, signs, valid)
                launched[0] += 1
                during[0] += capturing.is_set()
            torch.cuda.current_stream(cuda_device).synchronize()

    real_capture = FrameGraph._capture

    def watched_capture(self, *args, **kw):
        capturing.set()
        try:
            return real_capture(self, *args, **kw)
        finally:
            capturing.clear()

    monkeypatch.setattr(FrameGraph, "_capture", watched_capture)
    frames = list(SyntheticSequence(6, CAM, sweep=True, device=cuda_device))
    sess = SLAMSession(_graph_config(), device=cuda_device)
    before = (th.hamming_top2.launches, tg.gn_reduce.launches,
              tg.gn_reduce_batched.launches)
    thread = threading.Thread(target=launch)
    thread.start()
    try:
        for f in frames:
            sess.process_frame(*f)
        sess.flush_pipeline()
    finally:
        stop.set()
        thread.join()
    torch.cuda.synchronize()
    tracked = len(frames) - 1
    assert sess._graph.captures == 1 and during[0] > 0 and sess.state.lost == 0
    assert th.hamming_top2.launches - before[0] == launched[0]
    assert tg.gn_reduce.launches - before[1] == 12 * tracked
    assert tg.gn_reduce_batched.launches - before[2] == 10 * tracked
    assert set(sess._graph._per_replay) <= {tg.gn_reduce, tg.gn_reduce_batched}


@pytest.mark.cuda
def test_capture_while_the_backend_worker_runs_a_job_on_card(cuda_device, monkeypatch):
    """A threaded session: the bootstrap keyframe's backend job starts at
    the second call, whose steady frame is then captured while the job runs
    on the worker's stream (the pass is held a while); the capture and the
    pass both succeed, and the session tracks on."""
    import time

    from slam_rgbd_tpu_torch.backend import worker as tworker
    from slam_rgbd_tpu_torch.runtime.frame_graph import FrameGraph

    real_pass, real_capture = tworker.backend_pass, FrameGraph._capture
    busy_at_capture = []

    def held_pass(*args, **kw):
        res = real_pass(*args, **kw)
        time.sleep(0.5)
        return res

    def watched_capture(self, *args, **kw):
        busy_at_capture.append(sess.worker._job is not None)
        return real_capture(self, *args, **kw)

    monkeypatch.setattr(tworker, "backend_pass", held_pass)
    monkeypatch.setattr(FrameGraph, "_capture", watched_capture)
    sess = SLAMSession(_graph_config(), async_backend=True, device=cuda_device)
    try:
        for f in SyntheticSequence(12, CAM, sweep=True, device=cuda_device):
            sess.process_frame(*f)
        sess.sync_backend()
        completed = sess.worker.completed
        T = sess.poses()[1]
    finally:
        sess.close()
    assert busy_at_capture == [True] and sess._graph.captures == 1
    assert completed >= 1 and sess.state.lost == 0 and np.isfinite(T).all()


@pytest.mark.cuda
def test_graph_is_captured_again_after_the_ring_grows_on_card(cuda_device, monkeypatch):
    """A trajectory ring of 8 rows grows to 16 and 32 over 20 frames: each
    growth gives a new capture, and the poses are the eager session's bit
    for bit."""
    monkeypatch.setattr(SLAMSession, "traj_capacity", 8)
    cfg = _graph_config()
    frames = list(SyntheticSequence(20, CAM, sweep=True, device=cuda_device))
    poses = {}
    for graph in (False, True):
        sess = SLAMSession(cfg, device=cuda_device, cuda_graph=graph)
        for f in frames:
            sess.process_frame(*f)
        poses[graph] = sess.poses()[1]
        assert sess._traj_cap == 32
    assert sess._graph.captures == 3 and sess._graph.replays == len(frames) - 1 - 3
    assert np.array_equal(poses[True], poses[False])


@pytest.mark.cuda
def test_a_failed_capture_raises_on_card(cuda_device, monkeypatch):
    """A steady step that reads a value back to the host cannot be
    captured: the session raises, and does not fall back to the eager
    step."""
    from slam_rgbd_tpu_torch.runtime import session as tsession

    real = tsession._steady_step

    def reading_back(*args, **kw):
        out = real(*args, **kw)
        out[3].sum().item()  # a host read inside the frame
        return out

    monkeypatch.setattr(tsession, "_steady_step", reading_back)
    frames = list(SyntheticSequence(3, CAM, sweep=True, device=cuda_device))
    sess = SLAMSession(_graph_config(), device=cuda_device)
    sess.process_frame(*frames[0])
    with pytest.raises(RuntimeError, match="CUDA graph"):
        sess.process_frame(*frames[1])
    assert sess._graph.graph is None
    torch.cuda.synchronize()


def _feature_stage(device):
    """The Astra configuration's feature stage, eager, and three 640x480
    frames on `device`: the warm-up's textured plane, a rendered sweep frame,
    and a smooth frame with almost no corners."""
    import functools

    from slam_rgbd_tpu_torch.core.config import astra_default_config
    from slam_rgbd_tpu_torch.runtime import session as tsession

    cfg = astra_default_config()
    cam = cfg.camera
    yy, xx = np.meshgrid(np.arange(cam.height), np.arange(cam.width), indexing="ij")
    plane = ((1800.0 + 2.0 * xx + 1.5 * yy).astype(np.int32),
             np.broadcast_to((((xx // 8 + yy // 8) % 2) * 160 + 48).astype(np.uint8)[
                 ..., None], (cam.height, cam.width, 3)))
    _, d, c = SyntheticSequence(2, cam, sweep=True, device=device).frame(1)
    smooth = (np.full((cam.height, cam.width), 2000, np.int32),
              np.broadcast_to((64 + xx // 8).astype(np.uint8)[..., None],
                              (cam.height, cam.width, 3)))
    frames = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in f)
              for f in (plane, (d.astype(np.int32), c), smooth)]
    return functools.partial(tsession._features, orb=cfg.orb, cam=cam), frames


@pytest.mark.cuda
def test_feature_graph_equals_the_eager_stage_on_card(cuda_device):
    """The keyframe's feature stage at 640x480, ORB 1024 x 8, replayed from
    one capture on three frames (a textured plane, a rendered frame, a
    frame with almost no corners), twice each: every output (keypoints'
    uv, response, angle, level and mask, descriptors' words, signs and
    angle, points, mask) equals the eager stage's bit for bit."""
    from slam_rgbd_tpu_torch.runtime.frame_graph import FeatureGraph, _tensors

    features, frames = _feature_stage(cuda_device)
    graph = FeatureGraph(cuda_device, features)
    n_valid = []
    for f in frames + frames:
        got, want = graph.run(*f), features(*f)
        assert [type(x) for x in got] == [type(x) for x in want]
        for a, b in zip(_tensors(got), _tensors(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        n_valid.append(int(got[0].valid.sum()))
    assert graph.captures == 1 and graph.replays == 2 * len(frames) - 1
    assert got[1].signs.shape == (1024, 256)
    assert min(n_valid[:2]) > 100 and n_valid[2] < 10


@pytest.mark.cuda
def test_feature_graph_returns_clones_a_later_replay_leaves_alone_on_card(cuda_device):
    """What a replay returns is the caller's own: a second replay on another
    frame leaves every tensor of the first call's result as it was."""
    from slam_rgbd_tpu_torch.runtime.frame_graph import FeatureGraph, _tensors

    features, frames = _feature_stage(cuda_device)
    graph = FeatureGraph(cuda_device, features)
    graph.run(*frames[2])  # the capture
    kept = graph.run(*frames[0])
    before = [t.clone() for t in _tensors(kept)]
    other = graph.run(*frames[1])
    assert graph.replays == 2
    assert all(torch.equal(a, b) for a, b in zip(_tensors(kept), before))
    assert not torch.equal(kept[1].signs, other[1].signs)
    held = {t.data_ptr() for t in _tensors(graph._out)}
    assert held.isdisjoint(t.data_ptr() for t in _tensors(kept) + _tensors(other))


@pytest.mark.cuda
def test_feature_graph_session_equals_the_eager_session_on_card(cuda_device, monkeypatch):
    """The sweep with a lost and relocalized frame, after `warmup()`, in a
    session with `cuda_graph` and one without: the same keyframes, poses
    and map tensors bit for bit. The graph session's feature stage was
    captured once, in `warmup()`, and replayed for every insert and every
    relocalization after it."""
    import dataclasses

    cfg = _graph_config()
    frames = _sweep_with_a_lost_frame(cuda_device, 30)
    real_reloc = SLAMSession._relocalize
    tries = [0]

    def counted(self, *args, **kw):
        tries[0] += 1
        return real_reloc(self, *args, **kw)

    monkeypatch.setattr(SLAMSession, "_relocalize", counted)
    runs = {}
    for graph in (False, True):
        sess = SLAMSession(cfg, device=cuda_device, cuda_graph=graph)
        sess.warmup()
        fg = sess._feature_graph
        replays = None if fg is None else (fg.captures, fg.replays)
        tries[0] = 0
        for f in frames:
            sess.process_frame(*f)
        runs[graph] = (sess, sess.poses()[1], sess.keyframe_poses()[1], tries[0],
                       replays)
    (eager, *e), (sess, *g) = runs[False], runs[True]
    assert eager._feature_graph is None and g[3] == (1, 3)
    fg = sess._feature_graph
    assert fg.captures == 1 and g[2] == e[2] >= 1 and sess.state.relocalized >= 1
    assert fg.replays - g[3][1] == sess.state.keyframes + g[2]
    assert sess.state.keyframes == eager.state.keyframes >= 3
    assert np.array_equal(g[0], e[0]) and np.array_equal(g[1], e[1])
    for fld in dataclasses.fields(sess.map):
        a, b = getattr(sess.map, fld.name), getattr(eager.map, fld.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, fld.name


@pytest.mark.cuda
def test_feature_graph_capture_while_the_backend_worker_runs_a_job_on_card(
        cuda_device, monkeypatch):
    """A threaded session whose feature graph is dropped once the worker
    holds a job (its pass is held a while): the next insert captures the
    feature stage again while the pass runs on the worker's stream; the
    capture and the pass both succeed, and the session tracks on."""
    import time

    from slam_rgbd_tpu_torch.backend import worker as tworker
    from slam_rgbd_tpu_torch.runtime.frame_graph import FeatureGraph

    real_pass, real_capture = tworker.backend_pass, FeatureGraph._capture
    busy_at_capture = []

    def held_pass(*args, **kw):
        res = real_pass(*args, **kw)
        time.sleep(0.5)
        return res

    def watched_capture(self, *args, **kw):
        busy_at_capture.append(sess.worker._job is not None)
        return real_capture(self, *args, **kw)

    monkeypatch.setattr(tworker, "backend_pass", held_pass)
    monkeypatch.setattr(FeatureGraph, "_capture", watched_capture)
    sess = SLAMSession(_graph_config(), async_backend=True, device=cuda_device)
    fg, dropped = sess._feature_graph, False
    try:
        for f in SyntheticSequence(16, CAM, sweep=True, device=cuda_device):
            sess.process_frame(*f)
            if not dropped and sess.worker._job is not None:
                fg.graph, dropped = None, True
        sess.sync_backend()
        completed = sess.worker.completed
        T = sess.poses()[1]
    finally:
        sess.close()
    assert busy_at_capture == [False, True] and fg.captures == 2 and fg.replays >= 1
    assert completed >= 1 and sess.state.lost == 0 and np.isfinite(T).all()


@pytest.mark.cuda
def test_lost_frame_relocalizes_on_card(cuda_device):
    """The serving route of a relocalization on the card: a frame whose
    depth is blanked outside a central window, and the frame tracked against
    it, fall under the inlier gate; each is relocalized against the map with
    two `hamming_top2` launches a try, the logged and pending poses are
    corrected in place, and tracking comes back."""
    cfg = SLAMConfig(
        camera=CAM,
        keyframes=KeyframeConfig(kf_min_trans=0.03, max_keyframes=16,
                                 max_map_points=2048),
        orb=ORBConfig(n_features=256),
    )
    seq = SyntheticSequence(12, CAM, sweep=True, device=cuda_device)
    frames = [list(f) for f in seq]
    depth = frames[6][1]
    window = np.zeros_like(depth)
    window[30:90, 50:110] = depth[30:90, 50:110]
    frames[6][1] = window
    sess = SLAMSession(cfg, device=cuda_device)
    before = th.hamming_top2.launches
    for f in frames:
        sess.process_frame(*f)
    ts, T = sess.poses()
    launched = th.hamming_top2.launches - before
    st = sess.state
    assert st.lost >= 1 and st.relocalized >= 1
    assert launched % 2 == 0 and 2 * st.relocalized <= launched <= 2 * st.lost
    assert sess.stats[-1].tracking_ok
    assert np.isfinite(T).all()
    gt = np.linalg.inv(seq.poses[0]) @ seq.poses
    assert np.abs(T[:, :3, 3] - gt[:, :3, 3]).max() < 0.03


def _batched_problems(device, n_b, cam, levels=1):
    """n_b frame pairs of the sweep with different poses: (T (B, 4, 4), mu,
    src (B, 8, H, W), tgt (B, 10, H, W)) at the coarsest of `levels`."""
    seq = SyntheticSequence(2 * n_b, cam, sweep=True, device=device)
    k = levels - 1
    lcam = cam.scaled(2.0 ** k)
    Ts, mus, srcs, tgts = [], [], [], []
    for b in range(n_b):
        pyrs = []
        for pose in seq.poses[2 * b: 2 * b + 2]:
            depth, rgb = render_frame(pose, cam, device=device)
            pyrs.append(camera.build_frame_pyramid(depth, cam, levels=levels, rgb=rgb))
        T = torch.from_numpy(
            np.linalg.inv(seq.poses[2 * b]) @ seq.poses[2 * b + 1]).to(device)
        _, up, vp, _ = icp._project_level(T, pyrs[1][k]["vertices"], lcam)
        Ts.append(T)
        mus.append(icp.flow_shift(up, vp, lcam.height, lcam.width))
        srcs.append(icp.level_planes(pyrs[1][k])[: tg.SRC_CHANNELS])
        tgts.append(icp.level_planes(pyrs[0][k]))
    return (torch.stack(Ts), torch.stack(mus), torch.stack(srcs).contiguous(),
            torch.stack(tgts).contiguous(), lcam)


@pytest.mark.cuda
@pytest.mark.parametrize("n_b,radius", [(1, 4), (3, 2), (8, 8)])
def test_batched_kernel_matches_single_and_reference_on_card(cuda_device, n_b, radius):
    """One batched launch: every problem equals a single `gn_reduce` launch
    on its slice bit for bit, two launches are identical, and the whole
    agrees with the plain batched version (inliers exactly; sums at the
    tolerances of the single kernel's test)."""
    T, mu, src, tgt, lcam = _batched_problems(cuda_device, n_b, CAM)
    cfg = ICPConfig()
    before = tg.gn_reduce_batched.launches, tg.gn_reduce.launches
    out = tg.gn_reduce_batched(T, mu, src, tgt, lcam, cfg, radius)
    again = tg.gn_reduce_batched(T, mu, src, tgt, lcam, cfg, radius)
    assert tg.gn_reduce_batched.launches == before[0] + 2
    assert tg.gn_reduce.launches == before[1]
    singles = [tg.gn_reduce(T[b], mu[b], src[b], tgt[b], lcam, cfg, radius)
               for b in range(n_b)]
    ref = tg.gn_reduce_batched_reference(T, mu, src, tgt, lcam, cfg, radius)
    torch.cuda.synchronize()
    assert [tuple(x.shape) for x in out] == [(n_b, 6, 6), (n_b, 6), (n_b,), (n_b,)]
    assert out[2].dtype == torch.int32
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    for b, single in enumerate(singles):
        for a, c in zip(out, single):
            assert torch.equal(a[b], c), b
    assert torch.equal(out[2], ref[2]) and int(out[2].min()) > 1000
    assert len(set(out[2].tolist())) == n_b  # the problems really differ
    H1, g1, _, s1 = (x.cpu().numpy() for x in out)
    H0, g0, _, s0 = (x.cpu().numpy() for x in ref)
    for b in range(n_b):
        h_scale = max(1.0, float(np.abs(H0[b]).max()))
        np.testing.assert_allclose(H1[b] / h_scale, H0[b] / h_scale, atol=2e-6)
        g_scale = max(1.0, float(np.abs(g0[b]).max()))
        np.testing.assert_allclose(g1[b] / g_scale, g0[b] / g_scale, atol=5e-5)
    np.testing.assert_allclose(s1, s0, rtol=1e-4)


def _one_problem(device, radius=4):
    """(T, mu, src, tgt, cam) of one rendered frame pair at 160x120."""
    T, mu, src, tgt, lcam = _batched_problems(device, 1, CAM)
    return T[0], mu[0], src[0], tgt[0], lcam


@pytest.mark.cuda
def test_gn_step_matches_plain_versions_on_card(cuda_device):
    """`gn_step` is `gn_reduce` (the same bits) and, in the same launch, the
    pose update: T_next against `solve_update_written_out` on the kernel's
    own H and g to 1e-6 (the same scalar arithmetic; sin and cos may differ
    in the last bit), against `_apply_update` to 1e-5 (library Cholesky and
    matrix products round otherwise), and the whole against the plain
    `gn_step_reference`. An all-invalid source gives the identity step."""
    T, mu, src, tgt, lcam = _one_problem(cuda_device)
    cfg = ICPConfig()
    before = tg.gn_reduce.launches
    T1, H, g, inl, sq = tg.gn_step(T, mu, src, tgt, lcam, cfg, 4)
    again = tg.gn_step(T, mu, src, tgt, lcam, cfg, 4)
    reduced = tg.gn_reduce(T, mu, src, tgt, lcam, cfg, 4)
    assert tg.gn_reduce.launches == before + 3
    torch.cuda.synchronize()
    for a, b in zip((T1, H, g, inl, sq), again):
        assert torch.equal(a, b)
    for a, b in zip((H, g, inl, sq), reduced):
        assert torch.equal(a, b)
    assert inl.dtype == torch.int32 and int(inl) > 1000
    written = tg.solve_update_written_out(T, H, g, inl, cfg.damping)
    np.testing.assert_allclose(T1.cpu().numpy(), written.cpu().numpy(), atol=1e-6)
    applied = icp._apply_update(T, H, g, inl, cfg)
    np.testing.assert_allclose(T1.cpu().numpy(), applied.cpu().numpy(), atol=1e-5)
    assert float((T1 - T).abs().max()) > 1e-5  # the step moved the pose
    ref = tg.gn_step_reference(T, mu, src, tgt, lcam, cfg, 4)
    np.testing.assert_allclose(T1.cpu().numpy(), ref[0].cpu().numpy(), atol=1e-5)
    assert int(ref[3]) == int(inl)
    # no valid source pixel: no inliers, the identity step
    dead = src.clone()
    dead[6] = 0.0
    T0, H0, _, inl0, _ = tg.gn_step(T, mu, dead, tgt, lcam, cfg, 4)
    assert int(inl0) == 0 and not H0.any()
    np.testing.assert_allclose(T0.cpu().numpy(), T.cpu().numpy(), atol=1e-6)
    np.testing.assert_allclose(
        T0.cpu().numpy(),
        tg.solve_update_written_out(T, H0, g * 0, inl0, cfg.damping).cpu().numpy(),
        atol=1e-6)


@pytest.mark.cuda
def test_gn_step_batched_strides_and_bit_identity_on_card(cuda_device):
    """One batched `gn_step_batched` launch: problem b equals a single
    `gn_step` launch on its inputs bit for bit; a batch made by `expand`
    over one plane set, or a leading G = 1, gives what contiguous copies
    give; G = 2 sets under 6 problems are read as b // 3; and poses taken
    as views of an earlier launch's output (not contiguous across problems)
    are read in place."""
    T, mu, src, tgt, lcam = _batched_problems(cuda_device, 3, CAM)
    cfg = ICPConfig()
    before = tg.gn_reduce_batched.launches
    out = tg.gn_step_batched(T, mu, src, tgt, lcam, cfg, 4)
    assert tg.gn_reduce_batched.launches == before + 1
    assert [tuple(x.shape) for x in out] == [(3, 4, 4), (3, 6, 6), (3, 6), (3,), (3,)]
    for b in range(3):
        single = tg.gn_step(T[b], mu[b], src[b], tgt[b], lcam, cfg, 4)
        for a, c in zip(out, single):
            assert torch.equal(a[b], c), b
    ref = tg.gn_step_batched_reference(T, mu, src, tgt, lcam, cfg, 4)
    np.testing.assert_allclose(out[0].cpu().numpy(), ref[0].cpu().numpy(), atol=1e-5)
    assert torch.equal(out[3], ref[3])
    # three poses over the planes of problem 0
    copies = tg.gn_step_batched(T, mu, src[:1].repeat(3, 1, 1, 1),
                                tgt[:1].repeat(3, 1, 1, 1), lcam, cfg, 4)
    expanded = tg.gn_step_batched(T, mu, src[0].expand(3, -1, -1, -1),
                                  tgt[0].expand(3, -1, -1, -1), lcam, cfg, 4)
    one_set = tg.gn_step_batched(T, mu, src[:1], tgt[:1], lcam, cfg, 4)
    for a, b, c in zip(copies, expanded, one_set):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert len(set(copies[3].tolist())) == 3
    # the next iteration from the first one's poses, a strided view
    assert not out[0].is_contiguous()
    nxt = tg.gn_step_batched(out[0], mu, src, tgt, lcam, cfg, 4)
    nxt_c = tg.gn_step_batched(out[0].contiguous(), mu, src, tgt, lcam, cfg, 4)
    for a, b in zip(nxt, nxt_c):
        assert torch.equal(a, b)
    # two sets under six problems
    T6 = torch.cat([T, T.flip(0)])
    mu6 = torch.cat([mu, mu.flip(0)])
    grouped = tg.gn_step_batched(T6, mu6, src[:2], tgt[:2], lcam, cfg, 4)
    spelled = tg.gn_step_batched(T6, mu6, src[:2].repeat_interleave(3, 0),
                                 tgt[:2].repeat_interleave(3, 0), lcam, cfg, 4)
    for a, b in zip(grouped, spelled):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_at_a_width_no_multiple_of_four_on_card(cuda_device):
    """A level 126 wide, whose pixel count is no multiple of a block's 1024:
    the last block is ragged; results as the plain version's."""
    cam = CameraIntrinsics(fx=112.3, fy=112.3, cx=62.5, cy=47.5, width=126, height=96)
    T, mu, src, tgt, lcam = _batched_problems(cuda_device, 2, cam)
    cfg = ICPConfig()
    out = tg.gn_reduce_batched(T, mu, src, tgt, lcam, cfg, 4)
    ref = tg.gn_reduce_batched_reference(T, mu, src, tgt, lcam, cfg, 4)
    assert torch.equal(out[2], ref[2]) and int(out[2].min()) > 1000
    for b in range(2):
        h_scale = max(1.0, float(ref[0][b].abs().max()))
        np.testing.assert_allclose(out[0][b].cpu().numpy() / h_scale,
                                   ref[0][b].cpu().numpy() / h_scale, atol=2e-6)
        single = tg.gn_reduce(T[b], mu[b], src[b], tgt[b], lcam, cfg, 4)
        for a, c in zip(out, single):
            assert torch.equal(a[b], c)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gn_reduce", "gn_step", "gn_reduce_batched",
                                  "gn_step_batched", "gated_match", "hamming_top2"])
def test_a_call_is_one_launch_and_nothing_else_on_card(cuda_device, name):
    """A profiler trace of one call holds one device operation: the kernel
    (no copy, fill, pack or second kernel around it)."""
    from torch.profiler import ProfilerActivity, profile

    if name in ("gated_match", "hamming_top2"):
        rng = np.random.default_rng(0)
        s1, v1, s2, v2, _ = _descriptor_sets(rng, 1024, 16384)
        sets = [torch.tensor(x, device=cuda_device) for x in (s1, v1, s2, v2)]
        if name == "gated_match":
            meta = [torch.zeros((len(v), 8), device=cuda_device) for v in (v1, v2)]
            for m, v in zip(meta, sets[1::2]):
                m[:, 3] = v.float()
            sets = [sets[0], meta[0], sets[2], meta[1]]
        args, kernel = sets, name + "_kernel"
        fn = getattr(th, name)
    else:
        T, mu, src, tgt, lcam = _batched_problems(cuda_device, 2, CAM)
        if "batched" not in name:
            T, mu, src, tgt = T[0], mu[0], src[0], tgt[0]
        args, kernel = (T, mu, src, tgt, lcam, ICPConfig(), 4), "gn_kernel"
        fn = getattr(tg, name)
    fn(*args)  # builds, makes the workspace
    torch.cuda.synchronize()
    # A warm-up step first: CUPTI takes its activity buffer at the first
    # device record it has to store, and a trace stopped before that holds
    # no device event at all. The warm-up step's records stay out of the
    # trace, which is the active step's; the profiler's own step marker
    # (`ProfilerStep#`, an annotation on the device timeline, not an
    # operation) is not counted.
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule) as prof:
        for _ in range(2):
            fn(*args)
            torch.cuda.synchronize()
            prof.step()
    on_device = [(ev.key, ev.count) for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and not ev.key.startswith("ProfilerStep")]
    assert len(on_device) == 1 and on_device[0][1] == 1, on_device
    assert kernel in on_device[0][0]


@pytest.mark.cuda
def test_batched_kernel_rejects_bad_input_on_card(cuda_device):
    src = torch.zeros((2, 8, 12, 16), device=cuda_device)
    tgt = torch.zeros((2, 10, 12, 16), device=cuda_device)
    T = torch.eye(4, device=cuda_device).repeat(2, 1, 1)
    mu = torch.zeros((2, 2), device=cuda_device)
    with pytest.raises(ValueError):
        tg.gn_reduce_batched(T[0], mu, src, tgt, CAM, ICPConfig(), 2)
    with pytest.raises(ValueError):
        tg.gn_reduce_batched(T, mu, src, tgt[:1], CAM, ICPConfig(), 2)
    with pytest.raises(ValueError):
        tg.gn_reduce_batched(T, mu, src.cpu(), tgt, CAM, ICPConfig(), 2)
    H, g, inl, sq = tg.gn_reduce_batched(T, mu, src, tgt, CAM, ICPConfig(), 2)
    assert not inl.any() and not sq.any() and not H.any()


@pytest.mark.cuda
def test_batch_session_on_card_matches_cpu(cuda_device):
    """Two different sequences, ten frames, on the card and on the CPU: 22
    `gn_reduce_batched` launches a tracked step and no single `gn_reduce`
    launch on the card, none of either on the CPU; one `gated_match` launch
    an insert with a map. Poses agree to 1e-3: float32 sums in another order
    through nine tracked frames and, from the third keyframe on, a BA whose
    scatter-adds are atomics on the card."""
    cfg = SLAMConfig(
        camera=CAM, orb=ORBConfig(n_features=256, n_levels=4),
        keyframes=KeyframeConfig(max_keyframes=16, max_map_points=2048,
                                 kf_min_trans=0.03),
        ba=BAConfig(window=4, iters=3, max_points_per_window=512),
    )
    seqs = [SyntheticSequence(10, CAM, step_t=0.012 + 0.004 * b,
                              step_r=0.01 + 0.002 * b, seed=b, device=cuda_device)
            for b in range(2)]
    frames = []
    for i in range(10):
        fr = [s.frame(i) for s in seqs]
        frames.append((fr[0][0], np.stack([f[1] for f in fr]),
                       np.stack([f[2] for f in fr])))
    counters = (tg.gn_reduce_batched, tg.gn_reduce, th.gated_match)
    out = {}
    for dev in ("cpu", cuda_device):
        bs = BatchSession(cfg, 2, device=dev)
        before = [c.launches for c in counters]
        for f in frames:
            bs.process_frames(*f)
        launched = [c.launches - b for c, b in zip(counters, before)]
        _, T = bs.poses()
        assert T.shape == (2, 10, 4, 4) and np.isfinite(T).all()
        assert (bs.state.lost == 0).all() and (bs.keyframe_counts >= 3).all()
        if dev == "cpu":
            assert launched == [0, 0, 0]
        else:
            assert launched == [22 * 9, 0, int((bs.keyframe_counts - 1).sum())]
        out[str(dev)] = (T, bs.keyframe_counts, bs.map_point_counts())
    (T_cpu, kf_cpu, n_cpu), (T_gpu, kf_gpu, n_gpu) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(T_gpu, T_cpu, atol=1e-3)
    assert (kf_cpu == kf_gpu).all()
    assert (np.abs(n_cpu - n_gpu) <= 0.05 * n_cpu).all()
    assert np.abs(T_gpu[0, :, :3, 3] - T_gpu[1, :, :3, 3]).max() > 1e-3


@pytest.mark.cuda
def test_backend_sums_repeat_on_card(cuda_device):
    """The BA's and the pose graph's scatter sums have a fixed order on the
    card: the same inputs give the same bits twice, and the CPU result to
    1e-4 (poses) / 1e-3 (points)."""
    from slam_rgbd_tpu_torch.backend import ba, pose_graph
    from slam_rgbd_tpu_torch.core import se3

    rng = np.random.default_rng(0)
    W, n_pts = 4, 300
    pts = np.stack([rng.uniform(-1.5, 1.5, n_pts), rng.uniform(-1, 1, n_pts),
                    rng.uniform(2, 4, n_pts)], 1).astype(np.float32)
    step = se3.exp(torch.tensor([0.08, 0.01, 0.02, 0.01, 0.03, 0.005]))
    poses = [torch.eye(4)]
    for _ in range(W - 1):
        poses.append(poses[-1] @ step)
    poses = torch.stack(poses)
    T_cw = se3.inverse(poses)
    pc = torch.tensor(pts) @ T_cw[:, :3, :3].transpose(-1, -2) + T_cw[:, None, :3, 3]
    uv = torch.stack([CAM.fx * pc[..., 0] / pc[..., 2] + CAM.cx,
                      CAM.fy * pc[..., 1] / pc[..., 2] + CAM.cy], -1)
    ok = (uv[..., 0] >= 0) & (uv[..., 0] < CAM.width) & (uv[..., 1] >= 0) & (uv[..., 1] < CAM.height)
    # every point observed twice by each camera: duplicate indices in the sums
    pid = torch.arange(n_pts, dtype=torch.int32).repeat(W, 2)
    noisy = poses @ se3.exp(torch.tensor(rng.normal(size=(W, 6)).astype(np.float32)) * 0.01)
    noisy[0] = poses[0]
    args = (noisy, torch.ones(W, dtype=torch.bool),
            torch.tensor(pts + rng.normal(size=pts.shape).astype(np.float32) * 0.02),
            uv.repeat(1, 2, 1), pc[..., 2].repeat(1, 2), pid, ok.repeat(1, 2))
    on_card = [a.to(cuda_device) for a in args]
    cfg = BAConfig(iters=5, max_points_per_window=256)
    a = ba.windowed_local_ba(*on_card, CAM, cfg)
    b = ba.windowed_local_ba(*on_card, CAM, cfg)
    cpu = ba.windowed_local_ba(*args, CAM, cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a.n_dropped) == int(cpu.n_dropped) > 0 and int(a.n_obs) == int(cpu.n_obs) > 500
    np.testing.assert_allclose(a.kf_pose.cpu().numpy(), cpu.kf_pose.numpy(), atol=1e-4)
    np.testing.assert_allclose(a.pt_xyz.cpu().numpy(), cpu.pt_xyz.numpy(), atol=1e-3)

    edges, n = pose_graph.EdgeList.empty(16, cuda_device), torch.zeros(
        (), dtype=torch.int32, device=cuda_device)
    for i in range(W - 1):
        edges, n = edges.add(n, i, i + 1, step.to(cuda_device), 1.0)
    edges, n = edges.add(n, 0, W - 1, (se3.inverse(poses[0]) @ poses[-1]).to(cuda_device), 5.0)
    valid = torch.ones(W, dtype=torch.bool, device=cuda_device)
    p1 = pose_graph.optimize_pose_graph(on_card[0], valid, edges, iters=4)
    p2 = pose_graph.optimize_pose_graph(on_card[0], valid, edges, iters=4)
    assert torch.equal(p1.poses, p2.poses) and float(p1.rmse) < 1e-3
    np.testing.assert_allclose(p1.poses.cpu().numpy(), poses.numpy(), atol=2e-3)


def _loop_map_on(device):
    """The loop scene of `tests/test_torch_worker.py` built with the port's
    own insert: candidate KF0, two far fillers, query KF3 revisiting KF0 with
    duplicates of its landmarks, held at a pose 4 cm off its truth.
    -> (map, edges, n_edges, config)."""
    from slam_rgbd_tpu_torch.backend.pose_graph import EdgeList
    from slam_rgbd_tpu_torch.core import se3
    from slam_rgbd_tpu_torch.mapping import map as tmap

    K = 64
    cfg = SLAMConfig(camera=CAM, orb=ORBConfig(n_features=K, n_levels=2),
                     keyframes=KeyframeConfig(max_keyframes=16, max_map_points=512),
                     ba=BAConfig(window=4, iters=4, global_ba_iters=8,
                                 global_ba_points=512, loop_min_interval=1))
    rng = np.random.default_rng(1)
    pts_w = np.stack([rng.uniform(-1.5, 1.5, K), rng.uniform(-1.0, 1.0, K),
                      rng.uniform(2.0, 4.0, K)], axis=1).astype(np.float32)
    signs = rng.choice(np.array([-1, 1], np.int8), size=(K, 256))

    def exp(xi):
        return se3.exp(torch.tensor(xi, dtype=torch.float32)).numpy()

    def observe(T):
        T_cw = np.linalg.inv(T)
        pc = (pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]).astype(np.float32)
        u = CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx
        v = CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy
        ok = (pc[:, 2] > 0.3) & (u >= 0) & (u < CAM.width) & (v >= 0) & (v < CAM.height)
        return np.stack([u, v], 1).astype(np.float32), pc, ok

    m = tmap.empty_map(cfg.keyframes, K, device)
    none = torch.full((K,), -1, dtype=torch.int32, device=device)
    T0 = np.eye(4, dtype=np.float32)
    Tq = T0 @ exp([0.02, 0, 0.01, 0, 0.008, 0])
    poses, views = [T0], [(T0, signs)]
    T = T0
    for _ in (1, 2):
        T = T @ exp([0.5, 0, 0, 0, 0.6, 0])
        poses.append(T)
        views.append((T, rng.choice(np.array([-1, 1], np.int8), size=(K, 256))))
    views.append((Tq, signs))
    poses.append(Tq @ exp([0.03, -0.02, 0.015, 0.01, -0.012, 0.006]))
    for i, ((T_obs, s), T_map) in enumerate(zip(views, poses)):
        uv, pc, ok = observe(T_obs)
        m = tmap.insert_keyframe(
            m, torch.tensor(T_map, device=device), float(i), torch.tensor(uv, device=device),
            torch.tensor(pc, device=device), torch.tensor(ok, device=device),
            torch.tensor(s, device=device), none)
    e = EdgeList.empty(64, device)
    n = torch.zeros((), dtype=torch.int32, device=device)
    for i in range(3):
        e, n = e.add(n, i, i + 1,
                     torch.tensor(np.linalg.inv(poses[i]) @ poses[i + 1], device=device))
    return m, e, n, cfg


@pytest.mark.cuda
def test_threaded_pass_runs_on_its_stream_and_equals_inline_on_card(cuda_device, monkeypatch):
    """The same closing job inline (the default stream) and on a
    `BackendWorker`: the worker's `hamming_top2` launches (verification and
    fusion, two each) are given the worker's own stream, and its result
    equals the inline one: decisions exactly, poses and points to 1e-5."""
    from slam_rgbd_tpu_torch.backend import worker as tworker

    m, e, n, cfg = _loop_map_on(cuda_device)
    streams = []
    real = th._scratch

    def recording(k1, k2, dev):  # the stream handle each launch is given
        out = real(k1, k2, dev)
        streams.append(out[2])
        return out

    monkeypatch.setattr(th, "_scratch", recording)
    inline = tworker.backend_pass(m, e, n, 3, cfg, n_kf=4)
    torch.cuda.synchronize()
    main_stream = torch.cuda.current_stream(cuda_device).cuda_stream
    assert inline.loop_closed and streams == [main_stream] * 4
    streams.clear()
    w = tworker.BackendWorker(cfg, cuda_device)
    try:
        snap, ready = tworker.snapshot(m)
        assert ready is not None
        w.submit(tworker.BackendJob(map=snap, edges=e, n_edges=n, kf_idx=3, n_kf=4,
                                    ready=ready))
        r = w.flush(120)
    finally:
        w.stop()
    assert r is not None and r.loop_closed
    assert streams == [w._stream.cuda_stream] * 4 and w._stream.cuda_stream != main_stream
    assert r.loop_edge[:2] == inline.loop_edge[:2] and r.n_fused == inline.n_fused > 20
    assert torch.equal(r.pt_adjusted, inline.pt_adjusted)
    assert torch.equal(r.fuse_row, inline.fuse_row)
    torch.testing.assert_close(r.kf_pose, inline.kf_pose, atol=1e-5, rtol=0)
    torch.testing.assert_close(r.pt_xyz, inline.pt_xyz, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_tf32_stays_off_inside_a_worker_pass_on_card(cuda_device, monkeypatch):
    """A threaded session on the card: every backend pass runs on the
    worker's stream with TF32 off for matrix products and cuDNN."""
    from slam_rgbd_tpu_torch.backend import worker as tworker

    seen = []
    real = tworker._backend_step

    def recording(*args, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.cuda.current_stream(cuda_device).cuda_stream))
        return real(*args, **kw)

    monkeypatch.setattr(tworker, "_backend_step", recording)
    cfg = SLAMConfig(camera=CAM, orb=ORBConfig(n_features=256),
                     keyframes=KeyframeConfig(kf_min_trans=0.03, max_keyframes=8,
                                              max_map_points=2048))
    sess = SLAMSession(cfg, async_backend=True, device=cuda_device)
    try:
        for f in SyntheticSequence(12, CAM, sweep=True, device=cuda_device):
            sess.process_frame(*f)
        sess.sync_backend()
        stream = sess.worker._stream.cuda_stream
        assert sess.worker.completed >= 2 and np.isfinite(sess.poses()[1]).all()
    finally:
        sess.close()
    assert seen and all(s == (False, False, stream) for s in seen)


@pytest.mark.cuda
def test_host_upload_does_not_wait_for_the_stream_on_card(cuda_device):
    """A host frame goes up through the pinned ring: the call returns while a
    spin kernel still holds the stream, and once the stream has run, the
    result equals the plain upload bit for bit, through more frames than
    the ring has slots (each slot reused behind its event)."""
    from slam_rgbd_tpu_torch.runtime.staging import PinnedStaging, upload_plain

    sess = SLAMSession(SLAMConfig(camera=CAM), device=cuda_device)
    assert isinstance(sess._staging, PinnedStaging)
    rng = np.random.default_rng(0)
    frames = [(rng.integers(0, 65536, (120, 160), dtype=np.uint16),
               rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
              for _ in range(2 * sess._staging.n_slots + 1)]
    stream = torch.cuda.current_stream(cuda_device)
    # the first frame of a shape allocates its ring of pinned buffers
    outs = [(sess._upload(frames[0][0]), sess._upload(frames[0][1]))]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))  # ~0.1 s of device time
    depth_t, rgb_t = sess._upload(frames[1][0]), sess._upload(frames[1][1])
    still_busy = not stream.query()
    torch.cuda.synchronize()
    assert still_busy, "the upload waited for the stream"
    assert depth_t.dtype == torch.int32 and rgb_t.dtype == torch.uint8
    outs += [(depth_t, rgb_t)] + [(sess._upload(d), sess._upload(c)) for d, c in frames[2:]]
    torch.cuda.synchronize()
    for (d, c), (dt, ct) in zip(frames, outs):
        assert torch.equal(dt, upload_plain(d, cuda_device))
        assert torch.equal(ct, upload_plain(c, cuda_device))
    # device tensors keep their path
    assert sess._upload(depth_t) is depth_t


@pytest.mark.cuda
def test_threaded_runner_from_host_frames_on_card(cuda_device):
    """`PipelineRunner` on the card, threaded, fed host frames: the session
    built on this thread and driven from the consumer thread tracks them as
    the same session driven inline does."""
    from slam_rgbd_tpu_torch.runtime.runner import PipelineRunner

    from slam_rgbd_tpu_torch.core.config import RuntimeConfig, StreamConfig

    # room in the queue for every frame (nothing dropped), and each frame's
    # decisions resolved at the next call (the same keyframes both ways)
    cfg = SLAMConfig(camera=CAM, icp=ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2)),
                     orb=ORBConfig(n_features=256),
                     keyframes=KeyframeConfig(max_keyframes=16, max_map_points=2048),
                     stream=StreamConfig(queue_capacity=12, queue_drop_to=12),
                     runtime=RuntimeConfig(max_decision_lag=1))
    frames = list(SyntheticSequence(12, CAM, device=cuda_device))
    runner = PipelineRunner(cfg, iter(frames), async_backend=False, device=cuda_device)
    sess = runner.run(threads=True)
    inline = SLAMSession(cfg, device=cuda_device)
    for f in frames:
        inline.process_frame(*f)
    _, est = sess.poses()
    _, want = inline.poses()
    assert sess.state.frames == 12 and runner.queue.dropped == 0
    assert runner.watchdog.stalls == 0
    np.testing.assert_array_equal(est, want)


@pytest.fixture()
def nccl_mesh(cuda_device, tmp_path):
    """This process as a process group of one over NCCL (a store in a file),
    and its (1, 1) mesh; the group is taken down after the test."""
    from slam_rgbd_tpu_torch.core.config import MeshConfig
    from slam_rgbd_tpu_torch.parallel import mesh as pmesh

    pmesh.initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, device="cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        yield pmesh.make_mesh(MeshConfig(), "cuda")
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["local_ba", "batch_track", "map_association",
                                     "pose_graph", "hamming_match"])
def test_sharded_program_on_one_nccl_rank_on_card(nccl_mesh, cuda_device, program):
    """Each program of `parallel.dist` on a (1, 1) mesh over NCCL against
    the unsharded port on the card, with the kernel launches the sharded
    call makes: BA and pose graph within the tolerances of
    tests/test_parallel.py (poses 5e-5 / points 5e-4; poses 1e-5) and equal
    counts, the tracker and the Hamming programs exact."""
    import test_torch_parallel as tp

    from slam_rgbd_tpu_torch.backend import ba as tba
    from slam_rgbd_tpu_torch.backend import pose_graph as tpg
    from slam_rgbd_tpu_torch.core.config import BAConfig as BA
    from slam_rgbd_tpu_torch.mapping import map as tmap
    from slam_rgbd_tpu_torch.parallel import dist as tdist

    dev, mesh = cuda_device, nccl_mesh
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    counters = (tg.gn_reduce_batched, tg.gn_reduce, th.gated_match, th.hamming_top2)
    before = [c.launches for c in counters]

    def launched():
        torch.cuda.synchronize()
        return [c.launches - b for c, b in zip(counters, before)]

    if program == "local_ba":
        x = tp._ba_problem(rng)
        args = [t(x[k]) for k in ("ba_poses", "ba_pts", "ba_uv", "ba_z", "ba_pid", "ba_ok")]
        valid = torch.ones(4, dtype=torch.bool, device=dev)
        got = tdist.sharded_local_ba(mesh, args[0], valid, *args[1:], tp.CAM, BA(iters=4))
        want = tba.local_ba(args[0], valid, *args[1:], tp.CAM, BA(iters=4))
        torch.testing.assert_close(got.kf_pose, want.kf_pose, atol=5e-5, rtol=0)
        torch.testing.assert_close(got.pt_xyz, want.pt_xyz, atol=5e-4, rtol=0)
        assert int(got.n_obs) == int(want.n_obs) > 0
    elif program == "pose_graph":
        x = tp._graph()
        edges = tpg.EdgeList(**{f: t(x[f"pg_{f}"]) for f in tp.EDGE_FIELDS})
        valid = torch.ones(12, dtype=torch.bool, device=dev)
        got = tdist.sharded_pose_graph(mesh, t(x["pg_poses"]), valid,
                                       tdist.edge_block(edges, mesh), iters=8)
        want = tpg.optimize_pose_graph(t(x["pg_poses"]), valid, edges, iters=8)
        torch.testing.assert_close(got.poses, want.poses, atol=1e-5, rtol=0)
        assert int(got.n_edges) == int(want.n_edges) == 12
    elif program == "batch_track":
        seq = SyntheticSequence(5, CAM, device=dev)
        frames = [render_frame(p, CAM, device=dev) for p in seq.poses]
        pyr = lambda ids: camera.build_frame_pyramid(
            torch.stack([frames[i][0] for i in ids]), CAM, levels=3,
            rgb=torch.stack([frames[i][1] for i in ids]))
        src, tgt = pyr([1, 2, 3, 4]), pyr([0, 1, 2, 3])
        T0 = torch.eye(4, device=dev).repeat(4, 1, 1)
        got = tdist.batch_track(mesh, src, tgt, T0, CAM, ICPConfig())
        assert launched() == [22, 0, 0, 0]
        want = icp.icp_align_batched(src, tgt, T0, CAM, ICPConfig())
        for a, b in zip(got, (want.T, want.inliers, want.rmse, want.valid_fraction)):
            assert torch.equal(a, b)
    elif program == "map_association":
        x = tp._map_scene(rng)
        q = [t(x[k]) for k in ("mp_signs_q", "mp_ok", "mp_uv", "mp_z")]
        pts = [t(x[k]) for k in ("mp_xyz", "mp_signs", "mp_valid")]
        eye = torch.eye(4, device=dev)
        for kp_pts in (t(x["mp_pts"]), None):
            got = tdist.sharded_map_association(mesh, *q, eye, *pts, tp.CAM,
                                                kp_pts=kp_pts, merge_radius=0.08)
            cand = tmap.association_candidates(*pts, *q, eye, tp.CAM, 6.0, 0.08, kp_pts, 0.08)
            want = tmap.association_ids(*cand, 64.0, 40.0, kp_pts is not None)
            assert torch.equal(got, want) and int((got >= 0).sum()) > 20
        assert launched() == [0, 0, 4, 0]
    else:
        s1, v1, s2, v2, _ = _variant(rng, 1024, 16384, "ties")
        args = [t(a) for a in (s1, v1, s2, v2)]
        idx, best, ok = tdist.sharded_hamming_match(mesh, *args)
        assert launched() == [0, 0, 0, 1]
        b, s, i = th.hamming_top2(*args)
        assert torch.equal(idx, i) and torch.equal(best, b)
        assert torch.equal(ok, (b < 64.0) & (b < 0.9 * s) & args[1])
        assert int(ok.sum()) > 100


def _with_worker_groups(sess, mesh):
    """Put a threaded session on a mesh whose model axis is 1 into the
    threaded sharded mode: its map on a `Block` of the whole table and its
    worker on that block with the worker's group, beside the agreement's
    host group (what `SLAMSession(cfg, async_backend=True, mesh=)` sets up
    for a model axis above 1)."""
    from slam_rgbd_tpu_torch.parallel import mesh as pmesh

    sess._stop_worker()
    sess._blk = pmesh.model_block(mesh, sess.cfg.keyframes.max_map_points)
    sess._fresh()
    assert sess.worker.blk.group is not sess._blk.group and sess._host_group is not None
    return sess


@pytest.mark.cuda
def test_threaded_session_with_worker_groups_equals_the_plain_one_on_card(cuda_device,
                                                                          tmp_path):
    """One rank, a (1, 1) mesh over a one-rank gloo group: the threaded
    session with the worker's group and the host group in place (each
    pass's collectives on the worker's group, the per-call agreement on the
    host group) equals the plain threaded session bit for bit, both driven
    with `sync_backend()` after every frame over 24 sweep frames with a lost
    one."""
    from slam_rgbd_tpu_torch.core.config import MeshConfig
    from slam_rgbd_tpu_torch.parallel import mesh as pmesh

    frames = _sweep_with_a_lost_frame(cuda_device, 24)
    pmesh.initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, "gloo", "cuda")
    try:
        mesh = pmesh.make_mesh(MeshConfig(data=1, model=1), "cuda")
        cfg = _graph_config()
        grouped = _with_worker_groups(SLAMSession(cfg, async_backend=True, mesh=mesh),
                                      mesh)
        plain = SLAMSession(cfg, async_backend=True)
        out = []
        for sess in (grouped, plain):
            try:
                for ts, d, c in frames:
                    sess.process_frame(ts, d, c)
                    sess.sync_backend()
                st = sess.state
                out.append((sess.poses()[1], sess.keyframe_poses()[1],
                            [st.keyframes, st.lost, st.relocalized, st.loops,
                             sess.worker.completed, sess.worker.skipped,
                             sess.map_point_count()],
                            {k: v.cpu() for k, v in vars(sess.map).items()}))
            finally:
                sess.close()
        (p1, k1, c1, m1), (p2, k2, c2, m2) = out
        assert c1 == c2 and c1[0] >= 3 and c1[2] >= 1 and c1[4] >= 3
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(k1, k2)
        for k in m2:
            assert torch.equal(m1[k], m2[k]), k
        assert grouped._worker_blk is None and grouped._host_group is None
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_a_collection_during_a_capture_frees_no_graph_on_card(cuda_device):
    """A finished session held only by a reference cycle, its frame graph
    captured: a second session's capture, with the collector set to run at
    almost every allocation, succeeds (the capture runs with the collector
    off; a graph destroyed while a stream captures would invalidate the
    capture)."""
    import gc

    frames = list(SyntheticSequence(3, CAM, sweep=True, device=cuda_device))
    old = SLAMSession(_graph_config(), device=cuda_device)
    for f in frames:
        old.process_frame(*f)
    assert old._graph.captures == 1
    old.itself = old  # only the collector can free it now
    del old
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        new = SLAMSession(_graph_config(), device=cuda_device)
        for f in frames:
            new.process_frame(*f)
    finally:
        gc.set_threshold(*threshold)
    assert new._graph.captures == 1 and np.isfinite(new.poses()[1]).all()


@pytest.mark.cuda
def test_device_ms_and_roofline_on_card(cuda_device):
    """`runtime.profiling.device_ms` of a copy of 256 MiB: a positive median
    near the copy's time (the card busy through the timed span), and
    `roofline` judged on the card's own name: a fraction in (0, 1] where the
    table has the card, None where it lacks it."""
    from slam_rgbd_tpu_torch.runtime import profiling

    x = torch.empty(64 * 2**20, dtype=torch.float32, device=cuda_device)
    y = torch.empty_like(x)
    ms, busy = profiling.device_ms(lambda: y.copy_(x), n=20)
    assert 0.0 < ms < 50.0 and 0.5 < busy <= 1.0 + 1e-6
    name = torch.cuda.get_device_name(cuda_device)
    r = profiling.roofline(2 * x.numel() * 4, ms / 1e3)
    assert r["card"] == name and r["bound"] in (None, "bytes")
    if profiling.card_peaks(name) is None:
        assert r["fraction"] is None
    else:
        assert 0.0 < r["fraction"] <= 1.0
    assert 0.0 < profiling.host_ms(lambda: y.copy_(x)) < 1e3
    assert name in profiling.card_and_power()


@pytest.mark.cuda
@pytest.mark.parametrize("k1, k2", [(1024, 16384), (1024, 1024)])
def test_hamming_top2_library_comparator_on_card(cuda_device, k1, k2):
    """The benchmark's library comparator (bf16 matmul + `torch.topk`) gives
    the kernel's best and second distances exactly, masked rows included;
    the index agrees wherever the best distance is unique."""
    from slam_rgbd_tpu_torch.benchmarks import hamming_top2_library

    rng = np.random.default_rng(11)
    s1 = torch.from_numpy(rng.choice([-1, 1], (k1, 256)).astype(np.int8)).to(cuda_device)
    s2 = torch.from_numpy(rng.choice([-1, 1], (k2, 256)).astype(np.int8)).to(cuda_device)
    s2[k2 - 64:] = s2[:64]  # ties across column tiles
    v1 = torch.from_numpy(rng.uniform(size=k1) > 0.05).to(cuda_device)
    v2 = torch.from_numpy(rng.uniform(size=k2) > 0.05).to(cuda_device)
    got = th.hamming_top2(s1, v1, s2, v2)
    lib = hamming_top2_library(s1, v1, s2, v2)
    assert torch.equal(got[0], lib[0]) and torch.equal(got[1], lib[1])
    unique = got[1] > got[0]
    assert torch.equal(got[2][unique], lib[2][unique].to(torch.int32))
