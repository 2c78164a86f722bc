"""The port's backend maths vs the JAX package: local BA, pose graph, loop.

The scenes of `tests/test_map_backend.py:242-540` are built with numpy from
a seed and go through `slam_rgbd_tpu.backend.{ba,pose_graph,loop}` and the
port's counterparts on the CPU. Both run the same float32 formulas; sums
and small solves are taken in other orders, and an LM or GN iteration feeds
the differences back, so every tolerance is stated where it is asserted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.backend import ba as jba
from slam_rgbd_tpu.backend import loop as jloop
from slam_rgbd_tpu.backend import pose_graph as jpg
from slam_rgbd_tpu.core import se3 as jse3
from slam_rgbd_tpu.core.config import BAConfig, CameraIntrinsics, KeyframeConfig
from slam_rgbd_tpu.mapping import map as jmap
from slam_rgbd_tpu_torch import interop
from slam_rgbd_tpu_torch.backend import ba as tba
from slam_rgbd_tpu_torch.backend import loop as tloop
from slam_rgbd_tpu_torch.backend import pose_graph as tpg
from slam_rgbd_tpu_torch.core import se3 as tse3
from test_torch_priority import below_the_jax_files  # noqa: F401 (autouse)

torch.set_num_threads(1)

CAM = CameraIntrinsics(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
K = 64


def _exp(xi):
    return np.asarray(jse3.exp(jnp.asarray(np.asarray(xi, np.float32))))


def _make_world(rng, n_pts):
    return np.stack([
        rng.uniform(-1.5, 1.5, n_pts), rng.uniform(-1.0, 1.0, n_pts),
        rng.uniform(2.0, 4.0, n_pts),
    ], axis=1).astype(np.float32)


def _observe(T_wc, pts_w, noise=0.0, rng=None):
    T_cw = np.linalg.inv(T_wc)
    pc = pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = pc[:, 2]
    u = CAM.fx * pc[:, 0] / z + CAM.cx
    v = CAM.fy * pc[:, 1] / z + CAM.cy
    if noise:
        u = u + rng.normal(0, noise, u.shape)
        v = v + rng.normal(0, noise, v.shape)
    ok = (z > 0.3) & (u >= 0) & (u < CAM.width) & (v >= 0) & (v < CAM.height)
    return np.stack([u, v], 1).astype(np.float32), pc.astype(np.float32), ok


def _ba_problem(rng, W=4, n_pts=128, P=None, noise=0.0):
    """A window of W keyframes along a gentle arc seeing n_pts points; poses
    (but the first) and points start perturbed. With `P` the points sit at
    sorted random rows of a P-row table of far-off decoys."""
    pts_w = _make_world(rng, n_pts)
    poses_gt, T = [], np.eye(4, dtype=np.float32)
    for _ in range(W):
        poses_gt.append(T.copy())
        T = T @ _exp([0.08, 0.01, 0.02, 0.01, 0.03, 0.005])
    poses_gt = np.stack(poses_gt)
    obs_uv = np.zeros((W, n_pts, 2), np.float32)
    obs_z = np.zeros((W, n_pts), np.float32)
    obs_ok = np.zeros((W, n_pts), bool)
    for w in range(W):
        uv, pc, ok = _observe(poses_gt[w], pts_w, noise, rng)
        obs_uv[w], obs_z[w], obs_ok[w] = uv, pc[:, 2], ok
    poses_init = poses_gt.copy()
    for w in range(1, W):
        xi = rng.normal(size=6).astype(np.float32) * np.array(
            [0.02, 0.02, 0.02, 0.01, 0.01, 0.01], np.float32)
        poses_init[w] = poses_gt[w] @ _exp(xi)
    pts_init = pts_w + rng.normal(size=pts_w.shape).astype(np.float32) * 0.02
    ids = np.arange(n_pts, dtype=np.int32)
    table = pts_init
    if P is not None:
        ids = np.sort(rng.choice(P, n_pts, replace=False)).astype(np.int32)
        table = rng.normal(size=(P, 3)).astype(np.float32) + np.array([0, 0, 10], np.float32)
        table[ids] = pts_init
    obs_pid = np.tile(ids, (W, 1))
    args = (poses_init, np.ones(W, bool), table, obs_uv, obs_z, obs_pid, obs_ok)
    return args, poses_gt, ids


def _j(args):
    return tuple(jnp.asarray(a) for a in args)


def _t(args):
    return tuple(torch.tensor(a) for a in args)


def test_inv3x3_matches_jax(rng):
    M = rng.normal(size=(50, 3, 3)).astype(np.float32)
    M = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    got = tba._inv3x3(torch.tensor(M)).numpy()
    # the same ~40 float32 operations in the same order
    np.testing.assert_allclose(got, np.asarray(jba._inv3x3(jnp.asarray(M))), rtol=1e-5)
    np.testing.assert_allclose(got @ M, np.tile(np.eye(3), (50, 1, 1)), atol=1e-3)


def test_adjoint_matches_jax(rng):
    xi = rng.normal(size=(5, 6)).astype(np.float32) * 0.5
    T = np.stack([_exp(x) for x in xi])
    want = np.stack([np.asarray(jse3.adjoint(jnp.asarray(t))) for t in T])
    np.testing.assert_allclose(tse3.adjoint(torch.tensor(T)).numpy(), want, atol=1e-6)
    np.testing.assert_allclose(tse3.adjoint(torch.tensor(T[2])).numpy(), want[2], atol=1e-6)


@pytest.mark.parametrize("fn", ["exp", "log", "inverse", "normalize_rotation"])
def test_se3_batched_equals_per_element(rng, fn):
    """A leading batch dimension gives each element's own result (1e-6: the
    same formulas through batched matrix products)."""
    xi = rng.normal(size=(6, 6)).astype(np.float32) * 0.4
    xi[0] = 0.0
    xi[1, 3:] = [1e-5, -2e-5, 1e-5]
    xi[2, 3:] = [2.9, 0.6, 0.2]  # near the pi branch of log
    x = torch.tensor(xi)
    T = tse3.exp(x)
    if fn == "exp":
        f, arg = tse3.exp, x
    else:
        f, arg = getattr(tse3, fn), T
    batched = f(arg.reshape((2, 3) + arg.shape[1:]))
    for i in range(6):
        np.testing.assert_allclose(batched[i // 3, i % 3].numpy(), f(arg[i]).numpy(),
                                   atol=1e-6)
    if fn == "exp":  # against the JAX one, element by element
        for i in range(6):
            np.testing.assert_allclose(T[i].numpy(), _exp(xi[i]), atol=1e-5)


def test_reproj_residuals_match_jax(rng):
    args, _, _ = _ba_problem(rng)
    poses, _, pts, uv, z, pid, ok = args
    pid = pid.copy()
    pid[0, :5] = -1  # unmatched keypoints
    want = jba._reproj_residuals(*_j((poses, pts, uv, z, pid, ok)), CAM)
    got = tba._reproj_residuals(*_t((poses, pts, uv, z, pid, ok)), CAM)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3])) and not got[3][0, :5].any()
    m = np.asarray(want[3])
    # residuals in pixels (up to ~10 px here) and Jacobians up to ~1e3
    np.testing.assert_allclose(got[0].numpy()[m], np.asarray(want[0])[m], atol=2e-3)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_local_ba_matches_jax(rng, noise):
    """Eight LM iterations from the same perturbed start: poses to 1e-4 and
    points to 1e-3 of the JAX result (float32 normal equations solved in
    other orders, fed back eight times), and to the ground truth as the JAX
    package's own test holds it."""
    args, poses_gt, _ = _ba_problem(rng, noise=noise)
    cfg = BAConfig(iters=8)
    want = jba.local_ba(*_j(args), CAM, cfg)
    got = tba.local_ba(*_t(args), CAM, cfg)
    assert int(got.n_obs) == int(want.n_obs) > 300
    np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(want.kf_pose), atol=1e-4)
    np.testing.assert_allclose(got.pt_xyz.numpy(), np.asarray(want.pt_xyz), atol=1e-3)
    np.testing.assert_allclose(float(got.rmse_px), float(want.rmse_px), atol=5e-3)
    np.testing.assert_allclose(got.kf_pose[0].numpy(), args[0][0], atol=1e-6)  # gauge
    if noise:
        assert 0.2 < float(got.rmse_px) < 0.9
    else:
        assert float(got.rmse_px) < 0.1
        for w in range(4):
            e = tse3.log(torch.tensor(np.linalg.inv(poses_gt[w])) @ got.kf_pose[w])
            assert float(e[:3].norm()) < 2e-3 and float(e[3:].norm()) < 2e-3


def test_local_ba_free_mask_and_invalid_camera(rng):
    """The batch session's use: the older half of the window fixed, one
    window slot invalid. Fixed and invalid cameras keep their poses."""
    args, _, _ = _ba_problem(rng)
    valid = np.array([True, True, False, True])
    free = np.array([False, False, True, True])
    a = list(args)
    a[1] = valid
    cfg = BAConfig(iters=4)
    want = jba.local_ba(*_j(a), CAM, cfg, free_mask=jnp.asarray(free))
    got = tba.local_ba(*_t(a), CAM, cfg, free_mask=torch.tensor(free))
    np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(want.kf_pose), atol=1e-4)
    np.testing.assert_array_equal(got.kf_pose[:3].numpy(), args[0][:3])
    assert int(got.n_obs) == int(want.n_obs)


def test_win_compact_matches_jax_incl_overflow(rng):
    """The compaction is integer work: selection, remapped ids and masks
    equal the JAX ones exactly, with room (256 slots for 128 points) and
    with overflow (64 slots)."""
    args, _, ids = _ba_problem(rng, P=1024)
    _, valid, table, uv, z, pid, ok = args
    for budget in (256, 64):
        cfg = BAConfig(iters=3, max_points_per_window=budget)
        want = jba._win_compact(*_j((valid, table, uv, z, pid, ok)), CAM, cfg)
        got = tba._win_compact(*_t((valid, table, uv, z, pid, ok)), CAM, cfg)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        n_seen = len(np.unique(pid[ok]))
        assert int(got[4]) == n_seen and int((got[0] < 1024).sum()) == min(budget, n_seen)


def test_windowed_single_matches_jax_and_overflow_is_reported(rng):
    args, _, ids = _ba_problem(rng, P=1024)
    table = args[2]
    cfg = BAConfig(iters=5)
    want = jba._windowed_single(*_j(args), CAM, cfg)
    got = tba._windowed_single(*_t(args), CAM, cfg)
    full = tba.local_ba(*_t(args), CAM, cfg)
    assert int(got.n_obs) == int(want.n_obs) == int(full.n_obs) > 0
    np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(want.kf_pose), atol=1e-4)
    np.testing.assert_allclose(got.pt_xyz.numpy(), np.asarray(want.pt_xyz), atol=1e-3)
    np.testing.assert_array_equal(got.pt_solved.numpy(), np.asarray(want.pt_solved))
    assert int(got.n_dropped) == int(want.n_dropped) == 0
    # the same solve as over the full table, and unobserved rows untouched
    np.testing.assert_allclose(got.kf_pose.numpy(), full.kf_pose.numpy(), atol=1e-4)
    rest = np.ones(1024, bool)
    rest[ids] = False
    np.testing.assert_array_equal(got.pt_xyz.numpy()[rest], table[rest])

    small = BAConfig(iters=3, max_points_per_window=64)
    want = jba._windowed_single(*_j(args), CAM, small)
    got = tba._windowed_single(*_t(args), CAM, small)
    np.testing.assert_array_equal(got.pt_solved.numpy(), np.asarray(want.pt_solved))
    assert int(got.n_dropped) == int(want.n_dropped) == len(np.unique(args[5][args[6]])) - 64
    moved = ~np.isclose(got.pt_xyz.numpy(), table, atol=0).all(axis=1)
    assert not moved[~got.pt_solved.numpy()].any() and np.isfinite(got.pt_xyz.numpy()).all()
    np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(want.kf_pose), atol=1e-4)


@pytest.mark.parametrize("k", [1, 2, 3, 9])
def test_chunked_equals_single(rng, k):
    """`dispatch_iters` (the reference's chunked dispatch) leaves the result
    the one-go result, bit for bit, and a chunk of less than one raises."""
    args, _, _ = _ba_problem(rng, P=1024)
    cfg = BAConfig(iters=5, max_points_per_window=256)
    one = tba.windowed_local_ba(*_t(args), CAM, cfg)
    chk = tba.windowed_local_ba(*_t(args), CAM, cfg, dispatch_iters=k)
    for a, b in zip(one, chk):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tba.windowed_local_ba(*_t(args), CAM, cfg, dispatch_iters=0)


# ---- pose graph -------------------------------------------------------------

def _chain(n):
    gt, steps = [np.eye(4, dtype=np.float32)], []
    for i in range(n - 1):
        D = _exp([0.1, 0.02 * np.sin(i), 0, 0, 0.08, 0])
        gt.append((gt[-1] @ D).astype(np.float32))
        steps.append(D)
    return np.stack(gt), steps


def _edge_lists(capacity, items):
    """The same edges in both packages' lists; items: (i, j, T, weight)."""
    ej, nj = jpg.EdgeList.empty(capacity), jnp.int32(0)
    et, nt = tpg.EdgeList.empty(capacity, "cpu"), torch.zeros((), dtype=torch.int32)
    for i, j, T, w in items:
        ej, nj = ej.add(nj, i, j, jnp.asarray(T), w)
        et, nt = et.add(nt, i, j, torch.tensor(T), w)
    assert int(nj) == int(nt)
    return ej, et


def test_pose_graph_loop_corrects_drift_like_jax():
    """A drifted chain with one exact loop edge, 15 GN iterations: the
    poses agree with the JAX result to 1e-3 (each iteration's system is
    solved by CG to a relative 1e-5, in float32, and fed back) and the
    drift of the last node falls below a quarter, as in the JAX test."""
    M = 10
    gt, steps = _chain(M)
    Dd = _exp([0.004, 0, 0.002, 0, 0.003, 0])
    est = [gt[0]]
    for D in steps:
        est.append((est[-1] @ D @ Dd).astype(np.float32))
    est = np.stack(est)
    items = [(i, i + 1, (D @ Dd).astype(np.float32), 1.0) for i, D in enumerate(steps)]
    items.append((0, M - 1, (np.linalg.inv(gt[0]) @ gt[-1]).astype(np.float32), 10.0))
    ej, et = _edge_lists(32, items)
    want = jpg.optimize_pose_graph(jnp.asarray(est), jnp.ones(M, bool), ej, iters=15)
    got = tpg.optimize_pose_graph(torch.tensor(est), torch.ones(M, dtype=torch.bool),
                                  et, iters=15)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=1e-3)
    np.testing.assert_allclose(float(got.rmse), float(want.rmse), atol=1e-4)
    assert int(got.n_edges) == int(want.n_edges) == M
    drift0 = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    drift1 = np.linalg.norm(got.poses[-1].numpy()[:3, 3] - gt[-1][:3, 3])
    assert drift1 < 0.25 * drift0
    np.testing.assert_array_equal(got.poses[0].numpy(), est[0])  # the gauge


def test_pose_graph_consistent_chain_and_invalid_nodes():
    M = 8
    gt, steps = _chain(M)
    ej, et = _edge_lists(32, [(i, i + 1, D, 1.0) for i, D in enumerate(steps)])
    got = tpg.optimize_pose_graph(torch.tensor(gt), torch.ones(M, dtype=torch.bool), et, iters=5)
    want = jpg.optimize_pose_graph(jnp.asarray(gt), jnp.ones(M, bool), ej, iters=5)
    assert float(got.rmse) < 1e-5 and float(want.rmse) < 1e-5
    np.testing.assert_allclose(got.poses.numpy(), gt, atol=1e-4)

    # four valid nodes at identity with 10 cm edges, two invalid ones
    poses = np.stack([np.eye(4, dtype=np.float32)] * 6)
    valid = np.array([True] * 4 + [False] * 2)
    D = _exp([0.1, 0, 0, 0, 0, 0])
    ej, et = _edge_lists(8, [(i, i + 1, D, 1.0) for i in range(3)])
    want = jpg.optimize_pose_graph(jnp.asarray(poses), jnp.asarray(valid), ej, iters=3)
    got = tpg.optimize_pose_graph(torch.tensor(poses), torch.tensor(valid), et, iters=3)
    np.testing.assert_array_equal(got.poses[4:].numpy(), poses[4:])
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=1e-4)
    np.testing.assert_allclose(got.poses[3, 0, 3].item(), 0.3, atol=1e-3)


def test_conjugate_gradient_matches_jax(rng):
    A = rng.normal(size=(40, 40)).astype(np.float32)
    A = A @ A.T + 40 * np.eye(40, dtype=np.float32)
    b = rng.normal(size=40).astype(np.float32)
    want, _ = jax.scipy.sparse.linalg.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                                         tol=1e-5, maxiter=256)
    got = tpg.conjugate_gradient(torch.tensor(A), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(A @ got.numpy(), b, atol=1e-4)
    # a zero right-hand side ends at once with the zero start
    assert not tpg.conjugate_gradient(torch.tensor(A), torch.zeros(40)).any()
    # three iterations only: the state of iteration three, not a converged one
    few = tpg.conjugate_gradient(torch.tensor(A), torch.tensor(b), maxiter=3)
    want3, _ = jax.scipy.sparse.linalg.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                                          tol=1e-5, maxiter=3)
    np.testing.assert_allclose(few.numpy(), np.asarray(want3), atol=1e-6)


# ---- loop closure -----------------------------------------------------------

@pytest.fixture(scope="module")
def revisit_map():
    """Keyframes 0..7 where keyframe 7 comes back to keyframe 0's viewpoint
    (`tests/test_map_backend.py:493`), built by the JAX `insert_keyframe`."""
    rng = np.random.default_rng(0)
    m = jmap.empty_map(KeyframeConfig(max_keyframes=16, max_map_points=2048), K)
    pts_w = _make_world(rng, K)
    signs0 = rng.choice([-1, 1], size=(K, 256)).astype(np.int8)
    poses, T = [], np.eye(4, dtype=np.float32)
    for i in range(8):
        if i == 7:
            T = poses[0] @ _exp([0.02, 0, 0.01, 0, 0.01, 0])
        poses.append(T.copy())
        uv, pc, ok = _observe(T, pts_w)
        if 2 <= i <= 5:  # distant views that do not see the points
            T = T @ _exp([0.4, 0, 0, 0, 0.5, 0])
            signs = rng.choice([-1, 1], size=(K, 256)).astype(np.int8)
            ok = ok & False
        else:
            T = T @ _exp([0.05, 0, 0, 0, 0.02, 0])
            signs = signs0 + 0
        m = jmap.insert_keyframe(
            m, jnp.asarray(poses[-1]), float(i), jnp.asarray(uv), jnp.asarray(pc),
            jnp.asarray(ok | (i in (2, 3, 4, 5))), jnp.asarray(signs),
            jnp.full((K,), -1, jnp.int32))
    return m, interop.map_from_numpy(m, "cpu"), poses


def test_place_signatures_match_jax_and_kf_sig(revisit_map):
    mj, mt, _ = revisit_map
    got = tloop.place_signatures(mt).numpy()
    np.testing.assert_allclose(got, np.asarray(jloop.place_signatures(mj)), atol=1e-6)
    np.testing.assert_allclose(got, mt.kf_sig.numpy(), atol=1e-6)


@pytest.mark.parametrize("query,min_interval,min_score", [(7, 3, 0.15), (3, 20, 0.2),
                                                          (7, 3, 0.999), (6, 2, 0.0)])
def test_find_loop_candidate_matches_jax(revisit_map, query, min_interval, min_score):
    mj, mt, _ = revisit_map
    want = jloop.find_loop_candidate(mj, jnp.int32(query), min_interval=min_interval,
                                     min_score=min_score)
    got = tloop.find_loop_candidate(mt, query, min_interval=min_interval,
                                    min_score=min_score)
    assert bool(got.ok) == bool(want.ok)
    assert int(got.kf_idx) == int(want.kf_idx) and got.kf_idx.dtype == torch.int32
    np.testing.assert_allclose(float(got.score), float(want.score), atol=1e-6)
    if (query, min_score) == (7, 0.15):
        assert bool(got.ok) and int(got.kf_idx) in (0, 1)
    if min_interval == 20:
        assert not bool(got.ok)


def test_verify_loop_matches_jax(revisit_map):
    """The match is exact in both; the 3D-3D solve draws other minimal
    triples, so on this scene with a clear consensus the two agree on the
    result: the same matches, inliers within 2, T_rel to 1e-4."""
    mj, mt, poses = revisit_map
    for cand in (0, 1):
        want = jloop.verify_loop(mj, jnp.int32(7), jnp.int32(cand))
        got = tloop.verify_loop(mt, 7, cand)
        assert bool(got.ok) and bool(want.ok)
        assert int(got.n_matches) == int(want.n_matches) > 25
        assert abs(int(got.inliers) - int(want.inliers)) <= 2
        np.testing.assert_allclose(got.T_rel.numpy(), np.asarray(want.T_rel), atol=1e-4)
        T_want = np.linalg.inv(poses[cand]) @ poses[7]
        e = tse3.log(torch.tensor(np.linalg.inv(T_want).astype(np.float32)) @ got.T_rel)
        assert float(e.norm()) < 0.01
    # against a distant keyframe nothing verifies, in either package
    assert not bool(tloop.verify_loop(mt, 7, 3).ok)
    assert not bool(jloop.verify_loop(mj, jnp.int32(7), jnp.int32(3)).ok)
