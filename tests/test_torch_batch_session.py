"""The port's batch session vs the JAX package, step program by step program.

One scenario at 128x96, B = 2: sequence A is an out-and-back sweep whose last
keyframe carries a pose offset (so that map association fails there and the
revisit must close a loop), sequence B a forward orbit with another seed.
Keyframes are forced at the same frames on both sides. Every JAX step
program (`_batch_features`, `_batch_insert`, `_batch_ba`,
`_batch_loop_candidates`, `_batch_loop_close`, `_batch_reloc`,
`_batch_steady`, `_batch_traj_append`) runs once from the state the one
before left; the port's counterpart starts from the same state, carried over
with `interop.batch_state_from_numpy`, and must land on the JAX result, the
masked-out sequence untouched. Both sides get the JAX feature stage's output
where a program consumes features (descriptors flip bits under last-bit
float differences; the port's own feature stage is compared separately).
The JAX tracker runs its kernel path (`backend="pallas"`, the batched kernel
in interpret mode).

Then `BatchSession(device="cpu")` end to end with its own features.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.backend.pose_graph import EdgeList as JEdgeList
from slam_rgbd_tpu.core import camera as jcam
from slam_rgbd_tpu.core import se3 as jse3
from slam_rgbd_tpu.core.config import (
    BAConfig, CameraIntrinsics, ICPConfig, KeyframeConfig, ORBConfig, SLAMConfig,
)
from slam_rgbd_tpu.io import synthetic as jsyn
from slam_rgbd_tpu.mapping import map as jmap
from slam_rgbd_tpu.runtime import batch_session as jbs
from slam_rgbd_tpu_torch import BatchSession, interop
from slam_rgbd_tpu_torch.core import se3 as tse3
from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse
from slam_rgbd_tpu_torch.ops import gn_reduce as tg
from slam_rgbd_tpu_torch.ops import hamming as th
from slam_rgbd_tpu_torch.runtime import batch_session as tbs

torch.set_num_threads(1)

CAM = CameraIntrinsics(fx=114.1, fy=114.1, cx=63.5, cy=47.5, width=128, height=96)
CFG = SLAMConfig(
    camera=CAM,
    icp=ICPConfig(levels=2, iters=(3, 2), window_px=(4, 2), backend="pallas"),
    orb=ORBConfig(n_features=256, n_levels=4),
    keyframes=KeyframeConfig(max_keyframes=16, max_map_points=2048, kf_min_trans=0.03),
    ba=BAConfig(window=4, iters=3, max_points_per_window=512, pg_iters=4,
                loop_min_interval=2, loop_cooldown_kf=2),
)
B = 2
N = 17  # sequence A turns round at frame 8: frame 16 sees what frame 0 saw
# frame -> (which sequences insert a keyframe there, which run the backend
# pass after it). Sequence A's last keyframe is inserted 40 cm off and shares
# no point with the others: a BA over it would be a free-floating problem
# whose answer is rounding noise, so that pass runs for B alone.
KF_PLAN = {0: ((True, True), (False, False)), 4: ((True, True), (False, False)),
           8: ((True, True), (True, True)), 12: ((True, False), (True, False)),
           16: ((True, True), (False, True))}
MAP_FIELDS = [f.name for f in dataclasses.fields(tbs.smap.MapState)]
EYE = np.eye(4, dtype=np.float32)


def _exp(xi):
    return np.asarray(jse3.exp(jnp.asarray(np.asarray(xi, np.float32))))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def frames():
    gts = [jsyn.orbit_trajectory(N, sweep=True),
           jsyn.orbit_trajectory(N, step_t=0.016, step_r=0.012, seed=1)]
    depth, rgb = [], []
    for i in range(N):
        fr = [jsyn.render_frame(jnp.asarray(gt[i]), CAM) for gt in gts]
        depth.append(np.stack([np.array(f[0]) for f in fr]))
        rgb.append(np.stack([np.array(f[1]) for f in fr]))
    rel = np.stack([np.linalg.inv(gt[0]) @ gt for gt in gts]).astype(np.float32)
    # keyframe poses: ground truth 1 cm off (work for the BA); sequence A's
    # revisit 40 cm off, beyond both association gates (the checker texture
    # repeats, so a few keypoints still alias onto old points)
    pose = rel.copy()
    for i in (4, 8, 12):
        pose[:, i] = rel[:, i] @ _exp([0.01, -0.005, 0.0, 0.0, 0.004, 0.0])
    pose[0, 16] = rel[0, 16] @ _exp([0.3, -0.25, 0.1, 0.0, 0.0, 0.0])
    return depth, rgb, pose, rel


@pytest.fixture(scope="module")
def scenario(frames):
    """The JAX side: every step program once, the state before and after
    each kept as numpy. -> list of (name, before, args, after)."""
    depth, rgb, pose, _ = frames
    n_kp = CFG.orb.n_features
    stackB = lambda t: jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), t)
    st = dict(
        maps=stackB(jmap.empty_map(CFG.keyframes, n_kp)),
        edges=stackB(JEdgeList.empty(4 * CFG.keyframes.max_keyframes)),
        n_edges=jnp.zeros((B,), jnp.int32),
        T_world=jnp.asarray(np.stack([EYE] * B)), last_kf_T=jnp.asarray(np.stack([EYE] * B)),
        n_kf=np.zeros(B, np.int64),
    )
    steps = []

    def record(name, before, args, after):
        steps.append((name, _np(before), args, _np(after)))

    for i, (plan, ba_plan) in KF_PLAN.items():
        do = np.asarray(plan)
        d, c = jnp.asarray(depth[i]), jnp.asarray(rgb[i])
        feats = jbs._batch_features(d, c, cam=CAM, orb=CFG.orb)
        before = dict(st)
        st = dict(st, T_world=jnp.asarray(pose[:, i]))
        kf_idx = st["n_kf"].astype(np.int32)
        m, e, n, last = jbs._batch_insert(
            st["maps"], st["edges"], st["n_edges"], *feats, st["T_world"],
            jnp.full((B,), np.float32(i / 30.0)), jnp.asarray(kf_idx), jnp.asarray(do),
            cfg=CFG)
        st = dict(st, maps=m, edges=e, n_edges=n, last_kf_T=last, n_kf=st["n_kf"] + do)
        record("insert", dict(before, T_world=jnp.asarray(pose[:, i])),
               dict(frame=i, do=do, kf_idx=kf_idx, feats=_np(feats)), st)
        do_ba = np.asarray(ba_plan)
        if do_ba.any():
            before = dict(st)
            m, Tw, rmse = jbs._batch_ba(st["maps"], st["T_world"], jnp.asarray(do_ba), cfg=CFG)
            st = dict(st, maps=m, T_world=Tw)
            record("ba", before, dict(do=do_ba), dict(st, rmse=rmse))
    # the revisit: candidates for both sequences, closure where one exists
    new_kf = (st["n_kf"] - 1).astype(np.int32)
    cand = np.asarray(jbs._batch_loop_candidates(st["maps"], jnp.asarray(new_kf), cfg=CFG))
    record("candidates", st, dict(kf_idx=new_kf), dict(cand=cand))
    do_loop = cand[:, 0] > 0.5
    before = dict(st)
    m, e, n, Tw, closed = jbs._batch_loop_close(
        st["maps"], st["edges"], st["n_edges"], st["T_world"], jnp.asarray(new_kf),
        jnp.asarray(cand[:, 1].astype(np.int32)), jnp.asarray(do_loop), cfg=CFG)
    st = dict(st, maps=m, edges=e, n_edges=n, T_world=Tw)
    record("loop_close", before,
           dict(kf_idx=new_kf, cand_idx=cand[:, 1].astype(np.int32), do=do_loop),
           dict(st, closed=closed))
    return steps


def _load(before) -> BatchSession:
    bs = BatchSession(CFG, B, device="cpu")
    interop.batch_state_from_numpy(
        bs, maps=before["maps"], edges=before["edges"], n_edges=before["n_edges"],
        T_world=before["T_world"], motion=np.stack([EYE] * B),
        last_kf_T=before["last_kf_T"], n_kf=before["n_kf"])
    return bs


def _assert_maps(maps, want, seqs, atol=None):
    """Sequence b's port map equals row b of the stacked JAX map: integers
    and masks exactly, floats to `atol[name]` (default 1e-6)."""
    atol = atol or {}
    for b in seqs:
        got = interop.map_to_numpy(maps[b])
        for name in MAP_FIELDS:
            w = np.asarray(getattr(want, name))[b]
            assert got[name].dtype == w.dtype, name
            if w.dtype == np.float32:
                np.testing.assert_allclose(got[name], w, atol=atol.get(name, 1e-6),
                                           err_msg=f"{name}[{b}]")
            else:
                np.testing.assert_array_equal(got[name], w, err_msg=f"{name}[{b}]")


def _assert_edges(edges, n_edges, want, want_n, seqs, atol=1e-6):
    for b in seqs:
        for name, g in interop.edges_to_numpy(edges[b]).items():
            w = np.asarray(getattr(want, name))[b]
            if w.dtype == np.float32:
                np.testing.assert_allclose(g, w, atol=atol, err_msg=f"{name}[{b}]")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name}[{b}]")
        assert int(n_edges[b]) == int(want_n[b])


def _feats_list(feats, do):
    uv, signs, pts, ok = feats
    return [(torch.tensor(uv[b]), torch.tensor(signs[b]), torch.tensor(pts[b]),
             torch.tensor(ok[b])) if do[b] else None for b in range(B)]


def _steps(scenario, name):
    return [s for s in scenario if s[0] == name]


def test_batch_insert_matches_jax(scenario):
    """Five inserts, one of them with sequence B masked out: map, edges and
    reference keyframe pose after each (integers exactly, floats to 1e-6).
    The masked-out sequence keeps its state and gets the previous keyframe's
    pose as reference."""
    inserts = _steps(scenario, "insert")
    assert len(inserts) == 5
    for _, before, a, after in inserts:
        bs = _load(before)
        untouched = [interop.map_to_numpy(m) for m in bs.maps]
        maps, edges, n_edges, last = tbs._batch_insert(
            bs.maps, bs.edges, bs.n_edges, _feats_list(a["feats"], a["do"]),
            bs.T_world, a["frame"] / 30.0, a["kf_idx"], a["do"], CFG)
        _assert_maps(maps, after["maps"], range(B))
        _assert_edges(edges, n_edges, after["edges"], after["n_edges"], range(B))
        np.testing.assert_allclose(last.numpy(), after["last_kf_T"], atol=1e-6)
        for b in np.flatnonzero(~a["do"]):
            assert maps[b] is bs.maps[b]
            for k, v in interop.map_to_numpy(maps[b]).items():
                np.testing.assert_array_equal(v, untouched[b][k])
            np.testing.assert_array_equal(
                last[b].numpy(), untouched[b]["kf_pose"][a["kf_idx"][b] - 1])
    final = inserts[-1][3]
    assert final["n_kf"].tolist() == [5, 4]
    assert np.asarray(final["n_edges"]).tolist() == [4, 3]
    # association worked on the way out and failed on sequence A's way back
    nobs = np.asarray(final["maps"].pt_nobs)
    assert nobs[0].max() >= 3 and nobs[1].max() >= 3
    covis = np.asarray(final["maps"].covis)
    assert covis[0, 4, 0] <= 5 < covis[0, 1, 0]


def test_batch_features_match_jax(frames, scenario):
    """The port's own feature stage on a keyframe of the plan, for the
    sequence whose mask is set: the same keypoints but for a few on a
    threshold (<= 2%), descriptor bits >= 99% equal."""
    depth, rgb, _, _ = frames
    want = _steps(scenario, "insert")[1][2]["feats"]
    which = np.array([False, True])
    got = tbs._batch_features(
        torch.tensor(depth[4].astype(np.int32)), torch.tensor(rgb[4]), CAM, CFG.orb, which)
    assert got[0] is None
    uv, signs, pts, ok = (x.numpy() for x in got[1])
    assert (ok != want[3][1]).mean() <= 0.02
    both = ok & want[3][1]
    same_kp = np.abs(uv - want[0][1]).max(axis=1) < 1e-3
    assert same_kp[both].mean() >= 0.98
    sel = both & same_kp
    assert (signs[sel] == want[1][1][sel]).mean() >= 0.99
    np.testing.assert_allclose(pts[sel], want[2][1][sel], atol=1e-5)


def test_batch_ba_matches_jax(scenario):
    """Three backend passes (both sequences; A alone; B alone): keyframe poses
    and the live pose to 1e-4, points to 1e-3 (float32 normal equations
    solved in other orders and fed back over three LM iterations), the rest
    of the map exactly. A masked-out sequence is untouched."""
    passes = _steps(scenario, "ba")
    assert [p[2]["do"].tolist() for p in passes] == [[True, True], [True, False], [False, True]]
    moved = 0.0
    for _, before, a, after in passes:
        bs = _load(before)
        maps, Tw, rmse = tbs._batch_ba(bs.maps, bs.T_world, a["do"], CFG)
        _assert_maps(maps, after["maps"], range(B), atol={"kf_pose": 1e-4, "pt_xyz": 1e-3})
        np.testing.assert_allclose(Tw.numpy(), after["T_world"], atol=1e-4)
        np.testing.assert_allclose(rmse.numpy(), after["rmse"], atol=5e-3)
        for b in np.flatnonzero(~a["do"]):
            assert maps[b] is bs.maps[b] and float(rmse[b]) == 0.0
            np.testing.assert_array_equal(Tw[b].numpy(), before["T_world"][b])
        moved = max(moved, float(np.abs(after["maps"].kf_pose - before["maps"].kf_pose).max()))
    assert moved > 1e-3  # the passes really moved keyframes


def test_batch_loop_candidates_match_jax(scenario):
    (_, before, a, after), = _steps(scenario, "candidates")
    bs = _load(before)
    got = tbs._batch_loop_candidates(bs.maps, a["kf_idx"], CFG, np.ones(B, bool)).numpy()
    want = after["cand"]
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=1e-6)
    assert want[0, 0] == 1.0 and want[0, 1] in (0.0, 1.0)  # A's revisit has one
    assert want[1, 0] == 0.0  # B never came back
    only_a = tbs._batch_loop_candidates(bs.maps, a["kf_idx"], CFG, np.array([True, False]))
    assert not only_a[1].any() and torch.equal(only_a[0], torch.tensor(got[0]))


def test_batch_loop_close_matches_jax(scenario):
    """Sequence A closes its loop, B is masked out. Poses to 2e-3 and points
    to 5e-3: the 3D-3D verification draws other minimal triples in the two
    packages (T_rel agrees to ~1e-4), and four GN iterations, each solved by
    CG to a relative 1e-5, feed that back; the edge list gets the same
    weight-5 edge."""
    (_, before, a, after), = _steps(scenario, "loop_close")
    assert a["do"].tolist() == [True, False] and after["closed"].tolist() == [True, False]
    bs = _load(before)
    maps, edges, n_edges, Tw, closed = tbs._batch_loop_close(
        bs.maps, bs.edges, bs.n_edges, bs.T_world, a["kf_idx"], a["cand_idx"], a["do"], CFG)
    assert closed.tolist() == [True, False]
    _assert_maps(maps, after["maps"], range(B), atol={"kf_pose": 2e-3, "pt_xyz": 5e-3})
    _assert_edges(edges, n_edges, after["edges"], after["n_edges"], range(B), atol=2e-4)
    np.testing.assert_allclose(Tw.numpy(), after["T_world"], atol=2e-3)
    assert int(n_edges[0]) == 5 and float(edges[0].weight[4]) == 5.0
    assert (int(edges[0].i[4]), int(edges[0].j[4])) == (int(a["cand_idx"][0]), 4)
    assert maps[1] is bs.maps[1] and edges[1] is bs.edges[1]
    np.testing.assert_array_equal(Tw[1].numpy(), before["T_world"][1])
    # the closure pulled the 40 cm offset of the revisit keyframe in
    off_before = np.linalg.norm(before["maps"].kf_pose[0, 4, :3, 3] - before["maps"].kf_pose[0, 0, :3, 3])
    off_after = float(torch.linalg.norm(maps[0].kf_pose[4, :3, 3] - maps[0].kf_pose[0, :3, 3]))
    assert off_before > 0.3 and off_after < 0.5 * off_before
    # the same candidate under a consistency gate of 0 m: the would-be edge
    # disagrees with the current poses, nothing closes, nothing changes
    strict = dataclasses.replace(CFG, ba=dataclasses.replace(CFG.ba, loop_max_residual_t=0.0))
    m2, e2, n2, Tw2, closed2 = tbs._batch_loop_close(
        bs.maps, bs.edges, bs.n_edges, bs.T_world, a["kf_idx"], a["cand_idx"], a["do"], strict)
    assert not closed2.any() and m2[0] is bs.maps[0] and e2[0] is bs.edges[0]
    assert torch.equal(Tw2, bs.T_world) and int(n2[0]) == 4


def test_batch_reloc_matches_jax(frames, scenario, monkeypatch):
    """Sequence B lost at frame 6 with an estimate off by 5 cm / 2 deg, A
    masked out: both accept B only; T to 1e-4 (other minimal triples, the
    same consensus). The port's feature stage is given the JAX output."""
    depth, rgb, _, rel = frames
    before = _steps(scenario, "loop_close")[0][1]
    off = _exp([0.05, 0.0, 0.0, 0.0, 0.035, 0.0])
    T_est = np.stack([rel[0, 6], rel[1, 6] @ off]).astype(np.float32)
    do = np.array([False, True])
    d, c = jnp.asarray(depth[6]), jnp.asarray(rgb[6])
    Tj, acc_j = jbs._batch_reloc(before["maps"], d, c, jnp.asarray(T_est), jnp.asarray(do), cfg=CFG)
    # JAX features of sequence B's frame, as the port's stage output
    uv, signs, pts, ok = _np(jbs._batch_features(d, c, cam=CAM, orb=CFG.orb))

    def jax_features(depth_b, rgb_b, orb, cam):
        kp = interop.Keypoints(uv=torch.tensor(uv[1]), response=None, angle=None,
                               level=None, valid=torch.tensor(ok[1]))
        desc = interop.Descriptors(packed=None, signs=torch.tensor(signs[1]), angle=None)
        return kp, desc, torch.tensor(pts[1]), torch.tensor(ok[1])

    monkeypatch.setattr(tbs, "_features", jax_features)
    bs = _load(before)
    launches = th.hamming_top2.launches
    Tt, acc_t = tbs._batch_reloc(
        bs.maps, torch.tensor(depth[6].astype(np.int32)), torch.tensor(rgb[6]),
        torch.tensor(T_est), do, CFG)
    assert th.hamming_top2.launches == launches  # CPU tensors: the plain version
    assert acc_t.tolist() == np.asarray(acc_j).tolist() == [False, True]
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_array_equal(Tt[0].numpy(), T_est[0])
    assert np.linalg.norm(Tt[1].numpy()[:3, 3] - rel[1, 6, :3, 3]) < 0.02
    # an estimate a metre and a half off is an aliased solve: rejected
    far = T_est.copy()
    far[1, 0, 3] += 1.5
    Tf, acc_f = tbs._batch_reloc(
        bs.maps, torch.tensor(depth[6].astype(np.int32)), torch.tensor(rgb[6]),
        torch.tensor(far), do, CFG)
    assert not acc_f.any() and torch.equal(Tf, torch.tensor(far))


def test_batch_steady_and_traj_append_match_jax(frames, scenario):
    """One tracked step of both sequences from a carried-over pyramid and
    poses: poses to 1e-5, the summary's inlier fraction to 1e-6, rmse to
    1e-3 relative, the finite flag and the keyframe decision exactly."""
    depth, rgb, _, rel = frames
    prev = jax.vmap(lambda d, c: jcam.build_frame_pyramid(d, CAM, levels=2, rgb=c))(
        jnp.asarray(depth[4]), jnp.asarray(rgb[4]))
    Tw = rel[:, 4]
    motion = np.stack([EYE, _exp([0.002, 0, 0, 0, 0, 0])])
    # A's reference keyframe is the current pose (no insert), B's lies 5 cm
    # back (insert)
    last = np.stack([rel[0, 4], rel[1, 4] @ _exp([-0.05, 0, 0, 0, 0, 0])]).astype(np.float32)
    pyr_j, T2_j, m2_j, s_j = jbs._batch_steady(
        prev, jnp.asarray(depth[5]), jnp.asarray(rgb[5]), jnp.asarray(Tw), jnp.asarray(motion),
        jnp.asarray(last), cam=CAM, icp_cfg=CFG.icp, kcfg=CFG.keyframes)
    launches = tg.gn_reduce_batched.launches
    pyr_t, T2_t, m2_t, s_t = tbs._batch_steady(
        interop.pyramid_from_numpy(_np(prev), "cpu"), torch.tensor(depth[5].astype(np.int32)),
        torch.tensor(rgb[5]), torch.tensor(Tw), torch.tensor(motion), torch.tensor(last),
        CAM, CFG.icp, CFG.keyframes)
    assert tg.gn_reduce_batched.launches == launches
    np.testing.assert_allclose(T2_t.numpy(), np.asarray(T2_j), atol=1e-5)
    np.testing.assert_allclose(m2_t.numpy(), np.asarray(m2_j), atol=1e-5)
    s_j, s_t = np.asarray(s_j), s_t.numpy()
    assert s_t.shape == (B, 4)
    np.testing.assert_allclose(s_t[:, 0], s_j[:, 0], atol=1e-6)
    np.testing.assert_allclose(s_t[:, 1], s_j[:, 1], rtol=1e-3)
    np.testing.assert_array_equal(s_t[:, 2:], s_j[:, 2:])
    assert s_t[:, 3].tolist() == [0.0, 1.0] and (s_t[:, 0] > 0.8).all()
    for lj, lt in zip(pyr_j, pyr_t):
        np.testing.assert_allclose(lt["depth"].numpy(), np.asarray(lj["depth"]), atol=1e-5)
    buf_j = jbs._batch_traj_append(jnp.zeros((B, 8, 4, 4)), np.int32(3), T2_j)
    buf_t = tbs._batch_traj_append(torch.zeros((B, 8, 4, 4)), 3, T2_t)
    np.testing.assert_allclose(buf_t.numpy(), np.asarray(buf_j), atol=1e-5)
    assert not buf_t[:, :3].any() and not buf_t[:, 4:].any()


@pytest.mark.parametrize("hypotheses", [1, 3])
def test_icp_align_batched_stacked_starts_match_jax(frames, hypotheses):
    """The batched tracker against the JAX kernel path with one and with
    three starts. The port runs the starts of the coarsest level as problems
    b * n_hyp + s of one batched GN step, the starts of a sequence sharing
    its planes. With three starts sequence B's prior is rolled 0.3 rad about
    the optical axis, so that another start than the prior wins there (a
    single start from that prior does not converge in five iterations and
    is no parity scene): poses to 1e-5, inliers equal."""
    from slam_rgbd_tpu.odometry import icp as jicp
    from slam_rgbd_tpu_torch.odometry import icp as ticp

    depth, rgb, _, _ = frames
    pyr = lambda i: jax.vmap(lambda d, c: jcam.build_frame_pyramid(d, CAM, levels=2, rgb=c))(
        jnp.asarray(depth[i]), jnp.asarray(rgb[i]))
    prev_j, curr_j = pyr(4), pyr(5)
    prev_t, curr_t = (interop.pyramid_from_numpy(_np(p), "cpu") for p in (prev_j, curr_j))
    prior = np.stack([_exp([0.002, 0, 0, 0, 0, 0]), EYE]).astype(np.float32)
    if hypotheses == 3:
        prior[1, :2, :2] = [[np.cos(0.3), -np.sin(0.3)], [np.sin(0.3), np.cos(0.3)]]
    else:
        prior[1, 1, 3] = -0.002
    icfg = dataclasses.replace(CFG.icp, hypotheses=hypotheses)
    want = jicp.icp_align_batched(curr_j, prev_j, jnp.asarray(prior), CAM, icfg)
    got = ticp.icp_align_batched(curr_t, prev_t, torch.tensor(prior), CAM, icfg)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-5)
    assert got.inliers.tolist() == np.asarray(want.inliers).tolist()
    one = dataclasses.replace(icfg, hypotheses=1, iters=(3, 0), backend="auto")
    alone = lambda T0: ticp.icp_align_batched(curr_t, prev_t, T0, CAM, one).inliers
    T0 = torch.tensor(prior)
    by_start = torch.stack([alone(T0), alone(torch.tensor(np.stack([EYE] * B))),
                            alone(tse3.normalize_rotation(tse3.inverse(T0)))])
    coarse = ticp.icp_align_batched(curr_t, prev_t, T0, CAM,
                                    dataclasses.replace(one, hypotheses=hypotheses))
    if hypotheses == 3:
        assert int(by_start[:, 1].argmax()) != 0  # B: another start beats the rolled prior
        assert coarse.inliers.tolist() == by_start.amax(dim=0).tolist()
    else:
        assert coarse.inliers.tolist() == by_start[0].tolist()


def test_interop_round_trip(scenario):
    before = _steps(scenario, "loop_close")[0][1]
    bs = _load(before)
    out = interop.batch_state_to_numpy(bs)
    for name in MAP_FIELDS:
        np.testing.assert_array_equal(out["maps"][name], np.asarray(getattr(before["maps"], name)))
    for name in ("i", "j", "T_meas", "weight", "valid"):
        np.testing.assert_array_equal(out["edges"][name], np.asarray(getattr(before["edges"], name)))
    np.testing.assert_array_equal(out["n_edges"], before["n_edges"])
    np.testing.assert_array_equal(out["T_world"], before["T_world"])
    assert out["n_kf"].tolist() == [5, 4] and out["prev_pyr"] is None
    assert bs.keyframe_counts.tolist() == [5, 4]
    assert bs.map_point_counts().tolist() == np.asarray(before["maps"].pt_valid).sum(1).tolist()


# ---- the session end to end on the CPU, with its own features --------------

E2E = dataclasses.replace(
    CFG, icp=ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2)),
    keyframes=dataclasses.replace(CFG.keyframes, kf_min_trans=0.025))


def _run(cfg, seqs, n, damage=None):
    bs = BatchSession(cfg, len(seqs), device="cpu")
    for i in range(n):
        d = np.stack([s[0][i] for s in seqs])
        c = np.stack([s[1][i] for s in seqs])
        if damage is not None and i == damage[0]:
            # depth in a central window only
            h, w = d.shape[1:]
            keep = np.zeros((h, w), bool)
            keep[h // 4: 3 * h // 4, 5 * w // 16: 11 * w // 16] = True
            d = d.copy()
            d[damage[1]] = np.where(keep, d[damage[1]], 0)
        bs.process_frames(i / 30.0, d.astype(np.uint16), c)
    return bs


@pytest.fixture(scope="module")
def two_runs(frames):
    depth, rgb, _, _ = frames
    a = ([d[0] for d in depth], [c[0] for c in rgb])
    b = ([d[1] for d in depth], [c[1] for c in rgb])
    return _run(E2E, [a, a], 12), _run(E2E, [a, b], 12)


def test_identical_inputs_give_equal_trajectories(two_runs, frames):
    same, _ = two_runs
    ts, est = same.poses()
    assert est.shape == (2, 12, 4, 4) and len(ts) == 12 and np.isfinite(est).all()
    np.testing.assert_array_equal(est[0], est[1])
    assert same.keyframe_counts[0] == same.keyframe_counts[1] >= 3
    assert same.map_point_counts()[0] == same.map_point_counts()[1] > 100


def test_different_inputs_give_their_own_results(two_runs, frames):
    same, diff = two_runs
    _, _, _, rel = frames
    ts, est = diff.poses()
    assert np.abs(est[0][:, :3, 3] - est[1][:, :3, 3]).max() > 1e-2
    # sequence A does not depend on what runs beside it (1e-6: the batched
    # matrix products may take another path for another batch)
    np.testing.assert_allclose(est[0], same.poses()[1][0], atol=1e-6)
    ate = diff.ate_per_sequence(rel[:, :12])
    assert ate.shape == (2,) and (ate < 0.02).all(), ate
    assert (diff.state.lost == 0).all() and diff.state.frames == 12
    assert (diff.keyframe_counts >= 3).all()
    assert diff.map_point_counts()[0] != diff.map_point_counts()[1]
    assert [int(n) for n in diff.n_edges] == (diff.keyframe_counts - 1).tolist()
    assert tg.gn_reduce_batched.launches == 0 and th.gated_match.launches == 0  # CPU
    # BA moved keyframes, and poses() re-anchors the log to them
    raw = diff._traj[:, :12].numpy()
    assert np.abs(est - raw).max() > 1e-5


def test_lost_sequence_relocalizes_and_its_neighbour_does_not_notice(frames, two_runs):
    """Frame 6 of sequence B arrives with depth in a central window only: B
    falls under the inlier gate, relocalizes against its map (on the first
    lost frame of a streak, then every fourth) and tracks again; sequence A
    is as in the undamaged run."""
    depth, rgb, _, rel = frames
    a = ([d[0] for d in depth], [c[0] for c in rgb])
    b = ([d[1] for d in depth], [c[1] for c in rgb])
    bs = _run(E2E, [a, b], 12, damage=(6, 1))
    assert bs.state.lost[0] == 0 and bs.state.lost[1] >= 1
    assert bs.state.relocalized[0] == 0 and bs.state.relocalized[1] >= 1
    assert bs._lost_streak.tolist() == [0, 0]
    _, est = bs.poses()
    assert np.isfinite(est).all()
    np.testing.assert_allclose(est[0], two_runs[1].poses()[1][0], atol=1e-6)
    assert np.linalg.norm(est[1][-1, :3, 3] - rel[1, 11, :3, 3]) < 0.03
    assert bs.state.frames == 12


def test_forced_loop_close_end_to_end():
    """An out-and-back sweep under injected odometry drift at 160x120: the
    sweep sequence closes a loop and ends far more accurate than with the
    loop search off; the forward sequence beside it stays finite."""
    cam = CameraIntrinsics(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
    from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence

    n = 60
    drift = (0.012, 0.0, 0.006, 0.0, 0.006, 0.0)
    cfg = SLAMConfig(
        camera=cam, orb=ORBConfig(n_features=256, n_levels=4),
        icp=ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2), drift_xi=drift),
        keyframes=KeyframeConfig(max_keyframes=32, max_map_points=4096,
                                 kf_min_trans=0.02, kf_min_rot_deg=2.0,
                                 kf_min_gap_frames=6),
        ba=BAConfig(window=4, iters=3, loop_min_interval=3, loop_cooldown_kf=2),
    )
    sweep = SyntheticSequence(n, cam, step_t=0.015, step_r=0.012, sweep=True, device="cpu")
    fwd = SyntheticSequence(n, cam, step_t=0.015, step_r=0.012, device="cpu")
    fr = [(sweep.frame(i), fwd.frame(i)) for i in range(n)]
    seqs = [([f[b][1] for f in fr], [f[b][2] for f in fr]) for b in range(2)]
    gt = np.stack([sweep.groundtruth(), fwd.groundtruth()])
    on = _run(cfg, seqs, n)
    off = _run(dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, loop_min_score=2.0)),
               seqs[:1], n)
    assert on.state.loops[0] >= 1 and off.state.loops[0] == 0
    ate_on, ate_off = on.ate_per_sequence(gt), off.ate_per_sequence(gt[:1])
    assert np.isfinite(ate_on).all() and np.isfinite(on.poses()[1]).all()
    assert ate_on[0] < 0.6 * ate_off[0], (ate_on, ate_off)
    assert int(on.n_edges[0]) == on.keyframe_counts[0] - 1 + on.state.loops[0]


def test_traj_log_doubles_and_input_is_checked():
    bs = BatchSession(E2E, 2, device="cpu")
    bs._traj_cap = 2
    bs._traj = bs._traj[:, :2].clone()
    bs._traj_kfT = bs._traj_kfT[:, :2].clone()
    d = np.full((2, 96, 128), 1500, np.uint16)
    c = np.zeros((2, 96, 128, 3), np.uint8)
    for i in range(3):
        bs.process_frames(i / 30.0, d, c)
    assert bs._traj_cap == 4 and bs.poses()[1].shape == (2, 3, 4, 4)
    with pytest.raises(ValueError):
        bs.process_frames(0.1, d[:1], c[:1])
    with pytest.raises(ValueError):
        BatchSession(E2E, 0, device="cpu")


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchSession(CFG, 2)
