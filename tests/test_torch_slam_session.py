"""The keyframe and relocalization slice as a whole vs the JAX package, and
the feature stage it starts from.

One 12-frame 160x120 sweep. Keyframes are forced at the same frames on both
sides, at ground-truth poses, and both sides get the JAX feature stage's
output (descriptors flip bits under last-bit float differences, so
everything downstream of them is compared on the same numpy descriptors):
the JAX `_features_jit` + `_kf_insert_jit` against the port session's
`_insert_keyframe`. Then the relocalization solve on that map, and
`SLAMSession(device="cpu")` end to end with its own features.

The feature stage on a rendered 160x120 frame of the same camera, piece by
piece: pyramid, FAST / Harris / NMS maps, keypoints, descriptors, keypoint
depth, and the whole stage against `_features_jit`, the program the slice
compiles (one compile for the module). The stencil maps are compared on the
same input image and agree exactly (the same float32 operations in the same
order). The pyramid agrees to 1e-6 (two small matrix products a level,
summed in another order). Descriptors are compared on the keypoints of the
JAX run, with a stated bit floor: BRIEF bits flip under last-bit differences
of atan2 / cos / sin.

The JAX keyframes, the JAX feature pyramid and the port's own session run
on three threads started with the module.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.backend.pose_graph import EdgeList as JEdgeList
from slam_rgbd_tpu.core import camera as jcam
from slam_rgbd_tpu.core.config import (
    CameraIntrinsics, ICPConfig, KeyframeConfig, ORBConfig, SLAMConfig,
)
from slam_rgbd_tpu.features import detect as jdet
from slam_rgbd_tpu.features import orb as jorb
from slam_rgbd_tpu.io import synthetic as jsyn
from slam_rgbd_tpu.mapping import map as jmap
from slam_rgbd_tpu.runtime import session as jsess
from slam_rgbd_tpu_torch import SLAMSession, interop
from slam_rgbd_tpu_torch.core import se3 as tse3
from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse, load_trajectory_tum
from slam_rgbd_tpu_torch.features import detect as tdet
from slam_rgbd_tpu_torch.features import orb as torb
from slam_rgbd_tpu_torch.ops import hamming as th
from slam_rgbd_tpu_torch.runtime import session as tsess
from test_torch_priority import below_the_jax_files  # noqa: F401 (autouse)

torch.set_num_threads(1)

CAM = CameraIntrinsics(fx=142.6, fy=142.6, cx=79.5, cy=59.5, width=160, height=120)
CFG = SLAMConfig(
    camera=CAM,
    icp=ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2), backend="xla"),
    orb=ORBConfig(n_features=256),
    # kf_min_trans 3 cm: a keyframe every few frames of the ~1.3 cm/frame orbit
    keyframes=KeyframeConfig(max_keyframes=8, max_map_points=1024, kf_min_trans=0.03),
)
N = 12
KF_FRAMES = (0, 3, 6, 9)
MAP_FIELDS = [f.name for f in dataclasses.fields(tsess.smap.MapState)]
ORB = ORBConfig(n_features=256)  # the feature tests' stage: CFG's
assert ORB == CFG.orb  # so `_features_jit` compiles once for the module


@pytest.fixture(scope="module")
def frames():
    gt = jsyn.orbit_trajectory(N, sweep=True)
    out = []
    for i, p in enumerate(gt):
        d, c = jsyn.render_frame(jnp.asarray(p), CAM)
        out.append((i / 30.0, np.array(d), np.array(c)))
    rel = np.linalg.inv(gt[0]) @ gt  # poses in the first camera's frame
    return out, gt, rel.astype(np.float32)


@pytest.fixture(scope="module")
def frame():
    """The feature tests' frame: the fourth pose of a 4-frame sweep."""
    pose = jsyn.orbit_trajectory(4, sweep=True)[3]
    depth, rgb = (np.array(x) for x in jsyn.render_frame(jnp.asarray(pose), CAM))
    intensity = np.asarray(jcam.rgb_to_intensity(jnp.asarray(rgb)) / 255.0)
    return depth, rgb, intensity


@pytest.fixture(scope="module")
def started(frames, frame):
    """The module's three long computations, on threads from the start:
    -> futures of the JAX keyframes, the JAX feature pyramid and the port's
    session over the sweep."""
    with ThreadPoolExecutor(max_workers=3) as pool:
        yield {"keyframes": pool.submit(_jax_keyframes, frames),
               "features": pool.submit(_jax_features, frame),
               "session": pool.submit(_cpu_session, frames)}


@pytest.fixture(scope="module")
def jax_keyframes(started):
    return started["keyframes"].result(timeout=600)


@pytest.fixture(scope="module")
def jax_features(started):
    return started["features"].result(timeout=600)


def _jax_features(frame):
    _, _, intensity = frame
    kp, pyr = jdet.detect_pyramid(jnp.asarray(intensity), n_features=ORB.n_features)
    return kp, pyr, jorb.describe(kp, pyr)


def _jax_keyframes(frames):
    """The reference: features + insert at the forced frames, no backend
    pass. -> per keyframe (features as numpy, map, edges, n_edges, last_kf_T)."""
    seq, _, rel = frames
    m = jmap.empty_map(CFG.keyframes, CFG.orb.n_features)
    edges, n_edges = JEdgeList.empty(4 * CFG.keyframes.max_keyframes), jnp.int32(0)
    steps = []
    for k, i in enumerate(KF_FRAMES):
        ts, d, c = seq[i]
        kp, desc, pts, ok = jsess._features_jit(jnp.asarray(d), jnp.asarray(c), CFG.orb, CAM)
        m, edges, n_edges, last_kf_T, _ = jsess._kf_insert_jit(
            m, edges, n_edges, kp.uv, desc.signs, pts, ok, jnp.asarray(rel[i]),
            jnp.float32(ts), np.int32(k - 1), np.int32(k), CFG, "xla")
        steps.append(dict(kp=kp, desc=desc, pts=np.asarray(pts), ok=np.asarray(ok),
                          map=m, edges=edges, n_edges=int(n_edges),
                          last_kf_T=np.asarray(last_kf_T)))
    return steps


def _jax_features_on(sess, step):
    """Make the port session's feature stage return the JAX run's output."""
    out = (interop.keypoints_from_numpy(step["kp"], "cpu"),
           interop.descriptors_from_numpy(step["desc"], "cpu"),
           torch.tensor(step["pts"]), torch.tensor(step["ok"]))
    sess._features = lambda depth, rgb: out


def _assert_state_equal(sess, step):
    got = interop.map_to_numpy(sess.map)
    for name in MAP_FIELDS:
        want = np.asarray(getattr(step["map"], name))
        assert got[name].dtype == want.dtype, name
        if want.dtype == np.float32:
            np.testing.assert_allclose(got[name], want, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)
    edges = interop.edges_to_numpy(sess.edges)
    for name, g in edges.items():
        want = np.asarray(getattr(step["edges"], name))
        if want.dtype == np.float32:
            np.testing.assert_allclose(g, want, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, want, err_msg=name)
    assert int(sess.n_edges) == step["n_edges"]
    np.testing.assert_allclose(sess.last_kf_T.numpy(), step["last_kf_T"], atol=1e-6)


def test_keyframe_slice_matches_kf_insert_jit(frames, jax_keyframes):
    """Map fields, edges and last_kf_T after every forced keyframe: integers
    and masks exactly, floats to 1e-6. The association runs for real on both
    sides (XLA branch there, plain gated match here)."""
    seq, _, rel = frames
    sess = SLAMSession(CFG, device="cpu")
    for k, i in enumerate(KF_FRAMES):
        ts, d, c = seq[i]
        _jax_features_on(sess, jax_keyframes[k])
        sess._insert_keyframe(ts, sess._upload(d), sess._upload(c), torch.tensor(rel[i]))
        _assert_state_equal(sess, jax_keyframes[k])
    last = jax_keyframes[-1]["map"]
    assert sess.state.keyframes == len(KF_FRAMES) == int(last.n_kf)
    # the association really matched: later keyframes reobserve points
    assert int(np.asarray(last.pt_nobs).max()) >= 3
    assert int(sess.n_edges) == len(KF_FRAMES) - 1
    ts_kf, T_kf = sess.keyframe_poses()
    np.testing.assert_allclose(ts_kf, [seq[i][0] for i in KF_FRAMES], atol=1e-6)
    np.testing.assert_allclose(T_kf, rel[list(KF_FRAMES)], atol=1e-6)
    assert sess.map_point_count() == int(jmap.map_point_count(last))


def test_state_from_numpy_carries_the_map(frames, jax_keyframes):
    """The JAX map and edges after three keyframes loaded into a fresh port
    session: the fourth insert lands on the JAX state."""
    seq, _, rel = frames
    prev = jax_keyframes[2]
    sess = SLAMSession(CFG, device="cpu")
    eye = np.eye(4, dtype=np.float32)
    interop.state_from_numpy(
        sess, T_world=rel[8], motion=eye, last_kf_T=prev["last_kf_T"],
        map=prev["map"], edges=prev["edges"], n_edges=prev["n_edges"])
    assert sess.state.keyframes == 3 and sess.last_kf_idx == 2
    ts, d, c = seq[KF_FRAMES[3]]
    _jax_features_on(sess, jax_keyframes[3])
    sess._insert_keyframe(ts, sess._upload(d), sess._upload(c), torch.tensor(rel[KF_FRAMES[3]]))
    _assert_state_equal(sess, jax_keyframes[3])


@pytest.mark.parametrize("frame_i", [4, 7])
def test_reloc_matches_reloc_jit(frames, jax_keyframes, frame_i):
    """The relocalization solve on the same map and descriptors, from an
    estimate off by 5 cm / 2 deg: both accept, inliers agree (+-2: other
    minimal triples, a residual on the threshold) and T to 1e-4."""
    seq, _, rel = frames
    ts, d, c = seq[frame_i]
    kp, desc, pts, ok = jsess._features_jit(jnp.asarray(d), jnp.asarray(c), CFG.orb, CAM)
    off = np.asarray(tse3.exp(torch.tensor([0.05, 0.0, 0.0, 0.0, 0.035, 0.0])))
    T_est = rel[frame_i] @ off
    m_j = jax_keyframes[-1]["map"]
    Tj, Cj, sj = jsess._reloc_jit(m_j, desc.signs, ok, pts, jnp.asarray(T_est), CFG, "xla")
    Tt, Ct, st = tsess._reloc(
        interop.map_from_numpy(m_j, "cpu"), torch.tensor(np.asarray(desc.signs)),
        torch.tensor(np.asarray(ok)), torch.tensor(np.asarray(pts)),
        torch.tensor(T_est), CFG)
    sj, st = np.asarray(sj), st.numpy()
    assert sj[0] == st[0] == 1.0
    assert abs(sj[1] - st[1]) <= 2 and sj[2] == st[2] > 20
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=1e-4)
    # and it really relocalizes: within 2 cm of the true pose
    assert np.linalg.norm(Tt.numpy()[:3, 3] - rel[frame_i][:3, 3]) < 0.02


def _cpu_session(frames):
    seq, _, _ = frames
    sess = SLAMSession(CFG, device="cpu")
    for f in seq:
        sess.process_frame(*f)
    sess.flush_pipeline()
    return sess


@pytest.fixture(scope="module")
def cpu_session(started):
    return started["session"].result(timeout=600)


def test_session_end_to_end_on_cpu(frames, cpu_session):
    seq, gt, _ = frames
    sess = cpu_session
    assert sess.state.frames == N and sess.state.lost == 0
    assert sess.state.keyframes > 1 and sess.state.keyframes == sess._n_kf_host
    assert 0 < sess.map_point_count() < CFG.keyframes.max_map_points
    assert int(sess.map.pt_dropped) == 0 and int(sess.map.n_kf) == sess.state.keyframes
    assert int(sess.n_edges) == sess.state.keyframes - 1
    assert th.gated_match.launches == 0 and th.hamming_top2.launches == 0  # CPU: plain
    ts, T = sess.poses()
    assert T.shape == (N, 4, 4) and np.isfinite(T).all()
    # the inline backend moved keyframes: each frame is its logged pose
    # re-anchored on its reference keyframe's current pose
    raw = sess._traj_T[:N].numpy()
    kf_then = sess._traj_kfT[:N].numpy()
    kf_now = sess.map.kf_pose.numpy()[np.maximum(sess._frame_kf_idx, 0)]
    want = np.where((np.asarray(sess._frame_kf_idx) >= 0)[:, None, None],
                    kf_now @ np.linalg.inv(kf_then) @ raw, raw)
    np.testing.assert_allclose(T, want, atol=1e-5)
    assert sess.state.keyframes >= 3 and np.abs(kf_now - kf_then).max() > 1e-5
    assert ate_rmse(T, gt)[0] < 0.01
    kf_flags = [s.is_keyframe for s in sess.stats]
    assert sum(kf_flags) == sess.state.keyframes and kf_flags[0]
    # later keyframes reobserve the map
    assert int(sess.map.pt_nobs.max()) >= 2


def test_keyframe_trajectory_export(tmp_path, cpu_session):
    sess = cpu_session
    path = tmp_path / "kf.txt"
    sess.save_keyframe_trajectory(str(path))
    ts, T = load_trajectory_tum(str(path))
    ts_kf, T_kf = sess.keyframe_poses()
    assert len(ts) == sess.state.keyframes
    np.testing.assert_allclose(ts, ts_kf, atol=1e-6)
    np.testing.assert_allclose(T, T_kf, atol=1e-5)


@pytest.mark.parametrize("frame_i", [5, 10])
def test_relocalize_recovers_offset_estimate(frames, cpu_session, frame_i):
    """`_relocalize` from an estimate off by 5 cm / 2 deg comes back within
    2 cm of the session's own pose of that frame."""
    seq, _, _ = frames
    sess = cpu_session
    own = sess.poses()[1][frame_i]
    off = tse3.exp(torch.tensor([0.05, 0.0, 0.0, 0.0, 0.035, 0.0]))
    T_est = torch.tensor(own) @ off
    T_fixed, C = sess._relocalize(seq[frame_i][1], seq[frame_i][2], T_est=T_est)
    assert T_fixed is not None
    assert np.linalg.norm(T_fixed.numpy()[:3, 3] - own[:3, 3]) < 0.02
    np.testing.assert_allclose((C @ T_est).numpy(), T_fixed.numpy(), atol=1e-5)


def test_blanked_depth_frame_is_lost_not_fatal(frames):
    """A frame without depth: lost >= 1, a relocalization attempt, no crash,
    and tracking is back on the frames after it."""
    seq, _, _ = frames
    sess = SLAMSession(CFG, device="cpu")
    for i, (ts, d, c) in enumerate(seq[:8]):
        sess.process_frame(ts, np.zeros_like(d) if i == 4 else d, c)
    sess.flush_pipeline()
    assert sess.state.frames == 8 and sess.state.lost >= 1
    assert not sess.stats[4].is_keyframe
    assert sess.stats[-1].tracking_ok
    assert np.isfinite(sess.poses()[1]).all()


def test_relocalization_corrects_the_trajectory(frames, cpu_session):
    """A lost frame that relocalizes: the correction lands on the live pose,
    the logged poses since the lost frame and the pending estimates."""
    seq, _, _ = frames
    sess = SLAMSession(CFG, device="cpu")
    for f in seq[:7]:
        sess.process_frame(*f)
    sess.flush_pipeline()
    good = sess.T_world.clone()
    before = sess._traj_T[5].clone()
    off = tse3.exp(torch.tensor([0.05, 0.0, 0.0, 0.0, 0.035, 0.0]))
    bad = good @ off
    sess.T_world = bad
    sess._traj_T[6] = bad
    entry = tsess._PendingFrame(
        summary=torch.tensor([0.1, 0.0, 1.0, 0.0]), event=None, st=sess.stats[6],
        ts=seq[6][0], depth_raw=sess._upload(seq[6][1]), rgb=sess._upload(seq[6][2]),
        traj_i=6, frame_i=6, T=bad)
    sess._resolve_entry(entry)
    assert sess.state.lost == 1 and sess.state.relocalized == 1
    assert sess.stats[6].tracking_ok
    assert np.linalg.norm((sess.T_world - good).numpy()[:3, 3]) < 0.02
    assert np.linalg.norm((sess._traj_T[6] - good).numpy()[:3, 3]) < 0.02
    # the frame before the lost one keeps its logged pose
    np.testing.assert_allclose(sess._traj_T[5].numpy(), before.numpy(), atol=1e-5)


def test_warmup_leaves_a_fresh_session():
    small = dataclasses.replace(
        CFG, camera=CameraIntrinsics(fx=114.1, fy=114.1, cx=63.5, cy=47.5,
                                     width=128, height=96))
    sess = SLAMSession(small, device="cpu")
    sess.warmup()
    assert sess.state.frames == 0 and sess.state.keyframes == 0
    assert sess.map_point_count() == 0 and len(sess.poses()[0]) == 0


def test_default_device_is_cuda_and_raises_without_one():
    from slam_rgbd_tpu_torch.__main__ import main
    from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence

    if torch.cuda.is_available():
        pytest.skip("checks a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        SLAMSession(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticSequence(2, CAM)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["run", "synthetic:2"])


def test_cuda_graph_on_the_cpu_raises_and_the_eager_step_is_its_path():
    """The frame graph is for a CUDA device: asked for on the CPU it raises;
    the CPU's session runs the eager step (no graph)."""
    with pytest.raises(ValueError, match="cuda_graph"):
        SLAMSession(CFG, device="cpu", cuda_graph=True)
    assert SLAMSession(CFG, device="cpu")._graph is None
    assert SLAMSession(CFG, device="cpu", cuda_graph=False)._graph is None


# ---- the feature stage --------------------------------------------------------
def test_level_shapes_and_budgets_match_jax():
    for h, w, k in ((480, 640, 1024), (120, 160, 256), (96, 128, 100)):
        assert tdet._level_shapes(h, w, 8, 1.2) == jdet._level_shapes(h, w, 8, 1.2)
        assert tdet._per_level_budget(k, 8, 1.2) == jdet._per_level_budget(k, 8, 1.2)
        assert sum(tdet._per_level_budget(k, 8, 1.2)) == k


def test_pyramid_levels_match_jax(frame, jax_features):
    _, pyr_j, _ = jax_features
    pyr_t = tdet.build_pyramid(torch.tensor(frame[2]), 8, 1.2)
    assert len(pyr_t) == len(pyr_j) == 8
    for a, b in zip(pyr_t, pyr_j):
        assert tuple(a.shape) == b.shape
        # antialiased linear resize, level from level: 1e-6 after 7 resizes
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("level", [0, 2, 5])
def test_fast_harris_nms_maps_match_jax(jax_features, level):
    x = np.asarray(jax_features[1][level]) * 255.0
    xt, xj = torch.tensor(x), jnp.asarray(x)
    for thresh in (20.0, 7.0):
        corner_t, score_t = tdet.fast_score(xt, thresh)
        corner_j, score_j = jdet.fast_score(xj, thresh)
        np.testing.assert_array_equal(corner_t.numpy(), np.asarray(corner_j))
        np.testing.assert_array_equal(score_t.numpy(), np.asarray(score_j))
    assert int(corner_t.sum()) > 20
    harris_j = np.asarray(jdet.harris_response(xj))
    np.testing.assert_array_equal(tdet.harris_response(xt).numpy(), harris_j)
    np.testing.assert_array_equal(
        tdet.nms_mask(torch.tensor(harris_j)).numpy(),
        np.asarray(jdet.nms_mask(jnp.asarray(harris_j))))
    # the blur of the descriptor stage wraps at the border alike
    np.testing.assert_array_equal(torb.smooth(xt).numpy(), np.asarray(jorb.smooth(xj)))


def test_detect_level_on_jax_pyramid_is_exact(jax_features):
    """On the same level image every response is the same float, so the
    stable sort returns top_k's order, ties included."""
    img = np.asarray(jax_features[1][1])
    uv_t, resp_t, valid_t = tdet.detect_level(torch.tensor(img), 60, 20.0, 7.0)
    uv_j, resp_j, valid_j = jdet.detect_level(jnp.asarray(img), 60, 20.0, 7.0)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(resp_t.numpy(), np.asarray(resp_j))


def test_detect_level_ties_take_the_lower_index():
    """A periodic image has exact plateaus of the response: the lower pixel
    index comes first, as `jax.lax.top_k` orders them."""
    yy, xx = np.meshgrid(np.arange(96), np.arange(128), indexing="ij")
    img = (((xx % 16 < 6) & (yy % 16 < 6)) * 0.6 + 0.2).astype(np.float32)  # squares
    uv_t, _, valid_t = tdet.detect_level(torch.tensor(img), 64, 20.0, 7.0)
    uv_j, _, valid_j = jdet.detect_level(jnp.asarray(img), 64, 20.0, 7.0)
    assert int(valid_t.sum()) > 8
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))


def test_keypoints_match_jax(frame, jax_features):
    kp_j = jax_features[0]
    kp_t, _ = tdet.detect_pyramid(torch.tensor(frame[2]), n_features=ORB.n_features)
    np.testing.assert_array_equal(kp_t.level.numpy(), np.asarray(kp_j.level))
    valid_j = np.asarray(kp_j.valid)
    # levels >= 1 differ by <= 3e-7 in intensity: a response near a tie or a
    # threshold may change rank, on at most 5% of the keypoints
    assert (kp_t.valid.numpy() != valid_j).mean() <= 0.02
    same = (kp_t.uv.numpy() == np.asarray(kp_j.uv)).all(axis=1)
    assert same[valid_j].mean() >= 0.95
    first = tdet._per_level_budget(ORB.n_features, 8, 1.2)[0]
    assert same[:first].all()  # level 0 is the input itself: exact
    np.testing.assert_allclose(kp_t.response.numpy()[same], np.asarray(kp_j.response)[same],
                               rtol=1e-4, atol=1e-3)
    assert kp_t.uv.dtype == torch.float32 and kp_t.level.dtype == torch.int32


def test_descriptors_on_jax_keypoints(jax_features):
    """Bit floor: >= 99% of all bits equal and every valid keypoint within
    Hamming 8 of its JAX descriptor; orientation to 1e-3 rad."""
    kp_j, pyr_j, desc_j = jax_features
    kp_t = interop.keypoints_from_numpy(kp_j, "cpu")
    desc_t = torb.describe(kp_t, tuple(torch.tensor(np.asarray(p)) for p in pyr_j))
    valid = np.asarray(kp_j.valid)
    ham = (desc_t.signs.numpy() != np.asarray(desc_j.signs)).sum(axis=1)
    assert ham[valid].sum() <= 0.01 * valid.sum() * 256
    assert ham[valid].max() <= 8
    np.testing.assert_allclose(desc_t.angle.numpy()[valid], np.asarray(desc_j.angle)[valid],
                               atol=1e-3)
    agree = ham == 0
    np.testing.assert_array_equal(desc_t.packed.numpy().view(np.uint32)[agree],
                                  np.asarray(desc_j.packed)[agree])
    assert set(np.unique(desc_t.signs.numpy())) == {-1, 1}
    back = interop.descriptors_from_numpy(desc_j, "cpu")
    np.testing.assert_array_equal(back.packed.numpy().view(np.uint32), np.asarray(desc_j.packed))


def test_extract_patches_edge_rule_matches_jax(rng):
    """Taps outside the image weigh zero (not clamped), also for keypoints
    hanging over the border."""
    img = rng.random((40, 50)).astype(np.float32)
    uv = np.array([[20.3, 18.7], [2.2, 3.9], [48.6, 38.1], [-4.0, 20.0], [25.0, 44.5]],
                  np.float32)
    got = torb.extract_patches(torch.tensor(img), torch.tensor(uv)).numpy()
    want = np.asarray(jorb.extract_patches(jnp.asarray(img), jnp.asarray(uv)))
    np.testing.assert_allclose(got, want, atol=1e-6)  # the product may fuse a*b+c
    assert (got[1, 0, :] == 0).all() and (got[0] > 0).all()
    np.testing.assert_allclose(
        torb.orientation(torch.tensor(want)).numpy(),
        np.asarray(jorb.orientation(jnp.asarray(want))), atol=1e-5)


def test_brief_pattern_is_the_same():
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())


def test_keypoint_depth_matches_jax(frame, jax_features):
    kp_j = jax_features[0]
    depth_m = np.asarray(jcam.depth_to_metres(jnp.asarray(frame[0]), CAM))
    pts_j, ok_j = jorb.keypoint_depth(kp_j, jnp.asarray(depth_m), CAM)
    pts_t, ok_t = torb.keypoint_depth(interop.keypoints_from_numpy(kp_j, "cpu"),
                                      torch.tensor(depth_m), CAM)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))
    assert 0 < int(ok_t.sum()) < len(ok_t)


def test_feature_stage_matches_features_jit(frame):
    """The session's whole feature stage from raw depth and rgb."""
    depth, rgb, _ = frame
    kp_j, desc_j, pts_j, ok_j = jsess._features_jit(
        jnp.asarray(depth), jnp.asarray(rgb), ORB, CAM)
    kp_t, desc_t, pts_t, ok_t = tsess._features(
        torch.tensor(depth.astype(np.int32)), torch.tensor(rgb), ORB, CAM)
    same = (kp_t.uv.numpy() == np.asarray(kp_j.uv)).all(axis=1)
    both = same & np.asarray(ok_j) & ok_t.numpy()
    assert both.sum() >= 0.9 * np.asarray(ok_j).sum()
    np.testing.assert_allclose(pts_t.numpy()[both], np.asarray(pts_j)[both], atol=1e-6)
    ham = (desc_t.signs.numpy() != np.asarray(desc_j.signs)).sum(axis=1)
    assert ham[both].max() <= 8 and ham[both].mean() <= 1.0
