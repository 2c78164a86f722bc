"""The port on a CUDA card: the hand-written kernels (`gn_reduce`,
`gated_match`, `hamming_top2`) against their plain torch versions, and the
session on the card against the same session on the CPU.

Every test here needs a card and skips without one. The file imports no jax
(the machine with the card has none), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from slam_rgbd_tpu_torch import SLAMSession
from slam_rgbd_tpu_torch.core.config import (
    CameraIntrinsics, ICPConfig, KeyframeConfig, ORBConfig, SLAMConfig,
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


@pytest.mark.cuda
@pytest.mark.parametrize("k1,k2", [(1024, 16384), (16384, 1024), (100, 333)])
def test_hamming_top2_kernel_matches_reference_on_card(cuda_device, k1, k2):
    """All three outputs equal the plain version's exactly (distances are
    integers, ties go to the first index), twice alike."""
    rng = np.random.default_rng(k1 + k2)
    s1, v1, s2, v2, _ = _descriptor_sets(rng, k1, k2)
    v1[3] = True
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
    assert (best[~v1] == 1e9).all() and (idx[~v1] == 0).all()
    assert (best[v1] < 1e9).all() and (best <= second).all()
    m = th.match_kernel(*args)
    assert int(m.valid.sum()) > 0 and not bool(m.valid[~args[1]].any())


@pytest.mark.cuda
@pytest.mark.parametrize("k1,k2", [(1024, 16384), (100, 333)])
@pytest.mark.parametrize("merge_radius", [0.05, -1.0])
def test_gated_match_kernel_matches_reference_on_card(cuda_device, k1, k2,
                                                      merge_radius):
    """d1, i1, d2, i2 equal the plain version's exactly: the gate arithmetic
    rounds alike in both (no contraction), so no margin is needed."""
    rng = np.random.default_rng(k1 + k2)
    s1, v1, s2, v2, src = _descriptor_sets(rng, k1, k2)
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
    d1, _, d2, i2 = (x.cpu().numpy() for x in out)
    assert (d1 < 64).sum() > k1 // 8  # the gates let real matches through
    if merge_radius < 0:
        assert (d2 == 1e9).all() and (i2 == 0).all()
    else:
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
    own launches: 42 `gn_reduce` a tracked frame and one `gated_match` a
    keyframe insert that had a map on the card, none on the CPU; no frame
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
    counters = (tg.gn_reduce, th.gated_match, th.hamming_top2)
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
            assert launched == [0, 0, 0]
        else:
            assert launched == [42 * (len(frames) - 1), sess.state.keyframes - 1, 0]
        out[str(dev)] = T
        sessions[str(dev)] = sess
    np.testing.assert_allclose(out[str(cuda_device)], out["cpu"], atol=1e-4)
    a, b = sessions["cpu"], sessions[str(cuda_device)]
    assert a.state.keyframes == b.state.keyframes
    na, nb = a.map_point_count(), b.map_point_count()
    assert na > 0 and abs(na - nb) <= 0.05 * na


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
