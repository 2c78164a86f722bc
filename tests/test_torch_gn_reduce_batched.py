"""The port's batched GN reduction and batched tracker vs the JAX package.

`gn_reduce_batched_reference` (the plain version the CPU wrapper takes) is
held against `ops.icp_pallas.gn_reduce_batched` in interpret mode, on the
scenes of `tests/test_icp_pallas.py:105`, and per problem against the port's
single plain version (exactly). `icp_align_batched` / `track_frame_batched`
are held against the JAX ones on their kernel path (`backend="pallas"`, the
batched kernel in interpret mode) at 128x96 with two pyramid levels. The CUDA
kernel is held against the plain version in `tests/test_torch_cuda.py`,
which needs a card.

Tolerances: the reductions sum the same float32 terms in different orders,
so H and g are compared relative to their largest entry (atol 2e-6 and 5e-5,
as `tests/test_icp_pallas.py:60-71`), sq_sum by rtol 1e-4, inlier counts
exactly; poses after the GN iterations to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.core import camera as jcam
from slam_rgbd_tpu.core.config import CameraIntrinsics, ICPConfig
from slam_rgbd_tpu.io import synthetic as jsyn
from slam_rgbd_tpu.odometry import icp as jicp
from slam_rgbd_tpu.ops import icp_pallas as ip
from slam_rgbd_tpu_torch.interop import pyramid_from_numpy
from slam_rgbd_tpu_torch.odometry import icp as ticp
from slam_rgbd_tpu_torch.ops import gn_reduce as tg

# one intra-op thread: torch's spinning thread pool would otherwise take
# every core from the test workers running beside this one
torch.set_num_threads(1)

CAM_K = CameraIntrinsics(fx=120.0, fy=120.0, cx=127.5, cy=63.5, width=256, height=128)
RADIUS = 2
CFG_K = ICPConfig(levels=1, iters=(2,), window_px=(RADIUS,))


def _level(cam, shift, seed):
    """Source / target levels (numpy dicts) of a textured surface with a
    hole; the source is the target rolled by `shift`."""
    h, w = cam.height, cam.width
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    depth = (1400 + 320 * np.sin(u / 15.0 + seed) + 240 * np.cos(v / 11.0)).astype(np.uint16)
    depth[h // 4: h // 4 + 6, w // 3: w // 3 + 20] = 0
    rgb = ((128 + 90 * np.sin(u / 5.0 + seed) * np.cos(v / 7.0))
           .clip(0, 255).astype(np.uint8)[..., None].repeat(3, -1))

    def level(d, c):
        pyr = jcam.build_frame_pyramid(jnp.asarray(d), cam, levels=1, rgb=jnp.asarray(c))
        return jax.tree.map(np.array, pyr[0])

    return level(np.roll(depth, shift, (0, 1)), np.roll(rgb, shift, (0, 1))), level(depth, rgb)


@pytest.fixture(scope="module")
def problems():
    """Two problems with other scenes, poses and flow shifts."""
    Ts = np.stack([np.eye(4, dtype=np.float32)] * 2)
    Ts[0, 0, 3] = 0.01
    Ts[1, 1, 3], Ts[1, 2, 3] = -0.008, 0.004
    mus = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
    levels = [_level(CAM_K, (i + 1, 2 - i), 10 + i) for i in range(2)]
    return Ts, mus, levels


def _port_inputs(Ts, mus, levels):
    srcs, tgts = [], []
    for src, tgt in levels:
        (s,), (t,) = pyramid_from_numpy([src], "cpu"), pyramid_from_numpy([tgt], "cpu")
        srcs.append(ticp.level_planes(s)[: tg.SRC_CHANNELS])
        tgts.append(ticp.level_planes(t))
    return (torch.from_numpy(Ts), torch.from_numpy(mus),
            torch.stack(srcs).contiguous(), torch.stack(tgts).contiguous())


def test_batched_reference_matches_pallas_batched(problems):
    Ts, mus, levels = problems
    h, w = CAM_K.height, CAM_K.width
    th, n_tiles, w_pad = ip.plan_tiles(h, w, RADIUS)
    scal, srcp, tgtp = [], [], []
    for T, mu, (src, tgt) in zip(Ts, mus, levels):
        mu_u, mu_v = jnp.int32(mu[0]), jnp.int32(mu[1])
        scal.append(ip.pack_scalars(jnp.asarray(T), mu_u, mu_v))
        srcp.append(ip.build_source_planes(jax.tree.map(jnp.asarray, src), th, n_tiles, w_pad))
        tgtp.append(ip.build_target_planes(
            jax.tree.map(jnp.asarray, tgt), mu_u, mu_v, RADIUS, th, n_tiles, w_pad))
    want = ip.gn_reduce_batched(
        jnp.concatenate(scal), jnp.stack(srcp), jnp.stack(tgtp), CAM_K, CFG_K,
        RADIUS, (h, w), interpret=True)
    got = tg.gn_reduce_batched(*_port_inputs(Ts, mus, levels), CAM_K, CFG_K, RADIUS)
    assert [tuple(x.shape) for x in got] == [(2, 6, 6), (2, 6), (2,), (2,)]
    assert got[2].dtype == torch.int32
    H1, g1, i1, s1 = (x.numpy() for x in got)
    H0, g0, i0, s0 = (np.asarray(x) for x in want)
    assert i1.tolist() == i0.tolist() and i1.min() > 1000 and i1[0] != i1[1]
    for b in range(2):
        h_scale = max(1.0, float(np.abs(H0[b]).max()))
        np.testing.assert_allclose(H1[b] / h_scale, H0[b] / h_scale, atol=2e-6)
        g_scale = max(1.0, float(np.abs(g0[b]).max()))
        np.testing.assert_allclose(g1[b] / g_scale, g0[b] / g_scale, atol=5e-5)
    np.testing.assert_allclose(s1, s0, rtol=1e-4)


def test_batched_reference_equals_single_per_problem(problems):
    """Problem b of the batched plain version is the single plain version on
    its slice, bit for bit, whatever else the batch holds (the contract the
    CUDA kernel keeps on the card); on the CPU the wrapper takes the plain
    version and counts no launch."""
    T, mu, src, tgt = _port_inputs(*problems)
    before = tg.gn_reduce_batched.launches, tg.gn_reduce.launches
    got = tg.gn_reduce_batched(T, mu, src, tgt, CAM_K, CFG_K, RADIUS)
    flipped = tg.gn_reduce_batched(T.flip(0).contiguous(), mu.flip(0).contiguous(),
                                   src.flip(0).contiguous(), tgt.flip(0).contiguous(),
                                   CAM_K, CFG_K, RADIUS)
    assert (tg.gn_reduce_batched.launches, tg.gn_reduce.launches) == before
    for b in range(2):
        single = tg.gn_reduce_reference(T[b], mu[b], src[b], tgt[b], CAM_K, CFG_K, RADIUS)
        for a, f, c in zip(got, flipped, single):
            assert torch.equal(a[b], c) and torch.equal(f[1 - b], c)


def test_batched_wrapper_rejects_bad_input(problems):
    T, mu, src, tgt = _port_inputs(*problems)
    for bad in ((T[0], mu, src, tgt), (T, mu[:1], src, tgt), (T, mu, src[0], tgt),
                (T, mu, src, tgt[:, :8]), (T.double(), mu, src, tgt),
                (T, mu, src[:, :, ::2], tgt[:, :, ::2])):
        with pytest.raises(ValueError):
            tg.gn_reduce_batched(*bad, CAM_K, CFG_K, RADIUS)
    with pytest.raises(ValueError):
        tg.gn_reduce_batched(T, mu, src, tgt, CAM_K, CFG_K, -1)


# ---- the batched tracker ---------------------------------------------------

CAM = CameraIntrinsics(fx=114.1, fy=114.1, cx=63.5, cy=47.5, width=128, height=96)
# max_step_m 1 cm: problem 1 (consecutive orbit frames, ~1.4 cm) is clamped,
# problems 0 and 2 (rolled copies, ~6 mm) are kept
CFG = ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2), backend="pallas",
                max_step_m=0.01)


@pytest.fixture(scope="module")
def batch():
    """Three problems: (0) a frame against its rolled copy from a small
    prior; (1) two consecutive orbit frames, a step the clamp rejects;
    (2) the rolled pair from a prior rolled about the optical axis, so that
    another start than the prior wins the coarse level."""
    poses = jsyn.orbit_trajectory(5)
    fr = [tuple(np.array(x) for x in jsyn.render_frame(jnp.asarray(p), CAM))
          for p in poses[3:5]]
    d, c = fr[0]
    rolled = (np.roll(d, (1, 2), (0, 1)), np.roll(c, (1, 2), (0, 1)))

    def pyr(depth, rgb):
        return jcam.build_frame_pyramid(jnp.asarray(depth), CAM, levels=2,
                                        rgb=jnp.asarray(rgb))

    prev = [pyr(*fr[0]), pyr(*fr[0]), pyr(*fr[0])]
    curr = [pyr(*rolled), pyr(*fr[1]), pyr(*rolled)]
    prior = np.stack([np.eye(4, dtype=np.float32)] * 3)
    prior[0, 0, 3] = 0.002
    prior[1, 0, 3] = 0.002
    # a roll of 0.3 rad about the optical axis, which no flow shift absorbs
    prior[2, :2, :2] = [[np.cos(0.3), -np.sin(0.3)], [np.sin(0.3), np.cos(0.3)]]
    stack = lambda ps: jax.tree.map(lambda *xs: jnp.stack(xs), *ps)
    prev_j, curr_j = stack(prev), stack(curr)
    to_port = lambda p: pyramid_from_numpy(jax.tree.map(np.array, p), "cpu")
    return prev_j, curr_j, to_port(prev_j), to_port(curr_j), prior


def test_track_frame_batched_matches_jax(batch):
    prev_j, curr_j, prev_t, curr_t, prior = batch
    T_prev = np.stack([jsyn.orbit_trajectory(4)[3]] * 3)
    Tw_j, Tm_j, res_j = jicp.track_frame_batched(
        prev_j, curr_j, jnp.asarray(T_prev), jnp.asarray(prior), CAM, CFG)
    Tw_t, Tm_t, res_t = ticp.track_frame_batched(
        prev_t, curr_t, torch.from_numpy(T_prev), torch.from_numpy(prior), CAM, CFG)
    np.testing.assert_allclose(Tw_t.numpy(), np.asarray(Tw_j), atol=1e-5)
    np.testing.assert_allclose(Tm_t.numpy(), np.asarray(Tm_j), atol=1e-5)
    assert res_t.inliers.tolist() == np.asarray(res_j.inliers).tolist()
    np.testing.assert_allclose(res_t.valid_fraction.numpy(),
                               np.asarray(res_j.valid_fraction), atol=1e-6)
    np.testing.assert_allclose(res_t.rmse.numpy(), np.asarray(res_j.rmse), rtol=1e-3)
    # problem 1: the clamp rejected the step, per problem
    assert torch.equal(Tm_t[1], torch.eye(4)) and float(res_t.valid_fraction[1]) == 0.0
    assert float(res_t.valid_fraction[0]) > 0.8 and float(res_t.valid_fraction[2]) > 0.8
    assert 0.002 < float(torch.linalg.norm(Tm_t[0, :3, 3])) < CFG.max_step_m


def test_icp_align_batched_matches_jax_and_single(batch, monkeypatch):
    """`icp_align_batched` against the JAX one, one `gn_step_batched` call
    per GN iteration for all problems (4 + 3): at the coarsest level the
    3 starts x 3 sequences as nine problems over the three plane sets, then
    three problems; and each problem against the port's own single
    `icp_align` (1e-6: the same arithmetic, batched matrix products)."""
    prev_j, curr_j, prev_t, curr_t, prior = batch
    want = jicp.icp_align_batched(curr_j, prev_j, jnp.asarray(prior), CAM, CFG)
    calls = []
    real = tg.gn_step_batched

    def counting(*args):
        calls.append((args[0].shape[0], tuple(args[2].shape)))
        return real(*args)

    monkeypatch.setattr(tg, "gn_step_batched", counting)
    got = ticp.icp_align_batched(curr_t, prev_t, torch.from_numpy(prior), CAM, CFG)
    monkeypatch.undo()
    assert calls == [(9, (3, 8, 48, 64))] * 4 + [(3, (3, 8, 96, 128))] * 3
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-5)
    assert got.inliers.tolist() == np.asarray(want.inliers).tolist()
    for b in range(3):
        one = ticp.icp_align(
            tuple({k: v[b] for k, v in lv.items()} for lv in curr_t),
            tuple({k: v[b] for k, v in lv.items()} for lv in prev_t),
            torch.from_numpy(prior[b]), CAM, CFG)
        np.testing.assert_allclose(got.T[b].numpy(), one.T.numpy(), atol=1e-6)
        assert int(got.inliers[b]) == int(one.inliers)


def test_best_start_is_taken_per_problem(batch):
    """Problem 2's prior is far off: its coarse level must be won
    by another start than the prior, while problem 0 keeps the prior (or
    ties to it): the choice is per problem, the first maximum winning."""
    _, _, prev_t, curr_t, prior = batch
    coarse = ICPConfig(levels=2, iters=(4, 0), window_px=(4, 2), max_step_m=0.01)
    T0 = torch.from_numpy(prior)
    cands = [T0, torch.eye(4).expand(3, 4, 4).contiguous(),
             ticp.se3.normalize_rotation(ticp.se3.inverse(T0))]
    single = ICPConfig(levels=2, iters=(4, 0), window_px=(4, 2), hypotheses=1)
    inl = torch.stack([ticp.icp_align_batched(curr_t, prev_t, c, CAM, single).inliers
                       for c in cands])  # (3 starts, 3 problems)
    best = inl.argmax(dim=0)
    assert int(best[2]) != 0 and int(inl[int(best[2]), 2]) > int(inl[0, 2])
    got = ticp.icp_align_batched(curr_t, prev_t, T0, CAM, coarse)
    assert got.inliers.tolist() == inl.amax(dim=0).tolist()


def test_rejected_step_is_identity_per_problem():
    """One problem of a batch with too few inliers, a singular system or a
    non-finite one keeps its pose (up to `normalize_rotation`), while its
    neighbour moves: as the JAX `_apply_update` under vmap."""
    T = torch.eye(4).repeat(4, 1, 1)
    T[:, 0, 3] = 0.1
    H = torch.eye(6).repeat(4, 1, 1) * 50.0
    H[2] = -H[2]
    H[3] = H[3] * float("nan")
    g = torch.full((4, 6), 0.3)
    inl = torch.tensor([100, 6, 100, 100], dtype=torch.int32)
    out = ticp._apply_update(T, H, g, inl, CFG)
    want = jax.vmap(lambda t, h, g_, i: jicp._apply_update(t, h, g_, i, CFG))(
        jnp.asarray(T.numpy()), jnp.asarray(H.numpy()), jnp.asarray(g.numpy()),
        jnp.asarray(inl.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6)
    assert not torch.allclose(out[0], T[0])
    np.testing.assert_allclose(out[1:].numpy(), T[1:].numpy(), atol=1e-6)
