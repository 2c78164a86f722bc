"""Port ICP (`icp_align`, `track_frame`) vs the JAX package on its kernel
path (`backend="pallas"`, `gn_reduce` in interpret mode), at 128x96 with two
pyramid levels as in `tests/test_icp_pallas.py:194`.

Both follow the same dominant-flow schedule, so they agree far inside the
5e-4 that separates the JAX package's own two schedules: poses to 1e-5
(float32 sums in another order, compounded over the GN iterations),
inlier counts exactly.
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
from slam_rgbd_tpu_torch.interop import pyramid_from_numpy
from slam_rgbd_tpu_torch.odometry import icp as ticp
from slam_rgbd_tpu_torch.ops import gn_reduce as tg

# one intra-op thread: torch's spinning thread pool would otherwise take
# every core from the test workers running beside this one
torch.set_num_threads(1)

CAM = CameraIntrinsics(fx=114.1, fy=114.1, cx=63.5, cy=47.5, width=128, height=96)
# max_step_m 1 cm: the rolled pair steps ~6 mm and is kept, the orbit pair
# steps ~1.4 cm and is clamped, so one compiled JAX program covers both
CFG = ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2), backend="pallas",
                max_step_m=0.01)


@pytest.fixture(scope="module")
def pairs():
    poses = jsyn.orbit_trajectory(5)
    fr = [tuple(np.array(x) for x in jsyn.render_frame(jnp.asarray(p), CAM))
          for p in poses[3:5]]
    d, c = fr[0]
    rolled = (np.roll(d, (1, 2), (0, 1)), np.roll(c, (1, 2), (0, 1)))

    def pyr(depth, rgb):
        p = jcam.build_frame_pyramid(jnp.asarray(depth), CAM, levels=2,
                                     rgb=jnp.asarray(rgb))
        return p, pyramid_from_numpy(jax.tree.map(np.array, p))

    return {"kept": (pyr(*fr[0]), pyr(*rolled)), "clamped": (pyr(*fr[0]), pyr(*fr[1]))}


def _prior():
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.002  # a nonzero motion prior, so all three starts differ
    return T


@pytest.mark.parametrize("case", ["kept", "clamped"])
def test_track_frame_matches_jax(pairs, case):
    (prev_j, prev_t), (curr_j, curr_t) = pairs[case]
    T_prev = jsyn.orbit_trajectory(4)[3]
    Tw_j, Tm_j, res_j = jicp.track_frame(prev_j, curr_j, jnp.asarray(T_prev),
                                         jnp.asarray(_prior()), CAM, CFG)
    Tw_t, Tm_t, res_t = ticp.track_frame(prev_t, curr_t, torch.from_numpy(T_prev),
                                         torch.from_numpy(_prior()), CAM, CFG)
    np.testing.assert_allclose(Tw_t.numpy(), np.asarray(Tw_j), atol=1e-5)
    np.testing.assert_allclose(Tm_t.numpy(), np.asarray(Tm_j), atol=1e-5)
    assert int(res_t.inliers) == int(res_j.inliers)
    np.testing.assert_allclose(float(res_t.valid_fraction),
                               float(res_j.valid_fraction), atol=1e-6)
    np.testing.assert_allclose(float(res_t.rmse), float(res_j.rmse), rtol=1e-3)
    step = float(torch.linalg.norm(Tm_t[:3, 3]))
    if case == "clamped":  # the solve stepped ~1.4 cm: rejected, quality 0
        assert torch.equal(Tm_t, torch.eye(4)) and float(res_t.valid_fraction) == 0.0
        raw = ticp.icp_align(curr_t, prev_t, torch.from_numpy(_prior()), CAM, CFG)
        assert float(torch.linalg.norm(raw.T[:3, 3])) > CFG.max_step_m
    else:
        assert 0.002 < step < CFG.max_step_m
        assert float(res_t.valid_fraction) > 0.8


def test_icp_align_matches_jax_and_counts_reductions(pairs, monkeypatch):
    """`icp_align` itself, and one GN reduction per iteration: three starts
    at the coarsest level, then the finer level, so 3*4 + 3 calls."""
    (prev_j, prev_t), (curr_j, curr_t) = pairs["kept"]
    want = jicp.icp_align(curr_j, prev_j, jnp.asarray(_prior()), CAM, CFG)
    calls = []
    real = tg.gn_reduce

    def counting(*args):
        calls.append(args[2].shape)
        return real(*args)

    monkeypatch.setattr(tg, "gn_reduce", counting)
    got = ticp.icp_align(curr_t, prev_t, torch.from_numpy(_prior()), CAM, CFG)
    assert len(calls) == 3 * 4 + 3
    assert calls[0] == (8, 48, 64) and calls[-1] == (8, 96, 128)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-5)
    assert int(got.inliers) == int(want.inliers)


def test_flow_shift_rounds_half_to_even():
    h, w = 6, 8
    u = torch.arange(w, dtype=torch.float32)[None].expand(h, w)
    v = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    for du, dv in ((0.5, 1.5), (2.5, -0.5), (0.3, -1.7)):
        got = ticp.flow_shift(u + du, v + dv, h, w)
        mu_u, mu_v = jicp.flow_shift(jnp.asarray((u + du).numpy()),
                                     jnp.asarray((v + dv).numpy()), h, w)
        assert got.tolist() == [float(mu_u), float(mu_v)]


def test_apply_update_identity_step_when_degenerate():
    """Too few inliers, a singular system or a non-finite one: the pose
    only passes through `normalize_rotation`, as in the reference."""
    T = torch.eye(4)
    T[0, 3] = 0.1
    H = torch.eye(6) * 50.0
    g = torch.full((6,), 0.3)
    moved = ticp._apply_update(T, H, g, torch.tensor(100, dtype=torch.int32), CFG)
    assert not torch.allclose(moved, T)
    for H_bad, inl in ((H, 6), (-H, 100), (H * float("nan"), 100)):
        out = ticp._apply_update(T, H_bad, g, torch.tensor(inl, dtype=torch.int32), CFG)
        want = jicp._apply_update(jnp.asarray(T.numpy()), jnp.asarray(H_bad.numpy()),
                                  jnp.asarray(g.numpy()), jnp.int32(inl), CFG)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(out.numpy(), T.numpy(), atol=1e-6)
