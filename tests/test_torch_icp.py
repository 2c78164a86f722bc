"""Port ICP (`icp_align`, `track_frame`) vs the JAX package on its kernel
path (`backend="pallas"`, `gn_reduce` in interpret mode), at 128x96 with two
pyramid levels as in `tests/test_icp_pallas.py:194`. The port runs the
coarsest level's three starts stacked as problems of one batched GN step.

Both follow the same dominant-flow schedule, so they agree far inside the
5e-4 that separates the JAX package's own two schedules: poses to 1e-5
(float32 sums in another order, compounded over the GN iterations),
inlier counts exactly. The JAX results are computed once, on three threads
started with the module (each compiles its own program).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

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
from test_torch_priority import below_the_jax_files  # noqa: F401 (autouse)

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
        return p, pyramid_from_numpy(jax.tree.map(np.array, p), "cpu")

    return {"kept": (pyr(*fr[0]), pyr(*rolled)), "clamped": (pyr(*fr[0]), pyr(*fr[1]))}


def _prior():
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.002  # a nonzero motion prior, so all three starts differ
    return T


def _rolled_prior():
    """A prior rolled 0.3 rad about the optical axis."""
    prior = np.eye(4, dtype=np.float32)
    prior[:2, :2] = [[np.cos(0.3), -np.sin(0.3)], [np.sin(0.3), np.cos(0.3)]]
    return prior


def _jax_track(pairs):
    out = {}
    for case in ("kept", "clamped"):
        (prev_j, _), (curr_j, _) = pairs[case]
        out[case] = jicp.track_frame(prev_j, curr_j,
                                     jnp.asarray(jsyn.orbit_trajectory(4)[3]),
                                     jnp.asarray(_prior()), CAM, CFG)
    return out


def _jax_align(pairs, cfg, prior):
    (prev_j, _), (curr_j, _) = pairs["kept"]
    return jicp.icp_align(curr_j, prev_j, jnp.asarray(prior), CAM, cfg)


@pytest.fixture(scope="module")
def jax_refs(pairs):
    """The JAX tracker's results, started on three threads with the module:
    -> futures of track_frame on both pairs, icp_align with the small prior
    and the rolled one, icp_align with one start."""
    one = dataclasses.replace(CFG, hypotheses=1)
    with ThreadPoolExecutor(max_workers=3) as pool:
        yield {"track": pool.submit(_jax_track, pairs),
               "align": pool.submit(
                   lambda: [_jax_align(pairs, CFG, p) for p in (_prior(), _rolled_prior())]),
               "one": pool.submit(_jax_align, pairs, one, _prior())}


@pytest.mark.parametrize("case", ["kept", "clamped"])
def test_track_frame_matches_jax(pairs, jax_refs, case):
    (prev_j, prev_t), (curr_j, curr_t) = pairs[case]
    T_prev = jsyn.orbit_trajectory(4)[3]
    Tw_j, Tm_j, res_j = jax_refs["track"].result(timeout=600)[case]
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


def _count_steps(monkeypatch):
    """Record every `gn_step` / `gn_step_batched` call of the tracker as
    (name, leading shape of T, shape of src)."""
    calls = []
    for name in ("gn_step", "gn_step_batched"):
        def counting(*args, _real=getattr(tg, name), _name=name):
            calls.append((_name, tuple(args[0].shape[:-2]), tuple(args[2].shape)))
            return _real(*args)

        monkeypatch.setattr(tg, name, counting)
    return calls


def test_icp_align_matches_jax_and_counts_reductions(pairs, jax_refs, monkeypatch):
    """`icp_align` itself, and one GN step per iteration: the three starts
    of the coarsest level as problems of one batched call over one set of
    planes (made by `expand`), then the finer level, so 4 + 3 calls."""
    (prev_j, prev_t), (curr_j, curr_t) = pairs["kept"]
    want = jax_refs["align"].result(timeout=600)[0]
    calls = _count_steps(monkeypatch)
    got = ticp.icp_align(curr_t, prev_t, torch.from_numpy(_prior()), CAM, CFG)
    assert calls[:4] == [("gn_step_batched", (3,), (3, 8, 48, 64))] * 4
    assert calls[4:] == [("gn_step", (), (8, 96, 128))] * 3
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-5)
    assert int(got.inliers) == int(want.inliers)


def test_icp_align_single_start_matches_jax(pairs, jax_refs, monkeypatch):
    """`hypotheses` 1: no stacking, every iteration a single `gn_step`."""
    one = dataclasses.replace(CFG, hypotheses=1)
    (prev_j, prev_t), (curr_j, curr_t) = pairs["kept"]
    want = jax_refs["one"].result(timeout=600)
    calls = _count_steps(monkeypatch)
    got = ticp.icp_align(curr_t, prev_t, torch.from_numpy(_prior()), CAM, one)
    assert [c[0] for c in calls] == ["gn_step"] * 7
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-5)
    assert int(got.inliers) == int(want.inliers)


def test_icp_align_identity_start_wins_over_a_bad_prior(pairs, jax_refs):
    """A prior rolled 0.3 rad about the optical axis, which no flow shift
    absorbs: of the stacked starts the identity (problem 1) has the most
    inliers at the coarsest level and seeds the finer one, as in the JAX
    package."""
    (prev_j, prev_t), (curr_j, curr_t) = pairs["kept"]
    prior = _rolled_prior()
    want = jax_refs["align"].result(timeout=600)[1]
    got = ticp.icp_align(curr_t, prev_t, torch.from_numpy(prior), CAM, CFG)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-5)
    assert int(got.inliers) == int(want.inliers)
    # each start alone through the coarsest level
    coarse = dataclasses.replace(CFG, iters=(4, 0), hypotheses=1, backend="auto")
    T0 = torch.from_numpy(prior)
    starts = [T0, torch.eye(4), ticp.se3.normalize_rotation(ticp.se3.inverse(T0))]
    inl = [int(ticp.icp_align(curr_t, prev_t, c, CAM, coarse).inliers) for c in starts]
    assert inl[1] == max(inl) > inl[0]
    stacked = ticp.icp_align(curr_t, prev_t, T0, CAM,
                             dataclasses.replace(coarse, hypotheses=3))
    assert int(stacked.inliers) == inl[1]
    np.testing.assert_allclose(
        stacked.T.numpy(), ticp.icp_align(curr_t, prev_t, starts[1], CAM, coarse).T.numpy(),
        atol=1e-6)


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
