"""The tracking slice end to end: the session (`TrackingSession`, the name the
tracking-only slice gave `SLAMSession`) vs a loop over the JAX
package's fused `_steady_step` on its kernel path (`backend="pallas"`).

The JAX loop applies each frame's keyframe decision before the next frame,
as the session does when every summary has landed (always, on the CPU):
the reference keyframe pose moves to the frame's pose, nothing else.
Per-frame poses agree to 1e-4 (eight frames of float32 GN solves, summed in
another order) and keyframe flags exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.core import camera as jcam
from slam_rgbd_tpu.core.config import (
    BAConfig, CameraIntrinsics, ICPConfig, KeyframeConfig, SLAMConfig,
)
from slam_rgbd_tpu.eval.trajectory import load_trajectory_tum
from slam_rgbd_tpu.io import synthetic as jsyn
from slam_rgbd_tpu.runtime import session as jsess
from slam_rgbd_tpu_torch import TrackingSession
from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse
from slam_rgbd_tpu_torch.interop import pyramid_to_numpy, state_from_numpy
from slam_rgbd_tpu_torch.ops import gn_reduce as tg

# one intra-op thread: torch's spinning thread pool would otherwise take
# every core from the test workers running beside this one
torch.set_num_threads(1)

CAM = CameraIntrinsics(fx=114.1, fy=114.1, cx=63.5, cy=47.5, width=128, height=96)
# kf_min_trans 3 cm: a keyframe every few frames of the ~1.3 cm/frame orbit
CFG = SLAMConfig(
    camera=CAM,
    icp=ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2), backend="pallas"),
    keyframes=KeyframeConfig(kf_min_trans=0.03),
)
N = 8


@pytest.fixture(scope="module")
def frames():
    poses = jsyn.orbit_trajectory(N, sweep=True)
    out = []
    for i, p in enumerate(poses):
        d, c = jsyn.render_frame(jnp.asarray(p), CAM)
        out.append((i / 30.0, np.array(d), np.array(c)))
    return out, poses


@pytest.fixture(scope="module")
def jax_run(frames):
    """The reference loop: per-frame poses, keyframe flags, and the state
    after each frame (for the resume test)."""
    seq, _ = frames
    eye = jnp.eye(4)
    pyr = jcam.build_frame_pyramid(jnp.asarray(seq[0][1]), CAM,
                                   levels=CFG.icp.levels, rgb=jnp.asarray(seq[0][2]))
    T_world, motion, last_kf = eye, eye, eye
    buf_T = jnp.zeros((16, 4, 4)).at[0].set(eye)
    buf_kfT = jnp.zeros((16, 4, 4)).at[0].set(eye)
    flags, states = [True], [None]
    last_kf_frame, fresh_from = 0, 0
    for i in range(1, N):
        _, d, c = seq[i]
        states.append(dict(
            T_world=np.asarray(T_world), motion=np.asarray(motion),
            last_kf_T=np.asarray(last_kf), prev_pyr=pyramid_to_numpy_jax(pyr),
            traj_T=np.asarray(buf_T[:i]), traj_kfT=np.asarray(buf_kfT[:i]),
        ))
        pyr, T_world, motion, summary, buf_T, buf_kfT = jsess._steady_step(
            pyr, jnp.asarray(d), jnp.asarray(c), T_world, motion, last_kf,
            buf_T, buf_kfT, np.int32(i), CAM, CFG.icp, CFG.keyframes,
        )
        vf, _, finite, should = (float(x) for x in np.asarray(summary))
        kf = (vf > 0.25 and finite > 0.5 and should > 0.5
              and i - last_kf_frame >= CFG.keyframes.kf_min_gap_frames
              and i >= fresh_from)
        if kf:
            last_kf, last_kf_frame, fresh_from = T_world, i, i + 1
        flags.append(kf)
    return np.asarray(buf_T[:N]), flags, states


def pyramid_to_numpy_jax(pyr):
    return tuple({k: np.array(v) for k, v in level.items()} for level in pyr)


def test_slice_matches_jax_steady_step(frames, jax_run):
    seq, gt = frames
    want_T, want_flags, _ = jax_run
    # the reference loop has no backend: the session's backend pass runs no
    # LM iteration here (and finds no loop), so it moves no keyframe and the
    # poses stay the tracker's
    sess = TrackingSession(dataclasses.replace(CFG, ba=BAConfig(iters=0)), device="cpu")
    for ts, d, c in seq:
        sess.process_frame(ts, d, c)
    ts, got_T = sess.poses()
    np.testing.assert_allclose(ts, [f[0] for f in seq])
    np.testing.assert_allclose(got_T, want_T, atol=1e-4)
    assert [s.is_keyframe for s in sess.stats] == want_flags
    assert sum(want_flags) >= 3  # the decision path really ran
    assert sess.state.frames == N and sess.state.lost == 0
    assert all(s.inlier_fraction > 0.5 for s in sess.stats)
    # held against the orbit's ground truth too: ~2.7 mm ATE at 128x96
    assert ate_rmse(got_T, gt)[0] < 0.01


def test_state_from_numpy_resumes_mid_sequence(frames, jax_run):
    """JAX state after frame 4 carried into a fresh port session: the next
    frame lands on the JAX pose."""
    seq, _ = frames
    want_T, _, states = jax_run
    k = 5
    sess = TrackingSession(CFG, device="cpu")
    s = states[k]
    state_from_numpy(sess, T_world=s["T_world"], motion=s["motion"],
                     last_kf_T=s["last_kf_T"], prev_pyr=s["prev_pyr"],
                     traj_ts=[f[0] for f in seq[:k]], traj_T=s["traj_T"],
                     traj_kfT=s["traj_kfT"])
    sess.process_frame(*seq[k])
    _, got = sess.poses()
    assert got.shape == (k + 1, 4, 4)
    np.testing.assert_allclose(got[:k], want_T[:k], atol=1e-6)
    np.testing.assert_allclose(got[k], want_T[k], atol=1e-4)
    rt = pyramid_to_numpy(sess.prev_pyr)
    assert set(rt[0]) == set(s["prev_pyr"][0]) and rt[0]["valid"].dtype == bool


def test_default_icp_is_42_reductions_per_frame(monkeypatch):
    """Default ICPConfig (iters (10,7,5), 3 starts): 3*10 + 7 + 5 GN
    reductions per tracked frame in 10 + 7 + 5 calls (the three starts of
    the coarsest level are problems of one batched call), none on the
    bootstrap frame."""
    cam = CameraIntrinsics(fx=142.6, fy=142.6, cx=79.5, cy=59.5,
                           width=160, height=120)
    cfg = SLAMConfig(camera=cam)
    calls = []
    for name in ("gn_step", "gn_step_batched"):
        def counting(*args, _real=getattr(tg, name)):
            problems = args[0].shape[0] if args[0].dim() == 3 else 1
            calls.append((problems, tuple(args[2].shape[-2:])))
            return _real(*args)

        monkeypatch.setattr(tg, name, counting)
    sess = TrackingSession(cfg, device="cpu")
    seq = jsyn.SyntheticSequence(3, cam)
    for ts, d, c in seq:
        sess.process_frame(ts, d, c)
    assert len(calls) == 22 * 2 and sum(c[0] for c in calls) == 42 * 2
    assert calls[:10] == [(3, (30, 40))] * 10 and calls[17:22] == [(1, (120, 160))] * 5


def test_trajectory_export_reset_and_device(tmp_path, frames):
    seq, _ = frames
    sess = TrackingSession(CFG, device="cpu")
    for f in seq[:3]:
        sess.process_frame(*f)
    path = tmp_path / "traj.txt"
    sess.save_trajectory(str(path))
    ts, T = sess.poses()
    ts2, T2 = load_trajectory_tum(str(path))  # the JAX package's reader
    np.testing.assert_allclose(ts2, ts, atol=1e-6)
    np.testing.assert_allclose(T2, T, atol=1e-5)
    sess.reset()
    assert sess.state.frames == 0 and len(sess.poses()[0]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TrackingSession(CFG, device="cuda")
        with pytest.raises(RuntimeError):
            TrackingSession(CFG)  # the default device is the card


def test_cli_run_synthetic(tmp_path, capsys):
    """`python -m slam_rgbd_tpu_torch run synthetic:N --traj ...`, the
    counterpart of the JAX package's `run` verb, at its default 640x480."""
    from slam_rgbd_tpu_torch.__main__ import main

    path = tmp_path / "traj.txt"
    assert main(["run", "synthetic:3", "--traj", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "frames=3" in out and "lost=0" in out and "ATE RMSE" in out
    assert "keyframes=1" in out and "map_points=" in out
    ts, T = load_trajectory_tum(str(path))
    assert len(ts) == 3 and np.isfinite(T).all()
