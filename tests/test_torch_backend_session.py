"""The single session with its backend, end to end, vs the JAX package.

Inline: one 100-frame 160x120 out-and-back sweep under injected odometry
drift with the loop settings of `tests/test_runtime.py:272-283` (drift
twist, 64 keyframes, 8192 points, BA window 4, loop interval 4, cooldown 2)
through both packages' `SLAMSession`, the backend inline. Two settings
differ, so that the run is deterministic and short and still closes loops:
`max_decision_lag=1` resolves every frame's decision at the next call in
both packages (the JAX session's lag otherwise follows how fast its CPU
programs finish, and its keyframes with it), and `kf_min_trans` 0.2 m /
`kf_min_rot_deg` 30 give the keyframe spacing (~1 in 10 frames) at which the
revisit fails association and loops close; two ICP levels keep it short.
Keyframes, the frames that insert them, loops and the frames their merges
land on are equal; poses agree to 1e-3 m. The JAX run happens once, in a
module fixture. The threaded session's tests are in
`tests/test_torch_async_session.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.core import config as jc
from slam_rgbd_tpu.io import synthetic as jsyn
from slam_rgbd_tpu.runtime import session as jsess
from slam_rgbd_tpu_torch import SLAMSession
from slam_rgbd_tpu_torch.core import config as tc
from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse

torch.set_num_threads(1)

N = 100
DRIFT = (0.006, 0.0, 0.003, 0.0, 0.003, 0.0)


def _cam(pkg):
    return pkg.CameraIntrinsics(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)


def _drift_cfg(pkg):
    return pkg.SLAMConfig(
        camera=_cam(pkg),
        orb=pkg.ORBConfig(n_features=256, n_levels=4),
        icp=pkg.ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2), drift_xi=DRIFT),
        keyframes=pkg.KeyframeConfig(max_keyframes=64, max_map_points=8192,
                                     kf_min_trans=0.2, kf_min_rot_deg=30.0),
        ba=pkg.BAConfig(window=4, iters=4, loop_min_interval=4, loop_cooldown_kf=2),
        runtime=pkg.RuntimeConfig(max_decision_lag=1),
    )


@pytest.fixture(scope="module")
def sweep():
    seq = jsyn.SyntheticSequence(N, _cam(jc), step_t=0.015, step_r=0.012, sweep=True)
    frames = [tuple(np.asarray(x) if k else x for k, x in enumerate(seq.frame(i)))
              for i in range(N)]
    return frames, seq.groundtruth()


def _summary(sess, ts_est):
    return dict(
        keyframes=sess.state.keyframes, loops=sess.state.loops,
        merges=list(sess.state.loop_merge_frames),
        flags=[s.is_keyframe for s in sess.stats],
        closed=[i for i, s in enumerate(sess.stats) if s.loop_closed],
        lost=sess.state.lost, poses=ts_est[1])


@pytest.fixture(scope="module")
def jax_inline(sweep):
    frames, _ = sweep
    sess = jsess.SLAMSession(_drift_cfg(jc))
    for ts, d, c in frames:
        sess.process_frame(ts, jnp.asarray(d), jnp.asarray(c))
    sess.flush_pipeline()
    return _summary(sess, sess.poses())


def test_inline_session_matches_jax(sweep, jax_inline):
    frames, gt = sweep
    sess = SLAMSession(_drift_cfg(tc), device="cpu")
    for f in frames:
        sess.process_frame(*f)
    sess.flush_pipeline()
    got = _summary(sess, sess.poses())
    want = jax_inline
    assert got["loops"] == want["loops"] >= 1
    assert got["merges"] == want["merges"]
    assert got["keyframes"] == want["keyframes"] and got["flags"] == want["flags"]
    assert got["closed"] == want["closed"] and len(got["closed"]) == got["loops"]
    assert got["lost"] == want["lost"] == 0
    assert np.abs(got["poses"][:, :3, 3] - want["poses"][:, :3, 3]).max() <= 1e-3
    assert ate_rmse(got["poses"], gt)[0] < 0.1
