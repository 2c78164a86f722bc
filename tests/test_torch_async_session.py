"""The single session with its backend on the worker thread (CPU).

The reference's async test (`tests/test_runtime.py:161-185`) on the port:
every keyframe's job is run or counted as skipped, results land, the ATE
gate holds. Then `warmup` on a threaded session, and the CLI's `run`, which
runs the threaded session and drains it with a final pass.
"""

import dataclasses

import torch

from slam_rgbd_tpu_torch import SLAMSession
from slam_rgbd_tpu_torch.core import config as tc
from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse
from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence

torch.set_num_threads(1)

CAM = tc.CameraIntrinsics(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)


def _small_cfg():
    """`tests/test_runtime.py`'s `small_config`."""
    return tc.SLAMConfig(
        camera=CAM, orb=tc.ORBConfig(n_features=256, n_levels=4),
        keyframes=tc.KeyframeConfig(max_keyframes=32, max_map_points=4096,
                                    kf_min_trans=0.05, kf_min_rot_deg=5.0),
        ba=tc.BAConfig(window=4, iters=4))


def test_async_session_backs_the_frontend():
    """BA / loop closure on the worker thread: every keyframe's job is run
    or counted as skipped, results land, the ATE gate holds."""
    seq = SyntheticSequence(25, CAM, step_t=0.015, step_r=0.012, device="cpu")
    sess = SLAMSession(_small_cfg(), async_backend=True, device="cpu")
    try:
        for ts, d, c in seq:
            sess.process_frame(ts, d, c)
        ts_, est = sess.poses()  # drains the pipeline and the worker
        assert sess.state.keyframes >= 3
        assert sess.worker.completed + sess.worker.skipped >= sess.state.keyframes - 1
        assert sess.worker.completed >= 1 and not sess.worker.busy()
        assert all(s.tracking_ok for s in sess.stats)
        assert ate_rmse(est, seq.groundtruth())[0] < 0.02
    finally:
        sess.close()
    assert sess.worker is None


def test_warmup_leaves_a_fresh_threaded_session():
    cfg = dataclasses.replace(_small_cfg(), camera=tc.CameraIntrinsics(
        fx=114.1, fy=114.1, cx=63.5, cy=47.5, width=128, height=96))
    sess = SLAMSession(cfg, async_backend=True, device="cpu")
    try:
        sess.warmup()
        assert sess.async_backend and sess.worker is not None
        assert sess.worker._thread.is_alive() and not sess.worker.busy()
        assert sess.worker.completed == 0 and sess.worker.skipped == 0
        assert sess.state.frames == sess.state.keyframes == sess.state.loops == 0
        assert sess.map_point_count() == 0 and len(sess.poses()[0]) == 0
    finally:
        sess.close()


def test_cli_run_prints_loops(capsys):
    """`python -m slam_rgbd_tpu_torch run synthetic:12 --device cpu`: the
    threaded session at the Astra profile, drained with a final pass."""
    from slam_rgbd_tpu_torch.__main__ import main

    assert main(["run", "synthetic:12", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "frames=12" in out and "loops=0" in out and "lost=0" in out
    assert "ATE RMSE" in out
