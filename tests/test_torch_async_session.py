"""The single session with its backend on the worker thread (CPU).

The reference's async test (`tests/test_runtime.py:161-185`) on the port:
every keyframe's job is run or counted as skipped, results land, the ATE
gate holds. Then `warmup` on a threaded session, and the CLI's `run`, which
runs the threaded session and drains it with a final pass. The first two
print nothing: they run on threads started with the module, while the CLI
runs in the test's own thread (its output is read from the capture).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import pytest

import torch

from slam_rgbd_tpu_torch import SLAMSession
from slam_rgbd_tpu_torch.core import config as tc
from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse
from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence
from test_torch_priority import below_the_jax_files  # noqa: F401 (autouse)

torch.set_num_threads(1)

CAM = tc.CameraIntrinsics(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)


def _small_cfg():
    """`tests/test_runtime.py`'s `small_config`."""
    return tc.SLAMConfig(
        camera=CAM, orb=tc.ORBConfig(n_features=256, n_levels=4),
        keyframes=tc.KeyframeConfig(max_keyframes=32, max_map_points=4096,
                                    kf_min_trans=0.05, kf_min_rot_deg=5.0),
        ba=tc.BAConfig(window=4, iters=4))


def _backs_the_frontend():
    """The threaded session over 25 frames, drained -> what the test reads."""
    seq = SyntheticSequence(25, CAM, step_t=0.015, step_r=0.012, device="cpu")
    sess = SLAMSession(_small_cfg(), async_backend=True, device="cpu")
    try:
        for ts, d, c in seq:
            sess.process_frame(ts, d, c)
        ts_, est = sess.poses()  # drains the pipeline and the worker
        out = dict(keyframes=sess.state.keyframes, completed=sess.worker.completed,
                   skipped=sess.worker.skipped, busy=sess.worker.busy(),
                   tracking_ok=all(s.tracking_ok for s in sess.stats),
                   ate=ate_rmse(est, seq.groundtruth())[0])
    finally:
        sess.close()
    out["worker_after_close"] = sess.worker
    return out


def _warmup():
    """A fresh threaded session warmed up -> what the test reads."""
    cfg = dataclasses.replace(_small_cfg(), camera=tc.CameraIntrinsics(
        fx=114.1, fy=114.1, cx=63.5, cy=47.5, width=128, height=96))
    sess = SLAMSession(cfg, async_backend=True, device="cpu")
    try:
        sess.warmup()
        return dict(async_backend=sess.async_backend, worker=sess.worker is not None,
                    alive=sess.worker._thread.is_alive(), busy=sess.worker.busy(),
                    completed=sess.worker.completed, skipped=sess.worker.skipped,
                    counts=(sess.state.frames, sess.state.keyframes, sess.state.loops),
                    points=sess.map_point_count(), poses=len(sess.poses()[0]))
    finally:
        sess.close()


@pytest.fixture(scope="module", autouse=True)
def started():
    """The two sessions that print nothing, on threads from the start:
    -> futures of `_backs_the_frontend` and `_warmup`."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        yield {"backs": pool.submit(_backs_the_frontend), "warmup": pool.submit(_warmup)}


def test_cli_run_prints_loops(started, capsys):
    """`python -m slam_rgbd_tpu_torch run synthetic:12 --device cpu`: the
    threaded session at the Astra profile, drained with a final pass."""
    from slam_rgbd_tpu_torch.__main__ import main

    assert main(["run", "synthetic:12", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "frames=12" in out and "loops=0" in out and "lost=0" in out
    assert "ATE RMSE" in out


def test_async_session_backs_the_frontend(started):
    """BA / loop closure on the worker thread: every keyframe's job is run
    or counted as skipped, results land, the ATE gate holds."""
    got = started["backs"].result(timeout=600)
    assert got["keyframes"] >= 3
    assert got["completed"] + got["skipped"] >= got["keyframes"] - 1
    assert got["completed"] >= 1 and not got["busy"]
    assert got["tracking_ok"]
    assert got["ate"] < 0.02
    assert got["worker_after_close"] is None


def test_warmup_leaves_a_fresh_threaded_session(started):
    got = started["warmup"].result(timeout=600)
    assert got["async_backend"] and got["worker"]
    assert got["alive"] and not got["busy"]
    assert got["completed"] == 0 and got["skipped"] == 0
    assert got["counts"] == (0, 0, 0)
    assert got["points"] == 0 and got["poses"] == 0
