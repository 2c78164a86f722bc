"""The port's command line on the CPU (`--device cpu`): `record`, `play`,
`eval`, `export` and `run` on the golden TUM directory; `eval` and `export`
against the JAX package's verbs on the same files; `frame_to_pointcloud`,
the PLY writer and the viewer's server.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from slam_rgbd_tpu.cli.main import main as jmain
from slam_rgbd_tpu.core.config import tum_fr1_config as jtum_cfg
from slam_rgbd_tpu.io.tum import TUMSequence as JTUMSequence
from slam_rgbd_tpu.viz import pointcloud as jpc
from slam_rgbd_tpu_torch.__main__ import main
from slam_rgbd_tpu_torch.core.config import (
    CameraIntrinsics, ICPConfig, KeyframeConfig, ORBConfig, SLAMConfig, tum_fr1_config,
)
from slam_rgbd_tpu_torch.eval.trajectory import load_trajectory_tum
from slam_rgbd_tpu_torch.io import stream as st
from slam_rgbd_tpu_torch.viz import pointcloud as tpc
from slam_rgbd_tpu_torch.viz.server import PointCloudServer

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "tum_golden")
SMALL_CAM = CameraIntrinsics(fx=90.0, fy=90.0, cx=47.5, cy=35.5, width=96, height=72)


@pytest.fixture(scope="module")
def small_yaml(tmp_path_factory):
    cfg = SLAMConfig(
        camera=SMALL_CAM,
        icp=ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2)),
        orb=ORBConfig(n_features=128, n_levels=4),
        keyframes=KeyframeConfig(max_keyframes=16, max_map_points=2048),
    )
    path = tmp_path_factory.mktemp("cfg") / "small.yaml"
    cfg.to_yaml(str(path))
    return str(path)


def _json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def test_record_play_eval(tmp_path, small_yaml, capsys):
    clip, traj, ck = tmp_path / "clip.rgbd", tmp_path / "traj.txt", tmp_path / "ck"
    cpu = ["--device", "cpu", "--config", small_yaml]
    assert main(["record", "synthetic:6", str(clip), *cpu]) == 0
    assert "recorded 6 frames" in capsys.readouterr().out
    assert len(list(st.StreamReader(str(clip)))) == 6
    assert main(["play", str(clip), "--threaded", "--traj", str(traj),
                 "--checkpoint", str(ck), *cpu]) == 0
    out = capsys.readouterr().out
    assert "frames=" in out and "checkpoint -> " in out
    ts, est = load_trajectory_tum(str(traj))
    assert 1 <= len(ts) <= 6 and np.isfinite(est).all()
    assert (ck / "state.npz").exists() and (ck / "meta.json").exists()
    # eval of the trajectory against itself
    assert main(["eval", str(traj), str(traj), "--device", "cpu"]) == 0
    res = _json_line(capsys.readouterr().out)
    assert res["ate_rmse_m"] == 0.0 and res["frames"] == len(ts)


def make_grabber():
    """A zero-argument grabber factory, as `run grabber:module:factory` takes."""
    from slam_rgbd_tpu_torch.io.grabber import SyntheticGrabber

    return SyntheticGrabber(SMALL_CAM, n_frames=4, device="cpu")


def test_run_options_record_serve_interactive_and_a_grabber(tmp_path, small_yaml, capsys,
                                                            monkeypatch):
    """`run` from a grabber with a tee, a live viewer and the stdin menu
    (which quits at once: the threaded run stops early and shuts down)."""
    import io
    import sys

    tee = tmp_path / "tee.rgbd"
    cpu = ["--device", "cpu", "--config", small_yaml]
    assert main(["run", f"grabber:{__name__}:make_grabber", "--record", str(tee),
                 "--serve", "0", *cpu]) == 0
    out = capsys.readouterr().out
    assert "live viewer at http://127.0.0.1:" in out and "frames=4 " in out
    assert len(list(st.StreamReader(str(tee)))) == 4
    monkeypatch.setattr(sys, "stdin", io.StringIO("s\nq\n"))
    assert main(["run", "synthetic:200", "--interactive", *cpu]) == 0
    out = capsys.readouterr().out
    assert "menu:" in out and "shutting down" in out
    frames = int(out.split("frames=")[-1].split()[0])
    assert frames < 200


def test_run_golden_tum_and_eval_equals_jax(tmp_path, capsys):
    traj = tmp_path / "traj.txt"
    assert main(["run", GOLDEN, "--tum", "--traj", str(traj), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "frames=3 " in out and "ATE RMSE vs ground truth" in out
    ts, est = load_trajectory_tum(str(traj))
    assert est.shape == (3, 4, 4)
    gt = os.path.join(GOLDEN, "groundtruth.txt")
    assert main(["eval", str(traj), gt, "--device", "cpu"]) == 0
    got = _json_line(capsys.readouterr().out)
    assert jmain(["eval", str(traj), gt]) == 0
    assert got == _json_line(capsys.readouterr().out)
    assert got["frames"] == 3 and got["ate_rmse_m"] < 0.01


def test_export_ply_equals_jax(tmp_path, capsys):
    mine, ref = tmp_path / "port.ply", tmp_path / "jax.ply"
    assert main(["export", GOLDEN, str(mine), "--tum", "--frame", "1", "--stride", "4",
                 "--device", "cpu"]) == 0
    assert jmain(["export", GOLDEN, str(ref), "--tum", "--frame", "1", "--stride", "4"]) == 0
    out = capsys.readouterr().out
    assert " points -> " in out
    p1, c1 = tpc.load_ply(str(mine))
    p2, c2 = jpc.load_ply(str(ref))
    assert len(p1) == len(p2) > 1000
    np.testing.assert_allclose(p1, p2, atol=1e-6)
    np.testing.assert_array_equal(c1, c2)
    head = lambda p: p.read_bytes().split(b"end_header")[0]  # noqa: E731
    assert head(mine) == head(ref)


def test_export_from_an_icl_nuim_directory(tmp_path, small_yaml, capsys):
    """A directory of raw ICL-NUIM `.depth` files is routed to the ICL-NUIM
    loader (ray length to planar depth), not to the TUM one."""
    rng = np.random.default_rng(4)
    for k in range(2):
        ray = rng.uniform(1.0, 3.0, size=(SMALL_CAM.height, SMALL_CAM.width))
        np.savetxt(tmp_path / f"scene_00_{k:04d}.depth", ray.reshape(1, -1))
    out = tmp_path / "icl.ply"
    assert main(["export", str(tmp_path), str(out), "--frame", "1", "--device", "cpu",
                 "--config", small_yaml]) == 0
    pts, colors = tpc.load_ply(str(out))
    assert len(pts) == SMALL_CAM.height * SMALL_CAM.width and (colors == 0).all()
    assert 0.7 < pts[:, 2].min() and pts[:, 2].max() < 3.0  # planar z <= ray length


def test_frame_to_pointcloud_and_ply_writer_equal_jax(tmp_path):
    ts, depth, rgb = JTUMSequence(GOLDEN, jtum_cfg().camera).frame(0)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]]
    T[:3, 3] = [0.3, -0.2, 1.5]
    for stride, pose, colour in ((1, None, rgb), (3, T, rgb), (2, T, None)):
        p1, c1 = tpc.frame_to_pointcloud(depth, colour, tum_fr1_config().camera,
                                         stride=stride, T_world_cam=pose, device="cpu")
        p2, c2 = jpc.frame_to_pointcloud(depth, colour, jtum_cfg().camera, stride=stride,
                                         T_world_cam=pose)
        assert p1.dtype == np.float32 and c1.dtype == np.uint8 and len(p1) == len(p2)
        np.testing.assert_allclose(p1, p2, atol=1e-6)
        np.testing.assert_array_equal(c1, c2)
    # the writers: the same bytes for the same points, binary and ascii
    for binary in (True, False):
        for colors in (c2, None):
            a, b = tmp_path / "a.ply", tmp_path / "b.ply"
            tpc.save_ply(str(a), p2[:500], None if colors is None else colors[:500], binary)
            jpc.save_ply(str(b), p2[:500], None if colors is None else colors[:500], binary)
            assert a.read_bytes() == b.read_bytes()
            q, k = tpc.load_ply(str(a))
            np.testing.assert_allclose(q, p2[:500], atol=1e-5 if not binary else 0)
    assert tpc.pointcloud_json(p2, c2, max_points=1000) == jpc.pointcloud_json(
        p2, c2, max_points=1000)


def test_map_to_pointcloud_reads_the_valid_points():
    from slam_rgbd_tpu_torch.mapping.map import empty_map

    m = empty_map(KeyframeConfig(max_keyframes=4, max_map_points=256), 8, "cpu")
    m.pt_xyz[:] = torch.arange(256 * 3, dtype=torch.float32).reshape(256, 3)
    m.pt_valid[[3, 7, 100]] = True
    pts, colors = tpc.map_to_pointcloud(m)
    np.testing.assert_array_equal(pts, m.pt_xyz[[3, 7, 100]].numpy())
    assert colors.shape == (3, 3) and colors.dtype == np.uint8


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_server_answers():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (300, 3)).astype(np.uint8)
    server = PointCloudServer(lambda: (pts, colors), port=0).start()
    try:
        status, ctype, body = _get(server.port, "/pointcloud")
        assert status == 200 and ctype == "application/json"
        assert body.decode() == jpc.pointcloud_json(pts, colors)
        assert _get(server.port, "/healthz")[2] == b'{"ok": true}'
        assert b"three" in _get(server.port, "/")[2]
        assert _get(server.port, "/native/orbit?dx=5&dy=-3")[0] == 200
        assert _get(server.port, "/native/zoom?steps=1")[0] == 200
        status, ctype, png = _get(server.port, "/native/frame")
        assert status == 200 and ctype == "image/png" and png[:4] == b"\x89PNG"
        with pytest.raises(urllib.error.HTTPError):
            _get(server.port, "/nowhere")
    finally:
        server.stop()


def test_verbs_raise_without_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    traj = os.path.join(GOLDEN, "groundtruth.txt")
    for argv in (["eval", traj, traj], ["run", GOLDEN, "--tum"],
                 ["export", GOLDEN, str(tmp_path / "x.ply")], ["benchmark"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(argv)
