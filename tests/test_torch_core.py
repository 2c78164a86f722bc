"""Torch port vs the JAX package: se3, camera pyramid, renderer, trajectory
I/O, and the port's freedom from jax.

Inputs come from a numpy seed or from the JAX renderer and go through both
packages; each tolerance is stated where it is asserted.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.core import camera as jcam
from slam_rgbd_tpu.core import se3 as jse3
from slam_rgbd_tpu.core.config import CameraIntrinsics
from slam_rgbd_tpu.eval import trajectory as jtraj
from slam_rgbd_tpu.io import synthetic as jsyn
from slam_rgbd_tpu_torch.core import camera as tcam
from slam_rgbd_tpu_torch.core import se3 as tse3
from slam_rgbd_tpu_torch.eval import trajectory as ttraj
from slam_rgbd_tpu_torch.io import synthetic as tsyn
from test_torch_priority import below_the_jax_files  # noqa: F401 (autouse)

# one intra-op thread: torch's spinning thread pool would otherwise take
# every core from the test workers running beside this one
torch.set_num_threads(1)

CAM_160 = CameraIntrinsics(fx=142.6, fy=142.6, cx=79.5, cy=59.5,
                           width=160, height=120)
ATOL = 1e-5  # float32 results of the same formulas, summed in other orders


def _twists(rng, n=6):
    xi = rng.normal(size=(n, 6)).astype(np.float32) * 0.4
    xi[0] = 0.0  # exact identity
    xi[1, 3:] = [1e-5, -2e-5, 1e-5]  # small-angle Taylor branch
    xi[2, 3:] = [2.9, 0.6, 0.2]  # theta ~ 2.97 rad, near the pi branch
    return xi


@pytest.mark.parametrize("fn", ["exp", "log", "inverse", "normalize_rotation",
                                "so3", "points"])
def test_se3_matches_jax(rng, fn):
    for xi in _twists(rng):
        T_j = jse3.exp(jnp.asarray(xi))
        T_np = np.asarray(T_j)
        T_t = torch.from_numpy(T_np.copy())
        if fn == "exp":
            got, want = tse3.exp(torch.from_numpy(xi)), T_j
        elif fn == "log":
            got, want = tse3.log(T_t), jse3.log(T_j)
        elif fn == "inverse":
            got, want = tse3.inverse(T_t), jse3.inverse(T_j)
        elif fn == "normalize_rotation":
            noisy = T_np + rng.normal(size=(4, 4)).astype(np.float32) * 1e-3
            noisy[3] = [0, 0, 0, 1]
            got = tse3.normalize_rotation(torch.from_numpy(noisy))
            want = jse3.normalize_rotation(jnp.asarray(noisy))
        elif fn == "so3":
            w = xi[3:]
            for tf, jf in ((tse3.so3_exp, jse3.so3_exp), (tse3.hat, jse3.hat),
                           (tse3.left_jacobian, jse3.left_jacobian),
                           (tse3.left_jacobian_inv, jse3.left_jacobian_inv)):
                np.testing.assert_allclose(
                    tf(torch.from_numpy(w)).numpy(), np.asarray(jf(jnp.asarray(w))),
                    atol=ATOL,
                )
            got = tse3.so3_log(T_t[:3, :3])
            want = jse3.so3_log(T_j[:3, :3])
        else:
            pts = rng.normal(size=(5, 7, 3)).astype(np.float32)
            np.testing.assert_allclose(
                tse3.rotate_vectors(T_t, torch.from_numpy(pts)).numpy(),
                np.asarray(jse3.rotate_vectors(T_j, jnp.asarray(pts))), atol=ATOL,
            )
            got = tse3.transform_points(T_t, torch.from_numpy(pts))
            want = jse3.transform_points(T_j, jnp.asarray(pts))
        # log near pi divides by small numbers: 1e-4 there, ATOL elsewhere
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4 if fn == "log" else ATOL)


def _frame(cam, pose_i=5):
    poses = jsyn.orbit_trajectory(pose_i + 1)
    d, c = jsyn.render_frame(jnp.asarray(poses[pose_i]), cam)
    return np.array(d), np.array(c)  # writable copies for torch


def test_pyramid_matches_jax():
    depth, rgb = _frame(CAM_160)
    pj = jcam.build_frame_pyramid(jnp.asarray(depth), CAM_160, levels=3,
                                  rgb=jnp.asarray(rgb))
    pt = tcam.build_frame_pyramid(torch.from_numpy(depth.astype(np.int32)),
                                  CAM_160, levels=3, rgb=torch.from_numpy(rgb))
    assert len(pt) == 3
    flipped = 0
    for lj, lt in zip(pj, pt):
        assert set(lj) == set(lt)
        vj, vt = np.asarray(lj["valid"]), lt["valid"].numpy()
        # a pixel's validity may flip only where a quantity sits on its
        # threshold within float rounding; count those, allow 0.1%
        flipped += int(np.sum(vj != vt))
        both = vj & vt
        for k in ("depth", "intensity", "grad", "vertices"):
            np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]),
                                       atol=ATOL, err_msg=k)
        # normals: unit vectors from differences of nearby vertices, where
        # 1e-7 m of depth rounding becomes ~1e-5 of direction
        np.testing.assert_allclose(lt["normals"].numpy()[both],
                                   np.asarray(lj["normals"])[both], atol=1e-4)
    assert flipped <= 0.001 * sum(l["valid"].numel() for l in pt), flipped


def test_bilateral_wraps_and_borders_zero():
    """The filter mixes border pixels with the opposite edge (roll), while
    normals and gradients zero their one-pixel border, as in the JAX code."""
    rng = np.random.default_rng(1)
    d = rng.uniform(1.0, 1.1, size=(12, 16)).astype(np.float32)
    d[3, 4] = 0.0
    want = np.asarray(jcam.bilateral_depth_filter(jnp.asarray(d)))
    got = tcam.bilateral_depth_filter(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got[3, 4] == 0.0
    img = torch.from_numpy(rng.uniform(size=(12, 16)).astype(np.float32))
    g = tcam.image_gradients(img)
    np.testing.assert_allclose(g.numpy(), np.asarray(
        jcam.image_gradients(jnp.asarray(img.numpy()))), atol=ATOL)
    assert float(g[0].abs().sum() + g[-1].abs().sum() + g[:, 0].abs().sum()
                 + g[:, -1].abs().sum()) == 0.0


def test_render_frame_matches_jax():
    cam = CameraIntrinsics(fx=114.1, fy=114.1, cx=63.5, cy=47.5,
                           width=128, height=96)
    pose = jsyn.orbit_trajectory(4, sweep=True)[3]
    dj, cj = (np.asarray(x) for x in jsyn.render_frame(jnp.asarray(pose), cam))
    dt, ct = tsyn.render_frame(pose, cam)
    dt, ct = dt.numpy(), ct.numpy()
    assert dt.shape == dj.shape and ct.shape == cj.shape and ct.dtype == np.uint8
    # depth is quantized to 1 mm and colour to 1/255: float rounding moves a
    # value across a step rarely (<= 1 unit); a silhouette or checker edge
    # can flip a whole pixel, allowed on at most 0.5% of pixels
    ddiff = np.abs(dt.astype(np.int64) - dj.astype(np.int64))
    cdiff = np.abs(ct.astype(np.int64) - cj.astype(np.int64))
    assert np.mean(ddiff > 1) <= 0.005 and np.mean(cdiff.max(-1) > 1) <= 0.005
    assert np.mean(ddiff == 0) > 0.95


def test_orbit_trajectory_matches_jax():
    for sweep in (False, True):
        want = jsyn.orbit_trajectory(30, sweep=sweep)
        got = tsyn.orbit_trajectory(30, sweep=sweep)
        # 30 composed float32 steps: rounding accumulates to ~1e-6
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_trajectory_io_and_ate_match_jax(tmp_path, rng):
    poses = jsyn.orbit_trajectory(25, sweep=True)
    ts = np.arange(25) / 30.0
    est = poses.copy()
    est[:, :3, 3] += rng.normal(size=(25, 3)).astype(np.float32) * 0.01
    pt, pj = tmp_path / "t.txt", tmp_path / "j.txt"
    ttraj.save_trajectory_tum(str(pt), ts, est)
    jtraj.save_trajectory_tum(str(pj), ts, est)
    assert pt.read_text() == pj.read_text()
    ts2, est2 = ttraj.load_trajectory_tum(str(pj))
    ts3, est3 = jtraj.load_trajectory_tum(str(pt))
    np.testing.assert_array_equal(ts2, ts3)
    np.testing.assert_array_equal(est2, est3)
    np.testing.assert_allclose(est2, est, atol=2e-6)  # 6 decimals in the file
    assert ttraj.ate_rmse(est, poses)[0] == jtraj.ate_rmse(est, poses)[0]
    assert ttraj.rpe(est, poses, 2) == jtraj.rpe(est, poses, 2)
    for T in est[:5]:
        q = ttraj.matrix_to_quat(T[:3, :3].astype(np.float64))
        np.testing.assert_allclose(ttraj.quat_to_matrix(*q), T[:3, :3], atol=1e-6)


def test_port_never_imports_jax():
    """Every port module imports without jax and without anything of the
    JAX package. A subprocess: this test process imported both already."""
    code = (
        "import sys, pkgutil, importlib, slam_rgbd_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "for need in ('runtime.session', 'ops.hamming', 'ops.gn_reduce', 'features.detect',\n"
        "             'features.orb', 'features.match', 'features.pose3d', 'mapping.map',\n"
        "             'backend.pose_graph', 'backend.ba', 'backend.loop', 'backend.worker',\n"
        "             'io.synthetic', 'io.stream', 'io.native', 'io.tum', 'io.icl_nuim',\n"
        "             'io.faults', 'io.grabber', 'runtime.watchdog', 'runtime.profiling',\n"
        "             'runtime.runner', 'runtime.checkpoint', 'runtime.staging',\n"
        "             'viz.pointcloud', 'viz.server', 'viz.native',\n"
        "             'runtime.batch_session', 'core.config', 'interop', '__main__',\n"
        "             'parallel.mesh', 'parallel.dist', 'parallel.scaling',\n"
        "             'runtime.frame_graph', 'benchmarks'):\n"
        "    assert p.__name__ + '.' + need in sys.modules, need\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "ref = [k for k in sys.modules if k == 'slam_rgbd_tpu' or k.startswith('slam_rgbd_tpu.')]\n"
        "assert not ref, ref\n"
        "print(len(mods))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 52


def test_chip_smoke_imports_nothing_of_jax_or_the_jax_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(root, "chip_smoke.py")).read()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "jax" not in s and "slam_rgbd_tpu " not in s + " ", s
            assert "slam_rgbd_tpu." not in s, s


@pytest.mark.parametrize("profile", ["astra_default_config", "tum_fr1_config",
                                     "tum_fr2_config"])
def test_config_copy_equals_the_jax_package_tree(profile, tmp_path):
    """The port keeps its own copy of the configuration tree: the same
    classes, fields and defaults, field by field, and one YAML for both."""
    import dataclasses

    from slam_rgbd_tpu.core import config as jcfg
    from slam_rgbd_tpu_torch.core import config as tcfg

    a, b = getattr(jcfg, profile)(), getattr(tcfg, profile)()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(jcfg.SLAMConfig()) == dataclasses.asdict(tcfg.SLAMConfig())
    names = lambda mod: sorted(
        (n, [f.name for f in dataclasses.fields(c)]) for n, c in vars(mod).items()
        if dataclasses.is_dataclass(c) and isinstance(c, type))
    assert names(jcfg) == names(tcfg)
    # class by class, the defaults the backend and the batch session read
    # (BAConfig: window, iters, damping, reject_px, pg_*, loop_*; MeshConfig
    # stays in the tree though the port has no mesh yet)
    for cls in ("BAConfig", "KeyframeConfig", "ICPConfig", "ORBConfig", "MeshConfig"):
        assert dataclasses.asdict(getattr(jcfg, cls)()) == dataclasses.asdict(
            getattr(tcfg, cls)()), cls
    assert b.ba.window == 8 and b.ba.max_points_per_window == 2048
    path = tmp_path / "cfg.yaml"
    b.to_yaml(str(path))
    assert dataclasses.asdict(jcfg.SLAMConfig.from_yaml(str(path))) == dataclasses.asdict(b)
    assert tcfg.SLAMConfig.from_yaml(str(path)) == b
    assert a.camera.scaled(2.0).fx == b.camera.scaled(2.0).fx
