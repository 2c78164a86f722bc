"""The port's dataset loaders, fault injector and grabber against the JAX
package: the golden TUM directory (through PIL and through the built-in PNG
decoder), ICL-NUIM in both layouts, `FaultInjector` with one seed, and the
grabber's retry / reinit policy.
"""

import os

import numpy as np
import pytest

from slam_rgbd_tpu.core.config import tum_fr1_config as jtum_cfg
from slam_rgbd_tpu.io import faults as jfaults
from slam_rgbd_tpu.io import grabber as jgrabber
from slam_rgbd_tpu.io import icl_nuim as jicl
from slam_rgbd_tpu.io import tum as jtum
from slam_rgbd_tpu_torch.core.config import CameraIntrinsics, StreamConfig, tum_fr1_config
from slam_rgbd_tpu_torch.io import faults as tfaults
from slam_rgbd_tpu_torch.io import grabber as tgrabber
from slam_rgbd_tpu_torch.io import icl_nuim as ticl
from slam_rgbd_tpu_torch.io import tum as ttum
from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "tum_golden")
SMALL_CAM = CameraIntrinsics(fx=40.0, fy=40.0, cx=4.5, cy=3.5, width=10, height=8)


def _frames_equal(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_tum_golden_equals_jax_through_pil():
    want = jtum.TUMSequence(GOLDEN, jtum_cfg().camera)
    got = ttum.TUMSequence(GOLDEN, tum_fr1_config().camera)
    assert len(got) == len(want) == 3
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert got._depth_files == want._depth_files and got._rgb_files == want._rgb_files
    np.testing.assert_array_equal(got.groundtruth(), want.groundtruth())
    assert got.groundtruth().dtype == np.float32
    for i in range(3):
        _frames_equal(got.frame(i), want.frame(i))


def test_tum_golden_through_the_builtin_decoder(monkeypatch):
    """The path without PIL: through the built-in decoder, a golden
    frame (16-bit depth, 8-bit colour, adaptive row filters) equals the JAX
    loader's through PIL."""
    pytest.importorskip("PIL.Image")
    want = jtum.TUMSequence(GOLDEN, jtum_cfg().camera).frame(0)
    monkeypatch.setattr(ttum, "_read_png", ttum._read_png_builtin)
    _frames_equal(ttum.TUMSequence(GOLDEN, tum_fr1_config().camera).frame(0), want)


def test_association_and_quaternions_match_jax():
    rng = np.random.default_rng(0)
    a = [(t, ["a"]) for t in np.sort(rng.uniform(0, 2, 40))]
    b = [(t, ["b"]) for t in np.sort(rng.uniform(0, 2, 50))]
    assert ttum.associate(a, b, 0.02) == jtum.associate(a, b, 0.02)
    q = rng.normal(size=4)
    np.testing.assert_array_equal(ttum.quat_to_matrix(*q), jtum.quat_to_matrix(*q))
    R = jtum.quat_to_matrix(*q)
    assert ttum.matrix_to_quat(R) == jtum.matrix_to_quat(R)


def _write_png(path, arr):
    import PIL.Image

    PIL.Image.fromarray(arr).save(path)


def test_icl_nuim_raw_layout_equals_jax(tmp_path):
    pytest.importorskip("PIL.Image")
    cam = SMALL_CAM
    rng = np.random.default_rng(1)
    gt_lines = ["# frame tx ty tz qx qy qz qw"]
    for k in range(3):
        ray = rng.uniform(1.0, 3.0, size=(cam.height, cam.width))
        np.savetxt(tmp_path / f"scene_00_{k:04d}.depth", ray.reshape(1, -1))
        if k != 2:  # the last frame has no colour file
            _write_png(tmp_path / f"scene_00_{k:04d}.png",
                       rng.integers(0, 255, (cam.height, cam.width, 3)).astype(np.uint8))
        q = rng.normal(size=4)
        gt_lines.append(f"{k} {0.1 * k} 0.2 -0.1 {q[0]} {q[1]} {q[2]} {q[3]}")
    (tmp_path / "livingRoom0.gt.freiburg").write_text("\n".join(gt_lines))
    want = jicl.ICLNUIMSequence(str(tmp_path), cam, fps=30.0)
    got = ticl.ICLNUIMSequence(str(tmp_path), cam, fps=30.0)
    assert len(got) == len(want) == 3
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    np.testing.assert_array_equal(got.groundtruth(), want.groundtruth())
    for i in range(3):
        _frames_equal(got.frame(i), want.frame(i))
    ray = rng.uniform(0.5, 4.0, size=(cam.height, cam.width))
    np.testing.assert_array_equal(ticl.ray_to_planar_depth(ray, cam),
                                  jicl.ray_to_planar_depth(ray, cam))
    assert ticl.icl_nuim_camera() == ticl.CameraIntrinsics(**vars(jicl.icl_nuim_camera()))


def test_icl_nuim_tum_layout_equals_jax(tmp_path):
    pytest.importorskip("PIL.Image")
    cam = SMALL_CAM
    os.makedirs(tmp_path / "depth")
    os.makedirs(tmp_path / "rgb")
    rng = np.random.default_rng(2)
    rows = {"depth": [], "rgb": []}
    for k in range(3):
        ts = k / 30.0
        _write_png(tmp_path / "depth" / f"{ts:.6f}.png",
                   rng.integers(500, 5000, (cam.height, cam.width)).astype(np.uint16))
        _write_png(tmp_path / "rgb" / f"{ts + 0.003:.6f}.png",
                   rng.integers(0, 255, (cam.height, cam.width, 3)).astype(np.uint8))
        rows["depth"].append(f"{ts:.6f} depth/{ts:.6f}.png")
        rows["rgb"].append(f"{ts + 0.003:.6f} rgb/{ts + 0.003:.6f}.png")
    for kind, lines in rows.items():
        (tmp_path / f"{kind}.txt").write_text("\n".join(lines))
    (tmp_path / "groundtruth.txt").write_text(
        "\n".join(f"{k / 30.0:.6f} {k} 0 0 0 0 0 1" for k in range(3)))
    want = jicl.ICLNUIMSequence(str(tmp_path), cam)
    got = ticl.ICLNUIMSequence(str(tmp_path), cam)
    assert len(got) == len(want) == 3
    np.testing.assert_array_equal(got.groundtruth(), want.groundtruth())
    for i in range(3):
        _frames_equal(got.frame(i), want.frame(i))
    with pytest.raises(FileNotFoundError):
        ticl.ICLNUIMSequence(str(tmp_path / "depth"), cam)


class _Source:
    """Frames as numpy arrays with ground truth, for both packages."""

    def __init__(self, n=10, seed=3):
        rng = np.random.default_rng(seed)
        self.frames = [(i / 30.0, rng.integers(0, 4000, (12, 16)).astype(np.uint16),
                        rng.integers(0, 256, (12, 16, 3)).astype(np.uint8))
                       for i in range(n)]
        self.gt = np.repeat(np.eye(4, dtype=np.float32)[None], n, 0)
        self.gt[:, 0, 3] = np.arange(n)

    def __len__(self):
        return len(self.frames)

    def __iter__(self):
        return iter(self.frames)

    def groundtruth(self):
        return self.gt


@pytest.mark.parametrize("seed", [0, 7])
def test_fault_injector_equals_jax(seed):
    kw = dict(drop_frames=(1, 6), blackout_frames=(2,), corrupt_frames=(3, 8),
              noise_mm=4.0, freeze_frames=(4, 9), seed=seed)
    want = jfaults.FaultInjector(_Source(), jfaults.FaultSpec(**kw))
    got = tfaults.FaultInjector(_Source(), tfaults.FaultSpec(**kw))
    a, b = list(got), list(want)
    assert len(a) == len(b) == len(got) == 8
    for x, y in zip(a, b):
        _frames_equal(x, y)
    assert vars(got.report) == vars(want.report)
    np.testing.assert_array_equal(got.groundtruth(), want.groundtruth())


SYN_CAM = CameraIntrinsics(fx=40.0, fy=40.0, cx=15.5, cy=11.5, width=32, height=24)


def _scripted(base):
    """A grabber of package `base` that fails its first `fail_open` opens and
    the grabs at `fail_at`, and yields 12 frames."""

    class Scripted(base.FrameGrabber):
        def __init__(self, fail_open=0, fail_at=()):
            self.fail_open, self.fail_at = fail_open, set(fail_at)
            self.i, self.opened, self.open_attempts = 0, False, 0

        def open(self):
            self.open_attempts += 1
            if self.open_attempts <= self.fail_open:
                raise OSError("open failure")
            self.opened = True

        def grab(self):
            if self.i >= 12:
                raise StopIteration
            i, self.i = self.i, self.i + 1
            if i in self.fail_at:
                raise OSError(f"grab failure {i}")
            return i / 30.0, np.full((2, 2), i, np.uint16), np.zeros((2, 2, 3), np.uint8)

        def close(self):
            self.opened = False

    return Scripted


def test_grabber_source_retries_as_the_jax_one():
    """A failed open, then grab failures: one survives, five in a row
    reinitialize; the same frames, reinits and opens in both packages."""
    cfg = StreamConfig(init_retries=3, max_consecutive_errors=5)
    script = [dict(fail_open=1), dict(fail_at=(2, 5, 6, 7, 8, 9)), {}]
    runs = []
    for mod in (tgrabber, jgrabber):
        made, cls = [], _scripted(mod)

        def factory(made=made, cls=cls):
            made.append(cls(**script[len(made)]))
            return made[-1]

        src = mod.GrabberSource(factory, stream_cfg=cfg)
        frames = [(ts, int(d[0, 0])) for ts, d, _ in src]
        runs.append((frames, src.reinit_count, [g.open_attempts for g in made],
                     [g.opened for g in made]))
    assert runs[0] == runs[1]
    assert runs[0][1] == 1 and len(runs[0][0]) == 4 + 12


def test_synthetic_grabber_hands_out_host_frames():
    """The port's camera double: the host frames of the port's
    `SyntheticSequence`, through an injected open and grab failure."""
    made = []

    def factory():
        made.append(tgrabber.SyntheticGrabber(SYN_CAM, n_frames=5, fail_open=0 if made else 1,
                                              fail_at=(2,), device="cpu"))
        return made[-1]

    src = tgrabber.GrabberSource(factory, stream_cfg=StreamConfig())
    frames = list(src)
    assert [round(ts * 30) for ts, _, _ in frames] == [0, 1, 3, 4]
    assert made[-1].intrinsics == SYN_CAM and src.reinit_count == 0
    seq = SyntheticSequence(5, SYN_CAM, device="cpu")
    for ts, depth, rgb in frames:
        assert isinstance(depth, np.ndarray) and depth.dtype == np.uint16
        _frames_equal((ts, depth, rgb), seq.frame(round(ts * 30)))


def test_resolve_grabber():
    f = tgrabber.resolve_grabber("slam_rgbd_tpu_torch.io.grabber:SyntheticGrabber")
    assert f is tgrabber.SyntheticGrabber
    with pytest.raises(ValueError):
        tgrabber.resolve_grabber("no_colon")
