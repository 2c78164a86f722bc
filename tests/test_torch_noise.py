"""The port's sensor-noise model (`io.synthetic.NoiseSpec`) vs the JAX package.

`jax.random` bits cannot be drawn in torch, so the parity test takes the
JAX draws of a frame (the five keys `apply_sensor_noise` splits from its
frame key) and feeds them to the port's deterministic core: depth agrees to
1 sensor unit and RGB to 1 level (float32 rounding at a cast's boundary).
The port's own draws are held to their distributions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.core import se3 as jse3
from slam_rgbd_tpu.core.config import CameraIntrinsics as JCam
from slam_rgbd_tpu.io import synthetic as jsyn
from slam_rgbd_tpu_torch.core.config import CameraIntrinsics
from slam_rgbd_tpu_torch.io import synthetic as tsyn

torch.set_num_threads(1)

CAM = CameraIntrinsics(fx=142.6, fy=142.6, cx=79.5, cy=59.5, width=160, height=120)
JCAM = JCam(fx=142.6, fy=142.6, cx=79.5, cy=59.5, width=160, height=120)
N = 12
SPECS = {
    "default": {},
    # the degraded leg's: motion blur along the flow, exposure drift
    "degraded": dict(motion_blur=1.0, exposure_drift=0.08),
    # larger blur and stronger noise: rolls of several pixels, more dropout
    "heavy": dict(motion_blur=4.0, exposure_drift=0.3, rgb_sigma=6.0,
                  random_dropout=0.05, depth_sigma_rel2=5e-3),
}


@pytest.fixture(scope="module")
def sweep():
    poses = jsyn.orbit_trajectory(N, sweep=True, step_r=0.03)
    frames = [tuple(np.asarray(x) for x in jsyn.render_frame(jnp.asarray(p), JCAM))
              for p in poses]
    return poses, frames


def _jax_draws(spec, i, shape):
    """The draws the JAX `apply_sensor_noise` makes for frame i, in its
    order: normal (depth), uniform (edges), uniform (dropout), normal
    (RGB), uniform (gain)."""
    key = jax.random.fold_in(jax.random.key(spec.seed), i)
    k_z, k_edge, k_drop, k_rgb, k_gain = jax.random.split(key, 5)
    h, w = shape
    return tsyn.NoiseDraws(*(torch.tensor(np.asarray(x)) for x in (
        jax.random.normal(k_z, (h, w)), jax.random.uniform(k_edge, (h, w)),
        jax.random.uniform(k_drop, (h, w)), jax.random.normal(k_rgb, (h, w, 3)),
        jax.random.uniform(k_gain, ()),
    )))


def _jax_flow(poses, i):
    """The flow the JAX sequence computes for frame i."""
    j = max(i - 1, 0)
    xi = np.asarray(jse3.log(jnp.asarray(
        (np.linalg.inv(poses[j]) @ poses[min(j + 1, len(poses) - 1)]).astype(np.float32))))
    return np.asarray([JCAM.fx * abs(xi[4]), JCAM.fy * abs(xi[3])], np.float32)


def _edge_test_on_threshold(depth, spec):
    """Pixels where a neighbour's depth step is within 1e-7 m of the
    silhouette threshold edge_rel_tol * max(z, 0.5)."""
    z = depth.astype(np.float32) * np.float32(1.0 / 1000.0)
    thr = np.float32(spec.edge_rel_tol) * np.maximum(z, np.float32(0.5))
    out = np.zeros(z.shape, bool)
    for ax, s in ((0, 1), (0, -1), (1, 1), (1, -1)):
        out |= np.abs(np.abs(np.roll(z, s, axis=ax) - z) - thr) < 1e-7
    return out


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("i", [0, 5, 11])
def test_noise_core_matches_jax_with_its_draws(sweep, name, i):
    poses, frames = sweep
    jspec = jsyn.NoiseSpec(**SPECS[name])
    tspec = tsyn.NoiseSpec(**SPECS[name])
    depth, rgb = frames[i]
    flow = _jax_flow(poses, i)
    np.testing.assert_allclose(tsyn.frame_flow(poses, i, CAM), flow, rtol=1e-5, atol=1e-4)
    key = jax.random.fold_in(jax.random.key(jspec.seed), i)
    jd, jc = jsyn.apply_sensor_noise(
        jnp.asarray(depth), jnp.asarray(rgb), key, JCAM, jspec,
        flow_px=jnp.asarray(flow), t_s=jnp.float32(i / 30.0))
    jd, jc = np.asarray(jd).astype(np.int64), np.asarray(jc).astype(np.int64)
    td, tc = tsyn.apply_sensor_noise(
        torch.tensor(depth.astype(np.int32)), torch.tensor(rgb),
        _jax_draws(jspec, i, depth.shape), CAM, tspec, flow_px=flow, t_s=i / 30.0)
    assert td.dtype == torch.int32 and tc.dtype == torch.uint8
    td, tc = td.numpy().astype(np.int64), tc.numpy().astype(np.int64)
    # a dropout may differ only where the silhouette test sits on its
    # threshold within float32 rounding: on the scene's quantized planes
    # |z_a - z_b| can equal 0.02 * 0.5 to the last bit, and XLA's CPU
    # program fuses z_a - z_b into a multiply-add that rounds once
    on_edge = _edge_test_on_threshold(depth, tspec)
    flipped = (td != jd) & ((td == 0) | (jd == 0))
    assert not (flipped & ~on_edge).any()
    assert flipped.sum() <= 8
    assert np.abs(td - jd)[~flipped].max() <= 1
    assert np.abs(tc - jc).max() <= 1
    # the noise did something: dropout holes, changed colours
    assert (jd == 0).sum() > (depth == 0).sum()
    assert np.abs(jc - rgb).mean() > 0.5
    # the exact share of equal values: the two round alike but at a
    # boundary (float32 products in another order)
    assert (td == jd).mean() > 0.99 and (tc == jc).mean() > 0.99


def test_port_draws_follow_their_distributions():
    spec = tsyn.NoiseSpec()
    d = tsyn.draw_noise(240, 320, spec, 3, "cpu")
    again = tsyn.draw_noise(240, 320, spec, 3, "cpu")
    other = tsyn.draw_noise(240, 320, spec, 4, "cpu")
    reseeded = tsyn.draw_noise(240, 320, dataclasses.replace(spec, seed=12), 3, "cpu")
    for a, b in zip(d, again):
        assert torch.equal(a, b)  # the same frame, the same draws
    assert not torch.equal(d.depth_normal, other.depth_normal)
    assert not torch.equal(d.depth_normal, reseeded.depth_normal)
    assert d.depth_normal.shape == (240, 320) and d.rgb_normal.shape == (240, 320, 3)
    assert d.gain_uniform.shape == ()
    n = 240 * 320
    for x in (d.depth_normal, d.rgb_normal):
        # mean within 5 standard errors, std within 2%
        assert abs(float(x.mean())) < 5 / np.sqrt(x.numel())
        assert abs(float(x.std()) - 1.0) < 0.02
    for u in (d.edge_uniform, d.drop_uniform):
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 5 * np.sqrt(1 / 12 / n)
        assert abs(float((u < spec.random_dropout).float().mean()) - spec.random_dropout) < 0.001
    assert 0.0 <= float(d.gain_uniform) < 1.0


def test_noisy_sequence_is_the_clean_one_through_the_model(sweep):
    """`SyntheticSequence(noise=...)` frames are its clean frames through
    `noisy_frame`; the degraded spec blurs and drops depth, deterministically."""
    spec = tsyn.NoiseSpec(motion_blur=1.0, exposure_drift=0.08)
    clean = tsyn.SyntheticSequence(N, CAM, sweep=True, step_r=0.03, device="cpu")
    noisy = tsyn.SyntheticSequence(N, CAM, sweep=True, step_r=0.03, noise=spec,
                                   device="cpu")
    for i in (0, 6):
        _, d0, c0 = clean.frame(i)
        _, d1, c1 = noisy.frame(i)
        _, d2, c2 = noisy.frame(i)
        assert d1.dtype == np.uint16 and c1.dtype == np.uint8
        assert np.array_equal(d1, d2) and np.array_equal(c1, c2)
        dn, cn = tsyn.noisy_frame(torch.tensor(d0.astype(np.int32)), torch.tensor(c0),
                                  i, clean.poses, CAM, spec)
        assert np.array_equal(dn.numpy(), d1) and np.array_equal(cn.numpy(), c1)
        assert (d1 == 0).sum() > (d0 == 0).sum() and not np.array_equal(c1, c0)
        valid = (d1 > 0) & (d0 > 0)
        # axial noise ~ 1.4 mm at 1 m: small against the range
        assert np.median(np.abs(d1[valid].astype(np.int64) - d0[valid])) < 20
