"""The port's GN reduction vs the JAX package's two versions of it.

`gn_reduce_reference` (the plain torch version the CPU wrapper takes) is
held against `ops.icp_pallas.gn_reduce` in interpret mode and against
`odometry.icp._normal_equations` with the same dominant-flow shift, at the
three shapes of `tests/test_icp_pallas.py` and at two cases built to sit on
the association gates. The CUDA kernel is held against the plain version in
`tests/test_torch_cuda.py`, which needs a card.

Tolerances are those of `tests/test_icp_pallas.py:60-71`: the three
versions sum the same float32 terms in different orders, so H and g are
compared relative to their largest entry (atol 2e-6 and 5e-5) and sq_sum by
rtol 1e-4. Inlier counts are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.core import camera as jcam
from slam_rgbd_tpu.core.config import CameraIntrinsics, ICPConfig
from slam_rgbd_tpu.odometry import icp as jicp
from slam_rgbd_tpu.ops import icp_pallas as ip
from slam_rgbd_tpu_torch.core import camera as tcam
from slam_rgbd_tpu_torch.interop import pyramid_from_numpy
from slam_rgbd_tpu_torch.odometry import icp as ticp
from slam_rgbd_tpu_torch.ops import gn_reduce as tg

# one intra-op thread: torch's spinning thread pool would otherwise take
# every core from the test workers running beside this one
torch.set_num_threads(1)


def _scene(cam, shift=(0, 0), seed=0, hole_col=None, flat=False):
    """Target / source levels (numpy dicts) of a textured surface; the
    source is the target rolled by `shift`. `flat` gives constant depth,
    `hole_col` a column of missing depth in the target only."""
    h, w = cam.height, cam.width
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    if flat:
        depth = np.full((h, w), 1500, np.uint16)
    else:
        depth = (1400 + 320 * np.sin(u / 15.0 + seed)
                 + 240 * np.cos(v / 11.0)).astype(np.uint16)
        depth[h // 4: h // 4 + 6, w // 3: w // 3 + 20] = 0
    rgb = ((128 + 90 * np.sin(u / 5.0 + seed) * np.cos(v / 7.0))
           .clip(0, 255).astype(np.uint8)[..., None].repeat(3, -1))
    tgt_depth = depth.copy()
    if hole_col is not None:
        tgt_depth[:, hole_col] = 0

    def level(d, c):
        pyr = jcam.build_frame_pyramid(jnp.asarray(d), cam, levels=1,
                                       rgb=jnp.asarray(c))
        return jax.tree.map(np.array, pyr[0])  # writable copies

    return (level(np.roll(depth, shift, (0, 1)), np.roll(rgb, shift, (0, 1))),
            level(tgt_depth, rgb))


def _mu(T, src, cam):
    _, up, vp, _ = jicp._project_level(jnp.asarray(T), jnp.asarray(src["vertices"]), cam)
    return jicp.flow_shift(up, vp, cam.height, cam.width)


def _port_planes(src, tgt):
    (s,), (t,) = pyramid_from_numpy([src], "cpu"), pyramid_from_numpy([tgt], "cpu")
    return ticp.level_planes(s)[: tg.SRC_CHANNELS].contiguous(), ticp.level_planes(t)


def _reduce_three(cam, radius, T, src, tgt, mu=None):
    """(XLA stencil, Pallas interpret, port plain) results for one level."""
    cfg = ICPConfig(levels=1, iters=(1,), window_px=(radius,))
    h, w = cam.height, cam.width
    mu_u, mu_v = _mu(T, src, cam) if mu is None else (jnp.int32(mu[0]), jnp.int32(mu[1]))
    Tj = jnp.asarray(T)
    src_j = jax.tree.map(jnp.asarray, src)
    tgt_j = jax.tree.map(jnp.asarray, tgt)
    xla = jicp._normal_equations(Tj, jicp._pack_level(src_j, tgt_j), cam, cfg,
                                 radius, shift=(mu_u, mu_v))
    th, n_tiles, w_pad = ip.plan_tiles(h, w, radius)
    pallas = ip.gn_reduce(
        ip.pack_scalars(Tj, mu_u, mu_v),
        ip.build_source_planes(src_j, th, n_tiles, w_pad),
        ip.build_target_planes(tgt_j, mu_u, mu_v, radius, th, n_tiles, w_pad),
        cam, cfg, radius, (h, w), interpret=True,
    )
    sp, tp = _port_planes(src, tgt)
    mu_t = torch.tensor([float(mu_u), float(mu_v)])
    port = tg.gn_reduce(torch.from_numpy(np.asarray(T, np.float32)), mu_t, sp,
                        tp, cam, cfg, radius)
    return xla, pallas, port


def _assert_close(got, want):
    H1, g1, inl1, sq1 = (np.asarray(x) for x in got)
    H0, g0, inl0, sq0 = (np.asarray(x) for x in want)
    assert int(inl1) == int(inl0), (int(inl1), int(inl0))
    h_scale = max(1.0, float(np.max(np.abs(H0))))
    np.testing.assert_allclose(H1 / h_scale, H0 / h_scale, atol=2e-6)
    g_scale = max(1.0, float(np.max(np.abs(g0))))
    np.testing.assert_allclose(g1 / g_scale, g0 / g_scale, atol=5e-5)
    np.testing.assert_allclose(float(sq1), float(sq0), rtol=1e-4)


def _t(tx=0.0, ty=0.0, yaw_z=0.0):
    c, s = np.cos(yaw_z), np.sin(yaw_z)
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[c, -s], [s, c]]
    T[0, 3], T[1, 3] = tx, ty
    return T


SHAPES = [  # the cases of tests/test_icp_pallas.py:75-103
    (CameraIntrinsics(fx=80.0, fy=80.0, cx=63.5, cy=31.5, width=128, height=64),
     2, (1, 2), 0, _t(0.01, -0.004)),
    (CameraIntrinsics(fx=120.0, fy=120.0, cx=255.5, cy=99.5, width=512, height=200),
     2, (-2, 3), 1, _t(0.0, 0.008)),
    (CameraIntrinsics(fx=90.0, fy=90.0, cx=95.5, cy=47.5, width=192, height=96),
     4, (2, -3), 2, _t()),
]


@pytest.mark.parametrize("case", range(len(SHAPES)), ids=["128x64r2", "512x200r2", "192x96r4"])
def test_reference_matches_jax_shapes(case):
    cam, radius, shift, seed, T = SHAPES[case]
    src, tgt = _scene(cam, shift=shift, seed=seed)
    xla, pallas, port = _reduce_three(cam, radius, T, src, tgt)
    assert int(port[2]) > 1000
    _assert_close(port, xla)
    _assert_close(port, pallas)


def test_window_edge_displacement():
    """A roll about the optical axis spreads the residual displacement over
    the window edge: some pixels fall just inside [-R, R+1], some just
    outside. All three versions must keep and drop the same pixels."""
    cam, radius = SHAPES[0][0], 2
    src, tgt = _scene(cam)
    T = _t(yaw_z=np.deg2rad(3.3))
    mu_u, mu_v = _mu(T, src, cam)
    _, up, vp, _ = ticp._project_level(
        torch.from_numpy(T), torch.from_numpy(src["vertices"]), cam)
    u, v = tcam.pixel_grid(cam.height, cam.width)
    disp = torch.maximum((up - u - int(mu_u)).abs(), (vp - v - int(mu_v)).abs())
    valid = torch.from_numpy(src["valid"])
    assert int(((disp > radius + 1) & (disp < radius + 2) & valid).sum()) > 50
    assert int(((disp > radius) & (disp < radius + 1) & valid).sum()) > 50
    xla, pallas, port = _reduce_three(cam, radius, T, src, tgt)
    _assert_close(port, xla)
    _assert_close(port, pallas)


def test_invalid_corner_below_weight_gate():
    """A corner of weight < 0.001 may be invalid and the pixel still passes
    (`wsum > 0.999` and `sum w*valid > 0.999`, icp_pallas.py:263,305).

    Constant depth, a flow of 0.9995 px: with mu_u = 1 every pixel's left
    corner weighs 0.0005. Column 61 of the target is invalid (the missing
    column 60 breaks its normal), so source column 61 samples an invalid
    corner at weight 0.0005 and must still count; column 60, whose heavy
    corner is invalid, must not."""
    cam = SHAPES[0][0]
    src, tgt = _scene(cam, hole_col=60, flat=True)
    assert not tgt["valid"][:, 59:62].any() and tgt["valid"][1:-1, 62].all()
    T = _t(tx=0.9995 * 1.5 / cam.fx)
    for col, expect_pass in ((61, True), (60, False)):
        only = dict(src, valid=np.zeros_like(src["valid"]))
        only["valid"][:, col] = src["valid"][:, col]
        xla, pallas, port = _reduce_three(cam, 2, T, only, tgt, mu=(1, 0))
        n_src = int(only["valid"].sum())
        assert int(port[2]) == (n_src if expect_pass else 0), (col, int(port[2]))
        _assert_close(port, xla)
        _assert_close(port, pallas)


def test_wrapper_dispatch_on_cpu():
    """A CPU tensor takes the plain version and launches nothing; malformed
    input raises."""
    cam, radius, shift, seed, T = SHAPES[0]
    src, tgt = _scene(cam, shift=shift, seed=seed)
    sp, tp = _port_planes(src, tgt)
    Tt, mu = torch.from_numpy(T), torch.tensor([1.0, 0.0])
    cfg = ICPConfig(levels=1, iters=(1,), window_px=(radius,))
    before = tg.gn_reduce.launches
    got = tg.gn_reduce(Tt, mu, sp, tp, cam, cfg, radius)
    want = tg.gn_reduce_reference(Tt, mu, sp, tp, cam, cfg, radius)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tg.gn_reduce.launches == before
    with pytest.raises(ValueError):
        tg.gn_reduce(Tt, mu, tp, tp, cam, cfg, radius)  # 10 source planes
    with pytest.raises(ValueError):
        tg.gn_reduce(Tt.double(), mu, sp, tp, cam, cfg, radius)
    with pytest.raises(ValueError):
        tg.gn_reduce(Tt, mu, sp, tp[:, :, :-1], cam, cfg, radius)
