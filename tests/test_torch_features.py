"""The port's feature stage vs the JAX package on a rendered 160x120 frame:
pyramid, FAST / Harris / NMS maps, keypoints, descriptors, keypoint depth.

The stencil maps are compared on the same input image and agree exactly
(the same float32 operations in the same order). The pyramid agrees to 1e-6
(two small matrix products a level, summed in another order). Descriptors
are compared on the keypoints of the JAX run, with a stated bit floor:
BRIEF bits flip under last-bit differences of atan2 / cos / sin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.core import camera as jcam
from slam_rgbd_tpu.core.config import CameraIntrinsics, ORBConfig
from slam_rgbd_tpu.features import detect as jdet
from slam_rgbd_tpu.features import orb as jorb
from slam_rgbd_tpu.io import synthetic as jsyn
from slam_rgbd_tpu.runtime import session as jsess
from slam_rgbd_tpu_torch import interop
from slam_rgbd_tpu_torch.features import detect as tdet
from slam_rgbd_tpu_torch.features import orb as torb
from slam_rgbd_tpu_torch.runtime import session as tsess

torch.set_num_threads(1)

CAM = CameraIntrinsics(fx=142.6, fy=142.6, cx=79.5, cy=59.5, width=160, height=120)
ORB = ORBConfig(n_features=256)


@pytest.fixture(scope="module")
def frame():
    pose = jsyn.orbit_trajectory(4, sweep=True)[3]
    depth, rgb = (np.array(x) for x in jsyn.render_frame(jnp.asarray(pose), CAM))
    intensity = np.asarray(jcam.rgb_to_intensity(jnp.asarray(rgb)) / 255.0)
    return depth, rgb, intensity


@pytest.fixture(scope="module")
def jax_features(frame):
    _, _, intensity = frame
    kp, pyr = jdet.detect_pyramid(jnp.asarray(intensity), n_features=ORB.n_features)
    return kp, pyr, jorb.describe(kp, pyr)


def test_level_shapes_and_budgets_match_jax():
    for h, w, k in ((480, 640, 1024), (120, 160, 256), (96, 128, 100)):
        assert tdet._level_shapes(h, w, 8, 1.2) == jdet._level_shapes(h, w, 8, 1.2)
        assert tdet._per_level_budget(k, 8, 1.2) == jdet._per_level_budget(k, 8, 1.2)
        assert sum(tdet._per_level_budget(k, 8, 1.2)) == k


def test_pyramid_levels_match_jax(frame, jax_features):
    _, pyr_j, _ = jax_features
    pyr_t = tdet.build_pyramid(torch.tensor(frame[2]), 8, 1.2)
    assert len(pyr_t) == len(pyr_j) == 8
    for a, b in zip(pyr_t, pyr_j):
        assert tuple(a.shape) == b.shape
        # antialiased linear resize, level from level: 1e-6 after 7 resizes
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("level", [0, 2, 5])
def test_fast_harris_nms_maps_match_jax(jax_features, level):
    x = np.asarray(jax_features[1][level]) * 255.0
    xt, xj = torch.tensor(x), jnp.asarray(x)
    for thresh in (20.0, 7.0):
        corner_t, score_t = tdet.fast_score(xt, thresh)
        corner_j, score_j = jdet.fast_score(xj, thresh)
        np.testing.assert_array_equal(corner_t.numpy(), np.asarray(corner_j))
        np.testing.assert_array_equal(score_t.numpy(), np.asarray(score_j))
    assert int(corner_t.sum()) > 20
    harris_j = np.asarray(jdet.harris_response(xj))
    np.testing.assert_array_equal(tdet.harris_response(xt).numpy(), harris_j)
    np.testing.assert_array_equal(
        tdet.nms_mask(torch.tensor(harris_j)).numpy(),
        np.asarray(jdet.nms_mask(jnp.asarray(harris_j))))
    # the blur of the descriptor stage wraps at the border alike
    np.testing.assert_array_equal(torb.smooth(xt).numpy(), np.asarray(jorb.smooth(xj)))


def test_detect_level_on_jax_pyramid_is_exact(jax_features):
    """On the same level image every response is the same float, so the
    stable sort returns top_k's order, ties included."""
    img = np.asarray(jax_features[1][1])
    uv_t, resp_t, valid_t = tdet.detect_level(torch.tensor(img), 60, 20.0, 7.0)
    uv_j, resp_j, valid_j = jdet.detect_level(jnp.asarray(img), 60, 20.0, 7.0)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(resp_t.numpy(), np.asarray(resp_j))


def test_detect_level_ties_take_the_lower_index():
    """A periodic image has exact plateaus of the response: the lower pixel
    index comes first, as `jax.lax.top_k` orders them."""
    yy, xx = np.meshgrid(np.arange(96), np.arange(128), indexing="ij")
    img = (((xx % 16 < 6) & (yy % 16 < 6)) * 0.6 + 0.2).astype(np.float32)  # squares
    uv_t, _, valid_t = tdet.detect_level(torch.tensor(img), 64, 20.0, 7.0)
    uv_j, _, valid_j = jdet.detect_level(jnp.asarray(img), 64, 20.0, 7.0)
    assert int(valid_t.sum()) > 8
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))


def test_keypoints_match_jax(frame, jax_features):
    kp_j = jax_features[0]
    kp_t, _ = tdet.detect_pyramid(torch.tensor(frame[2]), n_features=ORB.n_features)
    np.testing.assert_array_equal(kp_t.level.numpy(), np.asarray(kp_j.level))
    valid_j = np.asarray(kp_j.valid)
    # levels >= 1 differ by <= 3e-7 in intensity: a response near a tie or a
    # threshold may change rank, on at most 5% of the keypoints
    assert (kp_t.valid.numpy() != valid_j).mean() <= 0.02
    same = (kp_t.uv.numpy() == np.asarray(kp_j.uv)).all(axis=1)
    assert same[valid_j].mean() >= 0.95
    first = tdet._per_level_budget(ORB.n_features, 8, 1.2)[0]
    assert same[:first].all()  # level 0 is the input itself: exact
    np.testing.assert_allclose(kp_t.response.numpy()[same], np.asarray(kp_j.response)[same],
                               rtol=1e-4, atol=1e-3)
    assert kp_t.uv.dtype == torch.float32 and kp_t.level.dtype == torch.int32


def test_descriptors_on_jax_keypoints(jax_features):
    """Bit floor: >= 99% of all bits equal and every valid keypoint within
    Hamming 8 of its JAX descriptor; orientation to 1e-3 rad."""
    kp_j, pyr_j, desc_j = jax_features
    kp_t = interop.keypoints_from_numpy(kp_j, "cpu")
    desc_t = torb.describe(kp_t, tuple(torch.tensor(np.asarray(p)) for p in pyr_j))
    valid = np.asarray(kp_j.valid)
    ham = (desc_t.signs.numpy() != np.asarray(desc_j.signs)).sum(axis=1)
    assert ham[valid].sum() <= 0.01 * valid.sum() * 256
    assert ham[valid].max() <= 8
    np.testing.assert_allclose(desc_t.angle.numpy()[valid], np.asarray(desc_j.angle)[valid],
                               atol=1e-3)
    agree = ham == 0
    np.testing.assert_array_equal(desc_t.packed.numpy().view(np.uint32)[agree],
                                  np.asarray(desc_j.packed)[agree])
    assert set(np.unique(desc_t.signs.numpy())) == {-1, 1}
    back = interop.descriptors_from_numpy(desc_j, "cpu")
    np.testing.assert_array_equal(back.packed.numpy().view(np.uint32), np.asarray(desc_j.packed))


def test_extract_patches_edge_rule_matches_jax(rng):
    """Taps outside the image weigh zero (not clamped), also for keypoints
    hanging over the border."""
    img = rng.random((40, 50)).astype(np.float32)
    uv = np.array([[20.3, 18.7], [2.2, 3.9], [48.6, 38.1], [-4.0, 20.0], [25.0, 44.5]],
                  np.float32)
    got = torb.extract_patches(torch.tensor(img), torch.tensor(uv)).numpy()
    want = np.asarray(jorb.extract_patches(jnp.asarray(img), jnp.asarray(uv)))
    np.testing.assert_allclose(got, want, atol=1e-6)  # the product may fuse a*b+c
    assert (got[1, 0, :] == 0).all() and (got[0] > 0).all()
    np.testing.assert_allclose(
        torb.orientation(torch.tensor(want)).numpy(),
        np.asarray(jorb.orientation(jnp.asarray(want))), atol=1e-5)


def test_brief_pattern_is_the_same():
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())


def test_keypoint_depth_matches_jax(frame, jax_features):
    kp_j = jax_features[0]
    depth_m = np.asarray(jcam.depth_to_metres(jnp.asarray(frame[0]), CAM))
    pts_j, ok_j = jorb.keypoint_depth(kp_j, jnp.asarray(depth_m), CAM)
    pts_t, ok_t = torb.keypoint_depth(interop.keypoints_from_numpy(kp_j, "cpu"),
                                      torch.tensor(depth_m), CAM)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))
    assert 0 < int(ok_t.sum()) < len(ok_t)


def test_feature_stage_matches_features_jit(frame):
    """The session's whole feature stage from raw depth and rgb."""
    depth, rgb, _ = frame
    kp_j, desc_j, pts_j, ok_j = jsess._features_jit(
        jnp.asarray(depth), jnp.asarray(rgb), ORB, CAM)
    kp_t, desc_t, pts_t, ok_t = tsess._features(
        torch.tensor(depth.astype(np.int32)), torch.tensor(rgb), ORB, CAM)
    same = (kp_t.uv.numpy() == np.asarray(kp_j.uv)).all(axis=1)
    both = same & np.asarray(ok_j) & ok_t.numpy()
    assert both.sum() >= 0.9 * np.asarray(ok_j).sum()
    np.testing.assert_allclose(pts_t.numpy()[both], np.asarray(pts_j)[both], atol=1e-6)
    ham = (desc_t.signs.numpy() != np.asarray(desc_j.signs)).sum(axis=1)
    assert ham[both].max() <= 8 and ham[both].mean() <= 1.0
