"""The GN step of the port's kernel, on the CPU: the pose update's arithmetic
written out (`solve_update_written_out`, what the CUDA kernel's `T_next` is
held against on the card) against the port's and the JAX package's
`_apply_update`, and the plain versions of `gn_step` / `gn_step_batched`
(what the wrappers take for a CPU tensor).

Tolerances: the written-out update does the same float32 arithmetic as
`_apply_update` with its sums in a stated order, while LAPACK's Cholesky and
the 3x3 / 4x4 matrix products round in theirs: 1e-6 against the port (entries
of a pose are of order 1), 1e-5 against the JAX package (XLA's solve and
products). The plain step functions are compositions and are held exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.core.config import CameraIntrinsics, ICPConfig
from slam_rgbd_tpu.odometry import icp as jicp
from slam_rgbd_tpu_torch.core import se3 as tse3
from slam_rgbd_tpu_torch.odometry import icp as ticp
from slam_rgbd_tpu_torch.ops import gn_reduce as tg

# one intra-op thread: torch's spinning thread pool would otherwise take
# every core from the test workers running beside this one
torch.set_num_threads(1)

CFG = ICPConfig()


def _system(seed: int, scale: float = 1.0):
    """A well-conditioned 6x6 normal-equation system and a pose, as numpy:
    H = J^T J of 400 random rows, g of the size a GN step of a few
    millimetres and milliradians gives."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(400, 6)).astype(np.float32)
    J[:, 3:] *= 1.5  # rotational columns weigh more, as with points ~1.5 m out
    H = (J.T @ J).astype(np.float32) * np.float32(scale)
    step = rng.normal(size=6).astype(np.float32) * np.float32(0.01)
    g = -(H @ step).astype(np.float32)
    xi = rng.normal(size=6).astype(np.float32) * np.float32(0.2)
    T = tse3.exp(torch.from_numpy(xi)).numpy()
    return T, H, g


def _all_three(T, H, g, inliers):
    """(written out, port `_apply_update`, JAX `_apply_update`) as numpy."""
    args = (torch.from_numpy(T), torch.from_numpy(H), torch.from_numpy(g),
            torch.tensor(inliers, dtype=torch.int32))
    written = tg.solve_update_written_out(*args, CFG.damping).numpy()
    port = ticp._apply_update(*args, CFG).numpy()
    ref = np.asarray(jicp._apply_update(jnp.asarray(T), jnp.asarray(H), jnp.asarray(g),
                                        jnp.int32(inliers), CFG))
    return written, port, ref


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 50.0), (2, 1e-3)])
def test_written_out_update_matches_both_apply_updates(seed, scale):
    T, H, g = _system(seed, scale)
    written, port, ref = _all_three(T, H, g, 5000)
    assert written.dtype == np.float32 and written.shape == (4, 4)
    np.testing.assert_allclose(written, port, atol=1e-6)
    np.testing.assert_allclose(written, ref, atol=1e-5)
    assert np.abs(written - T).max() > 1e-3  # the step really moved the pose
    np.testing.assert_array_equal(written[3], [0.0, 0.0, 0.0, 1.0])
    R = written[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)


def test_written_out_update_takes_the_taylor_branch_for_a_tiny_rotation():
    """A step whose rotation is below the 1e-8 threshold of `_sinc_terms`."""
    T, H, _ = _system(3)
    step = np.array([3e-3, -2e-3, 1e-3, 2e-5, -3e-5, 1e-5], np.float32)
    g = -(H @ step).astype(np.float32)
    written, port, ref = _all_three(T, H, g, 5000)
    np.testing.assert_allclose(written, port, atol=1e-6)
    np.testing.assert_allclose(written, ref, atol=1e-5)
    assert np.abs(written[:3, 3] - T[:3, 3]).max() > 1e-3


def test_singular_system_is_damped_and_solved_alike():
    """A direction the pixels do not constrain (a zero row and column of H,
    a zero in g): the damping `damping * max(diag, 1)` keeps the pivot
    positive, the step leaves that direction alone, and the three agree."""
    T, H, g = _system(8)
    H[5, :] = 0.0
    H[:, 5] = 0.0
    g[5] = 0.0
    written, port, ref = _all_three(T, H, g, 5000)
    np.testing.assert_allclose(written, port, atol=1e-6)
    np.testing.assert_allclose(written, ref, atol=1e-5)
    assert np.abs(written - T).max() > 1e-3


@pytest.mark.parametrize("case", ["indefinite", "negative", "nan_in_g", "nan_in_H",
                                  "six_inliers"])
def test_degenerate_systems_give_the_identity_step_in_all_three(case):
    """A pivot that is not positive, a non-finite step or `inliers <= 6`:
    the pose only passes through `normalize_rotation`, in the written-out
    update, in the port's `_apply_update` and in the JAX package's."""
    T, H, g = _system(4)
    inliers = 5000
    if case == "indefinite":
        H = H.copy()
        H[5, 5] = -H[5, 5]
    elif case == "negative":
        H = -H
    elif case == "nan_in_g":
        g = g.copy()
        g[2] = np.nan
    elif case == "nan_in_H":
        H = H.copy()
        H[1, 1] = np.nan
    else:
        inliers = 6
    written, port, ref = _all_three(T, H, g, inliers)
    want = tse3.normalize_rotation(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(written, want, atol=1e-6)
    np.testing.assert_allclose(port, want, atol=1e-6)
    np.testing.assert_allclose(ref, want, atol=1e-6)
    assert np.isfinite(written).all()


def test_written_out_update_is_per_problem_under_a_leading_batch():
    """Leading dimensions: each problem as alone (exactly: the arithmetic is
    elementwise), the degenerate one keeps its pose while its neighbours
    move."""
    systems = [_system(s) for s in (5, 6, 7)]
    T, H, g = (np.stack(x) for x in zip(*systems))
    H[1] = -H[1]
    inl = torch.tensor([5000, 5000, 7], dtype=torch.int32)
    out = tg.solve_update_written_out(torch.from_numpy(T), torch.from_numpy(H),
                                      torch.from_numpy(g), inl, CFG.damping)
    assert out.shape == (3, 4, 4)
    for b in range(3):
        one = tg.solve_update_written_out(
            torch.from_numpy(T[b]), torch.from_numpy(H[b]), torch.from_numpy(g[b]),
            inl[b], CFG.damping)
        assert torch.equal(out[b], one)
    port = ticp._apply_update(torch.from_numpy(T), torch.from_numpy(H),
                              torch.from_numpy(g), inl, CFG)
    np.testing.assert_allclose(out.numpy(), port.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        out[1].numpy(), tse3.normalize_rotation(torch.from_numpy(T[1])).numpy(), atol=1e-6)
    assert float((out[0] - torch.from_numpy(T[0])).abs().max()) > 1e-3
    assert float((out[2] - torch.from_numpy(T[2])).abs().max()) > 1e-3


# ---- the plain step functions, on a small scene ----------------------------


def _scene(h: int, w: int, n_b: int, seed: int = 0):
    """n_b problems at h x w: a smooth textured surface with a hole seen
    from slightly different poses -> (T, mu, src (B, 8, h, w), tgt
    (B, 10, h, w), cam), made with numpy."""
    cam = CameraIntrinsics(fx=0.9 * w, fy=0.9 * w, cx=(w - 1) / 2, cy=(h - 1) / 2,
                           width=w, height=h)
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    Ts, mus, srcs, tgts = [], [], [], []
    for b in range(n_b):
        z = (1.4 + 0.3 * np.sin(u / 9.0 + b) + 0.2 * np.cos(v / 7.0)).astype(np.float32)
        x = (u - cam.cx) / cam.fx * z
        y = (v - cam.cy) / cam.fy * z
        n = np.stack([-np.gradient(z, axis=1), -np.gradient(z, axis=0),
                      np.full_like(z, 0.02)], 0)
        n = (n / np.linalg.norm(n, axis=0)).astype(np.float32)
        valid = np.ones((h, w), np.float32)
        valid[h // 4: h // 4 + 5, w // 3: w // 3 + 9] = 0.0
        inten = (0.5 + 0.4 * np.sin(u / 4.0 + b) * np.cos(v / 5.0)).astype(np.float32)
        gx = np.gradient(inten, axis=1).astype(np.float32)
        gy = np.gradient(inten, axis=0).astype(np.float32)
        planes = np.stack([x, y, z, n[0], n[1], n[2], valid, inten, gx, gy]).astype(np.float32)
        xi = (rng.normal(size=6) * [4e-3, 4e-3, 4e-3, 3e-3, 3e-3, 3e-3]).astype(np.float32)
        Ts.append(tse3.exp(torch.from_numpy(xi)))
        mus.append(torch.tensor([float(b % 2), 0.0]))
        srcs.append(torch.from_numpy(planes[:8]))
        tgts.append(torch.from_numpy(planes))
    return torch.stack(Ts), torch.stack(mus), torch.stack(srcs), torch.stack(tgts), cam


@pytest.mark.parametrize("h,w", [(48, 64), (120, 160)])
def test_gn_step_reference_is_reduction_then_apply_update(h, w):
    T, mu, src, tgt, cam = _scene(h, w, 1)
    args = (T[0], mu[0], src[0], tgt[0], cam, CFG, 2)
    before = tg.gn_reduce.launches
    T_next, H, g, inl, sq = tg.gn_step(*args)  # a CPU tensor: the plain version
    assert tg.gn_reduce.launches == before
    H0, g0, inl0, sq0 = tg.gn_reduce_reference(*args)
    assert int(inl) > 0.8 * h * w
    for a, b in ((H, H0), (g, g0), (inl, inl0), (sq, sq0)):
        assert torch.equal(a, b)
    assert torch.equal(T_next, ticp._apply_update(T[0], H0, g0, inl0, CFG))
    assert float((T_next - T[0]).abs().max()) > 1e-4
    # and the kernel's own arithmetic, written out, lands on the same pose
    written = tg.solve_update_written_out(T[0], H0, g0, inl0, CFG.damping)
    np.testing.assert_allclose(written.numpy(), T_next.numpy(), atol=1e-6)


def test_gn_step_batched_reference_equals_single_per_problem():
    T, mu, src, tgt, cam = _scene(48, 64, 3)
    before = tg.gn_reduce_batched.launches
    out = tg.gn_step_batched(T, mu, src, tgt, cam, CFG, 2)
    assert tg.gn_reduce_batched.launches == before
    assert [tuple(x.shape) for x in out] == [(3, 4, 4), (3, 6, 6), (3, 6), (3,), (3,)]
    assert out[3].dtype == torch.int32 and len(set(out[3].tolist())) == 3
    for b in range(3):
        single = tg.gn_step_reference(T[b], mu[b], src[b], tgt[b], cam, CFG, 2)
        for a, c in zip(out, single):
            assert torch.equal(a[b], c)


def test_expanded_and_grouped_planes_equal_contiguous_copies():
    """Three poses over one set of planes: a batch made by `expand`
    (stride 0), a leading G = 1, and three contiguous copies give the same
    bits; two sets under six problems are read as b // 3."""
    T, mu, src, tgt, cam = _scene(48, 64, 3)
    copies = tg.gn_step_batched(T, mu, src[:1].repeat(3, 1, 1, 1),
                                tgt[:1].repeat(3, 1, 1, 1), cam, CFG, 2)
    expanded = tg.gn_step_batched(T, mu, src[0].expand(3, -1, -1, -1),
                                  tgt[0].expand(3, -1, -1, -1), cam, CFG, 2)
    one_set = tg.gn_step_batched(T, mu, src[:1], tgt[:1], cam, CFG, 2)
    for a, b, c in zip(copies, expanded, one_set):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert len(set(copies[3].tolist())) > 1  # the poses differ
    T6, mu6 = torch.cat([T, T.flip(0)]), torch.cat([mu, mu.flip(0)])
    grouped = tg.gn_reduce_batched(T6, mu6, src[:2], tgt[:2], cam, CFG, 2)
    spelled = tg.gn_reduce_batched(T6, mu6, src[:2].repeat_interleave(3, 0),
                                   tgt[:2].repeat_interleave(3, 0), cam, CFG, 2)
    for a, b in zip(grouped, spelled):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):  # two sets do not divide three problems
        tg.gn_step_batched(T, mu, src[:2], tgt[:2], cam, CFG, 2)
    with pytest.raises(ValueError):  # not contiguous within a problem
        tg.gn_step_batched(T, mu, src[:, :, :, ::2], tgt[:, :, :, ::2], cam, CFG, 2)


@pytest.mark.parametrize("h,w,blocks", [(120, 160, 19), (240, 320, 75), (480, 640, 300),
                                        (96, 126, 12), (7, 5, 1)])
def test_launch_parameters_depend_on_the_level_only(h, w, blocks):
    """The kernel's thread blocks a problem cover the level's pixels at 1024
    a block, whatever the batch; the parameters hold the constants rounded to
    float32 and are made once for a (cam, cfg) pair at a level."""
    cam = CameraIntrinsics(fx=0.9 * w, fy=0.9 * w, cx=(w - 1) / 2, cy=(h - 1) / 2,
                           width=w, height=h)
    params, n_blocks = tg._params(cam, CFG, 4, h, w)
    assert n_blocks == blocks and (n_blocks - 1) * 1024 < h * w <= n_blocks * 1024
    assert (params.height, params.width, params.radius) == (h, w, 4)
    assert params.fx == np.float32(cam.fx) and params.damping == np.float32(CFG.damping)
    assert params.max_dist_sq == np.float32(CFG.max_dist * CFG.max_dist)
    assert tg._params(cam, CFG, 4, h, w)[0] is params
