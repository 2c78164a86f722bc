"""The port's robust 3D-3D solve vs the JAX package.

The weighted Kabsch fit is compared directly (1e-5: a 3x3 SVD in two
libraries). The two packages draw other minimal triples (jax.random vs a
torch.Generator), so the full solve is compared on its result, on scenes
with a clear consensus; the IRLS polish is compared from the same seed
weights and pose.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.core import se3 as jse3
from slam_rgbd_tpu.features import pose3d as jp3
from slam_rgbd_tpu_torch.features import pose3d as tp3
from test_torch_priority import below_the_jax_files  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _scene(rng, n=200, outliers=0.3, noise=0.003, invalid=0.1):
    T = np.asarray(jse3.exp(jnp.asarray(
        np.array([0.3, -0.2, 0.15, 0.1, -0.25, 0.2], np.float32))))
    p1 = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    p2 = p1 @ T[:3, :3].T + T[:3, 3] + rng.normal(0, noise, (n, 3)).astype(np.float32)
    bad = rng.random(n) < outliers
    p2[bad] = rng.uniform(-2, 2, size=(int(bad.sum()), 3))
    valid = rng.random(n) > invalid
    return T, p1, p2.astype(np.float32), valid, bad


@pytest.mark.parametrize("weights", ["ones", "random", "sparse"])
def test_weighted_kabsch_matches_jax(rng, weights):
    T, p1, p2, _, _ = _scene(rng, n=50, outliers=0.0)
    w = {"ones": np.ones(50), "random": rng.random(50),
         "sparse": (rng.random(50) < 0.1) * 1.0}[weights].astype(np.float32)
    got = tp3._weighted_kabsch(torch.tensor(p1), torch.tensor(p2), torch.tensor(w))
    want = jp3._weighted_kabsch(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), T, atol=5e-3)


def test_weighted_kabsch_batched_and_reflection(rng):
    """The batched fit equals the single one triple by triple; a mirrored
    target still yields a proper rotation (det +1)."""
    _, p1, p2, _, _ = _scene(rng, n=30, outliers=0.0)
    tri = rng.integers(0, 30, size=(16, 3))
    a, b = torch.tensor(p1[tri]), torch.tensor(p2[tri])
    batched = tp3._weighted_kabsch(a, b, torch.ones(16, 3))
    for h in range(16):
        single = tp3._weighted_kabsch(a[h], b[h], torch.ones(3))
        if torch.isfinite(single).all():
            np.testing.assert_allclose(batched[h].numpy(), single.numpy(), atol=1e-5)
    mirrored = p2 * np.array([1, 1, -1], np.float32)
    got = tp3._weighted_kabsch(torch.tensor(p1), torch.tensor(mirrored), torch.ones(30))
    want = jp3._weighted_kabsch(jnp.asarray(p1), jnp.asarray(mirrored), jnp.ones(30))
    assert abs(float(torch.linalg.det(got[:3, :3])) - 1.0) < 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_pose3d_consensus_matches_jax(seed):
    """30% outliers, 10% invalid: both accept, count the same inliers (+-2:
    a residual on the 10 cm threshold) and agree on T to 1e-4."""
    rng = np.random.default_rng(seed)
    T, p1, p2, valid, bad = _scene(rng)
    got = tp3.solve_pose3d(torch.tensor(p1), torch.tensor(p2), torch.tensor(valid), iters=8)
    want = jp3.solve_pose3d(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), iters=8)
    assert bool(got.ok) and bool(want.ok)
    assert abs(int(got.inliers) - int(want.inliers)) <= 2
    assert int(got.n_valid) == int(want.n_valid) == int(valid.sum())
    assert int(got.inliers) >= 0.9 * (valid & ~bad).sum()
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-4)
    # against the truth: Huber still gives the outliers a little weight
    np.testing.assert_allclose(got.T.numpy(), T, atol=1e-2)
    np.testing.assert_allclose(float(got.rmse), float(want.rmse), atol=1e-4)
    assert got.inliers.dtype == torch.int32


def test_solve_pose3d_rejects_without_consensus(rng):
    p1 = rng.uniform(-2, 2, size=(100, 3)).astype(np.float32)
    p2 = rng.uniform(-2, 2, size=(100, 3)).astype(np.float32)
    valid = np.ones(100, bool)
    got = tp3.solve_pose3d(torch.tensor(p1), torch.tensor(p2), torch.tensor(valid))
    want = jp3.solve_pose3d(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))
    assert not bool(got.ok) and not bool(want.ok)
    none = tp3.solve_pose3d(torch.tensor(p1), torch.tensor(p2), torch.zeros(100, dtype=torch.bool))
    assert not bool(none.ok) and int(none.n_valid) == 0


def test_sample_triples_distinct_valid_and_seeded(rng):
    valid = torch.tensor(rng.random(80) > 0.5)
    idx = tp3.sample_triples(valid, 64)
    assert idx.shape == (64, 3) and bool(valid[idx].all())
    assert all(len(set(row.tolist())) == 3 for row in idx)
    assert torch.equal(idx, tp3.sample_triples(valid, 64))
    assert not torch.equal(idx, tp3.sample_triples(
        valid, 64, torch.Generator().manual_seed(1)))
    g = torch.Generator().manual_seed(5)
    a, b = tp3.sample_triples(valid, 64, g), tp3.sample_triples(valid, 64, g)
    assert not torch.equal(a, b)  # a generator advances


def test_polish_matches_jax_irls_from_same_seed(rng):
    """The IRLS polish from the same w0 and T0: the JAX solve's own loop,
    replayed with its functions, against `polish`."""
    T, p1, p2, valid, bad = _scene(rng)
    w0 = (valid & ~bad & (rng.random(len(valid)) < 0.5)).astype(np.float32)
    got = tp3.polish(torch.tensor(p1), torch.tensor(p2), torch.tensor(valid),
                     torch.tensor(w0), torch.eye(4), iters=6)
    w, valid_f = jnp.asarray(w0), jnp.asarray(valid).astype(jnp.float32)
    for _ in range(6):
        Tj = jp3._weighted_kabsch(jnp.asarray(p1), jnp.asarray(p2), w)
        r = jp3._residuals(Tj, jnp.asarray(p1), jnp.asarray(p2))
        w = jnp.where(r <= 0.05, 1.0, 0.05 / jnp.maximum(r, 1e-12)) * valid_f
    r = np.asarray(jp3._residuals(Tj, jnp.asarray(p1), jnp.asarray(p2)))
    np.testing.assert_allclose(got.T.numpy(), np.asarray(Tj), atol=1e-5)
    assert abs(int(got.inliers) - int((valid & (r < 0.10)).sum())) <= 1
    assert bool(got.ok)
