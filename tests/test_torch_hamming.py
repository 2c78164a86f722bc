"""The port's Hamming matching (plain versions, as every CPU tensor takes
them) vs the JAX package: the Pallas kernels in interpret mode and the XLA
branches.

Distances are small integers and ties go to the first index in all of them,
so every comparison is exact. The gated scene keeps a margin around both
gates: XLA's dot may round the 3-D cross term otherwise than three explicit
products, so a pair within ~1e-6 of a threshold could flip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.core.config import CameraIntrinsics, KeyframeConfig
from slam_rgbd_tpu.features import match as jmatch
from slam_rgbd_tpu.mapping import map as jmap
from slam_rgbd_tpu.ops import hamming_pallas as hp
from slam_rgbd_tpu_torch import interop
from slam_rgbd_tpu_torch.features import match as tmatch
from slam_rgbd_tpu_torch.mapping import map as tmap
from slam_rgbd_tpu_torch.ops import hamming as th

torch.set_num_threads(1)


def _sets(rng, k1=256, k2=384):
    """Sign sets with real matches, a duplicated block of columns (ties),
    masked columns, masked zero rows and an all-invalid query."""
    s2 = rng.choice(np.array([-1, 1], np.int8), size=(k2, 256))
    s1 = rng.choice(np.array([-1, 1], np.int8), size=(k1, 256))
    for q in range(0, k1, 2):
        s1[q] = s2[rng.integers(0, k2 // 2)]
        s1[q, rng.choice(256, size=rng.integers(0, 25), replace=False)] *= -1
    s2[k2 // 2: k2 // 2 + 32] = s2[:32]
    v1 = rng.random(k1) > 0.15
    v2 = rng.random(k2) > 0.2
    v2[:32] = v2[k2 // 2: k2 // 2 + 32] = True
    s2[-16:] = 0  # empty map slots: zero rows, always masked
    v2[-16:] = False
    v1[7] = False
    return s1, v1, s2, v2


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# Inputs that straddle the Pallas kernels' 2048-column tiles (`_K2_TILE`):
# 256 queries against 4096 columns, two tiles.
_EDGE_K1, _EDGE_K2 = 256, 4096
_HALF = _EDGE_K2 // 2


def _edge_signs(rng):
    """'tiles': each query an exact copy of a column of the first tile, which
    is duplicated in the second (a tie at distance 0 across tiles: the
    first index must win, and second == best); the first 64 queries and
    every 7th are invalid. 'lone': the same queries against a set whose one
    valid column is the last."""
    s2 = rng.choice(np.array([-1, 1], np.int8), size=(_EDGE_K2, 256))
    s2[_HALF:] = s2[:_HALF]
    src = rng.integers(0, _HALF, size=_EDGE_K1)
    s1 = s2[src].copy()
    v1 = np.ones(_EDGE_K1, bool)
    v1[:64] = False
    v1[::7] = False
    v2 = np.ones(_EDGE_K2, bool)
    lone = np.zeros(_EDGE_K2, bool)
    lone[-1] = True
    return {"tiles": (s1, v1, s2, v2), "lone": (s1, v1, s2, lone), "src": src}


@pytest.fixture(scope="module")
def top2_edges():
    """The edge input sets and the Pallas kernel's answers on each (interpret
    mode), computed once for the module."""
    sets = _edge_signs(np.random.default_rng(6))
    for name in ("tiles", "lone"):
        arrays = sets[name]
        sets[name] = (arrays, [np.asarray(x) for x in
                               hp.hamming_top2(*_j(*arrays), interpret=True)])
    return sets


@pytest.mark.parametrize("case", [
    pytest.param("unmasked", id="False"), pytest.param("masked", id="True"),
    "ties_across_tiles", "masked_rows", "lone_last_column"])
def test_top2_reference_matches_pallas_and_xla(rng, top2_edges, case):
    if case in ("unmasked", "masked"):
        s1, v1, s2, v2 = _sets(rng)
        if case == "unmasked":
            s2[-16:] = 1
            v1[:], v2[:] = True, True
        pb, ps, pi = (np.asarray(x) for x in
                      hp.hamming_top2(*_j(s1, v1, s2, v2), interpret=True))
    else:
        (s1, v1, s2, v2), (pb, ps, pi) = top2_edges[
            "lone" if case == "lone_last_column" else "tiles"]
    best, second, idx = (x.numpy() for x in th.hamming_top2(*_t(s1, v1, s2, v2)))
    np.testing.assert_array_equal(best, pb)
    np.testing.assert_array_equal(second, ps)
    np.testing.assert_array_equal(idx, pi)
    assert idx.dtype == np.int32 and best.dtype == np.float32
    # the XLA branch: the matrix, masked, then argmin and the rest's min
    d = np.array(jmatch.hamming_matrix(*_j(s1, s2)))
    d[~(v1[:, None] & v2[None, :])] = 1e9
    np.testing.assert_array_equal(idx, d.argmin(1))
    np.testing.assert_array_equal(best, d.min(1))
    d[np.arange(len(d)), d.argmin(1)] = 1e9
    np.testing.assert_array_equal(second, d.min(1))
    # an all-invalid row reads (1e9, 0, 1e9)
    if case != "unmasked":
        assert (best[~v1] == 1e9).all() and (idx[~v1] == 0).all()
        assert (second[~v1] == 1e9).all()
    if case in ("unmasked", "masked"):
        assert (best == second).sum() >= 16  # the tie block really tied
    elif case == "ties_across_tiles":
        src = top2_edges["src"]
        assert (best[v1] == 0).all() and (second[v1] == 0).all()
        np.testing.assert_array_equal(idx[v1], src[v1])  # the first tile's copy
    elif case == "masked_rows":
        assert (~v1).sum() > 64 and (best[v1] < 1e9).all()
    else:  # one valid column, the last: no second anywhere
        assert (idx[v1] == _EDGE_K2 - 1).all() and (second == 1e9).all()
        assert (best[v1] < 1e9).all()


def test_top2_free_sizes_and_packed_oracle(rng):
    """K1, K2 need not be multiples of 128 in the port; the popcount oracle
    on packed words gives the same distances as the sign product."""
    s1, v1, s2, v2 = _sets(rng, 100, 333)
    s2[-16:] = 1
    best, second, idx = th.hamming_top2(*_t(s1, v1, s2, v2))
    d = th.hamming_matrix(*_t(s1, s2)).numpy()
    from slam_rgbd_tpu_torch.features.orb import pack_bits

    p1, p2 = (pack_bits(torch.tensor(s) > 0) for s in (s1, s2))
    np.testing.assert_array_equal(tmatch.hamming_packed(p1, p2).numpy(), d)
    np.testing.assert_array_equal(
        np.asarray(jmatch.hamming_packed(jnp.asarray(p1.numpy().view(np.uint32)),
                                         jnp.asarray(p2.numpy().view(np.uint32)))), d)
    np.testing.assert_array_equal(tmatch.pack_to_signs(p1).numpy(), s1)
    d[~(v1[:, None] & v2[None, :])] = 1e9
    np.testing.assert_array_equal(best.numpy(), d.min(1))
    np.testing.assert_array_equal(idx.numpy(), d.argmin(1))


@pytest.mark.parametrize("cross_check", [False, True])
def test_match_kernel_matches_match_pallas_and_xla(rng, cross_check):
    s1, v1, s2, v2 = _sets(rng)
    got = tmatch.match(*_t(s1, v1, s2, v2), ratio=0.95, cross_check=cross_check)
    i1, i2, dist, ok = (np.asarray(x) for x in hp.match_pallas(
        *_j(s1, v1, s2, v2), ratio=0.95, cross_check=cross_check, interpret=True))
    np.testing.assert_array_equal(got.idx1.numpy(), i1)
    np.testing.assert_array_equal(got.idx2.numpy(), i2)
    np.testing.assert_array_equal(got.distance.numpy(), dist)
    np.testing.assert_array_equal(got.valid.numpy(), ok & v1)
    ref = jmatch.match(*_j(s1, v1, s2, v2), ratio=0.95, cross_check=cross_check,
                       backend="xla")
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    sel = got.valid.numpy()
    np.testing.assert_array_equal(got.idx2.numpy()[sel], np.asarray(ref.idx2)[sel])
    assert sel.sum() > 20


def _map_scene(rng, K=128, P=256):
    """The scene of the JAX package's gated-match test: K points seen from
    the identity pose, inserted as the first keyframe of an empty map."""
    cam = CameraIntrinsics(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
    kcfg = KeyframeConfig(max_keyframes=8, max_map_points=P)
    pts = np.stack([rng.uniform(-1.5, 1.5, K), rng.uniform(-1.0, 1.0, K),
                    rng.uniform(2.0, 4.0, K)], axis=1).astype(np.float32)
    z = pts[:, 2]
    u = cam.fx * pts[:, 0] / z + cam.cx
    v = cam.fy * pts[:, 1] / z + cam.cy
    ok = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    uv = np.stack([u, v], 1).astype(np.float32)
    signs = rng.choice(np.array([-1, 1], np.int8), size=(K, 256))
    m = jmap.insert_keyframe(
        jmap.empty_map(kcfg, K), jnp.eye(4), 0.0, *_j(uv, pts, ok, signs),
        jnp.full((K,), -1, jnp.int32))
    return cam, m, uv, pts, ok, signs


def _perturbed(rng, uv, pts, signs):
    """A reobservation with a margin around the gates: pixel offsets of
    radius <= 4 or >= 8 px (gate 6), depth off by <= 4% or >= 12% (gate
    8%), 3-D offsets <= 5 cm or >= 12 cm (merge gate 8 cm)."""
    K = len(uv)
    ang = rng.uniform(0, 2 * np.pi, K)
    rad = np.where(rng.random(K) < 0.7, rng.uniform(0, 4, K), rng.uniform(8, 20, K))
    uv_q = (uv + np.stack([rad * np.cos(ang), rad * np.sin(ang)], 1)).astype(np.float32)
    rel = np.where(rng.random(K) < 0.8, rng.uniform(-0.04, 0.04, K),
                   rng.uniform(0.12, 0.2, K))
    z_q = (pts[:, 2] * (1 + rel)).astype(np.float32)
    step = rng.normal(size=(K, 3))
    step /= np.linalg.norm(step, axis=1, keepdims=True)
    far = rng.random(K) < 0.3
    pts_q = (pts + step * np.where(far, rng.uniform(0.12, 0.3, K),
                                   rng.uniform(0, 0.05, K))[:, None]).astype(np.float32)
    signs_q = signs.copy()
    for q in range(K):  # a few bit flips; every fifth gets a fresh descriptor
        signs_q[q, rng.choice(256, size=rng.integers(0, 30), replace=False)] *= -1
    signs_q[::5] = rng.choice(np.array([-1, 1], np.int8), size=signs_q[::5].shape)
    return uv_q, z_q, pts_q, signs_q


def _meta(uv, z, ok, xyz):
    return np.concatenate([uv, z[:, None], ok[:, None].astype(np.float32), xyz,
                           (xyz * xyz).sum(1, keepdims=True)], 1).astype(np.float32)


def _edge_scene(rng):
    """Gated inputs over two 2048-column tiles. 'tiles': 4096 map points in
    view whose second half repeats the first (signs, position, pixel), and
    256 queries, each an exact descriptor copy of a point of the first half,
    reobserved within 2 px, 2% of depth and 1 cm (gates 6 px, 8%, 8 cm): a
    tie at distance 0 across tiles in both tiers; the first 64 queries and
    every 7th invalid. 'lone': the same with only the last point valid,
    which the first 32 valid queries reobserve."""
    cam = CameraIntrinsics(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
    sets = _edge_signs(rng)
    s1, v1, s2, _ = sets["tiles"]
    src = sets["src"].copy()
    xyz = np.stack([rng.uniform(-1.5, 1.5, _HALF), rng.uniform(-1.0, 1.0, _HALF),
                    rng.uniform(2.0, 4.0, _HALF)], 1).astype(np.float32)
    xyz = np.concatenate([xyz, xyz])
    uv = np.stack([cam.fx * xyz[:, 0] / xyz[:, 2] + cam.cx,
                   cam.fy * xyz[:, 1] / xyz[:, 2] + cam.cy], 1).astype(np.float32)
    p_meta = _meta(uv, xyz[:, 2], np.ones(_EDGE_K2, bool), xyz)
    lone = p_meta.copy()
    lone[:, 3] = 0.0
    lone[-1, 3] = 1.0
    src_lone = src.copy()
    src_lone[np.flatnonzero(v1)[:32]] = _EDGE_K2 - 1
    out = {}
    for name, pm, at in (("tiles", p_meta, src), ("lone", lone, src_lone)):
        off = rng.uniform(-1.0, 1.0, size=(_EDGE_K1, 2)).astype(np.float32)
        q_uv = uv[at] + off
        q_z = xyz[at, 2] * (1 + rng.uniform(-0.02, 0.02, _EDGE_K1)).astype(np.float32)
        q_xyz = xyz[at] + rng.uniform(-0.005, 0.005, size=(_EDGE_K1, 3)).astype(np.float32)
        sq = s1.copy()
        sq[at == _EDGE_K2 - 1] = s2[-1]
        out[name] = (sq, _meta(q_uv, q_z, v1, q_xyz), s2, pm)
    return out, v1


@pytest.fixture(scope="module")
def gated_edges():
    """The gated edge input sets and the Pallas kernel's answers on each
    (interpret mode, merge radius 0.08), computed once for the module."""
    sets, v1 = _edge_scene(np.random.default_rng(7))
    kw = dict(px_radius=6.0, z_rel_tol=0.08, merge_radius=0.08)
    return {name: (args, [np.asarray(x) for x in
                          hp.gated_match(*_j(*args), interpret=True, **kw)])
            for name, args in sets.items()}, v1


@pytest.mark.parametrize("merge_radius,case", [
    pytest.param(0.08, "scene", id="0.08"), pytest.param(-1.0, "scene", id="-1.0"),
    pytest.param(0.08, "ties_across_tiles", id="ties_across_tiles"),
    pytest.param(0.08, "masked_rows", id="masked_rows"),
    pytest.param(0.08, "lone_last_column", id="lone_last_column")])
def test_gated_reference_matches_pallas(rng, gated_edges, merge_radius, case):
    """`gated_match_reference` vs the Pallas kernel in interpret mode on the
    same signs and gate data: d1, i1, d2, i2 exact, merge tier on and off;
    and on inputs over two Pallas column tiles: ties across them, invalid
    queries, one valid column (the last)."""
    kw = dict(px_radius=6.0, z_rel_tol=0.08, merge_radius=merge_radius)
    if case != "scene":
        sets, v1 = gated_edges
        args, want = sets["lone" if case == "lone_last_column" else "tiles"]
        got = [g.numpy() for g in th.gated_match(*_t(*args), **kw)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        d1, i1, d2, i2 = got
        assert (d1[~v1] == 1e9).all() and (i1[~v1] == 0).all()
        assert (d2[~v1] == 1e9).all() and (i2[~v1] == 0).all()
        if case == "lone_last_column":
            hit = np.flatnonzero(v1)[:32]
            assert (d1[hit] == 0).all() and (i1[hit] == _EDGE_K2 - 1).all()
            assert (i2[hit] == _EDGE_K2 - 1).all()
            # any other row has the last column or nothing
            for d, i in ((d1, i1), (d2, i2)):
                assert (((d == 1e9) & (i == 0)) | (i == _EDGE_K2 - 1)).all()
            assert ((d1 == 1e9) & v1).sum() > 64
        else:  # both tiers tie at 0 across tiles: the first tile's point
            assert (d1[v1] == 0).all() and (d2[v1] == 0).all()
            assert (i1[v1] < _HALF).all() and (i2[v1] == i1[v1]).all()
            if case == "masked_rows":
                assert (~v1).sum() > 64
        return
    cam, m, uv, pts, ok, signs = _map_scene(rng)
    uv_q, z_q, pts_q, signs_q = _perturbed(rng, uv, pts, signs)
    q_meta = np.concatenate([uv_q, z_q[:, None], ok[:, None].astype(np.float32),
                             pts_q, (pts_q * pts_q).sum(1, keepdims=True)], 1)
    xyz = np.asarray(m.pt_xyz)
    zp = xyz[:, 2]
    p_meta = np.concatenate([
        (cam.fx * xyz[:, 0] / np.maximum(zp, 1e-6) + cam.cx)[:, None],
        (cam.fy * xyz[:, 1] / np.maximum(zp, 1e-6) + cam.cy)[:, None], zp[:, None],
        np.asarray(m.pt_valid)[:, None].astype(np.float32), xyz,
        (xyz * xyz).sum(1, keepdims=True)], 1).astype(np.float32)
    pt_signs = np.asarray(m.pt_signs)
    assert (pt_signs[~np.asarray(m.pt_valid)] == 0).all()  # zero rows, masked
    got = th.gated_match(*_t(signs_q, q_meta.astype(np.float32), pt_signs, p_meta), **kw)
    want = hp.gated_match(*_j(signs_q, q_meta.astype(np.float32), pt_signs, p_meta),
                          interpret=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    d1, _, d2, i2 = (g.numpy() for g in got)
    assert (d1 < 64).sum() > 0.3 * ok.sum()
    if merge_radius < 0:
        assert (d2 == 1e9).all() and (i2 == 0).all()
    else:
        assert (d2 < 40).sum() > 0.3 * ok.sum()


@pytest.mark.parametrize("merge", [True, False])
def test_match_against_map_matches_jax_both_backends(rng, merge):
    """The port's `match_against_map` on the JAX map carried over through
    `interop.map_from_numpy` vs the JAX function on its XLA and Pallas
    paths: the (K,) point ids are equal."""
    cam, m, uv, pts, ok, signs = _map_scene(rng)
    uv_q, z_q, pts_q, signs_q = _perturbed(rng, uv, pts, signs)
    T = np.eye(4, dtype=np.float32)
    kw = dict(cam=cam, px_radius=6.0, max_distance=80.0)
    if merge:
        kw.update(merge_radius=0.08)
    want = {
        backend: np.asarray(jmap.match_against_map(
            m, *_j(signs_q, ok, uv_q, z_q, T), backend=backend,
            kp_pts=jnp.asarray(pts_q) if merge else None, **kw))
        for backend in ("xla", "pallas")
    }
    np.testing.assert_array_equal(want["xla"], want["pallas"])
    got = tmap.match_against_map(
        interop.map_from_numpy(m, "cpu"), *_t(signs_q, ok, uv_q, z_q, T),
        kp_pts=torch.tensor(pts_q) if merge else None, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want["xla"])
    assert (got.numpy() >= 0).sum() > 0.3 * ok.sum()


def test_wrappers_reject_bad_input():
    s = torch.ones((8, 256), dtype=torch.int8)
    v = torch.ones(8, dtype=torch.bool)
    meta = torch.zeros((8, 8))
    with pytest.raises(ValueError):
        th.hamming_top2(s, v, s.float(), v)
    with pytest.raises(ValueError):
        th.hamming_top2(s, v[:4], s, v)
    with pytest.raises(ValueError):
        th.hamming_top2(s, v.float(), s, v)
    with pytest.raises(ValueError):
        th.gated_match(s, meta[:, :7].contiguous(), s, meta)
    with pytest.raises(ValueError):
        th.gated_match(s, meta.double(), s, meta)
    with pytest.raises(ValueError):
        th.hamming_top2(s[:0], v[:0], s, v)
    assert th.hamming_top2.launches == 0 and th.gated_match.launches == 0
