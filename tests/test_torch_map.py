"""The port's keyframe map vs the JAX package: the same insert / cull
sequence from the same numpy inputs, every `MapState` field compared through
`interop.map_to_numpy` after every step (integers and masks exactly, floats
to 1e-6: one 3x3 product a keypoint).

The sequence avoids two keypoints matching one map point, where the
reference's scatter lets either descriptor win; one test covers that case
and compares the contested rows by membership.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.backend.pose_graph import EdgeList as JEdgeList
from slam_rgbd_tpu.core import se3 as jse3
from slam_rgbd_tpu.core.config import KeyframeConfig
from slam_rgbd_tpu.mapping import map as jmap
from slam_rgbd_tpu_torch import interop
from slam_rgbd_tpu_torch.backend.pose_graph import EdgeList
from slam_rgbd_tpu_torch.mapping import map as tmap
from test_torch_priority import below_the_jax_files  # noqa: F401 (autouse)

torch.set_num_threads(1)

K, P, M = 64, 110, 4
KCFG = KeyframeConfig(max_keyframes=M, max_map_points=P)
FIELDS = [f.name for f in dataclasses.fields(tmap.MapState)]


def _assert_maps_equal(mt, mj, skip_rows=None):
    got = interop.map_to_numpy(mt)
    assert sorted(got) == sorted(FIELDS)
    for name in FIELDS:
        want = np.asarray(getattr(mj, name))
        g = got[name]
        assert g.shape == want.shape and g.dtype == want.dtype, name
        if skip_rows is not None and name == "pt_signs":
            keep = np.ones(len(g), bool)
            keep[skip_rows] = False
            g, want = g[keep], want[keep]
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, want, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, want, err_msg=name)


def _keyframe(rng, i):
    T = np.asarray(jse3.exp(jnp.asarray(
        rng.normal(size=6).astype(np.float32) * 0.1)))
    return dict(
        T=T, ts=np.float32(i / 30.0),
        uv=rng.uniform(0, 160, size=(K, 2)).astype(np.float32),
        pts=rng.uniform(-1, 3, size=(K, 3)).astype(np.float32),
        ok=rng.random(K) > 0.2,
        signs=rng.choice(np.array([-1, 1], np.int8), size=(K, 256)),
    )


def _insert_both(mt, mj, kf, pid):
    mj = jmap.insert_keyframe(
        mj, jnp.asarray(kf["T"]), kf["ts"], jnp.asarray(kf["uv"]),
        jnp.asarray(kf["pts"]), jnp.asarray(kf["ok"]), jnp.asarray(kf["signs"]),
        jnp.asarray(pid))
    mt = tmap.insert_keyframe(
        mt, torch.tensor(kf["T"]), float(kf["ts"]), torch.tensor(kf["uv"]),
        torch.tensor(kf["pts"]), torch.tensor(kf["ok"]), torch.tensor(kf["signs"]),
        torch.tensor(pid))
    return mt, mj


def _unique_matches(rng, mj, n):
    """pid (K,): n keypoints matched to n distinct valid points, rest -1."""
    valid = np.flatnonzero(np.asarray(mj.pt_valid))
    pid = np.full(K, -1, np.int32)
    pid[rng.choice(K, size=n, replace=False)] = rng.choice(valid, size=n, replace=False)
    return pid


def test_empty_map_matches_jax():
    mt, mj = tmap.empty_map(KCFG, K, "cpu"), jmap.empty_map(KCFG, K)
    _assert_maps_equal(mt, mj)
    assert mt.capacity_kf == M and mt.capacity_pt == P
    rt = interop.map_from_numpy(mj, "cpu")
    _assert_maps_equal(rt, mj)
    _assert_maps_equal(interop.map_from_numpy(interop.map_to_numpy(mt), "cpu"), mj)


def test_insert_cull_recycle_and_capacity_sequence(rng):
    mt, mj = tmap.empty_map(KCFG, K, "cpu"), jmap.empty_map(KCFG, K)
    none = np.full(K, -1, np.int32)
    # keyframe 0: everything spawns
    mt, mj = _insert_both(mt, mj, _keyframe(rng, 0), none)
    _assert_maps_equal(mt, mj)
    n0 = int(mt.n_pt)
    assert n0 == int(tmap.map_point_count(mt)) > 30
    # keyframe 1: 20 matches (one of them to an invalid keypoint), the rest spawn
    kf1 = _keyframe(rng, 1)
    pid1 = _unique_matches(rng, mj, 20)
    kf1["ok"][np.flatnonzero(pid1 >= 0)[0]] = False
    mt, mj = _insert_both(mt, mj, kf1, pid1)
    _assert_maps_equal(mt, mj)
    n_seen = int(((pid1 >= 0) & kf1["ok"]).sum())
    assert int(mt.covis[0, 1]) == int(mt.covis[1, 0]) == n_seen < 20
    assert int(mt.pt_nobs.max()) == 2
    # cull: points of keyframe 0 never seen again go; their slots free up
    mj, nj = jmap.cull_points(mj, jnp.int32(1), min_obs=2, max_age_kf=1)
    mt, nt = tmap.cull_points(mt, 1, min_obs=2, max_age_kf=1)
    assert int(nt) == int(nj) > 10
    _assert_maps_equal(mt, mj)
    freed = np.flatnonzero(~np.asarray(mj.pt_valid))[:5]
    # keyframe 2: spawns recycle the freed slots in ascending order
    mt, mj = _insert_both(mt, mj, _keyframe(rng, 2), _unique_matches(rng, mj, 10))
    _assert_maps_equal(mt, mj)
    assert mt.pt_valid.numpy()[freed].all()
    assert (mt.pt_first_kf.numpy()[freed] == 2).all()
    # keyframe 3: more spawns than free slots -> pt_dropped
    mt, mj = _insert_both(mt, mj, _keyframe(rng, 3), none)
    _assert_maps_equal(mt, mj)
    assert int(mt.pt_dropped) > 0 and int(mt.n_pt) == P and int(mt.n_kf) == M
    # keyframe 4: no room -> nothing changes but kf_dropped
    before = interop.map_to_numpy(mt)
    mt, mj = _insert_both(mt, mj, _keyframe(rng, 4), none)
    _assert_maps_equal(mt, mj)
    after = interop.map_to_numpy(mt)
    assert int(mt.kf_dropped) == 1
    for name in FIELDS:
        if name != "kf_dropped":
            np.testing.assert_array_equal(before[name], after[name], err_msg=name)


def test_duplicate_matches_last_keypoint_wins(rng):
    """Two keypoints on one map point: counts add up exactly as in JAX; the
    point's descriptor is the higher keypoint's in the port, either one in
    the reference."""
    mt, mj = tmap.empty_map(KCFG, K, "cpu"), jmap.empty_map(KCFG, K)
    mt, mj = _insert_both(mt, mj, _keyframe(rng, 0), np.full(K, -1, np.int32))
    kf = _keyframe(rng, 1)
    kf["ok"][:] = True
    pid = np.full(K, -1, np.int32)
    target = int(np.flatnonzero(np.asarray(mj.pt_valid))[3])
    pid[[5, 40, 17]] = target
    mt, mj = _insert_both(mt, mj, kf, pid)
    _assert_maps_equal(mt, mj, skip_rows=[target])
    assert int(mt.pt_nobs[target]) == 4
    np.testing.assert_array_equal(mt.pt_signs[target].numpy(), kf["signs"][40])
    want = np.asarray(mj.pt_signs)[target]
    assert any((want == kf["signs"][j]).all() for j in (5, 17, 40))


@pytest.mark.parametrize("n_kf,window", [(0, 3), (2, 4), (4, 3)])
def test_local_window_matches_jax(n_kf, window):
    mt, mj = tmap.empty_map(KCFG, K, "cpu"), jmap.empty_map(KCFG, K)
    mt = dataclasses.replace(mt, n_kf=torch.tensor(n_kf, dtype=torch.int32))
    mj = mj.replace(n_kf=jnp.int32(n_kf))
    it, vt = tmap.local_window(mt, window)
    ij, vj = jmap.local_window(mj, window)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert it.dtype == torch.int32


def test_edge_list_matches_jax(rng):
    et, ej = EdgeList.empty(3, "cpu"), JEdgeList.empty(3)
    nt, nj = torch.zeros((), dtype=torch.int32), jnp.int32(0)
    for k in range(4):  # the fourth is dropped: full
        T = np.asarray(jse3.exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.1)))
        et, nt = et.add(nt, k, k + 1, torch.tensor(T), 1.0 + k)
        ej, nj = ej.add(nj, k, k + 1, jnp.asarray(T), 1.0 + k)
        got = interop.edges_to_numpy(et)
        for name, g in got.items():
            want = np.asarray(getattr(ej, name))
            assert g.dtype == want.dtype, name
            np.testing.assert_array_equal(g, want, err_msg=name)
        assert int(nt) == int(nj)
    assert int(nt) == 3
    rt = interop.edges_from_numpy(ej, "cpu")
    np.testing.assert_array_equal(rt.T_meas.numpy(), np.asarray(ej.T_meas))


def test_should_insert_keyframe_matches_jax(rng):
    cfg = KeyframeConfig()
    for scale, ratio in ((0.01, 0.9), (0.2, 0.9), (0.01, 0.3), (0.05, 0.7)):
        A = np.asarray(jse3.exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.3)))
        B = A @ np.asarray(jse3.exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * scale)))
        got = tmap.should_insert_keyframe(torch.tensor(B), torch.tensor(A),
                                          torch.tensor(ratio), cfg)
        want = jmap.should_insert_keyframe(jnp.asarray(B), jnp.asarray(A),
                                           jnp.float32(ratio), cfg)
        assert bool(got) == bool(want)
