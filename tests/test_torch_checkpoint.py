"""Checkpoints across the two packages: a JAX checkpoint restores into the
port and a port checkpoint into the JAX session, field for field; save,
restore and continue; the v1 migration; a capacity mismatch raises.

The JAX session runs once, in a module fixture, over 8 small frames, the
port's session beside it on a thread of its own.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu.core import config as jcfg
from slam_rgbd_tpu.io import synthetic as jsyn
from slam_rgbd_tpu.runtime import checkpoint as jck
from slam_rgbd_tpu.runtime import session as jsess
from slam_rgbd_tpu_torch.backend.loop import place_signatures
from slam_rgbd_tpu_torch.core import config as tcfg
from slam_rgbd_tpu_torch.runtime import checkpoint as tck
from slam_rgbd_tpu_torch.runtime.session import SLAMSession
from test_torch_priority import below_the_jax_files  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 8


def _cfg(mod, max_keyframes=8):
    cam = mod.CameraIntrinsics(fx=90.0, fy=90.0, cx=47.5, cy=35.5, width=96, height=72)
    return mod.SLAMConfig(
        camera=cam,
        icp=mod.ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2), backend="xla"),
        orb=mod.ORBConfig(n_features=128, n_levels=4),
        keyframes=mod.KeyframeConfig(max_keyframes=max_keyframes, max_map_points=1024,
                                     kf_min_trans=0.02),
        runtime=mod.RuntimeConfig(max_decision_lag=1),
    )


JCFG, TCFG = _cfg(jcfg), _cfg(tcfg)


@pytest.fixture(scope="module")
def frames():
    gt = jsyn.orbit_trajectory(N + 4, sweep=True)
    out = []
    for i, p in enumerate(gt):
        d, c = jsyn.render_frame(jnp.asarray(p), JCFG.camera)
        out.append((i / 30.0, np.array(d), np.array(c)))
    return out


@pytest.fixture(scope="module")
def saved(frames, tmp_path_factory):
    """A JAX and a port session over the first N frames, each checkpointed."""
    root = tmp_path_factory.mktemp("ck")

    def port():
        ts = SLAMSession(TCFG, device="cpu")
        for f in frames[:N]:
            ts.process_frame(*f)
        tck.save(ts, str(root / "port"))
        return ts

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(port)
        js = jsess.SLAMSession(JCFG)
        for f in frames[:N]:
            js.process_frame(*f)
        jck.save(js, str(root / "jax"))
        ts = fut.result(timeout=600)
    return {"jax": (js, str(root / "jax")), "port": (ts, str(root / "port"))}


def _arrays(path):
    with np.load(os.path.join(path, "state.npz")) as d:
        return {k: d[k] for k in d.files}


def _assert_state(sess_np, want, meta, state):
    """`sess_np`: the restored session's arrays as numpy, by checkpoint key."""
    assert set(sess_np) == set(want)
    for k, v in want.items():
        got = sess_np[k]
        assert got.dtype == v.dtype, (k, got.dtype, v.dtype)
        assert got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    assert (state.frames, state.keyframes, state.loops) == (
        meta["frames"], meta["keyframes"], meta["loops"])


def test_file_layout_and_dtypes_equal_the_jax_package(saved):
    """The same keys, dtypes and shapes in both packages' `state.npz`, the
    edges in the order the JAX package flattens its pytree, and 0-d counts."""
    j, t = _arrays(saved["jax"][1]), _arrays(saved["port"][1])
    assert sorted(j) == sorted(t)
    for k in j:
        assert (j[k].dtype, j[k].shape) == (t[k].dtype, t[k].shape), k
    assert [j[f"edges_{i}"].dtype for i in range(5)] == [
        np.int32, np.int32, np.float32, np.float32, np.bool_]
    for k in ("map.n_kf", "map.n_pt", "n_edges"):
        assert t[k].shape == () and t[k].dtype == np.int32
    assert t["map.kf_time"].dtype == np.float32 and t["map.kp_ok"].dtype == np.bool_
    mj = json.load(open(os.path.join(saved["jax"][1], "meta.json")))
    mt = json.load(open(os.path.join(saved["port"][1], "meta.json")))
    assert sorted(mj) == sorted(mt) and mt["format_version"] == 2


def _port_arrays(sess):
    out = {f"map.{f.name}": getattr(sess.map, f.name).numpy()
           for f in dataclasses.fields(sess.map)}
    out.update({f"edges_{i}": getattr(sess.edges, f.name).numpy()
                for i, f in enumerate(dataclasses.fields(sess.edges))})
    out.update(n_edges=sess.n_edges.numpy(), T_world=sess.T_world.numpy(),
               motion=sess.motion.numpy())
    out.update(zip(("traj_ts", "traj_T", "frame_kf_idx", "kf_T_at_frame"),
                   sess._traj_arrays()))
    return out


def _jax_arrays(sess):
    import jax

    out = {f"map.{f.name}": np.asarray(getattr(sess.map, f.name))
           for f in dataclasses.fields(sess.map)}
    out.update({f"edges_{i}": np.asarray(leaf)
                for i, leaf in enumerate(jax.tree_util.tree_flatten(sess.edges)[0])})
    out.update(n_edges=np.asarray(sess.n_edges), T_world=np.asarray(sess.T_world),
               motion=np.asarray(sess.motion))
    out.update(zip(("traj_ts", "traj_T", "frame_kf_idx", "kf_T_at_frame"),
                   sess._traj_arrays()))
    return out


def test_jax_checkpoint_restores_into_the_port(saved):
    js, path = saved["jax"]
    sess = tck.restore(SLAMSession(TCFG, device="cpu"), path)
    meta = json.load(open(os.path.join(path, "meta.json")))
    _assert_state(_port_arrays(sess), _arrays(path), meta, sess.state)
    assert sess.last_kf_idx == js.last_kf_idx and sess._n_kf_host == js._n_kf_host
    assert torch.equal(sess.last_kf_T, sess.map.kf_pose[sess.last_kf_idx])
    assert sess.prev_pyr is None and not sess._pending


def test_port_checkpoint_restores_into_the_jax_session(saved):
    ts, path = saved["port"]
    js = jck.restore(jsess.SLAMSession(JCFG), path)
    meta = json.load(open(os.path.join(path, "meta.json")))
    _assert_state(_jax_arrays(js), _port_arrays(ts), meta, js.state)
    assert js.last_kf_idx == ts.last_kf_idx


def test_save_restore_continue(saved, frames):
    """A restored port session goes on: the next frame anchors tracking, no
    keyframe is bootstrapped, keyframe slots and the trajectory continue,
    and the JAX session restored from the same file tracks the same frames
    to the same poses."""
    ts, path = saved["port"]
    sess = tck.restore(SLAMSession(TCFG, device="cpu"), path)
    js = jck.restore(jsess.SLAMSession(JCFG), path)
    n_kf = sess._n_kf_host
    for f in frames[N:]:
        sess.process_frame(*f)
        js.process_frame(*f)
    t1, p1 = sess.poses()
    t2, p2 = js.poses()
    assert sess.state.frames == len(frames) == len(t1)
    assert sess._n_kf_host >= n_kf and int(sess.map.n_kf) == sess._n_kf_host
    assert sess.state.keyframes == js.state.keyframes
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_allclose(p1, p2, atol=1e-3)
    assert np.isfinite(p1).all()
    # the saved frames' log is carried over as it was
    for a, b in zip(sess._traj_arrays(), ts._traj_arrays()):
        np.testing.assert_array_equal(a[:N], b)


def _write_v1(src, dst):
    """The v1 layout of a v2 checkpoint: positional map_{i} keys over the
    fields before `kf_sig` existed, no format_version."""
    os.makedirs(dst)
    data = _arrays(src)
    fields = [f.name for f in dataclasses.fields(jsess.smap.MapState) if f.name != "kf_sig"]
    out = {k: v for k, v in data.items() if not k.startswith("map.")}
    out.update({f"map_{i}": data[f"map.{name}"] for i, name in enumerate(fields)})
    np.savez_compressed(os.path.join(dst, "state.npz"), **out)
    meta = json.load(open(os.path.join(src, "meta.json")))
    meta.pop("format_version")
    json.dump(meta, open(os.path.join(dst, "meta.json"), "w"))


def test_v1_checkpoint_migrates_as_in_the_jax_package(saved, tmp_path):
    _, path = saved["port"]
    v1 = str(tmp_path / "v1")
    _write_v1(path, v1)
    sess = tck.restore(SLAMSession(TCFG, device="cpu"), v1)
    js = jck.restore(jsess.SLAMSession(JCFG), v1)
    want = _arrays(path)
    got = _port_arrays(sess)
    for k, v in want.items():
        if k != "map.kf_sig":
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert torch.equal(sess.map.kf_sig, place_signatures(sess.map))
    np.testing.assert_allclose(got["map.kf_sig"], np.asarray(js.map.kf_sig), atol=1e-6)
    np.testing.assert_allclose(got["map.kf_sig"], want["map.kf_sig"], atol=1e-6)
    # a v1 file of another layout is refused
    bad = str(tmp_path / "bad")
    _write_v1(path, bad)
    data = _arrays(bad)
    data.pop("map_0")
    np.savez_compressed(os.path.join(bad, "state.npz"), **data)
    with pytest.raises(ValueError):
        tck.restore(SLAMSession(TCFG, device="cpu"), bad)


def test_capacity_mismatch_raises(saved):
    _, path = saved["jax"]
    other = SLAMSession(_cfg(tcfg, max_keyframes=16), device="cpu")
    with pytest.raises(ValueError, match="capacities must match"):
        tck.restore(other, path)
