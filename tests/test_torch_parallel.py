"""The port's parallel layer against the JAX package's, over real ranks.

One module fixture starts a single group of four gloo ranks on the CPU
(`parallel.mesh.spawn`: spawned processes, a store in a file of a temporary
directory, one thread each). Each rank imports torch and the port only,
loads the same numpy inputs (made here from a seed), and runs the five
sharded programs of `parallel/dist.py` over the meshes (4, 1), (1, 4) and
(2, 2), then `BatchSession(cfg, 4, mesh=)` on the (2, 2) mesh, and writes
what it got to an `.npz` file. This process compares the ranks' results
three ways:

  * against the JAX `dist.*` programs on the conftest's virtual CPU mesh of
    the same shape (the same numpy inputs; each JAX reference once a
    module);
  * against the port's unsharded functions;
  * across ranks: an output that JAX replicates is equal bit for bit on
    every rank.

Tolerances: BA poses 5e-5, points 5e-4, `n_obs` equal; pose graph poses
1e-5, `n_edges` equal (`tests/test_parallel.py`: the sharded sums run in
another order). The Hamming programs, map association, `batch_track` and
the sharded session are exact against the unsharded port. `batch_track`
against the JAX kernel path: poses 1e-5 and inliers equal, as
`tests/test_torch_batch_session.py` holds the unsharded tracker.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from slam_rgbd_tpu_torch import BatchSession, interop
from slam_rgbd_tpu_torch.backend import ba as tba
from slam_rgbd_tpu_torch.backend import pose_graph as tpg
from slam_rgbd_tpu_torch.core import se3 as tse3
from slam_rgbd_tpu_torch.core.config import (
    BAConfig, CameraIntrinsics, ICPConfig, KeyframeConfig, MeshConfig, ORBConfig, SLAMConfig,
)
from slam_rgbd_tpu_torch.mapping import map as tmap
from slam_rgbd_tpu_torch.odometry import icp as ticp
from slam_rgbd_tpu_torch.ops import hamming as th
from slam_rgbd_tpu_torch.parallel import dist as tdist
from slam_rgbd_tpu_torch.parallel import mesh as tmesh
from test_torch_priority import below_the_jax_files  # noqa: F401 (autouse)

CAM = CameraIntrinsics(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
CAM_ICP = CameraIntrinsics(fx=114.1, fy=114.1, cx=63.5, cy=47.5, width=128, height=96)
# one level keeps the JAX kernel path's compile (interpret mode, once a mesh
# shape) short; its three stacked starts are there all the same
ICP = ICPConfig(levels=1, iters=(3,), window_px=(4,), backend="pallas")
BA_CFG = BAConfig(iters=4)
PG_ITERS = 8
MESHES = ((4, 1), (1, 4), (2, 2))
N_TRACK = 4  # sequences of batch_track
SESSION = SLAMConfig(
    camera=CAM_ICP,
    icp=ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2)),
    orb=ORBConfig(n_features=256, n_levels=4),
    keyframes=KeyframeConfig(max_keyframes=16, max_map_points=2048, kf_min_trans=0.02),
    ba=BAConfig(window=4, iters=3, max_points_per_window=512, pg_iters=4,
                loop_min_interval=2, loop_cooldown_kf=2),
)
SESSION_FRAMES = 6
EDGE_FIELDS = ("i", "j", "T_meas", "weight", "valid")


def _exp(xi) -> np.ndarray:
    return tse3.exp(torch.tensor(np.asarray(xi, np.float32))).numpy()


# ---- inputs, made with numpy from a seed -----------------------------------
def _ba_problem(rng, W=4, n_pts=128):
    """A window of W cameras along a path observing n_pts points, poses and
    points perturbed (the scene of `tests/test_parallel.py`)."""
    pts_w = np.stack([rng.uniform(-1.5, 1.5, n_pts), rng.uniform(-1, 1, n_pts),
                      rng.uniform(2, 4, n_pts)], 1).astype(np.float32)
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(W - 1):
        poses.append(poses[-1] @ _exp([0.06, 0.01, 0.02, 0.01, 0.02, 0.0]))
    poses = np.stack(poses)
    obs_uv = np.zeros((W, n_pts, 2), np.float32)
    obs_z = np.zeros((W, n_pts), np.float32)
    obs_ok = np.zeros((W, n_pts), bool)
    for w in range(W):
        T_cw = np.linalg.inv(poses[w])
        pc = pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]
        u = CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx
        v = CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy
        obs_uv[w] = np.stack([u + rng.normal(0, 0.3, n_pts), v + rng.normal(0, 0.3, n_pts)], 1)
        obs_z[w] = pc[:, 2]
        obs_ok[w] = (u > 0) & (u < 160) & (v > 0) & (v < 120)
    poses_init = poses.copy()
    for w in range(1, W):
        poses_init[w] = poses[w] @ _exp(rng.normal(size=6) * 0.01)
    pts_init = pts_w + rng.normal(size=pts_w.shape).astype(np.float32) * 0.01
    return {"ba_poses": poses_init.astype(np.float32), "ba_pts": pts_init.astype(np.float32),
            "ba_uv": obs_uv, "ba_z": obs_z, "ba_ok": obs_ok,
            "ba_pid": np.tile(np.arange(n_pts, dtype=np.int32), (W, 1))}


def _graph(M=12, E=32):
    """A drifted odometry chain with one loop edge, padded to E slots."""
    gt = [np.eye(4, dtype=np.float32)]
    for k in range(M - 1):
        gt.append(gt[-1] @ _exp([0.1, 0.02 * np.sin(k), 0, 0, 0.09, 0]))
    drift = _exp([0.004, 0.001, 0, 0, 0.003, 0])
    i, j = np.zeros(E, np.int32), np.zeros(E, np.int32)
    T_meas = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    weight, valid = np.zeros(E, np.float32), np.zeros(E, bool)
    poses = [gt[0]]
    for k in range(M - 1):
        T_rel = np.linalg.inv(gt[k]) @ gt[k + 1]
        i[k], j[k], T_meas[k], weight[k], valid[k] = k, k + 1, T_rel, 1.0, True
        poses.append(poses[-1] @ T_rel @ drift)
    i[M - 1], j[M - 1], weight[M - 1], valid[M - 1] = 0, M - 1, 5.0, True
    T_meas[M - 1] = np.linalg.inv(gt[0]) @ gt[M - 1]
    return {"pg_poses": np.stack(poses).astype(np.float32), "pg_gt": np.stack(gt),
            "pg_i": i, "pg_j": j, "pg_T_meas": T_meas.astype(np.float32),
            "pg_weight": weight, "pg_valid": valid}


def _descriptors(rng, K1=256, K2=192):
    """Random sign descriptors with seeded ties (columns 150-169 copy 10-29,
    so the first index must win and second == best) and invalid rows and
    columns."""
    s1 = rng.choice([-1, 1], size=(K1, 256)).astype(np.int8)
    s2 = rng.choice([-1, 1], size=(K2, 256)).astype(np.int8)
    s2[150:170] = s2[10:30]
    s1[:40] = s2[:40] * np.where(rng.random((40, 256)) < 0.08, -1, 1).astype(np.int8)
    v1, v2 = np.ones(K1, bool), np.ones(K2, bool)
    v1[rng.choice(K1, 16, replace=False)] = False
    v2[rng.choice(K2, 12, replace=False)] = False
    v2[10:30] = True
    return {"hm_s1": s1, "hm_v1": v1, "hm_s2": s2, "hm_v2": v2}


def _map_scene(rng, K=64, cap=512):
    """The point table of a map with one keyframe (cap slots: the keypoints
    in view spawned points in slot order) and a query near it: points 0-31
    repeated in slots 448-479 (the last block of every mesh here), so that
    ties between blocks go to the lower index."""
    pts_w = np.stack([rng.uniform(-1.5, 1.5, K), rng.uniform(-1.0, 1.0, K),
                      rng.uniform(2.0, 4.0, K)], axis=1).astype(np.float32)
    z = pts_w[:, 2]
    u = CAM.fx * pts_w[:, 0] / z + CAM.cx
    v = CAM.fy * pts_w[:, 1] / z + CAM.cy
    ok = (u >= 0) & (u < CAM.width) & (v >= 0) & (v < CAM.height)
    uv = np.stack([u, v], 1).astype(np.float32)
    signs = rng.choice([-1, 1], size=(K, 256)).astype(np.int8)
    n = int(ok.sum())
    xyz, sg, va = np.zeros((cap, 3), np.float32), np.zeros((cap, 256), np.int8), np.zeros(cap, bool)
    xyz[:n], sg[:n], va[:n] = pts_w[ok], signs[ok], True
    xyz[448:480], sg[448:480], va[448:480] = xyz[:32], sg[:32], va[:32]
    return {"mp_xyz": xyz, "mp_signs": sg, "mp_valid": va, "mp_signs_q": signs,
            "mp_ok": ok, "mp_uv": (uv + rng.normal(0, 2.0, uv.shape)).astype(np.float32),
            "mp_z": (z * (1 + rng.normal(0, 0.02, K))).astype(np.float32), "mp_pts": pts_w}


def _track_problems():
    """N_TRACK frame pairs of two orbits at 128x96, pyramids built by the
    JAX package (both packages then track from the same planes)."""
    import jax
    import jax.numpy as jnp

    from slam_rgbd_tpu.core import camera as jcam
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory, render_frame

    src, tgt = [], []
    for b in range(N_TRACK):
        gt = orbit_trajectory(2 + b, step_t=0.012 + 0.002 * b, step_r=0.01, seed=b)
        for pose, out in ((gt[-1], src), (gt[-2], tgt)):
            d, c = render_frame(pose, CAM_ICP)
            out.append(jcam.build_frame_pyramid(jnp.asarray(d.numpy()), CAM_ICP,
                                                levels=ICP.levels, rgb=jnp.asarray(c.numpy())))
    stack = lambda ps: jax.tree.map(lambda *x: np.stack([np.asarray(a) for a in x]), *ps)
    out = {}
    for name, pyr in (("src", stack(src)), ("tgt", stack(tgt))):
        for k, level in enumerate(pyr):
            for key, v in level.items():
                out[f"tk_{name}_{k}_{key}"] = v
    out["tk_T0"] = np.stack([_exp([0.002 * b, 0, 0, 0, 0, 0]) for b in range(N_TRACK)])
    return out


def _session_frames():
    """(SESSION_FRAMES, 4, H, W) depth and (..., 3) colour: four orbits."""
    from slam_rgbd_tpu_torch.io.synthetic import orbit_trajectory, render_frame

    depth = np.zeros((SESSION_FRAMES, 4, CAM_ICP.height, CAM_ICP.width), np.uint16)
    rgb = np.zeros(depth.shape + (3,), np.uint8)
    for b in range(4):
        gt = orbit_trajectory(SESSION_FRAMES, step_t=0.016 + 0.003 * b, step_r=0.012,
                              seed=b, sweep=b == 0)
        for i, pose in enumerate(gt):
            d, c = render_frame(pose, CAM_ICP)
            depth[i, b], rgb[i, b] = d.numpy(), c.numpy()
    return {"ss_depth": depth, "ss_rgb": rgb}


def _pyr(x: dict, name: str) -> tuple:
    return interop.pyramid_from_numpy(
        [{key: x[f"tk_{name}_{k}_{key}"] for key in ("vertices", "normals", "valid",
                                                     "intensity", "grad")
          if f"tk_{name}_{k}_{key}" in x} for k in range(ICP.levels)], "cpu")


def _edges(x: dict) -> tpg.EdgeList:
    return interop.edges_from_numpy({f: x[f"pg_{f}"] for f in EDGE_FIELDS}, "cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---- what every rank runs ----------------------------------------------------
def _rank_checks(rank: int, world: int, tmp: str) -> None:
    """Every sharded program on each mesh, then the sharded session; writes
    this rank's results to rank<r>.npz."""
    x = dict(np.load(os.path.join(tmp, "inputs.npz")))
    out = {}
    for d, m in MESHES:
        mesh = tmesh.make_mesh(MeshConfig(data=d, model=m), "cpu")
        tag = f"{d}x{m}"
        sh = lambda a, axis="model", dim=0: tmesh.shard(_t(a), mesh, axis, dim)

        res = tdist.sharded_local_ba(
            mesh, _t(x["ba_poses"]), torch.ones(4, dtype=torch.bool), _t(x["ba_pts"]),
            sh(x["ba_uv"], dim=1), sh(x["ba_z"], dim=1), sh(x["ba_pid"], dim=1),
            sh(x["ba_ok"], dim=1), CAM, BA_CFG)
        out[f"{tag}/ba_pose"], out[f"{tag}/ba_pts"] = res.kf_pose.numpy(), res.pt_xyz.numpy()
        out[f"{tag}/ba_rmse"], out[f"{tag}/ba_nobs"] = res.rmse_px.numpy(), res.n_obs.numpy()

        src = tuple({k: tmesh.shard(v, mesh, "data") for k, v in lvl.items()}
                    for lvl in _pyr(x, "src"))
        tgt = tuple({k: tmesh.shard(v, mesh, "data") for k, v in lvl.items()}
                    for lvl in _pyr(x, "tgt"))
        T, inl, rmse, vf = tdist.batch_track(mesh, src, tgt, sh(x["tk_T0"], "data"),
                                             CAM_ICP, ICP)
        out[f"{tag}/tk_T"], out[f"{tag}/tk_inl"] = T.numpy(), inl.numpy()
        out[f"{tag}/tk_rmse"], out[f"{tag}/tk_vf"] = rmse.numpy(), vf.numpy()

        for merge in (True, False):
            pid = tdist.sharded_map_association(
                mesh, _t(x["mp_signs_q"]), _t(x["mp_ok"]), _t(x["mp_uv"]), _t(x["mp_z"]),
                torch.eye(4), sh(x["mp_xyz"]), sh(x["mp_signs"]), sh(x["mp_valid"]), CAM,
                kp_pts=_t(x["mp_pts"]) if merge else None, merge_radius=0.08)
            out[f"{tag}/mp_pid_{merge}"] = pid.numpy()

        pg = tdist.sharded_pose_graph(mesh, _t(x["pg_poses"]), torch.ones(12, dtype=torch.bool),
                                      tdist.edge_block(_edges(x), mesh), iters=PG_ITERS)
        out[f"{tag}/pg_poses"], out[f"{tag}/pg_rmse"] = pg.poses.numpy(), pg.rmse.numpy()
        out[f"{tag}/pg_n"] = pg.n_edges.numpy()

        idx, best, ok = tdist.sharded_hamming_match(
            mesh, sh(x["hm_s1"]), sh(x["hm_v1"]), _t(x["hm_s2"]), _t(x["hm_v2"]), ratio=0.99)
        out[f"{tag}/hm_idx"], out[f"{tag}/hm_best"] = idx.numpy(), best.numpy()
        out[f"{tag}/hm_ok"] = ok.numpy()

    # the session on the (2, 2) mesh: 2 sequences a data rank, the two model
    # ranks of a data index replicas of each other
    bs = BatchSession(SESSION, 4, device="cpu", mesh=mesh)
    for i in range(SESSION_FRAMES):
        bs.process_frames(i / 30.0, x["ss_depth"][i], x["ss_rgb"][i])
    out["ss_poses"] = bs.poses()[1]
    out["ss_kf"], out["ss_pts"] = bs.keyframe_counts, bs.map_point_counts()
    st = bs.state
    out["ss_state"] = np.stack([st.lost, st.loops, st.relocalized])
    mine = interop.batch_state_to_numpy(bs)
    out["ss_block_T"], out["ss_block_xyz"] = mine["T_world"], mine["maps"]["pt_xyz"]
    out["ss_n_local"] = np.asarray(bs.n_local)
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)


# ---- the run and the references, once a module ---------------------------------
@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the inputs, the four ranks' results, the JAX references). The ranks
    run while this process computes the references: a thread waits for
    them."""
    rng = np.random.default_rng(0)
    x = {**_ba_problem(rng), **_graph(), **_descriptors(rng), **_map_scene(rng),
         **_track_problems(), **_session_frames()}
    tmp = str(tmp_path_factory.mktemp("ranks"))
    np.savez(os.path.join(tmp, "inputs.npz"), **x)
    failed = []

    def ranks_run():
        try:
            tmesh.spawn(_rank_checks, 4, args=(tmp,), backend="gloo", device="cpu",
                        threads=1)
        except Exception as e:  # raised in this process below
            failed.append(e)

    waiter = threading.Thread(target=ranks_run)
    waiter.start()
    try:
        ref = _jax_references(x)
    finally:
        waiter.join(timeout=600)
    assert not waiter.is_alive(), "the ranks did not finish"
    if failed:
        raise failed[0]
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(4)]
    return x, ranks, ref


@pytest.fixture(scope="module")
def run(both):
    return both[:2]


@pytest.fixture(scope="module")
def jax_ref(both):
    return both[2]


def _coords(shape, rank):
    """(data index, model index) of `rank` on a (data, model) mesh: ranks
    fill the mesh row by row."""
    return divmod(rank, shape[1])


def _jax_references(x: dict) -> dict:
    """The JAX `dist.*` programs on a virtual CPU mesh of each shape."""
    import jax
    import jax.numpy as jnp

    from slam_rgbd_tpu.backend.pose_graph import EdgeList as JEdgeList
    from slam_rgbd_tpu.core.config import MeshConfig as JMeshConfig
    from slam_rgbd_tpu.parallel import dist as jdist
    from slam_rgbd_tpu.parallel import mesh as jmesh

    J = jnp.asarray
    src = [{key: J(x[f"tk_src_{k}_{key}"]) for key in ("vertices", "normals", "valid",
                                                     "intensity", "grad")
            if f"tk_src_{k}_{key}" in x} for k in range(ICP.levels)]
    tgt = [{key: J(x[f"tk_tgt_{k}_{key}"]) for key in ("vertices", "normals", "valid",
                                                     "intensity", "grad")
            if f"tk_tgt_{k}_{key}" in x} for k in range(ICP.levels)]
    edges = JEdgeList(**{f: J(x[f"pg_{f}"]) for f in EDGE_FIELDS})
    out = {}
    for shape in MESHES:
        mesh = jmesh.make_mesh(JMeshConfig(data=shape[0], model=shape[1]),
                               devices=jax.devices()[:4])
        # each program under jit: one compile, not an op-by-op shard_map
        res = jax.jit(lambda *a: jdist.sharded_local_ba(mesh, *a, CAM, BA_CFG))(
            J(x["ba_poses"]), jnp.ones(4, bool), J(x["ba_pts"]), J(x["ba_uv"]),
            J(x["ba_z"]), J(x["ba_pid"]), J(x["ba_ok"]))
        T, inl, _, _ = jax.jit(lambda *a: jdist.batch_track(mesh, *a, CAM_ICP, ICP))(
            src, tgt, J(x["tk_T0"]))
        assoc = lambda merge: jax.jit(lambda *a: jdist.sharded_map_association(
            mesh, *a, CAM, kp_pts=J(x["mp_pts"]) if merge else None, merge_radius=0.08))
        pids = {merge: assoc(merge)(
            J(x["mp_signs_q"]), J(x["mp_ok"]), J(x["mp_uv"]), J(x["mp_z"]), jnp.eye(4),
            J(x["mp_xyz"]), J(x["mp_signs"]), J(x["mp_valid"])) for merge in (True, False)}
        pg = jax.jit(lambda *a: jdist.sharded_pose_graph(mesh, *a, iters=PG_ITERS))(
            J(x["pg_poses"]), jnp.ones(12, bool), edges)
        hm = jax.jit(lambda *a: jdist.sharded_hamming_match(mesh, *a, ratio=0.99))(
            J(x["hm_s1"]), J(x["hm_v1"]), J(x["hm_s2"]), J(x["hm_v2"]))
        out[shape] = {
            "ba": (np.asarray(res.kf_pose), np.asarray(res.pt_xyz), int(res.n_obs)),
            "tk": (np.asarray(T), np.asarray(inl)),
            "mp": {k: np.asarray(v) for k, v in pids.items()},
            "pg": (np.asarray(pg.poses), int(pg.n_edges)),
            "hm": tuple(np.asarray(a) for a in hm),
        }
    return out


def _blocks(ranks, shape, key, axis):
    """The full array from the ranks' blocks along mesh axis `axis`, and
    a check that the replicas (the ranks that hold the same block) agree bit
    for bit."""
    n = shape[0] if axis == "data" else shape[1]
    parts = {}
    for r, res in enumerate(ranks):
        d, m = _coords(shape, r)
        i = d if axis == "data" else m
        if i in parts:
            np.testing.assert_array_equal(res[key], parts[i], err_msg=f"rank {r} {key}")
        else:
            parts[i] = res[key]
    return np.concatenate([parts[i] for i in range(n)])


def _replicated(ranks, key):
    """The value every rank returned, after checking they agree bit for bit."""
    for r, res in enumerate(ranks[1:], 1):
        np.testing.assert_array_equal(res[key], ranks[0][key], err_msg=f"rank {r} {key}")
    return ranks[0][key]


# ---- the mesh factorization ----------------------------------------------------
@pytest.mark.parametrize("world,cfg,want", [
    (8, MeshConfig(), (8, 1)),
    (8, MeshConfig(data=4, model=2), (4, 2)),
    (8, MeshConfig(data=2), (2, 4)),
    (8, MeshConfig(model=4), (2, 4)),
    (1, MeshConfig(), (1, 1)),
    (9, MeshConfig(data=3, model=3), (3, 3)),
])
def test_mesh_shape_infers_axes(world, cfg, want):
    """The cases of tests/test_parallel.py::TestMesh, as a function of the
    world size: axis sizes of 0 are inferred (model 1, data the rest)."""
    assert tmesh.mesh_shape(world, cfg) == want


@pytest.mark.parametrize("world,cfg", [(8, MeshConfig(data=3, model=3)),
                                       (8, MeshConfig(data=3)), (6, MeshConfig(model=4))])
def test_mesh_shape_rejects_bad_factorization(world, cfg):
    with pytest.raises(ValueError):
        tmesh.mesh_shape(world, cfg)


def test_make_mesh_and_initialize_need_a_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(MeshConfig(), "cpu")
    tmesh.initialize_distributed(world_size=1, rank=0, device="cpu")  # one process: nothing
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        tmesh.initialize_distributed("file:///nonexistent/store", 2, 0, backend="nccl",
                                     device="cpu")


# ---- the five programs, on each mesh -------------------------------------------
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_local_ba(run, jax_ref, shape):
    x, ranks = run
    tag = f"{shape[0]}x{shape[1]}"
    pose, pts = _replicated(ranks, f"{tag}/ba_pose"), _replicated(ranks, f"{tag}/ba_pts")
    _replicated(ranks, f"{tag}/ba_rmse")
    n_obs = int(_replicated(ranks, f"{tag}/ba_nobs"))
    ref = tba.local_ba(_t(x["ba_poses"]), torch.ones(4, dtype=torch.bool), _t(x["ba_pts"]),
                       _t(x["ba_uv"]), _t(x["ba_z"]), _t(x["ba_pid"]), _t(x["ba_ok"]),
                       CAM, BA_CFG)
    j_pose, j_pts, j_n = jax_ref[shape]["ba"]
    for want_pose, want_pts, want_n in ((ref.kf_pose.numpy(), ref.pt_xyz.numpy(),
                                         int(ref.n_obs)), (j_pose, j_pts, j_n)):
        np.testing.assert_allclose(pose, want_pose, atol=5e-5)
        np.testing.assert_allclose(pts, want_pts, atol=5e-4)
        assert n_obs == want_n
    assert np.abs(pose - x["ba_poses"]).max() > 1e-3  # the solve moved the cameras


@pytest.mark.parametrize("shape", MESHES)
def test_batch_track(run, jax_ref, shape):
    x, ranks = run
    tag = f"{shape[0]}x{shape[1]}"
    T, inl = (_blocks(ranks, shape, f"{tag}/tk_{k}", "data") for k in ("T", "inl"))
    rmse, vf = (_blocks(ranks, shape, f"{tag}/tk_{k}", "data") for k in ("rmse", "vf"))
    ref = ticp.icp_align_batched(_pyr(x, "src"), _pyr(x, "tgt"), _t(x["tk_T0"]), CAM_ICP, ICP)
    np.testing.assert_array_equal(T, ref.T.numpy())
    np.testing.assert_array_equal(inl, ref.inliers.numpy())
    np.testing.assert_array_equal(rmse, ref.rmse.numpy())
    np.testing.assert_array_equal(vf, ref.valid_fraction.numpy())
    j_T, j_inl = jax_ref[shape]["tk"]
    np.testing.assert_allclose(T, j_T, atol=1e-5)
    assert inl.tolist() == j_inl.tolist() and (inl > 1000).all()


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("merge", [True, False])
def test_sharded_map_association(run, jax_ref, shape, merge):
    x, ranks = run
    pid = _replicated(ranks, f"{shape[0]}x{shape[1]}/mp_pid_{merge}")
    # the unsharded association over the whole table
    d1, i1, d2, i2 = tmap.association_candidates(
        _t(x["mp_xyz"]), _t(x["mp_signs"]), _t(x["mp_valid"]), _t(x["mp_signs_q"]),
        _t(x["mp_ok"]), _t(x["mp_uv"]), _t(x["mp_z"]), torch.eye(4), CAM, 6.0, 0.08,
        _t(x["mp_pts"]) if merge else None, 0.08)
    ref = tmap.association_ids(d1, i1, d2, i2, 64.0, 40.0, merge).numpy()
    np.testing.assert_array_equal(pid, ref)
    np.testing.assert_array_equal(pid, jax_ref[shape]["mp"][merge])
    assert (pid >= 0).sum() > 0.5 * x["mp_ok"].sum()
    assert pid.max() < 448  # a tie between blocks went to the lower index


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_pose_graph(run, jax_ref, shape):
    x, ranks = run
    tag = f"{shape[0]}x{shape[1]}"
    poses = _replicated(ranks, f"{tag}/pg_poses")
    _replicated(ranks, f"{tag}/pg_rmse")
    n = int(_replicated(ranks, f"{tag}/pg_n"))
    ref = tpg.optimize_pose_graph(_t(x["pg_poses"]), torch.ones(12, dtype=torch.bool),
                                  _edges(x), iters=PG_ITERS)
    j_poses, j_n = jax_ref[shape]["pg"]
    for want, want_n in ((ref.poses.numpy(), int(ref.n_edges)), (j_poses, j_n)):
        np.testing.assert_allclose(poses, want, rtol=0, atol=1e-5)
        assert n == want_n == 12
    gt = x["pg_gt"]
    before = np.linalg.norm(x["pg_poses"][:, :3, 3] - gt[:, :3, 3], axis=1).max()
    after = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1).max()
    assert after < 0.5 * before


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_hamming_match(run, jax_ref, shape):
    x, ranks = run
    tag = f"{shape[0]}x{shape[1]}"
    idx, best, ok = (_blocks(ranks, shape, f"{tag}/hm_{k}", "model")
                     for k in ("idx", "best", "ok"))
    b, s, i = th.hamming_top2(_t(x["hm_s1"]), _t(x["hm_v1"]), _t(x["hm_s2"]), _t(x["hm_v2"]))
    np.testing.assert_array_equal(idx, i.numpy())
    np.testing.assert_array_equal(best, b.numpy())
    np.testing.assert_array_equal(ok, ((b < 64.0) & (b < 0.99 * s) & _t(x["hm_v1"])).numpy())
    for got, want in zip((idx, best, ok), jax_ref[shape]["hm"]):
        np.testing.assert_array_equal(got, want)
    tied = (s == b) & (b < 1e9)
    assert int(tied.sum()) >= 10 and not ok[tied.numpy()].any()


# ---- the sharded session ---------------------------------------------------------
@pytest.fixture(scope="module")
def unsharded_session(run):
    """The same frames through `BatchSession(cfg, 4)` in this process, on
    one thread as the ranks run: with more threads some CPU reductions sum
    in another order, and the poses move in the last bits (1e-7)."""
    x, _ = run
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bs = BatchSession(SESSION, 4, device="cpu")
        for i in range(SESSION_FRAMES):
            bs.process_frames(i / 30.0, x["ss_depth"][i], x["ss_rgb"][i])
    finally:
        torch.set_num_threads(threads)
    return bs


def test_batch_session_on_a_mesh_equals_the_unsharded_session(run, unsharded_session):
    """BatchSession(cfg, 4, mesh=) over the (2, 2) mesh: every rank returns
    all four sequences, equal bit for bit to the unsharded session's, and
    each rank's array state is its block of two sequences."""
    _, ranks = run
    ref = unsharded_session
    poses = _replicated(ranks, "ss_poses")
    np.testing.assert_array_equal(poses, ref.poses()[1])
    assert _replicated(ranks, "ss_kf").tolist() == ref.keyframe_counts.tolist()
    assert (ref.keyframe_counts >= 3).all()
    assert _replicated(ranks, "ss_pts").tolist() == ref.map_point_counts().tolist()
    st = ref.state
    np.testing.assert_array_equal(_replicated(ranks, "ss_state"),
                                  np.stack([st.lost, st.loops, st.relocalized]))
    full = interop.batch_state_to_numpy(ref)
    for r, res in enumerate(ranks):
        d, _ = _coords((2, 2), r)
        assert int(res["ss_n_local"]) == 2
        np.testing.assert_array_equal(res["ss_block_T"], full["T_world"][2 * d: 2 * d + 2])
        np.testing.assert_array_equal(res["ss_block_xyz"],
                                      full["maps"]["pt_xyz"][2 * d: 2 * d + 2])


def test_batch_session_rejects_an_uneven_data_axis():
    class TwoByOne:  # the mesh interface BatchSession reads
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return (2, 1)[dim]

    with pytest.raises(ValueError, match="not divisible by data axis 2"):
        BatchSession(SESSION, 3, device="cpu", mesh=TwoByOne())


# ---- BA across two ranks (the counterpart of tests/test_multiprocess.py) ----------
def _two_rank_ba(rank: int, world: int, x: dict) -> dict:
    mesh = tmesh.make_mesh(MeshConfig(model=world), "cpu")
    sh = lambda a: tmesh.shard(_t(a), mesh, "model", dim=1)
    res = tdist.sharded_local_ba(
        mesh, _t(x["ba_poses"]), torch.ones(3, dtype=torch.bool), _t(x["ba_pts"]),
        sh(x["ba_uv"]), sh(x["ba_z"]), sh(x["ba_pid"]), sh(x["ba_ok"]), CAM,
        BAConfig(iters=3))
    return {"pose": res.kf_pose.numpy(), "pts": res.pt_xyz.numpy(), "n": int(res.n_obs),
            "shape": tuple(mesh.shape), "cols": int(sh(x["ba_uv"]).shape[1])}


def test_two_rank_sharded_ba_matches_local_ba():
    """Two processes, one (1, 2) mesh, the observation columns split between
    them: both return the single-process `local_ba` result."""
    x = _ba_problem(np.random.default_rng(0), W=3, n_pts=64)
    got = tmesh.spawn(_two_rank_ba, 2, args=(x,), backend="gloo", device="cpu", threads=1)
    ref = tba.local_ba(_t(x["ba_poses"]), torch.ones(3, dtype=torch.bool), _t(x["ba_pts"]),
                       _t(x["ba_uv"]), _t(x["ba_z"]), _t(x["ba_pid"]), _t(x["ba_ok"]),
                       CAM, BAConfig(iters=3))
    assert got[0]["shape"] == (1, 2) and got[0]["cols"] == 32
    for g in got:
        np.testing.assert_array_equal(g["pose"], got[0]["pose"])
        np.testing.assert_array_equal(g["pts"], got[0]["pts"])
        np.testing.assert_allclose(g["pose"], ref.kf_pose.numpy(), atol=5e-5)
        np.testing.assert_allclose(g["pts"], ref.pt_xyz.numpy(), atol=5e-4)
        assert g["n"] == int(ref.n_obs)


# ---- benchmark --scaling -----------------------------------------------------------
def test_benchmark_scaling_cli_on_the_cpu(tmp_path):
    """The verb at 64x48 with a two-level schedule: the report names the
    CPU, one device, both tables with their keys, and the sharing note."""
    from slam_rgbd_tpu_torch.__main__ import main

    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text("icp:\n  levels: 2\n  iters: [2, 1]\n  window_px: [4, 2]\n")
    out = tmp_path / "scaling.json"
    assert main(["benchmark", "--scaling", "--iters", "1", "--width", "64", "--height", "48",
                 "--config", str(cfg_path), "--device", "cpu", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["platform"] == "cpu" and rep["hardware"] == "cpu" and rep["n_devices"] == 1
    assert rep["resolution"] == "64x48" and "note" in rep
    assert [r["mesh_data"] for r in rep["mesh_scaling"]] == [1]
    rows = rep["batch_scaling_1dev"]
    assert [r["batch"] for r in rows] == [1, 2, 4, 8]
    assert rows[0]["efficiency"] == 1.0 and "marginal_ms_per_seq" in rows[1]
    assert all(r["frames_per_s"] > 0 and r["step_ms"] > 0 for r in rows)
    with pytest.raises(SystemExit):
        main(["benchmark", "--device", "cpu"])  # without --scaling: a usage error
