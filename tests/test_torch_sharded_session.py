"""The map-block sharded session, `SLAMSession(cfg, mesh=)`, over real ranks.

One module fixture starts a group of two gloo ranks on the CPU
(`parallel.mesh.spawn`, one thread each) on a (data 1, model 2) mesh: each
rank holds one block of every point array. The ranks load the same numpy
inputs (made here from a seed) and run every check of the slice:

  (a) `insert_keyframe` and `cull_points` on the blocks of a JAX map
      carried over by `interop.map_block_from_numpy`: a near-capacity map
      whose free slots span both blocks (spawns dropped), and one whose
      first block is full;
  (b) `parallel.dist.sharded_map_match` with ties across the block
      boundary;
  (c) `backend_pass` on a loop scene: BA, a closed loop, fusion, global BA;
  (d) the session at `max_decision_lag=1` over 12 frames, its `reset()`,
      and checkpoints across the sharded and the unsharded session;
  (f) the threaded sharded session, `async_backend=True` with a model axis
      of 2: forced by `sync_backend()` after every frame; free-running
      behind `PipelineRunner(threads=True)` with rank 1's passes slowed (its
      `backend_pass` sleeps before and after each pass); the worker's
      process groups, and `close()` with a pass in flight;
  (g) a mesh whose model axis is 1 is the unsharded path.

Meanwhile this process computes the references: the port's unsharded
functions and session on the same inputs (one thread, as the ranks: more
intra-op threads reorder some CPU sums), and (e) the JAX package's own
sharded session on a (1, 2) mesh of the conftest's virtual CPU devices.
Against the unsharded port everything is bit for bit (the blocks gathered);
against the JAX sharded session the bounds of
`tests/test_batch_session.py::test_map_block_sharded_session_mode`: the same
keyframes, poses within 1 cm, ATE under 2 cm. The free-running threaded runs
are held against each other: both ranks merge the same results at the same
calls. Every wait on the ranks has a deadline, so a deadlock fails a test.
"""

import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from slam_rgbd_tpu_torch import SLAMSession, interop
from slam_rgbd_tpu_torch.backend import worker as tworker
from slam_rgbd_tpu_torch.backend.pose_graph import EdgeList
from slam_rgbd_tpu_torch.core import config as tc
from slam_rgbd_tpu_torch.core import se3 as tse3
from slam_rgbd_tpu_torch.core.config import (
    BAConfig, CameraIntrinsics, KeyframeConfig, MeshConfig, ORBConfig, SLAMConfig,
)
from slam_rgbd_tpu_torch.features import match as tmatch
from slam_rgbd_tpu_torch.mapping import map as tmap
from slam_rgbd_tpu_torch.parallel import dist as tdist
from slam_rgbd_tpu_torch.parallel import mesh as tmesh
from slam_rgbd_tpu_torch.runtime import checkpoint as tckpt
from slam_rgbd_tpu_torch.runtime.runner import PipelineRunner
from slam_rgbd_tpu_torch.viz.pointcloud import map_to_pointcloud
from test_torch_priority import below_the_jax_files  # noqa: F401 (autouse)

torch.set_num_threads(1)

RANKS = 2
CAM = CameraIntrinsics(fx=96.0, fy=96.0, cx=63.5, cy=47.5, width=128, height=96)
N_FRAMES = 12  # the session's frames: 10, a checkpoint, then 2 more
N_CKPT = 10
P_SCENE, K_SCENE = 512, 64  # the map scenes of (a) and (b)
SLOW_S = 0.3  # (f) rank 1's backend pass sleeps this long before and after
FREE_DEADLINE_S = 120.0  # (f) a free-running threaded run ends within this
CLOSE_DEADLINE_S = 30.0  # (f) `close()` with a pass in flight returns within this
RANKS_DEADLINE_S = 400.0  # the ranks end within this


def session_config(pkg, model: int = 2):
    """`tests/test_batch_session.py:25-33` sizes at 128x96, the decisions at
    the next call."""
    return pkg.SLAMConfig(
        camera=pkg.CameraIntrinsics(fx=96.0, fy=96.0, cx=63.5, cy=47.5, width=128,
                                    height=96),
        icp=pkg.ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2)),
        orb=pkg.ORBConfig(n_features=256, n_levels=4),
        keyframes=pkg.KeyframeConfig(max_keyframes=16, max_map_points=2048,
                                     kf_min_trans=0.04, kf_min_rot_deg=4.0),
        ba=pkg.BAConfig(window=4, iters=3, max_points_per_window=512),
        mesh=pkg.MeshConfig(data=1, model=model),
        runtime=pkg.RuntimeConfig(max_decision_lag=1),
    )


SESSION = session_config(tc)


# ---- inputs, made with numpy from a seed ----------------------------------
def _map_scene(rng, free: list, n_valid_kf: int = 3) -> dict:
    """A map in the JAX package's layout (the fields of its `empty_map`):
    every point slot valid but `free`, three keyframes observing valid
    points, random observation counts and ages."""
    from slam_rgbd_tpu.core import config as jc
    from slam_rgbd_tpu.mapping import map as jmap

    jm = jmap.empty_map(jc.KeyframeConfig(max_keyframes=8, max_map_points=P_SCENE),
                        K_SCENE)
    m = {f.name: np.array(getattr(jm, f.name)) for f in dataclasses.fields(jm)}
    valid = np.ones(P_SCENE, bool)
    valid[free] = False
    ids = np.flatnonzero(valid)
    m["pt_valid"] = valid
    m["pt_xyz"] = rng.uniform(-2, 2, (P_SCENE, 3)).astype(np.float32)
    m["pt_signs"] = rng.choice(np.array([-1, 1], np.int8), (P_SCENE, 256))
    m["pt_nobs"] = np.where(valid, rng.integers(1, 4, P_SCENE), 0).astype(np.int32)
    m["pt_first_kf"] = np.where(valid, rng.integers(0, n_valid_kf, P_SCENE), -1).astype(np.int32)
    m["pt_last_kf"] = np.where(valid, rng.integers(0, n_valid_kf, P_SCENE), -1).astype(np.int32)
    m["n_pt"] = np.int32(valid.sum())
    m["n_kf"] = np.int32(n_valid_kf)
    m["kf_valid"][:n_valid_kf] = True
    for k in range(n_valid_kf):
        pid = rng.choice(ids, K_SCENE, replace=False).astype(np.int32)
        pid[rng.random(K_SCENE) < 0.3] = -1
        m["point_id"][k] = pid
        m["kp_ok"][k] = pid >= 0
        m["kf_time"][k] = k
    return m


def _insert_inputs(rng, m: dict) -> dict:
    """A keyframe of K_SCENE keypoints: half match valid points of both
    blocks (two keypoints on one point), the rest spawn."""
    ids = np.flatnonzero(m["pt_valid"])
    match = np.full(K_SCENE, -1, np.int32)
    match[: K_SCENE // 2] = rng.choice(ids, K_SCENE // 2, replace=False)
    match[1] = match[0]
    ok = np.ones(K_SCENE, bool)
    ok[5] = False
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.1, -0.05, 0.2)
    return dict(T=T, uv=rng.uniform(0, 100, (K_SCENE, 2)).astype(np.float32),
                pts=rng.uniform(0.5, 3, (K_SCENE, 3)).astype(np.float32), ok=ok,
                signs=rng.choice(np.array([-1, 1], np.int8), (K_SCENE, 256)),
                match=match)


def _match_scene(rng) -> dict:
    """Map and query descriptors with ties across the block boundary: query
    0 equals map rows P/2 - 1 and P/2 (best tie: the first block's), query 1
    equals row P/2 + 44 with row 10 one bit off (second best in the other
    block), query 2 equals rows P/2 + 3 and P/2 + 9 (both in the second
    block); some map rows and queries invalid."""
    h = P_SCENE // 2
    s2 = rng.choice(np.array([-1, 1], np.int8), (P_SCENE, 256))
    s1 = rng.choice(np.array([-1, 1], np.int8), (K_SCENE, 256))
    v2 = rng.random(P_SCENE) > 0.1
    v1 = rng.random(K_SCENE) > 0.1
    s2[h - 1] = s2[h] = s1[0]
    s2[h + 44] = s1[1]
    s2[10] = s1[1]
    s2[10, 7] = -s2[10, 7]
    s2[h + 3] = s2[h + 9] = s1[2]
    v2[[h - 1, h, h + 44, 10, h + 3, h + 9]] = True
    v1[:3] = True
    return dict(s1=s1, v1=v1, s2=s2, v2=v2)


def _loop_scene() -> tuple[dict, dict, SLAMConfig]:
    """The loop scene of `tests/test_torch_cuda.py::_loop_map_on` on the
    CPU: candidate KF0, two far fillers, query KF3 revisiting KF0 with
    duplicates of its landmarks, 4 cm off its truth. -> (map, edges,
    config)."""
    K = 64
    cam = CameraIntrinsics(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
    cfg = SLAMConfig(camera=cam, orb=ORBConfig(n_features=K, n_levels=2),
                     keyframes=KeyframeConfig(max_keyframes=16, max_map_points=512),
                     ba=BAConfig(window=4, iters=4, global_ba_iters=8,
                                 global_ba_points=512, loop_min_interval=1))
    rng = np.random.default_rng(1)
    pts_w = np.stack([rng.uniform(-1.5, 1.5, K), rng.uniform(-1.0, 1.0, K),
                      rng.uniform(2.0, 4.0, K)], axis=1).astype(np.float32)
    signs = rng.choice(np.array([-1, 1], np.int8), size=(K, 256))

    def exp(xi):
        return tse3.exp(torch.tensor(xi, dtype=torch.float32)).numpy()

    def observe(T):
        T_cw = np.linalg.inv(T)
        pc = (pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]).astype(np.float32)
        u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
        v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
        ok = (pc[:, 2] > 0.3) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        return np.stack([u, v], 1).astype(np.float32), pc, ok

    m = tmap.empty_map(cfg.keyframes, K, "cpu")
    none = torch.full((K,), -1, dtype=torch.int32)
    T0 = np.eye(4, dtype=np.float32)
    Tq = T0 @ exp([0.02, 0, 0.01, 0, 0.008, 0])
    poses, views = [T0], [(T0, signs)]
    T = T0
    for _ in (1, 2):
        T = T @ exp([0.5, 0, 0, 0, 0.6, 0])
        poses.append(T)
        views.append((T, rng.choice(np.array([-1, 1], np.int8), size=(K, 256))))
    views.append((Tq, signs))
    poses.append(Tq @ exp([0.03, -0.02, 0.015, 0.01, -0.012, 0.006]))
    for i, ((T_obs, s), T_map) in enumerate(zip(views, poses)):
        uv, pc, ok = observe(T_obs)
        m = tmap.insert_keyframe(m, torch.tensor(T_map), float(i), torch.tensor(uv),
                                 torch.tensor(pc), torch.tensor(ok), torch.tensor(s), none)
    e = EdgeList.empty(64, "cpu")
    n = torch.zeros((), dtype=torch.int32)
    for i in range(3):
        e, n = e.add(n, i, i + 1, torch.tensor(np.linalg.inv(poses[i]) @ poses[i + 1]))
    edges = {**interop.edges_to_numpy(e), "n": n.numpy()}
    return interop.map_to_numpy(m), edges, cfg


def _frames() -> tuple[list, np.ndarray]:
    """The session's frames, rendered by the JAX package (the sequence of
    `tests/test_batch_session.py::test_map_block_sharded_session_mode`)."""
    from slam_rgbd_tpu.core import config as jc
    from slam_rgbd_tpu.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(N_FRAMES, session_config(jc).camera, step_t=0.015,
                            step_r=0.012)
    frames = []
    for i in range(N_FRAMES):
        ts, d, c = seq.frame(i)
        frames.append((float(ts), np.asarray(d), np.asarray(c)))
    return frames, seq.groundtruth()


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    h = P_SCENE // 2
    # free slots in both blocks, fewer than the spawns: spawns are dropped
    near = _map_scene(rng, [10, 100, h - 1, h, 300, P_SCENE - 1])
    # the first block full, room in the second only
    second = _map_scene(rng, list(range(h + 20, h + 120)))
    x = {}
    for tag, m in (("near", near), ("second", second)):
        x.update({f"{tag}/map/{k}": v for k, v in m.items()})
        x.update({f"{tag}/ins/{k}": v for k, v in _insert_inputs(rng, m).items()})
    x.update({f"match/{k}": v for k, v in _match_scene(rng).items()})
    loop_map, loop_edges, _ = _loop_scene()
    x.update({f"loop/map/{k}": v for k, v in loop_map.items()})
    x.update({f"loop/edges/{k}": v for k, v in loop_edges.items()})
    frames, gt = _frames()
    x["frames/ts"] = np.array([f[0] for f in frames])
    x["frames/depth"] = np.stack([f[1] for f in frames])
    x["frames/rgb"] = np.stack([f[2] for f in frames])
    x["frames/gt"] = gt
    return x


def _sub(x: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in x.items() if k.startswith(prefix)}


# ---- the functions both sides run -------------------------------------------
def _insert_and_cull(m, ins: dict, blk=None):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in ins.items()}
    m = tmap.insert_keyframe(m, t["T"], 3.0, t["uv"], t["pts"], t["ok"], t["signs"],
                             t["match"], blk=blk)
    culled, n_culled = tmap.cull_points(m, 3, min_obs=2, max_age_kf=2, blk=blk)
    return m, culled, n_culled


def _loop_inputs(x: dict):
    e = _sub(x, "loop/edges/")
    edges = interop.edges_from_numpy({k: v for k, v in e.items() if k != "n"}, "cpu")
    return edges, torch.from_numpy(e["n"])


def _result_arrays(r: tworker.BackendResult, gather) -> dict:
    return dict(kf_pose=r.kf_pose.numpy(), pt_xyz=gather(r.pt_xyz),
                pt_adjusted=gather(r.pt_adjusted), fuse_row=r.fuse_row.numpy(),
                pt_invalidate=gather(r.pt_invalidate), pt_nobs_delta=gather(r.pt_nobs_delta),
                scalars=np.array([r.ba_rmse, r.global_ba_rmse, r.n_fused, r.loop_closed,
                                  r.loop_edge[0], r.loop_edge[1]], np.float64),
                T_rel=r.loop_edge[2].numpy())


def tdist_ranks(group) -> list:
    return torch.distributed.get_process_group_ranks(group)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def _map_arrays(m, gather) -> dict:
    """Every field of a map, the point table gathered from its blocks."""
    return {f.name: (gather(getattr(m, f.name)) if f.name.startswith("pt_")
                     and getattr(m, f.name).dim() else getattr(m, f.name).numpy())
            for f in dataclasses.fields(m)}


def _drive(sess, x: dict, frames: range) -> None:
    for i in frames:
        sess.process_frame(float(x["frames/ts"][i]), x["frames/depth"][i],
                           x["frames/rgb"][i])


def _drive_synced(sess, x: dict) -> None:
    """Every frame, then `sync_backend()`: each keyframe's pass merges at
    the call after its insert (the forced schedule)."""
    for i in range(N_FRAMES):
        _drive(sess, x, range(i, i + 1))
        sess.sync_backend()


def _merge_log(sess) -> list:
    """(frame count, snapshot keyframe) of every result `sess` merges from
    now on."""
    merged = []
    apply = sess._apply_backend

    def logged(r):
        if r is not None:
            merged.append((sess.state.frames, r.snap_kf_idx))
        apply(r)

    sess._apply_backend = logged
    return merged


def _held_count(sess) -> dict:
    """Counts, from now on, the agreements at which this rank's pass had
    ended while another rank's had not (the merge was held back)."""
    held = {"calls": 0}
    end = sess._agreement_end

    def watched(work, flags, idle_here):
        ended, r = end(work, flags, idle_here)
        held["calls"] += idle_here and not ended
        return ended, r

    sess._agreement_end = watched
    return held


def _threaded_arrays(sess, gather, merged: list, worker=None) -> dict:
    """`_session_arrays` and the backend's schedule: loops, the frames
    their merges landed on, the worker's (`worker`: of a closed session)
    completed and skipped passes, the merges."""
    out = _session_arrays(sess, gather)
    st, worker = sess.state, worker or sess.worker
    out["backend"] = np.array([st.loops, worker.completed, worker.skipped])
    out["loop_merge_frames"] = np.array(st.loop_merge_frames, np.int64)
    out["merges"] = np.array(merged, np.int64).reshape(-1, 2)
    return out


def _session_arrays(sess, gather) -> dict:
    """What the comparison reads from a session: poses, keyframe poses, the
    whole map (gathered), its point cloud, the host counts."""
    sess.flush_pipeline()
    out = {f"map/{k}": v for k, v in _map_arrays(sess.map, gather).items()}
    out["poses"] = sess.poses()[1]
    out["kf_poses"] = sess.keyframe_poses()[1]
    out["cloud"] = map_to_pointcloud(sess.map, sess._blk)[0]
    st = sess.state
    out["counts"] = np.array([st.frames, st.keyframes, st.lost, st.relocalized, st.loops,
                              sess.map_point_count()])
    out["flags"] = np.array([s.is_keyframe for s in sess.stats])
    return out


# ---- what every rank runs -------------------------------------------------------
def _rank_checks(rank: int, world: int, tmp: str) -> None:
    x = dict(np.load(os.path.join(tmp, "inputs.npz")))
    mesh = tmesh.make_mesh(MeshConfig(data=1, model=world), "cpu")
    out = {}

    def gather(t):
        return tmesh.gather(t, mesh, "model").numpy()

    # (a) insert and cull on the blocks
    blk = tmesh.model_block(mesh, P_SCENE)
    for tag in ("near", "second"):
        m = interop.map_block_from_numpy(_sub(x, f"{tag}/map/"), blk, "cpu")
        out[f"{tag}/block_rows"] = np.array([m.pt_xyz.shape[0], m.kp_uv.shape[0]])
        ins, culled, n_culled = _insert_and_cull(m, _sub(x, f"{tag}/ins/"), blk)
        for name, mm in (("ins", ins), ("cull", culled)):
            out.update({f"{tag}/{name}/{k}": v for k, v in _map_arrays(mm, gather).items()})
        out[f"{tag}/n_culled"] = n_culled.numpy()

    # (b) the relocalization's match over the blocks
    ms = {k: torch.from_numpy(v) for k, v in _sub(x, "match/").items()}
    mt = tdist.sharded_map_match(blk, ms["s1"], ms["v1"], tmesh.shard(ms["s2"], mesh, "model"),
                                 tmesh.shard(ms["v2"], mesh, "model"))
    out["match/idx2"], out["match/dist"] = mt.idx2.numpy(), mt.distance.numpy()
    out["match/valid"] = mt.valid.numpy()

    # (c) a backend pass that closes a loop, fuses and runs the global BA
    _, _, loop_cfg = _loop_scene()
    lblk = tmesh.model_block(mesh, loop_cfg.keyframes.max_map_points)
    lm = interop.map_block_from_numpy(_sub(x, "loop/map/"), lblk, "cpu")
    edges, n_edges = _loop_inputs(x)
    r = tworker.backend_pass(lm, edges, n_edges, 3, loop_cfg, n_kf=4, blk=lblk)
    out.update({f"pass/{k}": v for k, v in _result_arrays(r, gather).items()})

    # (d) the session, its reset and checkpoints both ways
    sess = SLAMSession(SESSION, mesh=mesh, device="cpu")
    out["sess/block_rows"] = np.array([sess.map.pt_xyz.shape[0], sess.map.kp_uv.shape[0]])
    _drive(sess, x, range(N_CKPT))
    ck_sharded = os.path.join(tmp, "ckpt_sharded")
    tckpt.save(sess, ck_sharded)
    out.update({f"ckpt/saved/{k}": v for k, v in _map_arrays(sess.map, gather).items()})
    _drive(sess, x, range(N_CKPT, N_FRAMES))
    out.update({f"sess/{k}": v for k, v in _session_arrays(sess, gather).items()})
    sess.reset()
    out["sess/after_reset"] = np.array([sess.map.pt_xyz.shape[0], sess._blk is not None,
                                        sess.map_point_count(), len(sess.stats)])
    # sharded -> unsharded (each rank its own copy), unsharded -> sharded
    plain = tckpt.restore(SLAMSession(session_config(tc, model=1), device="cpu"),
                          ck_sharded)
    ck_plain = os.path.join(tmp, f"ckpt_plain{rank}")
    tckpt.save(plain, ck_plain)
    back = tckpt.restore(SLAMSession(SESSION, mesh=mesh, device="cpu"), ck_plain)
    out["ckpt/back_rows"] = np.array([back.map.pt_xyz.shape[0]])
    for name, s, g in (("plain", plain, _np), ("back", back, gather)):
        out.update({f"ckpt/{name}0/{k}": v for k, v in _map_arrays(s.map, g).items()})
        _drive(s, x, range(N_CKPT, N_FRAMES))
        out.update({f"ckpt/{name}/{k}": v for k, v in _session_arrays(s, g).items()})

    # (f) the threaded sharded session, forced: every pass merges at the
    # call after its insert
    forced = SLAMSession(SESSION, async_backend=True, mesh=mesh, device="cpu")
    try:
        wblk, host = forced.worker.blk, forced._host_group
        axis = mesh.get_group("model")
        out["groups"] = np.array([
            wblk.group is not axis, host is not axis, host is not wblk.group,
            forced._blk.group is axis,
            dataclasses.replace(wblk, group=axis) == forced._blk,
            tdist_ranks(wblk.group) == tdist_ranks(axis) == tdist_ranks(host),
            torch.distributed.get_backend(host) == "gloo"])
        merged = _merge_log(forced)
        _drive_synced(forced, x)
        out.update({f"forced/{k}": v for k, v in
                    _threaded_arrays(forced, gather, merged).items()})
        # reset keeps the groups: `new_group` runs once a session
        forced.reset()
        out["groups_kept"] = np.array([forced.worker.blk.group is wblk.group,
                                       forced._host_group is host])
    finally:
        forced.close()
    out["groups_left"] = np.array([forced._worker_blk is None, forced._host_group is None])

    # free-running behind the threaded pipeline runner, rank 1's passes
    # slowed: the ranks agree on every merge
    if rank == 1:
        fast = tworker.backend_pass

        def slow(*args, **kw):
            time.sleep(SLOW_S)
            res = fast(*args, **kw)
            time.sleep(SLOW_S)
            return res

        tworker.backend_pass = slow
    frames = [(float(x["frames/ts"][i]), x["frames/depth"][i], x["frames/rgb"][i])
              for i in range(N_FRAMES)]
    runner = PipelineRunner(SESSION, iter(frames), device="cpu", mesh=mesh)
    free, worker = runner.session, runner.session.worker
    merged, held = _merge_log(free), _held_count(free)
    t0 = time.monotonic()
    runner.run(threads=True)  # ends with close(): drained, the groups left
    out["free/seconds"] = np.array(time.monotonic() - t0)
    out.update({f"free/{k}": v for k, v in
                _threaded_arrays(free, gather, merged, worker).items()})
    out["held"] = np.array(held["calls"])
    out["dropped"] = np.array(runner.queue.dropped)

    # close() with a pass in flight: the bootstrap keyframe's job goes in at
    # frame 1 and sleeps on rank 1
    inflight = SLAMSession(SESSION, async_backend=True, mesh=mesh, device="cpu")
    try:
        _drive(inflight, x, range(2))
        out["close/busy"] = np.array(inflight.worker.busy())
        worker = inflight.worker
        t0 = time.monotonic()
    finally:
        inflight.close()
    out["close/seconds"] = np.array(time.monotonic() - t0)
    out["close/stopped"] = np.array([inflight.worker is None,
                                     not worker._thread.is_alive(), worker.completed])
    if rank == 1:
        tworker.backend_pass = fast
    # (g) a model axis of 1
    mesh21 = tmesh.make_mesh(MeshConfig(data=world, model=1), "cpu")
    one = SLAMSession(SESSION, mesh=mesh21, device="cpu")
    out["unsharded_rows"] = np.array([one._blk is None, one.map.pt_xyz.shape[0]])
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)


# ---- the references in this process, once a module ------------------------------
def _jax_reference(x: dict) -> dict:
    """(e) The JAX package's own sharded session on the same frames."""
    ref = {}
    from slam_rgbd_tpu.core import config as jc
    from slam_rgbd_tpu.parallel.mesh import make_mesh as jmake_mesh
    from slam_rgbd_tpu.runtime.session import SLAMSession as JSession
    import jax
    import jax.numpy as jnp

    # (e) the JAX package's own sharded session
    jcfg = session_config(jc)
    js = JSession(jcfg, mesh=jmake_mesh(jcfg.mesh, devices=jax.devices()[:RANKS]))
    for i in range(N_FRAMES):
        js.process_frame(float(x["frames/ts"][i]), jnp.asarray(x["frames/depth"][i]),
                         jnp.asarray(x["frames/rgb"][i]))
    ref["jax/poses"] = np.asarray(js.poses()[1])
    ref["jax/keyframes"] = js.state.keyframes
    ref["jax/devices"] = len(js.map.pt_xyz.sharding.device_set)
    return ref


def _port_references(x: dict) -> dict:
    """The unsharded port on the same inputs, inline and threaded."""
    ref = {}
    for tag in ("near", "second"):
        m = interop.map_from_numpy(_sub(x, f"{tag}/map/"), "cpu")
        ins, culled, n_culled = _insert_and_cull(m, _sub(x, f"{tag}/ins/"))
        for name, mm in (("ins", ins), ("cull", culled)):
            ref.update({f"{tag}/{name}/{k}": v for k, v in interop.map_to_numpy(mm).items()})
        ref[f"{tag}/n_culled"] = n_culled.numpy()
    ms = {k: torch.from_numpy(v) for k, v in _sub(x, "match/").items()}
    mt = tmatch.match(ms["s1"], ms["v1"], ms["s2"], ms["v2"])
    ref["match/idx2"], ref["match/dist"] = mt.idx2.numpy(), mt.distance.numpy()
    ref["match/valid"] = mt.valid.numpy()
    _, _, loop_cfg = _loop_scene()
    lm = interop.map_from_numpy(_sub(x, "loop/map/"), "cpu")
    edges, n_edges = _loop_inputs(x)
    r = tworker.backend_pass(lm, edges, n_edges, 3, loop_cfg, n_kf=4)
    ref.update({f"pass/{k}": v for k, v in _result_arrays(r, _np).items()})
    sess = SLAMSession(session_config(tc, model=1), device="cpu")
    _drive(sess, x, range(N_FRAMES))
    ref.update({f"sess/{k}": v for k, v in _session_arrays(sess, _np).items()})
    # (f) the threaded unsharded port under the forced schedule
    threaded = SLAMSession(session_config(tc, model=1), async_backend=True, device="cpu")
    try:
        merged = _merge_log(threaded)
        _drive_synced(threaded, x)
        ref.update({f"forced/{k}": v for k, v in
                    _threaded_arrays(threaded, _np, merged).items()})
    finally:
        threaded.close()
    return ref


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the inputs, the ranks' results, the references). The ranks run while
    this process computes the references, the port's on a thread beside the
    JAX session: a thread waits for the ranks."""
    x = _inputs()
    tmp = str(tmp_path_factory.mktemp("ranks"))
    np.savez(os.path.join(tmp, "inputs.npz"), **x)
    failed = []

    def ranks_run():
        try:
            tmesh.spawn(_rank_checks, RANKS, args=(tmp,), backend="gloo", device="cpu",
                        threads=1)
        except Exception as e:  # raised in this process below
            failed.append(e)

    waiter = threading.Thread(target=ranks_run, daemon=True)
    waiter.start()
    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            port = pool.submit(_port_references, x)
            ref = _jax_reference(x)
            ref.update(port.result(timeout=RANKS_DEADLINE_S))
    finally:
        waiter.join(timeout=RANKS_DEADLINE_S)
    assert not waiter.is_alive(), "the ranks did not finish"
    if failed:
        raise failed[0]
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(RANKS)]
    return x, ranks, ref


def _equal(got: dict, want: dict, prefix: str) -> None:
    keys = [k for k in want if k.startswith(prefix)]
    assert keys
    for k in keys:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("tag", ["near", "second"])
def test_block_insert_and_cull_equal_the_unsharded_map(both, tag):
    """(a) The gathered blocks after an insert and a cull equal the
    unsharded port's map, every field, on both ranks; the near-capacity map
    drops spawns, and its free slots lie in both blocks."""
    x, ranks, ref = both
    for got in ranks:
        assert got[f"{tag}/block_rows"].tolist() == [P_SCENE // RANKS, 8]
        _equal(got, ref, f"{tag}/")
    ins = ref[f"{tag}/ins/pt_valid"]
    was = x[f"{tag}/map/pt_valid"]
    spawned = np.flatnonzero(ins & ~was)
    if tag == "near":
        assert int(ref["near/ins/pt_dropped"]) > 0 and ins.all()
        assert (spawned < P_SCENE // 2).any() and (spawned >= P_SCENE // 2).any()
    else:
        assert (spawned >= P_SCENE // 2).all() and len(spawned) > 0
    assert int(ref[f"{tag}/n_culled"]) > 0


def test_sharded_map_match_equals_the_whole_map_match(both):
    """(b) Index, distance and validity exactly as `match` on the whole
    map, with the best tied across the block boundary (the lower index
    wins) and the second best in the other block."""
    _, ranks, ref = both
    h = P_SCENE // 2
    assert ref["match/idx2"][0] == h - 1 and ref["match/idx2"][2] == h + 3
    assert ref["match/idx2"][1] == h + 44 and ref["match/valid"][1]
    for got in ranks:
        _equal(got, ref, "match/")


def test_sharded_backend_pass_equals_the_unsharded_pass(both):
    """(c) BA, the closed loop, fusion and the global BA on the blocks:
    every output of the pass bit for bit."""
    _, ranks, ref = both
    assert ref["pass/scalars"][3] == 1 and ref["pass/scalars"][2] > 20
    for got in ranks:
        _equal(got, ref, "pass/")


def test_sharded_session_equals_the_unsharded_session(both):
    """(d) 12 frames at `max_decision_lag=1`: keyframes, every frame and
    keyframe pose, the gathered map and its point cloud bit for bit, on both
    ranks; at least 3 keyframes, so a BA pass ran; each rank holds half the
    points."""
    _, ranks, ref = both
    assert ref["sess/counts"][1] >= 3 and ref["sess/counts"][2] == 0
    for got in ranks:
        assert got["sess/block_rows"].tolist() == [2048 // RANKS, 16]
        _equal(got, ref, "sess/")


def test_reset_keeps_the_blocks(both):
    _, ranks, _ = both
    for got in ranks:
        assert got["sess/after_reset"].tolist() == [2048 // RANKS, 1, 0, 0]


def test_checkpoints_cross_between_sharded_and_unsharded(both):
    """(d) A checkpoint of the sharded session restores into an unsharded
    one with the whole map as it was, whose checkpoint restores into a
    sharded one with the same map in its blocks; both then track the last
    frames alike, bit for bit."""
    _, ranks, _ = both
    for got in ranks:
        assert got["ckpt/back_rows"].tolist() == [2048 // RANKS]
        for name in ("plain0", "back0"):
            for k in (k for k in got if k.startswith("ckpt/saved/")):
                assert np.array_equal(got[k], got[f"ckpt/{name}/" + k[11:]]), (name, k)
        keys = [k for k in got if k.startswith("ckpt/plain/")]
        assert keys
        for k in keys:
            assert np.array_equal(got[k], got["ckpt/back/" + k[len("ckpt/plain/"):]]), k


def test_sharded_session_meets_the_jax_sharded_session(both):
    """(e) The JAX package's sharded session on a (1, 2) mesh of virtual
    CPU devices, same frames: the same keyframes, poses within 1 cm, ATE
    under 2 cm (`tests/test_batch_session.py:87-121`)."""
    from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse

    x, ranks, ref = both
    assert ref["jax/devices"] == RANKS
    for got in ranks:
        assert got["sess/counts"][1] == ref["jax/keyframes"]
        np.testing.assert_allclose(got["sess/poses"], ref["jax/poses"], atol=1e-2)
        assert ate_rmse(got["sess/poses"], x["frames/gt"])[0] < 0.02


def test_threaded_sharded_session_equals_the_threaded_unsharded_session(both):
    """(f) `async_backend=True` on the blocks, `sync_backend()` after every
    frame, and the threaded unsharded session driven alike: poses, keyframe
    poses, counts, the gathered map, the merges (at the same calls, of the
    same keyframes) and the worker's counts bit for bit, on both ranks."""
    _, ranks, ref = both
    assert len(ref["forced/merges"]) >= 3 and ref["forced/backend"][1] >= 3
    for got in ranks:
        _equal(got, ref, "forced/")


def test_free_running_ranks_agree_with_a_slow_rank(both):
    """(f) Free-running behind the threaded runner, rank 1's passes slowed
    by 2 x SLOW_S: both ranks
    end with the same loops, loop-merge frames, merges, completed and
    skipped passes, poses and gathered map, within FREE_DEADLINE_S. Rank 0's
    pass ended first at some call, and the agreement held its merge back;
    every keyframe's job was merged or counted as skipped."""
    _, (r0, r1), _ = both
    keys = [k for k in r0 if k.startswith("free/") and k != "free/seconds"]
    assert keys
    for k in keys:
        assert np.array_equal(r0[k], r1[k]), k
    assert int(r0["held"]) >= 1
    assert len(r0["free/merges"]) >= 1 and r0["free/counts"][2] == 0
    assert len(r0["free/merges"]) + r0["free/backend"][2] == r0["free/counts"][1]
    for got in (r0, r1):
        assert float(got["free/seconds"]) < FREE_DEADLINE_S


def test_threaded_sharded_runner_drops_no_frame(both):
    """(f) `PipelineRunner(cfg, frames, mesh=).run(threads=True)`: the
    producer outruns the session, yet the queue drops no frame on either
    rank (each rank must see every frame), and every frame is processed."""
    _, ranks, _ = both
    for got in ranks:
        assert int(got["dropped"]) == 0 and got["free/counts"][0] == N_FRAMES
        assert got["free/flags"].shape == (N_FRAMES,)


def test_the_worker_has_groups_of_its_own(both):
    """(f) The worker's process group and the agreement's gloo group are
    neither the frontend's nor each other, over the same ranks; the
    worker's block is the session's but for its group; `reset()` keeps
    both groups and `close()` leaves them."""
    _, ranks, _ = both
    for got in ranks:
        assert got["groups"].all(), got["groups"]
        assert got["groups_kept"].all() and got["groups_left"].all()


def test_close_with_a_pass_in_flight_returns(both):
    """(f) `close()` right after a job went in (rank 1 sleeping in it)
    drains it and stops the thread on both ranks within CLOSE_DEADLINE_S."""
    _, ranks, _ = both
    for got in ranks:
        assert bool(got["close/busy"])
        assert float(got["close/seconds"]) < CLOSE_DEADLINE_S
        assert got["close/stopped"].tolist()[:2] == [1, 1] and got["close/stopped"][2] >= 1


def test_a_model_axis_of_one_is_the_unsharded_path(both):
    _, ranks, _ = both
    for got in ranks:
        assert got["unsharded_rows"].tolist() == [1, 2048]


def test_a_one_rank_mesh_is_the_unsharded_path(tmp_path):
    """(g) A 1 x 1 mesh over a one-rank group: the session is the unsharded
    one, bit for bit on three frames."""
    import torch.distributed as tdist_

    from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence

    frames = list(SyntheticSequence(3, CAM, step_t=0.015, step_r=0.012, device="cpu"))
    cfg = session_config(tc, model=1)
    tmesh.initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, "gloo", "cpu")
    try:
        mesh = tmesh.make_mesh(MeshConfig(data=1, model=1), "cpu")
        one, plain = SLAMSession(cfg, mesh=mesh, device="cpu"), SLAMSession(cfg, device="cpu")
        for s in (one, plain):
            for f in frames:
                s.process_frame(*f)
        assert one._blk is None and one.map.pt_xyz.shape[0] == 2048
        assert np.array_equal(one.poses()[1], plain.poses()[1])
    finally:
        tdist_.destroy_process_group()
