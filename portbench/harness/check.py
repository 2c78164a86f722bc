"""The output check: what the timed window produced, against the plain
reference in `portbench/reference/`, after the window has closed.

Four comparisons, each over a sample drawn from the seed or fixed slots,
each one number with a limit of its own (`limits/<config>.json`, or the
cell's own file for a number its configuration's lacks); a mix's `checks`
name the numbers its cells have to pass:

  * `track_gap_mm`: tracked frames. The reference tracks frame t against
    frame t - 1 from the motion prior the program had (its own relative
    pose of frame t - 1, the identity at a recording's first tracked frame,
    which checks the start without any state of the program), and the gap
    between its relative pose and the program's is taken as
    |dt| + 1 m x |drotation| in millimetres. The program's relative poses
    come from its trajectory ring: the pose of each frame against the
    keyframe it was tracked from, which a backend merge does not change.
  * `kf_mismatch` and `kf_point_gap_mm`: keyframe inserts. The reference
    computes the keyframe's features from the raw frame, associates them
    with the map's points as they were before the insert (the program's
    state, kept by reference), and spawns the new points; `kf_mismatch`
    counts the keypoint slots whose pixel, validity, descriptor or map-point
    id differ, `kf_point_gap_mm` is the largest gap of a keypoint's
    camera-frame point or of a spawned point's world position.
  * `ba_gap_mm`: local BA. The reference solves the backend job's window
    from the job's own snapshot; the gap is the largest over the window's
    keyframe poses and the solved points, and a point that one side solved
    and the other did not counts as a gap of 1 m.
  * `loop_gap_mm`: backend passes that closed a loop (the single session's
    first two a recording that merged, kept only where the mix names this
    number). The reference runs the closing pass from the job's own
    snapshot and edge list with the program's verified loop edge
    (`reference/loop.py`): local BA, the pose graph, the points riding with
    their anchors, landmark fusion and the bounded global BA. The gap is
    the largest over the snapshot's valid keyframe poses and the points
    both sides adjusted; a point that one side adjusted and the other did
    not, a fusion output (the query's row, the ghosts, the observation
    counts) that differs, or a global BA kept by one side only counts as a
    gap of 1 m. The fleet's loop closing is not compared.

With `control=True` the reference in TF32 (`precision.tf32_products`) takes
the program's place: the check's control, which has to fail. The
benchmark's own runs never set it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import ba as ref_ba
from portbench.reference import features as ref_feat
from portbench.reference import loop as ref_loop
from portbench.reference import mapping as ref_map
from portbench.reference import tracker as ref_track
from portbench.reference.camera import Camera
from portbench.reference.precision import no_tf32, tf32_products

MISSING_GAP_MM = 1000.0  # a solved point that the other side left alone


@dataclass
class Sample:
    """What the check looks at: the keyframe slots whose inserts and backend
    jobs are kept, and in a batch the two streams they are kept for, fixed
    at every seed (every kept map holds card memory that the program would
    otherwise reuse, inside the window: the same slots keep that cost the
    same); the seed's room order puts them in other rooms. The tracked
    frames are drawn from the seed after the window, from `rng`."""

    keyframes: set
    ba_jobs: set
    streams: set
    rng: np.random.Generator


KEPT_KEYFRAMES = frozenset({0, 1, 8, 17})
KEPT_BA_JOBS = frozenset({2, 5, 8, 11, 14, 17})


def draw_sample(seed: int, streams: int = 1) -> Sample:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC4EC]))
    kept = {0} if streams == 1 else {0, streams // 2 + 1}
    return Sample(keyframes=set(KEPT_KEYFRAMES), ba_jobs=set(KEPT_BA_JOBS), streams=kept,
                  rng=rng)


def pose_gap_mm(A: np.ndarray, B: np.ndarray) -> float:
    """|t_A - t_B| + 1 m x the angle between R_A and R_B, in millimetres.
    The angle is 2 asin(|R_A - R_B|_F / sqrt(8)), which holds its precision
    near zero (the trace's arccos does not)."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    dt = np.linalg.norm(A[:3, 3] - B[:3, 3])
    s = min(np.linalg.norm(A[:3, :3] - B[:3, :3]) / math.sqrt(8.0), 1.0)
    return float(1e3 * (dt + 2.0 * math.asin(s)))


def _inv(T: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def single_deltas(ring: dict) -> tuple[np.ndarray, np.ndarray]:
    """The single session's relative pose of every frame and the motion
    prior it was tracked from, from its trajectory ring: Q_i, frame i's pose
    against its reference keyframe, is unchanged by a merge (both move by
    the same correction), and a frame whose reference keyframe is new was
    tracked from that keyframe's own pose. -> (delta (n, 4, 4), prior)."""
    T = ring["T"].astype(np.float64)
    kfT = ring["kfT"].astype(np.float64)
    kf = ring["kf_idx"]
    n = len(T)
    Q = np.stack([_inv(kfT[i]) @ T[i] for i in range(n)])
    delta = np.tile(np.eye(4), (n, 1, 1))
    for i in range(1, n):
        base = Q[i - 1] if kf[i] == kf[i - 1] else np.eye(4)
        delta[i] = _inv(base) @ Q[i]
    prior = np.tile(np.eye(4), (n, 1, 1))
    prior[2:] = delta[1:-1]
    return delta, prior


def batch_deltas(T: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The batch session logs each stream's pose after its step's
    corrections, and the next step tracks from it. -> (delta, prior), each
    (streams, n, 4, 4)."""
    T = T.astype(np.float64)
    s, n = T.shape[:2]
    delta = np.tile(np.eye(4), (s, n, 1, 1))
    for b in range(s):
        for i in range(1, n):
            delta[b, i] = _inv(T[b, i - 1]) @ T[b, i]
    prior = np.tile(np.eye(4), (s, n, 1, 1))
    prior[:, 2:] = delta[:, 1:-1]
    return delta, prior


def loop_gap_mm(prog: dict, ref: dict, kf_valid, n_kf: int) -> float:
    """The largest gap between two results of a closing pass, each a dict
    as `reference.loop.closing_pass` returns it."""
    valid = np.flatnonzero(kf_valid[:n_kf].cpu().numpy())
    A, B = prog["kf_pose"].cpu().numpy(), ref["kf_pose"].cpu().numpy()
    g = max((pose_gap_mm(A[i], B[i]) for i in valid), default=0.0)
    a, b = prog["pt_adjusted"], ref["pt_adjusted"]
    if bool((a != b).any()):
        g = max(g, MISSING_GAP_MM)
    both = a & b
    if both.any():
        g = max(g, 1e3 * float(torch.linalg.norm(prog["pt_xyz"][both] - ref["pt_xyz"][both],
                                                 dim=1).max()))
    fusion = all(torch.equal(prog[k].long(), ref[k].long())
                 for k in ("fuse_row", "pt_invalidate", "pt_nobs_delta"))
    if not fusion or prog["n_fused"] != ref["n_fused"]:
        g = max(g, MISSING_GAP_MM)
    if prog["global_applied"] != ref["global_applied"]:
        g = max(g, MISSING_GAP_MM)
    return g


class Checker:
    def __init__(self, conf: dict, depth: np.ndarray, rgb: np.ndarray, device,
                 n_tracked: int):
        self.slam = conf["slam"]
        self.cam = Camera.from_dict(self.slam["camera"])
        self.icp = ref_track.icp_params(self.slam["icp"])
        self.depth = depth
        self.rgb = rgb
        self.device = device
        self.n_tracked = n_tracked  # tracked frames a recording, over its streams
        no_tf32()

    def _frame(self, f: int):
        return (torch.from_numpy(self.depth[f].astype(np.int32)).to(self.device),
                torch.from_numpy(self.rgb[f]).to(self.device))

    def _ref(self, fn, control: bool):
        if not control:
            return fn()
        with tf32_products():
            return fn()

    # ------------------------------------------------------------ tracking
    def tracking(self, rec, sample: Sample, control: bool = False) -> tuple[float, int]:
        """(largest gap in mm, frames compared)."""
        gaps = []
        for r in rec.recordings:
            if rec.kind == "single":
                delta, prior = single_deltas(r.ring)
                delta, prior, ok = delta[None], prior[None], r.ring["ok"][None]
            else:
                delta, prior = batch_deltas(r.ring["T"])
                ok = ~(r.ring["corrected"] | r.ring["lost"]).T  # (streams, n)
            streams, n = delta.shape[:2]
            if n < 2:
                continue
            # every stream's first tracked frame, and `n_tracked` more
            # (stream, frame) pairs of the recording
            pairs = [(b, 1) for b in range(streams)]
            if n > 2:
                flat = sample.rng.choice(streams * (n - 2), min(self.n_tracked, streams * (n - 2)),
                                         replace=False)
                pairs += sorted((int(x) % streams, 2 + int(x) // streams) for x in flat)
            for b, i in pairs:
                # a lost or relocalized frame, or a step whose pose a
                # backend pass corrected after tracking, has no plain
                # relative pose in the log
                if not (ok[b, i] and ok[b, i - 1]):
                    continue
                f_prev, f = int(r.frames[i - 1, b]), int(r.frames[i, b])
                p = torch.tensor(prior[b, i], dtype=torch.float32, device=self.device)
                ref = ref_track.track(self._frame(f_prev), self._frame(f), p, self.cam,
                                      self.icp).cpu().numpy()
                prog = delta[b, i]
                if control:
                    prog = self._ref(lambda: ref_track.track(
                        self._frame(f_prev), self._frame(f), p, self.cam, self.icp),
                        True).cpu().numpy()
                gaps.append(pose_gap_mm(prog, ref))
        self.track_median = float(np.median(gaps)) if gaps else None
        return (max(gaps) if gaps else None), len(gaps)

    # ----------------------------------------------------------- keyframes
    def keyframes(self, rec, control: bool = False) -> tuple[int | None, float | None, int]:
        """(mismatched keypoint slots, largest point gap in mm, keyframes
        compared)."""
        orb, kcfg = self.slam["orb"], self.slam["keyframes"]
        mism, gaps, n = 0, [], 0
        for r in rec.recordings:
            for cap in r.kf_captures:
                k = cap["k"]
                stream = cap.get("stream", 0)
                call = int(round(cap["ts"] * self.cam.fps))
                f = int(r.frames[call, stream])
                post, pre = cap["post"], cap["pre"]
                T_wc = cap["T_pose"] if "T_pose" in cap else post.kf_pose[k]

                def run():
                    uv, signs, pts, ok = ref_feat.keyframe_features(*self._frame(f), orb,
                                                                    self.cam)
                    if k > 0:
                        match = ref_map.associate(
                            pre.pt_xyz, pre.pt_signs, pre.pt_valid, uv, signs, pts, ok,
                            T_wc, self.cam, float(orb["match_threshold"]),
                            kcfg["merge_radius"])
                    else:
                        match = torch.full((uv.shape[0],), -1, dtype=torch.int64,
                                           device=uv.device)
                    pid = ref_map.insert_ids(match, ok, pre.pt_valid)
                    spawned = ok & (match < 0) & (pid >= 0)
                    return uv, signs, pts, ok, pid, spawned, ref_map.world_points(pts, T_wc)

                uv, signs, pts, ok, pid, spawned, world = run()
                if control:
                    c_uv, c_signs, c_pts, c_ok, c_pid, _, c_world = self._ref(run, True)
                else:
                    c_uv, c_signs, c_pts, c_ok = (post.kp_uv[k], post.kp_signs[k],
                                                  post.kp_pts[k], post.kp_ok[k])
                    c_pid = post.point_id[k].to(torch.int64)
                    c_world = post.pt_xyz[c_pid.clamp_min(0)]
                differ = ((c_uv != uv).any(dim=1) | (c_ok != ok) | (c_signs != signs).any(dim=1)
                          | (c_pid != pid))
                mism += int(differ.sum())
                pt_gap = float(torch.linalg.norm(c_pts - pts, dim=1).max())
                same = spawned & (c_pid == pid)
                sp_gap = 0.0
                if same.any() and not cap.get("moved_by_ba"):
                    sp_gap = float(torch.linalg.norm(c_world[same] - world[same], dim=1).max())
                gaps.append(1e3 * max(pt_gap, sp_gap))
                n += 1
        return (mism if n else None), (max(gaps) if gaps else None), n

    # ------------------------------------------------------------------ BA
    def ba(self, rec, control: bool = False) -> tuple[float | None, int]:
        """(largest gap in mm, backend jobs compared)."""
        gaps = []
        for r in rec.recordings:
            n_kf_rec = r.ring.get("n_kf", 1 << 30)
            for key, cap in sorted(r.ba_captures.items()):
                # the single session's last keyframe's pass can be the
                # drain's final pass, which runs on the live map and not on
                # the job's snapshot
                k = key[1] if isinstance(key, tuple) else key
                if "result" not in cap or cap["n_kf"] < 3 or k >= n_kf_rec - 1:
                    continue
                kf_pose, pt_xyz, pt_solved, loop = cap["result"]
                if loop:
                    continue

                def run():
                    kf_pose0, pt_xyz0, kp_uv, kp_pts, point_id, kp_ok = cap["input"]
                    return ref_ba.window_ba(kf_pose0, cap["n_kf"], pt_xyz0, kp_uv, kp_pts,
                                            point_id, kp_ok, self.cam, self.slam["ba"])

                poses, pts, solved = run()
                if control:
                    kf_pose, pt_xyz, pt_solved = self._ref(run, True)
                w = 2 * self.slam["ba"]["window"]
                window = range(max(cap["n_kf"] - w, 0), cap["n_kf"])
                g = max(pose_gap_mm(kf_pose[i].cpu().numpy(), poses[i].cpu().numpy())
                        for i in window)
                if pt_solved is None:  # the batch merges the solved valid points
                    both = solved & cap["valid"]
                else:
                    both = solved & pt_solved
                    if bool((solved != pt_solved).any()):
                        g = max(g, MISSING_GAP_MM)
                if both.any():
                    g = max(g, 1e3 * float(torch.linalg.norm(pt_xyz[both] - pts[both],
                                                             dim=1).max()))
                gaps.append(g)
        return (max(gaps) if gaps else None), len(gaps)

    # --------------------------------------------------------------- loops
    def loops(self, rec, control: bool = False) -> tuple[float | None, int]:
        """(largest gap in mm, closing passes compared)."""
        gaps = []
        for r in rec.recordings:
            for cap in r.loop_captures:
                res = cap["result"]
                cand, _, T_rel = res["loop_edge"]

                def run():
                    return ref_loop.closing_pass(
                        cap["snapshot"], cap["edges"], cap["n_edges"], cap["kf_idx"],
                        cap["n_kf"], cand, T_rel, self.cam, self.slam["ba"])

                ref = run()
                if control:
                    prog = self._ref(run, True)
                else:
                    prog = dict(res, global_applied=res["global_ba_rmse"] >= 0)
                gaps.append(loop_gap_mm(prog, ref, cap["snapshot"].kf_valid, cap["n_kf"]))
        return (max(gaps) if gaps else None), len(gaps)

    # --------------------------------------------------------------- all
    def numbers(self, rec, sample: Sample, control: bool = False) -> dict:
        """{number: value or None}, and how many items each compared."""
        track, n_track = self.tracking(rec, sample, control)
        mism, kgap, n_kf = self.keyframes(rec, control)
        bgap, n_ba = self.ba(rec, control)
        lgap, n_loops = self.loops(rec, control)
        return {"track_gap_mm": track, "kf_mismatch": mism, "kf_point_gap_mm": kgap,
                "ba_gap_mm": bgap, "loop_gap_mm": lgap,
                "_counts": {"tracked": n_track, "keyframes": n_kf, "ba_jobs": n_ba,
                            "loops": n_loops, "track_gap_median_mm": self.track_median}}


def verdict(numbers: dict, limits: dict, required: list) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]): every required number read and
    within its limit."""
    rows, ok = [], True
    for name in required:
        v, lim = numbers.get(name), limits[name]
        rows.append((name, v, lim))
        ok = ok and v is not None and v <= lim
    return ok, rows
