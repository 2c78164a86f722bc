"""Configuration tree: the port's own copy of `slam_rgbd_tpu/core/config.py`.

Every tunable lives in one frozen dataclass tree, serializable to and from
YAML, and consumed by every layer. The classes, fields and defaults are
those of the JAX package's tree (a test holds the two equal field by
field), so a YAML file written by one package loads in the other. The port
imports nothing of the JAX package, so it keeps this copy; it needs numpy
only.

All dataclasses are frozen and hashable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole camera model.

    Defaults mirror the Orbbec Astra config of the reference
    (`astra_orb_slam3_rgbd.yaml:9-23`): fx=fy=570.3, cx=320, cy=240,
    640x480 @ 30 fps, depth in millimetres (DepthMapFactor 1000,
    `astra_orb_slam3_rgbd.yaml:35`).
    """

    fx: float = 570.3
    fy: float = 570.3
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    # Divide raw integer depth by this to get metres (mm -> m).
    depth_scale: float = 1000.0
    # Depth validity range in metres. ThDepth/bf in the reference gate
    # "close" features (`astra_orb_slam3_rgbd.yaml:26-32`); we use explicit
    # metric bounds.
    min_depth: float = 0.2
    max_depth: float = 8.0

    def scaled(self, factor: float) -> "CameraIntrinsics":
        """Intrinsics for an image downscaled by `factor` (pyramid levels)."""
        return dataclasses.replace(
            self,
            fx=self.fx / factor,
            fy=self.fy / factor,
            cx=(self.cx + 0.5) / factor - 0.5,
            cy=(self.cy + 0.5) / factor - 0.5,
            width=int(self.width / factor),
            height=int(self.height / factor),
        )

    def matrix(self) -> np.ndarray:
        """3x3 K matrix (numpy; device code uses the scalars directly)."""
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )


@dataclass(frozen=True)
class ORBConfig:
    """Feature budget — mirrors `astra_orb_slam3_rgbd.yaml:41-52`."""

    n_features: int = 1024  # reference: 1000; padded to a lane-friendly 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0  # iniThFAST
    fast_min_threshold: float = 7.0  # minThFAST
    # Per-level candidate cap before the global top-k (fixed shapes).
    max_per_level: int = 2048
    patch_size: int = 31
    # Hamming matching thresholds (ORB-SLAM conventions).
    match_threshold: int = 64
    match_ratio: float = 0.9


@dataclass(frozen=True)
class ICPConfig:
    """Dense projective point-to-plane ICP (the odometry frontend)."""

    levels: int = 3  # coarse-to-fine pyramid depth
    # Gauss-Newton iterations per level, coarse -> fine.
    iters: tuple = (10, 7, 5)
    # Association search radius (pixels) per level, coarse -> fine: the
    # association is a bounded-displacement window; displacement beyond
    # the radius is treated as association failure. The window
    # only has to cover flow VARIATION (the dominant flow is removed by a
    # mean shift), but close-range structure makes that variation large:
    # an object at 0.5 m moves ~19 px/frame at 640x480 while the far
    # scene moves ~3 px, so a 2 px finest window collapsed association
    # (inliers 0.02-0.25, the round-3 bench's 14-frame tracking cascade)
    # whenever clutter came near. (8, 6, 4) holds min inliers ~0.65
    # through that section (A/B on frames 138-175 of the sweep bench:
    # (8,6,3) still loses 3 frames, (8,6,4) none); tightening below this
    # is NOT tunable headroom.
    window_px: tuple = (8, 6, 4)
    # Huber robust kernel width (metres) on the point-to-plane residual.
    huber_delta: float = 0.05
    # Association gates.
    max_dist: float = 0.25  # metres between associated points
    max_normal_angle_deg: float = 30.0
    # Levenberg damping added to JtJ diagonal for conditioning (float32).
    damping: float = 1e-6
    # Early-out threshold on update norm (the iteration count is fixed;
    # this only gates *applying* the update).
    min_update: float = 1e-7
    # Dense photometric (DVO-style) term: weight of the intensity residual
    # block relative to the geometric block, and its Huber width (intensity
    # in [0,1]). Geometry-only ICP cannot observe translation parallel to a
    # flat wall; texture can. 0 disables the term.
    rgb_weight: float = 20.0
    rgb_huber: float = 0.08
    # GN-reduction backend of the JAX package ("auto", "xla", "pallas"). The
    # port keeps the field for the shared YAML and ignores it: its
    # `ops.gn_reduce` dispatches on the tensor's device.
    backend: str = "auto"
    # Multi-hypothesis initialization: the coarsest level is solved from
    # each of {motion prior, identity, reversed prior} and the best (most
    # inliers) seeds the finer levels. The constant-velocity prior is
    # exactly wrong when motion reverses (a sweep turnaround) and
    # poisonous after a bad solve; the identity hypothesis is always
    # within one frame's motion of the truth, so the cascade where one
    # diverged solve corrupts every following prior cannot start. 0 or 1
    # disables (prior only); 2 = prior+identity; 3 adds the reversed prior.
    hypotheses: int = 3
    # Per-frame motion sanity clamp (metres): a solve whose translation
    # step exceeds this is physically impossible at sensor rate and is
    # rejected — the pose holds (identity step) and the motion prior
    # resets, instead of feeding a diverged estimate into the next frame.
    max_step_m: float = 0.25
    # Fault injection (bench/test only): a 6-twist composed onto every
    # frame's tracked relative pose — a miscalibrated-odometry model that
    # makes the trajectory accumulate real drift so a revisit exercises
    # the FULL loop pipeline (association failure -> candidate -> verify
    # -> consistency -> pose graph) end to end on the timed path. Empty
    # tuple disables (production default).
    drift_xi: tuple = ()


@dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe selection + fixed-capacity map (SURVEY.md §7 layer 5)."""

    max_keyframes: int = 256
    max_map_points: int = 16384
    # Insert a keyframe when translation/rotation to last KF exceeds these.
    kf_min_trans: float = 0.10  # metres
    kf_min_rot_deg: float = 10.0
    # Or when tracked-inlier ratio drops below this.
    kf_min_inlier_ratio: float = 0.35
    # Co-visibility: two KFs are connected if they share >= this many points.
    covis_min_shared: int = 15
    # Map maintenance (ORB-SLAM-style recent-point culling; the upkeep
    # behind the reference's map-point query surface, `SLAM.cpp:204-218`):
    # points observed < cull_min_obs times and not re-observed within
    # cull_max_age_kf keyframes are culled; their slots recycle.
    cull_min_obs: int = 2
    cull_max_age_kf: int = 3
    # Duplicate-point merge gate: a keypoint within merge_radius metres of
    # an existing point with near-identical descriptor reuses its id
    # instead of spawning a duplicate.
    merge_radius: float = 0.05
    # Host-side anti-duplicate guard for pipelined keyframe decisions:
    # decisions resolve with a few frames of lag, during which several
    # frames may all have flagged "insert" against the same stale
    # reference keyframe — enforce this many frames between inserts.
    kf_min_gap_frames: int = 2


@dataclass(frozen=True)
class BAConfig:
    """Sliding-window local BA + pose graph (SURVEY.md §7 layer 6)."""

    window: int = 8  # keyframes in the local window
    max_points_per_window: int = 2048
    iters: int = 5
    # LM iterations per device dispatch for DIRECT `windowed_local_ba`
    # calls (0 = whole solve as one program; k = ceil(iters/k) separate
    # dispatches with LM state carried — identical math). The backend
    # worker itself always runs the fused single-dispatch
    # `_backend_program` (BA + loop + pose graph in one program, one
    # stats fetch).
    dispatch_iters: int = 0
    huber_delta_px: float = 2.0
    # Observations with residual above this are hard-dropped each iteration
    # (outlier gate; Huber alone still lets aliased matches bias the solve).
    reject_px: float = 6.0
    damping: float = 1e-4
    # Pose graph
    pg_iters: int = 10
    pg_damping: float = 1e-6
    # Loop closure
    loop_min_score: float = 0.20
    loop_min_interval: int = 20  # keyframes between loop candidates
    # Consistency gate: a verified loop edge is accepted only if its
    # discrepancy against the CURRENT pose estimates (the would-be edge
    # residual) is within plausible accumulated drift. Geometric
    # verification alone can pass aliased matches in self-similar scenes —
    # one such accepted edge (5.5 m in a 2 m room) dragged the live pose
    # through the merge correction and cascaded into tracking divergence.
    loop_max_residual_t: float = 1.0  # metres
    loop_max_residual_deg: float = 45.0
    # Keyframes to wait after an accepted loop before attempting another:
    # every backend pass during a revisit otherwise re-closes the same
    # region, stacking near-duplicate weight-5 edges on the pose graph.
    loop_cooldown_kf: int = 8
    # Global map refinement after an accepted loop (the ORB-SLAM3
    # GlobalBundleAdjustment semantics delegated at `SLAM.cpp:54`): a
    # full-map BA — every valid keyframe free except the gauge anchor —
    # over the pose-graph-corrected state, run as its own device program
    # on the backend worker. 0 disables.
    global_ba_iters: int = 6
    # Point budget of the global solve's compaction (the global window
    # observes the whole map; the least-observed overflow is excluded,
    # same policy as the local window).
    global_ba_points: int = 8192
    # Keyframe compaction of the global solve: the newest (up to) this
    # many VALID keyframes are solved; older ones stay fixed (extra gauge
    # anchoring). Solving over the raw slot capacity processed the dense
    # (max_keyframes, K) observation grid and a (6*max_keyframes)^2
    # normal system even when ~5% of slots were live, all of it on the
    # closing frame's critical path (inline) or the device (async).
    global_ba_window: int = 64
    # Trust region for accepting the global solve: reject it (keep the
    # pose-graph state) if any keyframe moved further than this from its
    # pose-graph-corrected init. A reprojection-only global BA is well
    # conditioned only when landmarks are co-observed by many keyframes;
    # on a weakly-coupled chain (sparse revisits) its near-null gauge
    # directions let whole segments wander coherently — measured: it
    # relocated early keyframes ~22 cm and cancelled the pose graph's
    # ATE gain. Refinement should refine, not relocate.
    global_ba_max_move: float = 0.15


@dataclass(frozen=True)
class StreamConfig:
    """Host-side frame stream: backpressure + pacing.

    Semantics from the reference: bounded ingest queue that warns above 10
    and drops to 5 (`Youth.Source/AlgorithmModule/SLAM.cpp:162-168`), 30 fps
    pacing (`sensorModule.c:242-243`), sensor retry/reinit counters
    (`sensorModule.c:25,50-67`).
    """

    queue_capacity: int = 10
    queue_drop_to: int = 5
    prefetch: int = 4
    max_consecutive_errors: int = 5
    init_retries: int = 3
    paced_fps: float = 0.0  # 0 = unpaced (as fast as possible)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the parallel layer (SURVEY.md §7 layer 7)."""

    # Mesh axis sizes; 0 = infer from available devices.
    data: int = 0  # concurrent sequences (batch mode)
    model: int = 0  # sharded BA / matching / map blocks
    # Preferred axis names.
    data_axis: str = "data"
    model_axis: str = "model"


@dataclass(frozen=True)
class RuntimeConfig:
    """Session lifecycle knobs — `main.c` semantics (SURVEY.md §2 C1)."""

    watchdog_period_s: float = 0.1  # main.c:310-342 polls at 100 ms
    shutdown_timeout_s: float = 10.0  # force-exit timer, main.c:162-187
    health_check_grace_s: float = 1.0
    checkpoint_every_kf: int = 16
    metrics_every_frames: int = 30
    # Decision-pipeline depth of the JAX package's session: a frame's
    # control scalars resolve once their copy has landed, or when this many
    # frames are in flight (a bound for a high-latency link). Kept for the
    # configuration format; the port's session, whose devices are local,
    # resolves every frame's decisions at the next call.
    max_decision_lag: int = 12


@dataclass(frozen=True)
class SLAMConfig:
    camera: CameraIntrinsics = field(default_factory=CameraIntrinsics)
    orb: ORBConfig = field(default_factory=ORBConfig)
    icp: ICPConfig = field(default_factory=ICPConfig)
    keyframes: KeyframeConfig = field(default_factory=KeyframeConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    # ------------------------------------------------------------------ YAML
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SLAMConfig":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in fields:
                        raise KeyError(f"unknown config key {tp.__name__}.{k}")
                    ftp = fields[k].type
                    # resolve string annotations to the actual class
                    ftp = _TYPE_MAP.get(ftp, ftp) if isinstance(ftp, str) else ftp
                    kwargs[k] = build(ftp, v)
                return tp(**kwargs)
            if isinstance(val, list):
                return tuple(val)
            return val

        return build(cls, d)

    def to_yaml(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    @classmethod
    def from_yaml(cls, path: str) -> "SLAMConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

    def replace(self, **kw: Any) -> "SLAMConfig":
        return dataclasses.replace(self, **kw)


_TYPE_MAP = {
    "CameraIntrinsics": CameraIntrinsics,
    "ORBConfig": ORBConfig,
    "ICPConfig": ICPConfig,
    "KeyframeConfig": KeyframeConfig,
    "BAConfig": BAConfig,
    "StreamConfig": StreamConfig,
    "MeshConfig": MeshConfig,
    "RuntimeConfig": RuntimeConfig,
}


def astra_default_config() -> SLAMConfig:
    """The Astra camera profile of the reference, as our defaults."""
    return SLAMConfig()


def tum_fr1_config() -> SLAMConfig:
    """TUM RGB-D freiburg1 intrinsics (fr1/xyz, fr1/desk sequences)."""
    cam = CameraIntrinsics(
        fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480,
        fps=30.0, depth_scale=5000.0,
    )
    return SLAMConfig(camera=cam)


def tum_fr2_config() -> SLAMConfig:
    """TUM RGB-D freiburg2 intrinsics (fr2/desk)."""
    cam = CameraIntrinsics(
        fx=520.9, fy=521.0, cx=325.1, cy=249.7, width=640, height=480,
        fps=30.0, depth_scale=5000.0,
    )
    return SLAMConfig(camera=cam)
