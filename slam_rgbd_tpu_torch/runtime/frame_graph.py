"""The steady-state frame and the keyframe's feature stage as CUDA graphs:
each captured once, replayed a call.

Counterpart of the reference's `jax.jit(_steady_step)`: one dispatch a
frame, with nothing on the host between its operations. Eager, the same
frame is some 800 device operations (the pyramid, the coarse-to-fine track
with its 22 GN launches, the flow shifts, the control summary, the ring
writes), each queued by the host. `FrameGraph.run` records them once and
replays the recording; the replay runs the same kernels in the same order
on the same addresses, so it gives the eager step's bits.

`FeatureGraph.run` does the same for the feature stage of a keyframe insert
and of a relocalization (`runtime.session._features`: FAST, Harris, NMS and
a stable sort at each pyramid level, then the descriptors and the keypoint
depth): some 3,300 operations, with fixed shapes and no read-back, become
one replay.

A graph reads and writes fixed addresses. What the step reads and writes
therefore lives in static tensors that are updated in place and never
rebound, and `run` captures again whenever one of them is not the tensor
the graph was captured with. The hazards, each handled here or by the
session (`runtime.session.SLAMSession`):

  1. The ring slot. `traj_i` is a device int64 scalar filled before each
     replay; the ring write is an `index_copy_` at it. A grown ring (or a
     restored one) is another tensor: the graph is captured again.
  2. The pyramid. The graph builds the new pyramid in its own memory and
     ends by copying it into the static previous-frame pyramid, which is
     what the session's `prev_pyr` names.
  3. The pose state. `T_world`, `motion` and `last_kf_T` are inputs the
     graph reads (and, for the first two, writes). The session writes them
     with `copy_` only, so work queued before a write still sees the old
     value, as the eager step does.
  4. What a caller keeps. The frame is uploaded into a tensor of its own
     and copied into the graph's input buffers before the replay; a
     pending frame's pose is cloned after the replay, and the feature
     graph returns clones of every output (the keypoints, descriptors,
     points and mask an insert writes into the map or a relocalization
     matches). A later replay overwrites none of them.
  5. The summary. The graph's (4,) summary is copied to the host after the
     replay and before the next one, in stream order.
  6. The kernels' workspaces and counters. K1's scratch and ticket counters
     (`ops.workspace`) are keyed by the stream a launch is queued on. The
     eager run before a capture runs on the capture stream, so the
     workspace the graph bakes in exists before the capture (a capture
     would otherwise record its allocation and zeroing), and its counters
     are zero at every replay, since every launch leaves them zero. The
     same run fills the feature stage's cached constants (the pyramid's
     resize weights, the BRIEF pattern), so the capture records no upload
     from the host. The launch counters of the frame's wrappers (K1, K1b)
     are host Python: what the capture added is taken back, and every
     replay adds it again, so a count still says how many times the kernel
     ran. Two graphs whose capture streams
     share a handle share one workspace; replays queued on one stream run
     in turn, so they never use it at once.
  7. Other threads. The capture uses `capture_error_mode="thread_local"`,
     so the backend worker's thread may run its pass on its own stream
     meanwhile. Each graph and its memory pool belong to its `FrameGraph`
     or `FeatureGraph`, which the session keeps across `reset()`.
  8. TF32 stays as the session set it (off), the same in the capture as in
     the eager step.
  9. Garbage. Destroying a CUDA graph while a stream captures invalidates
     the capture, and a garbage collection inside it could free a finished
     session held in a reference cycle, graph and all. So the capture runs
     with the collector off.

A capture that fails raises; nothing falls back to the eager step. The
eager functions stay the plain version: the session runs them on the CPU,
and on the card when asked (`SLAMSession(..., cuda_graph=False)`).
"""

from __future__ import annotations

import gc

import torch

from slam_rgbd_tpu_torch.ops import gn_reduce as gn_ops


def _counters() -> tuple:
    """The wrappers of the kernels the frame launches (K1, K1b), whose
    `launches` count their launches. The backend worker's thread never
    launches them; its kernels (`ops.hamming`) count under a lock of their
    own and are not touched here."""
    return (gn_ops.gn_reduce, gn_ops.gn_reduce_batched)


def _leaves(pyr) -> list:
    return [lvl[k] for lvl in pyr for k in sorted(lvl)]


def _tensors(out) -> list:
    """The tensors of a tensor or a (named) tuple of them, nested."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out for t in _tensors(x)]


def _cloned(out):
    """`out` with every tensor cloned, its (named) tuples rebuilt."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    parts = [_cloned(x) for x in out]
    return type(out)(*parts) if hasattr(out, "_fields") else type(out)(parts)


class _Graph:
    """A function of static input buffers, captured once as a CUDA graph on
    a stream of its own, in its own memory pool, and replayed: what
    `FrameGraph` and `FeatureGraph` share (hazards 6, 7 and 9). `captures`
    and `replays` count both."""

    what = "a CUDA graph"  # what the error of a failed capture names

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graph = None
        self.captures = 0
        self.replays = 0
        self._inputs = None  # the buffers the graph reads
        self._out = None  # the graph's outputs
        self._per_replay = {}  # counter -> launches a replay

    def _replay(self, inputs):
        """Copy `inputs` into the graph's buffers and replay it on the
        current stream. -> the graph's outputs (overwritten by the next
        replay)."""
        for buf, x in zip(self._inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        self.replays += 1
        for c, n in self._per_replay.items():
            c.launches += n
        return self._out

    def _capture(self, body, inputs):
        """`body(buffers)` on copies of `inputs`: once eagerly on the
        capture stream, then captured. -> the eager run's output, this
        call's result."""
        self.graph = self._out = None
        main = torch.cuda.current_stream(self.device)
        bufs = tuple(torch.empty_like(x) for x in inputs)
        for buf, x in zip(bufs, inputs):
            buf.copy_(x)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            # the call, eagerly, on the capture stream: it builds what the
            # capture must find built (the kernels' library and constants,
            # this stream's workspaces, the solver handles)
            result = body(bufs)
        main.wait_stream(self.stream)
        for t in _tensors(result):
            t.record_stream(main)
        before = {c: c.launches for c in _counters()}
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a collection there could
        # free another session's graph, and destroying a graph is not
        # permitted while a stream captures (it invalidates the capture)
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out = body(bufs)
        except Exception as exc:
            raise RuntimeError(
                f"capturing {self.what} as a CUDA graph failed; pass "
                "cuda_graph=False to run it eagerly") from exc
        finally:
            if gc_on:
                gc.enable()
            captured = {c: c.launches - n for c, n in before.items()}
            for c, n in before.items():
                c.launches = n
        self._per_replay = {c: n for c, n in captured.items() if n}
        self.graph, self._inputs, self._out = graph, bufs, out
        self.captures += 1
        return result


class FrameGraph(_Graph):
    """One captured steady-state frame of a session on a CUDA device.

    `run(step, inputs, state, ring, traj_i, prev_pyr)`: `step(prev_pyr, depth,
    rgb) -> (pyr, T_world, motion, summary)` is the eager frame (it also
    writes the ring at `traj_i`); `inputs` the frame's (depth, rgb);
    `state` the static (T_world, motion, last_kf_T) the step reads; `ring`
    the trajectory ring tensors it writes. Returns the frame's summary on
    the device. The first call, and any call whose static tensors or input
    shapes differ from the capture's, runs the frame eagerly on the capture
    stream (that run is this frame's result) and then captures the graph;
    every other call copies the inputs in and replays.
    """

    what = "the steady-state frame"

    def __init__(self, device: torch.device):
        super().__init__(device)
        self._key = None  # what the graph was captured on (holds them)
        self.pyr = None  # the static previous-frame pyramid of the capture

    def _signature(self, inputs, state, ring, traj_i, prev_pyr):
        return (tuple((x.shape, x.dtype) for x in inputs),
                tuple(state) + tuple(ring) + (traj_i,) + tuple(_leaves(prev_pyr)))

    def _matches(self, key) -> bool:
        if self._key is None:
            return False
        (shapes, tensors), (shapes0, tensors0) = key, self._key
        return shapes == shapes0 and len(tensors) == len(tensors0) and all(
            a is b for a, b in zip(tensors, tensors0))

    def run(self, step, inputs, state, ring, traj_i, prev_pyr) -> torch.Tensor:
        key = self._signature(inputs, state, ring, traj_i, prev_pyr)
        if self.graph is not None and self._matches(key):
            return self._replay(inputs)
        self._key = None
        summary = self._capture(lambda bufs: self._body(step, bufs, state, prev_pyr),
                                inputs)
        self._key, self.pyr = key, prev_pyr
        return summary

    def adopt_pyramid(self, pyr):
        """A bootstrap pyramid as the previous-frame pyramid: copied in place
        into the capture's static one where the layouts agree (no new
        capture), else `pyr` itself (the next `run` captures again)."""
        if self.pyr is None or len(self.pyr) != len(pyr) or any(
                sorted(a) != sorted(b) for a, b in zip(self.pyr, pyr)):
            return pyr
        pairs = list(zip(_leaves(self.pyr), _leaves(pyr)))
        if any(a.shape != b.shape or a.dtype != b.dtype for a, b in pairs):
            return pyr
        for dst, src in pairs:
            dst.copy_(src)
        return self.pyr

    def _body(self, step, inputs, state, prev_pyr):
        """The frame on static tensors: the eager step, then the writes
        back into the pose state and the previous-frame pyramid."""
        pyr, T_world, motion, summary = step(prev_pyr, *inputs)
        state[0].copy_(T_world)
        state[1].copy_(motion)
        for dst, src in zip(_leaves(prev_pyr), _leaves(pyr)):
            dst.copy_(src)
        return summary


class FeatureGraph(_Graph):
    """The feature stage of a session on a CUDA device, captured once.

    `features(depth, rgb) -> (Keypoints, Descriptors, pts, ok)` is the eager
    stage; `run(depth, rgb)` returns what it returns for the frame's depth
    (int32 (H, W)) and rgb (uint8 (H, W, 3)). The first call, and any call
    at another input shape or type, runs the stage eagerly on the capture
    stream (that run is the call's result) and then captures it; every
    other call copies the frame in, replays, and returns clones of the
    graph's outputs (hazard 4).
    """

    what = "the keyframe's feature stage"

    def __init__(self, device: torch.device, features):
        super().__init__(device)
        self.features = features

    def run(self, depth: torch.Tensor, rgb: torch.Tensor):
        inputs = (depth, rgb)
        if self.graph is not None and all(
                b.shape == x.shape and b.dtype == x.dtype
                for b, x in zip(self._inputs, inputs)):
            return _cloned(self._replay(inputs))
        return self._capture(lambda bufs: self.features(*bufs), inputs)
