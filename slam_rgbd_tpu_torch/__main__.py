"""Command line of the port, the verbs of `slam_rgbd_tpu.cli`:

    python -m slam_rgbd_tpu_torch run <input>     SLAM over a source
    python -m slam_rgbd_tpu_torch record <input> <out.rgbd>
    python -m slam_rgbd_tpu_torch play <clip.rgbd>
    python -m slam_rgbd_tpu_torch eval <estimate.txt> <groundtruth.txt>
    python -m slam_rgbd_tpu_torch export <input> <out.ply | out.ppm>
    python -m slam_rgbd_tpu_torch serve <input>   web point-cloud viewer
    python -m slam_rgbd_tpu_torch benchmark [--frames N] [--no-legs] [--out line.json]
    python -m slam_rgbd_tpu_torch benchmark --scaling [--out report.json]

An input is a TUM or ICL-NUIM directory, a `.rgbd` recording,
`synthetic[:N]`, or `grabber:module:factory` (a `FrameGrabber` factory).
`run` and `play` go through `PipelineRunner` with the backend on its worker
thread (`--threaded` adds the producer / consumer threads and the bounded
queue), drain it with a final backend pass, and print frames, keyframes,
map points, loops and, where the input has ground truth, the ATE with each
estimate paired to the ground truth nearest in time. `benchmark` runs
`benchmarks.main` and prints its one JSON line (the threaded session's
frames/s and call times, tracking alone, the kernels against the card's
peaks, local BA ms an iteration, batch scaling, and with the legs the
degraded and the loop leg); `--iters` sets its scaling iterations. `benchmark --scaling`
prints the scaling report of `parallel.scaling` as JSON (frames/s of batched
tracking at B = 1, 2, 4, 8 on one device, and of `dist.batch_track` at each
mesh size up to the number of cards). Every verb runs on the CUDA device and
raises without one; `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys

import numpy as np

from slam_rgbd_tpu_torch.core.config import (
    SLAMConfig, astra_default_config, tum_fr1_config,
)


def _load_config(args) -> SLAMConfig:
    if args.config:
        return SLAMConfig.from_yaml(args.config)
    if getattr(args, "tum", False):
        return tum_fr1_config()
    return astra_default_config()


def _make_source(args, cfg):
    """The frame source of `args.input` -> (source, ground-truth timestamps,
    ground-truth poses); both None where the input has no ground truth."""
    from slam_rgbd_tpu_torch.io import stream as st

    inp = args.input or ""
    if os.path.isdir(inp):
        if not os.path.exists(os.path.join(inp, "depth.txt")) and glob.glob(
            os.path.join(inp, "*.depth")
        ):
            from slam_rgbd_tpu_torch.io.icl_nuim import ICLNUIMSequence

            seq = ICLNUIMSequence(inp, cfg.camera)
        else:
            from slam_rgbd_tpu_torch.io.tum import TUMSequence

            seq = TUMSequence(inp, cfg.camera)
        gt = seq.groundtruth()
        return seq, (seq.timestamps if gt is not None else None), gt
    if inp.endswith(".rgbd"):
        return st.open_reader(inp, prefetch=cfg.stream.prefetch), None, None
    if inp.startswith("synthetic"):
        from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence

        n = int(inp.split(":")[1]) if ":" in inp else 100
        seq = SyntheticSequence(n, cfg.camera, device=args.device)
        return seq, seq.timestamps, seq.groundtruth()
    if inp.startswith("grabber:"):
        from slam_rgbd_tpu_torch.io.grabber import GrabberSource, resolve_grabber

        factory = resolve_grabber(inp[len("grabber:"):])
        return GrabberSource(factory, stream_cfg=cfg.stream), None, None
    raise SystemExit(
        f"unrecognized input {args.input!r}: expected a TUM or ICL-NUIM directory, "
        f"a .rgbd recording, 'synthetic[:N]', or 'grabber:module:factory'"
    )


def cmd_run(args) -> int:
    from slam_rgbd_tpu_torch.eval.trajectory import ate_by_timestamp
    from slam_rgbd_tpu_torch.io import stream as st
    from slam_rgbd_tpu_torch.runtime.runner import ControlMenu, PipelineRunner

    cfg = _load_config(args)
    src, gt_ts, gt = _make_source(args, cfg)
    runner = PipelineRunner(cfg, iter(src), device=args.device)
    if args.record:
        runner.control.send(st.ControlCommand.START_RECORD, args.record)
        runner._handle_control()
    threaded = args.threaded
    if getattr(args, "interactive", False):
        ControlMenu(runner).start()
        threaded = True  # the menu needs the threaded pipeline
    server = None
    if getattr(args, "serve", None) is not None:
        # the viewer reads the running session's map at every request
        from slam_rgbd_tpu_torch.viz.pointcloud import map_to_pointcloud
        from slam_rgbd_tpu_torch.viz.server import PointCloudServer

        server = PointCloudServer(
            lambda: map_to_pointcloud(runner.session.map), port=args.serve,
        ).start()
        print(f"live viewer at http://{server.host}:{server.port}/ "
              f"(/native for the C++ rasterizer)")
    session = runner.session
    try:
        runner.run(threads=threaded)
        if runner.recorder is not None:
            runner.recorder.close()
        # a final backend pass before any export, as the reference saves
        # through one last optimization
        session.sync_backend(final_pass=True)
        print(f"frames={session.state.frames} keyframes={session.state.keyframes} "
              f"map_points={session.map_point_count()} loops={session.state.loops} "
              f"lost={session.state.lost} relocalized={session.state.relocalized} "
              f"dropped={runner.queue.dropped}")
        if args.traj:
            session.save_trajectory(args.traj)
            print(f"trajectory -> {args.traj}")
        if args.kf_traj:
            session.save_keyframe_trajectory(args.kf_traj)
        if args.checkpoint:
            from slam_rgbd_tpu_torch.runtime import checkpoint

            checkpoint.save(session, args.checkpoint)
            print(f"checkpoint -> {args.checkpoint}")
        ts, est = session.poses()
    finally:
        if server is not None:
            server.stop()
        session.close()
    if gt is not None and len(est):
        rmse = ate_by_timestamp(ts, est, gt_ts, gt)
        print(f"ATE RMSE vs ground truth: {rmse * 100:.2f} cm")
    return 0


def cmd_record(args) -> int:
    from slam_rgbd_tpu_torch.io import stream as st

    cfg = _load_config(args)
    src, _, _ = _make_source(args, cfg)
    n = 0
    with st.open_recorder(args.output) as rec:
        for ts, d, c in st.paced(iter(src), args.fps):
            rec.write(ts, d, c)
            n += 1
            if args.frames and n >= args.frames:
                break
    print(f"recorded {n} frames -> {args.output}")
    return 0


def cmd_play(args) -> int:
    args.input = args.recording
    args.record = None
    return cmd_run(args)


def cmd_eval(args) -> int:
    from slam_rgbd_tpu_torch.eval.trajectory import (
        associate_by_timestamp, ate_rmse, load_trajectory_tum, rpe,
    )

    ts_e, est = load_trajectory_tum(args.estimate)
    ts_g, gt = load_trajectory_tum(args.groundtruth)
    gt_assoc = gt[associate_by_timestamp(ts_e, ts_g)]
    rmse, _, _ = ate_rmse(est, gt_assoc)
    t_rpe, r_rpe = rpe(est, gt_assoc)
    print(json.dumps({
        "ate_rmse_m": round(rmse, 5),
        "rpe_trans_m": round(t_rpe, 5),
        "rpe_rot_deg": round(float(np.rad2deg(r_rpe)), 4),
        "frames": len(est),
    }))
    return 0


def _nth_frame(args, cfg):
    src, _, _ = _make_source(args, cfg)
    frame = None
    for i, f in enumerate(iter(src)):
        frame = f
        if i >= args.frame:
            break
    if frame is None:
        raise SystemExit(f"{args.input}: no frames")
    return frame


def cmd_export(args) -> int:
    from slam_rgbd_tpu_torch.viz.pointcloud import frame_to_pointcloud, save_ply

    cfg = _load_config(args)
    _, depth, rgb = _nth_frame(args, cfg)
    pts, colors = frame_to_pointcloud(depth, rgb, cfg.camera, stride=args.stride,
                                      device=args.device)
    if args.output.endswith(".ppm"):
        # a snapshot through the native software viewer
        from slam_rgbd_tpu_torch.viz.native import NativeViewer, native_available

        if not native_available():
            raise SystemExit("native viewer unavailable (see the WARNING of its build)")
        with NativeViewer() as vw:
            vw.set_target(0.0, 0.0, float(np.median(pts[:, 2])))
            vw.write_ppm(args.output, vw.render(pts, colors))
        print(f"{len(pts)} points rendered -> {args.output}")
        return 0
    save_ply(args.output, pts, colors)
    print(f"{len(pts)} points -> {args.output}")
    return 0


def cmd_serve(args) -> int:
    import time

    from slam_rgbd_tpu_torch.viz.pointcloud import frame_to_pointcloud
    from slam_rgbd_tpu_torch.viz.server import PointCloudServer

    cfg = _load_config(args)
    _, depth, rgb = _nth_frame(args, cfg)
    cloud = frame_to_pointcloud(depth, rgb, cfg.camera, stride=2, device=args.device)
    server = PointCloudServer(lambda: cloud, port=args.port).start()
    print(f"viewer at http://{server.host}:{server.port}/ (Ctrl-C stops it)")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def cmd_benchmark(args) -> int:
    from slam_rgbd_tpu_torch.parallel.scaling import scaling_report

    cfg = _load_config(args)
    if not args.scaling:
        from slam_rgbd_tpu_torch import benchmarks

        res = benchmarks.main(cfg, n_frames=args.frames, legs=not args.no_legs,
                              device=args.device, scaling_iters=args.iters)
        if args.out:
            with open(args.out, "w") as f:
                f.write(json.dumps(res) + "\n")
        return 0
    rep = scaling_report(cfg.camera, cfg.icp, iters=args.iters, width=args.width,
                         height=args.height, device=args.device)
    out = json.dumps(rep, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
        print(f"scaling report -> {args.out}")
    print(out)
    return 0


def build_parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--config", help="YAML config (default: the Astra profile)")
    common.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    common.add_argument("-v", "--verbose", action="store_true")
    p = argparse.ArgumentParser(prog="python -m slam_rgbd_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="verb", required=True)

    def verb(name, fn, help_):
        sp = sub.add_parser(name, help=help_, parents=[common])
        sp.set_defaults(fn=fn)
        return sp

    def source_opts(sp):
        sp.add_argument("--tum", action="store_true", help="TUM fr1 intrinsics")

    def run_opts(sp):
        source_opts(sp)
        sp.add_argument("--traj", help="write the TUM trajectory here")
        sp.add_argument("--kf-traj", help="write the keyframe trajectory here")
        sp.add_argument("--checkpoint", help="save the final state here")
        sp.add_argument("--threaded", action="store_true",
                        help="producer / consumer threads and the bounded queue")

    pr = verb("run", cmd_run, "run SLAM over a source")
    pr.add_argument("input", help="TUM / ICL-NUIM dir | .rgbd | synthetic[:N] | "
                                  "grabber:module:factory")
    run_opts(pr)
    pr.add_argument("--record", help="tee the frames to a .rgbd recording")
    pr.add_argument("--interactive", action="store_true",
                    help="stdin control menu (record / playback / reset / quit)")
    pr.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve the running session's map (0: an ephemeral port)")

    pc = verb("record", cmd_record, "capture a source to a .rgbd recording")
    pc.add_argument("input")
    pc.add_argument("output")
    pc.add_argument("--fps", type=float, default=0.0, help="pace (0: as fast as read)")
    pc.add_argument("--frames", type=int, default=0)
    source_opts(pc)

    pp = verb("play", cmd_play, "replay a recording through SLAM")
    pp.add_argument("recording")
    run_opts(pp)

    pe = verb("eval", cmd_eval, "ATE / RPE of a trajectory against ground truth")
    pe.add_argument("estimate")
    pe.add_argument("groundtruth")

    px = verb("export", cmd_export, "a frame as a .ply point cloud or a .ppm render")
    px.add_argument("input")
    px.add_argument("output")
    px.add_argument("--frame", type=int, default=0)
    px.add_argument("--stride", type=int, default=1)
    source_opts(px)

    ps = verb("serve", cmd_serve, "web point-cloud viewer of one frame")
    ps.add_argument("input")
    ps.add_argument("--frame", type=int, default=0)
    ps.add_argument("--port", type=int, default=8080)
    source_opts(ps)

    pb = verb("benchmark", cmd_benchmark,
              "the benchmark's JSON line, or the scaling report (--scaling)")
    pb.add_argument("--scaling", action="store_true",
                    help="frames/s against the batch size and the mesh size")
    pb.add_argument("--frames", type=int, default=240, help="frames of the sweep")
    pb.add_argument("--no-legs", action="store_true",
                    help="leave out the degraded and the loop leg")
    pb.add_argument("--iters", type=int, default=10, help="timed steps a scaling row")
    pb.add_argument("--width", type=int, default=0)
    pb.add_argument("--height", type=int, default=0)
    pb.add_argument("--out", help="write the JSON line or report here")
    return p


def _require_device(device: str) -> None:
    """A verb asked for a CUDA device raises without one: no CPU fallback."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {device} was asked for but torch sees no CUDA device; "
            "pass --device cpu to run on the CPU"
        )


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    _require_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
