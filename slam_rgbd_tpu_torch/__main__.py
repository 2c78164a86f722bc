"""Command line of the port: `python -m slam_rgbd_tpu_torch run synthetic:N`.

Counterpart of the `run` verb of `slam_rgbd_tpu.cli`: runs the SLAM session
over a synthetic sequence with the backend on its worker thread (as the
reference's `run` does through its pipeline runner), drains it with a final
backend pass, writes the TUM trajectory and prints keyframes, map points,
loops and the ATE against ground truth. It runs on the CUDA device;
`--device cpu` asks for the CPU.

    python -m slam_rgbd_tpu_torch run synthetic:200 --traj out.txt
"""

from __future__ import annotations

import argparse
import sys

from slam_rgbd_tpu_torch.core.config import SLAMConfig, astra_default_config


def _load_config(path: str | None) -> SLAMConfig:
    return SLAMConfig.from_yaml(path) if path else astra_default_config()


def cmd_run(args) -> int:
    from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse
    from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence
    from slam_rgbd_tpu_torch.runtime.session import SLAMSession

    if not args.input.startswith("synthetic"):
        raise SystemExit(f"unrecognized input {args.input!r}: expected 'synthetic[:N]'")
    n = int(args.input.split(":")[1]) if ":" in args.input else 100
    cfg = _load_config(args.config)
    seq = SyntheticSequence(n, cfg.camera, device=args.device)
    session = SLAMSession(cfg, async_backend=True, device=args.device)
    try:
        for ts, depth, rgb in seq:
            session.process_frame(ts, depth, rgb)
        session.sync_backend(final_pass=True)
        print(f"frames={session.state.frames} keyframes={session.state.keyframes} "
              f"map_points={session.map_point_count()} loops={session.state.loops} "
              f"lost={session.state.lost} relocalized={session.state.relocalized}")
        if args.traj:
            session.save_trajectory(args.traj)
            print(f"trajectory -> {args.traj}")
        _, est = session.poses()
    finally:
        session.close()
    rmse, _, _ = ate_rmse(est, seq.groundtruth()[: len(est)])
    print(f"ATE RMSE vs ground truth: {rmse * 100:.2f} cm")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m slam_rgbd_tpu_torch")
    sub = p.add_subparsers(dest="verb", required=True)
    pr = sub.add_parser("run", help="track a sequence, export + evaluate")
    pr.add_argument("input", help="synthetic[:N]")
    pr.add_argument("--traj", help="write the TUM trajectory here")
    pr.add_argument("--config", help="YAML config (default: Astra profile)")
    pr.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    return cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
