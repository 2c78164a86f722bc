"""Keyframes of the two packages' sessions on the same frames, on the CPU.

    python tools/pair_keyframes.py [--scale 2.0] [--frames 240] [--only NAME]

Renders the JAX package's bench sweep (`orbit_trajectory(n, sweep=True)`) at
640x480 / scale (320x240 by default: the full width does not fit a CPU run of
the JAX session in reasonable time), then runs three inline sessions on the
same frames and prints each one's keyframe count, the frames that inserted
them, loops and ATE:

  * the JAX package's `SLAMSession` at its default `max_decision_lag` (12):
    a frame's decision is taken once its summary has reached the host, and
    decisions computed before the newest insert resolved are suppressed, so
    the count follows how fast its programs finish;
  * the same with `max_decision_lag=1`: every decision at the next call;
  * the port's `SLAMSession(device="cpu")`: on every device it resolves
    each frame's decisions at the next call, whatever the lag setting.

`--only jax12|jax1|port` runs one of the three (they take tens of minutes
each on a CPU; three processes at once take the time of the slowest).

Like the tests, this script imports both packages; the port never does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from slam_rgbd_tpu.core import config as jc  # noqa: E402
from slam_rgbd_tpu.io import synthetic as jsyn  # noqa: E402
from slam_rgbd_tpu.runtime.session import SLAMSession as JaxSession  # noqa: E402
from slam_rgbd_tpu_torch import SLAMSession as PortSession  # noqa: E402
from slam_rgbd_tpu_torch.core import config as tc  # noqa: E402
from slam_rgbd_tpu_torch.eval.trajectory import ate_rmse  # noqa: E402


def _run(label, sess, frames, gt, to_device):
    t0 = time.perf_counter()
    for ts, d, c in frames:
        sess.process_frame(ts, to_device(d), to_device(c))
    sess.flush_pipeline()
    _, est = sess.poses()
    kf = [i for i, s in enumerate(sess.stats) if s.is_keyframe]
    print(f"{label}: keyframes {len(kf)} at frames {kf}; loops {sess.state.loops}; "
          f"lost {sess.state.lost}; ATE {100 * ate_rmse(est, gt)[0]:.3f} cm; "
          f"{time.perf_counter() - t0:.0f} s", flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scale", type=float, default=2.0)
    p.add_argument("--frames", type=int, default=240)
    p.add_argument("--only", choices=("jax12", "jax1", "port"))
    args = p.parse_args()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 3))
    jcfg = jc.astra_default_config()
    jcfg = jcfg.replace(camera=jcfg.camera.scaled(args.scale))
    tcfg = tc.astra_default_config()
    tcfg = dataclasses.replace(tcfg, camera=tcfg.camera.scaled(args.scale))
    gt = jsyn.orbit_trajectory(args.frames, sweep=True)
    frames = [(i / 30.0,) + tuple(np.asarray(x) for x in jsyn.render_frame(
        jnp.asarray(T), jcfg.camera)) for i, T in enumerate(gt)]
    print(f"{args.frames} frames at {jcfg.camera.width}x{jcfg.camera.height}, Astra "
          f"profile otherwise, backend inline", flush=True)
    lag1 = jcfg.replace(runtime=dataclasses.replace(jcfg.runtime, max_decision_lag=1))
    runs = {
        "jax12": ("JAX package, max_decision_lag 12", lambda: JaxSession(jcfg), jnp.asarray),
        "jax1": ("JAX package, max_decision_lag 1", lambda: JaxSession(lag1), jnp.asarray),
        "port": ("port, CPU", lambda: PortSession(tcfg, device="cpu"), lambda x: x),
    }
    for name, (label, make, to_device) in runs.items():
        if args.only in (None, name):
            _run(label, make(), frames, gt, to_device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
