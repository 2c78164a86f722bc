#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch + CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of `BENCHMARK.json`; its
configuration, traffic mix, per-layer metrics and check limits are files
under `portbench/` found by name. The run renders its inputs from the seed
on the card, warms up, measures for `--seconds`, checks what the window
produced against the plain reference in `portbench/reference/`, and prints
as its last line of standard output one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `check`: each compared number beside its limit, also the last
lines of standard error). Without a CUDA device it exits with 2 and prints
no result. Build and kernel caches stay inside the checkout
(`build/kernels/` for the port's nvcc builds, `build/portbench/` for any
other).
"""

from __future__ import annotations

import os
import sys
import time

_T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (from /proc where it can be read;
    else since this file began to run)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(_ROOT, "build", "portbench")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, _ROOT)

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # a fatal signal prints every thread's stack on standard error
    faulthandler.enable()
    import torch

    from portbench.harness import bench, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), torch sees "
              f"{have}; no result", file=sys.stderr)
        return 2
    out, rows = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), _process_age)
    for name, value, limit in rows:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
