#!/usr/bin/env python3
"""Readings of the output check's numbers, on the card, for the limits.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one short window of the cell at its own size, then every
compared number twice over the same sample: the program against the plain
reference (the lower readings), and the reference in TF32 in the program's
place (the control, which has to fail). One JSON line a seed. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench.harness import bench, check, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    t0 = time.perf_counter()
    for seed in args.seeds:
        st = bench.prepare(cell, seed, device, False, lambda: time.perf_counter() - t0)
        rec = st["drv"].run(args.seconds)
        st["drv"].close()
        checker = check.Checker(cell.config, st["depth"], st["rgb"], device,
                                int(cell.mix["check_tracked"]))
        streams = int(cell.config["streams"])
        prog = checker.numbers(rec, check.draw_sample(seed, streams))
        ctrl = checker.numbers(rec, check.draw_sample(seed, streams), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "program": prog,
                          "control": ctrl, "limits": cell.limits}), flush=True)
        del st, rec, checker
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
