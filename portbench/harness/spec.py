"""A cell's pieces, found by name: its entry in `BENCHMARK.json`, its
configuration file, its traffic mix (`traffic/<mix>.json`), the readers of
its per-layer metrics (`layer_metrics/<metric>.py`) and the limits of its
output check (`limits/<config>.json`, and `limits/<cell>.json` where a cell
compares a number that its configuration's file does not hold). A new
cell, mix, configuration or metric is new files and new `BENCHMARK.json`
entries; nothing here names one.

A reader is a file with `read(record) -> float | None`; the record is
`bench.layer_record`'s: the window's calls, the backend passes' times, the
worker's counts, the trace's summary, and what the program reports, read
by name: its spans (`record["spans"]`, each with `name`, `parent`,
`thread`, `call`, `start_s`, `end_s` and `traced`) and its log records
(`record["log"]`, each a dict with its `kind`). A reader that finds
nothing returns None."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict  # the configuration file
    mix: dict  # the traffic file
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list
    readers: dict  # per-layer metric name -> read(record)
    limits: dict  # compared number -> limit


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_reader(path: Path):
    """The `read(record)` function of a per-layer metric's file."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, root: Path = ROOT, bench_dir: Path | None = None) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`; its files live under
    `bench_dir` (default: the directory of this harness)."""
    bench_dir = BENCH_DIR if bench_dir is None else bench_dir
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf_entry["file"]).read_text())
    mix = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    readers = {m["name"]: load_reader(bench_dir / "layer_metrics" / f"{m['name']}.py")
               for m in layer}
    limits = json.loads((bench_dir / "limits" / f"{w['config']}.json").read_text())
    own = bench_dir / "limits" / f"{name}.json"
    if name != w["config"] and own.exists():
        more = json.loads(own.read_text())
        if set(more) & set(limits):
            raise ValueError(f"{own.name} states limits that {w['config']}.json holds: "
                             f"{sorted(set(more) & set(limits))}")
        limits.update(more)
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]), config=config, mix=mix, end_to_end=e2e,
                per_layer=layer, readers=readers, limits=limits)
