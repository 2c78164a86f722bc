"""What the program reports reaching the per-layer readers, on the CPU at
a small size: the window's spans (set-up's cleared, those in the traced
slice marked), the batch session handed the traced run's log, and the
drivers keeping no loop captures unless a mix names `loop_gap_mm`.

    python -m pytest portbench/tests -q"""

from __future__ import annotations

import json
import statistics
import time
from pathlib import Path

import pytest
import torch

from portbench.harness import bench, spec
from portbench.harness.trace import Tracer
from portbench.tests.test_portbench_check import small

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _window(cell, traced: bool, seconds: float = 3.0, seed: int = 2 ** 31 + 21):
    """(driver, record) of a window of `cell`; the driver is left open."""
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    st = bench.prepare(cell, seed, CPU, traced, lambda: time.perf_counter() - t0)
    drv = st["drv"]
    if traced:
        assert drv.metrics.spans == [] and drv.metrics.records == []  # set-up's cleared
    tracer = Tracer(float(cell.mix["trace_after_s"]), float(cell.mix["trace_s"]), CPU) \
        if traced else None
    rec = drv.run(seconds, tracer)
    if tracer is not None:
        rec.trace = tracer.summary
    return drv, rec


def test_spans_reach_the_readers_and_only_those_outside_the_slice_count():
    cell = small("astra_session.hold")
    drv, rec = _window(cell, traced=True)
    drv.close()
    record = bench.layer_record(rec, cell.config, "cpu")
    spans = record["spans"]
    lo, hi = rec.trace["slice_s"]
    assert 0.0 < lo < hi < rec.window_s
    # set-up's spans are gone: every span lies in the window
    assert spans and all(0.0 <= s["start_s"] <= s["end_s"] <= rec.window_s for s in spans)
    assert all(s["traced"] == (s["start_s"] < hi and s["end_s"] > lo) for s in spans)
    waits = [s for s in spans if s["name"] == "session.wait"]
    # inside a call, or in the drain at a recording's end
    parents = {s["parent"] for s in waits}
    assert "session.decide" in parents and parents <= {"session.decide", None}
    outside = [1e3 * (s["end_s"] - s["start_s"]) for s in waits if not s["traced"]]
    assert outside and any(s["traced"] for s in waits)
    read = spec.load_reader(spec.BENCH_DIR / "layer_metrics" / "session.wait_ms.py")
    assert read(record) == pytest.approx(statistics.median(outside))
    # spans inside the slice alone read nothing
    inside = dict(record, spans=[dict(s, traced=True) for s in spans])
    assert read(inside) is None
    assert any(r["kind"] == "backend" for r in record["log"])


def test_the_batch_session_gets_the_traced_runs_log():
    cell = small("tum_fleet.hold")
    drv, rec = _window(cell, traced=True)
    drv.close()
    record = bench.layer_record(rec, cell.config, "cpu")
    names = {s["name"] for s in record["spans"]}
    assert {"batch.step", "batch.upload", "batch.fetch", "batch.track"} <= names
    for metric in ("batch.upload_ms", "batch.fetch_ms"):
        v = spec.load_reader(spec.BENCH_DIR / "layer_metrics" / f"{metric}.py")(record)
        assert v is not None and v > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_committed_mixes_keep_no_loop_captures(name):
    cell = spec.load_cell(name)
    assert "loop_gap_mm" not in cell.mix["checks"]
    from slam_rgbd_tpu_torch.core.config import SLAMConfig

    from portbench.harness import drive

    drv = {"single": drive.SingleDriver, "batch": drive.BatchDriver}[cell.config["session"]](
        SLAMConfig.from_dict(cell.config["slam"]), cell.config, None, None, cell.mix, CPU,
        None, [0])
    assert drv.loops is False


def test_loop_capture_is_off_unless_named_and_holds_no_pass_when_on():
    cell = small("astra_session.sweep")
    drv, rec = _window(cell, traced=False, seconds=2.0)
    worker = drv.sess.worker
    assert "_pass" not in vars(worker) and drv.ended == {}
    assert all(r.loop_captures == [] for r in rec.recordings)
    drv.close()

    cell.mix["checks"] = cell.mix["checks"] + ["loop_gap_mm"]
    drv, rec = _window(cell, traced=False, seconds=2.0)
    worker = drv.sess.worker
    assert "_pass" in vars(worker)
    assert sum(r.completed for r in rec.recordings) > 0
    # every pass that ended was taken by a merge or a drop
    assert drv.ended == {}
    drv.close()
