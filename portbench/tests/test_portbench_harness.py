"""The benchmark harness on the CPU: pieces found by name, the traffic
schedule, the metric arithmetic, the imports of a run, the result line and
the refusal without a card.

    python -m pytest portbench/tests -q

Tests that need the card carry the `cuda` marker and skip without one."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import bench, drive, spec, traffic
from portbench.reference import trajectory
from portbench.reference.camera import Camera
from portbench.reference.synthetic import orbit, render, seeded_room

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.config_name
    assert cell.config["chips"] == cell.chips
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer and all(callable(cell.readers[m["name"]]) for m in cell.per_layer)
    assert all(m["moves"] in reported for m in cell.per_layer)
    for number in cell.mix["checks"]:
        assert number in cell.limits


def _digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_mix_config_and_metric_need_only_new_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    conf = json.loads((pb / "configs" / "astra_session.json").read_text())
    conf["name"] = "astra_wide"
    (pb / "configs" / "astra_wide.json").write_text(json.dumps(conf))
    shutil.copy(pb / "limits" / "astra_session.json", pb / "limits" / "astra_wide.json")
    mix = json.loads((pb / "traffic" / "hold.json").read_text())
    mix["span"] = 12
    (pb / "traffic" / "hold12.json").write_text(json.dumps(mix))
    (pb / "layer_metrics" / "session.call_count.py").write_text(
        "def read(record):\n    return float(len(record['calls']))\n")
    bench_json = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench_json["configs"].append({"name": "astra_wide", "source": "x",
                                  "file": "portbench/configs/astra_wide.json",
                                  "reduced": [], "why": "x"})
    bench_json["workloads"].append({"name": "astra_wide.hold12", "config": "astra_wide",
                                    "traffic": "hold12", "chips": 1, "why": "x"})
    bench_json["per_layer"].append({"name": "session.call_count", "unit": "calls",
                                    "better": "higher", "source": "host_clock", "layer": "x",
                                    "moves": "frames_per_s",
                                    "workloads": ["astra_wide.hold12"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))

    cell = spec.load_cell("astra_wide.hold12", root=tmp_path, bench_dir=pb)
    assert cell.mix["span"] == 12 and cell.config["name"] == "astra_wide"
    assert cell.readers["session.call_count"]({"calls": [1, 2, 3]}) == 3.0
    after = _digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_reader_of_a_span_or_a_log_record_and_a_cells_limit_need_only_new_files(tmp_path):
    """A later cell that reads what the program reports, and compares a
    number its configuration's limits lack, brings only new files."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    pb = tmp_path / "portbench"
    before = _digest(pb)
    mix = json.loads((pb / "traffic" / "sweep.json").read_text())
    mix.update(frames=1260, span=630, recording_calls=630,
               checks=mix["checks"] + ["loop_gap_mm"])
    (pb / "traffic" / "lap.json").write_text(json.dumps(mix))
    (pb / "limits" / "astra_session.lap.json").write_text(json.dumps({"loop_gap_mm": 0.5}))
    (pb / "layer_metrics" / "session.decide_ms.py").write_text(
        "from portbench.harness.bench import span_median_ms\n\n\n"
        "def read(record):\n    return span_median_ms(record, 'session.decide')\n")
    (pb / "layer_metrics" / "worker.loops.py").write_text(
        "def read(record):\n"
        "    n = [r for r in record['log'] if r['kind'] == 'backend' and r['loop']]\n"
        "    return float(len(n)) if record['log'] else None\n")
    bench_json = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench_json["workloads"].append({"name": "astra_session.lap", "config": "astra_session",
                                    "traffic": "lap", "chips": 1, "why": "x"})
    for name in ("session.decide_ms", "worker.loops"):
        bench_json["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                        "source": "program_span", "layer": "x",
                                        "moves": "frames_per_s",
                                        "workloads": ["astra_session.lap"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))

    cell = spec.load_cell("astra_session.lap", root=tmp_path, bench_dir=pb)
    assert cell.limits["loop_gap_mm"] == 0.5
    assert {k: v for k, v in cell.limits.items() if k != "loop_gap_mm"} == spec.load_cell(
        "astra_session.sweep").limits
    assert traffic.schedule(cell.mix, 1, 630)[-1, 0] == 629
    span = {"name": "session.decide", "parent": "session.frame", "thread": 1, "call": 0}
    record = {"spans": [dict(span, start_s=1.0, end_s=1.002, traced=False),
                        dict(span, start_s=2.0, end_s=2.004, traced=False),
                        dict(span, start_s=3.0, end_s=3.5, traced=True)],
              "log": [{"kind": "backend", "loop": True}, {"kind": "backend", "loop": False},
                      {"kind": "frame_window"}]}
    assert cell.readers["session.decide_ms"](record) == pytest.approx(3.0)
    assert cell.readers["worker.loops"](record) == 1.0
    assert cell.readers["worker.loops"]({"log": []}) is None
    after = _digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before

    # a cell's own limits add numbers and never restate its configuration's
    (pb / "limits" / "astra_session.lap.json").write_text(json.dumps({"ba_gap_mm": 1.0}))
    with pytest.raises(ValueError):
        spec.load_cell("astra_session.lap", root=tmp_path, bench_dir=pb)


@pytest.mark.parametrize("mix_name", ["sweep", "hold"])
def test_schedule_is_continuous_in_range_and_free_of_the_seed(mix_name):
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{mix_name}.json").read_text())
    for streams in (1, 16):
        s = traffic.schedule(mix, streams, 3 * traffic.period(mix))
        assert s.shape == (3 * traffic.period(mix), streams)
        assert s.min() >= 0 and s.max() < mix["frames"]
        assert np.abs(np.diff(s, axis=0)).max() <= 1  # every stream moves continuously
        assert np.array_equal(s, traffic.schedule(mix, streams, len(s)))
    assert traffic.schedule(mix, 1, 5)[:, 0].tolist() == traffic.bounce(np.arange(5),
                                                                        mix["span"]).tolist()


def test_a_recording_has_to_hold_calls():
    mix = json.loads((ROOT / "portbench" / "traffic" / "sweep.json").read_text())
    assert traffic.recording_calls(mix) == mix["recording_calls"] > 0
    with pytest.raises(ValueError):
        traffic.recording_calls({**mix, "recording_calls": 0})


def test_bounce_reverses_at_both_ends():
    assert traffic.bounce(np.arange(10), 4).tolist() == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]


def test_the_seed_draws_the_room_and_nothing_else():
    poses = orbit(240)
    assert np.array_equal(poses, orbit(240))
    cam = Camera(fx=57.03, fy=57.03, cx=31.55, cy=23.55, width=64, height=48,
                 depth_scale=1000.0)
    a, b = seeded_room(5, poses[:, :3, 3]), seeded_room(2 ** 33 + 5, poses[:, :3, 3])
    assert a.spheres.shape == b.spheres.shape == (16, 4)
    assert a.boxes.shape == b.boxes.shape == (12, 6)
    assert not np.array_equal(a.spheres, b.spheres)
    d1, c1 = render(poses[7], cam, a, "cpu")
    d2, c2 = render(poses[7], cam, seeded_room(5, poses[:, :3, 3]), "cpu")
    assert torch.equal(d1, d2) and torch.equal(c1, c2)
    # the keyframe thresholds (10 cm, 10 deg) fall on the same frames at
    # every seed: they follow the trajectory, which the seed does not move
    kf, last = [0], poses[0]
    for i in range(1, 240):
        rel = np.linalg.inv(last) @ poses[i]
        ang = np.degrees(np.arccos(np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1)))
        if np.linalg.norm(rel[:3, 3]) > 0.10 or ang > 10.0:
            kf.append(i)
            last = poses[i]
    assert 15 <= len(kf) <= 40


def test_p95_rate_and_ate_on_hand_made_cases():
    assert bench.p95(list(range(1, 101))) == pytest.approx(95.05)
    assert bench.p95([7.0] * 20) == 7.0
    gt = orbit(30).astype(np.float64)
    R = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float64)
    moved = gt.copy()
    moved[:, :3, 3] = gt[:, :3, 3] @ R.T + np.array([1.0, 2.0, 3.0])
    assert trajectory.ate_rms([(moved, gt)]) == pytest.approx(0.0, abs=1e-9)
    off = gt.copy()
    off[::2, 0, 3] += 0.01
    off[1::2, 0, 3] -= 0.01  # zero mean: the alignment cannot absorb it
    assert trajectory.ate_rms([(off, gt)]) == pytest.approx(0.01, rel=2e-2)
    rec = drive.Record(kind="single", streams=2, window_s=4.0, frames_done=10)
    rec.calls = [{"ms": m} for m in (1.0, 2.0, 3.0, 4.0, 5.0)]
    rec.recordings = [drive.Recording(frames=np.zeros((3, 2), int),
                                      est=np.stack([gt[:3], gt[:3]]))]
    out = bench.end_to_end(rec, gt, setup_s=1.5)
    assert out["frames_per_s"] == 2.5
    assert out["call_ms_p95"] == pytest.approx(4.8)
    assert out["setup_s"] == 1.5


_IMPORTS = """
import sys
from portbench import run, control
from portbench.harness import bench, check, drive, spec, trace
import slam_rgbd_tpu_torch.runtime.session, slam_rgbd_tpu_torch.runtime.batch_session
import slam_rgbd_tpu_torch.runtime.profiling
for f in sorted((spec.BENCH_DIR / "layer_metrics").glob("*.py")):
    spec.load_reader(f)
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_imports_no_jax_and_not_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORTS], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert "slam_rgbd_tpu_torch" in names and "portbench" in names
    assert not names & set(bench.FORBIDDEN)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no result" in out.stderr
