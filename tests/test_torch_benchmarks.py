"""The port's benchmark module against the JAX package's on the CPU.

`slam_rgbd_tpu_torch/benchmarks.py` is the counterpart of
`slam_rgbd_tpu/benchmarks.py`. Its workloads are held against the JAX
package's: the local BA on the bench's own workload (both packages'
`windowed_local_ba` on the same numpy arrays), the rendered sweep, and the
loop leg's settings (written out from `slam_rgbd_tpu/benchmarks.py:623,
635-642`, where they are built inline). Then the card helpers of
`runtime.profiling` on hand-computed numbers, the library comparator of
`hamming_top2`, the whole run at 160x120 over 8 frames on the CPU (its one
JSON line and its keys), the `benchmark` verb's wiring, and the backend
worker's default device. The timings are the card's only: here they are the
host clock's and mean nothing.
"""

import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_rgbd_tpu import benchmarks as jbench
from slam_rgbd_tpu.backend import ba as jba
from slam_rgbd_tpu.core import config as jconfig
from slam_rgbd_tpu_torch import __main__ as cli
from slam_rgbd_tpu_torch import benchmarks as tbench
from slam_rgbd_tpu_torch.backend import ba as tba
from slam_rgbd_tpu_torch.backend import worker as tworker
from slam_rgbd_tpu_torch.core import config as tconfig
from slam_rgbd_tpu_torch.io.synthetic import NoiseSpec
from slam_rgbd_tpu_torch.ops import hamming as th
from slam_rgbd_tpu_torch.runtime import profiling
from test_torch_priority import below_the_jax_files  # noqa: F401 (autouse)

H100 = "NVIDIA H100 80GB HBM3"
BA_ARGS = ("poses", "valid", "pts", "obs_uv", "obs_z", "pid", "obs_ok")
# the keys of the JAX package's line (`bench_session` :150-168, 179 and
# `main` :837-901), less `rig` (its TPU link, not ported)
JAX_KEYS = {
    "metric", "value", "unit", "vs_baseline", "tracking_fps", "kernel_sol",
    "ba_ms_per_iter", "ba_window_kf", "ba_obs", "scaling", "session_fps",
    "session_mean_ms", "session_p50_ms", "session_p99_ms", "session_max_ms",
    "keyframes", "map_points", "loops", "backend_jobs", "session_ate_cm", "notes",
    "degraded_leg", "loop_leg", "device",
}
PORT_KEYS = {
    "tracking_fps_eager", "tracking_p50_ms", "tracking_p99_ms",
    "session_insert_p50_ms", "session_insert_p99_ms", "ba_busy_share",
    "kernel_launches", "power_limit_w",
}


def _small(config):
    """A 160x120 configuration of `config` (either package's module): two
    ICP levels, 256 features, a 1024-point map, a BA window of 4."""
    cfg = config.astra_default_config()
    return dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, fx=120.0, fy=120.0, cx=79.5, cy=59.5,
                                   width=160, height=120),
        orb=dataclasses.replace(cfg.orb, n_features=256, n_levels=4),
        icp=config.ICPConfig(levels=2, iters=(4, 3), window_px=(4, 2)),
        keyframes=dataclasses.replace(cfg.keyframes, max_keyframes=64,
                                      max_map_points=1024, kf_min_trans=0.03),
        ba=config.BAConfig(window=4, iters=3, max_points_per_window=512,
                           global_ba_points=512, global_ba_window=16),
    )


def test_ba_on_the_bench_workload_matches_jax():
    tcfg, jcfg = _small(tconfig), _small(jconfig)
    w = tbench.ba_workload(tcfg)
    W, K = 2 * tcfg.ba.window, tcfg.orb.n_features
    assert w["poses"].shape == (W, 4, 4) and w["pid"].shape == (W, K)
    assert w["pts"].shape == (tcfg.keyframes.max_map_points, 3)
    assert len(np.unique(w["pid"])) <= tcfg.ba.max_points_per_window
    assert 0.5 * W * K < w["obs_ok"].sum() < W * K
    want = jba.windowed_local_ba(*(jnp.asarray(w[k]) for k in BA_ARGS), jcfg.camera,
                                 jcfg.ba, free_mask=jnp.asarray(w["free"]))
    got = tba.windowed_local_ba(*(torch.from_numpy(w[k]) for k in BA_ARGS), tcfg.camera,
                                tcfg.ba, free_mask=torch.from_numpy(w["free"]))
    # the backend parity tests' tolerances (`tests/test_torch_backend.py`)
    assert int(got.n_obs) == int(want.n_obs) > 0
    np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(want.kf_pose), atol=1e-4)
    np.testing.assert_allclose(got.pt_xyz.numpy(), np.asarray(want.pt_xyz), atol=1e-3)
    np.testing.assert_allclose(float(got.rmse_px), float(want.rmse_px), rtol=1e-3)
    # the older half is held fixed, the newer half moved
    fixed = ~w["free"]
    np.testing.assert_array_equal(got.kf_pose.numpy()[fixed], w["poses"][fixed])
    assert np.abs(got.kf_pose.numpy()[~fixed] - w["poses"][~fixed]).max() > 0
    # the same draws as the seed's: another seed, other arrays
    assert not np.array_equal(tbench.ba_workload(tcfg, seed=1)["pts"], w["pts"])


def test_render_sequence_matches_jax():
    tcfg, jcfg = _small(tconfig), _small(jconfig)
    jframes, jgt = jbench._render_sequence(jcfg, 4, return_gt=True)
    tframes, tgt = tbench._render_sequence(tcfg, 4, return_gt=True, device="cpu")
    # orbit_trajectory's float32 steps, composed in both packages alike
    np.testing.assert_allclose(tgt, jgt, atol=1e-6)
    for (ts_t, dt, ct), (ts_j, dj, cj) in zip(tframes, jframes):
        assert ts_t == ts_j
        dt, ct, dj, cj = dt.numpy(), ct.numpy(), np.asarray(dj), np.asarray(cj)
        assert dt.shape == dj.shape == (120, 160) and ct.shape == cj.shape == (120, 160, 3)
        # `tests/test_torch_core.py::test_render_frame_matches_jax`'s tolerance:
        # quantization moves a value by one unit; an edge may flip a pixel
        ddiff = np.abs(dt.astype(np.int64) - dj.astype(np.int64))
        cdiff = np.abs(ct.astype(np.int64) - cj.astype(np.int64))
        assert np.mean(ddiff > 1) <= 0.005 and np.mean(cdiff.max(-1) > 1) <= 0.005
        assert np.mean(ddiff == 0) > 0.95
    # the degraded sweep: the port's own draws, the same bits every time
    noise = NoiseSpec(motion_blur=1.0, exposure_drift=0.08)
    a = tbench._render_sequence(tcfg, 2, noise=noise, device="cpu")
    b = tbench._render_sequence(tcfg, 2, noise=noise, device="cpu")
    for (_, da, ca), (_, db, cb), (_, d0, _) in zip(a, b, tframes):
        assert torch.equal(da, db) and torch.equal(ca, cb) and not torch.equal(da, d0)


def test_loop_leg_config_is_the_jax_bench_settings():
    drift = (0.006, 0.0, 0.003, 0.0, 0.003, 0.0)
    for cfg_t, cfg_j in ((tconfig.astra_default_config(), jconfig.astra_default_config()),
                         (_small(tconfig), _small(jconfig))):
        for on in (False, True):
            want = cfg_j.replace(
                icp=dataclasses.replace(cfg_j.icp, drift_xi=drift),
                keyframes=dataclasses.replace(cfg_j.keyframes, kf_min_trans=0.06),
                ba=dataclasses.replace(
                    cfg_j.ba, loop_min_interval=5, loop_cooldown_kf=3,
                    loop_min_score=(cfg_j.ba.loop_min_score if on else 2.0)))
            got = tbench.loop_leg_config(cfg_t, on)
            assert got.to_dict() == want.to_dict()
            assert got.icp.drift_xi == drift and got.keyframes.kf_min_trans == 0.06
            assert (got.ba.loop_min_interval, got.ba.loop_cooldown_kf) == (5, 3)
            assert got.ba.loop_min_score == (cfg_t.ba.loop_min_score if on else 2.0)
            assert got.camera == cfg_t.camera and got.orb == cfg_t.orb


def test_roofline_on_hand_computed_numbers():
    # 3.35 GB at 3.35 TB/s: 1 ms, measured 2 ms
    r = profiling.roofline(3.35e9, 2e-3, card=H100)
    assert r["sol_us"] == pytest.approx(1000.0) and r["fraction"] == pytest.approx(0.5)
    assert r["bound"] == "bytes" and r["measured_us"] == pytest.approx(2000.0)
    assert r["achieved_gbps"] == pytest.approx(1675.0) and r["card"] == H100
    # 2 ms of int8 operations measured in 1 ms: reported as measured, not capped
    r = profiling.roofline(1e6, 1e-3, int8_ops=1979e12 * 2e-3, card=H100)
    assert r["fraction"] == pytest.approx(2.0) and r["bound"] == "int8"
    assert r["achieved_tops"] == pytest.approx(3958.0)
    # float32 and int8 operations run on units that overlap: the larger
    # binds, 1 ms of float32 over 0.5 ms of int8
    r = profiling.roofline(0.0, 4e-3, f32_ops=67e9, int8_ops=1979e12 * 0.5e-3, card=H100)
    assert r["sol_us"] == pytest.approx(1000.0) and r["fraction"] == pytest.approx(0.25)
    assert r["bound"] == "f32"
    assert profiling.sol_s(0.0, 67e9, 1979e12 * 0.5e-3, H100) == (pytest.approx(1e-3), "f32")
    assert profiling.sol_s(3.35e9, card="NVIDIA A100-SXM4-80GB") is None
    # a card the table lacks: no peaks stand in
    for card in ("NVIDIA A100-SXM4-80GB", None):
        r = profiling.roofline(3.35e9, 2e-3, card=card)
        assert r["sol_us"] is None and r["fraction"] is None and r["bound"] is None
        assert r["achieved_gbps"] == pytest.approx(1675.0)
    assert profiling.card_peaks(H100)["bytes_s"] == 3.35e12
    assert profiling.card_peaks("NVIDIA A100-SXM4-80GB") is None
    assert profiling.card_peaks(None) is None


def test_work_counts_give_the_kernel_table_bounds():
    """The bench's counts of each kernel's work, at the main path's shapes,
    on the H100's peaks: the bounds of `PERF.md` section 6, by hand."""
    def sol(work):
        assert len(work) == 3  # bytes, float32 operations, int8 operations
        return profiling.roofline(*work[:1], 1.0, *work[1:], card=H100)

    gn = sol(tbench.gn_work(1, 1, 480 * 640))  # 18 planes read, 78 values a problem
    assert gn["bound"] == "bytes"
    assert gn["sol_us"] == pytest.approx(4.0 * (18 * 480 * 640 + 78) / 3.35e12 * 1e6)
    b4 = sol(tbench.gn_work(4, 4, 480 * 640))
    assert b4["sol_us"] == pytest.approx(4.0 * (4 * 18 * 480 * 640 + 4 * 78) / 3.35e12 * 1e6)
    top2 = sol(tbench.top2_work(1024, 16384, 1024 * 16384))
    assert top2["bound"] == "int8"
    assert top2["sol_us"] == pytest.approx(2 * 256 * 1024 * 16384 / 1979e12 * 1e6)
    pairs = 14647296  # a full map's unmasked pairs
    gated = sol(tbench.gated_work(1024, 16384, pairs))
    assert gated["bound"] == "int8"
    assert gated["sol_us"] == pytest.approx(512 * pairs / 1979e12 * 1e6)


def test_hamming_top2_library_distances_equal_the_reference():
    rng = np.random.default_rng(5)
    s1 = torch.from_numpy(rng.choice([-1, 1], (96, 256)).astype(np.int8))
    s2 = torch.from_numpy(rng.choice([-1, 1], (300, 256)).astype(np.int8))
    s2[200:210] = s2[:10]  # ties: the index is the only thing that may differ
    v1 = torch.from_numpy(rng.uniform(size=96) > 0.1)
    v2 = torch.from_numpy(rng.uniform(size=300) > 0.1)
    ref = th.hamming_top2_reference(s1, v1, s2, v2)
    lib = tbench.hamming_top2_library(s1, v1, s2, v2)
    assert torch.equal(lib[0], ref[0]) and torch.equal(lib[1], ref[1])
    assert bool((lib[0][~v1] == 1e9).all())
    unique = ref[1] > ref[0]
    assert torch.equal(lib[2][unique].to(torch.int32), ref[2][unique])


def test_main_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.setattr(tbench, "bench_tracking",
                        functools.partial(tbench.bench_tracking, iters=12))
    res = tbench.main(_small(tconfig), n_frames=8, device="cpu", scaling_iters=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(res))
    assert set(line) == JAX_KEYS | PORT_KEYS
    assert line["metric"] == "slam_session_fps_640x480_odometry_plus_mapping"
    assert line["unit"] == "frames/sec" and line["value"] == line["session_fps"] > 0
    assert line["vs_baseline"] == pytest.approx(line["session_fps"] / 30.0)
    assert line["kernel_sol"] == "skipped (no CUDA device)"
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["ba_busy_share"] is None
    assert line["ba_window_kf"] == 8 and line["ba_ms_per_iter"] > 0 and line["ba_obs"] > 0
    for k in ("tracking_fps", "tracking_fps_eager", "tracking_p50_ms", "tracking_p99_ms",
              "session_mean_ms", "session_p50_ms", "session_p99_ms", "session_max_ms"):
        assert np.isfinite(line[k]) and line[k] > 0, k
    assert line["keyframes"] >= 2 and line["map_points"] > 0
    assert line["session_insert_p50_ms"] > 0
    assert line["session_ate_cm"] < 5.0
    assert line["backend_jobs"]["completed"] >= 1
    assert [r["batch"] for r in line["scaling"]["batch_scaling_1chip"]] == [1, 2, 4, 8]
    assert line["scaling"]["hardware"] == "cpu"
    assert set(line["degraded_leg"]) == {"fps", "ate_cm", "keyframes", "lost_frames",
                                         "relocalized", "degradations", "data"}
    assert "NOT real TUM footage" in line["degraded_leg"]["data"]
    leg = line["loop_leg"]
    assert leg["n_frames"] == 8 and leg["drift_xi"] == [0.006, 0.0, 0.003, 0.0, 0.003, 0.0]
    assert set(leg["loop_off"]) == {"ate_cm", "loops", "keyframes", "fps", "p99_ms"}
    assert set(leg["loop_on"]) == set(leg["loop_off"]) | {"loop_merge_frames",
                                                          "merge_frame_ms"}
    assert leg["loop_off"]["loops"] == 0
    # on CPU tensors the wrappers take their plain versions and count nothing
    assert line["kernel_launches"] == dict.fromkeys(
        ("gn_reduce", "gn_reduce_batched", "gated_match", "hamming_top2"), 0)


def test_the_verb_runs_the_benchmark(tmp_path, monkeypatch):
    seen = {}

    def fake_main(cfg, **kw):
        seen.update(kw, cfg=cfg)
        return {"metric": tbench.METRIC, "value": 1.0}

    monkeypatch.setattr(tbench, "main", fake_main)
    yaml, out = tmp_path / "small.yaml", tmp_path / "line.json"
    _small(tconfig).to_yaml(str(yaml))
    argv = ["benchmark", "--device", "cpu", "--config", str(yaml), "--frames", "8"]
    assert cli.main(argv + ["--no-legs", "--iters", "2", "--out", str(out)]) == 0
    assert seen == {"cfg": _small(tconfig), "n_frames": 8, "legs": False, "device": "cpu",
                    "scaling_iters": 2}
    assert json.loads(out.read_text()) == {"metric": tbench.METRIC, "value": 1.0}
    seen.clear()
    assert cli.main(argv) == 0
    assert seen["legs"] is True and seen["scaling_iters"] == 10 and seen["n_frames"] == 8


def test_backend_worker_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tworker.BackendWorker(_small(tconfig))
