"""The port's `.rgbd` codec, queue and retry policy against the JAX package.

Files written by the port's Python and native writers equal the JAX
package's byte for byte; each package reads the other's files; a flipped
payload byte raises and a v1 file reads; `BoundedFrameQueue` and
`RetryingSource` behave as the JAX ones on the same scripted inputs.
"""

import struct

import numpy as np
import pytest

from slam_rgbd_tpu.io import stream as jst
from slam_rgbd_tpu_torch.io import native as tnative
from slam_rgbd_tpu_torch.io import stream as tst


def _frames(n=5, h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    return [(i / 30.0 + 1305031102.0 * (i % 2),
             rng.integers(0, 65536, (h, w), dtype=np.uint16),
             rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for i in range(n)]


def _write(recorder_cls, path, frames):
    with recorder_cls(str(path)) as rec:
        for f in frames:
            rec.write(*f)
    return path.read_bytes()


def _assert_frames_equal(got, want):
    assert len(got) == len(want)
    for (t1, d1, c1), (t2, d2, c2) in zip(got, want):
        assert t1 == t2
        assert d1.dtype == np.uint16 and c1.dtype == np.uint8
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(c1, c2)


@pytest.fixture(scope="module")
def native_ok():
    assert tnative.native_available(), "g++ is here: the native library must build"
    return True


def test_writers_equal_the_jax_writer_byte_for_byte(tmp_path, native_ok):
    frames = _frames()
    want = _write(jst.StreamRecorder, tmp_path / "jax.rgbd", frames)
    assert want[:8] == b"RGBDTPU2"
    assert _write(tst.StreamRecorder, tmp_path / "py.rgbd", frames) == want
    assert _write(tnative.NativeStreamRecorder, tmp_path / "native.rgbd", frames) == want
    rec = tst.open_recorder(str(tmp_path / "open.rgbd"))
    assert isinstance(rec, tnative.NativeStreamRecorder)
    with rec:
        for f in frames:
            rec.write(*f)
    assert (tmp_path / "open.rgbd").read_bytes() == want


def test_each_package_reads_the_others_files(tmp_path, native_ok):
    frames = _frames(4)
    _write(jst.StreamRecorder, tmp_path / "jax.rgbd", frames)
    _write(tnative.NativeStreamRecorder, tmp_path / "port.rgbd", frames)
    # timestamps go through integer microseconds on disk
    want = [(int(t * 1e6) / 1e6, d, c) for t, d, c in frames]
    for path in ("jax.rgbd", "port.rgbd"):
        p = str(tmp_path / path)
        _assert_frames_equal(list(jst.StreamReader(p)), want)
        _assert_frames_equal(list(tst.StreamReader(p)), want)
        _assert_frames_equal(list(tnative.NativeStreamReader(p)), want)
        _assert_frames_equal(list(tst.open_reader(p, prefetch=2)), want)


@pytest.mark.parametrize("reader", ["python", "native"])
def test_flipped_payload_byte_raises(tmp_path, native_ok, reader):
    path = tmp_path / "c.rgbd"
    _write(tst.StreamRecorder, path, _frames(2))
    raw = bytearray(path.read_bytes())
    raw[8 + 40 + 100] ^= 0x01  # a depth byte of frame 0
    path.write_bytes(bytes(raw))
    cls = tst.StreamReader if reader == "python" else tnative.NativeStreamReader
    with pytest.raises(ValueError):
        list(cls(str(path)))


def test_v1_file_reads_in_both_packages(tmp_path, native_ok):
    frames = _frames(3)
    hdr = struct.Struct("<QQIIIII")
    out = bytearray(b"RGBDTPU1")
    for i, (ts, d, c) in enumerate(frames):
        h, w = d.shape
        out += hdr.pack(i, int(ts * 1e6), 1, w, h, d.nbytes, c.nbytes)
        out += d.tobytes() + c.tobytes()
    out += hdr.pack(len(frames), 0, 2, 0, 0, 0, 0)
    path = tmp_path / "v1.rgbd"
    path.write_bytes(bytes(out))
    want = list(jst.StreamReader(str(path)))
    assert len(want) == 3
    _assert_frames_equal(list(tst.StreamReader(str(path))), want)
    _assert_frames_equal(list(tnative.NativeStreamReader(str(path))), want)


def test_bad_magic_raises(tmp_path):
    path = tmp_path / "x.rgbd"
    path.write_bytes(b"NOTRGBD0" + b"\0" * 64)
    with pytest.raises(ValueError):
        tst.StreamReader(str(path))


def test_bounded_queue_drops_as_the_jax_queue():
    """The same script of puts and gets: the same drops, depths and items."""
    rng = np.random.default_rng(1)
    script = rng.integers(0, 3, 200)  # 0: get, else put
    qs = [jst.BoundedFrameQueue(10, 5), tst.BoundedFrameQueue(10, 5)]
    logs = [[], []]
    for k, op in enumerate(script):
        for q, log in zip(qs, logs):
            if op == 0 and len(q):
                log.append(("get", q.get(timeout=1.0)))
            elif op != 0:
                q.put(k)
            log.append(("state", len(q), q.dropped))
    assert logs[0] == logs[1]
    assert qs[1].dropped > 0
    for q in qs:
        q.close()
    drained = [[], []]
    for q, out in zip(qs, drained):
        while (item := q.get()) is not None:
            out.append(item)
    assert drained[0] == drained[1]
    with pytest.raises(ValueError):
        tst.BoundedFrameQueue(5, 10)


def test_native_queue_drops_oldest(native_ok):
    q = tnative.NativeFrameQueue(capacity=4, drop_to=2, max_w=8, max_h=8)
    frames = _frames(6, h=8, w=8)
    for i, f in enumerate(frames):
        q.put(*f, frame_id=i)
    assert q.dropped == 3 and len(q) == 3
    got = [q.get(timeout_ms=100) for _ in range(3)]
    _assert_frames_equal(got, [(int(t * 1e6) / 1e6, d, c) for t, d, c in frames[3:]])
    q.close()
    assert q.get(timeout_ms=100) is None
    q.destroy()


class _Flaky:
    """A scripted source: `fail_init` factory calls raise first, then each
    instance raises at the read indices in `errors`."""

    def __init__(self, fail_init, errors, n=12):
        self.fail_init, self.errors, self.n = fail_init, errors, n
        self.calls = 0

    def factory(self):
        self.calls += 1
        if self.calls <= self.fail_init:
            raise OSError(f"init failure {self.calls}")
        return self._iter(self.calls)

    def _iter(self, gen):
        outer = self

        class It:
            i = 0

            def __iter__(self):
                return self

            def __next__(self):
                i, self.i = self.i, self.i + 1
                if i >= outer.n:
                    raise StopIteration
                if (gen, i) in outer.errors:
                    raise OSError(f"read error {gen}/{i}")
                return (gen, i)

        return It()


@pytest.mark.parametrize("fail_init,errors", [
    (0, set()),
    (2, {(3, 2)}),
    (1, {(2, 1), (2, 2), (2, 3), (2, 4), (2, 5), (3, 0)}),  # five in a row: reinit
])
def test_retrying_source_as_the_jax_one(fail_init, errors):
    outs = []
    for mod in (jst, tst):
        flaky = _Flaky(fail_init, errors)
        src = mod.RetryingSource(flaky.factory, backoff_s=0.0)
        items = list(src)
        outs.append((items, src.reinit_count, src.error_count, flaky.calls))
    assert outs[0] == outs[1]
    flaky = _Flaky(5, set())
    with pytest.raises(tst.SourceError):
        list(tst.RetryingSource(flaky.factory, init_retries=3, backoff_s=0.0))


def test_paced_and_control_channel():
    import time

    t0 = time.monotonic()
    assert list(tst.paced(iter(range(4)), 100.0)) == [0, 1, 2, 3]
    assert time.monotonic() - t0 >= 0.025
    ch = tst.ControlChannel()
    assert ch.poll() is None
    ch.send(tst.ControlCommand.START_RECORD, "x.rgbd")
    assert ch.poll() == (tst.ControlCommand.START_RECORD, "x.rgbd")
    assert [c.name for c in tst.ControlCommand] == [c.name for c in jst.ControlCommand]


def test_failed_native_build_falls_back_with_a_warning(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(tnative, "native_available", lambda: False)
    with caplog.at_level("WARNING", logger="slam_rgbd_tpu_torch.stream"):
        rec = tst.open_recorder(str(tmp_path / "f.rgbd"))
        rec.close()
        reader = tst.open_reader(str(tmp_path / "f.rgbd"), prefetch=4)
    assert isinstance(rec, tst.StreamRecorder) and isinstance(reader, tst.StreamReader)
    assert list(reader) == []
    reader.close()
    warnings = [r for r in caplog.records if r.levelname == "WARNING"]
    assert len(warnings) == 2 and "Python codec" in warnings[0].getMessage()


def test_bounded_queue_under_threads():
    """Four producers and a consumer with a short switch interval: every
    frame put is got once or counted as dropped, none twice."""
    import sys
    import threading

    q = tst.BoundedFrameQueue(10, 5)
    got = []
    n_prod, n_put = 4, 500

    def producer(k):
        for i in range(n_put):
            q.put((k, i))

    def consumer():
        while (item := q.get(timeout=30)) is not None:
            got.append(item)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        cons = threading.Thread(target=consumer)
        cons.start()
        prods = [threading.Thread(target=producer, args=(k,)) for k in range(n_prod)]
        for t in prods:
            t.start()
        for t in prods:
            t.join(timeout=30)
        q.close()
        cons.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not cons.is_alive() and not any(t.is_alive() for t in prods)
    assert len(got) == len(set(got))
    assert len(got) + q.dropped == n_prod * n_put
    for k in range(n_prod):  # each producer's frames arrive in order
        mine = [i for kk, i in got if kk == k]
        assert mine == sorted(mine)


def test_native_build_without_a_source_warns(monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(tnative, "NATIVE_SRC", tmp_path)
    with caplog.at_level("WARNING", logger="slam_rgbd_tpu_torch.native"):
        assert tnative.build_library("slamio.cpp") is None
    assert "no source" in caplog.records[-1].getMessage()
