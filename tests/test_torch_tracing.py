"""The port's request tracing (``hyperopt_tpu_torch.tracing``): the JAX
package's ``tests/test_tracing.py`` run against the port, except its
service, Prometheus and trace-report cases, which wait for the service —
spans nest within a thread and never leak across threads, sampling 0 is
a no-op on the hot path, the trace log survives a mid-write SIGKILL and
rotates, chaos injections carry the active trace id — plus the record
format against the JAX package's.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from hyperopt_tpu import tracing as jtracing
from hyperopt_tpu_torch import tracing
from hyperopt_tpu_torch.tracing import (
    NULL_SPAN,
    Tracer,
    format_record,
    head_sampled,
    parse_trace_log,
    read_trace_log,
)


@pytest.fixture(autouse=True)
def _readable_cwd():
    """Threaded queue workers of an earlier test file in this process (the
    JAX package's ``tests/test_file_trials.py``) can leave its cwd in a
    deleted temporary directory; this file's subprocesses and lazy imports
    need a cwd that exists."""
    try:
        os.getcwd()
    except FileNotFoundError:
        os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    yield


class TestSpans:
    def test_nesting_within_a_thread(self):
        tracer = Tracer(sample=1.0)
        tr = tracer.begin()
        with tracing.use_trace(tr):
            with tracing.span("outer") as outer:
                with tracing.span("inner", k=1) as inner:
                    assert tracing.current_span() is inner
                assert tracing.current_span() is outer
            assert tracing.current_span() is None
        spans = {s.name: s for s in tr.spans()}
        assert spans["inner"].parent_id == spans["outer"].span_id
        assert spans["outer"].parent_id is None
        assert tr.root is spans["outer"]
        assert spans["inner"].attrs == {"k": 1}
        assert spans["inner"].duration_s >= 0.0

    def test_never_leaks_across_threads(self):
        tracer = Tracer(sample=1.0)
        tr = tracer.begin()
        seen = {}

        def probe():
            seen["trace"] = tracing.current_trace()
            seen["span"] = tracing.span("should_be_null")

        with tracing.use_trace(tr):
            with tracing.span("root"):
                t = threading.Thread(target=probe)
                t.start()
                t.join()
        # a freshly spawned thread starts UNBOUND even while the parent
        # holds an open span — no implicit inheritance
        assert seen["trace"] is None
        assert seen["span"] is NULL_SPAN
        assert [s.name for s in tr.spans()] == ["root"]

    def test_use_trace_restores_previous_binding(self):
        tracer = Tracer(sample=1.0)
        tr1, tr2 = tracer.begin(), tracer.begin()
        with tracing.use_trace(tr1):
            assert tracing.current_trace() is tr1
            with tracing.use_trace(tr2):
                assert tracing.current_trace() is tr2
            assert tracing.current_trace() is tr1
        assert tracing.current_trace() is None

    def test_explicit_parent_for_cross_thread_handoff(self):
        tracer = Tracer(sample=1.0)
        tr = tracer.begin()
        with tracing.use_trace(tr):
            with tracing.span("root") as root:
                pass

        def worker():
            with tracing.use_trace(tr, parent=root):
                with tracing.span("child"):
                    pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        spans = {s.name: s for s in tr.spans()}
        assert spans["child"].parent_id == spans["root"].span_id

    def test_span_error_attr_on_exception(self):
        tracer = Tracer(sample=1.0)
        tr = tracer.begin()
        with pytest.raises(RuntimeError):
            with tracing.use_trace(tr):
                with tracing.span("boom"):
                    raise RuntimeError("x")
        (sp,) = tr.spans()
        assert sp.attrs["error"] == "RuntimeError"
        assert sp.t1 is not None


# ---------------------------------------------------------------------
# sampling / disabled hot path
# ---------------------------------------------------------------------


class TestSampling:
    def test_sample_zero_is_disabled(self):
        tracer = Tracer(sample=0.0)
        assert not tracer.enabled
        assert tracer.begin() is None
        # the null path: one shared singleton, nothing allocated
        with tracing.use_trace(None):
            assert tracing.span("anything") is NULL_SPAN
            assert tracing.add_event("anything") is NULL_SPAN
            assert tracing.current_trace_id() is None
        assert tracer.summary()["n_begun"] == 0

    def test_sample_zero_noop_survives_recorder_retention(self, monkeypatch):
        """A recorder's trace-ring retention hooks Tracer.finish, and must
        NOT regress the sample-0 fast path — with no trace bound, span()
        still returns the shared singleton without allocating, locking,
        or reading a clock.  (The reference installs its flight
        recorder, which the port does not carry yet; a ring that counts
        what it is fed stands in for it.)"""

        class Ring:
            def __init__(self):
                self.traces = []

            def record_trace(self, trace):
                self.traces.append(trace)

        recorder = Ring()
        tracer = Tracer(sample=0.0)
        tracer.set_recorder(recorder)
        # off still means off: no traces begin, the ring stays empty
        assert not tracer.enabled
        assert tracer.begin() is None
        assert tracer.finish(None) is False
        assert recorder.traces == []
        # no clock read on the unbound span path: a poisoned monotonic
        # clock would raise if span()/add_event() ever touched it
        def poisoned():
            raise AssertionError("unbound span path read the clock")

        monkeypatch.setattr(tracing.time, "monotonic", poisoned)
        with tracing.use_trace(None):
            assert tracing.span("anything", k=1) is NULL_SPAN
            assert tracing.add_event("anything") is NULL_SPAN
        # no per-call allocation: the singleton is returned, not built
        import tracemalloc

        tracemalloc.start()
        try:
            tracing.span("hot")  # warm any lazy interning
            before = tracemalloc.take_snapshot()
            for _ in range(100):
                tracing.span("hot")
            after = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
        grown = [
            s for s in after.compare_to(before, "lineno")
            if s.size_diff > 0 and "tracing.py" in str(s.traceback)
        ]
        assert not grown, grown

    def test_slow_threshold_alone_enables(self):
        tracer = Tracer(sample=0.0, slow_threshold_s=0.5)
        assert tracer.enabled
        assert tracer.begin() is not None

    def test_head_dropped_requests_buffer_nothing(self):
        # without a slow threshold a head-dropped request must not pay
        # for Trace allocation and span bookkeeping at all
        tracer = Tracer(sample=1e-9)
        drop_id = "some-id"
        assert not head_sampled(drop_id, tracer.sample)
        assert tracer.begin(drop_id) is None
        s = tracer.summary()
        assert s["n_dropped"] == 1 and s["n_begun"] == 0
        # WITH a slow threshold the same request buffers (tail rescue
        # needs the spans to know the duration)
        rescue = Tracer(sample=1e-9, slow_threshold_s=0.5)
        assert rescue.begin(drop_id) is not None

    def test_counters_reconcile_without_log_path(self):
        tracer = Tracer(sample=1.0)  # kept traces, nowhere to land
        tr = tracer.begin()
        with tracing.use_trace(tr):
            with tracing.span("root"):
                pass
        assert tracer.finish(tr) is False
        s = tracer.summary()
        assert s["n_unlogged"] == 1
        assert s["n_begun"] == (
            s["n_written"] + s["n_dropped"] + s["n_unlogged"]
        )

    def test_head_sampling_is_deterministic_in_the_id(self):
        decisions = {head_sampled("trace-abc", 0.5) for _ in range(32)}
        assert len(decisions) == 1
        assert head_sampled("x", 1.0) and not head_sampled("x", 0.0)
        # roughly the configured fraction samples
        n = sum(head_sampled(f"t{i}", 0.25) for i in range(2000))
        assert 0.15 < n / 2000 < 0.35

    def test_slow_trace_written_despite_head_drop(self, tmp_path):
        log = str(tmp_path / "t.jsonl")
        tracer = Tracer(path=log, sample=1e-9, slow_threshold_s=0.01)
        # fast trace: head-dropped
        tr = tracer.begin()
        with tracing.use_trace(tr):
            with tracing.span("root"):
                pass
        assert tracer.finish(tr) is False
        # slow trace: rescued by the threshold
        tr = tracer.begin()
        with tracing.use_trace(tr):
            with tracing.span("root"):
                time.sleep(0.02)
        assert tracer.finish(tr) is True
        records, torn = read_trace_log(log)
        assert torn == 0 and len(records) == 1
        assert records[0]["duration_s"] >= 0.01


# ---------------------------------------------------------------------
# crash-tolerant log
# ---------------------------------------------------------------------


class TestTraceLog:
    def _write_n(self, tracer, n):
        for i in range(n):
            tr = tracer.begin()
            with tracing.use_trace(tr):
                with tracing.span("root", i=i):
                    pass
            tracer.finish(tr)

    def test_roundtrip_and_resync_after_torn_tail(self, tmp_path):
        log = str(tmp_path / "t.jsonl")
        tracer = Tracer(path=log, sample=1.0)
        self._write_n(tracer, 5)
        # tear the tail mid-record (what a SIGKILL mid-append leaves)
        with open(log, "r+b") as f:
            f.truncate(os.path.getsize(log) - 9)
        records, torn = read_trace_log(log)
        assert torn == 1 and len(records) == 4
        # the NEXT append's leading newline re-synchronizes the reader
        self._write_n(tracer, 1)
        records, torn = read_trace_log(log)
        assert torn == 1 and len(records) == 5
        assert all(r["root"] == "root" for r in records)

    def test_survives_midwrite_sigkill(self, tmp_path):
        """A writer SIGKILL'd at a random moment leaves at most one torn
        record, and the log stays appendable + readable."""
        log = str(tmp_path / "t.jsonl")
        child = subprocess.Popen(
            [sys.executable, "-c", f"""
import sys; sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
from hyperopt_tpu_torch import tracing
tracer = tracing.Tracer(path={log!r}, sample=1.0)
i = 0
while True:
    tr = tracer.begin()
    with tracing.use_trace(tr):
        with tracing.span("root", i=i):
            pass
    tracer.finish(tr)
    i += 1
"""],
        )
        try:
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                if os.path.exists(log) and os.path.getsize(log) > 2000:
                    break
                time.sleep(0.01)
        finally:
            child.send_signal(signal.SIGKILL)
            child.wait(timeout=10)
        assert os.path.getsize(log) > 0
        records, torn = read_trace_log(log)
        assert torn <= 1
        assert len(records) >= 1
        # still appendable after the crash
        tracer = Tracer(path=log, sample=1.0)
        self._write_n(tracer, 1)
        records2, torn2 = read_trace_log(log)
        assert len(records2) == len(records) + 1 and torn2 == torn

    def test_rotation_bounds_the_log(self, tmp_path):
        log = str(tmp_path / "t.jsonl")
        tracer = Tracer(path=log, sample=1.0, max_bytes=2000)
        self._write_n(tracer, 60)
        assert os.path.getsize(log) <= 2000
        assert os.path.exists(log + ".1")
        assert tracer.summary()["n_rotations"] >= 1
        # both generations parse; total stays bounded
        records, torn = read_trace_log(log)
        assert torn == 0 and 0 < len(records) < 60

    def test_format_crc_rejects_corruption(self):
        rec = format_record({"a": 1})
        records, torn = parse_trace_log(rec)
        assert records == [{"a": 1}] and torn == 0
        records, torn = parse_trace_log(rec[:-2] + b"xx")
        assert records == [] and torn == 1


class TestChaosCorrelation:
    def test_injection_log_carries_active_trace_id(self, tmp_path):
        from hyperopt_tpu_torch.resilience.chaos import ChaosConfig, ChaosMonkey

        inj = str(tmp_path / "inj.jsonl")
        victim = tmp_path / "doc.json"
        victim.write_bytes(b"x" * 100)
        monkey = ChaosMonkey(ChaosConfig(
            seed=0, p_torn_doc=1.0, tear_kills_process=False,
            injection_log=inj,
        ))
        tracer = Tracer(sample=1.0)
        tr = tracer.begin()
        with tracing.use_trace(tr):
            monkey.maybe_torn_doc(str(victim), 7)
        # outside any trace, the stamp is null — still parseable
        victim.write_bytes(b"y" * 100)
        monkey.maybe_torn_doc(str(victim), 8)
        from hyperopt_tpu_torch.resilience.chaos import parse_injection_log

        lines = parse_injection_log(open(inj, "rb").read())
        assert lines[0]["site"] == "torn_doc"
        assert lines[0]["trace_id"] == tr.trace_id
        assert lines[1]["trace_id"] is None


def test_trace_log_reads_in_both_packages(tmp_path):
    """A trace log written by the port parses to the same records in the
    JAX package, and head sampling decides the same for the same ids."""
    log = str(tmp_path / "t.jsonl")
    tracer = Tracer(path=log, sample=1.0)
    for i in range(3):
        tr = tracer.begin()
        with tracing.use_trace(tr):
            with tracing.span("root", i=i):
                with tracing.span("child"):
                    pass
        tracer.finish(tr)
    raw = open(log, "rb").read()
    assert parse_trace_log(raw) == jtracing.parse_trace_log(raw)
    assert len(parse_trace_log(raw)[0]) == 3
    for i in range(200):
        assert head_sampled(f"t{i}", 0.3) == jtracing.head_sampled(f"t{i}", 0.3)
    assert format_record({"k": [1, 2]}) == jtracing.format_record({"k": [1, 2]})
