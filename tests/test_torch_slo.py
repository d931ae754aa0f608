"""The port's SLO guardrails (``hyperopt_tpu_torch.slo``), held to the
JAX package's ``tests/test_slo.py`` on the CPU, and to the JAX package's
engine on identical inputs.

Covers the contracts:

- multi-window burn-rate arithmetic over histogram-bucket deltas (a
  window histogram is the elementwise difference of two snapshots);
- each SL6xx rule fires on its degenerate signal and ONLY then (the
  seeded injections of scripts/slo_report.FIXTURES, driven into the
  port's stats objects), with the same rule rows as the JAX package's
  engine on the same inputs;
- the multi-window discipline: a hot fast window with a cold slow
  window does NOT breach (no paging on one bad minute after a clean
  hour);
- breach transitions: ok → breach increments ``breaches_total`` and
  dumps exactly one flight-recorder bundle; recovery clears status
  without re-dumping;
- the flight recorder: bounded trace ring fed by Tracer.finish
  regardless of head-sampling, pull providers read only at dump time,
  CRC-per-record bundle round-trip, torn-record detection, pruning;
- storage-plane telemetry (StoreStats) reconciles against trial
  counts on a driven service, and the warm/cold latency split
  attributes first-touch compile events;
- the service surfaces: ``/v1/alerts`` over HTTP, client.alerts(),
  slo/store/build-info families on ``/metrics``, crash-hook dump.

SL608 (failover MTTR) reads the replica plane's ``ReplicaStats``: a
single-process service reports it ``no_data`` (its ``ok`` and ``breach``
over a replica service are in ``tests/test_torch_replicas.py``).
"""

import json
import os
import sys
import threading

import pytest

from hyperopt_tpu_torch import hp, slo, tracing
from hyperopt_tpu_torch.observability import (
    DeviceStats,
    ServiceStats,
    StoreStats,
    quantile_from_counts,
)
from hyperopt_tpu_torch.tracing import Tracer

sys.path.insert(
    0,
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts",
    ),
)

SPACE = {
    "x": hp.uniform("x", -5, 5),
    "c": hp.choice("c", ["a", "b"]),
}
AP = {"n_startup_jobs": 1, "n_EI_candidates": 8}


def _drain(svc):
    try:
        svc.close(timeout=10.0)
    except Exception:
        pass


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engine(clock, recorder=None, **kwargs):
    env = {
        "service": ServiceStats(),
        "device": DeviceStats(),
        "store": StoreStats(),
    }
    eng = slo.SloEngine(
        service_stats=env["service"],
        device_stats=env["device"],
        store_stats=env["store"],
        recorder=recorder,
        time_fn=clock,
        snapshot_interval=1.0,
        **kwargs,
    )
    env["engine"] = eng
    return env


def _fixture_env(pkg_slo, pkg_obs, bundle_dir):
    """``scripts/slo_report._fixture_env`` over either package's modules:
    fresh stats + recorder + a deterministic-clock engine."""
    clock = {"t": 0.0}
    service_stats = pkg_obs.ServiceStats()
    device_stats = pkg_obs.DeviceStats()
    store_stats = pkg_obs.StoreStats()
    recorder = pkg_slo.FlightRecorder(bundle_dir=bundle_dir)
    recorder.set_provider("dispatch", device_stats.recent_records)
    recorder.set_provider("store_op", store_stats.recent_ops)
    engine = pkg_slo.SloEngine(
        service_stats=service_stats, device_stats=device_stats,
        store_stats=store_stats, recorder=recorder,
        time_fn=lambda: clock["t"], snapshot_interval=1.0,
    )
    return {
        "clock": clock, "service": service_stats, "device": device_stats,
        "store": store_stats, "recorder": recorder, "engine": engine,
    }


def _run_fixture(rule_id, name, inject, bundle_dir, baseline_kwargs=None):
    """``scripts/slo_report.run_fixture`` against the port's engine: a
    healthy baseline, the injection, a tick; the intended rule (and only
    it) breaches and the dump round-trips with the breaching traces."""
    import slo_report

    from hyperopt_tpu_torch import observability

    env = _fixture_env(slo, observability, bundle_dir)
    trace_ids = [f"{rule_id.lower()}-victim-{i}" for i in range(3)]
    for tid in trace_ids:
        env["recorder"].record_trace({
            "trace_id": tid, "root": "service.suggest",
            "duration_s": 5.0, "spans": [],
        })
    slo_report._seed_baseline(env, **(baseline_kwargs or {}))
    env["clock"]["t"] = 10.0
    env["engine"].tick()
    pre_breaching = env["engine"].current_breaching()
    inject(env)
    env["clock"]["t"] = 110.0
    env["engine"].tick()
    breaching = env["engine"].current_breaching()
    bundle_path = env["recorder"].summary()["last_bundle"]
    bundle = (slo.validate_bundle(bundle_path) if bundle_path
              else {"ok": False, "trace_ids": []})
    present = all(t in bundle.get("trace_ids", []) for t in trace_ids)
    return {
        "ok": (pre_breaching == [] and breaching == [rule_id] and bundle["ok"]
               and present and rule_id in str(bundle.get("reason"))),
        "pre_breaching": pre_breaching, "breaching": breaching,
        "bundle": {"ok": bundle["ok"], "breaching_trace_ids_present": present},
    }


def _fixture_ids():
    import slo_report

    return [f[0] for f in slo_report.FIXTURES]


@pytest.mark.parametrize("rule_id", _fixture_ids())
def test_rule_rows_equal_the_jax_engines(rule_id, tmp_path):
    """Each seeded fixture driven into both packages' stats objects and
    engines at the same clock: the same rule rows (status, burn rates,
    measured values, breach counts), SL607's detail text aside."""
    import slo_report

    import hyperopt_tpu.observability as jobs
    import hyperopt_tpu.slo as jslo
    from hyperopt_tpu_torch import observability as tobs

    fixture = next(f for f in slo_report.FIXTURES if f[0] == rule_id)
    _, _, inject, baseline_kwargs = fixture
    rows = {}
    for tag, pkg_slo, pkg_obs in (("jax", jslo, jobs), ("port", slo, tobs)):
        env = _fixture_env(pkg_slo, pkg_obs, str(tmp_path / tag))
        slo_report._seed_baseline(env, **baseline_kwargs)
        env["clock"]["t"] = 10.0
        env["engine"].tick()
        inject(env)
        env["clock"]["t"] = 110.0
        env["engine"].tick()
        rows[tag] = [
            {k: v for k, v in r.items() if not (r["rule"] == "SL607" and k == "detail")}
            for r in env["engine"].evaluate(force=True)
        ]
    assert rows["port"] == rows["jax"]


# ---------------------------------------------------------------------
# window arithmetic
# ---------------------------------------------------------------------


class TestWindows:
    def test_quantile_from_counts_matches_histogram(self):
        from hyperopt_tpu_torch.observability import LatencyHistogram

        h = LatencyHistogram(buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v)
        s = h.state()
        for q in (0.5, 0.9, 0.99):
            assert quantile_from_counts(
                s["edges"], s["counts"], q
            ) == h.quantile(q)

    def test_window_delta_sees_only_recent_observations(self):
        clock = _Clock()
        env = _engine(clock)
        eng, ss = env["engine"], env["service"]
        for _ in range(10):
            ss.record_request("suggest", seconds=0.01, study="s")
        clock.t = 100.0
        eng.tick()  # snapshot carrying the 10 old observations
        for _ in range(5):
            ss.record_request("suggest", seconds=0.02, study="s")
        clock.t = 150.0
        cur = eng._capture()
        with eng._lock:
            snaps = list(eng._snapshots)
        # nominal 50 s: the t=100 snapshot is exactly old enough, so
        # the window excludes the 10 older observations
        win = eng._window(cur, 50.0, snaps)
        assert win.hist("suggest_warm")["total"] == 5
        # nominal longer than the snapshot spacing allows: the window
        # extends to the earliest snapshot (more coverage, never empty)
        full = eng._window(cur, 10_000.0, snaps)
        assert full.hist("suggest_warm")["total"] == 15

    def test_count_above_is_exact_at_bucket_edges(self):
        state = {"edges": (0.1, 1.0, 2.5), "counts": [3, 2, 1, 4]}
        assert slo._count_above(state, 2.5) == 4
        assert slo._count_above(state, 1.0) == 5
        assert slo._count_above(state, 0.1) == 7

    def test_count_above_non_edge_bound_undercounts(self):
        """A bound inside a bucket excludes that bucket entirely — the
        conservative direction: a custom objective off a bucket edge
        must never page on observations that may be under it."""
        state = {"edges": (0.1, 1.0, 2.5), "counts": [3, 2, 1, 4]}
        # bound 1.5 sits inside (1.0, 2.5]: that bucket's 1 observation
        # is excluded (it may be 1.2 — under the bound); only buckets
        # entirely above count
        assert slo._count_above(state, 1.5) == 4
        assert slo._count_above(state, 0.5) == 5

    def test_idle_device_burn_is_finite(self):
        """Duty 0 is the WORST SL604 breach: the exported burn must be
        a finite >= 1 number an external alert can fire on, not NaN."""
        win = slo._Window(100.0, 300.0, {"busy_s": 0.0, "dispatches": 10},
                          {})
        burn, duty, _ = slo.DutyCycleRule().eval_window(win, {})
        assert duty == 0.0
        assert burn == 1e6
        assert slo._round6(burn) == 1e6


# ---------------------------------------------------------------------
# rules — seeded fixtures single-sourced from the acceptance script
# ---------------------------------------------------------------------


class TestRuleFixtures:
    def test_every_fixture_fires_exactly_its_intended_rule(self, tmp_path):
        import slo_report

        for rule_id, name, inject, baseline_kwargs in slo_report.FIXTURES:
            rec = _run_fixture(
                rule_id, name, inject,
                str(tmp_path / rule_id), baseline_kwargs=baseline_kwargs,
            )
            assert rec["ok"], (rule_id, rec)
            assert rec["pre_breaching"] == []
            assert rec["breaching"] == [rule_id]
            assert rec["bundle"]["ok"]
            assert rec["bundle"]["breaching_trace_ids_present"]

    def test_healthy_traffic_breaches_nothing(self):
        clock = _Clock()
        env = _engine(clock)
        for _ in range(50):
            env["service"].record_request(
                "suggest", seconds=0.02, study="s"
            )
            env["store"].record_fsync(0.001, kind="doc", nbytes=100)
        env["device"].record_dispatch({
            "sig": "x", "device_s": 8.0, "n_requests": 8,
            "binding_ceiling": "hbm_bw", "roofline_pct": 10.0,
            "hbm_bytes": 1e6, "flops": 1e6, "live_bytes": 10,
            "compiled": False,
        })
        clock.t = 60.0
        env["engine"].tick()
        rows = env["engine"].evaluate(force=True)
        assert all(r["status"] != "breach" for r in rows), rows
        assert env["engine"].current_breaching() == []

    def test_no_data_never_breaches(self):
        clock = _Clock()
        env = _engine(clock)
        clock.t = 60.0
        rows = env["engine"].evaluate(force=True)
        # an idle server: latency/duty/fsync rules lack data, the
        # zero-tolerance and rate rules read clean
        by_rule = {r["rule"]: r for r in rows}
        assert by_rule["SL601"]["status"] == "no_data"
        assert by_rule["SL604"]["status"] == "no_data"
        assert all(r["status"] != "breach" for r in rows)


# ---------------------------------------------------------------------
# multi-window discipline + transitions
# ---------------------------------------------------------------------


class TestMultiWindow:
    def test_hot_fast_window_with_cold_slow_window_does_not_breach(self):
        clock = _Clock()
        env = _engine(clock)
        eng, ss = env["engine"], env["service"]
        # a clean hour: 1000 served requests
        for _ in range(1000):
            ss.record_request("suggest", study="s")
        clock.t = 3000.0
        eng.tick()  # snapshot: the fast window will start after this
        # one bad minute: 20 rejections against 20 serves
        for _ in range(20):
            ss.record_request("suggest", study="s")
            ss.record_rejection("suggest")
        clock.t = 3300.0
        rows = {r["rule"]: r for r in eng.evaluate(force=True)}
        r = rows["SL603"]
        # fast window burns (0.5/0.05 = 10) but the slow window holds
        # (40/1040 over 5% budget < 1) — no breach, no page
        assert r["burn_fast"] >= 1.0
        assert r["burn_slow"] < 1.0
        assert r["status"] == "ok"
        assert eng.current_breaching() == []

    def test_breach_transition_counts_and_recovers(self, tmp_path):
        clock = _Clock()
        recorder = slo.FlightRecorder(bundle_dir=str(tmp_path))
        env = _engine(clock, recorder=recorder)
        eng, ss = env["engine"], env["service"]
        for _ in range(20):
            ss.record_request("suggest", study="s")
            ss.record_rejection("suggest")
        clock.t = 50.0
        eng.tick()
        assert eng.current_breaching() == ["SL603"]
        rows = {r["rule"]: r for r in eng.evaluate(force=True)}
        assert rows["SL603"]["breaches_total"] == 1
        assert recorder.summary()["n_dumps"] == 1  # one dump per transition
        # still breaching on the next tick: no second dump
        clock.t = 55.0
        eng.tick()
        assert recorder.summary()["n_dumps"] == 1
        # recovery: an hour of clean traffic pushes both windows green
        for _ in range(5000):
            ss.record_request("suggest", study="s")
        clock.t = 50.0 + 3700.0
        eng.tick()
        assert eng.current_breaching() == []
        rows = {r["rule"]: r for r in eng.evaluate(force=True)}
        assert rows["SL603"]["status"] == "ok"
        assert rows["SL603"]["breaches_total"] == 1  # transitions, not ticks

    def test_read_route_errors_do_not_inflate_sl603(self):
        """A flaky read-only endpoint (500s on /v1/status) must not
        page the mutating-route error SLO: numerator and denominator
        cover the same (mutating) population."""
        clock = _Clock()
        env = _engine(clock)
        eng, ss = env["engine"], env["service"]
        for _ in range(20):
            ss.record_request("suggest", study="s")
            ss.record_error("other")  # read-route 500s
        clock.t = 50.0
        rows = {r["rule"]: r for r in eng.evaluate(force=True)}
        assert rows["SL603"]["status"] == "ok"
        assert rows["SL603"]["burn_fast"] == 0.0
        # the same volume of MUTATING errors does breach
        for _ in range(20):
            ss.record_error("suggest")
        clock.t = 100.0
        rows = {r["rule"]: r for r in eng.evaluate(force=True)}
        assert rows["SL603"]["status"] == "breach"

    def test_rule_table_shape(self):
        clock = _Clock()
        env = _engine(clock)
        rows = env["engine"].evaluate(force=True)
        assert {r["rule"] for r in rows} == {
            "SL601", "SL602", "SL603", "SL604", "SL605", "SL606",
            "SL607", "SL608",
        }
        for r in rows:
            assert r["status"] in ("ok", "breach", "no_data")
            assert "burn_fast" in r and "burn_slow" in r
            assert "objective" in r and "detail" in r
            assert r["window_fast_s"] >= 0 and r["window_slow_s"] >= 0

    def test_default_rules_rejects_unknown_override(self):
        with pytest.raises(ValueError):
            slo.default_rules(latency_ration={"ratio_max": 1})


# ---------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------


class TestFlightRecorder:
    def test_trace_ring_is_bounded(self):
        rec = slo.FlightRecorder(max_traces=4)
        for i in range(10):
            rec.record_trace({"trace_id": f"t{i}", "spans": []})
        assert rec.summary()["n_buffered_traces"] == 4
        records = rec._trace_records()
        assert [r["trace_id"] for r in records] == [
            "t6", "t7", "t8", "t9"
        ]

    def test_dump_roundtrip_and_validation(self, tmp_path):
        rec = slo.FlightRecorder(bundle_dir=str(tmp_path))
        rec.record_trace({"trace_id": "abc", "spans": []})
        rec.set_provider("dispatch", lambda: [{"sig": "s", "device_s": 1}])
        rec.set_provider("study_health", lambda: [{"study": "a"}])
        path = rec.dump("unit-test", context={"k": 1})
        assert path and os.path.exists(path)
        v = slo.validate_bundle(path)
        assert v["ok"] and v["n_torn"] == 0
        assert v["reason"] == "unit-test"
        assert v["kinds"]["trace"] == 1
        assert v["kinds"]["dispatch"] == 1
        assert v["kinds"]["study_health"] == 1
        assert v["trace_ids"] == ["abc"]
        records, _ = slo.read_bundle(path)
        assert records[0]["kind"] == "manifest"
        assert records[0]["context"] == {"k": 1}
        assert "version" in records[0]["build"]
        assert records[-1]["kind"] == "end"

    def test_torn_bundle_detected(self, tmp_path):
        rec = slo.FlightRecorder(bundle_dir=str(tmp_path))
        path = rec.dump("tear-me")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 7)
        v = slo.validate_bundle(path)
        assert not v["ok"] and v["n_torn"] == 1

    def test_dump_without_dir_returns_none(self):
        rec = slo.FlightRecorder()
        assert rec.dump("nowhere") is None

    def test_bundles_pruned_to_bound(self, tmp_path):
        rec = slo.FlightRecorder(bundle_dir=str(tmp_path), max_bundles=3)
        for i in range(6):
            rec.dump(f"r{i}")
        names = sorted(
            n for n in os.listdir(tmp_path) if n.startswith("flightrec-")
        )
        assert len(names) == 3
        assert names[-1].endswith("r5.jsonl")

    def test_provider_failure_does_not_fail_the_dump(self, tmp_path):
        rec = slo.FlightRecorder(bundle_dir=str(tmp_path))

        def boom():
            raise RuntimeError("provider down")

        rec.set_provider("bad", boom)
        rec.set_provider("good", lambda: [{"x": 1}])
        path = rec.dump("resilient")
        v = slo.validate_bundle(path)
        assert v["ok"] and v["kinds"].get("good") == 1
        assert "bad" not in v["kinds"]

    def test_non_json_evidence_is_stringified(self, tmp_path):
        rec = slo.FlightRecorder(bundle_dir=str(tmp_path))
        rec.set_provider("odd", lambda: [{"obj": object()}])
        path = rec.dump("stringify")
        v = slo.validate_bundle(path)
        assert v["ok"] and v["kinds"]["odd"] == 1


class TestTracerRetention:
    def test_finish_feeds_recorder_even_when_head_dropped(self):
        rec = slo.FlightRecorder()
        # sample ~0 but slow-threshold set: traces are begun (buffered)
        # and head-DROPPED at finish — the recorder still sees them
        tracer = Tracer(sample=1e-9, slow_threshold_s=10.0)
        tracer.set_recorder(rec)
        tr = tracer.begin("some-id")
        with tracing.use_trace(tr):
            with tracing.span("root"):
                pass
        assert tracer.finish(tr) is False  # not written anywhere
        assert rec.summary()["n_buffered_traces"] == 1
        assert rec._trace_records()[0]["trace_id"] == tr.trace_id

    def test_disabled_tracer_feeds_nothing(self):
        rec = slo.FlightRecorder()
        tracer = Tracer(sample=0.0)
        tracer.set_recorder(rec)
        assert tracer.begin() is None
        assert tracer.finish(None) is False
        assert rec.summary()["n_buffered_traces"] == 0


class TestCrashHooks:
    def test_threading_excepthook_dumps_then_chains(self, tmp_path):
        rec = slo.FlightRecorder(bundle_dir=str(tmp_path))
        chained = []
        prev = threading.excepthook
        threading.excepthook = lambda args: chained.append(args)
        try:
            slo.install_crash_dump(rec)

            def boom():
                raise RuntimeError("unhandled")

            t = threading.Thread(target=boom)
            t.start()
            t.join()
        finally:
            threading.excepthook = prev
            import sys as _sys

            _sys.excepthook = _sys.__excepthook__
        assert rec.summary()["n_dumps"] == 1
        # the reason survives (filename-sanitized: ':' becomes '-')
        assert "crash-RuntimeError" in rec.summary()["last_bundle"]
        assert len(chained) == 1  # the previous hook still ran


# ---------------------------------------------------------------------
# service integration
# ---------------------------------------------------------------------


class TestServiceIntegration:
    def _service(self, tmp_path=None, **kwargs):
        from hyperopt_tpu_torch.service import OptimizationService

        return OptimizationService(
            root=str(tmp_path / "root") if tmp_path is not None else None,
            batch_window=0.001, device="cpu", **kwargs,
        )

    def _drive(self, svc, sid="s0", n=4):
        svc.create_study(sid, SPACE, seed=3, algo_params=AP)
        for j in range(n):
            (t,) = svc.suggest(sid, idempotency_key=f"{sid}-k{j}")
            svc.report(
                sid, t["tid"], loss=float(j),
                idempotency_key=f"{sid}-r{j}",
            )

    def test_store_counters_reconcile_on_driven_service(self, tmp_path):
        svc = self._service(tmp_path)
        try:
            self._drive(svc, n=4)
            s = svc.store_stats.summary()
            # segmented default backend: one segment append per
            # trial-state transition (4 inserts + 4 result writes),
            # one record each on this unbatched path — and NO per-doc
            # writes at all
            assert s["doc_writes"] == 0
            assert s["segment_appends"] == 8
            assert s["segment_records"] == 8
            # one journal append per keyed mutation (4 suggests +
            # 4 reports; the create above was unkeyed)
            assert s["journal_appends"] == 8
            assert s["fsyncs"]["journal"] == 8
            # ZERO O(N) directory scans anywhere: the study-create
            # refresh replays the (empty) segment tail, the serve hot
            # path runs on the materialized view
            assert s["scans"] == 0
            assert s["refresh_local"] == 8
            assert s["refresh_full"] == 1
            # every fsync kind accounted: no doc fsyncs; one manifest
            # publish at create + one fsync per segment append
            assert s["fsyncs"].get("doc", 0) == 0
            assert s["fsyncs"]["segment"] == 9
            assert s["fsyncs"]["counter"] == 4
            # config + one seed cursor per suggest
            assert s["fsyncs"]["attachment"] == 5
        finally:
            _drain(svc)

    def test_warm_cold_split_attributes_first_touch(self, tmp_path):
        from hyperopt_tpu_torch.algos import tpe_device

        svc = self._service(tmp_path)
        try:
            # force a fresh compile event: an earlier test in this
            # process may have dispatched the same program key already
            tpe_device.reset_device_state()
            self._drive(svc, n=4)
            s = svc.stats.summary()
            warm, cold = (
                s["suggest_latency_warm"], s["suggest_latency_cold"]
            )
            assert warm["count"] + cold["count"] == 4
            # the first batched dispatch is a compile event: >= 1 cold
            assert cold["count"] >= 1
            hist_total = s["suggest_latency"]
            assert hist_total["p99_ms"] is not None
        finally:
            _drain(svc)

    def test_alerts_payload_and_metrics_families(self, tmp_path):
        svc = self._service(tmp_path)
        try:
            self._drive(svc, n=2)
            al = svc.alerts()
            assert {r["rule"] for r in al["rules"]} == {
                "SL601", "SL602", "SL603", "SL604", "SL605", "SL606",
                "SL607", "SL608",
            }
            assert al["breaching"] == [
                r["rule"] for r in al["rules"] if not r["ok"]
            ]
            assert al["recorder"] is not None
            text = svc.metrics_text()
            for family in (
                "hyperopt_slo_status", "hyperopt_slo_burn_rate",
                "hyperopt_slo_breaches_total", "hyperopt_build_info",
                "hyperopt_store_fsyncs_total",
                "hyperopt_store_fsync_duration_seconds_bucket",
                "hyperopt_store_scans_total",
                "hyperopt_service_suggest_split_latency_ms",
                "hyperopt_service_errors_total",
            ):
                assert family in text, family
        finally:
            _drain(svc)

    def test_alerts_over_http_and_client(self, tmp_path):
        from hyperopt_tpu_torch.service import ServiceClient, ServiceServer

        svc = self._service(tmp_path)
        server = ServiceServer(svc).start()
        try:
            client = ServiceClient(server.url)
            al = client.alerts()
            assert len(al["rules"]) == 8
            st = client.service_status()
            assert "version" in st and "started_at" in st
            assert st["version"]["version"]
            assert "store" in st and "slo_breaching" in st
        finally:
            server.stop()

    def test_slo_disabled_is_fully_off(self, tmp_path):
        from hyperopt_tpu_torch.parallel.file_trials import store_stats

        svc = self._service(tmp_path, slo_enabled=False)
        try:
            assert store_stats() is not svc.store_stats
            # no breach-triggered dumps either: the engine carries no
            # recorder, so a /v1/alerts poll stays passive
            assert svc.slo.recorder is None
            self._drive(svc, n=2)
            assert svc.store_stats.summary()["doc_writes"] == 0
            assert "hyperopt_slo_status" not in svc.metrics_text()
        finally:
            _drain(svc)

    def test_close_uninstalls_store_stats(self, tmp_path):
        from hyperopt_tpu_torch.parallel.file_trials import store_stats

        svc = self._service(tmp_path)
        assert store_stats() is svc.store_stats
        _drain(svc)
        assert store_stats() is None

    def test_status_json_serializable(self, tmp_path):
        svc = self._service(tmp_path)
        try:
            self._drive(svc, n=2)
            json.dumps(svc.service_status())
            json.dumps(svc.alerts())
        finally:
            _drain(svc)


# ---------------------------------------------------------------------
# race lint registration (satellite convention)
# ---------------------------------------------------------------------


def test_slo_registered_and_race_clean():
    """The port's own race lint passes on its ``slo.py``, whose shared
    state keeps its guarded-by annotations."""
    from hyperopt_tpu_torch.analysis import lint_races

    path = slo.__file__
    diags = lint_races(paths=[path])
    assert not diags, [str(d) for d in diags]
    src = open(path).read()
    assert "# guarded-by: _lock" in src


def test_failover_rule_reads_no_data_without_a_replica_plane(tmp_path):
    """A single-process service has no replica plane: SL608 reports
    ``no_data``."""
    from hyperopt_tpu_torch.service import OptimizationService

    svc = OptimizationService(root=str(tmp_path / "r"), device="cpu",
                              warmup=False)
    try:
        rows = {r["rule"]: r for r in svc.alerts()["rules"]}
        assert rows["SL608"]["status"] == "no_data"
    finally:
        _drain(svc)
