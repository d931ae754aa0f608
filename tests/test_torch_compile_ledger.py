"""The port's compile plane (``hyperopt_tpu_torch.compile_ledger``): the
persistent compile ledger, the ledger-driven warmup behind /readyz, and
cold-request containment — the JAX package's ``tests/test_compile_ledger.py``
on the CPU, with its XLA cases recast to the port's compile event (the
first dispatch in the process of a program key, ``tpe_device.program_key``)
and its persistent XLA cache to the kernel-library directory.

- the ledger's on-disk format is crash-consistent: per-record CRC +
  leading-newline resync (torn tail, real mid-write SIGKILL);
- a ledger written under a different torch/kernel fingerprint must
  never mark buckets warm (version invalidation);
- a ledger record is self-sufficient for replay: zero-filled arguments
  at the recorded shapes rebuild the EXACT program key, so a restarted
  server can pre-warm with no study state at all;
- the warmup driver replays ledger + predicted (dry-prepare) grids
  through the real dispatch path (on the service's scheduler thread),
  /readyz gates on it, and its progress rides the 503 body + GET
  /v1/warmup;
- cold containment serves an unwarmed suggest host-side (tagged
  served_cold) and warms its program next on the scheduler thread;
- SL607 pages on post-ready cold-compile rate, never on warmup's own
  compile events;
- the compile-event attribution key equals the JAX package's for the
  same history.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from hyperopt_tpu_torch import compile_ledger, hp
from hyperopt_tpu_torch.algos import rand, tpe, tpe_device
from hyperopt_tpu_torch.base import JOB_STATE_DONE, STATUS_OK, Domain, Trials

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPACE = {
    "x": hp.uniform("x", -5, 5),
    "c": hp.choice("c", ["a", "b"]),
}

ALGO_PARAMS = {"n_startup_jobs": 2, "n_EI_candidates": 16}


def _history_trials(n=6, seed=0):
    domain = Domain(lambda cfg: 0.0, SPACE)
    trials = Trials()
    rng = np.random.default_rng(seed)
    for i in range(n):
        (doc,) = rand.suggest([i], domain, trials, i, device="cpu")
        doc["state"] = JOB_STATE_DONE
        doc["result"] = {"status": STATUS_OK, "loss": float(rng.normal())}
        trials._insert_trial_docs([doc])
        trials.refresh()
    return domain, trials


def _prepared_requests(domain, trials, n_cand=16):
    prep = tpe.suggest_prepare(
        [999], domain, trials, 0, n_startup_jobs=2, n_EI_candidates=n_cand,
        device="cpu",
    )
    assert prep is not None
    return prep[0]


# ---------------------------------------------------------------------
# ledger format + crash consistency
# ---------------------------------------------------------------------


class TestLedgerFormat:
    def _record_one(self, ledger, domain=None, trials=None, n_cand=16):
        if domain is None:
            domain, trials = _history_trials()
        requests = _prepared_requests(domain, trials, n_cand=n_cand)
        sig = tpe_device._multi_sig(requests)
        shapes = tpe_device.args_shapes([a for _, a, _ in requests])
        return ledger.record_compile(
            sig, shapes, duration_s=1.25, cache_hit=False, n_requests=1
        )

    def test_roundtrip_latest_per_key(self, tmp_path):
        path = str(tmp_path / "ledger.jsonl")
        ledger = compile_ledger.CompileLedger(path)
        domain, trials = _history_trials()
        rec = self._record_one(ledger, domain, trials)
        # same program again: latest record wins, no duplicate entry
        ledger.record_compile(
            rec["sig"], rec["shapes"], duration_s=0.5, cache_hit=True
        )
        assert len(ledger) == 1
        # a DIFFERENT program (different candidate count -> statics)
        self._record_one(ledger, domain, trials, n_cand=32)
        assert len(ledger) == 2

        loaded = compile_ledger.CompileLedger(path)
        assert len(loaded) == 2
        assert loaded.n_torn_lines == 0
        by_key = {e["replay_key"]: e for e in loaded.entries()}
        assert by_key[rec["replay_key"]]["duration_s"] == 0.5
        assert by_key[rec["replay_key"]]["cache_hit"] is True
        grid = loaded.grid()
        assert all(isinstance(k[0], int) and k[1] for k in grid)

    def test_torn_tail_resync(self, tmp_path):
        path = str(tmp_path / "ledger.jsonl")
        ledger = compile_ledger.CompileLedger(path)
        domain, trials = _history_trials()
        self._record_one(ledger, domain, trials, n_cand=16)
        self._record_one(ledger, domain, trials, n_cand=32)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 11)
        loaded = compile_ledger.CompileLedger(path)
        assert loaded.n_torn_lines == 1
        assert len(loaded) == 1
        # the next append's leading newline re-synchronizes the reader
        self._record_one(loaded, domain, trials, n_cand=64)
        again = compile_ledger.CompileLedger(path)
        assert again.n_torn_lines == 1
        assert len(again) == 2

    def test_survives_midwrite_sigkill(self, tmp_path):
        """A writer SIGKILL'd at a random moment leaves at most one
        torn record; everything before it loads clean."""
        path = str(tmp_path / "ledger.jsonl")
        child = subprocess.Popen(
            [sys.executable, "-c", f"""
import sys; sys.path.insert(0, {REPO!r})
from hyperopt_tpu_torch import compile_ledger
led = compile_ledger.CompileLedger({path!r})
sig = [["cont", [["cap_b", 4], ["k", 1]]]]
i = 0
while True:
    shapes = [[[[i % 7 + 1, 8], "float32"]]]
    led.record_compile(sig, shapes, duration_s=0.1 * i)
    i += 1
"""],
        )
        try:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if os.path.exists(path) and os.path.getsize(path) > 4096:
                    break
                time.sleep(0.02)
            child.send_signal(signal.SIGKILL)
            child.wait(timeout=30)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=10)
        assert os.path.getsize(path) > 0
        loaded = compile_ledger.CompileLedger(path)
        assert loaded.n_torn_lines <= 1
        assert len(loaded) >= 1
        # the survivors parse into well-formed records
        for e in loaded.entries():
            assert "replay_key" in e and "duration_s" in e

    def test_compaction_keeps_live_entries(self, tmp_path):
        path = str(tmp_path / "ledger.jsonl")
        ledger = compile_ledger.CompileLedger(path)
        sig = [["cont", [["cap_b", 4], ["k", 1]]]]
        shapes = [[[[4, 8], "float32"]]]
        for i in range(3 * compile_ledger.COMPACT_APPEND_FACTOR):
            ledger.record_compile(sig, shapes, duration_s=float(i))
        assert len(ledger) == 1
        raw = open(path, "rb").read()
        records, torn = __import__(
            "hyperopt_tpu_torch.tracing", fromlist=["parse_trace_log"]
        ).parse_trace_log(raw)
        assert torn == 0
        # compacted at least once: far fewer lines than appends
        assert len(records) < 2 * compile_ledger.COMPACT_APPEND_FACTOR
        assert compile_ledger.CompileLedger(path).entries()[0][
            "duration_s"
        ] == float(3 * compile_ledger.COMPACT_APPEND_FACTOR - 1)

    def test_fingerprint_invalidation(self, tmp_path):
        """A stale ledger (older torch or kernels / different backend) must
        not mark buckets warm: entries() filters, and the warmup driver
        skips."""
        path = str(tmp_path / "ledger.jsonl")
        ledger = compile_ledger.CompileLedger(path)
        domain, trials = _history_trials()
        requests = _prepared_requests(domain, trials)
        sig = tpe_device._multi_sig(requests)
        shapes = tpe_device.args_shapes([a for _, a, _ in requests])
        stale_fp = {"version": "0.0.0", "torch": "0.0.1", "backend": "cuda"}
        ledger.record_compile(sig, shapes, duration_s=9.0, fp=stale_fp)
        current = compile_ledger.fingerprint()
        assert ledger.entries() and not ledger.entries(
            current_fingerprint=current
        )
        driver = compile_ledger.WarmupDriver(ledger=ledger, device="cpu")
        assert driver.plan() == []
        driver.start()
        assert driver.wait(30)
        assert driver.progress_brief()["total"] == 0
        # the same record stamped with the CURRENT fingerprint replays
        ledger2 = compile_ledger.CompileLedger(str(tmp_path / "l2.jsonl"))
        ledger2.record_compile(sig, shapes, duration_s=9.0, fp=current)
        driver2 = compile_ledger.WarmupDriver(ledger=ledger2, device="cpu")
        plan = driver2.plan()
        assert len(plan) == 1
        assert plan[0]["source"] == "ledger"


# ---------------------------------------------------------------------
# replay identity + warm-key tracking
# ---------------------------------------------------------------------


class TestReplayIdentity:
    def test_requests_from_record_not_replayable(self):
        rr = compile_ledger.requests_from_record
        assert rr({}, device="cpu") is None
        assert rr({"sig": [["cont", []]], "shapes": []}, device="cpu") is None
        # a mesh-sharded program never replays from JSON
        rec = {
            "sig": [["cont", [["mesh", "Mesh(dp=4)"], ["k", 1]]]],
            "shapes": [[[[4, 8], "float32"]]],
        }
        assert rr(rec, device="cpu") is None
        # nor with a dtype torch does not have
        ok = {"sig": [["cont", [["k", 1]]]], "shapes": [[[[4, 8], "float32"]]]}
        assert rr(ok, device="cpu") is not None
        bad = {"sig": [["cont", [["k", 1]]]], "shapes": [[[[4, 8], "bfloat99"]]]}
        assert rr(bad, device="cpu") is None

    def test_replay_reproduces_program_identity(self, tmp_path):
        """Zero-filled args at the recorded shapes map to the same
        program key the live dispatch had — and dispatching the replay of
        a warm program is no compile event."""
        path = str(tmp_path / "ledger.jsonl")
        ledger = compile_ledger.CompileLedger(path)
        recorder = compile_ledger.CompileLedgerRecorder(ledger).install()
        try:
            domain, trials = _history_trials()
            requests = _prepared_requests(domain, trials)
            if tpe_device.is_warm(requests):  # an earlier test dispatched it
                tpe_device.reset_device_state()
                requests = _prepared_requests(domain, trials)
            assert not tpe_device.is_warm(requests)
            tpe_device.multi_family_suggest_async(requests)()
            assert tpe_device.is_warm(requests)
            assert len(ledger) == 1
            (rec,) = compile_ledger.CompileLedger(path).entries()
            replay = compile_ledger.requests_from_record(rec, device="cpu")
            assert replay is not None
            assert tpe_device.is_warm(replay)
            n_before = len(ledger)
            tpe_device.multi_family_suggest_async(replay)()
            assert len(ledger) == n_before, "replay of a warm program was a compile event"
            # the recorder stamped the shared attribution key
            assert (rec["bucket"], rec["families"]) in [
                (int(b), f) for (b, f) in ledger.grid()
            ]
            assert rec["duration_s"] > 0
        finally:
            recorder.uninstall()

    def test_reset_device_state_clears_warm_keys(self):
        domain, trials = _history_trials(seed=3)
        requests = _prepared_requests(domain, trials, n_cand=24)
        tpe_device.multi_family_suggest_async(requests)()
        assert tpe_device.is_warm(requests)
        tpe_device.reset_device_state()
        assert not tpe_device.is_warm(requests)

    def test_fused_is_warm_canonical_order(self):
        d1, t1 = _history_trials(seed=11)
        d2, t2 = _history_trials(n=10, seed=12)
        g1 = _prepared_requests(d1, t1, n_cand=48)
        g2 = _prepared_requests(d2, t2, n_cand=48)
        if tpe_device.fused_is_warm([g1, g2]):
            tpe_device.reset_device_state()
            g1 = _prepared_requests(d1, t1, n_cand=48)
            g2 = _prepared_requests(d2, t2, n_cand=48)
        assert not tpe_device.fused_is_warm([g1, g2])
        tpe_device.multi_study_suggest_async([g1, g2])[0]()
        # batch order must not matter — the fused key is canonical
        assert tpe_device.fused_is_warm([g1, g2])
        assert tpe_device.fused_is_warm([g2, g1])


# ---------------------------------------------------------------------
# warmup behind /readyz (service level)
# ---------------------------------------------------------------------


def _service(root, **kwargs):
    from hyperopt_tpu_torch.service import OptimizationService

    kwargs.setdefault("slo_tick", 3600)
    kwargs.setdefault("device", "cpu")
    return OptimizationService(root=str(root), **kwargs)


def _drive(svc, sid="s1", n=5, seed=0):
    svc.create_study(
        sid, SPACE, seed=seed, algo="tpe", algo_params=ALGO_PARAMS,
        exist_ok=True,
    )
    for _ in range(n):
        (t,) = svc.suggest(sid)
        svc.report(sid, t["tid"], loss=float(t["vals"]["x"]) ** 2)


class TestWarmupService:
    def test_restart_warms_from_ledger_and_prediction(self, tmp_path):
        svc = _service(tmp_path)
        try:
            _drive(svc, n=5)
            assert len(svc.compile_ledger) >= 1
        finally:
            svc.close()
        # the ledger survived on disk next to the studies
        assert os.path.exists(
            os.path.join(str(tmp_path), "compile_ledger.jsonl")
        )
        svc2 = _service(tmp_path)
        try:
            assert svc2.warmup.wait(120)
            status = svc2.warmup_status()
            assert status["finished"] is True
            assert status["total"] >= 1
            states = {i["state"] for i in status["items"]}
            assert states <= {"warm", "skipped"}
            assert any(i["source"] == "ledger" for i in status["items"])
            r = svc2.readiness()
            assert r["ready"] is True
            assert r["warmup"]["finished"] is True
            assert r["warmup"]["warmed"] == r["warmup"]["total"]
            # post-warmup, the recovered study's next suggest is warm:
            # zero cold suggests after ready
            (t,) = svc2.suggest("s1")
            assert t["tid"] is not None
            stats = svc2.stats.summary()
            assert stats["n_cold_after_ready"] == 0
        finally:
            svc2.close()

    def test_prediction_probe_without_ledger(self, tmp_path):
        """With no ledger at all, the dry-prepare probe per recovered
        study still predicts the grid."""
        tpe_device.reset_device_state()  # force a real compile event below
        svc = _service(tmp_path)
        try:
            _drive(svc, n=5)
        finally:
            svc.close()
        ledger_path = os.path.join(str(tmp_path), "compile_ledger.jsonl")
        if os.path.exists(ledger_path):
            os.unlink(ledger_path)
        tpe_device.reset_device_state()
        svc2 = _service(tmp_path)
        try:
            assert svc2.warmup.wait(120)
            status = svc2.warmup_status()
            assert status["total"] >= 1
            assert any(
                i["source"] == "predicted" for i in status["items"]
            )
            assert all(i["state"] == "warm" for i in status["items"])
            # the probe consumed nothing: seed cursor untouched
            study = svc2.registry.get("s1")
            assert study.n_seeds_drawn == study.n_seeds_committed
        finally:
            svc2.close()

    def test_readyz_503_body_reports_warmup_progress(self, tmp_path):
        svc = _service(tmp_path)
        try:
            # hold warmup open artificially (once the startup task has
            # run it): readiness must say 503 WITH warmup progress (the
            # wait_ready-actionable body)
            assert svc.readiness()["ready"] is True
            svc.warmup._done.clear()
            r = svc.readiness()
            assert r["ready"] is False
            assert r["warmup"]["finished"] is False
            assert "warmed" in r["warmup"] and "total" in r["warmup"]
            svc.warmup._done.set()
            assert svc.readiness()["ready"] is True
        finally:
            svc.close()

    def test_warmup_over_http_and_client(self, tmp_path):
        from hyperopt_tpu_torch.service import ServiceClient, ServiceServer

        svc = _service(tmp_path)
        server = ServiceServer(svc).start()
        try:
            client = ServiceClient(server.url)
            ready = client.wait_ready(timeout=60)
            assert ready["warmup"]["finished"] is True
            wu = client.warmup()
            assert wu["finished"] is True
            assert isinstance(wu["items"], list)
            assert wu["ledger"] is not None
            text = client.metrics()
            assert "hyperopt_compile_warmup_total" in text
            assert "hyperopt_compile_warmup_finished 1" in text
            assert "hyperopt_compile_cache_hits_total" in text
        finally:
            server.stop()

    def test_warmup_disabled(self, tmp_path):
        svc = _service(tmp_path, warmup=False)
        try:
            assert svc.warmup.finished
            assert svc.readiness()["ready"] is True
            assert svc.readiness()["warmup"]["enabled"] is False
        finally:
            svc.close()


# ---------------------------------------------------------------------
# cold containment
# ---------------------------------------------------------------------


class TestColdContainment:
    def test_cold_fallback_serves_host_side_then_warms(self, tmp_path):
        tpe_device.reset_device_state()
        svc = _service(tmp_path, cold_fallback=True)
        try:
            svc.create_study(
                "cold", SPACE, seed=0, algo="tpe",
                algo_params=ALGO_PARAMS,
            )
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                (t,) = svc.suggest("cold")
                svc.report(
                    "cold", t["tid"], loss=float(t["vals"]["x"]) ** 2
                )
                stats = svc.stats.summary()
                if stats["n_dispatches"] >= 1:
                    break
            stats = svc.stats.summary()
            # the first device-plane suggest hit an unwarmed program:
            # served from the host-side fallback, warmed next on the
            # scheduler thread
            assert stats["n_cold_fallbacks"] >= 1
            # the warm-up dispatch landed and later suggests went
            # through the device plane (batched dispatches happened)
            assert stats["n_dispatches"] >= 1
            # containment kept compile events out of the request path
            # entirely: background warm-ups are excluded from cold
            # attribution (tpe_device.background_compiles), so no
            # request is ever tagged cold
            assert stats["n_cold_suggests"] == 0
            assert stats["phase_seconds"].get("cold_fallback")
        finally:
            svc.close()

    def test_cold_fallback_off_keeps_exact_trajectory(self, tmp_path):
        """Default (containment off): the served trajectory equals the
        serial fmin trajectory — the determinism contract is intact."""
        from hyperopt_tpu_torch.fmin import fmin

        svc = _service(tmp_path / "svc", cold_fallback=False)
        try:
            svc.create_study(
                "det", SPACE, seed=7, algo="tpe", algo_params=ALGO_PARAMS
            )
            got = []
            for _ in range(6):
                (t,) = svc.suggest("det")
                svc.report(
                    "det", t["tid"], loss=float(t["vals"]["x"]) ** 2
                )
                got.append(t["vals"]["x"])
        finally:
            svc.close()
        trials = Trials()
        fmin(
            lambda cfg: cfg["x"] ** 2, SPACE,
            algo=__import__(
                "functools"
            ).partial(tpe.suggest, device="cpu", **ALGO_PARAMS),
            max_evals=6, trials=trials, rstate=np.random.default_rng(7),
            show_progressbar=False,
        )
        ref = [v[0] for v in (
            d["misc"]["vals"]["x"] for d in trials._dynamic_trials
        )]
        np.testing.assert_allclose(got, ref)


# ---------------------------------------------------------------------
# SL607
# ---------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TestSL607:
    def _engine(self, ss, clock):
        from hyperopt_tpu_torch import slo

        return slo.SloEngine(
            service_stats=ss, time_fn=clock, min_window_s=0.0,
            snapshot_interval=1.0,
        )

    def test_cold_before_ready_never_counts(self):
        from hyperopt_tpu_torch.observability import ServiceStats

        ss = ServiceStats()
        clock = _Clock()
        eng = self._engine(ss, clock)
        for _ in range(40):
            ss.record_request("suggest", seconds=0.01, cold=True)
        clock.t = 100.0
        rows = {r["rule"]: r for r in eng.evaluate(force=True)}
        assert rows["SL607"]["status"] == "ok"
        assert rows["SL607"]["value"] == 0.0

    def test_post_ready_cold_rate_breaches(self):
        from hyperopt_tpu_torch.observability import ServiceStats

        ss = ServiceStats()
        clock = _Clock()
        eng = self._engine(ss, clock)
        ss.mark_ready()
        for i in range(40):
            ss.record_request("suggest", seconds=0.01, cold=(i % 2 == 0))
        clock.t = 100.0
        rows = {r["rule"]: r for r in eng.evaluate(force=True)}
        assert rows["SL607"]["status"] == "breach"
        assert rows["SL607"]["value"] == pytest.approx(0.5)

    def test_quiet_window_with_cold_suggest_still_counts(self):
        from hyperopt_tpu_torch.observability import ServiceStats

        ss = ServiceStats()
        clock = _Clock()
        eng = self._engine(ss, clock)
        ss.mark_ready()
        for _ in range(3):
            ss.record_request("suggest", seconds=0.01, cold=True)
        clock.t = 100.0
        rows = {r["rule"]: r for r in eng.evaluate(force=True)}
        # 3 cold / floor-of-20 = 15% >> 1% budget: a compile storm in a
        # quiet window must not hide behind the traffic floor
        assert rows["SL607"]["status"] == "breach"

    def test_no_traffic_is_no_data(self):
        from hyperopt_tpu_torch.observability import ServiceStats

        ss = ServiceStats()
        clock = _Clock()
        eng = self._engine(ss, clock)
        clock.t = 100.0
        rows = {r["rule"]: r for r in eng.evaluate(force=True)}
        assert rows["SL607"]["status"] == "no_data"


# ---------------------------------------------------------------------
# race-lint registration
# ---------------------------------------------------------------------


def test_compile_ledger_registered_for_race_lint():
    """The port's own race lint passes on its ledger module."""
    from hyperopt_tpu_torch.analysis import lint_file

    path = os.path.join(REPO, "hyperopt_tpu_torch", "compile_ledger.py")
    assert lint_file(path) == []


# ---------------------------------------------------------------------
# the port's compile event
# ---------------------------------------------------------------------


def test_compile_event_is_the_first_dispatch_of_a_program_key():
    """The compile observers fire once per program key per process (and
    again after ``reset_device_state``), on the launching thread, with
    the dispatch's launch time; the service counts the same events and
    tags the requests that waited on one cold."""
    domain, trials = _history_trials(seed=21)
    requests = _prepared_requests(domain, trials, n_cand=40)
    tpe_device.reset_device_state()
    events = []

    def observe(sig, shapes, launch_s):
        events.append((tpe_device.compile_key(sig, shapes), launch_s))

    tpe_device._trace_observers.append(observe)
    try:
        requests = _prepared_requests(domain, trials, n_cand=40)
        tpe_device.multi_family_suggest_async(requests)()
        tpe_device.multi_family_suggest_async(requests)()
        assert len(events) == 1 and events[0][1] > 0
        assert events[0][0] == tpe_device.compile_key(
            *tpe_device.program_key(requests))
        tpe_device.reset_device_state()
        requests = _prepared_requests(domain, trials, n_cand=40)
        tpe_device.multi_family_suggest_async(requests)()
        assert len(events) == 2
    finally:
        tpe_device._trace_observers.remove(observe)


def test_service_cold_flags_count_the_compile_events(tmp_path):
    """``ServiceStats.n_compile_events``, the cold suggests and the
    ledger's records are one count: each compile event of the request
    path is one cold suggest and one ledger record."""
    tpe_device.reset_device_state()
    svc = _service(tmp_path, warmup=False)
    try:
        _drive(svc, n=8)
        s = svc.stats.summary()
        n_events = svc.stats.n_compile_events
        assert n_events >= 1
        assert s["n_cold_suggests"] == n_events
        assert sum(svc.stats.compile_events().values()) == n_events
        assert len(svc.compile_ledger) == n_events
        assert s["suggest_latency_warm"]["count"] + s["suggest_latency_cold"]["count"] == 8
    finally:
        svc.close()


def test_attribution_key_equals_the_jax_packages():
    """The same history through both packages' prepare: the compile
    event's (trial-count bucket, families) key is the reference's."""
    import copy

    import hyperopt_tpu as J

    for n in (3, 6, 9, 17):
        domain, trials = _history_trials(n=n, seed=n)
        requests = _prepared_requests(domain, trials)
        jspace = {"x": J.hp.uniform("x", -5, 5), "c": J.hp.choice("c", ["a", "b"])}
        jdomain = J.Domain(lambda cfg: 0.0, jspace)
        jtrials = J.trials_from_docs(copy.deepcopy(trials._dynamic_trials))
        jreq, _ = J.tpe.suggest_prepare([999], jdomain, jtrials, 0, n_startup_jobs=2,
                                        n_EI_candidates=16)
        jtd = J.algos.tpe_device
        jkey = jtd.compile_key(jtd._multi_sig(jreq),
                               jtd.args_shapes([a for _, a, _ in jreq]))
        assert tpe_device.compile_key(*tpe_device.program_key(requests)) == jkey


def test_persistent_cache_dir_moves_the_kernel_library_directory(tmp_path):
    from hyperopt_tpu_torch.ops import kernel_build

    before = kernel_build.BUILD_DIR
    try:
        assert compile_ledger.enable_persistent_cache(str(tmp_path / "kc"))
        assert kernel_build.BUILD_DIR == (tmp_path / "kc").resolve()
        assert kernel_build.library_path("pair_score").parent == kernel_build.BUILD_DIR
        assert set(compile_ledger.cache_event_counts()) == {"hits", "misses"}
    finally:
        kernel_build.set_build_dir(before)
