"""The port's optimization service (``hyperopt_tpu_torch.service``)
against the JAX package's, on the CPU.

The JAX package's ``tests/test_service.py`` run against the port with
``device="cpu"`` (all but its replica classes, which wait for the
replica plane): determinism against serial ``fmin``, continuous
batching, backpressure, durability and restart, the HTTP plane and the
CLI (``python -m hyperopt_tpu_torch.service --device cpu``), stats,
idempotency, client retries, readiness and ``kill -9`` recovery.  Then
what only the port has to show: served docs equal to the JAX service's
where the streams are comparable (``rand``, ``anneal``, ``tpe`` with
JAX's uniforms injected), study directories read across the packages,
``decode_space`` refusing a JAX blob, the card requirement, and the
batched dispatch's compile events.

Every wait has a bound and every server, thread and process is stopped
in a ``finally``; no assertion follows a fixed sleep.
"""

import copy
import json
import os
import signal
import subprocess
import sys
import threading
import time
from functools import partial

import numpy as np
import pytest

import hyperopt_tpu as J
from hyperopt_tpu.service import OptimizationService as JaxService
from hyperopt_tpu_torch import Trials, fmin, hp
from hyperopt_tpu_torch.algos import rand, tpe, tpe_device
from hyperopt_tpu_torch.base import (
    JOB_STATE_DONE,
    JOB_STATE_NEW,
    STATUS_OK,
    Domain,
)
from hyperopt_tpu_torch.fmin import space_eval
from hyperopt_tpu_torch.observability import (
    FaultStats,
    PhaseTimings,
    ServiceStats,
    SpeculationStats,
    render_prometheus,
)
from hyperopt_tpu_torch.service import (
    BackpressureError,
    OptimizationService,
    ServiceClient,
    ServiceServer,
    StudyExists,
    StudyNotFound,
    decode_space,
    encode_space,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120  # the bound of every wait below; none is reached when the code is right


def Svc(**kw):
    """The port's service on the CPU (its default is the card)."""
    kw.setdefault("device", "cpu")
    return OptimizationService(**kw)


# mixed families: continuous, categorical (idx), bounded-quantized
SPACE = {
    "x": hp.uniform("x", -5, 5),
    "c": hp.choice("c", ["a", "b"]),
    "w": hp.quniform("w", 0, 10, 1),
}
AP = {"n_startup_jobs": 4, "n_EI_candidates": 32}


def _objective(cfg):
    return (
        (cfg["x"] - 1.0) ** 2
        + (0.5 if cfg["c"] == "b" else 0.0)
        + 0.1 * cfg["w"]
    )


def _drive(svc, study_id, n, objective=_objective):
    """Serial suggest→evaluate→report client loop against the core."""
    out = []
    for _ in range(n):
        (t,) = svc.suggest(study_id, n=1)
        out.append(t)
        point = space_eval(SPACE, t["vals"])
        svc.report(study_id, t["tid"], loss=objective(point))
    return out


def _serial_fmin_vals(seed, max_evals, ap=AP):
    trials = Trials()
    fmin(
        _objective, SPACE, algo=partial(tpe.suggest, device="cpu", **ap),
        max_evals=max_evals, trials=trials,
        rstate=np.random.default_rng(seed), show_progressbar=False,
        verbose=False, max_speculation=0,
    )
    return [
        {k: v[0] for k, v in t["misc"]["vals"].items() if len(v)}
        for t in trials.trials
    ]


# ---------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------


class TestDeterminism:
    def test_single_study_reproduces_serial_fmin(self):
        ref = _serial_fmin_vals(seed=42, max_evals=12)
        svc = Svc(root=None, batch_window=0.001)
        try:
            svc.create_study("s", SPACE, seed=42, algo="tpe",
                             algo_params=AP)
            got = _drive(svc, "s", 12)
        finally:
            svc.close()
        assert len(ref) == len(got) == 12
        for i, (rv, g) in enumerate(zip(ref, got)):
            assert rv.keys() == g["vals"].keys(), (i, rv, g)
            for k in rv:
                assert np.isclose(rv[k], g["vals"][k]), (i, k, rv, g)

    def test_batched_dispatch_identical_to_unbatched(self):
        """Two studies' suggests launched as ONE batched dispatch equal
        the two unbatched tpe.suggest calls bit-for-bit — batching changes
        the carrier dispatch, never the result."""
        def mk_trials(seed, n=6):
            domain = Domain(lambda c: 0.0, SPACE)
            trials = Trials()
            rng = np.random.default_rng(seed)
            for i in range(n):
                docs = rand.suggest([i], domain, trials,
                                    int(rng.integers(2 ** 31 - 1)),
                                    device="cpu")
                docs[0]["state"] = JOB_STATE_DONE
                docs[0]["result"] = {
                    "status": STATUS_OK, "loss": float(rng.normal()),
                }
                trials.insert_trial_docs(docs)
                trials.refresh()
            return domain, trials

        da, ta = mk_trials(0)
        db, tb = mk_trials(1, n=9)  # different history sizes on purpose
        kw = dict(n_startup_jobs=4, n_EI_candidates=32, device="cpu")
        direct_a = tpe.suggest([6], da, ta, 123, **kw)
        direct_b = tpe.suggest([9, 10], db, tb, 456, **kw)

        prep_a = tpe.suggest_prepare([6], da, ta, 123, **kw)
        prep_b = tpe.suggest_prepare([9, 10], db, tb, 456, **kw)
        assert prep_a is not None and prep_b is not None
        res_a, res_b = tpe_device.multi_study_suggest_async(
            [prep_a[0], prep_b[0]]
        )
        batched_b = prep_b[1](res_b())  # resolve out of order on purpose
        batched_a = prep_a[1](res_a())

        for direct, batched in ((direct_a, batched_a),
                                (direct_b, batched_b)):
            assert len(direct) == len(batched)
            for d, b in zip(direct, batched):
                assert d["misc"]["vals"] == b["misc"]["vals"]

    def test_prepare_returns_none_on_startup(self):
        domain = Domain(lambda c: 0.0, SPACE)
        trials = Trials()
        assert tpe.suggest_prepare([0], domain, trials, 0,
                                   device="cpu") is None


# ---------------------------------------------------------------------
# continuous batching + backpressure
# ---------------------------------------------------------------------


class TestScheduler:
    def test_concurrent_studies_batch(self):
        svc = Svc(root=None, batch_window=0.02)
        n_studies, n_trials = 6, 7
        try:
            for i in range(n_studies):
                svc.create_study(f"s{i}", SPACE, seed=i, algo="tpe",
                                 algo_params=AP)
            errors = []

            def worker(sid):
                try:
                    _drive(svc, sid, n_trials)
                except Exception as e:  # pragma: no cover - debug aid
                    errors.append(e)

            threads = [
                threading.Thread(target=worker, args=(f"s{i}",))
                for i in range(n_studies)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors
            s = svc.stats.summary()
        finally:
            svc.close()
        total_requests = s["requests"]["suggest"]
        assert total_requests == n_studies * n_trials
        # the startup suggests are host-side; the TPE ones all went
        # through fused dispatches, and batching means strictly fewer
        # dispatches than device-plane requests
        assert s["n_batched_suggests"] == total_requests - s["n_inline_suggests"]
        assert s["n_dispatches"] < s["n_batched_suggests"]
        assert s["mean_batch_occupancy"] > 1.0
        # every study completed every trial — nothing dropped
        for i in range(n_studies):
            assert svc.study_status(f"s{i}")["n_completed"] == n_trials

    def test_backpressure_rejects_without_side_effects(self):
        svc = Svc(root=None, max_queue=0)
        try:
            svc.create_study("s", SPACE, seed=0, algo_params=AP)
            study = svc.registry.get("s")
            with pytest.raises(BackpressureError):
                svc.suggest("s", n=1)
            # no ids were allocated, no seed drawn: retry is safe
            assert study.n_seeds_drawn == 0
            assert len(study.trials._dynamic_trials) == 0
            assert svc.stats.summary()["rejected"]["suggest"] == 1
        finally:
            svc.close()

    def test_registry_full_is_backpressure(self):
        svc = Svc(root=None, max_studies=1)
        try:
            svc.create_study("a", SPACE)
            with pytest.raises(BackpressureError):
                svc.create_study("b", SPACE)
        finally:
            svc.close()

    def test_nan_loss_rejected_at_report(self):
        # a diverged trial is a FAILED trial at this API: NaN/inf would
        # poison best-trial math and render as invalid JSON downstream
        svc = Svc(root=None)
        try:
            svc.create_study("n", SPACE, seed=0)
            (t,) = svc.suggest("n")
            with pytest.raises(ValueError, match="non-finite"):
                svc.report("n", t["tid"], loss=float("nan"))
            svc.report("n", t["tid"], status="fail")  # the sanctioned path
            st = svc.study_status("n")
            assert st["best"] is None
        finally:
            svc.close()

    def test_rejected_create_leaves_no_orphan_dir(self, tmp_path):
        root = str(tmp_path / "r")
        svc = Svc(root=root)
        try:
            with pytest.raises(ValueError):
                svc.create_study("typo", SPACE, algo_params={"bogus": 1})
            assert not os.path.exists(
                os.path.join(root, "studies", "typo")
            )
        finally:
            svc.close()
        # and a fresh server recovers cleanly (nothing to trip over)
        svc2 = Svc(root=root)
        try:
            assert svc2.list_studies() == []
        finally:
            svc2.close()

    def test_bad_space_leaves_no_orphan_dir(self, tmp_path):
        # a space that fails Domain construction (duplicate labels
        # assembled without hp.* validation) must reject BEFORE any
        # disk side effect — no orphan study dir for _recover()
        root = str(tmp_path / "r")
        dup_space = {"a": hp.uniform("x", 0, 1), "b": hp.uniform("x", 0, 1)}
        svc = Svc(root=root)
        try:
            with pytest.raises(Exception):
                svc.create_study("dup", dup_space)
            assert not os.path.exists(os.path.join(root, "studies", "dup"))
        finally:
            svc.close()

    def test_registry_full_counts_as_rejection(self):
        svc = Svc(root=None, max_studies=1)
        try:
            svc.create_study("a", SPACE)
            with pytest.raises(BackpressureError):
                svc.create_study("b", SPACE)
            assert svc.stats.summary()["rejected"] == {"create_study": 1}
        finally:
            svc.close()

    def test_bad_algo_params_rejected_at_create(self):
        # a typo'd keyword must fail the CREATE (400), not poison every
        # batch its suggests later land in (multi-tenant isolation)
        svc = Svc(root=None)
        try:
            with pytest.raises(ValueError, match="bogus"):
                svc.create_study("b", SPACE, algo_params={"bogus": 1})
        finally:
            svc.close()

    def test_invalid_study_id_rejected(self):
        svc = Svc(root=None)
        try:
            for bad in ("a/b", "a b", "", ".", "a?b", "x" * 200):
                with pytest.raises(ValueError):
                    svc.create_study(bad, SPACE)
        finally:
            svc.close()

    def test_one_studys_failure_does_not_fail_batchmates(self):
        """A per-study finish/prepare exception fails only that pending;
        other studies coalesced into the same batch complete."""
        svc = Svc(root=None, batch_window=0.05)
        try:
            svc.create_study("good", SPACE, seed=0, algo_params=AP)
            svc.create_study("sick", SPACE, seed=1, algo_params=AP)
            # warm both past startup so both take the device path
            for sid in ("good", "sick"):
                _drive(svc, sid, AP["n_startup_jobs"] + 1)
            # break the sick study's prepare only
            sick = svc.registry.get("sick")
            def broken_prepare(ids, seed):
                raise RuntimeError("synthetic study-local failure")
            sick.prepare = broken_prepare
            results = {}

            def call(sid):
                try:
                    results[sid] = svc.suggest(sid, timeout=60)
                except Exception as e:
                    results[sid] = e

            threads = [threading.Thread(target=call, args=(sid,))
                       for sid in ("good", "sick")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads)
            assert isinstance(results["sick"], RuntimeError)
            assert isinstance(results["good"], list) and results["good"]
        finally:
            svc.close()

    def test_study_errors(self):
        svc = Svc(root=None)
        try:
            with pytest.raises(StudyNotFound):
                svc.suggest("nope")
            svc.create_study("a", SPACE)
            with pytest.raises(StudyExists):
                svc.create_study("a", SPACE)
            again = svc.create_study("a", SPACE, exist_ok=True)
            assert again["study_id"] == "a"
        finally:
            svc.close()

    def test_exist_ok_rejects_config_mismatch(self):
        svc = Svc(root=None)
        try:
            svc.create_study("a", SPACE, seed=0, algo_params=AP)
            # same config attaches...
            svc.create_study("a", SPACE, seed=0, algo_params=AP,
                             exist_ok=True)
            # ...but a different space/seed/algo is a 409, not a silent
            # attach serving suggestions from the OLD config
            other_space = {"x": hp.uniform("x", -1, 1)}
            with pytest.raises(StudyExists, match="DIFFERENT"):
                svc.create_study("a", other_space, seed=0,
                                 algo_params=AP, exist_ok=True)
            with pytest.raises(StudyExists, match="DIFFERENT"):
                svc.create_study("a", SPACE, seed=1, algo_params=AP,
                                 exist_ok=True)
        finally:
            svc.close()

    def test_exist_ok_matches_across_http_roundtrip(self):
        # the space crosses the wire as a pickle blob; two decodes of
        # the same client-side space must still compare equal
        with ServiceServer(Svc(root=None)) as server:
            c1 = ServiceClient(server.url)
            c2 = ServiceClient(server.url)
            c1.create_study("h", SPACE, seed=3, algo_params=AP)
            st = c2.create_study("h", SPACE, seed=3, algo_params=AP,
                                 exist_ok=True)
            assert st["study_id"] == "h"

    def test_failed_suggest_does_not_desync_seed_cursor(self, tmp_path):
        """A suggest that fails after its seed draw must not shift the
        restart fast-forward: later committed draws advance the cursor
        PAST the failed position (a seed an existing trial used can
        never be re-issued)."""
        root = str(tmp_path / "r")
        svc = Svc(root=root, batch_window=0.001)
        try:
            svc.create_study("s", SPACE, seed=9, algo_params=AP)
            study = svc.registry.get("s")
            _drive(svc, "s", AP["n_startup_jobs"] + 1)  # past startup
            # suggest that fails AFTER the seed draw (prepare breaks)
            real_prepare = study.prepare
            def broken(ids, seed):
                raise RuntimeError("study-local failure")
            study.prepare = broken
            with pytest.raises(RuntimeError):
                svc.suggest("s")
            study.prepare = real_prepare
            ok = _drive(svc, "s", 1)  # commits a LATER draw position
            n_drawn = study.n_seeds_drawn
        finally:
            svc.close()
        svc2 = Svc(root=root, batch_window=0.001)
        try:
            recovered = svc2.registry.get("s")
            # the failed draw sits between committed ones: the cursor
            # must cover it, so the next suggest continues the stream
            assert recovered.n_seeds_drawn == n_drawn
            (t,) = svc2.suggest("s")
            assert t["tid"] > ok[0]["tid"]
        finally:
            svc2.close()

    def test_studies_gauge_set_after_recovery(self, tmp_path):
        root = str(tmp_path / "r")
        svc = Svc(root=root)
        try:
            svc.create_study("g", SPACE)
        finally:
            svc.close()
        svc2 = Svc(root=root)
        try:
            assert svc2.stats.summary()["n_studies"] == 1
        finally:
            svc2.close()

    def test_rand_algo_serves_inline(self):
        svc = Svc(root=None)
        try:
            svc.create_study("r", SPACE, seed=7, algo="rand")
            _drive(svc, "r", 5)
            s = svc.stats.summary()
            assert s["n_inline_suggests"] == 5
            assert s["n_dispatches"] == 0
        finally:
            svc.close()

    def test_error_report_excluded_from_history(self):
        svc = Svc(root=None)
        try:
            svc.create_study("e", SPACE, seed=0, algo_params=AP)
            (t,) = svc.suggest("e")
            svc.report("e", t["tid"], status="fail")
            st = svc.study_status("e")
            assert st["n_completed"] == 0
            assert st["n_trials"] == 1
            # the run continues past the failure
            (t2,) = svc.suggest("e")
            assert t2["tid"] == t["tid"] + 1
        finally:
            svc.close()


# ---------------------------------------------------------------------
# durability: drain + restart recovery
# ---------------------------------------------------------------------


class TestDurability:
    def test_restart_continues_exact_trajectory(self, tmp_path):
        root_split = str(tmp_path / "split")
        root_full = str(tmp_path / "full")
        n_first, n_total = 5, 10

        svc = Svc(root=root_split, batch_window=0.001)
        try:
            svc.create_study("s", SPACE, seed=11, algo_params=AP)
            first = _drive(svc, "s", n_first)
        finally:
            svc.close()  # graceful drain; state is write-through

        # a NEW server process on the same root recovers the study
        svc2 = Svc(root=root_split, batch_window=0.001)
        try:
            assert svc2.list_studies() == ["s"]
            st = svc2.study_status("s")
            assert st["n_completed"] == n_first
            assert st["n_suggests"] == n_first
            rest = _drive(svc2, "s", n_total - n_first)
        finally:
            svc2.close()

        # the uninterrupted twin
        svc3 = Svc(root=root_full, batch_window=0.001)
        try:
            svc3.create_study("s", SPACE, seed=11, algo_params=AP)
            full = _drive(svc3, "s", n_total)
        finally:
            svc3.close()

        got = first + rest
        assert len(got) == len(full) == n_total
        for i, (g, f) in enumerate(zip(got, full)):
            assert g["tid"] == f["tid"]
            assert g["vals"].keys() == f["vals"].keys(), (i, g, f)
            for k in g["vals"]:
                assert np.isclose(g["vals"][k], f["vals"][k]), (i, k, g, f)

    def test_suggested_but_unreported_trials_survive(self, tmp_path):
        root = str(tmp_path / "r")
        svc = Svc(root=root, batch_window=0.001)
        try:
            svc.create_study("s", SPACE, seed=3)
            (t,) = svc.suggest("s")
        finally:
            svc.close()
        svc2 = Svc(root=root)
        try:
            st = svc2.study_status("s")
            assert st["n_trials"] == 1
            assert st["states"][str(JOB_STATE_NEW)] == 1
            # the doc is recoverable: reporting it after restart works
            svc2.report("s", t["tid"], loss=1.0)
            assert svc2.study_status("s")["n_completed"] == 1
        finally:
            svc2.close()

    def test_space_roundtrip(self):
        blob = encode_space(SPACE)
        space2 = decode_space(blob)
        assert set(space2) == set(SPACE)


# ---------------------------------------------------------------------
# HTTP plane
# ---------------------------------------------------------------------


class TestHTTP:
    def test_end_to_end(self, tmp_path):
        with ServiceServer(
            Svc(root=str(tmp_path / "q"),
                                batch_window=0.004)
        ) as server:
            client = ServiceClient(server.url)
            assert client.healthz()
            client.create_study("h1", SPACE, seed=0, algo_params=AP)
            client.create_study("h2", SPACE, seed=1, algo_params=AP)
            assert client.list_studies() == ["h1", "h2"]
            for sid in ("h1", "h2"):
                for _ in range(6):
                    (t,) = client.suggest(sid)
                    point = space_eval(SPACE, t["vals"])
                    client.report(sid, t["tid"], loss=_objective(point))
            st = client.study_status("h1")
            assert st["n_completed"] == 6
            assert st["best"] is not None
            metrics = client.metrics()
            assert "hyperopt_service_requests_total" in metrics
            assert 'endpoint="suggest"' in metrics
            assert "hyperopt_service_batch_occupancy" in metrics
            status = client.service_status()
            assert status["studies"] == 2
            assert status["stats"]["requests"]["suggest"] == 12

    def test_http_backpressure_is_retryable_429(self):
        with ServiceServer(
            Svc(root=None, max_queue=0)
        ) as server:
            client = ServiceClient(server.url, retry_timeout=0.0)
            client.create_study("s", SPACE)
            with pytest.raises(BackpressureError):
                client.suggest("s")

    def test_http_error_mapping(self):
        from hyperopt_tpu_torch.service import ServiceClientError

        with ServiceServer(Svc(root=None)) as server:
            client = ServiceClient(server.url)
            with pytest.raises(ServiceClientError) as e:
                client.study_status("missing")
            assert e.value.status == 404
            client.create_study("s", SPACE)
            # a conflicting config is a 409 (an identical keyed create
            # would attach — see TestIdempotency)
            with pytest.raises(ServiceClientError) as e:
                client.create_study("s", SPACE, seed=99)
            assert e.value.status == 409
            with pytest.raises(ServiceClientError) as e:
                client._request("POST", "/v1/studies/s/report",
                                {"no_tid": 1})
            assert e.value.status == 400

    def test_minimize_loop(self):
        with ServiceServer(Svc(root=None)) as server:
            client = ServiceClient(server.url)
            st = client.minimize(
                "m", _objective, SPACE, max_evals=8, seed=5,
                algo_params=AP,
            )
            assert st["n_completed"] == 8
            assert st["best"]["loss"] <= 40.0

    def test_shutdown_endpoint_drains_and_stops(self, tmp_path):
        server = ServiceServer(
            Svc(root=str(tmp_path / "q"))
        ).start()
        client = ServiceClient(server.url)
        client.create_study("s", SPACE)
        client.shutdown()
        # probes that fail at once once the listener is gone
        probe = ServiceClient(server.url, timeout=2, retry_timeout=0,
                              deadline=1.0, max_transport_retries=0)
        deadline = time.monotonic() + 30
        try:
            while time.monotonic() < deadline:
                try:
                    probe.healthz()
                    time.sleep(0.1)
                except Exception:
                    break
            else:
                pytest.fail("server did not stop after /v1/shutdown")
        finally:
            server.stop()  # idempotent
        # new submits are rejected, not hung
        with pytest.raises(Exception):
            probe.healthz()


# ---------------------------------------------------------------------
# CLI (python -m hyperopt_tpu_torch.service) — true subprocess E2E
# ---------------------------------------------------------------------


class TestServiceCLI:
    def test_cli_serves_and_sigterm_drains(self, tmp_path):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
        )
        env["JAX_PLATFORMS"] = "cpu"
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "hyperopt_tpu_torch.service",
                "--root", str(tmp_path / "svc"),
                "--port", "0", "--device", "cpu",
            ],
            env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        try:
            url = proc.stdout.readline().strip()
            assert url.startswith("http://127.0.0.1:"), url
            client = ServiceClient(url)
            client.create_study("cli", SPACE, seed=0, algo="rand")
            (t,) = client.suggest("cli")
            client.report("cli", t["tid"], loss=1.0)
            assert client.study_status("cli")["n_completed"] == 1
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            assert rc == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


# ---------------------------------------------------------------------
# stats + Prometheus rendering (satellite)
# ---------------------------------------------------------------------


class TestServiceStats:
    def test_occupancy_and_latency(self):
        s = ServiceStats()
        assert s.mean_batch_occupancy is None
        s.record_dispatch(3, 0.010)
        s.record_dispatch(1, 0.005)
        assert s.mean_batch_occupancy == 2.0
        for ms in (1, 2, 100):
            s.record_request("suggest", seconds=ms / 1e3, study="a")
        # exported quantiles come from the fixed-bucket histogram:
        # exact at bucket edges, interpolated inside the bucket — the
        # p50 (2 ms) must land inside its (1, 2.5] ms bucket
        q = s.latency_quantiles()
        assert 1.0 <= q["p50_ms"] <= 2.5
        assert q["p99_ms"] > 50
        # the ring keeps the exact recent sample (human JSON only),
        # and says how wide its window is
        w = s.window_quantiles()
        assert w["p50_ms"] == pytest.approx(2.0, abs=0.1)
        assert w["window"] == 3
        assert w["max_window"] == 65536
        summ = s.summary()
        assert summ["study_suggests"] == {"a": 3}
        assert summ["n_dispatches"] == 2
        assert summ["suggest_latency_window"]["window"] == 3
        # a replayed suggest is tagged: counted as a request, kept OUT
        # of the latency histogram and the per-study suggest counter
        s.record_request("suggest", seconds=5.0, study="a", replay=True)
        assert s.summary()["study_suggests"] == {"a": 3}
        assert s.latency_quantiles()["p99_ms"] == q["p99_ms"]

    def test_rejections_and_gauges(self):
        s = ServiceStats()
        s.record_rejection("suggest")
        s.set_queue_depth(5)
        s.set_n_studies(2)
        summ = s.summary()
        assert summ["rejected"] == {"suggest": 1}
        assert summ["queue_depth"] == 5
        assert summ["n_studies"] == 2


class TestIdempotency:
    """The exactly-once protocol: replays are byte-identical and provably
    consume nothing."""

    def test_suggest_replay_consumes_no_seed(self, tmp_path):
        from hyperopt_tpu_torch.service.core import SEED_CURSOR_ATTACHMENT

        svc = Svc(root=str(tmp_path / "r"),
                                  batch_window=0.001)
        try:
            svc.create_study("s", SPACE, seed=4, algo_params=AP)
            p1 = svc.suggest("s", idempotency_key="K")
            study = svc.registry.get("s")
            drawn = study.n_seeds_drawn
            cursor = study.trials.attachments[SEED_CURSOR_ATTACHMENT]
            p2 = svc.suggest("s", idempotency_key="K")
            assert p1 == p2
            assert study.n_seeds_drawn == drawn
            assert (
                study.trials.attachments[SEED_CURSOR_ATTACHMENT] == cursor
            )
            assert len(study.trials._dynamic_trials) == 1
            assert svc.stats.summary()["idempotent_replays"] == {
                "suggest": 1
            }
        finally:
            svc.close()

    def test_report_replay_first_loss_stands(self):
        svc = Svc(root=None)
        try:
            svc.create_study("s", SPACE, seed=0)
            (t,) = svc.suggest("s")
            r1 = svc.report("s", t["tid"], loss=1.5, idempotency_key="R")
            # a buggy retry mutating the loss must NOT double-land
            r2 = svc.report("s", t["tid"], loss=9.9, idempotency_key="R")
            assert r1 == r2
            assert svc.study_status("s")["best"]["loss"] == 1.5
        finally:
            svc.close()

    def test_create_replay_and_conflict_semantics(self):
        svc = Svc(root=None)
        try:
            st1 = svc.create_study("s", SPACE, seed=0,
                                   idempotency_key="C")
            # same key replays (a retried create)...
            st2 = svc.create_study("s", SPACE, seed=0,
                                   idempotency_key="C")
            assert st1 == st2
            # ...a new key with the SAME config attaches (covers the
            # crash window between config persist and journal append —
            # a keyed create is "create exactly this study")...
            st3 = svc.create_study("s", SPACE, seed=0,
                                   idempotency_key="C2")
            assert st3["study_id"] == "s"
            # ...and a config MISMATCH is still a hard 409
            with pytest.raises(StudyExists):
                svc.create_study("s", SPACE, seed=1,
                                 idempotency_key="C3")
            # keyless duplicates keep the strict pre-key contract
            with pytest.raises(StudyExists):
                svc.create_study("s", SPACE, seed=0)
        finally:
            svc.close()

    def test_concurrent_same_key_attaches_to_inflight(self):
        svc = Svc(root=None, batch_window=0.05)
        try:
            svc.create_study("s", SPACE, seed=0, algo_params=AP)
            results = []

            def call():
                results.append(svc.suggest("s", idempotency_key="DUP"))

            threads = [threading.Thread(target=call) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads)
            study = svc.registry.get("s")
            # four racing retries of one logical request: ONE trial
            assert len(study.trials._dynamic_trials) == 1
            assert all(r == results[0] for r in results)
            assert study._inflight == {}  # cleaned up after completion
        finally:
            svc.close()

    def test_key_reuse_across_routes_is_rejected(self):
        """A suggest key replayed on the report route must not serve the
        suggest payload as a 200 report response — wrong shape; it is a
        client bug surfaced as a 400."""
        svc = Svc(root=None)
        try:
            svc.create_study("s", SPACE, seed=0)
            (t,) = svc.suggest("s", idempotency_key="X")
            with pytest.raises(ValueError, match="refusing to replay"):
                svc.report("s", t["tid"], loss=1.0, idempotency_key="X")
            # the sane path still lands
            svc.report("s", t["tid"], loss=1.0, idempotency_key="X-r")
            assert svc.study_status("s")["n_completed"] == 1
        finally:
            svc.close()

    def test_retry_does_not_attach_to_abandoned_pending(self):
        """A pending whose waiter timed out before it started (cancelled,
        nothing consumed) will be abandoned by the scheduler — a retry
        of its key must submit fresh, not inherit the spurious 504."""
        from hyperopt_tpu_torch.service.core import _PendingSuggest

        svc = Svc(root=None)
        try:
            svc.create_study("s", SPACE, seed=0)
            study = svc.registry.get("s")
            stale = _PendingSuggest(study, 1, idempotency_key="K")
            stale.cancelled = True
            with study.lock:
                study._inflight["K"] = stale
            out = svc.suggest("s", idempotency_key="K")
            assert out and "tid" in out[0]
        finally:
            svc.close()

    def test_replay_survives_restart_byte_identical(self, tmp_path):
        root = str(tmp_path / "r")
        svc = Svc(root=root, batch_window=0.001)
        try:
            svc.create_study("s", SPACE, seed=7, algo_params=AP)
            p1 = svc.suggest("s", idempotency_key="K")
            svc.report("s", p1[0]["tid"], loss=2.0, idempotency_key="R")
        finally:
            svc.close()
        svc2 = Svc(root=root, batch_window=0.001)
        try:
            assert svc2.suggest("s", idempotency_key="K") == p1
            study = svc2.registry.get("s")
            assert len(study.trials._dynamic_trials) == 1
            assert study.n_seeds_drawn == 1
        finally:
            svc2.close()

    def test_journal_wal_crash_window_replayed(self, tmp_path):
        """A suggest journaled but never inserted (crash between the
        WAL append and the store insert) is re-applied at startup and
        the seed cursor advances past its draw."""
        import copy

        from hyperopt_tpu_torch.service.core import (
            canonical_json,
            suggest_payload,
        )

        root = str(tmp_path / "r")
        svc = Svc(root=root, batch_window=0.001)
        svc.create_study("s", SPACE, seed=3, algo="rand")
        svc.suggest("s", idempotency_key="a")
        study = svc.registry.get("s")
        doc = copy.deepcopy(study.trials._dynamic_trials[0])
        doc["tid"] = doc["misc"]["tid"] = 1
        doc["misc"]["idxs"] = {k: [1] for k in doc["misc"]["idxs"]}
        doc["misc"]["service_draw"] = 2
        payload = suggest_payload([doc])
        study.journal.record("b", "suggest", canonical_json(payload),
                             docs=[doc], draw_index=2)
        svc.close()
        svc2 = Svc(root=root, batch_window=0.001)
        try:
            info = svc2.registry.recovery_info
            assert info["journal_entries_replayed"] == 1
            s2 = svc2.registry.get("s")
            assert len(s2.trials._dynamic_trials) == 2
            assert s2.n_seeds_drawn == 2
            assert svc2.suggest("s", idempotency_key="b") == payload
        finally:
            svc2.close()

    def test_http_replay_byte_identical(self, tmp_path):
        with ServiceServer(
            Svc(root=str(tmp_path / "q"),
                                batch_window=0.001)
        ) as server:
            client = ServiceClient(server.url)
            client.create_study("s", SPACE, seed=0, algo_params=AP)
            body = {"n": 1, "idempotency_key": "K"}
            st1, b1 = client._request(
                "POST", "/v1/studies/s/suggest", body, raw=True
            )
            st2, b2 = client._request(
                "POST", "/v1/studies/s/suggest", body, raw=True
            )
            assert st1 == st2 == 200
            assert b1 == b2


class TestClientRetry:
    """Transport retries, tolerant Retry-After, circuit breaker."""

    def test_parse_retry_after_tolerates_garbage(self):
        from hyperopt_tpu_torch.service import parse_retry_after

        assert parse_retry_after("0.5") == 0.5
        assert parse_retry_after("3") == 3.0
        default = 0.05
        for bad in (None, "", "soon", "Wed, 21 Oct 2015 07:28:00 GMT",
                    "-1"):
            assert parse_retry_after(bad, default) == default

    def test_malformed_retry_after_does_not_raise(self):
        """A 429 with a garbage Retry-After header must stay inside the
        retry loop (the old float(...) raised straight out of it)."""
        import http.server
        import socketserver

        hits = []

        class Flaky(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                hits.append(1)
                if len(hits) < 3:
                    self.send_response(429)
                    self.send_header("Retry-After", "not-a-number")
                    self.send_header("Content-Length", "2")
                    self.end_headers()
                    self.wfile.write(b"{}")
                else:
                    body = b'{"ok": true}'
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

            def log_message(self, *a):
                pass

        with socketserver.TCPServer(("127.0.0.1", 0), Flaky) as httpd:
            threading.Thread(
                target=httpd.serve_forever, daemon=True
            ).start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            client = ServiceClient(url, retry_timeout=10.0)
            assert client.healthz() is True
            httpd.shutdown()
        assert len(hits) == 3

    def test_get_retries_through_transport_errors(self):
        """A GET against a server that comes up late succeeds once it
        does (satellite: GET routes retry on URLError)."""
        from hyperopt_tpu_torch.service import free_port

        port = free_port()
        service = Svc(root=None)
        server_box = {}

        def start_late():
            time.sleep(1.0)
            server_box["server"] = ServiceServer(
                service, port=port
            ).start()

        starter = threading.Thread(target=start_late, daemon=True)
        starter.start()
        try:
            client = ServiceClient(
                f"http://127.0.0.1:{port}", deadline=30.0,
                backoff_base=0.1, breaker_threshold=50,
            )
            assert client.healthz() is True
        finally:
            starter.join(timeout=WAIT_S)
            if "server" in server_box:
                server_box["server"].stop()
            else:
                service.close()

    def test_mutating_call_without_key_is_not_transport_retried(self):
        from hyperopt_tpu_torch.service import ServiceTransportError, free_port

        port = free_port()  # nothing listening
        client = ServiceClient(
            f"http://127.0.0.1:{port}", deadline=10.0,
            use_idempotency_keys=False,
        )
        t0 = time.monotonic()
        with pytest.raises(ServiceTransportError) as e:
            client.report("s", 0, loss=1.0)
        assert e.value.attempts == 1  # no blind retry without a key
        assert time.monotonic() - t0 < 5.0

    def test_circuit_breaker_opens_and_half_opens(self):
        from hyperopt_tpu_torch.resilience.retry import (
            CircuitBreaker,
            CircuitOpenError,
        )

        clock = [0.0]
        b = CircuitBreaker(threshold=2, cooldown=10.0,
                           clock=lambda: clock[0])
        assert b.before_request() == 0.0
        b.record_failure()
        assert b.state == "closed"
        b.record_failure()
        assert b.state == "open"
        assert b.before_request() == pytest.approx(10.0)
        clock[0] = 10.5  # cooldown elapsed: one probe allowed
        assert b.state == "half-open"
        assert b.before_request() == 0.0  # this caller IS the probe
        assert b.before_request() > 0.0  # concurrent callers wait
        b.record_success()
        assert b.state == "closed"
        assert b.before_request() == 0.0
        # and CircuitOpenError carries the wait hint
        err = CircuitOpenError("open", retry_in=2.5)
        assert err.retry_in == 2.5

    def test_client_fails_fast_when_circuit_open(self):
        from hyperopt_tpu_torch.resilience.retry import CircuitOpenError
        from hyperopt_tpu_torch.service import free_port

        port = free_port()  # nothing listening: every dial fails
        client = ServiceClient(
            f"http://127.0.0.1:{port}", deadline=3.0,
            max_transport_retries=50, backoff_base=0.01,
            backoff_max=0.05, breaker_threshold=3,
            breaker_cooldown=60.0,
        )
        with pytest.raises(CircuitOpenError):
            client.list_studies()


class TestReadyz:
    def test_readyz_green_on_fresh_server(self, tmp_path):
        with ServiceServer(
            Svc(root=str(tmp_path / "q"))
        ) as server:
            client = ServiceClient(server.url)
            ready = client.wait_ready(timeout=60)
            assert ready["ready"] is True
            assert ready["recovery_ok"] is True
            # no CPU fallback in the port: "fallback" cannot occur
            assert ready["device"] == "warm"
            assert ready["fsck"]["clean"] is True

    def test_startup_fsck_repairs_torn_segment_then_ready(self, tmp_path):
        root = str(tmp_path / "r")
        svc = Svc(root=root, batch_window=0.001)
        svc.create_study("s", SPACE, seed=1, algo="rand")
        (t,) = svc.suggest("s", idempotency_key="K")
        svc.report("s", t["tid"], loss=3.0, idempotency_key="R")
        svc.close()
        # tear the active segment's tail (latent corruption a restart
        # discovers): clip mid-record so the last append fails its CRC
        seg_dir = os.path.join(root, "studies", "s", "segments")
        manifest = json.loads(
            open(os.path.join(seg_dir, "MANIFEST.json"), "rb")
            .read().split(b"\n#crc32:")[0]
        )
        seg_file = os.path.join(seg_dir, manifest["active"])
        with open(seg_file, "r+b") as f:
            f.truncate(os.path.getsize(seg_file) - 9)
        svc2 = Svc(root=root, batch_window=0.001)
        try:
            ready = svc2.readiness()
            assert ready["ready"] is True
            assert ready["fsck"]["by_rule"].get("FS410") == 1
            # the torn record was the report append: the trial survives
            # (insert record intact); only the unacknowledged-by-crash
            # tail is dropped, exactly torn-write semantics
            st = svc2.study_status("s")
            assert st["n_trials"] == 1
        finally:
            svc2.close()

    def test_draining_server_is_not_ready(self):
        svc = Svc(root=None)
        try:
            assert svc.readiness()["ready"] is True
            svc.drain(timeout=5.0)
            assert svc.readiness()["ready"] is False
        finally:
            svc.close()


class TestKillMinus9:
    """The restart suite beyond graceful SIGTERM — kill -9, restart,
    /readyz green, exact trajectory continues."""

    N_FIRST, N_TOTAL = 4, 10

    def _env(self):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
        )
        env["JAX_PLATFORMS"] = "cpu"
        return env

    def _spawn(self, root, port):
        return subprocess.Popen(
            [
                sys.executable, "-m", "hyperopt_tpu_torch.service",
                "--root", root, "--port", str(port), "--device", "cpu",
            ],
            env=self._env(), cwd=ROOT,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    def _twin_vals(self, seed, n):
        svc = Svc(root=None, batch_window=0.001)
        try:
            svc.create_study("k9", SPACE, seed=seed, algo="rand")
            out = []
            for _ in range(n):
                (t,) = svc.suggest("k9")
                out.append(t["vals"])
                svc.report("k9", t["tid"], loss=1.0)
            return out
        finally:
            svc.close()

    def test_kill9_restart_readyz_exact_trajectory(self, tmp_path):
        from hyperopt_tpu_torch.service import free_port

        twin = self._twin_vals(seed=21, n=self.N_TOTAL)
        root = str(tmp_path / "svc")
        port = free_port()
        proc = self._spawn(root, port)
        got = []
        try:
            client = ServiceClient(
                f"http://127.0.0.1:{port}", deadline=120.0,
                max_transport_retries=100, backoff_max=0.5,
                breaker_threshold=20, breaker_cooldown=0.25,
            )
            client.wait_ready(timeout=120)
            client.create_study("k9", SPACE, seed=21, algo="rand")
            for _ in range(self.N_FIRST):
                (t,) = client.suggest("k9")
                got.append(t["vals"])
                client.report("k9", t["tid"], loss=1.0)
            # kill -9: no drain, no flush beyond the write-through
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
            proc = self._spawn(root, port)
            ready = client.wait_ready(timeout=120)
            assert ready["ready"] is True
            assert ready["recovery"]["recovered_studies"] == 1
            for _ in range(self.N_TOTAL - self.N_FIRST):
                (t,) = client.suggest("k9")
                got.append(t["vals"])
                client.report("k9", t["tid"], loss=1.0)
            st = client.study_status("k9")
            assert st["n_completed"] == self.N_TOTAL
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        assert len(got) == len(twin)
        for i, (g, w) in enumerate(zip(got, twin)):
            assert g.keys() == w.keys(), (i, g, w)
            for k in g:
                assert np.isclose(g[k], w[k]), (i, k, g, w)

    def test_kill9_with_suggest_in_flight_exactly_once(self, tmp_path):
        """A suggest mid-flight when the server dies is retried by the
        client through the restart and lands exactly once."""
        from hyperopt_tpu_torch.service import free_port

        root = str(tmp_path / "svc")
        port = free_port()
        proc = self._spawn(root, port)
        box = {}
        try:
            client = ServiceClient(
                f"http://127.0.0.1:{port}", deadline=180.0,
                max_transport_retries=200, backoff_max=0.5,
                breaker_threshold=20, breaker_cooldown=0.25,
            )
            client.wait_ready(timeout=120)
            client.create_study("k9", SPACE, seed=5, algo="rand")
            (t0_trial,) = client.suggest("k9")
            client.report("k9", t0_trial["tid"], loss=1.0)

            def inflight():
                try:
                    box["trial"] = client.suggest("k9")
                except Exception as e:  # pragma: no cover - debug aid
                    box["error"] = e

            th = threading.Thread(target=inflight, daemon=True)
            th.start()
            proc.send_signal(signal.SIGKILL)  # lands around the suggest
            proc.wait(timeout=30)
            proc = self._spawn(root, port)
            client.wait_ready(timeout=120)
            th.join(timeout=180)
            assert not th.is_alive()
            assert "error" not in box, box
            (t1_trial,) = box["trial"]
            client.report("k9", t1_trial["tid"], loss=2.0)
            st = client.study_status("k9")
            # exactly once: two suggests -> two trials, no orphans
            assert st["n_trials"] == 2
            assert st["n_completed"] == 2
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


class TestRenderPrometheus:
    def test_all_sections_render(self):
        timings = PhaseTimings()
        timings.record("suggest", 0.25)
        spec = SpeculationStats()
        spec.record_dispatch(0.1)
        spec.record_sync(0.2)
        faults = FaultStats()
        faults.record("device_reinit")
        faults.record_backoff(1.5)
        service = ServiceStats()
        service.record_request("suggest", seconds=0.01, study="s")
        service.record_dispatch(2, 0.02)
        text = render_prometheus(
            timings=timings, speculation=spec, faults=faults,
            service=service, extra={"uptime_seconds": 12.5},
        )
        for needle in (
            '# TYPE hyperopt_phase_seconds_total counter',
            'hyperopt_phase_seconds_total{phase="suggest"} 0.25',
            'hyperopt_speculation_events_total{event="dispatched"} 1.0',
            'hyperopt_fault_events_total{event="device_reinit"} 1.0',
            'hyperopt_fault_backoff_seconds_total 1.5',
            'hyperopt_service_requests_total{endpoint="suggest"} 1.0',
            'hyperopt_service_batch_occupancy 2.0',
            'hyperopt_service_suggest_latency_ms{quantile="0.5"}',
            'hyperopt_uptime_seconds 12.5',
        ):
            assert needle in text, needle
        assert text.endswith("\n")

    def test_label_escaping_and_nan(self):
        s = ServiceStats()
        s.record_request("suggest", seconds=0.01, study='we"ird\nname')
        text = render_prometheus(service=s)
        assert 'study="we\\"ird\\nname"' in text
        # occupancy has no dispatches yet -> NaN, not a crash
        assert "hyperopt_service_batch_occupancy NaN" in text

    def test_empty_render(self):
        assert render_prometheus() == "\n"


# ---------------------------------------------------------------------
# the port against the JAX package's service
# ---------------------------------------------------------------------

J_SPACE = {
    "x": J.hp.uniform("x", -5, 5),
    "c": J.hp.choice("c", ["a", "b"]),
    "w": J.hp.quniform("w", 0, 10, 1),
}


def _lockstep(jsvc, tsvc, study_id, n):
    """Suggest from both services, report the JAX point's loss to both;
    returns the (JAX, port) payload pairs."""
    out = []
    for _ in range(n):
        (a,) = jsvc.suggest(study_id)
        (b,) = tsvc.suggest(study_id)
        out.append((a, b))
        loss = _objective(space_eval(SPACE, a["vals"]))
        jsvc.report(study_id, a["tid"], loss=loss)
        tsvc.report(study_id, b["tid"], loss=loss)
    return out


def _assert_same_payloads(pairs):
    for i, (a, b) in enumerate(pairs):
        assert a["tid"] == b["tid"] and a["vals"].keys() == b["vals"].keys(), (i, a, b)
        for k in a["vals"]:
            assert np.isclose(a["vals"][k], b["vals"][k], rtol=1e-5, atol=0), (i, k, a, b)


class TestAgainstJaxService:
    def test_anneal_served_docs_equal_the_jax_services(self):
        """``anneal`` draws from numpy streams in both packages: the whole
        served trajectory equals the JAX service's."""
        jsvc = JaxService(root=None, batch_window=0.001, warmup=False)
        tsvc = Svc(root=None, batch_window=0.001, warmup=False)
        try:
            jsvc.create_study("a", J_SPACE, seed=5, algo="anneal")
            tsvc.create_study("a", SPACE, seed=5, algo="anneal")
            _assert_same_payloads(_lockstep(jsvc, tsvc, "a", 12))
        finally:
            jsvc.close()
            tsvc.close()

    def test_rand_serves_the_jax_services_seed_stream(self):
        """``rand`` draws from ``torch.Generator`` in the port and from
        JAX's PRNG in the reference, so the values differ by design; what
        the service owns — one seed per suggest from the study's
        ``default_rng(seed)``, in arrival order — is the JAX service's:
        each served doc equals the port's ``rand.suggest`` at the seed the
        JAX study drew for it."""
        jsvc = JaxService(root=None, batch_window=0.001, warmup=False)
        tsvc = Svc(root=None, batch_window=0.001, warmup=False)
        try:
            jsvc.create_study("r", J_SPACE, seed=9, algo="rand")
            tsvc.create_study("r", SPACE, seed=9, algo="rand")
            pairs = _lockstep(jsvc, tsvc, "r", 6)
            jst, tst = jsvc.registry.get("r"), tsvc.registry.get("r")
            assert jst.n_seeds_drawn == tst.n_seeds_drawn == 6
            assert jst.rstate.integers(2 ** 31 - 1) == tst.rstate.integers(2 ** 31 - 1)
        finally:
            jsvc.close()
            tsvc.close()
        rng = np.random.default_rng(9)
        domain, trials = Domain(_objective, SPACE), Trials()
        for i, (_, b) in enumerate(pairs):
            seed = int(rng.integers(2 ** 31 - 1))
            (doc,) = rand.suggest([i], domain, trials, seed, device="cpu")
            assert b["vals"] == {k: v[0] for k, v in doc["misc"]["vals"].items() if v}

    def test_tpe_from_a_jax_written_root_serves_the_jax_services_docs(
        self, tmp_path, monkeypatch
    ):
        """A study directory the JAX service wrote (past its random
        startup) opens in the port's registry with equal docs, seed cursor
        and journal entries — after its config's pickled space is replaced
        by the port's encoding, which a port client supplies — and, with
        JAX's uniforms injected into the port's TPE, both services then
        serve equal docs from the shared history."""
        import shutil

        import hyperopt_tpu_torch.algos.tpe as ttpe
        from hyperopt_tpu_torch.service.core import (
            SEED_CURSOR_ATTACHMENT,
            STUDY_CONFIG_ATTACHMENT,
        )
        from test_torch_tpe import jax_streams

        jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
        jsvc = JaxService(root=jroot, batch_window=0.001, warmup=False)
        try:
            jsvc.create_study("s", J_SPACE, seed=13, algo="tpe", algo_params=AP)
            for i in range(AP["n_startup_jobs"] + 2):
                (t,) = jsvc.suggest("s", idempotency_key=f"k{i}")
                jsvc.report("s", t["tid"], loss=_objective(space_eval(SPACE, t["vals"])),
                            idempotency_key=f"r{i}")
        finally:
            jsvc.close()
        shutil.copytree(jroot, troot)
        _swap_space(troot, "s", encode_space(SPACE))
        monkeypatch.setattr(ttpe, "_label_uniforms", jax_streams)
        jsvc = JaxService(root=jroot, batch_window=0.001, warmup=False)
        tsvc = Svc(root=troot, batch_window=0.001, warmup=False)
        try:
            assert tsvc.registry.recovery_info["failed_studies"] == 0
            jst, tst = jsvc.registry.get("s"), tsvc.registry.get("s")
            assert _docs(tst) == _docs(jst)
            assert tst.n_seeds_committed == jst.n_seeds_committed == 6
            assert (tst.trials.attachments[SEED_CURSOR_ATTACHMENT]
                    == jst.trials.attachments[SEED_CURSOR_ATTACHMENT])
            assert _entries(tst) == _entries(jst)
            assert tsvc.suggest("s", idempotency_key="k5") == jsvc.suggest(
                "s", idempotency_key="k5")  # a replay, from either journal
            _assert_same_payloads(_lockstep(jsvc, tsvc, "s", 4))
            cfg = json.loads(tst.trials.attachments[STUDY_CONFIG_ATTACHMENT])
            assert cfg["space_b64"] == encode_space(SPACE)
        finally:
            jsvc.close()
            tsvc.close()

    def test_port_written_root_opens_in_the_jax_registry(self, tmp_path):
        """The other direction: the port's study directory opens in the JAX
        package's registry (space re-encoded by the JAX package) to equal
        docs, seed cursor and journal entries, and the JAX service replays
        the port's journaled responses."""
        import shutil

        troot, jroot = str(tmp_path / "t"), str(tmp_path / "j")
        tsvc = Svc(root=troot, batch_window=0.001, warmup=False)
        try:
            tsvc.create_study("s", SPACE, seed=2, algo="anneal")
            for i in range(5):
                (t,) = tsvc.suggest("s", idempotency_key=f"k{i}")
                tsvc.report("s", t["tid"], loss=float(i), idempotency_key=f"r{i}")
            tdocs = _docs(tsvc.registry.get("s"))
            tentries = _entries(tsvc.registry.get("s"))
            replay = tsvc.suggest("s", idempotency_key="k4")
        finally:
            tsvc.close()
        shutil.copytree(troot, jroot)
        from hyperopt_tpu.service import encode_space as j_encode

        _swap_space(jroot, "s", j_encode(J_SPACE))
        jsvc = JaxService(root=jroot, batch_window=0.001, warmup=False)
        try:
            jst = jsvc.registry.get("s")
            assert jsvc.registry.recovery_info["failed_studies"] == 0
            assert _docs(jst) == tdocs
            assert jst.n_seeds_committed == 5
            assert _entries(jst) == tentries
            assert jsvc.suggest("s", idempotency_key="k4") == replay
        finally:
            jsvc.close()

    def test_unconverted_jax_root_fails_recovery_cleanly(self, tmp_path):
        """A JAX-written study directory whose config still holds the JAX
        package's pickled space: the port's registry refuses it (a failed
        study, /readyz not green) instead of rebuilding foreign classes."""
        root = str(tmp_path / "j")
        jsvc = JaxService(root=root, batch_window=0.001, warmup=False)
        try:
            jsvc.create_study("s", J_SPACE, seed=1, algo="anneal")
        finally:
            jsvc.close()
        tsvc = Svc(root=root, batch_window=0.001, warmup=False)
        try:
            assert tsvc.registry.recovery_info["failed_studies"] == 1
            assert tsvc.readiness()["ready"] is False
        finally:
            tsvc.close()


def _docs(study):
    """A study's trial docs without the store's bookkeeping fields, in
    their JSON form (a live doc holds tuples where a loaded one holds
    lists)."""
    keep = ("tid", "state", "result", "misc", "spec")
    return json.loads(json.dumps(
        [{k: d.get(k) for k in keep} for d in study.trials._dynamic_trials]))


def _entries(study):
    """A study's live journal entries in their JSON form."""
    return json.loads(json.dumps(study.journal.entries(), default=str))


def _swap_space(root, study_id, space_b64):
    """Rewrite one study's config attachment with another space encoding
    (what a client of the other package re-creating the study supplies)."""
    from hyperopt_tpu_torch.parallel.file_trials import FileTrials
    from hyperopt_tpu_torch.service.core import STUDY_CONFIG_ATTACHMENT

    trials = FileTrials(os.path.join(root, "studies", study_id))
    cfg = json.loads(trials.attachments[STUDY_CONFIG_ATTACHMENT].decode())
    cfg["space_b64"] = space_b64
    trials.attachments[STUDY_CONFIG_ATTACHMENT] = json.dumps(
        cfg, sort_keys=True).encode()


# ---------------------------------------------------------------------
# what only the port has to show
# ---------------------------------------------------------------------


def _run_isolated(code, timeout=WAIT_S):
    """``code`` in a fresh interpreter at the repo root; returns stdout.
    It must not import ``jax`` or ``hyperopt_tpu`` (checked at its end)."""
    code += (
        "import sys\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'hyperopt_tpu' or m.startswith('hyperopt_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean"), out.stdout
    return out.stdout


def test_decode_space_refuses_a_jax_blob_without_importing_it():
    """A space pickled by the JAX package names its classes: the port's
    ``decode_space`` raises a ValueError (a 400 over HTTP) and imports
    nothing of that package."""
    from hyperopt_tpu.service import encode_space as j_encode

    blob = j_encode(J_SPACE)
    out = _run_isolated(
        "from hyperopt_tpu_torch.service import decode_space\n"
        f"blob = {blob!r}\n"
        "try:\n"
        "    decode_space(blob)\n"
        "except ValueError as e:\n"
        "    assert 'hyperopt_tpu.' in str(e) and 'JAX package' in str(e), e\n"
        "    print('refused')\n"
    )
    assert "refused" in out
    from hyperopt_tpu_torch.service import ServiceClientError

    with ServiceServer(Svc(root=None, warmup=False)) as server:
        client = ServiceClient(server.url, retry_timeout=0)
        with pytest.raises(ServiceClientError) as e:
            client._request("POST", "/v1/studies",
                            {"study_id": "j", "space_b64": blob, "seed": 0})
    assert e.value.status == 400 and "JAX package" in str(e.value)


def test_service_needs_a_card_or_an_explicit_cpu(tmp_path):
    """``OptimizationService()`` and the CLI without ``--device`` raise
    without a card, as the port's other entry points do; ``device="cpu"``
    serves."""
    out = _run_isolated(
        "import runpy, sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from hyperopt_tpu_torch.service import OptimizationService\n"
        "try:\n"
        "    OptimizationService()\n"
        "except RuntimeError as e:\n"
        "    assert \"device='cpu'\" in str(e), e\n"
        "    print('refused')\n"
        f"sys.argv = ['svc', '--root', {str(tmp_path / 'r')!r}, '--port', '0']\n"
        "try:\n"
        "    runpy.run_module('hyperopt_tpu_torch.service', run_name='__main__')\n"
        "except RuntimeError as e:\n"
        "    assert \"device='cpu'\" in str(e), e\n"
        "    print('cli refused')\n"
        "OptimizationService(device='cpu', warmup=False).close()\n"
    )
    assert "refused" in out and "cli refused" in out


def test_replica_and_mesh_options_raise_naming_the_roadmap(tmp_path):
    """The mesh is ported (``tests/test_torch_mesh.py``): a shape that
    does not cover the service's devices raises ValueError, and ``None``,
    ``off`` and ``auto`` on one device are the single-device dispatch; the
    replica options work (the replica plane is ported:
    ``tests/test_torch_replicas.py``) and none raises
    ``NotImplementedError``."""
    with pytest.raises(ValueError, match="covers 2 device"):
        Svc(root=None, mesh="2x1")
    for mesh in (None, "off", "auto"):
        svc = Svc(root=None, mesh=mesh, warmup=False)
        try:
            assert svc.mesh_label == "off"
        finally:
            svc.close()
    svc = Svc(root=str(tmp_path / "r"), replica_id="r1", advertise_url="http://127.0.0.1:1",
              replica_ttl=30.0, mirror_src_root=str(tmp_path / "m"), warmup=False)
    try:
        doc = svc.replica_status()
        assert doc["replica_mode"] is True and doc["replica_id"] == "r1"
        assert doc["ttl"] == 30.0 and svc.replica_set.mirror is not None
    finally:
        svc.close()
    with pytest.raises(ValueError, match="root"):
        Svc(root=None, replica_id="r1", warmup=False)
    with pytest.raises(ValueError, match="replica_id"):
        Svc(root=str(tmp_path / "r"), mirror_src_root=str(tmp_path / "m"), warmup=False)
    from hyperopt_tpu_torch.service.__main__ import make_parser, main

    # the CLI's replica arguments parse, and its checks refuse bad ones
    options = make_parser().parse_args([
        "--root", str(tmp_path / "c"), "--device", "cpu", "--replica-id", "r1",
        "--advertise-url", "http://127.0.0.1:1", "--replica-ttl", "3",
        "--mirror-src-root", str(tmp_path / "m")])
    assert (options.replica_id, options.advertise_url, options.replica_ttl,
            options.mirror_src_root) == ("r1", "http://127.0.0.1:1", 3.0, str(tmp_path / "m"))
    assert main(["--root", str(tmp_path / "c"), "--port", "0", "--device", "cpu",
                 "--replica-id", "r1"]) == 2  # no predictable advertise URL


def test_only_the_scheduler_thread_dispatches_and_reads_its_own_record(monkeypatch):
    """Four studies served concurrently over HTTP: every launch and
    readback runs on the scheduler thread (the handler threads only
    queue), and the profiler record the scheduler reads after each
    readback is that dispatch's (its request count is the batch's)."""
    from hyperopt_tpu_torch import profiling
    from hyperopt_tpu_torch.service import core

    launches, checks = [], []
    real_multi = tpe_device.multi_study_suggest_async
    real_last = profiling.last_dispatch_record

    def multi(groups):
        launches.append((threading.current_thread().name,
                         sum(len(g) for g in groups)))
        return real_multi(groups)

    def last(consume=True):
        rec = real_last(consume)
        checks.append((threading.current_thread().name,
                       None if rec is None else rec["n_requests"]))
        return rec

    monkeypatch.setattr(tpe_device, "multi_study_suggest_async", multi)
    monkeypatch.setattr(profiling, "last_dispatch_record", last)
    with ServiceServer(Svc(root=None, batch_window=0.02, warmup=False)) as server:
        errors = []

        def drive(sid):
            try:
                client = ServiceClient(server.url)
                client.create_study(sid, SPACE, seed=int(sid[1:]), algo_params=AP)
                for _ in range(AP["n_startup_jobs"] + 3):
                    (t,) = client.suggest(sid)
                    client.report(sid, t["tid"], loss=_objective(space_eval(SPACE, t["vals"])))
            except Exception as e:  # pragma: no cover - debug aid
                errors.append(e)

        threads = [threading.Thread(target=drive, args=(f"s{i}",)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        stats = server.service.stats.summary()
    assert launches and len(launches) == len(checks) == stats["n_dispatches"]
    assert {name for name, _ in launches + checks} == {"hyperopt-service-scheduler"}
    assert [n for _, n in launches] == [n for _, n in checks]
    assert core.SuggestScheduler  # the class the thread name belongs to


def test_fsck_cli_on_a_service_root(tmp_path):
    """``python -m hyperopt_tpu_torch.service fsck ROOT`` checks every
    study queue under the root and exits 0 when clean; a root with a
    replica plane is checked too (FS409), and a torn lease there is a
    finding the repair clears."""
    root = str(tmp_path / "r")
    svc = Svc(root=root, batch_window=0.001, warmup=False)
    try:
        svc.create_study("a", SPACE, seed=0, algo="rand")
        svc.create_study("b", SPACE, seed=1, algo="rand")
        for sid in ("a", "b"):
            (t,) = svc.suggest(sid)
            svc.report(sid, t["tid"], loss=1.0)
    finally:
        svc.close()
    out = subprocess.run([sys.executable, "-m", "hyperopt_tpu_torch.service", "fsck",
                          root, "--json"], capture_output=True, text=True,
                         timeout=WAIT_S, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["clean"] is True and report["n_queues"] == 2 and report["n_docs"] == 2
    from hyperopt_tpu_torch.resilience.fsck import fsck_path
    from hyperopt_tpu_torch.service.replicas import StudyLeaseStore

    store = StudyLeaseStore(root, ttl=30.0)
    store.claim("a", "r1")
    assert fsck_path(root).clean
    with open(store.lease_path("a"), "r+b") as f:
        f.truncate(10)
    report = fsck_path(root)
    assert not report.clean and [f.rule for f in report.findings] == ["FS409"]
    out = subprocess.run([sys.executable, "-m", "hyperopt_tpu_torch.service", "fsck",
                          root, "--repair"], capture_output=True, text=True,
                         timeout=WAIT_S, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert fsck_path(root).clean
