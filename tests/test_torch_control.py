"""The port's closed-loop control plane (``hyperopt_tpu_torch.control``),
held to the JAX package's ``tests/test_control.py`` on the CPU (the
service with ``device="cpu"``), and to the JAX package's control plane on
identical inputs where the two compare (guardrails, clamps, the
objective's score, the early-stop decision).

Covers the contract:

- KnobSet: typed validation envelope, all-or-nothing batch writes,
  out-of-envelope static values (constructor ground truth) with a
  revert that never re-range-checks, provenance ring + CRC-framed
  journal that survives a torn tail;
- guardrail bounds derived from the SL6xx catalog and the proposal
  clamp;
- ObjectiveProbe: one-window delta scoring, compile/chaos
  contamination discards, insufficient-traffic discards, and the
  loss formula;
- Controller state machine: evaluated / discarded / held /
  breach-revert / frozen with exponential re-arm / exception-revert;
  every decision flight-recorded, journaled, and traced;
- durability: a killed controller restarts and resumes its OWN Trials
  exactly (same proposal sequence as an uninterrupted run), stranded
  mid-window proposals repaired to failed trials;
- ``control_enabled=False`` (the default) is machine-checked inert:
  the fixed-seed service trajectory is trial-for-trial identical to
  serial ``fmin`` and the KnobSet never moves;
- SH5xx actuation: per-study ``early_stop`` opt-in stops a stalled
  study, releases its admission slot, counts the reclaim, and is
  reversible via resume — surviving a restart via the config blob;
- the HTTP plane: GET/POST ``/v1/config`` (validation 400, loopback
  403), the 409 ``StudyStopped`` mapping, and the resume route.
"""

import itertools
import json
import time
from functools import partial

import numpy as np
import pytest

from hyperopt_tpu_torch import Trials, fmin, hp
from hyperopt_tpu_torch import slo as slo_mod
from hyperopt_tpu_torch import tracing
from hyperopt_tpu_torch.algos import tpe
from hyperopt_tpu_torch.base import JOB_STATE_DONE, JOB_STATE_ERROR
from hyperopt_tpu_torch.control import (
    STOP_RULES,
    Controller,
    ControlStats,
    KnobSet,
    KnobSpec,
    ObjectiveProbe,
    WindowResult,
    build_stop_fn,
    guardrail_bounds,
)
from hyperopt_tpu_torch.fmin import space_eval
from hyperopt_tpu_torch.observability import FaultStats, ServiceStats
from hyperopt_tpu_torch.service import (
    BackpressureError,
    OptimizationService,
    ServiceClient,
    ServiceClientError,
    ServiceServer,
    StudyExists,
    StudyStopped,
)

SPACE = {
    "x": hp.uniform("x", -5, 5),
    "c": hp.choice("c", ["a", "b"]),
    "w": hp.quniform("w", 0, 10, 1),
}
AP = {"n_startup_jobs": 4, "n_EI_candidates": 32}


def Svc(**kw):
    """The port's service on the CPU (its default is the card)."""
    kw.setdefault("device", "cpu")
    return OptimizationService(**kw)


def _objective(cfg):
    return (
        (cfg["x"] - 1.0) ** 2
        + (0.5 if cfg["c"] == "b" else 0.0)
        + 0.1 * cfg["w"]
    )


def _drive(svc, study_id, n, objective=_objective):
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


def _mk_knobs(**overrides):
    static = {
        "batch_window": 0.004, "max_batch": 8,
        "max_queue": 1024, "max_speculation": 0,
    }
    static.update(overrides)
    return KnobSet(static=static)


class _ScoreProbe:
    """Deterministic probe: the loss is a pure function of the applied
    knob point, so two controllers walking the same proposal sequence
    observe identical losses (the restart-resume proof needs this)."""

    def __init__(self, knobs):
        self.knobs = knobs

    def open(self):
        return {"t": 0.0}

    def close(self, opened):
        v = self.knobs.values()
        loss = (
            v["batch_window"] * 10.0
            + v["max_batch"] * 1e-3
            + v["max_speculation"] * 1e-4
        )
        return WindowResult(
            ok=True, loss=loss, warm_p99_s=loss,
            mean_queue_depth=0.0, duty_cycle=None,
            warm_count=9, wall_s=0.01,
        )


class _FixedProbe:
    def __init__(self, result):
        self.result = result

    def open(self):
        return {"t": 0.0}

    def close(self, opened):
        if isinstance(self.result, Exception):
            raise self.result
        return self.result


# ---------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------


class TestKnobSet:
    def test_spec_coerce_is_type_only(self):
        spec = KnobSpec("k", int, 1, 8)
        assert spec.coerce(3.0) == 3
        assert spec.coerce(100) == 100  # out of range, coerce allows
        with pytest.raises(ValueError):
            spec.coerce(3.7)  # silent truncation refused
        with pytest.raises(ValueError):
            spec.coerce("nope")
        with pytest.raises(ValueError):
            spec.validate(100)  # validate DOES range-check

    def test_set_many_is_all_or_nothing(self):
        ks = _mk_knobs()
        ks.set_many({"batch_window": 0.01}, source="test")
        assert ks.get("batch_window") == 0.01
        assert ks.n_changes == 1
        before = ks.values()
        with pytest.raises(ValueError):
            # max_batch=0 is invalid; batch_window=0.02 must NOT land
            ks.set_many(
                {"batch_window": 0.02, "max_batch": 0}, source="test"
            )
        assert ks.values() == before
        assert ks.n_changes == 1

    def test_unknown_knob_rejected(self):
        with pytest.raises(ValueError):
            KnobSet(static={"warp_factor": 9})
        ks = _mk_knobs()
        with pytest.raises(ValueError):
            ks.set_many({"warp_factor": 9}, source="test")

    def test_out_of_envelope_static_is_ground_truth(self):
        # max_queue=0 (admission off) is below the runtime-write floor
        # of 1 — legal as a constructor value, restorable by revert
        ks = _mk_knobs(max_queue=0)
        assert ks.get("max_queue") == 0
        ks.set_many({"max_queue": 5}, source="test")
        assert not ks.is_static
        ks.revert(source="test")
        assert ks.get("max_queue") == 0
        assert ks.is_static

    def test_provenance_and_journal_survive_torn_tail(self, tmp_path):
        path = str(tmp_path / "ctl" / "knobs.jsonl")
        ks = KnobSet(static={"batch_window": 0.004}, journal_path=path)
        ks.set_many({"batch_window": 0.01}, source="api:127.0.0.1")
        ks.set_many({"max_batch": 16}, source="controller")
        ks.revert(source="controller:revert")
        prov = ks.provenance()
        assert [r["source"] for r in prov] == [
            "api:127.0.0.1", "controller", "controller:revert",
        ]
        assert prov[0]["before"] == {"batch_window": 0.004}
        assert prov[0]["changes"] == {"batch_window": 0.01}
        assert not prov[0]["noop"]
        records = ks.journal_records()
        assert len(records) == 3
        assert records[-1]["values"]["batch_window"] == 0.004
        # a mid-append kill tears the final record: CRC framing means
        # the reader skips it instead of exploding or misparsing
        with open(path, "ab") as f:
            f.write(b"\ndeadbeef {\"torn\": tru")
        assert len(ks.journal_records()) == 3

    def test_clamp_pulls_into_bounds_without_applying(self):
        ks = _mk_knobs()
        out = ks.clamp({"batch_window": 9.0, "max_batch": -3})
        assert out == {"batch_window": 0.5, "max_batch": 1}
        out = ks.clamp(
            {"batch_window": 0.4}, bounds={"batch_window": (0.0, 0.1)}
        )
        assert out == {"batch_window": 0.1}
        assert ks.is_static  # clamp never mutates

    def test_guardrail_bounds_from_sl602(self):
        rules = slo_mod.default_rules(
            latency_absolute={"p99_bound_s": 2.0}
        )
        bounds = guardrail_bounds(rules)
        lo, hi = bounds["batch_window"]
        assert lo == 0.0
        # the ceiling is a small fraction of the p99 bound — the
        # controller must never propose the breach itself
        assert hi == pytest.approx(0.1)
        assert guardrail_bounds([]) == {}


# ---------------------------------------------------------------------
# objective
# ---------------------------------------------------------------------


def _warm(stats, seconds, n=1):
    for _ in range(n):
        stats.record_request("suggest", seconds=seconds, study="s")


class TestObjectiveProbe:
    def test_insufficient_traffic_discarded(self):
        stats = ServiceStats()
        probe = ObjectiveProbe(stats, min_warm=5)
        opened = probe.open()
        _warm(stats, 0.01, n=2)
        result = probe.close(opened)
        assert not result.ok
        assert result.reason == "insufficient_traffic"
        assert result.warm_count == 2

    def test_request_path_compile_contaminates(self):
        stats = ServiceStats()
        probe = ObjectiveProbe(stats, min_warm=5)
        opened = probe.open()
        _warm(stats, 0.01, n=10)
        stats.record_compile(4, "x:uniform")
        result = probe.close(opened)
        assert not result.ok
        assert result.reason == "contaminated:compile"

    def test_background_compile_does_not_contaminate(self):
        stats = ServiceStats()
        probe = ObjectiveProbe(stats, min_warm=5)
        opened = probe.open()
        _warm(stats, 0.01, n=10)
        stats.record_compile(4, "x:uniform", background=True)
        assert probe.close(opened).ok

    def test_chaos_injection_contaminates(self):
        stats = ServiceStats()
        faults = FaultStats()
        probe = ObjectiveProbe(stats, fault_stats=faults, min_warm=5)
        opened = probe.open()
        _warm(stats, 0.01, n=10)
        faults.record("chaos_suggest")
        result = probe.close(opened)
        assert not result.ok
        assert result.reason == "contaminated:chaos"

    def test_loss_formula_and_delta_isolation(self):
        stats = ServiceStats()
        # pre-window pathology must NOT leak into the window's score:
        # the probe deltas against the open snapshot, never lifetime
        _warm(stats, 5.0, n=20)
        stats.record_compile(4, "x:uniform")
        probe = ObjectiveProbe(stats, min_warm=5, queue_weight=0.010)
        opened = probe.open()
        _warm(stats, 0.01, n=12)
        stats.set_queue_depth(4)
        stats.set_queue_depth(2)
        result = probe.close(opened)
        assert result.ok
        assert result.warm_count == 12
        assert result.mean_queue_depth == pytest.approx(3.0)
        # in-window p99 reflects the 10ms burst, not the 5s history
        assert result.warm_p99_s < 1.0
        assert result.duty_cycle is None  # no device stats wired
        assert result.loss == pytest.approx(
            result.warm_p99_s + 0.010 * result.mean_queue_depth
        )


# ---------------------------------------------------------------------
# controller state machine
# ---------------------------------------------------------------------


class TestController:
    def test_evaluated_cycle_applies_within_bounds(self):
        knobs = _mk_knobs()
        stats = ControlStats()
        ctl = Controller(
            knobs, _ScoreProbe(knobs), seed=0, window_s=0.0,
            stats=stats,
        )
        assert ctl.step() == "evaluated"
        assert not knobs.is_static
        values = knobs.values()
        for name in ctl.tuned:
            lo, hi = ctl.bounds[name]
            assert lo <= values[name] <= hi, (name, values[name])
        # untuned knobs are never touched by the controller
        assert values["max_queue"] == 1024
        docs = ctl.trials._dynamic_trials
        assert len(docs) == 1 and docs[0]["state"] == JOB_STATE_DONE
        actions = [d["action"] for d in ctl.recent_decisions()]
        assert actions == ["proposed", "applied", "evaluated"]
        decisions = stats.control_metrics()["decisions"]
        assert decisions == {"proposed": 1, "applied": 1, "evaluated": 1}
        assert stats.control_metrics()["objective"] is not None

    def test_discarded_window_lands_failed_trial(self):
        knobs = _mk_knobs()
        ctl = Controller(
            knobs,
            _FixedProbe(
                WindowResult(False, reason="insufficient_traffic")
            ),
            seed=0, window_s=0.0,
        )
        assert ctl.step() == "discarded"
        docs = ctl.trials._dynamic_trials
        assert len(docs) == 1 and docs[0]["state"] == JOB_STATE_ERROR
        assert not ctl.frozen
        last = ctl.recent_decisions()[-1]
        assert last["action"] == "discarded"
        assert last["reason"] == "insufficient_traffic"

    def test_active_breach_holds_without_actuating(self):
        knobs = _mk_knobs()
        ctl = Controller(
            knobs, _ScoreProbe(knobs), seed=0, window_s=0.0,
            breach_fn=lambda: {
                "transitions": 3, "breaching": ["SL602"],
            },
        )
        assert ctl.step() == "held"
        assert knobs.is_static  # never tune INTO an incident
        last = ctl.recent_decisions()[-1]
        assert last["reason"] == "active_breach"
        assert last["fired_rules"] == ["SL602"]

    def test_breach_transition_reverts_within_one_window(self):
        knobs = _mk_knobs()
        stats = ControlStats()
        schedule = iter([0, 0, 0, 1])
        ctl = Controller(
            knobs, _ScoreProbe(knobs), seed=0, window_s=0.0,
            stats=stats,
            breach_fn=lambda: {
                "transitions": next(schedule, 1), "breaching": [],
            },
        )
        assert ctl.step() == "evaluated"
        assert not knobs.is_static
        assert ctl.step() == "reverted"
        assert knobs.is_static  # static config restored
        assert ctl.frozen
        assert ctl.rearm_in_s() > 0
        assert ctl.step() == "frozen"  # no actuation while frozen
        status = ctl.status()
        assert status["frozen"] and status["freezes_total"] == 1
        assert stats.control_metrics()["frozen"] == 1
        # the breached window's trial is a failed trial, not a loss
        assert status["n_discarded"] == 1

    def test_exception_reverts_and_freezes(self):
        knobs = _mk_knobs()
        ctl = Controller(
            knobs, _FixedProbe(RuntimeError("probe exploded")),
            seed=0, window_s=0.0,
        )
        assert ctl.step() == "reverted"
        assert knobs.is_static and ctl.frozen
        last = ctl.recent_decisions()[-1]
        assert last["action"] == "reverted"
        assert last["reason"] == "exception:RuntimeError"

    def test_exponential_rearm_doubles_per_freeze(self):
        clock = {"t": 0.0}
        calls = itertools.count()
        knobs = _mk_knobs()
        ctl = Controller(
            knobs, _ScoreProbe(knobs), seed=0, window_s=0.0,
            freeze_base_s=10.0, freeze_max_s=100.0,
            time_fn=lambda: clock["t"],
            # transitions grow on every consultation: every completed
            # window sees a transition and trips
            breach_fn=lambda: {
                "transitions": next(calls), "breaching": [],
            },
        )
        assert ctl.step() == "reverted"
        assert ctl.rearm_in_s() == pytest.approx(10.0)
        assert ctl.step() == "frozen"  # still inside the backoff
        clock["t"] = 11.0
        assert ctl.step() == "reverted"  # re-armed, trips again
        assert ctl.rearm_in_s() == pytest.approx(20.0)
        clock["t"] = 32.0
        assert ctl.step() == "reverted"
        assert ctl.rearm_in_s() == pytest.approx(40.0)
        assert ctl.status()["freezes_total"] == 3

    def test_decision_span_emitted_when_traced(self, tmp_path):
        trace_path = str(tmp_path / "trace.jsonl")
        tracer = tracing.Tracer(path=trace_path, sample=1.0)
        knobs = _mk_knobs()
        ctl = Controller(
            knobs, _ScoreProbe(knobs), seed=0, window_s=0.0,
            tracer=tracer,
        )
        assert ctl.step() == "evaluated"
        with open(trace_path, "rb") as f:
            records, torn = tracing.parse_trace_log(f.read())
        assert torn == 0 and records
        blob = json.dumps(records)
        assert "control.decision" in blob
        # the applied decision's span carries the knob point
        assert '"action": "applied"' in blob


# ---------------------------------------------------------------------
# controller durability: restart resumes the Trials exactly
# ---------------------------------------------------------------------


class TestControllerDurability:
    def _applied_sequence(self, ctl):
        return [
            (d["knobs"], d.get("loss"))
            for d in ctl.decision_log_records()
            if d["action"] in ("applied", "evaluated")
        ]

    def test_restart_resumes_proposal_sequence_exactly(self, tmp_path):
        # uninterrupted reference: 5 cycles in one controller life
        ref_knobs = _mk_knobs()
        ref = Controller(
            ref_knobs, _ScoreProbe(ref_knobs), seed=11, window_s=0.0,
            trials_dir=str(tmp_path / "ref"),
        )
        for _ in range(5):
            assert ref.step() == "evaluated"

        # interrupted run: 3 cycles, then the process "dies" (no
        # close, no flush beyond the durable writes) and a NEW
        # controller restarts on the same trials_dir
        k1 = _mk_knobs()
        first = Controller(
            k1, _ScoreProbe(k1), seed=11, window_s=0.0,
            trials_dir=str(tmp_path / "run"),
        )
        for _ in range(3):
            assert first.step() == "evaluated"
        del first

        k2 = _mk_knobs()
        resumed = Controller(
            k2, _ScoreProbe(k2), seed=11, window_s=0.0,
            trials_dir=str(tmp_path / "run"),
        )
        # the resume fast-forwarded the seed cursor past the evidenced
        # draws, and the prior trials are all loaded
        assert resumed.n_draws == 3
        assert resumed.status()["n_trials"] == 3
        assert resumed.status()["n_evaluated"] == 3
        for _ in range(2):
            assert resumed.step() == "evaluated"

        got = self._applied_sequence(resumed)
        want = self._applied_sequence(ref)[-len(got):]
        # the resumed controller's continuation (cycles 4-5) equals
        # the uninterrupted run's cycles 4-5, point for point
        assert [g[0] for g in got[-4:]] == [w[0] for w in want[-4:]]
        for (gk, gl), (wk, wl) in zip(got[-4:], want[-4:]):
            if gl is not None or wl is not None:
                assert gl == pytest.approx(wl)

    def test_stranded_mid_window_proposal_repaired(self, tmp_path):
        knobs = _mk_knobs()
        ctl = Controller(
            knobs, _ScoreProbe(knobs), seed=3, window_s=0.0,
            trials_dir=str(tmp_path / "t"),
        )
        doc, _point = ctl.propose()  # kill -9 lands mid-window here
        del ctl

        knobs2 = _mk_knobs()
        resumed = Controller(
            knobs2, _ScoreProbe(knobs2), seed=3, window_s=0.0,
            trials_dir=str(tmp_path / "t"),
        )
        docs = resumed.trials._dynamic_trials
        assert len(docs) == 1
        assert docs[0]["state"] == JOB_STATE_ERROR
        assert docs[0]["result"]["reason"] == "interrupted"
        # the stranded proposal consumed a draw; the cursor skips it
        assert resumed.n_draws == 1

    def test_decision_journal_is_crc_framed(self, tmp_path):
        knobs = _mk_knobs()
        ctl = Controller(
            knobs, _ScoreProbe(knobs), seed=0, window_s=0.0,
            trials_dir=str(tmp_path / "t"),
        )
        ctl.step()
        records = ctl.decision_log_records()
        assert [r["action"] for r in records] == [
            "proposed", "applied", "evaluated",
        ]
        assert [r["seq"] for r in records] == [1, 2, 3]
        with open(ctl.decisions_log_path, "ab") as f:
            f.write(b"\n0bad0bad {\"torn")
        assert len(ctl.decision_log_records()) == 3


# ---------------------------------------------------------------------
# service integration: inertness, /v1/config core, controller wiring
# ---------------------------------------------------------------------


class TestServiceControl:
    def test_control_off_is_provably_inert(self):
        """The acceptance gate: with the default
        ``control_enabled=False``, the fixed-seed service trajectory
        is trial-for-trial identical to serial ``fmin`` AND the knob
        table never moves — the control plane's existence costs
        nothing until it is asked for."""
        ref = _serial_fmin_vals(seed=42, max_evals=12)
        svc = Svc(root=None, batch_window=0.001)
        try:
            assert svc.controller is None
            assert svc.knobs.is_static
            assert svc.knobs.values()["batch_window"] == 0.001
            svc.create_study("s", SPACE, seed=42, algo="tpe",
                             algo_params=AP)
            got = _drive(svc, "s", 12)
            # after a full campaign: zero knob mutations, zero
            # control decisions, no controller thread
            assert svc.knobs.n_changes == 0
            assert svc.knobs.is_static
            assert svc.controller is None
            status = svc.service_status()
            assert status["control"]["enabled"] is False
            assert status["control"]["controller"] is None
        finally:
            svc.close()
        assert len(ref) == len(got) == 12
        for i, (rv, g) in enumerate(zip(ref, got)):
            assert rv.keys() == g["vals"].keys(), (i, rv, g)
            for k in rv:
                assert np.isclose(rv[k], g["vals"][k]), (i, k, rv, g)

    def test_get_set_config_core(self):
        svc = Svc(root=None, batch_window=0.004)
        try:
            cfg = svc.get_config()
            assert cfg["control_enabled"] is False
            assert cfg["knobs"]["batch_window"]["value"] == 0.004
            out = svc.set_config(
                {"knobs": {"batch_window": 0.002, "max_batch": 16}},
                source="test",
            )
            assert out["values"]["batch_window"] == 0.002
            assert out["is_static"] is False
            with pytest.raises(ValueError):
                svc.set_config({"knobs": {"max_batch": 0}})
            with pytest.raises(ValueError):
                svc.set_config({})  # neither knobs nor revert
            out = svc.set_config({"revert": True}, source="test")
            assert out["is_static"] is True
            assert out["values"]["batch_window"] == 0.004
            provenance = svc.get_config()["provenance"]
            assert [p["source"] for p in provenance][:1] == ["test"]
        finally:
            svc.close()

    def test_scheduler_reads_knobs_per_batch(self):
        # a runtime knob write lands on the NEXT batch, no restart:
        # the scheduler's view IS the KnobSet
        svc = Svc(root=None, batch_window=0.001)
        try:
            svc.create_study("s", SPACE, seed=0, algo_params=AP)
            _drive(svc, "s", 2)
            svc.set_config({"knobs": {"max_batch": 2}}, source="test")
            _drive(svc, "s", 2)
            assert svc.knobs.get("max_batch") == 2
            assert not svc.knobs.is_static
        finally:
            svc.close()

    def test_self_tune_attaches_a_live_controller(self, tmp_path):
        svc = Svc(
            root=str(tmp_path / "r"), batch_window=0.001,
            control_enabled=True, control_window_s=0.05,
            control_interval_s=0.0, control_seed=7,
        )
        try:
            assert svc.controller is not None
            assert svc.controller.durable
            assert svc.controller.seed == 7
            svc.create_study("s", SPACE, seed=0, algo_params=AP)
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                _drive(svc, "s", 2)
                if svc.controller.status()["n_decisions"] >= 3:
                    break
            status = svc.service_status()["control"]
            assert status["enabled"] is True
            assert status["controller"]["n_decisions"] >= 3
            metrics = svc.metrics_text()
            assert "hyperopt_control_decisions_total" in metrics
            # every decision is also in the durable journal
            journaled = svc.controller.decision_log_records()
            assert len(journaled) == len(
                svc.controller.recent_decisions()
            )
        finally:
            svc.close()


# ---------------------------------------------------------------------
# SH5xx actuation: early-stop opt-in, slot reclaim, resume
# ---------------------------------------------------------------------

FLAT = {"x": hp.uniform("x", -5, 5)}
FLAT_AP = {"n_startup_jobs": 2, "n_EI_candidates": 8}
STALL = {"iteration_stop_count": 3}


def _drive_until_stopped(svc, study_id, limit=40):
    """Flat-loss reports until the SH5xx hook fires on suggest."""
    for i in range(limit):
        try:
            (t,) = svc.suggest(study_id, n=1)
        except StudyStopped:
            return i
        svc.report(study_id, t["tid"], loss=1.0)
    raise AssertionError("early stop never fired")


class TestActuation:
    def test_create_validates_early_stop_config(self):
        svc = Svc(root=None, batch_window=0.001)
        try:
            with pytest.raises(ValueError):
                svc.create_study("a", FLAT, early_stop={"bogus": 1})
            with pytest.raises(ValueError):
                svc.create_study(
                    "a", FLAT,
                    early_stop={"iteration_stop_count": 0},
                )
            with pytest.raises(ValueError):
                build_stop_fn("not-a-dict")
        finally:
            svc.close()

    def test_stop_is_terminal_and_releases_the_slot(self):
        svc = Svc(
            root=None, batch_window=0.001, max_studies=1,
        )
        try:
            svc.create_study(
                "s1", FLAT, seed=0, algo_params=FLAT_AP,
                early_stop=STALL,
            )
            n = _drive_until_stopped(svc, "s1")
            assert n >= FLAT_AP["n_startup_jobs"]
            status = svc.study_status("s1")
            assert status["status"] == "stopped"
            assert status["stopped"]["rule"] in STOP_RULES
            assert status["early_stop"] == STALL
            # terminal for NEW work: suggest keeps raising
            with pytest.raises(StudyStopped):
                svc.suggest("s1", n=1)
            # the admission slot is released: a queued study admits
            # under max_studies=1 even though s1 still exists
            svc.create_study("s2", FLAT, seed=1, algo_params=FLAT_AP)
            # ... which means resume needs capacity and must refuse
            with pytest.raises(BackpressureError):
                svc.resume_study("s1")
            counters = svc.control_stats.control_metrics()
            assert counters["reclaimed_studies_total"] == 1
            metrics = svc.metrics_text()
            assert "hyperopt_control_reclaimed_studies_total 1" in metrics
        finally:
            svc.close()

    def test_resume_reverses_the_stop(self):
        svc = Svc(root=None, batch_window=0.001)
        try:
            svc.create_study(
                "s1", FLAT, seed=0, algo_params=FLAT_AP,
                early_stop=STALL,
            )
            _drive_until_stopped(svc, "s1")
            out = svc.resume_study("s1")
            assert out["status"] == "active"
            assert svc.study_status("s1")["stopped"] is None
            # suggests flow again after the resume
            (t,) = svc.suggest("s1", n=1)
            svc.report("s1", t["tid"], loss=0.5)
            counters = svc.control_stats.control_metrics()
            assert counters["resumed_studies_total"] == 1
        finally:
            svc.close()

    def test_studies_without_opt_in_never_stop(self):
        svc = Svc(root=None, batch_window=0.001)
        try:
            svc.create_study("s", FLAT, seed=0, algo_params=FLAT_AP)
            for _ in range(12):  # flat losses, stall window exceeded
                (t,) = svc.suggest("s", n=1)
                svc.report("s", t["tid"], loss=1.0)
            status = svc.study_status("s")
            assert status["status"] == "active"
            assert status["early_stop"] is None
        finally:
            svc.close()

    def test_early_stop_config_survives_restart(self, tmp_path):
        root = str(tmp_path / "r")
        svc = Svc(root=root, batch_window=0.001)
        try:
            svc.create_study(
                "s", FLAT, seed=0, algo_params=FLAT_AP,
                early_stop=STALL,
            )
        finally:
            svc.close()
        svc = Svc(root=root, batch_window=0.001)
        try:
            status = svc.study_status("s")
            assert status["early_stop"] == STALL
            # exist_ok matches on the early_stop config too
            svc.create_study(
                "s", FLAT, seed=0, algo_params=FLAT_AP,
                early_stop=STALL, exist_ok=True,
            )
            with pytest.raises(StudyExists):
                svc.create_study(
                    "s", FLAT, seed=0, algo_params=FLAT_AP,
                    early_stop={"iteration_stop_count": 9},
                    exist_ok=True,
                )
            # the restarted hook still fires
            _drive_until_stopped(svc, "s")
            assert svc.study_status("s")["status"] == "stopped"
        finally:
            svc.close()


# ---------------------------------------------------------------------
# static-analysis coverage of the control package
# ---------------------------------------------------------------------


class TestLintCoverage:
    def test_race_lint_covers_control_package(self):
        """The control plane's locks (KnobSet table, controller decision
        ring) lint clean under the port's own race pass, and both files
        carry guarded-by annotations for it to read."""
        from hyperopt_tpu_torch.analysis import format_report, lint_races

        from hyperopt_tpu_torch.control import controller, knobs

        paths = [knobs.__file__, controller.__file__]
        diags = lint_races(paths=paths)
        assert diags == [], format_report(diags)
        for path in paths:
            assert "# guarded-by: _lock" in open(path).read()


# ---------------------------------------------------------------------
# HTTP plane: /v1/config, 403 non-loopback, 409 stopped, resume route
# ---------------------------------------------------------------------


class TestControlHTTP:
    def test_get_and_post_config(self):
        with ServiceServer(
            Svc(root=None, batch_window=0.004)
        ) as server:
            client = ServiceClient(server.url)
            cfg = client.get_config()
            assert cfg["knobs"]["batch_window"]["value"] == 0.004
            assert cfg["control_enabled"] is False
            out = client.set_config(knobs={"batch_window": 0.002})
            assert out["values"]["batch_window"] == 0.002
            with pytest.raises(ServiceClientError) as e:
                client.set_config(knobs={"max_batch": 0})
            assert e.value.status == 400
            out = client.set_config(revert=True)
            assert out["is_static"] is True
            # the write's provenance names the API source
            sources = [
                p["source"] for p in client.get_config()["provenance"]
            ]
            assert any(s.startswith("api:") for s in sources)

    def test_post_config_refused_off_loopback(self, monkeypatch):
        from hyperopt_tpu_torch.service import server as server_mod

        with ServiceServer(
            Svc(root=None)
        ) as server:
            client = ServiceClient(server.url)
            monkeypatch.setattr(
                server_mod._Handler, "_is_loopback", lambda self: False
            )
            with pytest.raises(ServiceClientError) as e:
                client.set_config(knobs={"batch_window": 0.002})
            assert e.value.status == 403
            # reads stay open; only mutation is loopback-gated
            assert client.get_config()["knobs"]

    def test_stopped_maps_to_409_and_resume_route(self):
        with ServiceServer(
            Svc(root=None, batch_window=0.001)
        ) as server:
            client = ServiceClient(server.url)
            client.create_study(
                "s", FLAT, seed=0, algo_params=FLAT_AP,
                early_stop=STALL,
            )
            status = None
            for _ in range(40):
                try:
                    (t,) = client.suggest("s")
                except ServiceClientError as e:
                    status = e.status
                    break
                client.report("s", t["tid"], loss=1.0)
            assert status == 409
            doc = client.study_status("s")
            assert doc["status"] == "stopped"
            out = client.resume_study("s")
            assert out["status"] == "active"
            (t,) = client.suggest("s")
            client.report("s", t["tid"], loss=0.5)


# ---------------------------------------------------------------------
# the port against the JAX package's control plane, on identical inputs
# ---------------------------------------------------------------------


def test_knob_table_guardrails_and_clamp_equal_the_jax_packages():
    import hyperopt_tpu.control as jctl
    import hyperopt_tpu.slo as jslo

    static = {"batch_window": 0.004, "max_batch": 8, "max_queue": 1024,
              "max_speculation": 0}
    assert (guardrail_bounds(slo_mod.default_rules())
            == jctl.guardrail_bounds(jslo.default_rules()))
    tk, jk = KnobSet(static=static), jctl.KnobSet(static=static)
    assert tk.describe() == jk.describe()
    far = {"batch_window": 9.0, "max_batch": 10 ** 6, "max_speculation": -3}
    assert tk.clamp(far) == jk.clamp(far)
    bounds = {"batch_window": (0.001, 0.01), "max_batch": (2, 16)}
    assert tk.clamp(far, bounds=bounds) == jk.clamp(far, bounds=bounds)


def test_objective_window_scores_equal_the_jax_packages():
    """One window of identical traffic (latencies, queue depths, a device
    record) into both packages' stats: the same WindowResult."""
    import hyperopt_tpu.control as jctl
    import hyperopt_tpu.observability as jobs

    from hyperopt_tpu_torch import observability as tobs

    rec = {"sig": "w", "device_s": 0.5, "n_requests": 2,
           "binding_ceiling": "hbm_bw", "roofline_pct": 1.0, "hbm_bytes": 1e6,
           "flops": 1e6, "live_bytes": 64, "compiled": False}
    results = []
    for obs, ctl in ((jobs, jctl), (tobs, __import__("hyperopt_tpu_torch.control",
                                                      fromlist=["x"]))):
        stats, dev = obs.ServiceStats(), obs.DeviceStats()
        probe = ctl.ObjectiveProbe(stats, device_stats=dev, min_warm=5)
        opened = probe.open()
        for i in range(40):
            stats.record_request("suggest", seconds=0.002 * (1 + i % 7), study="s")
            stats.set_queue_depth(i % 5)
        dev.record_dispatch(dict(rec))
        r = probe.close(opened).to_dict()
        r.pop("wall_s")  # the window's own wall time
        r.pop("duty_cycle")  # busy seconds over that wall time
        results.append(r)
    assert results[0] == results[1]


@pytest.mark.parametrize("losses", [[1.0] * 12, [5.0, 4.0, 3.0] + [3.0] * 9,
                                    [float(i % 3) for i in range(12)]])
def test_early_stop_fires_where_the_jax_packages_does(losses):
    """The SH5xx hook over identical landed results (each stalls within
    12 trials): both packages stop after the same trial, by the same
    rule."""
    import hyperopt_tpu as J
    import hyperopt_tpu.control as jctl

    from hyperopt_tpu_torch.base import STATUS_OK, trials_from_docs

    cfg = {"iteration_stop_count": 3}
    jt = J.Trials()
    docs = []
    for i, loss in enumerate(losses):
        doc = jt.new_trial_docs([i], [None], [{"status": STATUS_OK, "loss": loss}],
                                [{"tid": i, "cmd": None, "workdir": None,
                                  "idxs": {"x": [i]}, "vals": {"x": [0.1 * i]}}])[0]
        doc["state"] = JOB_STATE_DONE
        docs.append(doc)
    fired = []
    for pkg, mk, build, evaluate in (
        ("jax", lambda d: J.trials_from_docs(d), jctl.build_stop_fn, jctl.evaluate_stop),
        ("port", trials_from_docs, build_stop_fn,
         __import__("hyperopt_tpu_torch.control", fromlist=["x"]).evaluate_stop),
    ):
        stop = build(dict(cfg), n_startup_jobs=2)
        at = None
        for n in range(1, len(docs) + 1):
            record = evaluate(stop, mk([dict(d) for d in docs[:n]]))
            if record is not None:
                at = (n, record["rule"])
                break
        fired.append(at)
    assert fired[0] is not None and fired[0] == fired[1]
