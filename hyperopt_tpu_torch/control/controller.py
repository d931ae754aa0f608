"""The closed-loop controller: hyperopt running *on* hyperopt.

A background thread inside :class:`~hyperopt_tpu_torch.service.core
.OptimizationService` that treats the service's own serving knobs
(:mod:`.knobs`) as a bounded ``hp.*`` search space and its own SLO
telemetry (:mod:`.objective`) as the objective.  Each cycle:

1. **propose** — ``tpe.suggest`` over the controller's OWN ``Trials``
   (random warm-up for the first ``n_startup_jobs`` proposals, the
   Bergstra & Bengio exploration discipline), clamped to the guardrail
   bounds derived from the SL6xx catalog;
2. **apply** — the proposal lands in the :class:`~.knobs.KnobSet`; the
   scheduler reads it on its next batch;
3. **observe** — one objective window (:class:`~.objective
   .ObjectiveProbe`); contaminated or traffic-starved windows are
   discarded as failed trials (TPE ignores them);
4. **record** — the loss lands in the Trials (durably, via FileTrials,
   when the service has a root), so a restarted controller resumes its
   optimization history exactly.

The knob search runs on the CPU (``device="cpu"`` by default): its space
has four dimensions, and the card stays with the service's scheduler
thread, the one thread that launches there.

Safety is the headline: any SL6xx breach transition during a window —
or any controller exception — triggers an immediate revert to the
static config and a controller FREEZE with exponential re-arm.  Every
decision (proposed / applied / evaluated / discarded / reverted /
rearmed / held) is appended to a bounded ring + durable JSONL log,
surfaced as a flight-recorder provider, and emitted as a
``control.decision`` trace span.
"""

import json
import logging
import os
import threading
import time
from collections import deque

import numpy as np

from .. import tracing
from ..base import (
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    STATUS_FAIL,
    STATUS_OK,
    Domain,
    Trials,
)
from ..utils import coarse_utcnow
from .knobs import guardrail_bounds

logger = logging.getLogger(__name__)

__all__ = ["ControlStats", "Controller", "DEFAULT_TUNED_KNOBS"]

# the knobs the controller searches over (the full KnobSet remains
# settable via /v1/config; admission limits stay operator-owned)
DEFAULT_TUNED_KNOBS = ("batch_window", "max_batch", "max_speculation")

CONTROL_ALGO_PARAMS = {"n_startup_jobs": 5, "n_EI_candidates": 24}


def _null_objective(x):
    return 0.0


class ControlStats:
    """Thread-safe control-plane counters for ``/metrics`` and
    ``/v1/status``.  Constructed by the service unconditionally (the
    actuation counters exist with the controller off), fed by the
    controller thread when ``--self-tune`` is on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._decisions = {}          # guarded-by: _lock  (outcome -> n)
        self._objective = None        # guarded-by: _lock  (last loss)
        self._frozen = False          # guarded-by: _lock
        self._freezes = 0             # guarded-by: _lock
        self._reclaimed = 0           # guarded-by: _lock  (studies stopped)
        self._resumed = 0             # guarded-by: _lock  (studies resumed)

    def record_decision(self, outcome: str):
        with self._lock:
            self._decisions[str(outcome)] = (
                self._decisions.get(str(outcome), 0) + 1
            )

    def set_objective(self, loss):
        with self._lock:
            self._objective = float(loss) if loss is not None else None

    def set_frozen(self, frozen: bool):
        with self._lock:
            if frozen and not self._frozen:
                self._freezes += 1
            self._frozen = bool(frozen)

    def record_reclaimed(self, n: int = 1):
        with self._lock:
            self._reclaimed += int(n)

    def record_resumed(self, n: int = 1):
        with self._lock:
            self._resumed += int(n)

    @property
    def reclaimed_total(self) -> int:
        with self._lock:
            return self._reclaimed

    def control_metrics(self) -> dict:
        """The ``render_prometheus(control=...)`` section."""
        with self._lock:
            return {
                "decisions": dict(self._decisions),
                "objective": self._objective,
                "frozen": 1 if self._frozen else 0,
                "freezes_total": self._freezes,
                "reclaimed_studies_total": self._reclaimed,
                "resumed_studies_total": self._resumed,
            }

    def summary(self) -> dict:
        return self.control_metrics()


class Controller:
    """The self-tuning loop.  One instance per service; its thread is
    started by :meth:`start` and stopped by :meth:`close`.  Tests call
    :meth:`step` directly (one full cycle, synchronous)."""

    # lock-order: _lock (leaf; never held across a window wait or I/O)
    def __init__(self, knobs, probe, rules=None, seed=0, window_s=30.0,
                 interval_s=0.0, trials_dir=None, recorder=None,
                 tracer=None, stats=None, breach_fn=None,
                 algo_params=None, freeze_base_s=60.0,
                 freeze_max_s=3600.0, time_fn=time.monotonic,
                 max_decisions=512, device="cpu"):
        self.knobs = knobs
        self.probe = probe
        self.rules = list(rules) if rules is not None else []
        self.seed = int(seed)
        self.window_s = float(window_s)
        self.interval_s = float(interval_s)
        self.recorder = recorder
        self.tracer = tracer
        self.stats = stats if stats is not None else ControlStats()
        # () -> {"transitions": int, "breaching": [rule ids]} — the
        # SL6xx view the safety checks run on (injectable for tests
        # and the forced-breach fixture)
        self.breach_fn = breach_fn if breach_fn is not None else (
            lambda: {"transitions": 0, "breaching": []}
        )
        self.algo_params = dict(CONTROL_ALGO_PARAMS)
        self.algo_params.update(algo_params or {})
        self.device = device
        self.freeze_base_s = float(freeze_base_s)
        self.freeze_max_s = float(freeze_max_s)
        self._time = time_fn
        self.tuned = tuple(
            n for n in DEFAULT_TUNED_KNOBS if n in knobs.specs
        )
        self.bounds = self._derive_bounds()
        self.space = self._build_space()
        self.domain = Domain(_null_objective, self.space)
        self.trials_dir = trials_dir
        self.decisions_log_path = (
            os.path.join(trials_dir, "decisions.jsonl")
            if trials_dir else None
        )
        self._lock = threading.Lock()
        self._decisions = deque(maxlen=int(max_decisions))  # guarded-by: _lock
        self._seq = 0                 # guarded-by: _lock  (decision seq)
        self._frozen = False          # guarded-by: _lock
        self._freezes = 0             # guarded-by: _lock
        self._rearm_at = None         # guarded-by: _lock  (monotonic)
        self.rstate = np.random.default_rng(self.seed)
        self.n_draws = 0
        self.trials = self._load_trials()
        self._stop = threading.Event()
        self._thread = None

    # -- space / durability --------------------------------------------
    def _derive_bounds(self) -> dict:
        """Per-tuned-knob (lo, hi): the KnobSpec envelope intersected
        with the SL6xx guardrails and narrowed to a practical band
        around the static config (an int knob may grow at most 4x its
        static value in one campaign — the controller explores, it
        does not teleport)."""
        rails = guardrail_bounds(self.rules)
        static = self.knobs.static_values()
        bounds = {}
        for name in self.tuned:
            spec = self.knobs.specs[name]
            lo, hi = spec.lo, spec.hi
            if name in rails:
                lo = max(lo, spec.kind(rails[name][0]))
                hi = min(hi, spec.kind(rails[name][1]))
            if spec.kind is int:
                hi = min(hi, max(8, int(static.get(name, 0)) * 4))
            bounds[name] = (lo, hi)
        return bounds

    def _build_space(self) -> dict:
        from .. import hp

        space = {}
        for name in self.tuned:
            spec = self.knobs.specs[name]
            lo, hi = self.bounds[name]
            if spec.kind is int:
                space[name] = hp.quniform(name, lo, hi, 1)
            else:
                space[name] = hp.uniform(name, lo, hi)
        return space

    def _load_trials(self):
        """The controller's own Trials — durable (FileTrials) under
        ``trials_dir``, in-memory otherwise.  On a durable resume:
        stranded NEW/RUNNING docs (a kill mid-window) are repaired to
        failed trials, and the proposal RNG fast-forwards past every
        evidenced draw so the next proposal is exactly the one an
        uninterrupted controller would have made."""
        if not self.trials_dir:
            return Trials()
        from ..parallel.file_trials import FileTrials

        trials = FileTrials(self.trials_dir)
        high = -1
        for doc in trials._dynamic_trials:
            high = max(
                high, int(doc.get("misc", {}).get("control_draw", -1))
            )
            if doc["state"] in (JOB_STATE_NEW, JOB_STATE_RUNNING):
                doc["result"] = {
                    "status": STATUS_FAIL, "reason": "interrupted",
                }
                doc["state"] = JOB_STATE_ERROR
                doc["refresh_time"] = coarse_utcnow()
                trials.jobs.write(doc)
        trials.refresh_local()
        self.fast_forward_draws(high + 1)
        if high >= 0:
            logger.info(
                "control: resumed %d prior trials (%d draws)",
                len(trials._dynamic_trials), self.n_draws,
            )
        return trials

    def fast_forward_draws(self, n: int):
        for _ in range(int(n)):
            self.rstate.integers(2 ** 31 - 1)
        self.n_draws = int(n)

    @property
    def durable(self) -> bool:
        return getattr(self.trials, "jobs", None) is not None

    # -- decision record -----------------------------------------------
    def _decision(self, action: str, **fields) -> dict:
        """One flight-recorded, journaled, traced decision record."""
        with self._lock:
            self._seq += 1
            record = {"seq": self._seq, "t": time.time(),
                      "action": str(action)}
            record.update(fields)
            self._decisions.append(record)
        self.stats.record_decision(action)
        if self.decisions_log_path:
            try:
                # CRC-framed append (the response-journal discipline):
                # a mid-write kill tears at most the final record
                with open(self.decisions_log_path, "ab") as f:
                    f.write(tracing.format_record(record))
            except OSError:  # pragma: no cover - best-effort journal
                pass
        self._emit_span(record)
        return record

    def _emit_span(self, record):
        """A ``control.decision`` span per decision.  The controller
        thread owns no request trace, so it begins (and finishes) a
        one-span trace of its own when the tracer samples."""
        tracer = self.tracer
        if tracer is None or not getattr(tracer, "enabled", False):
            return
        trace = tracer.begin()
        if trace is None:
            return
        try:
            with tracing.use_trace(trace):
                attrs = {
                    "action": record["action"],
                    "seq": record["seq"],
                }
                for key in ("loss", "reason", "tid"):
                    if record.get(key) is not None:
                        attrs[key] = record[key]
                if record.get("knobs"):
                    attrs["knobs"] = json.dumps(
                        record["knobs"], sort_keys=True
                    )
                if record.get("fired_rules"):
                    attrs["fired_rules"] = ",".join(
                        record["fired_rules"]
                    )
                with tracing.span("control.decision", **attrs):
                    pass
        finally:
            tracer.finish(trace)

    def recent_decisions(self) -> list:
        """The bounded decision ring, oldest first — the flight
        recorder's ``control`` evidence provider."""
        with self._lock:
            return [dict(r) for r in self._decisions]

    def decision_log_records(self) -> list:
        """Re-read the durable decision journal (restart-surviving;
        CRC-failing torn tail records are skipped, never fatal)."""
        if (
            not self.decisions_log_path
            or not os.path.exists(self.decisions_log_path)
        ):
            return []
        with open(self.decisions_log_path, "rb") as f:
            records, _torn = tracing.parse_trace_log(f.read())
        return records

    # -- freeze / revert ------------------------------------------------
    @property
    def frozen(self) -> bool:
        with self._lock:
            return self._frozen

    def rearm_in_s(self):
        with self._lock:
            if not self._frozen or self._rearm_at is None:
                return None
            return max(self._rearm_at - self._time(), 0.0)

    def _trip(self, reason: str, fired_rules=None):
        """Revert to static + freeze with exponential re-arm — the one
        safety path for breaches AND controller exceptions."""
        try:
            self.knobs.revert(source="controller:revert")
        except Exception:  # pragma: no cover - revert must not raise
            logger.exception("control: revert failed")
        with self._lock:
            self._frozen = True
            self._freezes += 1
            backoff = min(
                self.freeze_base_s * (2 ** (self._freezes - 1)),
                self.freeze_max_s,
            )
            self._rearm_at = self._time() + backoff
        self.stats.set_frozen(True)
        record = self._decision(
            "reverted", reason=reason,
            fired_rules=list(fired_rules or []),
            knobs=self.knobs.values(), rearm_in_s=round(backoff, 3),
        )
        logger.error(
            "control FREEZE (%s): reverted to static config; re-arm "
            "in %.0fs", reason, backoff,
        )
        if self.recorder is not None:
            try:
                self.recorder.dump(
                    "control:revert", context={"decision": record}
                )
            except Exception:  # pragma: no cover - defensive
                logger.exception("control: flight dump failed")

    # -- trial bookkeeping ---------------------------------------------
    def _insert_proposal(self, docs, draw_index):
        for doc in docs:
            doc.setdefault("misc", {})["control_draw"] = int(draw_index)
            doc["state"] = JOB_STATE_RUNNING
        self.trials.insert_trial_docs(docs)
        stored = self.trials._dynamic_trials[-len(docs):]
        if self.durable:
            for doc in stored:
                self.trials.jobs.write(doc)
            self.trials.refresh_local()
        else:
            self.trials.refresh()
        return stored[0]

    def _land_result(self, doc, result):
        doc["result"] = result
        doc["state"] = (
            JOB_STATE_ERROR if result.get("status") == STATUS_FAIL
            else JOB_STATE_DONE
        )
        doc["refresh_time"] = coarse_utcnow()
        if self.durable:
            self.trials.jobs.write(doc)
            self.trials.refresh_local()
        else:
            self.trials.refresh()

    def propose(self) -> tuple:
        """(doc, knob point) — the next TPE proposal over the
        controller's own history, clamped to the guardrail bounds.
        Consumes one seed draw (resume-exact, like study seeds)."""
        from ..algos import tpe
        from ..fmin import space_eval

        seed = int(self.rstate.integers(2 ** 31 - 1))
        draw_index = self.n_draws
        self.n_draws += 1
        new_ids = self.trials.new_trial_ids(1)
        docs = tpe.suggest(
            new_ids, self.domain, self.trials, seed,
            device=self.device, **self.algo_params,
        )
        vals = {
            k: v[0] for k, v in docs[0]["misc"]["vals"].items() if v
        }
        point = self.knobs.clamp(
            space_eval(self.space, vals), bounds=self.bounds
        )
        doc = self._insert_proposal(docs, draw_index)
        return doc, point

    # -- the cycle ------------------------------------------------------
    def step(self) -> str:
        """One control cycle (synchronous; the thread loop and tests
        share it).  Returns the outcome: ``frozen`` / ``rearmed-hold``
        / ``held`` / ``reverted`` / ``discarded`` / ``evaluated`` /
        ``stopped``."""
        now = self._time()
        with self._lock:
            if self._frozen:
                if self._rearm_at is not None and now < self._rearm_at:
                    return "frozen"
                self._frozen = False
        if self.stats is not None and not self.frozen:
            self.stats.set_frozen(False)
        try:
            return self._cycle()
        except Exception as e:
            logger.exception("control cycle failed")
            self._trip(f"exception:{type(e).__name__}")
            return "reverted"

    def _cycle(self) -> str:
        before = self.breach_fn()
        if before.get("breaching"):
            # never tune INTO an active incident — hold at whatever
            # config is live and let the SLO engine's own machinery
            # (and the freeze path, if a transition fires) work
            self._decision(
                "held", reason="active_breach",
                fired_rules=list(before["breaching"]),
            )
            return "held"
        doc, point = self.propose()
        tid = int(doc["tid"])
        self._decision("proposed", tid=tid, knobs=dict(point))
        opened = self.probe.open()
        self.knobs.set_many(point, source="controller")
        self._decision("applied", tid=tid, knobs=dict(point))
        stopped = self._stop.wait(self.window_s)
        if stopped:
            self._land_result(doc, {
                "status": STATUS_FAIL, "reason": "shutdown",
            })
            return "stopped"
        after = self.breach_fn()
        if after.get("transitions", 0) > before.get("transitions", 0):
            self._land_result(doc, {
                "status": STATUS_FAIL, "reason": "breach",
            })
            self._trip("breach", fired_rules=after.get("breaching"))
            return "reverted"
        result = self.probe.close(opened)
        if not result.ok:
            self._land_result(doc, {
                "status": STATUS_FAIL, "reason": result.reason,
            })
            self._decision(
                "discarded", tid=tid, reason=result.reason,
                window=result.to_dict(),
            )
            return "discarded"
        self._land_result(doc, {
            "status": STATUS_OK, "loss": float(result.loss),
            "window": result.to_dict(),
        })
        self.stats.set_objective(result.loss)
        self._decision(
            "evaluated", tid=tid, loss=round(float(result.loss), 6),
            knobs=dict(point), window=result.to_dict(),
        )
        return "evaluated"

    # -- lifecycle ------------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="hyperopt-control", daemon=True
        )
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            outcome = self.step()
            if self._stop.is_set():
                return
            if outcome == "frozen":
                wait = self.rearm_in_s()
                self._stop.wait(
                    min(wait, 1.0) if wait is not None else 1.0
                )
            elif outcome == "held":
                # an active breach: back off a full window before
                # looking again
                self._stop.wait(max(self.window_s, 1.0))
            elif self.interval_s > 0:
                self._stop.wait(self.interval_s)

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # -- read surface ---------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            frozen = self._frozen
            freezes = self._freezes
            n_decisions = self._seq
        rearm = self.rearm_in_s()
        n_done = n_failed = 0
        for doc in self.trials._dynamic_trials:
            if doc["state"] == JOB_STATE_DONE:
                n_done += 1
            elif doc["state"] == JOB_STATE_ERROR:
                n_failed += 1
        return {
            "frozen": frozen,
            "freezes_total": freezes,
            "rearm_in_s": round(rearm, 3) if rearm is not None else None,
            "n_decisions": n_decisions,
            "n_trials": len(self.trials._dynamic_trials),
            "n_evaluated": n_done,
            "n_discarded": n_failed,
            "n_draws": self.n_draws,
            "window_s": self.window_s,
            "seed": self.seed,
            "durable": self.durable,
            "tuned": list(self.tuned),
            "bounds": {
                k: [self.bounds[k][0], self.bounds[k][1]]
                for k in sorted(self.bounds)
            },
        }
