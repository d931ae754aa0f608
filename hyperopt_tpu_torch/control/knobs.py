"""Live serving knobs — the thread-safe registry the scheduler reads.

The service's tunable serving parameters (batch window, batch size k,
admission limit, speculation depth) historically froze at construction:
``SuggestScheduler`` copied them into attributes and nothing could move
them without a restart.  :class:`KnobSet` replaces the frozen copies
with one lock-guarded table that the scheduler reads PER BATCH, so a
runtime change (``POST /v1/config``, or the closed-loop controller in
:mod:`.controller`) takes effect on the very next batch — and the
static constructor values remain pinned as the always-available revert
target.

Every mutation is validated against the knob's :class:`KnobSpec`
(type, bounds), recorded in a bounded in-memory provenance ring, and —
when the service runs with a durable root — appended to a JSONL
provenance journal, so "who changed what, when, from what to what" is
answerable after a restart.

With no mutations applied, :meth:`KnobSet.get` returns exactly the
constructor values: the control-plane-off service is behaviorally
identical to the pre-KnobSet service (machine-checked in
``tests/test_control.py``).
"""

import os
import threading
import time
from collections import deque

from ..tracing import format_record, parse_trace_log

__all__ = ["KnobSpec", "KnobSet", "KNOB_SPECS", "guardrail_bounds"]


class KnobSpec:
    """One knob's contract: name, scalar type, and hard bounds.

    The bounds here are the VALIDATION envelope (what ``/v1/config``
    will accept at all); the controller additionally clamps its
    proposals to the narrower guardrail bounds derived from the SL6xx
    rule catalog (:func:`guardrail_bounds`).
    """

    __slots__ = ("name", "kind", "lo", "hi", "doc")

    def __init__(self, name, kind, lo, hi, doc=""):
        self.name = str(name)
        self.kind = kind          # int or float
        self.lo = kind(lo)
        self.hi = kind(hi)
        self.doc = str(doc)

    def coerce(self, value):
        """Type-coerce only, no range check — the constructor-args
        path: static values are the operator's ground truth even when
        they sit outside the runtime-write envelope (``max_queue=0``
        as deliberate admission-off, say)."""
        try:
            if self.kind is int:
                # refuse silent float truncation: 3.7 is not an int
                if isinstance(value, float) and not value.is_integer():
                    raise ValueError
                return int(value)
            return float(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"knob {self.name!r} expects {self.kind.__name__}, "
                f"got {value!r}"
            )

    def validate(self, value):
        """Coerce ``value`` to this knob's type and range-check it.
        Raises ``ValueError`` on a type mismatch or an out-of-bounds
        value — the ``/v1/config`` 400 path."""
        coerced = self.coerce(value)
        if not (self.lo <= coerced <= self.hi):
            raise ValueError(
                f"knob {self.name!r} value {coerced!r} outside "
                f"[{self.lo}, {self.hi}]"
            )
        return coerced

    def clamp(self, value):
        """Coerce and clamp into bounds (the controller's proposal
        path — a TPE point just outside the envelope is pulled to the
        edge, never rejected)."""
        coerced = self.kind(value)
        return max(self.lo, min(self.hi, coerced))

    def to_dict(self):
        return {
            "name": self.name,
            "type": self.kind.__name__,
            "lo": self.lo,
            "hi": self.hi,
            "doc": self.doc,
        }


# the serving-knob catalog: every runtime-tunable parameter of the
# suggest plane.  ``max_speculation`` bounds the number of CONCURRENT
# cold-containment background compiles (0 = unbounded, today's
# behavior); it only matters with --cold-fallback on.
KNOB_SPECS = (
    KnobSpec(
        "batch_window", float, 0.0, 0.5,
        doc="seconds the scheduler holds a >1 batch open for stragglers",
    ),
    KnobSpec(
        "max_batch", int, 1, 1024,
        doc="max suggest requests fused into one device program (k)",
    ),
    KnobSpec(
        "max_queue", int, 1, 65536,
        doc="admission limit: queued suggests beyond this get 429",
    ),
    KnobSpec(
        "max_speculation", int, 0, 64,
        doc="max concurrent background cold-containment compiles "
            "(0 = unbounded)",
    ),
)


def guardrail_bounds(rules):
    """Per-knob (lo, hi) overrides derived from the SL6xx rule catalog
    — the controller's proposal clamp.

    The derivation is deliberately conservative: the batch window is
    pure added latency on every coalesced batch, so its ceiling is a
    small fraction of SL602's absolute p99 bound (a controller that
    proposed ``p99_bound_s`` itself would engineer the breach it is
    supposed to avoid).  Knobs without a rule-derived bound keep their
    :data:`KNOB_SPECS` envelope.
    """
    bounds = {}
    for rule in rules or ():
        rule_id = getattr(rule, "rule_id", None)
        try:
            obj = rule.objective()
        except Exception:
            continue
        if rule_id == "SL602" and obj.get("p99_bound_s"):
            spec = {s.name: s for s in KNOB_SPECS}["batch_window"]
            hi = min(spec.hi, float(obj["p99_bound_s"]) / 20.0)
            bounds["batch_window"] = (spec.lo, hi)
    return bounds


class KnobSet:
    """The live knob table.  Thread-safe: HTTP handler threads
    (``POST /v1/config``), the controller thread, and the scheduler
    thread read/write concurrently.
    """

    # lock-order: _lock (leaf — never held across I/O other than the
    # provenance append, which is a single O_APPEND write)
    def __init__(self, static=None, journal_path=None,
                 specs=KNOB_SPECS, max_provenance=256):
        self.specs = {s.name: s for s in specs}
        self._lock = threading.Lock()
        values = {s.name: s.kind(s.lo) for s in specs}
        for name, value in dict(static or {}).items():
            if name not in self.specs:
                raise ValueError(f"unknown knob {name!r}")
            values[name] = self.specs[name].coerce(value)
        # the static (constructor) config — the revert target; frozen
        self._static = dict(values)
        self._values = dict(values)   # guarded-by: _lock
        self._provenance = deque(maxlen=int(max_provenance))  # guarded-by: _lock
        self._n_changes = 0           # guarded-by: _lock
        self.journal_path = journal_path
        if journal_path:
            os.makedirs(os.path.dirname(journal_path), exist_ok=True)

    # -- reads ---------------------------------------------------------
    def get(self, name):
        with self._lock:
            return self._values[name]

    def values(self) -> dict:
        with self._lock:
            return dict(self._values)

    def static_values(self) -> dict:
        return dict(self._static)

    @property
    def is_static(self) -> bool:
        with self._lock:
            return self._values == self._static

    @property
    def n_changes(self) -> int:
        with self._lock:
            return self._n_changes

    def provenance(self) -> list:
        """The bounded in-memory change history, oldest first."""
        with self._lock:
            return [dict(r) for r in self._provenance]

    # -- mutation ------------------------------------------------------
    def set_many(self, changes: dict, source: str) -> dict:
        """Validate and apply a batch of knob changes atomically.
        Returns the post-apply values.  Raises ``ValueError`` on ANY
        invalid name/value — all-or-nothing, so a half-valid request
        can never leave the set in a mixed state."""
        validated = {}
        for name, value in dict(changes).items():
            spec = self.specs.get(str(name))
            if spec is None:
                raise ValueError(f"unknown knob {name!r}")
            validated[spec.name] = spec.validate(value)
        return self._apply(validated, source)

    def _apply(self, validated: dict, source: str) -> dict:
        with self._lock:
            before = {k: self._values[k] for k in validated}
            delta = {
                k: v for k, v in validated.items() if before[k] != v
            }
            self._values.update(validated)
            self._n_changes += 1
            record = {
                "t": time.time(),
                "source": str(source),
                "changes": dict(validated),
                "before": before,
                "values": dict(self._values),
                "noop": not delta,
            }
            self._provenance.append(record)
            after = dict(self._values)
        self._append_journal(record)
        return after

    def clamp(self, changes: dict, bounds=None) -> dict:
        """Coerce ``changes`` into the validation envelope (and the
        narrower ``bounds`` overrides when given) WITHOUT applying —
        the controller runs every TPE proposal through this before
        :meth:`set_many`."""
        out = {}
        for name, value in dict(changes).items():
            spec = self.specs[str(name)]
            clamped = spec.clamp(value)
            if bounds and name in bounds:
                lo, hi = bounds[name]
                clamped = max(spec.kind(lo), min(spec.kind(hi), clamped))
            out[spec.name] = clamped
        return out

    def revert(self, source: str) -> dict:
        """Restore the static (constructor) config — the safety path.
        Journaled like any other change, but never re-range-checked:
        the constructor values are legal by definition, even when they
        sit outside the runtime-write envelope."""
        return self._apply(dict(self._static), source=source)

    def _append_journal(self, record):
        if not self.journal_path:
            return
        try:
            # CRC-framed append (the response-journal discipline): a
            # mid-write kill tears at most the final record, and the
            # reader proves it torn instead of guessing
            with open(self.journal_path, "ab") as f:
                f.write(format_record(record))
        except OSError:  # pragma: no cover - provenance is best-effort
            pass

    def journal_records(self) -> list:
        """Re-read the durable provenance journal (restart-surviving
        history; empty without a journal path).  CRC-failing tail
        records from a mid-append kill are skipped, never fatal."""
        if not self.journal_path or not os.path.exists(self.journal_path):
            return []
        with open(self.journal_path, "rb") as f:
            records, _torn = parse_trace_log(f.read())
        return records

    def describe(self) -> dict:
        """The ``GET /v1/config`` knob block: specs + live values +
        static values."""
        with self._lock:
            values = dict(self._values)
            n_changes = self._n_changes
        return {
            "knobs": {
                name: {
                    **spec.to_dict(),
                    "value": values[name],
                    "static": self._static[name],
                }
                for name, spec in sorted(self.specs.items())
            },
            "is_static": values == self._static,
            "n_changes": n_changes,
        }
