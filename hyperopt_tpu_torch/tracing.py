"""End-to-end request tracing: trace ids, nested spans, a crash-tolerant log.

Reference parity: ``hyperopt_tpu/tracing.py`` (stdlib only, copied with
the port's import paths).  Every client call gets a **trace id**
(propagated via the ``X-Hyperopt-Trace`` header and accepted from
callers), each hop opens a named **span** with monotonic timestamps, and
a finished trace lands as ONE appended record in a bounded,
crash-tolerant JSONL log.  The trial store (``parallel.file_trials``,
``journal_io``) opens spans around its writes and frames its records
through :func:`format_record`.

Design constraints, in priority order:

1. **Off means off.**  With sampling disabled the hot path must be a
   measurable no-op: :func:`span` costs one thread-local read and
   returns a shared null singleton — no allocation, no lock, no clock
   read.  (Acceptance: loadgen suggest p50 within 5% of untraced.)
2. **Spans never leak across threads.**  The current trace binds to a
   thread only through :func:`use_trace`; a thread that never bound one
   sees ``None`` (a new thread starts clean — ``threading.local``).
   Cross-thread handoff is explicit: the carrier object holds the
   :class:`Trace` + parent :class:`Span`, and the worker re-binds.
3. **Crash-tolerant, bounded log.**  Every finished trace is ONE
   ``O_APPEND`` write of ``\\n<crc32 hex> <json>`` — the response
   journal's proven resync discipline (a torn tail garbles at most the
   record being written; the next record's leading newline
   re-synchronizes the reader).  The log rotates once (``<path>.1``)
   past ``max_bytes``, so it is bounded at ~2x that.
4. **Tail-latency traces are never lost to sampling.**  Head sampling
   (deterministic in the trace id, so one decision holds across layers)
   picks the steady-state fraction; ``slow_threshold_s`` additionally
   writes ANY trace whose root exceeds it — the p99 request is always in
   the log, whatever ``--trace-sample`` says.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
import zlib

logger = logging.getLogger(__name__)

TRACE_HEADER = "X-Hyperopt-Trace"

# trace/span ids are opaque tokens; these bounds keep a hostile or buggy
# caller's header from bloating every span record
_MAX_ID_LEN = 64


def new_trace_id() -> str:
    return uuid.uuid4().hex


def _clean_id(trace_id) -> str:
    tid = str(trace_id)
    if not tid or len(tid) > _MAX_ID_LEN or not tid.isprintable():
        return new_trace_id()
    return tid


class Span:
    """One named, timed region of one trace.

    Created through :func:`span` / :meth:`Trace.record_span`, never
    directly.  ``t0``/``t1`` are ``time.monotonic()`` seconds; the log
    record stores offsets from the trace start so readers never compare
    monotonic clocks across processes.  ``thread`` is the name of the
    thread that opened the span (one trace can span the fmin loop's
    thread and its objective's worker).
    """

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "attrs", "thread")

    def __init__(self, name, span_id, parent_id, t0, attrs=None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = None
        self.attrs = attrs
        self.thread = threading.current_thread().name

    def set_attr(self, key, value):
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def update_attrs(self, mapping):
        """Bulk attribute attach (e.g. the roofline attrs the scheduler
        adds to a ``device.dispatch`` span after the profiler's record
        lands).  ``None`` values are kept — a null roofline field is
        information (the cost model declined to attribute)."""
        if not mapping:
            return
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(mapping)

    @property
    def duration_s(self):
        return None if self.t1 is None else self.t1 - self.t0


class _NullSpan:
    """The shared no-op span: what every span call returns when no trace
    is bound (or the tracer is disabled).  Accepts the full Span surface
    so call sites never branch."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key, value):
        pass

    def update_attrs(self, mapping):
        pass

    name = None
    span_id = None
    parent_id = None
    duration_s = None


NULL_SPAN = _NullSpan()


class Trace:
    """One request's span tree, buffered until :meth:`Tracer.finish`.

    Thread-safe append: the HTTP handler thread and the scheduler worker
    both add spans to the same trace.
    """

    # lock-order: _lock
    __slots__ = ("trace_id", "head_sampled", "t_start", "wall_start",
                 "_lock", "_spans", "_next_span", "root")

    def __init__(self, trace_id, head_sampled):
        self.trace_id = trace_id
        self.head_sampled = bool(head_sampled)
        self.t_start = time.monotonic()
        self.wall_start = time.time()
        self._lock = threading.Lock()
        self._spans = []  # guarded-by: _lock
        self._next_span = 0  # guarded-by: _lock
        self.root = None  # the first span opened; set once by _new_span

    def _new_span(self, name, parent_id, t0, attrs):
        with self._lock:
            self._next_span += 1
            sp = Span(name, self._next_span, parent_id, t0, attrs or None)
            self._spans.append(sp)
        if self.root is None:
            self.root = sp
        return sp

    def record_span(self, name, t0, t1, parent=None, **attrs):
        """Append an already-measured span (retroactive intervals like
        queue wait, or batch-wide intervals shared by every request in a
        coalesced batch)."""
        parent_id = parent.span_id if parent is not None else None
        sp = self._new_span(name, parent_id, t0, attrs)
        sp.t1 = t1
        return sp

    def add_event(self, name, parent=None, **attrs):
        """A zero-duration marker span (e.g. one kernel build event)."""
        now = time.monotonic()
        return self.record_span(name, now, now, parent=parent, **attrs)

    def spans(self):
        with self._lock:
            return list(self._spans)

    def to_record(self) -> dict:
        """The JSON-able log record: root summary + flat span list with
        start offsets relative to the trace start."""
        root = self.root
        spans = []
        for sp in self.spans():
            rec = {
                "name": sp.name,
                "id": sp.span_id,
                "parent": sp.parent_id,
                "t0_s": round(sp.t0 - self.t_start, 6),
                "dur_s": round(
                    (sp.t1 if sp.t1 is not None else time.monotonic())
                    - sp.t0, 6,
                ),
                "thread": sp.thread,
            }
            if sp.attrs:
                rec["attrs"] = sp.attrs
            spans.append(rec)
        return {
            "trace_id": self.trace_id,
            "start_unix": round(self.wall_start, 6),
            "root": root.name if root is not None else None,
            "root_attrs": (root.attrs or {}) if root is not None else {},
            "duration_s": (
                round(root.duration_s, 6)
                if root is not None and root.duration_s is not None
                else None
            ),
            "spans": spans,
        }


# ---------------------------------------------------------------------
# thread binding
# ---------------------------------------------------------------------

_tls = threading.local()


def current_trace():
    """The trace bound to THIS thread (None when unbound — a fresh
    thread always starts unbound; traces never leak across threads)."""
    return getattr(_tls, "trace", None)


def current_trace_id():
    tr = getattr(_tls, "trace", None)
    return tr.trace_id if tr is not None else None


def current_span():
    """The innermost open span on this thread (None when unbound)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class _TraceBinding:
    """Context manager binding ``trace`` (and a base parent span) to the
    current thread for the block.  Re-entrant across threads: the
    scheduler binds a request's trace around that request's share of the
    batch work, then unbinds — restoring whatever was bound before."""

    __slots__ = ("trace", "parent", "_saved")

    def __init__(self, trace, parent):
        self.trace = trace
        self.parent = parent
        self._saved = None

    def __enter__(self):
        self._saved = (
            getattr(_tls, "trace", None), getattr(_tls, "stack", None)
        )
        _tls.trace = self.trace
        _tls.stack = [self.parent] if self.parent is not None else []
        return self.trace

    def __exit__(self, *exc):
        _tls.trace, _tls.stack = self._saved
        return False


def use_trace(trace, parent=None):
    """Bind ``trace`` to this thread for a ``with`` block; spans created
    inside (on this thread) attach to it, nested under ``parent`` when
    given.  ``use_trace(None)`` is a cheap no-op binding (call sites
    never branch on 'is tracing on')."""
    return _TraceBinding(trace, parent)


class _SpanCM:
    __slots__ = ("trace", "name", "attrs", "span")

    def __init__(self, trace, name, attrs):
        self.trace = trace
        self.name = name
        self.attrs = attrs
        self.span = None

    def __enter__(self):
        parent = current_span()
        self.span = self.trace._new_span(
            self.name,
            parent.span_id if parent is not None else None,
            time.monotonic(),
            self.attrs or None,
        )
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        self.span.t1 = time.monotonic()
        if exc_type is not None:
            self.span.set_attr("error", exc_type.__name__)
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self.span:
            stack.pop()
        return False


def span(name, **attrs):
    """Open a named child span under this thread's current trace.

    The hot-path contract: with no trace bound this returns the shared
    :data:`NULL_SPAN` singleton — no allocation, no lock, no clock read.
    """
    tr = getattr(_tls, "trace", None)
    if tr is None:
        return NULL_SPAN
    return _SpanCM(tr, name, attrs)


def add_event(name, **attrs):
    """Zero-duration marker on this thread's current trace (no-op when
    unbound) — e.g. a device-recovery action or a chaos injection."""
    tr = getattr(_tls, "trace", None)
    if tr is None:
        return NULL_SPAN
    parent = current_span()
    return tr.add_event(name, parent=parent, **attrs)


# ---------------------------------------------------------------------
# the tracer (sampling + log)
# ---------------------------------------------------------------------


def head_sampled(trace_id: str, sample: float) -> bool:
    """Deterministic head-sampling decision: a pure function of the
    trace id, so every layer that sees the id makes the SAME call."""
    if sample >= 1.0:
        return True
    if sample <= 0.0:
        return False
    h = zlib.crc32(str(trace_id).encode()) & 0xFFFFFFFF
    return h / 2 ** 32 < sample


def format_record(payload: dict, default=None) -> bytes:
    """One log record: ``\\n<crc32 hex> <json>`` in ONE buffer — the
    response journal's resync discipline (leading newline + per-record
    CRC), so a torn append garbles at most itself.  ``default`` passes
    through to ``json.dumps`` (the flight recorder stringifies
    non-JSON evidence leaves; trace records never need it)."""
    body = json.dumps(payload, sort_keys=True, default=default).encode()
    return b"\n%08x %s" % (zlib.crc32(body) & 0xFFFFFFFF, body)


def parse_trace_log(raw: bytes):
    """(records, n_torn) from raw trace-log bytes.  Lines failing their
    CRC or JSON parse count as torn and are skipped — after a mid-write
    SIGKILL only the final append can legitimately be torn."""
    records, torn = [], 0
    for line in raw.split(b"\n"):
        line = line.strip()
        if not line:
            continue
        try:
            crc_hex, body = line.split(b" ", 1)
            if (zlib.crc32(body) & 0xFFFFFFFF) != int(crc_hex, 16):
                raise ValueError("crc mismatch")
            records.append(json.loads(body.decode()))
        except (ValueError, json.JSONDecodeError, UnicodeDecodeError):
            torn += 1
    return records, torn


def read_trace_log(path):
    """(records, n_torn) for a trace log file (rotated sibling
    ``<path>.1`` read first when present, so records stay in rough
    append order across one rotation)."""
    records, torn = [], 0
    for p in (f"{path}.1", path):
        try:
            with open(p, "rb") as f:
                raw = f.read()
        except OSError:
            continue
        r, t = parse_trace_log(raw)
        records.extend(r)
        torn += t
    return records, torn


DEFAULT_MAX_BYTES = 64 * 1024 * 1024


class Tracer:
    """Sampling policy + the bounded trace log for one server process.

    ``sample`` is the head-sampling rate in [0, 1]; ``slow_threshold_s``
    additionally writes any trace whose root span exceeds it (tail-based
    rescue for exactly the requests worth explaining).  With ``sample``
    0 and no slow threshold the tracer is **disabled**: :meth:`begin`
    returns None and every downstream span call no-ops.

    Thread-safe: handler threads begin/finish traces concurrently; the
    log write is one O_APPEND syscall under ``_io_lock``.
    """

    # lock-order: _io_lock
    def __init__(self, path=None, sample=0.0, slow_threshold_s=None,
                 max_bytes=DEFAULT_MAX_BYTES):
        self.path = path
        self.sample = float(sample)
        self.slow_threshold_s = (
            None if slow_threshold_s is None else float(slow_threshold_s)
        )
        self.max_bytes = int(max_bytes)
        # optional flight-recorder ring fed EVERY finished trace before
        # the head-sampling keep/drop decision (None = not installed —
        # the common case, one attribute read in finish()).  The
        # sample-0 fast path is untouched: a disabled tracer begins no
        # traces, so there is nothing to retain.
        self._recorder = None
        self._io_lock = threading.Lock()
        self._bytes_written = 0  # guarded-by: _io_lock
        self._n_rotations = 0  # guarded-by: _io_lock
        self._counts_lock = threading.Lock()
        self._n_begun = 0  # guarded-by: _counts_lock
        self._n_written = 0  # guarded-by: _counts_lock
        self._n_dropped = 0  # guarded-by: _counts_lock
        self._n_unlogged = 0  # guarded-by: _counts_lock  (kept, no path)
        if self.path:
            parent = os.path.dirname(os.path.abspath(self.path))
            try:
                os.makedirs(parent, exist_ok=True)
            except OSError:
                logger.warning(
                    "cannot create trace-log dir %s", parent, exc_info=True
                )
            try:
                self._bytes_written = os.path.getsize(self.path)
            except OSError:
                pass

    @property
    def enabled(self) -> bool:
        return self.sample > 0.0 or self.slow_threshold_s is not None

    def begin(self, trace_id=None):
        """Start (or adopt) a trace.  Returns None when disabled — the
        null value flows through ``use_trace(None)`` and every span call
        no-ops, which IS the sampling-off hot path.

        A head-DROPPED request is also None **unless** a slow threshold
        is set (tail rescue needs the buffered spans to know the
        duration): at sample 0.01 the other 99% of requests must not
        pay for Trace allocation and span bookkeeping they will never
        serialize."""
        if not self.enabled:
            return None
        tid = _clean_id(trace_id) if trace_id is not None else new_trace_id()
        sampled = head_sampled(tid, self.sample)
        if not sampled and self.slow_threshold_s is None:
            with self._counts_lock:
                self._n_dropped += 1
            return None
        trace = Trace(tid, sampled)
        with self._counts_lock:
            self._n_begun += 1
        return trace

    def set_recorder(self, recorder):
        """Install (or with None, remove) a flight recorder whose ring
        retains every finished trace regardless of head-sampling."""
        self._recorder = recorder

    def finish(self, trace):
        """Close out a trace: decide head-sample OR slow, then append
        its record.  Never raises — tracing must not fail a request."""
        if trace is None:
            return False
        try:
            recorder = self._recorder
            if recorder is not None:
                # retention happens BEFORE the sampling decision: the
                # recorder's window is "last N finished traces", and a
                # head-dropped p99 outlier is exactly the evidence a
                # breach bundle exists to carry
                recorder.record_trace(trace)
            keep = trace.head_sampled
            if not keep and self.slow_threshold_s is not None:
                root = trace.root
                dur = root.duration_s if root is not None else None
                keep = dur is not None and dur >= self.slow_threshold_s
            if not keep or self.path is None:
                with self._counts_lock:
                    if not keep:
                        self._n_dropped += 1
                    else:
                        # kept but nowhere to land (no log path
                        # configured) — account for it so n_begun
                        # always reconciles against the other counters
                        self._n_unlogged += 1
                return False
            line = format_record(trace.to_record())
            with self._io_lock:
                if self._bytes_written + len(line) > self.max_bytes:
                    self._rotate()
                fd = os.open(
                    self.path,
                    os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644,
                )
                try:
                    os.write(fd, line)
                finally:
                    os.close(fd)
                self._bytes_written += len(line)
            with self._counts_lock:
                self._n_written += 1
            return True
        except Exception:
            logger.warning("trace write failed", exc_info=True)
            return False

    def _rotate(self):
        """One-deep rotation (caller holds ``_io_lock``): the previous
        generation is overwritten, bounding the log at ~2x max_bytes."""
        try:
            os.replace(self.path, f"{self.path}.1")
        except OSError:
            logger.warning("trace log rotation failed", exc_info=True)
        self._bytes_written = 0  # lint: disable=RL301  caller holds _io_lock
        self._n_rotations += 1  # lint: disable=RL301  caller holds _io_lock

    def summary(self) -> dict:
        with self._counts_lock:
            begun, written, dropped, unlogged = (
                self._n_begun, self._n_written, self._n_dropped,
                self._n_unlogged,
            )
        with self._io_lock:
            rotations = self._n_rotations
        return {
            "enabled": self.enabled,
            "sample": self.sample,
            "slow_threshold_s": self.slow_threshold_s,
            "path": self.path,
            "n_begun": begun,
            "n_written": written,
            "n_dropped": dropped,
            "n_unlogged": unlogged,
            "n_rotations": rotations,
        }


# A permanently-disabled tracer for call sites that want a non-None
# default (OptimizationService without tracing configured).
DISABLED = Tracer(sample=0.0)
