"""Per-trial retry policy: backoff, jitter, timeouts, quarantine.

Reference parity: ``hyperopt_tpu/resilience/retry.py``, with the
service client's circuit breaker (:class:`CircuitBreaker`).

A flaky objective (transient OOM, a preempted data source, a network
hiccup) or a hung one must not abort a whole ``fmin`` run.  This module
gives every trial a bounded number of attempts with exponential backoff
and **deterministic** jitter (the jitter is a pure function of
``(seed, trial key, attempt)``, so a re-run of the same campaign sleeps
the same schedule — chaos runs stay reproducible), plus a per-trial
objective timeout enforced by a watchdog thread — distinct from
``fmin``'s global ``timeout``, which bounds the whole run.

A trial that exhausts ``max_attempts`` is **quarantined**: it lands in
``JOB_STATE_ERROR``, which the history builder already excludes from the
TPE fit, instead of poisoning the fit or killing the run
(:class:`TrialQuarantined` carries the last error for the driver to
record).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import dataclass

# single source of truth for the queue's lease TTL default — the policy
# default and the queue-side default must not drift apart
from ..parallel.file_trials import DEFAULT_LEASE_TTL


class TrialTimeout(Exception):
    """The objective exceeded the per-trial ``trial_timeout`` watchdog."""


class TrialQuarantined(Exception):
    """A trial exhausted ``max_attempts`` and was quarantined.

    ``last_error`` is the exception from the final attempt; ``attempts``
    the number of executions that were tried."""

    def __init__(self, msg, last_error=None, attempts=0):
        super().__init__(msg)
        self.last_error = last_error
        self.attempts = attempts


@dataclass(frozen=True)
class RetryPolicy:
    """Knobs of the fault-tolerance layer (``fmin(retry_policy=...)``).

    - ``max_attempts``: executions a trial may consume (reservations by
      workers and in-place retries both count) before quarantine.
    - ``backoff_base`` / ``backoff_multiplier`` / ``backoff_max``:
      attempt *k* (1-based) sleeps
      ``min(base * multiplier**(k-1), backoff_max)`` scaled by jitter.
    - ``jitter``: relative jitter width; the factor is deterministic in
      ``(seed, key, attempt)`` and lies in ``[1-jitter, 1+jitter]``.
    - ``trial_timeout``: per-trial objective watchdog in seconds (None
      disables).  Orthogonal to ``fmin``'s global ``timeout``.
    - ``lease_ttl``: heartbeat lease time-to-live for FileTrials
      reservations (see :mod:`hyperopt_tpu_torch.resilience.leases`).
    - ``reap_interval``: reaper scan period; None → ``lease_ttl / 4``.
    - ``seed``: jitter seed (campaign reproducibility).
    """

    max_attempts: int = 3
    backoff_base: float = 0.1
    backoff_multiplier: float = 2.0
    backoff_max: float = 30.0
    jitter: float = 0.1
    trial_timeout: float | None = None
    lease_ttl: float = DEFAULT_LEASE_TTL
    reap_interval: float | None = None
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        if self.lease_ttl <= 0:
            raise ValueError(
                f"lease_ttl must be positive, got {self.lease_ttl}"
            )

    @property
    def effective_reap_interval(self) -> float:
        if self.reap_interval is not None:
            return self.reap_interval
        return self.lease_ttl / 4.0

    # -- (de)serialization for the queue attachment --------------------
    def to_json(self) -> bytes:
        """Encode for the ``FMinIter_RetryPolicy`` queue attachment, so
        out-of-process workers inherit the driver's policy."""
        return json.dumps(
            {f: getattr(self, f) for f in self.__dataclass_fields__},
            sort_keys=True,
        ).encode()

    @classmethod
    def from_json(cls, blob: bytes) -> "RetryPolicy":
        d = json.loads(blob.decode())
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        return cls(**known)


def _unit_hash(*parts) -> float:
    """Deterministic uniform in [0, 1) from arbitrary hashable parts."""
    h = hashlib.sha256(":".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2 ** 64


def backoff_delay(policy: RetryPolicy, attempt: int, key=0) -> float:
    """Sleep before attempt ``attempt + 1`` (``attempt`` is 1-based, the
    attempt that just failed).  Exponential in the attempt number, capped
    at ``backoff_max``, scaled by deterministic jitter so concurrent
    retries for different trials decorrelate without breaking seed
    reproducibility."""
    base = policy.backoff_base * policy.backoff_multiplier ** (attempt - 1)
    base = min(base, policy.backoff_max)
    if policy.jitter:
        frac = _unit_hash(policy.seed, key, attempt)
        base *= 1.0 + policy.jitter * (2.0 * frac - 1.0)
    return base


class CircuitOpenError(Exception):
    """The circuit breaker is open: the peer has failed ``threshold``
    consecutive times and the cooldown has not elapsed.  ``retry_in``
    says how long until the breaker half-opens for a probe."""

    def __init__(self, msg, retry_in=0.0):
        super().__init__(msg)
        self.retry_in = float(retry_in)


class CircuitBreaker:
    """Trip-after-N circuit breaker for a flaky peer (the service
    client wraps every HTTP round-trip in one).

    Closed → open after ``threshold`` CONSECUTIVE transport failures
    (an HTTP error response counts as success at this layer: the peer
    answered).  While open, :meth:`before_request` reports how long
    until the next probe is allowed; after ``cooldown`` seconds the
    breaker half-opens — ONE caller gets through, and its outcome
    closes or re-opens the circuit.  Thread-safe.
    """

    # lock-order: _lock
    def __init__(self, threshold=5, cooldown=1.0, clock=time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0  # guarded-by: _lock
        self._opened_at = None  # guarded-by: _lock
        self._probing = False  # guarded-by: _lock

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self._probing:
                return "half-open"
            if self._clock() - self._opened_at >= self.cooldown:
                return "half-open"
            return "open"

    def before_request(self) -> float:
        """0.0 = proceed (and, when half-open, this caller IS the
        probe); > 0.0 = the breaker is open for that many more seconds
        and the caller must wait or fail fast."""
        with self._lock:
            if self._opened_at is None:
                return 0.0
            remaining = self.cooldown - (self._clock() - self._opened_at)
            if remaining > 0.0:
                return remaining
            if self._probing:
                # someone else holds the half-open probe slot
                return self.cooldown / 2.0
            self._probing = True
            return 0.0

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self):
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._failures >= self.threshold:
                self._opened_at = self._clock()


def run_with_timeout(fn, timeout, stats=None):
    """Run ``fn()`` under a watchdog: raises :class:`TrialTimeout` after
    ``timeout`` seconds.  The objective runs in a short-lived daemon
    thread; on timeout the thread is *abandoned* (Python cannot kill it),
    so a hung objective leaks one sleeping thread — the price of not
    hanging the whole run.  A late result from an abandoned attempt is
    discarded, never delivered."""
    if timeout is None:
        return fn()
    box = {}
    done = threading.Event()

    def _target():
        try:
            box["result"] = fn()
        except BaseException as e:  # delivered to the caller below
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(
        target=_target, name="hyperopt-trial-watchdog", daemon=True
    )
    t.start()
    if not done.wait(timeout):
        if stats is not None:
            stats.record("objective_timeout")
        raise TrialTimeout(f"objective exceeded trial_timeout={timeout}s")
    if "error" in box:
        raise box["error"]
    return box["result"]


def execute_with_retry(
    fn,
    policy: RetryPolicy,
    key=0,
    stats=None,
    first_attempt: int = 1,
    sleep=time.sleep,
    on_retry=None,
):
    """Run ``fn()`` under ``policy``: up to ``max_attempts`` executions,
    backoff+jitter between them, per-attempt watchdog when
    ``trial_timeout`` is set.

    ``first_attempt`` lets a caller that already burned attempts (a
    worker resuming a reclaimed trial with a doc-recorded attempt
    counter) start the accounting mid-way.  ``on_retry(attempt, error)``
    is called before each backoff sleep (workers use it to renew their
    lease and checkpoint the attempt counter).

    Returns ``(result, attempts_used)``.  Raises
    :class:`TrialQuarantined` (chained to the last error) when the
    budget is exhausted."""
    attempt = max(int(first_attempt), 1)
    while True:
        try:
            result = run_with_timeout(fn, policy.trial_timeout, stats=stats)
            return result, attempt
        except Exception as e:
            if stats is not None:
                stats.record("trial_failure")
            if attempt >= policy.max_attempts:
                if stats is not None:
                    stats.record("trial_quarantined")
                raise TrialQuarantined(
                    f"trial quarantined after {attempt} attempt(s): {e!r}",
                    last_error=e,
                    attempts=attempt,
                ) from e
            if on_retry is not None:
                on_retry(attempt, e)
            delay = backoff_delay(policy, attempt, key=key)
            if stats is not None:
                stats.record("trial_retried")
                stats.record_backoff(delay)
            sleep(delay)
            attempt += 1
