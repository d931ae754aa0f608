"""ServiceClient — the library side of the optimization service.

Wraps the localhost HTTP API in typed calls and makes them **safe to
retry automatically**:

- every mutating call (``create_study``/``suggest``/``report``) carries
  a client-generated idempotency key, so a connection reset or timeout
  mid-request can be retried blindly — the server either never saw the
  request (retry executes it) or journaled it (retry replays the
  byte-identical response, consuming nothing);
- transport failures (connection reset/refused, timeout, a torn
  response) retry with exponential backoff and **deterministic** jitter
  (a pure function of ``(retry_seed, route, attempt)`` — campaign runs
  sleep the same schedule), bounded by ``max_transport_retries`` and a
  per-call ``deadline``;
- a trip-after-N :class:`~hyperopt_tpu_torch.resilience.retry.CircuitBreaker`
  stops hammering a dead server: after ``breaker_threshold``
  consecutive transport failures calls wait for the half-open probe (or
  fail fast with :class:`CircuitOpenError` when the deadline cannot
  cover the cooldown);
- the service's backpressure contract is still honored: 429/503 +
  ``Retry-After`` (parsed tolerantly — a malformed header falls back to
  a default instead of raising) are retried within ``retry_timeout``.

Stdlib only (``urllib``), one connection per call: correctness over
micro-latency, and the server's ThreadingHTTPServer handles it fine at
service scale.
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid

from .. import tracing
from ..base import STATUS_FAIL, STATUS_OK
from ..resilience.retry import (
    CircuitBreaker,
    CircuitOpenError,
    RetryPolicy,
    backoff_delay,
)
from .core import BackpressureError, encode_space
from .replicas import HashRing, read_discovery

logger = logging.getLogger(__name__)


def _quote(study_id) -> str:
    """Path-encode a study id.  Valid ids ([A-Za-z0-9._-]) pass through
    unchanged; anything else is escaped so a malformed id produces a
    clean 404/400 from the server instead of a mis-parsed URL."""
    return urllib.parse.quote(str(study_id), safe="")


def parse_retry_after(value, default=0.05) -> float:
    """Tolerant ``Retry-After`` parse: absent, non-numeric, or negative
    values fall back to ``default`` instead of raising out of the retry
    loop (the header may legally be an HTTP-date, or garbage)."""
    try:
        seconds = float(value)
    except (TypeError, ValueError):
        return float(default)
    if seconds < 0.0:
        return float(default)
    return seconds


class ServiceClientError(Exception):
    """A non-retryable error response from the service."""

    def __init__(self, status, error, detail):
        super().__init__(f"{status}: {error}: {detail}")
        self.status = status
        self.error = error
        self.detail = detail


class ServiceTransportError(Exception):
    """The transport kept failing (reset/refused/timeout) past the retry
    budget — the request may or may not have executed server-side; with
    an idempotency key, re-issuing it later is still safe."""

    def __init__(self, msg, attempts=0, last_error=None):
        super().__init__(msg)
        self.attempts = attempts
        self.last_error = last_error


class ReplicaRedirect(Exception):
    """A 307 from a non-owner replica, carrying the owner hint.  Raised
    out of the transport layer and consumed by the study-routing loop
    (:meth:`ServiceClient._study_request`) — it only escapes to callers
    who bypass that loop with raw ``_request`` calls."""

    def __init__(self, owner_url=None, owner_id=None, payload=None):
        super().__init__(
            f"redirected to owner {owner_id!r} at {owner_url!r}"
        )
        self.owner_url = owner_url
        self.owner_id = owner_id
        self.payload = payload or {}


# transport-level failures that are safe to retry when the request is
# idempotent.  HTTPError (a served error response) is caught BEFORE this
# tuple — the server answering is a transport success.
_TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class ServiceClient:
    def __init__(self, base_url=None, timeout=180.0, retry_timeout=30.0,
                 deadline=120.0, max_transport_retries=8,
                 backoff_base=0.05, backoff_multiplier=2.0,
                 backoff_max=2.0, jitter=0.2, retry_seed=0,
                 breaker_threshold=8, breaker_cooldown=1.0,
                 idempotency_prefix=None, use_idempotency_keys=True,
                 tracer=None, trace_headers=True, replicas=None,
                 discovery=None, failover_transport_retries=1):
        # replica endpoints: an explicit --replica list, a discovery
        # source (JSON file or a service root's replica registry), or
        # just the single base_url.  With >1 endpoint, study routes go
        # through consistent-hash routing + redirect-follow + ring
        # failover (_study_request); with 1, behavior is byte-for-byte
        # the single-server client.
        urls = []
        if base_url is not None:
            urls.append(str(base_url).rstrip("/"))
        if replicas:
            urls.extend(str(u).rstrip("/") for u in replicas)
        if discovery is not None:
            urls.extend(
                str(u).rstrip("/") for u in read_discovery(discovery)
            )
        # de-duplicate, preserving arrival order (base_url stays the
        # default endpoint for non-study routes)
        seen = set()
        self._urls = [
            u for u in urls if not (u in seen or seen.add(u))
        ]
        if not self._urls:
            raise ValueError(
                "ServiceClient needs a base_url, replicas list, or "
                "discovery source"
            )
        self.base_url = self._urls[0]
        self.ring = HashRing(self._urls) if len(self._urls) > 1 else None
        # per-call transport-retry budget AGAINST ONE replica while
        # failing over (the ring loop provides the persistence; a dead
        # primary must cost milliseconds, not the whole retry budget)
        self.failover_transport_retries = int(failover_transport_retries)
        self.timeout = float(timeout)
        # total wall-clock budget for retrying 429/503 rejections before
        # surfacing BackpressureError to the caller; 0 disables retries
        self.retry_timeout = float(retry_timeout)
        # per-call wall-clock budget for TRANSPORT retries (resets,
        # refused connections, timeouts); generous by default so a
        # client rides through a server kill -9 + restart
        self.deadline = float(deadline)
        self.max_transport_retries = int(max_transport_retries)
        # backoff schedule is deterministic in (retry_seed, route,
        # attempt) — see resilience.retry.backoff_delay
        self._retry_policy = RetryPolicy(
            backoff_base=float(backoff_base),
            backoff_multiplier=float(backoff_multiplier),
            backoff_max=float(backoff_max),
            jitter=float(jitter),
            seed=int(retry_seed),
        )
        # circuit breakers are PER ENDPOINT (one per replica URL), not
        # per client: one dead replica tripping its breaker must not
        # blackhole calls routed to healthy replicas
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown = float(breaker_cooldown)
        self._breakers_lock = threading.Lock()
        self._breakers = {}  # guarded-by: _breakers_lock  (url -> breaker)
        # study -> last-known owner URL (learned from 307 hints and
        # successful serves; advisory — corrected by the next redirect)
        self._owner_lock = threading.Lock()
        self._owner_cache = {}  # guarded-by: _owner_lock
        self.use_idempotency_keys = bool(use_idempotency_keys)
        # tracing: every call carries an X-Hyperopt-Trace id (ambient
        # when the caller already holds a trace, fresh otherwise) so the
        # server can attribute its side; a local ``tracer`` additionally
        # records the CLIENT's view — transport attempts, backoff sleeps,
        # circuit-breaker waits — under the same id
        self.tracer = tracer
        self.trace_headers = bool(trace_headers)
        self._key_lock = threading.Lock()
        self._key_seq = 0  # guarded-by: _key_lock
        self._key_prefix = (
            idempotency_prefix
            if idempotency_prefix is not None
            else uuid.uuid4().hex[:12]
        )

    def _next_key(self):
        """One fresh idempotency key per LOGICAL call — reused verbatim
        across that call's transport retries, never across calls."""
        if not self.use_idempotency_keys:
            return None
        with self._key_lock:
            self._key_seq += 1
            seq = self._key_seq
        return f"{self._key_prefix}-{seq}"

    # -- breakers (one per endpoint) -----------------------------------
    def breaker_for(self, url) -> CircuitBreaker:
        url = str(url).rstrip("/")
        with self._breakers_lock:
            breaker = self._breakers.get(url)
            if breaker is None:
                breaker = CircuitBreaker(
                    threshold=self._breaker_threshold,
                    cooldown=self._breaker_cooldown,
                )
                self._breakers[url] = breaker
            return breaker

    @property
    def breaker(self) -> CircuitBreaker:
        """The default endpoint's breaker (back-compat accessor; the
        real state is per-endpoint — see :meth:`breaker_for`)."""
        return self.breaker_for(self.base_url)

    # -- owner cache ---------------------------------------------------
    def _note_owner(self, study_id, url):
        with self._owner_lock:
            if url is None:
                self._owner_cache.pop(str(study_id), None)
            else:
                self._owner_cache[str(study_id)] = str(url).rstrip("/")

    def _cached_owner(self, study_id):
        with self._owner_lock:
            return self._owner_cache.get(str(study_id))

    # -- transport -----------------------------------------------------
    def _request(self, method, path, body=None, retryable=None, raw=False,
                 base_url=None, max_transport_retries=None,
                 fail_fast_on_open=False):
        if self.tracer is not None and self.tracer.enabled \
                and tracing.current_trace() is None:
            # this client is the trace ROOT: begin one for the logical
            # call (all transport attempts share it) and write it out
            trace = self.tracer.begin()
            try:
                with tracing.use_trace(trace):
                    return self._request_traced(
                        method, path, body=body, retryable=retryable,
                        raw=raw, base_url=base_url,
                        max_transport_retries=max_transport_retries,
                        fail_fast_on_open=fail_fast_on_open,
                    )
            finally:
                self.tracer.finish(trace)
        return self._request_traced(
            method, path, body=body, retryable=retryable, raw=raw,
            base_url=base_url,
            max_transport_retries=max_transport_retries,
            fail_fast_on_open=fail_fast_on_open,
        )

    def _request_traced(self, method, path, body=None, retryable=None,
                        raw=False, base_url=None,
                        max_transport_retries=None,
                        fail_fast_on_open=False):
        with tracing.span(
            "client.request", method=method, route=path
        ) as sp:
            out = self._request_inner(
                method, path, body=body, retryable=retryable, raw=raw,
                root_span=sp, base_url=base_url,
                max_transport_retries=max_transport_retries,
                fail_fast_on_open=fail_fast_on_open,
            )
        return out

    def _request_inner(self, method, path, body=None, retryable=None,
                       raw=False, root_span=tracing.NULL_SPAN,
                       base_url=None, max_transport_retries=None,
                       fail_fast_on_open=False):
        base = (
            self.base_url if base_url is None
            else str(base_url).rstrip("/")
        )
        breaker = self.breaker_for(base)
        retry_budget = (
            self.max_transport_retries if max_transport_retries is None
            else int(max_transport_retries)
        )
        if retryable is None:
            # GETs are safe by definition; mutating routes are safe iff
            # they carry an idempotency key (the server replays instead
            # of re-executing); shutdown is idempotent by nature
            retryable = (
                method == "GET"
                or path == "/v1/shutdown"
                or (isinstance(body, dict)
                    and body.get("idempotency_key") is not None)
            )
        call_deadline = time.monotonic() + self.deadline
        bp_deadline = time.monotonic() + self.retry_timeout
        data = None
        headers = {}
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        # trace-id propagation: reuse the ambient id (ours or an
        # enclosing caller's) so client- and server-side spans join on
        # one id; otherwise assign a fresh id so the SERVER can still
        # trace this call (it echoes the id back in the response)
        trace_id = tracing.current_trace_id()
        if trace_id is None and self.trace_headers:
            trace_id = tracing.new_trace_id()
        if trace_id is not None:
            headers[tracing.TRACE_HEADER] = trace_id
        attempts = 0
        while True:
            wait = breaker.before_request()
            if wait > 0.0:
                if (
                    fail_fast_on_open
                    or not retryable
                    or time.monotonic() + wait > call_deadline
                ):
                    raise CircuitOpenError(
                        f"circuit open for {base} "
                        f"(retry in {wait:.2f}s)",
                        retry_in=wait,
                    )
                with tracing.span("client.breaker_wait", wait_s=wait):
                    time.sleep(wait)
                continue
            req = urllib.request.Request(
                base + path, data=data, headers=headers,
                method=method,
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    raw_body = r.read()
                    breaker.record_success()
                    root_span.set_attr("attempts", attempts + 1)
                    if raw:
                        return r.status, raw_body
                    ctype = r.headers.get("Content-Type", "")
                    if ctype.startswith("application/json"):
                        return json.loads(raw_body.decode())
                    return raw_body.decode()
            except urllib.error.HTTPError as e:
                # the server answered: the transport (and breaker) are
                # fine, whatever the status says
                breaker.record_success()
                raw_body = e.read()
                try:
                    payload = json.loads(raw_body.decode())
                except (json.JSONDecodeError, UnicodeDecodeError):
                    payload = {
                        "error": "HTTPError",
                        "detail": raw_body.decode("utf-8", "replace"),
                    }
                if e.code == 307:
                    # not-owner redirect: surface the owner hint to the
                    # routing loop (urllib never auto-follows a 307
                    # POST, by design — re-sending the body is OUR call,
                    # made safe by the idempotency key)
                    raise ReplicaRedirect(
                        owner_url=payload.get("owner_url")
                        or e.headers.get("Location", "").rsplit(
                            "/v1/", 1
                        )[0] or None,
                        owner_id=payload.get("owner_id"),
                        payload=payload,
                    )
                if e.code in (429, 503):
                    retry_after = parse_retry_after(
                        e.headers.get("Retry-After")
                    )
                    if time.monotonic() + retry_after < bp_deadline:
                        with tracing.span(
                            "client.backpressure_wait",
                            wait_s=retry_after, status=e.code,
                        ):
                            time.sleep(retry_after)
                        continue
                    raise BackpressureError(
                        f"{e.code} from {path}: {payload.get('detail')}"
                    )
                raise ServiceClientError(
                    e.code, payload.get("error"), payload.get("detail")
                )
            except _TRANSPORT_ERRORS as e:
                breaker.record_failure()
                attempts += 1
                if not retryable:
                    raise ServiceTransportError(
                        f"{method} {path} failed in transport "
                        f"(not retryable): {e!r}",
                        attempts=attempts, last_error=e,
                    ) from e
                delay = backoff_delay(
                    self._retry_policy, attempts, key=path
                )
                if (
                    attempts > retry_budget
                    or time.monotonic() + delay > call_deadline
                ):
                    raise ServiceTransportError(
                        f"{method} {path} failed after {attempts} "
                        f"transport attempt(s): {e!r}",
                        attempts=attempts, last_error=e,
                    ) from e
                logger.debug(
                    "transport retry %d for %s %s in %.3fs: %r",
                    attempts, method, path, delay, e,
                )
                with tracing.span(
                    "client.backoff", wait_s=delay, attempt=attempts
                ):
                    time.sleep(delay)

    # -- study routing (consistent hash + redirect + failover) ---------
    def _candidates(self, study_id) -> list:
        """Replica URLs to try for a study, in order: the last-known
        owner first (learned from 307s and successful serves), then the
        consistent-hash ring order (primary, successor, ...)."""
        urls = (
            self.ring.ordered(study_id) if self.ring is not None
            else list(self._urls)
        )
        cached = self._cached_owner(study_id)
        if cached is not None:
            if cached in urls:
                urls.remove(cached)
            urls.insert(0, cached)
        return urls

    def _study_request(self, study_id, method, path, body=None,
                       raw=False):
        """One logical study-scoped request with replica routing.

        Single-endpoint clients behave exactly like the pre-replica
        client (full transport-retry budget against the one URL), plus
        redirect-following when the server answers 307.  Multi-endpoint
        clients fail over: each candidate gets a SHORT transport budget
        and an open breaker fails fast to the ring successor; a full
        pass over every replica backs off deterministically and retries
        until the call deadline — a killed owner costs the client one
        hop, not the whole retry budget."""
        multi = self.ring is not None
        # a mutation carrying no idempotency key must NOT be re-sent to
        # another replica after a mid-flight transport error — the first
        # send may have committed (same contract as the single-endpoint
        # transport-retry gate; redirects/open breakers never sent, so
        # those always fail over)
        resend_safe = (
            method == "GET"
            or path == "/v1/shutdown"
            or (isinstance(body, dict)
                and body.get("idempotency_key") is not None)
        )
        deadline = time.monotonic() + self.deadline
        attempts = 0
        rounds = 0
        last = None
        while True:
            candidates = self._candidates(study_id)
            # fixed cap (NOT against the growing list: each 307 inserts
            # a candidate, so a live cap would never bind and a
            # stale-hint ping-pong between two replicas would hot-spin
            # this loop forever)
            max_redirect_hops = len(candidates) + 2
            redirect_hops = 0
            i = 0
            while i < len(candidates):
                url = candidates[i]
                i += 1
                attempts += 1
                try:
                    out = self._request(
                        method, path, body=body, raw=raw, base_url=url,
                        max_transport_retries=(
                            self.failover_transport_retries
                            if multi else None
                        ),
                        fail_fast_on_open=multi,
                    )
                except ReplicaRedirect as r:
                    last = r
                    self._note_owner(study_id, r.owner_url)
                    if (
                        r.owner_url
                        and redirect_hops < max_redirect_hops
                    ):
                        # try the hinted owner next; the hop cap stops
                        # a stale-hint ping-pong from spinning (the
                        # outer backoff then takes over)
                        redirect_hops += 1
                        candidates.insert(i, r.owner_url.rstrip("/"))
                    continue
                except BackpressureError as e:
                    # this replica is saturated or draining; the study
                    # may be served instantly by its actual owner — a
                    # backpressured candidate costs one hop, not the
                    # whole logical call
                    last = e
                    if not multi:
                        raise
                    logger.debug(
                        "failover: %s backpressured for study %s (%r)",
                        url, study_id, e,
                    )
                    continue
                except CircuitOpenError as e:
                    # fail-fast: NO request was sent, so failover is
                    # safe regardless of idempotency
                    last = e
                    if self._cached_owner(study_id) == url:
                        self._note_owner(study_id, None)
                    if not multi:
                        raise
                    continue
                except ServiceTransportError as e:
                    last = e
                    if self._cached_owner(study_id) == url:
                        self._note_owner(study_id, None)
                    if not multi or not resend_safe:
                        raise
                    logger.debug(
                        "failover: %s unreachable for study %s (%r)",
                        url, study_id, e,
                    )
                    continue
                self._note_owner(study_id, url)
                return out
            rounds += 1
            if not multi:
                # a redirect chain that never landed (single endpoint)
                raise ServiceClientError(
                    307, "NotOwner",
                    f"redirect chain for study {study_id!r} did not "
                    f"reach a serving owner: {last}",
                )
            delay = backoff_delay(
                self._retry_policy, min(rounds, 10),
                key=f"route:{study_id}",
            )
            if time.monotonic() + delay > deadline:
                raise ServiceTransportError(
                    f"no replica served {method} {path} after "
                    f"{attempts} attempt(s) across {len(self._urls)} "
                    f"replica(s): {last!r}",
                    attempts=attempts,
                    last_error=(
                        last if isinstance(last, Exception) else None
                    ),
                )
            with tracing.span(
                "client.failover_backoff", wait_s=delay, round=rounds
            ):
                time.sleep(delay)

    # -- API -----------------------------------------------------------
    def healthz(self) -> bool:
        return bool(self._request("GET", "/healthz").get("ok"))

    def readyz(self) -> dict:
        """The readiness document, whatever the status code — a
        not-ready server answers 503 with the SAME document, so this is
        a single un-retried probe (callers poll via :meth:`wait_ready`),
        not a call routed through the retry/backpressure machinery."""
        req = urllib.request.Request(
            self.base_url + "/readyz", method="GET"
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read().decode())
            except (json.JSONDecodeError, UnicodeDecodeError):
                return {"ready": False, "error": f"HTTP {e.code}"}

    def wait_ready(self, timeout=60.0, poll=0.25) -> dict:
        """Poll ``/readyz`` until green (or raise TimeoutError) —
        transport errors (server still starting / mid-restart) count as
        not-ready and keep polling.  While blocked, the 503 body's
        warmup block is logged whenever it advances (``warmed/total``
        buckets + ETA) so a long AOT warmup is visible progress, not a
        silent hang."""
        deadline = time.monotonic() + float(timeout)
        last = None
        last_progress = None
        while time.monotonic() < deadline:
            try:
                last = self.readyz()
                if last.get("ready"):
                    return last
                wu = last.get("warmup") or {}
                progress = (wu.get("warmed"), wu.get("total"))
                if wu and progress != last_progress:
                    last_progress = progress
                    logger.info(
                        "waiting for %s: warmup %s/%s buckets warm"
                        "%s (device=%s, recovery_ok=%s)",
                        self.base_url, wu.get("warmed"), wu.get("total"),
                        (
                            f", eta {wu['eta_s']:.1f}s"
                            if wu.get("eta_s") else ""
                        ),
                        last.get("device"), last.get("recovery_ok"),
                    )
            except _TRANSPORT_ERRORS:
                pass
            time.sleep(poll)
        raise TimeoutError(f"service not ready after {timeout}s: {last}")

    def warmup(self) -> dict:
        """The ``GET /v1/warmup`` document (per-bucket AOT warmup
        state + ETA + compile-ledger summary)."""
        return self._request("GET", "/v1/warmup")

    def create_study(self, study_id, space, seed=0, algo="tpe",
                     algo_params=None, exist_ok=False, early_stop=None,
                     idempotency_key=None) -> dict:
        body = {
            "study_id": study_id,
            "space_b64": encode_space(space),
            "seed": int(seed),
            "algo": algo,
            "algo_params": algo_params or {},
            "exist_ok": bool(exist_ok),
            "idempotency_key": (
                idempotency_key if idempotency_key is not None
                else self._next_key()
            ),
        }
        if early_stop is not None:
            body["early_stop"] = early_stop
        return self._study_request(study_id, "POST", "/v1/studies", body)

    def suggest(self, study_id, n=1, idempotency_key=None) -> list:
        """[{"tid": int, "vals": {label: value}}, ...]"""
        out = self._study_request(
            study_id, "POST", f"/v1/studies/{_quote(study_id)}/suggest",
            {
                "n": int(n),
                "idempotency_key": (
                    idempotency_key if idempotency_key is not None
                    else self._next_key()
                ),
            },
        )
        return out["trials"]

    def report(self, study_id, tid, loss=None, status=STATUS_OK,
               result=None, idempotency_key=None) -> dict:
        body = {
            "tid": int(tid),
            "status": status,
            "idempotency_key": (
                idempotency_key if idempotency_key is not None
                else self._next_key()
            ),
        }
        if loss is not None:
            body["loss"] = float(loss)
        if result is not None:
            body["result"] = result
        return self._study_request(
            study_id, "POST",
            f"/v1/studies/{_quote(study_id)}/report", body,
        )

    def study_status(self, study_id) -> dict:
        return self._study_request(
            study_id, "GET", f"/v1/studies/{_quote(study_id)}"
        )

    def resume_study(self, study_id) -> dict:
        """Re-admit a study stopped by its early-stop hook (subject to
        the registry's active-study capacity)."""
        return self._study_request(
            study_id, "POST",
            f"/v1/studies/{_quote(study_id)}/resume", {},
        )

    def get_config(self) -> dict:
        """The runtime knob table: specs, live + static values, recent
        provenance, and controller status."""
        return self._request("GET", "/v1/config")

    def set_config(self, knobs=None, revert=False) -> dict:
        """Write serving knobs at runtime (localhost-only on the server
        side).  ``revert=True`` restores the static config."""
        body = {"revert": True} if revert else {"knobs": dict(knobs or {})}
        return self._request("POST", "/v1/config", body)

    def replicas(self) -> dict:
        """The ``GET /v1/replicas`` replica-plane document (identity,
        held studies, takeover log, directory snapshot)."""
        return self._request("GET", "/v1/replicas")

    def list_studies(self) -> list:
        return self._request("GET", "/v1/studies")["studies"]

    def service_status(self) -> dict:
        return self._request("GET", "/v1/status")

    def alerts(self) -> dict:
        """The SL6xx SLO rule table: per-rule status, multi-window burn
        rates, breaching subset, and flight-recorder state."""
        return self._request("GET", "/v1/alerts")

    def metrics(self) -> str:
        return self._request("GET", "/metrics")

    def shutdown(self) -> dict:
        return self._request("POST", "/v1/shutdown", {})

    # -- convenience loop ----------------------------------------------
    def minimize(self, study_id, fn, space, max_evals, seed=0,
                 algo="tpe", algo_params=None, exist_ok=True):
        """Client-side fmin: create (or attach to) the study and drive
        suggest → evaluate → report serially for ``max_evals`` trials.
        ``fn`` receives the ``space_eval``-materialized point.  Returns
        the study's final status document (``best`` holds the argmin).

        A study with prior completed trials counts them toward
        ``max_evals`` — re-running after an interruption (or a server
        restart) continues instead of restarting.
        """
        from ..fmin import space_eval

        status = self.create_study(
            study_id, space, seed=seed, algo=algo,
            algo_params=algo_params, exist_ok=exist_ok,
        )
        n_done = int(status.get("n_completed", 0))
        for _ in range(max(0, int(max_evals) - n_done)):
            (trial,) = self.suggest(study_id, n=1)
            point = space_eval(space, trial["vals"])
            try:
                loss = fn(point)
            except Exception as e:
                logger.warning(
                    "objective failed for trial %s: %s", trial["tid"], e
                )
                self.report(study_id, trial["tid"], status=STATUS_FAIL)
                continue
            if isinstance(loss, dict):
                self.report(study_id, trial["tid"], result=loss)
            else:
                self.report(study_id, trial["tid"], loss=float(loss))
        return self.study_status(study_id)
