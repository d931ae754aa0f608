"""HTTP front-end for the optimization service (stdlib only).

Reference parity: ``hyperopt_tpu/service/server.py`` — the same routes,
JSON bodies and status mapping.  Handler threads never touch the card:
a suggest waits on the scheduler's bounded queue.

``ThreadingHTTPServer`` + JSON bodies over localhost — one handler
thread per in-flight request, which is exactly what the continuous
-batching scheduler wants: every blocked ``/suggest`` is a queued
request the next batch can coalesce.

API (all JSON unless noted)::

    GET  /healthz                         liveness probe
    GET  /readyz                          readiness probe: 200 iff the
                                          registry recovered, the startup
                                          fsck left the store clean, and
                                          the device answered its warm
                                          probe (503 otherwise)
    GET  /metrics                         Prometheus text exposition
    GET  /v1/status                       service-wide stats snapshot
    GET  /v1/alerts                       SL6xx SLO rule table (status,
                                          multi-window burn rates,
                                          breaching subset, flight-
                                          recorder state)
    GET  /v1/warmup                       compile-warmup progress:
                                          per-bucket state (pending/
                                          compiling/warm/skipped/error),
                                          ETA from ledger durations,
                                          compile-ledger summary
    GET  /v1/replicas                     replica-plane document: this
                                          replica's identity, held
                                          studies, takeover log, and the
                                          live replica directory
    GET  /v1/studies                      {"studies": [id, ...]}
    GET  /v1/studies/<id>                 study status document
    POST /v1/studies                      create: {"study_id", "space_b64",
                                          "seed", "algo", "algo_params",
                                          "exist_ok"}
    POST /v1/studies/<id>/suggest         {"n": 1} -> {"trials": [{"tid",
                                          "vals"}, ...]}
    POST /v1/studies/<id>/report          {"tid", "loss", "status"} or
                                          {"tid", "result": {...}}
    POST /v1/shutdown                     drain + stop (localhost control)

Error contract: over-admission returns **429** with a ``Retry-After``
header (retry is always safe — a rejected request had no side effects);
a draining server returns **503**; unknown studies **404**; create
collisions **409**; malformed requests **400**.  Suggest waits are
bounded by the service's ``suggest_timeout`` and surface as **504**.
In multi-replica mode a study served by another replica answers **307
Temporary Redirect** with a ``Location`` header and an ``owner_url``
body field (send the same body there again; idempotency keys make the
re-send safe), or a retryable **503** while the owner is unknown
(mid-migration).

Exactly-once contract: the mutating routes (``create``, ``suggest``,
``report``) accept a client-generated ``idempotency_key`` in the body.
A retried request with the same key returns the journaled response
**byte-identical** (these routes serialize through one canonical
encoder) with no second seed draw, trial insert, or loss landing —
which is what makes the client's automatic retry of a connection reset
or timeout safe.  Handler reads are bounded by a socket timeout so a
slow-loris client ties up one handler thread for at most that long.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import tracing
from ..base import STATUS_OK
from .core import (
    BackpressureError,
    NotOwner,
    OptimizationService,
    ServiceDraining,
    StudyExists,
    StudyNotFound,
    StudyStopped,
    _active_chaos,
    canonical_json,
    decode_space,
)

logger = logging.getLogger(__name__)


class _ServiceHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    service: OptimizationService = None


class _Handler(BaseHTTPRequestHandler):
    server_version = "hyperopt-tpu-service/0.1"
    protocol_version = "HTTP/1.1"
    # bound every socket read: a slow-loris client that trickles its
    # request bytes forever holds ONE handler thread for at most this
    # long before the read times out and the connection is dropped
    timeout = 30.0

    # -- plumbing ------------------------------------------------------
    def log_message(self, fmt, *args):  # route access logs to logging
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _read_json(self):
        length = int(self.headers.get("Content-Length") or 0)
        if not length:
            return {}
        raw = self.rfile.read(length)
        try:
            return json.loads(raw.decode())
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(f"malformed JSON body: {e}")

    def _send(self, code, payload, content_type="application/json",
              headers=()):
        body = (
            payload if isinstance(payload, bytes)
            else json.dumps(payload).encode()
        )
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        trace = getattr(self, "_active_trace", None)
        if trace is not None:
            # echo the trace id so the caller can join its client-side
            # spans (and logs) to the server's trace record
            self.send_header(tracing.TRACE_HEADER, trace.trace_id)
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, code, exc, retry_after=None):
        headers = ()
        if retry_after is not None:
            headers = (("Retry-After", f"{retry_after:.3f}"),)
        self._send(
            code,
            {"error": type(exc).__name__, "detail": str(exc)},
            headers=headers,
        )

    def _is_loopback(self) -> bool:
        """Authenticated-enough for knob writes: the TCP peer must be
        the loopback interface.  Anything routed (including the pod
        network) is refused — runtime reconfiguration is an operator
        action taken ON the host, not a fleet API."""
        host = self.client_address[0]
        return host in ("127.0.0.1", "::1", "::ffff:127.0.0.1")

    def _endpoint_label(self) -> str:
        """Coarse endpoint label for the server-side error counter
        (the SL603 numerator)."""
        path = self.path.split("?", 1)[0].rstrip("/")
        if path.endswith("/suggest"):
            return "suggest"
        if path.endswith("/report"):
            return "report"
        if path == "/v1/studies" and self.command == "POST":
            return "create_study"
        return "other"

    def _dispatch(self, handler):
        try:
            handler()
        except NotOwner as e:
            # multi-replica routing: 307 + owner hint when the lease
            # holder has a live directory record (the client re-issues
            # the SAME body there — idempotency keys make that safe);
            # retryable 503 while the owner is unknown (mid-migration)
            if e.owner_url:
                path = self.path.split("?", 1)[0]
                self._send(
                    307,
                    {
                        "error": "NotOwner",
                        "detail": str(e),
                        "owner_url": e.owner_url,
                        "owner_id": e.owner_id,
                        "study_id": e.study_id,
                    },
                    headers=(
                        ("Location", e.owner_url.rstrip("/") + path),
                    ),
                )
            else:
                self._send_error_json(
                    503, e, retry_after=e.retry_after
                )
        except BackpressureError as e:
            self._send_error_json(429, e, retry_after=e.retry_after)
        except ServiceDraining as e:
            self._send_error_json(503, e, retry_after=e.retry_after)
        except StudyNotFound as e:
            self._send_error_json(404, e)
        except StudyExists as e:
            self._send_error_json(409, e)
        except StudyStopped as e:
            # terminal-but-reversible: the study's early-stop criterion
            # fired; 409 (not 404) because the study still exists and a
            # resume makes the same request valid again
            self._send_error_json(409, e)
        except TimeoutError as e:
            # a timed-out suggest is a failed request the SLO layer
            # must see (4xx client mistakes are not; 429s are counted
            # as rejections at the submit site)
            self.service.stats.record_error(self._endpoint_label())
            self._send_error_json(504, e)
        except (ValueError, KeyError, TypeError) as e:
            self._send_error_json(400, e)
        except BrokenPipeError:  # client went away mid-response
            pass
        except Exception as e:  # pragma: no cover - defensive
            logger.exception("unhandled service error")
            self.service.stats.record_error(self._endpoint_label())
            self._send_error_json(500, e)

    @property
    def service(self) -> OptimizationService:
        return self.server.service

    def _chaos_drop(self, route, key, when) -> bool:
        """Chaos connection-reset site: drop the connection without a
        response, either before any state change (``pre``) or after the
        journal+store commit (``post``).  Returns True when it fired —
        the caller must then send nothing."""
        monkey = _active_chaos()
        if monkey is None:
            return False
        if not monkey.should_reset_connection(route, key, when):
            return False
        logger.info("chaos: dropping connection (%s, %s)", route, when)
        self.close_connection = True
        return True

    def _chaos_partitioned(self) -> bool:
        """Asymmetric-partition chaos site: while a client↔replica
        partition window is open, EVERY request's connection is dropped
        without a response — but the replica's store-side heartbeats
        keep running (replica↔store alive), so its leases stay warm and
        no failover fires.  Exactly the scenario where redirects and
        client-side ring failover, not lease expiry, must carry the
        traffic."""
        monkey = _active_chaos()
        if monkey is None or self.service.replica_set is None:
            return False
        rid = self.service.replica_set.replica_id
        monkey.maybe_client_partition(rid)
        if not monkey.client_partitioned(rid):
            return False
        logger.info("chaos: client partition drop (replica %s)", rid)
        self.close_connection = True
        return True

    # -- routes --------------------------------------------------------
    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if self._chaos_partitioned():
            return

        def handle():
            if path == "/healthz":
                self._send(200, {"ok": True})
            elif path == "/readyz":
                ready = self.service.readiness()
                self._send(200 if ready["ready"] else 503, ready)
            elif path == "/metrics":
                self._send(
                    200,
                    self.service.metrics_text().encode(),
                    content_type="text/plain; version=0.0.4",
                )
            elif path == "/v1/status":
                self._send(200, self.service.service_status())
            elif path == "/v1/alerts":
                self._send(200, self.service.alerts())
            elif path == "/v1/warmup":
                self._send(200, self.service.warmup_status())
            elif path == "/v1/replicas":
                self._send(200, self.service.replica_status())
            elif path == "/v1/config":
                self._send(200, self.service.get_config())
            elif path == "/v1/studies":
                self._send(200, {"studies": self.service.list_studies()})
            elif path.startswith("/v1/studies/"):
                study_id = path[len("/v1/studies/"):]
                if "/" in study_id:
                    raise ValueError(f"bad path {self.path!r}")
                self._send(200, self.service.study_status(study_id))
            else:
                self._send(404, {"error": "NotFound", "detail": path})

        self._dispatch(handle)

    def do_POST(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        if self._chaos_partitioned():
            return

        def handle():
            # read the body FIRST on every route: an unread body left in
            # a keep-alive stream desyncs the next request's parse
            body = self._read_json()
            # client-generated idempotency key (exactly-once contract);
            # None keeps the pre-key at-most-once-per-connection behavior
            idem = body.get("idempotency_key")
            if idem is not None:
                idem = str(idem)
            if path == "/v1/studies":
                study_id = body["study_id"]
                # chaos rolls key on the idempotency key when present:
                # per-LOGICAL-request occurrence streams survive server
                # restarts (the injection-log replay restores hits) and
                # scale with traffic instead of with (route, study)
                if self._chaos_drop("create_study", idem or study_id,
                                    "pre"):
                    return
                out = self.service.create_study(
                    study_id,
                    decode_space(body["space_b64"]),
                    seed=int(body.get("seed", 0)),
                    algo=body.get("algo", "tpe"),
                    algo_params=body.get("algo_params") or None,
                    exist_ok=bool(body.get("exist_ok", False)),
                    early_stop=body.get("early_stop") or None,
                    idempotency_key=idem,
                )
                if self._chaos_drop("create_study", idem or study_id, "post"):
                    return
                # the canonical encoder: a replayed response must be
                # byte-identical to the original, so both serialize here
                self._send(200, canonical_json(out))
            elif path.startswith("/v1/studies/") and path.endswith("/suggest"):
                study_id = path[len("/v1/studies/"):-len("/suggest")]
                if self._chaos_drop("suggest", idem or study_id, "pre"):
                    return
                trials = self.service.suggest(
                    study_id, n=int(body.get("n", 1)),
                    idempotency_key=idem,
                )
                if self._chaos_drop("suggest", idem or study_id, "post"):
                    return
                self._send(200, canonical_json({"trials": trials}))
            elif path.startswith("/v1/studies/") and path.endswith("/report"):
                study_id = path[len("/v1/studies/"):-len("/report")]
                if self._chaos_drop("report", idem or study_id, "pre"):
                    return
                out = self.service.report(
                    study_id,
                    body["tid"],
                    loss=body.get("loss"),
                    status=body.get("status", STATUS_OK),
                    result=body.get("result"),
                    idempotency_key=idem,
                )
                if self._chaos_drop("report", idem or study_id, "post"):
                    return
                self._send(200, canonical_json(out))
            elif path.startswith("/v1/studies/") and path.endswith("/resume"):
                study_id = path[len("/v1/studies/"):-len("/resume")]
                self._send(200, self.service.resume_study(study_id))
            elif path == "/v1/config":
                if not self._is_loopback():
                    self._send(
                        403,
                        {
                            "error": "Forbidden",
                            "detail": "POST /v1/config is "
                                      "localhost-only (operator knob "
                                      "writes are not a fleet API)",
                        },
                    )
                    return
                self._send(
                    200,
                    self.service.set_config(
                        body,
                        source=f"api:{self.client_address[0]}",
                    ),
                )
            elif path == "/v1/shutdown":
                self._send(200, {"ok": True, "draining": True})
                # drain + stop off-thread: this handler must finish its
                # response before serve_forever is told to exit
                threading.Thread(
                    target=self.server._begin_shutdown, daemon=True
                ).start()
            else:
                self._send(404, {"error": "NotFound", "detail": path})

        # header contract: the study routes accept a caller-assigned
        # trace id via X-Hyperopt-Trace (one is assigned here when the
        # header is absent), bind it for the handler, and echo it back.
        # begin() returns None when tracing is disabled — every span
        # call downstream then no-ops (the sampling-off hot path).
        trace = None
        if path.startswith("/v1/studies"):
            trace = self.service.tracer.begin(
                self.headers.get(tracing.TRACE_HEADER)
            )
        self._active_trace = trace
        try:
            with tracing.use_trace(trace):
                self._dispatch(handle)
        finally:
            self._active_trace = None
            self.service.tracer.finish(trace)


class ServiceServer:
    """Owns the HTTP listener thread around an OptimizationService.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``stop()`` is the graceful path: drain the scheduler (admitted
    suggests complete; new ones get 503), then stop the listener.  All
    study state is write-through, so a subsequent server on the same
    root recovers every study.
    """

    def __init__(self, service: OptimizationService = None,
                 host="127.0.0.1", port=0, **service_kwargs):
        self.service = (
            service if service is not None
            else OptimizationService(**service_kwargs)
        )
        self.httpd = _ServiceHTTPServer((host, port), _Handler)
        self.httpd.service = self.service
        self.httpd._begin_shutdown = self._begin_shutdown
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = None
        self._stop_lock = threading.Lock()
        self._stopped = False  # guarded-by: _stop_lock

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="hyperopt-service-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self):
        """Foreground serving (the CLI path)."""
        self.httpd.serve_forever(poll_interval=0.1)

    def _begin_shutdown(self):
        self.stop(drain=True)

    def stop(self, drain=True, timeout=60.0):
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        # close() drains internally; a zero timeout skips the wait so a
        # wedged dispatch can't burn 2x the drain budget
        self.service.close(timeout=timeout if drain else 0.0)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def free_port(host="127.0.0.1"):
    """An OS-assigned free TCP port (tests / loadgen convenience)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]
