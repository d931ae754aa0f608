"""Optimization-service core: studies, registry, continuous batching.

Reference parity: ``hyperopt_tpu/service/core.py``, for one replica on
one card.  Bergstra et al.'s ICML 2013 systems paper frames hyperopt as
a distributed asynchronous *service* around the expression-graph DSL;
this module is the service plane on the CUDA card: ONE long-lived
process owns the device and multiplexes MANY concurrent studies onto
it.

The core is a **continuous-batching scheduler** (the same shape modern
LLM inference servers use for requests): concurrent ``suggest`` calls
from different studies land in a bounded queue, a scheduler thread
coalesces whatever has arrived within a short batching window, each
study's suggest is *prepared* (``tpe.suggest_prepare`` — the device
request list, built but not launched), and ALL prepared studies launch
back to back on the card's suggest stream
(``tpe_device.multi_study_suggest_async``: the pair-score kernel twice
per study on the default tier) with one flat readback.  Only the
scheduler thread launches on the card or reads back; the HTTP handler
threads hand requests over through the bounded queue.
While that program runs, new arrivals accumulate for the next batch —
occupancy rises under load with no extra latency when idle.

Guarantees:

- **Determinism** — each study draws exactly one seed per suggest from
  its own ``np.random.default_rng(study_seed)``, in arrival order: a
  single-study client driven serially through the server reproduces
  the serial ``fmin(tpe.suggest)`` trajectory trial-for-trial, because
  batching only changes *which device program* carries the suggest,
  never its inputs (each family core reads only its own study's
  buffers).
- **Durability** — with a service root, every study persists through
  :class:`~hyperopt_tpu_torch.parallel.file_trials.FileTrials` (write-through
  on report; suggested docs land on disk at insert) plus a config
  attachment and a seed cursor, so a restarted server recovers every
  study mid-trajectory.
- **Backpressure** — a full scheduler queue (or a full study registry)
  rejects with :class:`BackpressureError`, which the HTTP layer maps to
  a retryable 429; requests are never silently dropped and never hang
  unbounded (suggest waits carry a timeout).
- **Fault tolerance** — every batched dispatch (including the history
  uploads inside prepare) runs under the run-shared
  :class:`~hyperopt_tpu_torch.resilience.device.DeviceRecovery`; seeds and
  trial ids are drawn once per request and reused across recovery
  retries, so recovered batches are seed-transparent.  The port's
  recovery re-initializes at most ``max_reinits`` times and then raises:
  it has no CPU fallback.

The study directory's docs, config attachment, seed cursor and response
journal are the reference's formats, readable by either package; the
pickled space is not (:func:`decode_space` refuses a blob that names
the JAX package's classes).

Multi-replica mode (``replica_id=``, :mod:`.replicas`): N server
processes share one root — on one card, each its own CUDA context —
each serving the studies whose fencing-token lease it holds; a dead
replica's studies are adopted by a survivor (claim → fsck-clean →
recover → ledger pre-warm → serve), the pre-warm queued on the
adopter's scheduler thread.

Mesh execution mode (``mesh=`` / ``--mesh auto|off|DPxSP``): the service
owns one :class:`~hyperopt_tpu_torch.parallel.sharding.DeviceMesh`, and
every study's suggest shards its scoring over it, unless the study's
``algo_params["mesh"]`` opts out (``"off"``); a study may restate the
server's mesh but never name another, which is refused at create.  A
degenerate mesh (one card, ``off``) is the single-device dispatch.
"""

from __future__ import annotations

import base64
import contextlib
import json
import logging
import os
import pickle
import threading
import time
from collections import deque
from functools import partial

import numpy as np

from .. import diagnostics as search_diag
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
from ..observability import (
    DeviceStats,
    FaultStats,
    PhaseTimings,
    ServiceStats,
)
from ..utils import coarse_utcnow
from .replicas import OwnershipLost

logger = logging.getLogger(__name__)

# durable per-study metadata, stored as queue attachments (the blob
# store FileTrials already provides); values are JSON bytes
STUDY_CONFIG_ATTACHMENT = "ServiceStudyConfig"
SEED_CURSOR_ATTACHMENT = "ServiceSeedCursor"
# the exactly-once response journal: an append-only JSONL file under the
# study's attachments directory (written directly, not through the
# rewrite-whole-blob attachment API — appends must be crash-atomic)
RESPONSE_JOURNAL_ATTACHMENT = "ServiceResponseJournal.jsonl"
JOURNAL_MAX_ENTRIES = 512

DEFAULT_BATCH_WINDOW = 0.004
DEFAULT_MAX_BATCH = 32
DEFAULT_MAX_QUEUE = 64
DEFAULT_MAX_STUDIES = 256
DEFAULT_SUGGEST_TIMEOUT = 120.0
# how long a readiness check waits for the startup task (the device-warm
# probe, CUDA init included, and the warmup replay on the scheduler
# thread) before it answers with the progress so far
STARTUP_WAIT_S = 60.0
# per-study /metrics gauge families export at most this many studies
# (top-N by last search activity) — the cardinality guard that keeps a
# million-study fleet from blowing up the Prometheus exposition
DEFAULT_METRICS_MAX_STUDIES = 50
# the longest a takeover waits for its pre-warm, a task queued on the
# adopter's scheduler thread behind at most the batch in flight
TAKEOVER_PREWARM_WAIT_S = 300.0

_ALGOS = ("tpe", "rand", "anneal")

# the JAX package's classes: a space pickled there cannot be rebuilt here
_FOREIGN_PACKAGE = "hyperopt_tpu"


def _active_chaos():
    """The process-wide chaos monkey (zero import cost when the harness
    was never loaded) — one definition, in parallel.file_trials."""
    from ..parallel.file_trials import _active_chaos as impl

    return impl()


def _r4(v):
    """round(v, 4) passing None through (nullable roofline attrs)."""
    return None if v is None else round(float(v), 4)


def canonical_json(payload) -> bytes:
    """THE response encoding for idempotent routes: a replayed request
    must return byte-identical bytes, so both the original send and the
    replay serialize through this one function."""
    return json.dumps(payload, sort_keys=True).encode()


class ServiceError(Exception):
    """Base class for service-plane errors (each maps to an HTTP status)."""


class BackpressureError(ServiceError):
    """The service is over-admitted — retry after a short wait.

    Raised when the scheduler queue or the study registry is full; the
    HTTP layer maps it to ``429 Too Many Requests`` with a
    ``Retry-After`` hint.  Never a sign of lost state: the rejected
    request had no side effects.
    """

    retry_after = 0.05


class ServiceDraining(ServiceError):
    """The service is shutting down and not admitting new work (503)."""

    retry_after = 1.0


class StudyNotFound(ServiceError):
    """No such study (404)."""


class StudyExists(ServiceError):
    """create_study collision without ``exist_ok`` (409)."""


class StudyStopped(ServiceError):
    """The study was stopped by its SH5xx early-stop hook and no
    longer accepts suggests (409).  Reports for already-issued trials
    still land; ``resume_study`` re-admits it (subject to capacity)."""


class NotOwner(ServiceError):
    """This replica does not own the study (multi-replica mode).

    Maps to **307 Temporary Redirect** with a ``Location`` header and an
    ``owner_url`` body field when the owner has a live directory record,
    or to a retryable **503** when the owner is unknown (the study is
    mid-migration; the adopting replica serves it after takeover).
    """

    retry_after = 0.25

    def __init__(self, study_id, owner_id=None, owner_url=None):
        self.study_id = str(study_id)
        self.owner_id = owner_id
        self.owner_url = owner_url
        if owner_url:
            msg = (
                f"study {self.study_id!r} is owned by replica "
                f"{owner_id!r} at {owner_url}"
            )
        elif owner_id:
            msg = (
                f"study {self.study_id!r} is owned by replica "
                f"{owner_id!r} (no live directory record)"
            )
        else:
            msg = (
                f"study {self.study_id!r} is not served by this replica "
                f"(migrating; retry shortly)"
            )
        super().__init__(msg)


def _null_objective(config):
    """The service never evaluates objectives — clients do.  This
    placeholder satisfies Domain's constructor; calling it is a bug."""
    raise RuntimeError(
        "the optimization service does not evaluate objectives; "
        "evaluate client-side and POST the loss to /report"
    )


def encode_space(space) -> str:
    """base64(pickle(space)) — the wire form of a search space.

    Pickle is the same trust model FileTrials already uses for the
    ``FMinIter_Domain`` attachment: the service binds to localhost and
    serves cooperating clients on the same host/pod.
    """
    return base64.b64encode(pickle.dumps(space)).decode("ascii")


class _SpaceUnpickler(pickle.Unpickler):
    """Refuses every class of the JAX package (without importing it)."""

    def find_class(self, module, name):
        if module == _FOREIGN_PACKAGE or module.startswith(
            _FOREIGN_PACKAGE + "."
        ):
            raise ValueError(
                f"the space names {module}.{name}, a class of the JAX "
                f"package; hyperopt_tpu_torch cannot rebuild it — build "
                f"the space with hyperopt_tpu_torch.hp and encode it with "
                f"hyperopt_tpu_torch.service.encode_space"
            )
        return super().find_class(module, name)


def decode_space(blob: str):
    """The space of :func:`encode_space`'s blob.  A blob pickled by the
    JAX package raises ``ValueError`` (a 400 at the HTTP layer), and
    nothing of that package is imported."""
    import io

    raw = base64.b64decode(blob.encode("ascii"))
    return _SpaceUnpickler(io.BytesIO(raw)).load()


_STUDY_ID_RE = None


def validate_study_id(study_id) -> str:
    """Path- and URL-safe study id or ValueError — enforced for EVERY
    study (in-memory ones too: ids travel in URL paths and become
    directory names the moment a durable root is configured)."""
    global _STUDY_ID_RE
    if _STUDY_ID_RE is None:
        import re

        # \Z, not $: '$' also matches before a trailing newline, which
        # would admit an id that is a valid directory name but an
        # unreachable URL path segment
        _STUDY_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,127}\Z")
    sid = str(study_id)
    if not _STUDY_ID_RE.match(sid):
        raise ValueError(
            f"invalid study_id {study_id!r}: use 1-128 chars of "
            f"[A-Za-z0-9._-], starting alphanumeric"
        )
    return sid


def study_mesh(algo_params, service_mesh, device=None):
    """The mesh one study's suggests shard over: the service's, unless
    ``algo_params["mesh"]`` opts out (``"off"``: None) or restates it.
    Any other mesh raises ValueError: the scheduler fuses studies into one
    dispatch, which has one mesh (the suggest plane refuses two at
    dispatch; a create refuses the study instead, side-effect free).
    Spec strings resolve over the service mesh's devices (else the
    service's device: the local cards, or the CPU).  Reference:
    ``hyperopt_tpu/service/core.py:1149-1166``."""
    import torch

    from ..parallel.sharding import DeviceMesh, mesh_shape_str, resolve_mesh

    if "mesh" not in (algo_params or {}):
        return service_mesh
    spec = algo_params["mesh"]
    if isinstance(spec, str):
        if service_mesh is not None:
            devices = list(service_mesh.devices)
        elif device is not None and torch.device(device).type == "cpu":
            devices = [torch.device("cpu")]
        else:
            devices = None
        spec = DeviceMesh.from_spec(spec, devices=devices)
    mine = resolve_mesh(spec)
    if mine is not None and mine != service_mesh:
        raise ValueError(
            f"algo_params['mesh'] resolves to {mesh_shape_str(mine)!r} but this "
            f"server dispatches over {mesh_shape_str(service_mesh)!r}; per-study "
            f"meshes may only be 'off' or match the server's --mesh"
        )
    return mine


def _resolve_algo(algo_name: str, algo_params: dict, device=None, mesh=None):
    """(suggest_callable, prepare_callable_or_None) for a named algo.

    ``algo_params`` keys are validated against the suggest signature at
    STUDY CREATION — a typo'd keyword must fail the create with a 400,
    not every later suggest in whatever batch it lands in.  ``device``
    is the service's (driver-owned, like the seed): it is bound into an
    algo that takes one.  ``mesh``: the study's resolved mesh
    (:func:`study_mesh`), bound in place of ``algo_params["mesh"]`` into
    an algo that takes one."""
    if algo_name not in _ALGOS:
        raise ValueError(
            f"unknown algo {algo_name!r}; expected one of {_ALGOS}"
        )
    if algo_name == "tpe":
        from ..algos import tpe as mod
    elif algo_name == "anneal":
        from ..algos import anneal as mod
    else:
        from ..algos import rand as mod
    fn = mod.suggest
    if algo_params:
        import inspect

        accepted = set(inspect.signature(fn).parameters) - {
            "new_ids", "domain", "trials", "seed", "device",  # driver-owned
        }
        unknown = set(algo_params) - accepted
        if unknown:
            raise ValueError(
                f"unknown algo_params for {algo_name!r}: "
                f"{sorted(unknown)} (accepted: {sorted(accepted)})"
            )
    import inspect

    bound = dict(algo_params or {})
    if device is not None and "device" in inspect.signature(fn).parameters:
        bound["device"] = device
    if (mesh is not None or "mesh" in bound) and "mesh" in inspect.signature(fn).parameters:
        bound["mesh"] = mesh
    algo = partial(fn, **bound) if bound else fn
    prep = getattr(fn, "prepare_variant", None)
    if prep is not None and bound:
        prep = partial(prep, **bound)
    return algo, prep


def _journal_codec():
    """(dumps-default, loads-object-hook) shared with the trial-doc
    store, so journaled docs round-trip datetimes/bytes identically."""
    from ..parallel.file_trials import _json_default, _json_object_hook

    return _json_default, _json_object_hook


def _store_telemetry():
    """The process-wide StoreStats (one definition, in
    parallel.file_trials) — None when no service installed one."""
    from ..parallel.file_trials import store_stats

    return store_stats()


class ResponseJournal:
    """Bounded, crash-consistent idempotency journal for one study.

    Exactly-once over an unreliable transport needs a durable record of
    "this request already happened, and THIS is what we answered": a
    retried ``suggest``/``report``/``create_study`` carrying the same
    client-generated idempotency key returns the journaled response
    byte-for-byte — no second seed draw, no second trial, no
    double-landed loss.

    The journal doubles as a **write-ahead log**: a ``suggest`` entry
    carries the full suggested docs and its seed draw position, and is
    appended (fsync'd) BEFORE the docs are inserted into the store.  A
    crash between the two is repaired at startup by
    :meth:`Study.replay_journal` (re-insert the docs, advance the seed
    cursor); a crash before the append loses nothing the client ever
    saw — its retry re-draws the same cursor position and gets the same
    suggestion.

    On-disk format: append-only JSONL, every record written as ONE
    ``O_APPEND`` write of ``\\n<crc32 hex> <json>`` — a torn append
    (power loss mid-write) garbles at most the record being written,
    which by construction was never acknowledged to a client; the next
    append's leading newline re-synchronizes the reader.  Bounded by
    ``max_entries`` (oldest evicted; retried requests arrive within
    seconds, not thousands of requests later) and compacted in place
    once the file accumulates 4x that in appends.
    """

    # lock-order: _lock
    def __init__(self, path=None, max_entries=JOURNAL_MAX_ENTRIES):
        self.path = path
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries = {}  # guarded-by: _lock  (key -> entry dict)
        self._order = deque()  # guarded-by: _lock  (keys, oldest first)
        self._seq = 0  # guarded-by: _lock
        self._appends_since_compact = 0  # guarded-by: _lock
        self.n_torn_lines = 0  # from the last load; read-only after init
        if self.path:
            self._load()

    # -- codec ---------------------------------------------------------
    # Framing/resync/compaction live in hyperopt_tpu_torch.journal_io (shared
    # with the compile ledger, the chaos injection log, and the
    # segmented trial store); these thin wrappers pin the journal codec
    # and keep resilience.fsck's FS407 repair entry points stable.
    def _format_record(self, entry) -> bytes:
        default, _ = _journal_codec()
        return tracing.format_record(entry, default=default)

    @staticmethod
    def parse_lines(raw: bytes):
        """(entries, n_torn) from raw journal bytes.  Lines that fail
        their CRC or do not parse count as torn and are skipped — only
        an unacknowledged tail record can legitimately be torn."""
        from .. import journal_io

        _, object_hook = _journal_codec()
        return journal_io.read_records_bytes(raw, object_hook=object_hook)

    def _load(self):
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return
        entries, self.n_torn_lines = self.parse_lines(raw)
        if self.n_torn_lines:
            stats = _store_telemetry()
            if stats is not None:
                stats.record_journal_torn(self.n_torn_lines)
        entries.sort(key=lambda e: int(e.get("seq", 0)))
        with self._lock:
            for entry in entries[-self.max_entries:]:
                key = entry["key"]
                if key not in self._entries:
                    self._order.append(key)
                self._entries[key] = entry
                self._seq = max(self._seq, int(entry.get("seq", 0)))

    def _append_line(self, entry):
        from .. import journal_io

        default, _ = _journal_codec()
        # the fsync inside append_record is THE durability point of the
        # exactly-once protocol — and a named phase in every trace that
        # pays it (journal_io records the fsync into StoreStats)
        with tracing.span("journal.fsync"):
            nbytes = journal_io.append_record(
                self.path, entry, default=default, fsync_kind="journal"
            )
        stats = _store_telemetry()
        if stats is not None:
            stats.record_journal_append(nbytes)

    # -- API -------------------------------------------------------------
    def get(self, key):
        """The journaled entry for ``key`` (None = never seen)."""
        if key is None:
            return None
        with self._lock:
            return self._entries.get(str(key))

    def payload(self, key, kind=None):
        """The journaled response payload for ``key`` decoded from its
        canonical bytes (None = never seen).  ``kind`` guards against a
        key reused across ROUTES: a report's payload must never replay
        as a suggest response (wrong shape, served as a 200)."""
        entry = self.get(key)
        if entry is None:
            return None
        if kind is not None and entry.get("kind") != kind:
            raise ValueError(
                f"idempotency key {key!r} was used for a "
                f"{entry.get('kind')!r} request; refusing to replay it "
                f"as {kind!r} — use a fresh key per logical request"
            )
        return json.loads(base64.b64decode(entry["payload_b64"]))

    def record(self, key, kind, payload_bytes: bytes, docs=None,
               draw_index=None, tid=None, result=None):
        """Journal one response (durably, when the study is durable)
        BEFORE its side effects land in the trial store."""
        with self._lock:
            self._seq += 1
            entry = {
                "seq": self._seq,
                "key": str(key),
                "kind": str(kind),
                "payload_b64": base64.b64encode(payload_bytes).decode(
                    "ascii"
                ),
            }
            if docs is not None:
                entry["docs"] = docs
                entry["draw_index"] = int(draw_index)
            if tid is not None:
                entry["tid"] = int(tid)
                entry["result"] = result
            if str(key) not in self._entries:
                self._order.append(str(key))
            self._entries[str(key)] = entry
            while len(self._order) > self.max_entries:
                evicted = self._order.popleft()
                self._entries.pop(evicted, None)
            if self.path:
                self._append_line(entry)
                self._appends_since_compact += 1
                if self._appends_since_compact > 4 * self.max_entries:
                    # compaction: rewrite with only the live entries
                    # (atomic replace — crash-safe at any point)
                    from .. import journal_io

                    default, _ = _journal_codec()
                    nbytes = journal_io.compact_records(
                        self.path,
                        [self._entries[k] for k in self._order],
                        default=default, fsync_kind="journal",
                    )
                    self._appends_since_compact = 0
                    stats = _store_telemetry()
                    if stats is not None:
                        stats.record_journal_compaction(nbytes)
        if self.path:
            chaos = _active_chaos()
            if chaos is not None:
                chaos.maybe_torn_journal(self.path, str(key))
        return entry

    def entries(self):
        """Live entries, oldest first (a snapshot)."""
        with self._lock:
            return [self._entries[k] for k in self._order]

    def __len__(self):
        with self._lock:
            return len(self._order)


def suggest_payload(docs) -> list:
    """The suggest response body for a list of suggested trial docs —
    shared by the live path, the journal, and replays."""
    out = []
    for doc in docs:
        vals = {
            label: v[0]
            for label, v in doc["misc"]["vals"].items()
            if len(v)
        }
        out.append({"tid": int(doc["tid"]), "vals": vals})
    return out


class Study:
    """One tenant of the optimization service.

    Owns the search space, the Trials store (durable FileTrials under a
    service root, in-memory Trials otherwise), the per-study RNG, and a
    lock serializing every read/write of that state.  The scheduler and
    the report path both acquire ``self.lock`` — per-study mutual
    exclusion is the whole concurrency story at this layer (cross-study
    concurrency is the scheduler's job).
    """

    def __init__(self, study_id, space, seed, algo_name="tpe",
                 algo_params=None, trials=None, early_stop=None,
                 device=None, mesh=None):
        self.study_id = validate_study_id(study_id)
        self.space = space
        self.seed = int(seed)
        self.algo_name = str(algo_name)
        self.algo_params = dict(algo_params or {})
        # SH5xx actuation opt-in (default OFF): with an early_stop
        # config, the service checks no_progress_stop's criterion
        # after every landed report; a firing study transitions to the
        # terminal ``stopped`` state and releases its admission slot.
        # The hook owns a private SearchStats (criterion parameters
        # are the config's, not the study's display health).
        self.early_stop = dict(early_stop) if early_stop else None
        self.early_stop_fn = None
        if self.early_stop is not None:
            from ..control.actuation import build_stop_fn

            self.early_stop_fn = build_stop_fn(
                self.early_stop,
                n_startup_jobs=int(
                    (algo_params or {}).get("n_startup_jobs", 20)
                ),
            )
        # terminal stop record ({"t", "rule", "detail", ...}), or None
        # while active.  Written under self.lock; lock-free reads (the
        # registry's capacity count) see an atomic reference.
        self.stopped = None  # guarded-by: lock (writes)
        # the SERVICE owns the device: every study's suggest (and its
        # prepare for the batched dispatch) runs there
        self.device = device
        # ... and its mesh: every study's suggest shards over the one
        # service mesh unless its algo_params["mesh"] opts out
        self.mesh = study_mesh(self.algo_params, mesh, device)
        self.algo, self._prepare = _resolve_algo(
            self.algo_name, self.algo_params, device=device, mesh=self.mesh
        )
        self.domain = Domain(_null_objective, space)
        self.trials = trials if trials is not None else Trials()
        # multi-replica mode: the serving replica's fencing-token
        # credential (service.replicas.OwnershipHandle).  None in the
        # single-process shape — every ownership check then costs one
        # attribute read
        self.ownership = None
        self.lock = threading.Lock()
        self.rstate = np.random.default_rng(self.seed)
        self.n_seeds_drawn = 0
        # highest DRAW POSITION whose suggest's docs have landed — the
        # durable cursor.  A position (not a commit count): a failed
        # suggest consumes its draw without committing, and a later
        # committed draw must still advance the cursor PAST the failed
        # one, or a restart would re-issue a seed an existing trial
        # already used
        self.n_seeds_committed = 0
        self.created_at = time.time()
        self._docs_by_tid = {}
        for doc in self.trials._dynamic_trials:
            self._docs_by_tid[int(doc["tid"])] = doc
        # exactly-once plumbing, both touched only under self.lock:
        # the response journal (durable for FileTrials-backed studies)
        # and the in-flight dedup map (a retried key whose original
        # request is still queued attaches to the SAME pending instead
        # of consuming a second seed)
        self.journal = ResponseJournal(path=self._journal_path())
        self._inflight = {}  # idempotency_key -> _PendingSuggest
        # search-health telemetry: fed by the scheduler (fused-readback
        # diag per suggest) and the report path (loss/error/NaN stream);
        # internally locked — safe to read while self.lock is free
        self.search_stats = search_diag.SearchStats(
            study_id=self.study_id,
            n_startup_jobs=int(self.algo_params.get("n_startup_jobs", 20)),
        )
        # recovered studies re-count their result stream so the health
        # verdict survives a restart (the fused diag refreshes on the
        # next suggest)
        for doc in self.trials._dynamic_trials:
            if doc["state"] == JOB_STATE_DONE:
                self.search_stats.record_result(
                    loss=doc.get("result", {}).get("loss"),
                    status=doc.get("result", {}).get("status", "ok"),
                )
            elif doc["state"] == JOB_STATE_ERROR:
                self.search_stats.record_result(status="fail")

    def _journal_path(self):
        if getattr(self.trials, "jobs", None) is None:
            return None
        return self.trials.jobs.attachment_path(
            RESPONSE_JOURNAL_ATTACHMENT
        )

    # -- durability ----------------------------------------------------
    @property
    def durable(self) -> bool:
        return getattr(self.trials, "jobs", None) is not None

    def config_blob(self) -> bytes:
        cfg = {
            "study_id": self.study_id,
            "seed": self.seed,
            "algo_name": self.algo_name,
            "algo_params": self.algo_params,
            "space_b64": encode_space(self.space),
        }
        # only when opted in: studies without early_stop keep the
        # exact pre-control-plane config bytes
        if self.early_stop is not None:
            cfg["early_stop"] = self.early_stop
        return json.dumps(cfg, sort_keys=True).encode()

    def persist_config(self):
        if self.durable:
            self.trials.attachments[STUDY_CONFIG_ATTACHMENT] = (
                self.config_blob()
            )

    def config_matches(self, space, seed, algo_name, algo_params,
                       early_stop=None) -> bool:
        """Is the submitted config the one this study runs?  Guards the
        ``exist_ok`` attach path: silently serving suggestions from an
        OLD space to a client that re-created the study with a new one
        would crash (or corrupt) the client's space_eval."""
        if (
            int(seed) != self.seed
            or str(algo_name) != self.algo_name
            or dict(algo_params or {}) != self.algo_params
            or (dict(early_stop) if early_stop else None)
            != self.early_stop
        ):
            return False
        try:
            return encode_space(space) == encode_space(self.space)
        except Exception:
            return False

    def _persist_seed_cursor(self):
        if self.durable:
            self.trials.attachments[SEED_CURSOR_ATTACHMENT] = (
                str(self.n_seeds_committed).encode()
            )

    def fast_forward_seeds(self, n: int):
        """Re-draw ``n`` seeds after a restart so the (n+1)-th suggest
        of the recovered study gets exactly the seed it would have
        gotten without the restart."""
        for _ in range(int(n)):
            self.rstate.integers(2 ** 31 - 1)
        self.n_seeds_drawn = int(n)
        self.n_seeds_committed = int(n)

    # -- suggest plumbing (all called under self.lock) ------------------
    def draw_seed(self) -> int:
        """One seed per suggest request, in arrival order — the serial
        driver's exact protocol (FMinIter.run).  The durable cursor is
        persisted at INSERT time, not here: a crash between draw and
        insert must recover to "seed never consumed" (the client never
        got a response; its retry should get this seed again — the
        fmin-trajectory position), not to a skipped seed."""
        seed = int(self.rstate.integers(2 ** 31 - 1))
        self.n_seeds_drawn += 1
        return seed

    def prepare(self, new_ids, seed):
        """(requests, finish) for the batched device plane, or None when
        this suggest is host-side (startup/random, or an algo without a
        prepare variant)."""
        if self._prepare is None:
            return None
        return self._prepare(new_ids, self.domain, self.trials, seed)

    def suggest_inline(self, new_ids, seed):
        return self.algo(new_ids, self.domain, self.trials, seed)

    def refresh_local(self):
        """Recompute derived Trials views from the in-memory docs.  The
        service is the queue's single writer, so its in-memory docs are
        authoritative and the O(N)-file FileTrials.refresh disk re-read
        is pure waste on the hot path."""
        if self.durable:
            self.trials.refresh_local()
        else:
            self.trials.refresh()

    def insert(self, docs, draw_index=None):
        if draw_index is not None:
            for doc in docs:
                # the draw position travels WITH the doc so fsck and
                # restart recovery can re-derive the seed cursor from
                # the store alone (a stale cursor attachment is
                # repairable, not fatal)
                doc.setdefault("misc", {})["service_draw"] = int(draw_index)
        self.trials.insert_trial_docs(docs)
        # insert SONifies (copies) the docs — index the STORED copies,
        # or report would mutate orphans the history never sees
        for doc in self.trials._dynamic_trials[-len(docs):]:
            self._docs_by_tid[int(doc["tid"])] = doc
        self.refresh_local()
        if draw_index is not None:
            # seed-cursor commit point: this suggest's docs are now
            # durable, so a restart fast-forwards past its draw
            # position (see draw_seed for why not at draw time)
            self.n_seeds_committed = max(
                self.n_seeds_committed, int(draw_index)
            )
            self._persist_seed_cursor()

    def commit_suggest(self, docs, draw_index, idempotency_key=None):
        """The suggest commit point (caller holds ``self.lock``): journal
        first (the WAL — response + docs + draw position, fsync'd), then
        insert into the store.  A crash between the two is repaired by
        :meth:`replay_journal`; a crash before the append recovers to
        "seed never consumed".  Returns the response payload."""
        if self.ownership is not None:
            # stale-fence drop: re-verify the replica lease immediately
            # before the durable commit — a holder frozen past the TTL
            # whose study was reclaimed must never land this write
            # (raises OwnershipLost; nothing was journaled or stored)
            self.ownership.verify()
        payload = None
        if draw_index is not None:
            for doc in docs:
                doc.setdefault("misc", {})["service_draw"] = int(draw_index)
        payload = suggest_payload(docs)
        if idempotency_key is not None:
            self.journal.record(
                idempotency_key, "suggest", canonical_json(payload),
                docs=docs, draw_index=draw_index,
            )
        with tracing.span("store.insert", n_docs=len(docs)):
            self.insert(docs, draw_index=draw_index)
        return payload

    def _validate_result(self, tid, loss=None, status=STATUS_OK,
                         result=None):
        """(doc, result) after full validation — no side effects, so a
        rejected report never lands in the journal or the store."""
        doc = self._docs_by_tid.get(int(tid))
        if doc is None:
            raise StudyNotFound(
                f"study {self.study_id!r} has no trial {tid}"
            )
        if result is None:
            result = {"status": status}
            if loss is not None:
                result["loss"] = float(loss)
        if result.get("loss") is not None and not np.isfinite(
            float(result["loss"])
        ):
            # NaN/inf losses would poison best-trial math and render
            # as invalid JSON (bare NaN) in status payloads — a
            # diverged trial is a FAILED trial at this API.  The
            # rejection still COUNTS for search health (a NaN storm
            # must surface as FAULT_DEGRADED even though no state
            # changed) — once per trial, so an idempotent client
            # retrying the rejected report cannot inflate the counters
            self.search_stats.record_nan_rejected(doc["tid"])
            raise ValueError(
                f"non-finite loss {result['loss']!r} for trial {tid}; "
                f"report status='fail' instead"
            )
        return doc, result

    def _apply_result(self, doc, result):
        doc["result"] = result
        doc["state"] = (
            JOB_STATE_ERROR if result.get("status") == STATUS_FAIL
            else JOB_STATE_DONE
        )
        doc["refresh_time"] = coarse_utcnow()
        if self.durable:
            self.trials.jobs.write(doc)
        self.refresh_local()
        self.search_stats.record_result(
            loss=result.get("loss"), status=result.get("status", "ok")
        )
        return doc

    def report(self, tid, loss=None, status=STATUS_OK, result=None,
               idempotency_key=None):
        """Land one trial's outcome: DONE with a result (or ERROR for a
        failed evaluation), written through to the durable store.  With
        an idempotency key the response is journaled BEFORE the doc
        mutation (replay re-applies an unlanded result)."""
        if self.ownership is not None:
            # same stale-fence drop as commit_suggest: a reclaimed
            # study's terminal writes are refused BEFORE any journal
            # or store mutation
            self.ownership.verify()
        doc, result = self._validate_result(
            tid, loss=loss, status=status, result=result
        )
        if idempotency_key is not None:
            state = (
                JOB_STATE_ERROR if result.get("status") == STATUS_FAIL
                else JOB_STATE_DONE
            )
            payload = {"tid": int(doc["tid"]), "state": state}
            self.journal.record(
                idempotency_key, "report", canonical_json(payload),
                tid=int(doc["tid"]), result=result,
            )
        return self._apply_result(doc, result)

    # -- SH5xx actuation (caller holds self.lock) ------------------------
    def check_early_stop(self):
        """Evaluate the opt-in stop criterion against the landed
        results; transition to ``stopped`` (and return the record) the
        first time it fires.  No-op without the opt-in, and idempotent
        once stopped."""
        if self.early_stop_fn is None or self.stopped is not None:  # lint: disable=RL301  caller holds lock
            return None
        from ..control.actuation import evaluate_stop

        record = evaluate_stop(self.early_stop_fn, self.trials)
        if record is not None:
            self.stopped = record  # lint: disable=RL301  caller holds lock
        return record

    def resume(self):
        """Reverse a stop: clear the terminal state and reset the
        hook's private criterion counters (the stall window restarts —
        an immediately re-fired stop would make resume useless)."""
        self.stopped = None  # lint: disable=RL301  caller holds lock
        if self.early_stop is not None:
            from ..control.actuation import build_stop_fn

            self.early_stop_fn = build_stop_fn(
                self.early_stop,
                n_startup_jobs=int(
                    self.algo_params.get("n_startup_jobs", 20)
                ),
            )

    # -- startup recovery ------------------------------------------------
    def max_service_draw(self) -> int:
        """Highest seed-draw position evidenced by the store or the
        journal — the floor any recovered seed cursor must respect."""
        high = 0
        for doc in self.trials._dynamic_trials:
            high = max(high, int(doc.get("misc", {}).get(
                "service_draw", 0
            )))
        for entry in self.journal.entries():
            if entry.get("kind") == "suggest":
                high = max(high, int(entry.get("draw_index", 0)))
        return high

    def replay_journal(self) -> int:
        """Re-apply journal entries whose effects never landed (the
        crash-between-journal-and-store window): re-insert missing
        suggested docs, re-land unapplied reports.  Idempotent; returns
        the number of entries that needed replaying."""
        n = 0
        for entry in self.journal.entries():
            kind = entry.get("kind")
            if kind == "suggest":
                docs = entry.get("docs") or []
                missing = [
                    doc for doc in docs
                    if int(doc["tid"]) not in self._docs_by_tid
                ]
                if missing:
                    self.insert(
                        missing, draw_index=entry.get("draw_index")
                    )
                    n += 1
            elif kind == "report":
                doc = self._docs_by_tid.get(int(entry.get("tid", -1)))
                if doc is not None and doc["state"] in (
                    JOB_STATE_NEW, JOB_STATE_RUNNING
                ):
                    self._apply_result(doc, entry.get("result"))
                    n += 1
        return n

    def status(self) -> dict:
        counts = {
            JOB_STATE_NEW: 0, JOB_STATE_RUNNING: 0,
            JOB_STATE_DONE: 0, JOB_STATE_ERROR: 0,
        }
        for doc in self.trials._dynamic_trials:
            counts[doc["state"]] = counts.get(doc["state"], 0) + 1
        hist = self.trials.history
        best = None
        usable = np.flatnonzero(~np.isnan(hist.losses))
        if len(usable):  # NaN-guard mirrors Trials.best_trial
            i = int(usable[np.argmin(hist.losses[usable])])
            best = {
                "tid": int(hist.loss_tids[i]),
                "loss": float(hist.losses[i]),
            }
        snap = self.search_stats.snapshot()
        health = self.search_stats.health(snap=snap)
        return {
            "study_id": self.study_id,
            "seed": self.seed,
            "algo": self.algo_name,
            "algo_params": self.algo_params,
            # lifecycle: "stopped" is the SH5xx-actuated terminal state
            # (slot released, suggests refused until resume)
            "status": "stopped" if self.stopped is not None else "active",  # lint: disable=RL301  caller holds lock
            "stopped": self.stopped,  # lint: disable=RL301  caller holds lock
            "early_stop": self.early_stop,
            "n_trials": len(self.trials._dynamic_trials),
            "states": {str(k): v for k, v in counts.items()},
            "n_completed": counts[JOB_STATE_DONE],
            "n_suggests": self.n_seeds_drawn,
            "best": best,
            "durable": self.durable,
            # operators correlate health verdicts with the resilience
            # layer from this one document — no store reads required
            "faults": snap["faults"],
            "seed_cursor": {
                "drawn": self.n_seeds_drawn,
                "committed": self.n_seeds_committed,
            },
            # the search-health block: SH5xx verdict + the optimizer
            # statistics it was derived from (latest fused suggest)
            "health": {
                "state": health["state"],
                "rule": health["rule"],
                "rules": health["rules"],
                "best_loss": snap["best_loss"],
                "regret": snap["regret"],
                "improvement_window": snap["improvement_window"],
                "stall_window": snap["stall_window"],
                "n_results": snap["n_results"],
                "n_startup_jobs": snap["n_startup_jobs"],
                "regret_curve": snap["regret_curve"],
                "last_suggest": snap["last_suggest"],
            },
        }


class StudyRegistry:
    """The service's study table, durable under ``root`` when set.

    ``root`` layout::

        <root>/studies/<study_id>/   one FileTrials queue dir per study
                                     (trials/, locks/, attachments/ ...)

    On construction every existing study directory is recovered: the
    config attachment rebuilds the Study (space, algo, seed), FileTrials
    re-reads the trial docs, and the seed cursor fast-forwards the RNG —
    the study continues exactly where the previous server left it.
    """

    # lock-order: _create_lock < _studies_lock
    def __init__(self, root=None, max_studies=DEFAULT_MAX_STUDIES,
                 device=None, replica_set=None, mesh=None):
        self.root = os.path.abspath(root) if root else None
        self.max_studies = int(max_studies)
        self.device = device  # the service's device, bound into studies
        self.mesh = mesh  # the service's mesh (or None), likewise
        # multi-replica mode: recovery and create claim per-study
        # ownership leases through this ReplicaSet; a study another
        # live replica holds is skipped at recovery and refused (307)
        # at create.  None keeps the single-process behavior exactly.
        self.replica_set = replica_set
        self._studies_lock = threading.Lock()
        # serializes whole create() calls: the capacity/exists check,
        # the on-disk side effects (study dir + config attachment), and
        # the registry insert must be one atomic step, or a raced
        # duplicate create could persist the LOSER's config and break
        # restart recovery
        self._create_lock = threading.Lock()
        self._studies = {}  # guarded-by: _studies_lock
        # startup-recovery accounting, written once before the server
        # admits traffic and read by /readyz
        self.recovery_info = {
            "recovered_studies": 0,
            "failed_studies": 0,
            "journal_entries_replayed": 0,
            "torn_journal_lines": 0,
            "seed_cursors_repaired": 0,
        }
        if self.root:
            os.makedirs(os.path.join(self.root, "studies"), exist_ok=True)
            self._recover()

    def _study_dir(self, study_id):
        return os.path.join(
            self.root, "studies", validate_study_id(study_id)
        )

    def load_study(self, study_id) -> Study:
        """Rebuild one study from its on-disk queue directory: config
        attachment → Study, journal replay, seed-cursor re-verify.  The
        exactly-once recovery protocol, shared by startup recovery and
        replica takeover.  Does NOT register the study — the caller
        decides when it starts serving (takeover pre-warms first).
        Host work only: the first device work of a loaded study is its
        pre-warm or its first suggest, both on the scheduler thread."""
        from ..parallel.file_trials import FileTrials

        qdir = self._study_dir(study_id)
        trials = FileTrials(qdir)
        blob = trials.attachments[STUDY_CONFIG_ATTACHMENT]
        cfg = json.loads(blob.decode())
        study = Study(
            cfg["study_id"],
            decode_space(cfg["space_b64"]),
            cfg["seed"],
            algo_name=cfg["algo_name"],
            algo_params=cfg.get("algo_params") or {},
            trials=trials,
            early_stop=cfg.get("early_stop"),
            device=self.device,
            mesh=self.mesh,
        )
        # exactly-once recovery: re-apply journal entries whose
        # effects never landed (crash between journal append and
        # store insert), THEN re-verify the seed cursor against
        # the evidence in docs + journal — a stale cursor would
        # re-issue a seed an existing trial already used
        n_replayed = study.replay_journal()
        self.recovery_info["journal_entries_replayed"] += n_replayed
        self.recovery_info["torn_journal_lines"] += (
            study.journal.n_torn_lines
        )
        try:
            cursor = int(
                trials.attachments[SEED_CURSOR_ATTACHMENT].decode()
            )
        except (KeyError, ValueError):
            cursor = 0
        evidenced = study.max_service_draw()
        if evidenced > cursor:
            cursor = evidenced
            self.recovery_info["seed_cursors_repaired"] += 1
        study.fast_forward_seeds(cursor)
        study._persist_seed_cursor()
        logger.info(
            "recovered study %r (%d trials, %d suggests served, "
            "%d journal entries replayed)",
            study.study_id, len(study.trials._dynamic_trials),
            study.n_seeds_drawn, n_replayed,
        )
        return study

    def install(self, study: Study):
        """Register a recovered/adopted study for serving."""
        with self._studies_lock:
            self._studies[study.study_id] = study

    def remove(self, study_id) -> bool:
        """Evict a study from serving (relinquished ownership).  The
        on-disk state is untouched — the new owner recovers it."""
        with self._studies_lock:
            return self._studies.pop(str(study_id), None) is not None

    def _release(self, study_id, handle):
        """Hand a claimed study back (fence preserved) and forget it."""
        self.replica_set.leases.release(
            study_id, self.replica_set.replica_id, handle.fence
        )
        self.replica_set.drop(study_id)

    def _recover(self):
        studies_dir = os.path.join(self.root, "studies")
        for name in sorted(os.listdir(studies_dir)):
            qdir = os.path.join(studies_dir, name)
            if not os.path.isdir(qdir):
                continue
            handle = None
            if self.replica_set is not None:
                # claim-before-recover: a study another live replica
                # holds is ITS tenant, not ours (no failure — skip);
                # claimable studies (unheld, expired, released) are
                # taken over with a bumped fence
                handle = self.replica_set.try_claim(name)
                if handle is None:
                    logger.info(
                        "study %r is leased to another replica; skipping",
                        name,
                    )
                    continue
            try:
                study = self.load_study(name)
            except Exception:
                logger.exception("could not recover study dir %s", qdir)
                self.recovery_info["failed_studies"] += 1
                if handle is not None:
                    # release so a healthier replica may try
                    self._release(name, handle)
                continue
            study.ownership = handle
            self.install(study)
            self.recovery_info["recovered_studies"] += 1

    def n_active(self) -> int:
        """Studies holding an admission slot: registered and NOT in
        the SH5xx-stopped terminal state (a stopped study's slot is
        reclaimed — that is the actuation loop's whole point)."""
        with self._studies_lock:
            return sum(
                1 for s in self._studies.values() if s.stopped is None
            )

    def create(self, study_id, space, seed=0, algo_name="tpe",
               algo_params=None, exist_ok=False, early_stop=None) -> Study:
        study_id = validate_study_id(study_id)
        # _create_lock spans check → disk side effects → insert, so a
        # raced duplicate can never persist its config over the winner's
        # and the capacity check cannot be overshot
        with self._create_lock:
            with self._studies_lock:
                existing = self._studies.get(study_id)
                # capacity counts ACTIVE studies: slots reclaimed from
                # SH5xx-stopped studies re-admit queued creates
                n_now = sum(
                    1 for s in self._studies.values()
                    if s.stopped is None
                )
            if existing is not None:
                if exist_ok:
                    if not existing.config_matches(
                        space, seed, algo_name, algo_params,
                        early_stop=early_stop,
                    ):
                        raise StudyExists(
                            f"study {study_id!r} exists with a DIFFERENT "
                            f"config (space/seed/algo); pick a new "
                            f"study_id or delete the old study"
                        )
                    return existing
                raise StudyExists(f"study {study_id!r} already exists")
            if n_now >= self.max_studies:
                raise BackpressureError(
                    f"study registry full ({self.max_studies}); retry "
                    f"after capacity frees up"
                )
            # validate EVERYTHING that can reject the create BEFORE any
            # disk side effect — a rejected create must not leave an
            # orphan study dir (no config attachment) for _recover() to
            # trip over on every restart.  Domain construction is the
            # space's real gate (compiles it, catches duplicate labels
            # etc.); the throwaway instance is cheap next to a create.
            _resolve_algo(str(algo_name), dict(algo_params or {}))
            # a per-study mesh may opt out or restate the server's: never
            # another (one dispatch, one mesh)
            study_mesh(algo_params, self.mesh, self.device)
            if early_stop is not None:
                # validate the opt-in config side-effect free (400 on
                # a malformed dict, same as a bad space)
                from ..control.actuation import build_stop_fn

                build_stop_fn(dict(early_stop))
            Domain(_null_objective, space)
            handle = None
            if self.replica_set is not None:
                # ownership-before-side-effects: claim the study's
                # lease BEFORE the directory exists, so a raced create
                # on two replicas has exactly one winner (the fence
                # bump is the linearization point) and the loser
                # redirects with no orphan dir
                handle = self.replica_set.try_claim(study_id)
                if handle is None:
                    owner, url = self.replica_set.owner_hint(study_id)
                    raise NotOwner(
                        study_id, owner_id=owner, owner_url=url
                    )
            try:
                trials = None
                if self.root:
                    from ..parallel.file_trials import FileTrials

                    trials = FileTrials(self._study_dir(study_id))
                study = Study(
                    study_id, space, seed,
                    algo_name=algo_name, algo_params=algo_params,
                    trials=trials, early_stop=early_stop,
                    device=self.device, mesh=self.mesh,
                )
                study.persist_config()
            except Exception:
                if handle is not None:
                    self._release(study_id, handle)
                raise
            study.ownership = handle
            with self._studies_lock:
                self._studies[study.study_id] = study
        return study

    def get(self, study_id) -> Study:
        with self._studies_lock:
            study = self._studies.get(str(study_id))
        if study is None:
            raise StudyNotFound(f"no study {study_id!r}")
        return study

    def list(self):
        with self._studies_lock:
            return sorted(self._studies)

    def studies(self):
        """Snapshot of the live Study objects (unordered)."""
        with self._studies_lock:
            return list(self._studies.values())

    def __len__(self):
        with self._studies_lock:
            return len(self._studies)


class _PendingSuggest:
    """One queued suggest request: the handler thread waits on ``done_event``
    while the scheduler fills ``docs`` (or ``error``).  ``ids``/``seed``
    are drawn once on the first dispatch attempt and reused by recovery
    retries — seed transparency across device failures.  A request with
    an ``idempotency_key`` is also the dedup anchor: retries of the same
    key wait on THIS pending instead of submitting a second one."""

    __slots__ = (
        "study", "n", "ids", "seed", "draw_index", "docs", "payload",
        "error", "done", "done_event", "cancelled", "enqueued_at",
        "idempotency_key", "trace", "parent_span", "popped_at", "spanned",
        "completed_at", "compiled",
    )

    def __init__(self, study: Study, n: int, idempotency_key=None):
        self.study = study
        self.n = int(n)
        self.idempotency_key = idempotency_key
        self.ids = None
        self.seed = None
        self.draw_index = None
        self.docs = None
        self.payload = None
        self.error = None
        self.done = False
        self.cancelled = False
        self.done_event = threading.Event()
        self.enqueued_at = time.monotonic()
        # the explicit cross-thread trace handoff (handler → scheduler):
        # the scheduler re-binds this trace around this request's share
        # of the batch work, nesting under parent_span (the request's
        # root span).  Both None when the request is untraced.
        self.trace = None
        self.parent_span = None
        self.popped_at = None  # when the scheduler popped this request
        self.spanned = False   # intake spans recorded (once, not per retry)
        self.completed_at = None  # when complete()/fail() fired
        # was the dispatch serving this request a compile event (the
        # first dispatch of its program key in the process)?  The whole
        # batch waited on it, so the whole batch is "cold" — the
        # first-touch vs steady-state latency attribution
        self.compiled = False

    def complete(self, docs, payload=None):
        self.docs = docs
        self.payload = (
            payload if payload is not None else suggest_payload(docs)
        )
        self.done = True
        self.completed_at = time.monotonic()
        self.done_event.set()

    def fail(self, error):
        self.error = error
        self.done = True
        self.completed_at = time.monotonic()
        self.done_event.set()

    def wait(self, timeout):
        if not self.done_event.wait(timeout):
            # best-effort cancellation: a request that has not started
            # (no seed drawn, no ids allocated) is abandoned outright,
            # so the client's retry gets THIS seed — no trajectory
            # divergence and no orphan trial docs.  One already in
            # flight completes normally (its docs land; only the
            # response is lost), which is the unavoidable case.
            self.cancelled = True
            raise TimeoutError(
                f"suggest for study {self.study.study_id!r} did not "
                f"complete within {timeout}s"
            )
        if self.error is not None:
            raise self.error
        return self.docs


class SuggestScheduler:
    """The continuous-batching dispatcher.

    One daemon thread: pop whatever is queued, hold the batch open for
    ``batch_window`` seconds (or until ``max_batch``), prepare every
    request under its study's lock, launch ALL device-plane requests
    back to back, resolve the single readback, finish and insert each
    study's docs.  Host-side suggests (random startup) complete inline
    without a device dispatch.

    While a batch runs on the card, new arrivals pile into the queue —
    the next batch picks them all up at once, which is where occupancy
    > 1 comes from under load without adding idle latency.

    This thread is the only one that launches on the card or reads back:
    other device work (the readiness probe, the warmup replay, a
    cold-containment dispatch) is handed to it with :meth:`call_soon`
    and runs between batches.
    """

    def __init__(self, stats: ServiceStats = None, device_recovery=None,
                 batch_window=DEFAULT_BATCH_WINDOW,
                 max_batch=DEFAULT_MAX_BATCH, max_queue=DEFAULT_MAX_QUEUE,
                 cold_fallback=False, mesh_label="off", knobs=None):
        # the serving knobs live in a KnobSet read PER BATCH (not
        # frozen constructor copies), so a runtime change — POST
        # /v1/config or the closed-loop controller — lands on the very
        # next batch.  Without an externally supplied KnobSet (or any
        # runtime mutation of one), every read returns exactly the
        # constructor values: today's static behavior, bit-for-bit.
        if knobs is None:
            from ..control import KnobSet

            knobs = KnobSet(static={
                "batch_window": float(batch_window),
                "max_batch": int(max_batch),
                "max_queue": int(max_queue),
                "max_speculation": 0,
            })
        self.knobs = knobs
        self.stats = stats if stats is not None else ServiceStats()
        self.device_recovery = device_recovery
        # the serving mesh label ("off": one card) — stamped on every
        # device.dispatch span so a trace says which topology ran it
        self.mesh_label = str(mesh_label)
        # cold containment (OFF by default — it trades trajectory
        # determinism for tail latency): when the program a batch would
        # dispatch is not warm (its first dispatch would be a compile
        # event), serve the batch from the host-side startup path
        # (random suggest) tagged ``served_cold`` and queue a warm-up
        # dispatch of that program on this thread, so the NEXT request
        # finds it warm
        self.cold_fallback = bool(cold_fallback)
        self._bg_lock = threading.Lock()
        self._bg_compiling = set()  # guarded-by: _bg_lock (program keys)
        # per-program background-compile failure counts: past the
        # budget, containment STOPS for that program and the batch
        # dispatches normally, so the compile error surfaces to the
        # requests (and the recovery layer) instead of degrading the
        # study to random suggests forever
        self._bg_failures = {}  # guarded-by: _bg_lock
        self.max_bg_compile_failures = 3
        self._queue_cv = threading.Condition()
        self._queue = deque()  # guarded-by: _queue_cv
        self._tasks = deque()  # guarded-by: _queue_cv  (call_soon fns)
        self._draining = False  # guarded-by: _queue_cv
        self._stopped = False  # guarded-by: _queue_cv
        self._busy = False  # guarded-by: _queue_cv
        self._thread = threading.Thread(
            target=self._loop, name="hyperopt-service-scheduler", daemon=True
        )
        self._thread.start()

    # -- live knobs ------------------------------------------------------
    # per-batch reads, NOT cached: the control plane's whole contract
    # is that a knob change takes effect on the next batch
    @property
    def batch_window(self) -> float:
        return self.knobs.get("batch_window")

    @property
    def max_batch(self) -> int:
        return self.knobs.get("max_batch")

    @property
    def max_queue(self) -> int:
        return self.knobs.get("max_queue")

    @property
    def max_speculation(self) -> int:
        return self.knobs.get("max_speculation")

    # -- submission -----------------------------------------------------
    def submit(self, study: Study, n: int = 1, idempotency_key=None,
               trace=None, parent_span=None) -> _PendingSuggest:
        pending = _PendingSuggest(study, n, idempotency_key=idempotency_key)
        # attach the trace BEFORE the queue sees the pending: the
        # scheduler may pop it the instant the lock releases
        pending.trace = trace
        pending.parent_span = parent_span if trace is not None else None
        with self._queue_cv:
            if self._draining or self._stopped:
                raise ServiceDraining("service is draining; not admitting")
            if len(self._queue) >= self.max_queue:
                self.stats.record_rejection("suggest")
                raise BackpressureError(
                    f"suggest queue full ({self.max_queue} waiting); "
                    f"retry shortly"
                )
            self._queue.append(pending)
            depth = len(self._queue)
            self._queue_cv.notify_all()
        self.stats.set_queue_depth(depth)
        return pending

    def call_soon(self, fn):
        """Run ``fn()`` on the scheduler thread before the next batch (the
        device work that is not a suggest).  Exceptions are logged."""
        with self._queue_cv:
            self._tasks.append(fn)
            self._queue_cv.notify_all()

    def _run_tasks(self):
        while True:
            with self._queue_cv:
                if not self._tasks:
                    return
                fn = self._tasks.popleft()
                self._busy = True
            try:
                fn()
            except Exception:
                logger.exception("scheduler task failed")
            finally:
                with self._queue_cv:
                    self._busy = False
                    self._queue_cv.notify_all()

    # -- scheduler thread ----------------------------------------------
    def _loop(self):
        while True:
            self._run_tasks()
            batch = []
            with self._queue_cv:
                while (
                    not self._queue and not self._tasks
                    and not self._stopped
                ):
                    self._queue_cv.wait(0.1)
                if self._tasks:
                    continue
                if self._stopped and not self._queue:
                    return
                while self._queue and len(batch) < self.max_batch:
                    p = self._queue.popleft()
                    p.popped_at = time.monotonic()
                    batch.append(p)
                self._busy = True
            # batching window: only when the pop found CONCURRENT
            # traffic does the batch stay open briefly for stragglers —
            # a lone request (the serial-client case) dispatches
            # immediately, so an idle server adds zero latency.  Under
            # load, occupancy comes mostly from arrivals piling up
            # while the previous batch runs on the card; the window just
            # catches a burst's tail.
            if len(batch) > 1:
                deadline = time.monotonic() + self.batch_window
                while len(batch) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    with self._queue_cv:
                        if not self._queue:
                            self._queue_cv.wait(remaining)
                        while self._queue and len(batch) < self.max_batch:
                            p = self._queue.popleft()
                            p.popped_at = time.monotonic()
                            batch.append(p)
            with self._queue_cv:
                depth = len(self._queue)
            self.stats.set_queue_depth(depth)
            try:
                self._dispatch_batch(batch)
            finally:
                with self._queue_cv:
                    self._busy = False
                    self._queue_cv.notify_all()
                    depth = len(self._queue)
                # dispatch-time sample: without it the depth gauge (and
                # the control plane's mean-depth objective) only ever
                # saw arrival instants — a quiet tenant's drained queue
                # between arrivals was a blind spot
                self.stats.set_queue_depth(depth)

    def _dispatch_batch(self, batch):
        try:
            if self.device_recovery is not None:
                # seeds/ids are drawn once per request (memoized on the
                # pending), so a recovery retry re-prepares against the
                # re-uploaded history with the SAME inputs
                self.device_recovery.run(lambda: self._attempt(batch))
            else:
                self._attempt(batch)
        except Exception as e:
            logger.exception("suggest batch failed")
            for p in batch:
                if not p.done:
                    self._fail(p, e)

    def _unregister_inflight(self, p: _PendingSuggest):
        """Drop a finished pending from its study's dedup map (only if
        it is still the registered attempt for its key).  Never called
        while holding the study lock."""
        if p.idempotency_key is None:
            return
        study = p.study
        with study.lock:
            if study._inflight.get(p.idempotency_key) is p:
                del study._inflight[p.idempotency_key]

    def _complete(self, p: _PendingSuggest, docs, payload=None):
        # unregister BEFORE waking the waiters: a retry that lands
        # after the wake finds the key in the journal (committed by
        # commit_suggest), never a half-dead inflight entry
        self._unregister_inflight(p)
        p.complete(docs, payload=payload)

    def _fail(self, p: _PendingSuggest, error):
        self._unregister_inflight(p)
        p.fail(error)

    def _span_intake(self, p: _PendingSuggest, t_attempt: float):
        """Record the passive intake intervals for one request — queue
        wait (submit → pop) and coalesce (pop → batch close) — into the
        phase stats and, when traced, the request's trace.  Once per
        request: a device-recovery retry re-runs ``_attempt`` but the
        request only queued once."""
        if p.spanned:
            return
        p.spanned = True
        popped = p.popped_at if p.popped_at is not None else t_attempt
        self.stats.record_phase("queue_wait", popped - p.enqueued_at)
        self.stats.record_phase("coalesce", t_attempt - popped)
        if p.trace is None:
            return
        p.trace.record_span(
            "suggest.queue_wait", p.enqueued_at, popped,
            parent=p.parent_span,
        )
        p.trace.record_span(
            "suggest.coalesce", popped, t_attempt, parent=p.parent_span,
        )

    def _attempt(self, batch):
        from ..resilience.device import is_device_error

        t_attempt = time.monotonic()
        groups, finishes = [], []
        for p in batch:
            if p.done:
                continue  # completed inline before a recovery retry
            if p.cancelled and p.ids is None:
                # the waiter already timed out and nothing was consumed
                # yet: abandon it cleanly (seed stays in the study's
                # stream for the client's retry)
                self._fail(p, TimeoutError("abandoned after client timeout"))
                continue
            study = p.study
            self._span_intake(p, t_attempt)
            t_prep0 = time.monotonic()
            t_draw1 = None
            try:
                # explicit cross-thread handoff: this scheduler thread
                # adopts the request's trace for exactly this request's
                # share of the work, then unbinds (spans cannot leak
                # into a batch-mate's trace)
                with tracing.use_trace(p.trace, parent=p.parent_span):
                    if p.trace is not None and t_prep0 > t_attempt:
                        p.trace.record_span(
                            "batch.peer_wait", t_attempt, t_prep0,
                            parent=p.parent_span, stage="prepare",
                        )
                    with study.lock:
                        if p.ids is None:
                            p.seed = study.draw_seed()
                            p.draw_index = study.n_seeds_drawn
                            p.ids = study.trials.new_trial_ids(p.n)
                        # study-lock wait + seed draw + trial-id
                        # allocation (a durable study pays a counter
                        # fsync here) — milliseconds that were dark
                        # before this span existed
                        t_draw1 = time.monotonic()
                        if p.trace is not None and t_draw1 > t_prep0:
                            p.trace.record_span(
                                "suggest.draw", t_prep0, t_draw1,
                                parent=p.parent_span,
                            )
                        with tracing.span("suggest.prepare"):
                            prep = study.prepare(p.ids, p.seed)
                        if prep is None:
                            # host-side path (random startup / no prepare
                            # variant): complete inline, no device program
                            with tracing.span("suggest.inline"):
                                docs = study.suggest_inline(p.ids, p.seed)
                                payload = study.commit_suggest(
                                    docs, p.draw_index,
                                    idempotency_key=p.idempotency_key,
                                )
            except Exception as e:
                # multi-tenant isolation: one study's bad prepare must
                # not fail the other studies coalesced into this batch —
                # but device-plane errors are the whole batch's problem
                # and must reach the recovery wrapper
                if is_device_error(e):
                    raise
                logger.exception(
                    "suggest for study %r failed", study.study_id
                )
                self._fail(p, e)
                continue
            t_prep1 = time.monotonic()
            self.stats.record_phase("draw", (t_draw1 or t_prep1) - t_prep0)
            if prep is None:
                self.stats.record_phase("inline", t_prep1 - (t_draw1 or t_prep0))
                self.stats.record_inline()
                # host-side suggests (startup/random) carry no fused
                # diag; the count still feeds the study's health stats
                study.search_stats.record_suggest(None)
                self._complete(p, docs, payload=payload)
            else:
                self.stats.record_phase("prepare", t_prep1 - (t_draw1 or t_prep0))
                groups.append(prep[0])
                finishes.append((p, prep[1], t_prep1))
        if not finishes:
            return
        from ..algos import tpe_device

        order = tpe_device.canonical_group_order(groups)
        flat = [r for i in order for r in groups[i]]
        # is this dispatch a compile event?  (the first of its program
        # key in the process — what the compile observer counts)
        batch_compiled = not tpe_device.is_warm(flat)
        if self.cold_fallback and batch_compiled:
            with self._bg_lock:
                poisoned = self._bg_failures.get(
                    tpe_device.program_key(flat), 0
                ) >= self.max_bg_compile_failures
            if not poisoned:
                # cold containment: this batch's program is not warm —
                # dispatching it would park every member behind a
                # compile event.  Serve them all host-side (tagged
                # served_cold) and warm the program next on this thread.
                # A program whose warm-up keeps failing is NOT
                # contained again: the batch dispatches normally so the
                # error reaches the requests instead of silently
                # degrading the study to random suggests forever.
                self._spawn_background_compile(flat)
                for p, _finish, _t in finishes:
                    self._serve_cold_fallback(p)
                return
        t0 = time.perf_counter()

        # the batch LEADER's trace is bound for the launch: a compile
        # event fired here (via the tpe_device compile observers)
        # becomes a compile span on exactly one trace — the one that
        # paid for it
        lead = next(
            (p for p, _, _ in finishes if p.trace is not None), None
        )
        t_launch0 = time.monotonic()
        with tracing.use_trace(
            lead.trace if lead is not None else None,
            parent=lead.parent_span if lead is not None else None,
        ):
            resolvers = tpe_device.multi_study_suggest_async(groups)
            t_launch1 = time.monotonic()
            outs = [r() for r in resolvers]  # ONE readback, first call
        # each group's search-health rows rode that same readback
        # (zero extra dispatches — see hyperopt_tpu_torch.diagnostics)
        diags = [getattr(r, "diag", None) for r in resolvers]
        t_read1 = time.monotonic()
        n_batch = len(finishes)
        self.stats.record_dispatch(n_batch, time.perf_counter() - t0)
        self.stats.record_phase("dispatch", t_launch1 - t_launch0)
        self.stats.record_phase("readback", t_read1 - t_launch1)
        # roofline attribution of THIS dispatch: the device profiler's
        # resolver callback ran on this thread during the readback
        # above, so its record (consumed — a later batch can never read
        # a stale one) is exactly this dispatch's.  (Its ``compiled``
        # flag marks a kernel-library load; the batch's cold flag is the
        # compile event decided before the launch.)  Every request in a
        # compile-event batch waited on it — all cold.
        from .. import profiling

        roof = profiling.last_dispatch_record()
        for p, _, _ in finishes:
            p.compiled = batch_compiled
        roof_attrs = {}
        if roof is not None:
            roof_attrs = {
                "ceiling": roof["binding_ceiling"],
                "roofline_pct": _r4(roof["roofline_pct"]),
                "roofline_pct_bw": _r4(roof["roofline_pct_bw"]),
                "achieved_GBps": _r4(roof["achieved_GBps"]),
                "achieved_tflops": _r4(roof["achieved_tflops"]),
                "hbm_bytes": roof["hbm_bytes"],
                "flops": roof["flops"],
                "compiled": roof["compiled"],
            }
        # fan the shared device spans out to EVERY traced request in the
        # batch: the span interval is the real (shared) wall interval,
        # and pro_rata_s attributes this request's 1/n share — summing
        # pro_rata_s across the batch reproduces the batch total
        for p, _, t_prep1 in finishes:
            if p.trace is None:
                continue
            if t_launch0 > t_prep1:
                # time spent behind LATER batch-mates' prepares
                p.trace.record_span(
                    "batch.peer_wait", t_prep1, t_launch0,
                    parent=p.parent_span, stage="prepare",
                )
            sp = p.trace.record_span(
                "device.dispatch", t_launch0, t_launch1,
                parent=p.parent_span, batch_size=n_batch, shared=True,
                pro_rata_s=round((t_launch1 - t_launch0) / n_batch, 9),
                mesh=self.mesh_label, compiled=batch_compiled,
            )
            sp.update_attrs(roof_attrs)
            p.trace.record_span(
                "device.readback", t_launch1, t_read1,
                parent=p.parent_span, batch_size=n_batch, shared=True,
                pro_rata_s=round((t_read1 - t_launch1) / n_batch, 9),
                device_total_s=round(t_read1 - t_launch0, 9),
            )
        for (p, finish, _t_prep1), o, dg in zip(finishes, outs, diags):
            study = p.study
            t_f0 = time.monotonic()
            try:
                with tracing.use_trace(p.trace, parent=p.parent_span):
                    if p.trace is not None and t_f0 > t_read1:
                        # time spent behind batch-mates' finishes
                        p.trace.record_span(
                            "batch.peer_wait", t_read1, t_f0,
                            parent=p.parent_span, stage="finish",
                        )
                    with tracing.span("suggest.finish"):
                        with study.lock:
                            if dg is not None and getattr(
                                finish, "accepts_diag", False
                            ):
                                docs = finish(o, diag=dg)
                            else:
                                docs = finish(o)
                            # consume the snapshot finish published on
                            # this thread IMMEDIATELY: a later commit
                            # failure must not leave it to be claimed
                            # by a batch-mate's suggest
                            snap = search_diag.last_suggest_diag()
                            payload = study.commit_suggest(
                                docs, p.draw_index,
                                idempotency_key=p.idempotency_key,
                            )
            except Exception as e:
                # defensive TLS clear: whatever a failed finish/commit
                # left published must not be claimed by a batch-mate
                search_diag.last_suggest_diag()
                if is_device_error(e):
                    raise
                logger.exception(
                    "finishing suggest for study %r failed", study.study_id
                )
                self._fail(p, e)
                continue
            # fold it into the study's search-health accumulator
            study.search_stats.record_suggest(snap)
            self.stats.record_phase("finish", time.monotonic() - t_f0)
            self._complete(p, docs, payload=payload)

    # -- cold containment ----------------------------------------------
    def _serve_cold_fallback(self, p: _PendingSuggest):
        """Serve one pending from the host-side startup path (random
        suggest at the study's already-drawn seed) while its program
        waits for its warm-up dispatch.  The trial is real and committed;
        the trace root carries ``served_cold=true`` and the fallback is
        counted (``hyperopt_service_cold_fallbacks_total``)."""
        from ..algos import rand

        study = p.study
        t0 = time.monotonic()
        try:
            with tracing.use_trace(p.trace, parent=p.parent_span):
                with tracing.span("suggest.cold_fallback"):
                    with study.lock:
                        docs = rand.suggest(
                            p.ids, study.domain, study.trials, p.seed,
                            device=study.device,
                        )
                        payload = study.commit_suggest(
                            docs, p.draw_index,
                            idempotency_key=p.idempotency_key,
                        )
        except Exception as e:
            logger.exception(
                "cold-fallback suggest for study %r failed",
                study.study_id,
            )
            self._fail(p, e)
            return
        if p.trace is not None and p.parent_span is not None:
            p.parent_span.set_attr("served_cold", True)
        self.stats.record_cold_fallback()
        self.stats.record_inline()
        self.stats.record_phase("cold_fallback", time.monotonic() - t0)
        study.search_stats.record_suggest(None)
        self._complete(p, docs, payload=payload)

    def _spawn_background_compile(self, flat_requests):
        """Queue one warm-up dispatch of the program of ``flat_requests``
        on this thread (:meth:`call_soon`), against ZERO-FILLED clones of
        the arguments (the live buffers may change under a history
        append before it runs; zeros of the same shapes give the same
        program key).  Deduplicated per program key; errors are logged
        and counted, never raised."""
        import torch

        from ..algos import tpe_device

        key = tpe_device.program_key(flat_requests)
        cap = self.max_speculation
        with self._bg_lock:
            if key in self._bg_compiling:
                return
            if cap and len(self._bg_compiling) >= cap:
                # speculation-depth knob: bound the QUEUED warm-ups
                # (0 = unbounded); an over-cap program stays cold until
                # a slot frees — the next request re-requests it
                return
            self._bg_compiling.add(key)
        clones = [
            (
                kind,
                tuple(
                    torch.zeros_like(a) if isinstance(a, torch.Tensor)
                    else type(a)(0)
                    for a in args
                ),
                statics,
            )
            for kind, args, statics in flat_requests
        ]

        def compile_it():
            try:
                def dispatch():
                    tpe_device.multi_family_suggest_async(clones)()

                with tpe_device.background_compiles():
                    if self.device_recovery is not None:
                        self.device_recovery.run(dispatch)
                    else:
                        dispatch()
            except Exception:
                logger.exception("background warm-up dispatch failed")
                with self._bg_lock:
                    self._bg_failures[key] = (
                        self._bg_failures.get(key, 0) + 1
                    )
            else:
                with self._bg_lock:
                    self._bg_failures.pop(key, None)
            finally:
                with self._bg_lock:
                    self._bg_compiling.discard(key)

        self.call_soon(compile_it)

    # -- drain / shutdown ----------------------------------------------
    def drain(self, timeout=60.0):
        """Stop admitting, then wait for the queue and any in-flight
        batch to finish.  Already-admitted requests all complete (or
        fail loudly); none are dropped."""
        deadline = time.monotonic() + timeout
        with self._queue_cv:
            self._draining = True
            self._queue_cv.notify_all()
            while self._queue or self._tasks or self._busy:
                if time.monotonic() > deadline:
                    logger.warning(
                        "drain timed out with %d requests queued",
                        len(self._queue),
                    )
                    break
                self._queue_cv.wait(0.05)

    def close(self, timeout=60.0):
        self.drain(timeout=timeout)
        with self._queue_cv:
            self._stopped = True
            self._queue_cv.notify_all()
        self._thread.join(timeout=5.0)


class OptimizationService:
    """The multi-study suggest service: registry + scheduler + stats.

    This is the transport-independent core — :mod:`.server` puts an HTTP
    front on it, and tests drive it directly.  One instance per process;
    it owns the device (``device=None``: the CUDA card, raising without
    one; ``device="cpu"`` runs the plain versions of the kernels) via the
    shared :class:`~hyperopt_tpu_torch.resilience.device.DeviceRecovery`.
    Only its scheduler thread launches on the card.
    """

    def __init__(self, root=None, batch_window=DEFAULT_BATCH_WINDOW,
                 max_batch=DEFAULT_MAX_BATCH, max_queue=DEFAULT_MAX_QUEUE,
                 max_studies=DEFAULT_MAX_STUDIES,
                 suggest_timeout=DEFAULT_SUGGEST_TIMEOUT,
                 fault_stats=None, startup_fsck=True, tracer=None,
                 metrics_max_studies=DEFAULT_METRICS_MAX_STUDIES,
                 slo_enabled=True, slo_rules=None, flight_dir=None,
                 slo_tick=None, compile_cache_dir=None, warmup=True,
                 cold_fallback=False, compile_ledger_path=None,
                 compile_plane=True, mesh=None, replica_id=None,
                 advertise_url=None, replica_ttl=None,
                 mirror_src_root=None, control_enabled=False, control_window_s=30.0,
                 control_interval_s=0.0, control_seed=0, device=None):
        from ..device import resolve_device

        # the device first: without a card (and without device="cpu")
        # the service raises before it touches the root
        self.device = resolve_device(device)
        if replica_id is not None and not root:
            raise ValueError(
                "multi-replica mode (replica_id) requires a durable "
                "--root shared between the replicas"
            )
        if mirror_src_root is not None and replica_id is None:
            raise ValueError(
                "mirror_src_root (pull-based segment replication) "
                "requires multi-replica mode (replica_id)"
            )
        # multi-replica mode (--replica-id): N server processes share
        # this root, each claiming per-study ownership through fencing-
        # token heartbeat leases.  Built BEFORE the registry, so startup
        # recovery claims exactly the studies no live replica holds; its
        # threads start last.
        self.replica_set = None
        # lock-order: _adopt_lock is only ever held to look up/create a
        # per-study adopt lock, never across blocking work; the
        # PER-STUDY lock is what serializes a takeover, so adopting
        # study A (fsck + recover + a bounded pre-warm wait) cannot
        # stall a client whose request adopts study B
        self._adopt_lock = threading.Lock()
        self._adopt_locks = {}  # guarded-by: _adopt_lock  (study_id -> Lock)
        if replica_id is not None:
            from .replicas import (
                DEFAULT_REPLICA_LEASE_TTL,
                ReplicaSet,
                SegmentMirror,
            )

            self.replica_set = ReplicaSet(
                root, replica_id, url=advertise_url,
                ttl=(
                    DEFAULT_REPLICA_LEASE_TTL if replica_ttl is None
                    else float(replica_ttl)
                ),
            )
            # advertised in the directory record, as the reference's
            # record carries it; replicas may share the directory (its
            # kernel libraries land by os.replace)
            self.replica_set.compile_cache_dir = (
                compile_cache_dir if compile_plane else None
            )
            if mirror_src_root is not None:
                # no-shared-root replication: pull the peer's sealed
                # segments into OUR root so an eventual takeover serves
                # from a local, already-verified copy
                self.replica_set.attach_mirror(
                    SegmentMirror(
                        mirror_src_root, root, ttl=self.replica_set.ttl
                    )
                )
        self.stats = ServiceStats()
        # mesh execution mode (--mesh auto|DPxSP|off): the registry's
        # studies, the scheduler's label and the ledger's fingerprint
        # share this mesh.  Spec strings resolve over the local cards (the
        # CPU for device="cpu"); a one-card "auto" is the degenerate mesh,
        # the single-device dispatch
        from ..parallel.sharding import DeviceMesh, mesh_shape_str
        from ..parallel.sharding import resolve_mesh as resolve_device_mesh

        self.device_mesh = DeviceMesh.from_spec(
            mesh, devices=[self.device] if self.device.type == "cpu" else None)
        self.mesh = resolve_device_mesh(self.device_mesh)
        self.mesh_label = mesh_shape_str(self.mesh)
        # compile plane (hyperopt_tpu_torch.compile_ledger) — wired FIRST
        # so the kernel-library cache covers every build this process
        # pays (the warmup replay included) and the ledger recorder
        # sees the earliest dispatches.  compile_plane=False is the
        # full off switch (no recorder, no cache, no warmup) — the
        # overhead A/B's baseline arm, mirroring slo_enabled=False.
        from .. import compile_ledger as ledger_mod

        # stamp the serving topology into the compile-plane fingerprint
        # BEFORE any recording
        ledger_mod.set_topology(self.mesh if self.mesh is not None else "off",
                                device=self.device)
        self.compile_plane = bool(compile_plane)
        if not self.compile_plane:
            compile_cache_dir = None
            compile_ledger_path = None
            warmup = False
        if compile_cache_dir:
            ledger_mod.enable_persistent_cache(compile_cache_dir)
        self.compile_cache_dir = compile_cache_dir
        if compile_ledger_path is None and root and self.compile_plane:
            compile_ledger_path = os.path.join(
                os.path.abspath(root), ledger_mod.LEDGER_FILENAME
            )
        self.compile_ledger = ledger_mod.CompileLedger(compile_ledger_path)
        self.ledger_recorder = ledger_mod.CompileLedgerRecorder(
            self.compile_ledger
        )
        if self.compile_plane:
            self.ledger_recorder.install()
        # storage-plane telemetry, installed process-wide BEFORE the
        # startup fsck and registry recovery so their scans and journal
        # loads are on the record too (latest-installed wins when
        # several services share a process — tests).  slo_enabled=False
        # is the full guardrails-off switch (no store instrumentation,
        # no recorder retention, no ticker) — the overhead A/B's
        # baseline arm.
        from ..observability import StoreStats
        from ..parallel import file_trials as _file_trials

        self.slo_enabled = bool(slo_enabled)
        self.store_stats = StoreStats()
        if self.slo_enabled:
            _file_trials.set_store_stats(self.store_stats)
        # per-study /metrics cardinality bound (top-N by recency) +
        # running count of studies the bound dropped from the exposition
        self.metrics_max_studies = int(metrics_max_studies)
        self._truncated_lock = threading.Lock()
        self._studies_truncated_total = 0  # guarded-by: _truncated_lock
        self.timings = PhaseTimings()
        self.tracer = tracer if tracer is not None else tracing.DISABLED
        self.fault_stats = (
            fault_stats if fault_stats is not None else FaultStats()
        )
        from ..resilience.device import DeviceRecovery

        self.device_recovery = DeviceRecovery(stats=self.fault_stats)
        # device performance observability: a roofline profiler records
        # every dispatch (device time, achieved GB/s and TFLOP/s,
        # binding ceiling, memory watermarks) into device_stats —
        # exported on /metrics and attached to device.dispatch spans
        self.device_stats = DeviceStats()
        from ..profiling import DeviceProfiler

        self.device_profiler = DeviceProfiler(stats=self.device_stats)
        self.device_profiler.install()
        # compile attribution: a tpe_device compile observer turns every
        # compile event (first dispatch of a program key) into a counted
        # (trial-bucket, family) event AND a span on the trace that paid
        # for it (the scheduler binds the batch leader's trace around
        # the launch).  Installed whether or not tracing samples —
        # hyperopt_compile_events_total must count regardless.
        self._compile_observer = None
        self._install_compile_observer()
        # startup order is the recovery protocol: fsck the root FIRST
        # (quarantine torn docs, clear orphan leases/locks/tmp, trim a
        # torn journal tail), then let the registry rebuild each study
        # and replay its response journal against the repaired store
        self.fsck_report = None
        self._recovery_ok = True
        if root and startup_fsck:
            self._run_startup_fsck(root)
        self.registry = StudyRegistry(
            root, max_studies=max_studies, device=self.device,
            replica_set=self.replica_set, mesh=self.mesh,
        )
        if self.registry.recovery_info["failed_studies"]:
            self._recovery_ok = False
        # the gauge must reflect RECOVERED studies too, not just creates
        self.stats.set_n_studies(len(self.registry))
        # the live serving knobs: constructor args become the STATIC
        # config (the controller's revert target and the provably-inert
        # default); runtime changes arrive via POST /v1/config or the
        # closed-loop controller.  Provenance journals under the root.
        from ..control import (
            Controller,
            ControlStats,
            KnobSet,
            ObjectiveProbe,
        )

        control_dir = (
            os.path.join(os.path.abspath(root), "control")
            if root else None
        )
        self.knobs = KnobSet(
            static={
                "batch_window": float(batch_window),
                "max_batch": int(max_batch),
                "max_queue": int(max_queue),
                "max_speculation": 0,
            },
            journal_path=(
                os.path.join(control_dir, "knobs.jsonl")
                if control_dir else None
            ),
        )
        self.control_stats = ControlStats()
        self.scheduler = SuggestScheduler(
            stats=self.stats,
            device_recovery=self.device_recovery,
            cold_fallback=cold_fallback,
            mesh_label=self.mesh_label,
            knobs=self.knobs,
        )
        # readiness: the device-warm probe and then the ledger-driven
        # warmup (the compile grid of ledger records + a dry-prepare
        # probe per recovered study, replayed through the real dispatch
        # path) run once, as the scheduler thread's first task (the one
        # thread that touches the card), before any batch; /readyz reads
        # their outcome and gates on the warmup having FINISHED (errors
        # are reported, never allowed to wedge readiness)
        self._ready_lock = threading.Lock()
        self._device_state = "cold"  # guarded-by: _ready_lock
        self._started = threading.Event()
        self.warmup = ledger_mod.WarmupDriver(
            ledger=self.compile_ledger,
            studies=self.registry.studies(),
            device_recovery=self.device_recovery,
            enabled=bool(warmup),
            device=self.device,
            runner=lambda run: run(),  # inline, inside _startup
            mesh=self.mesh,
        )
        self.scheduler.call_soon(self._startup)
        # SLO guardrails + flight recorder: the component that WATCHES
        # the three telemetry pillars.  The recorder's rings are push
        # (every finished trace) + pull (evidence providers read only
        # at dump time); the engine's ticker thread takes the periodic
        # burn-rate snapshots and fires dumps on breach transitions.
        from .. import slo as slo_mod

        bundle_dir = flight_dir
        if bundle_dir is None and root:
            bundle_dir = os.path.join(os.path.abspath(root), "flightrec")
        self.flight_recorder = slo_mod.FlightRecorder(bundle_dir=bundle_dir)
        self.flight_recorder.set_provider(
            "dispatch", self.device_stats.recent_records
        )
        self.flight_recorder.set_provider(
            "store_op", self.store_stats.recent_ops
        )
        self.flight_recorder.set_provider("chaos", self._recent_chaos)
        self.flight_recorder.set_provider(
            "study_health", self._recorder_health_rows
        )
        self.flight_recorder.set_provider(
            "service", lambda: [{
                "stats": self.stats.summary(),
                "store": self.store_stats.summary(),
                "tracing": self.tracer.summary(),
            }]
        )
        if self.tracer is not tracing.DISABLED and self.slo_enabled:
            # retain every finished trace regardless of head-sampling;
            # a disabled tracer begins none, so off still means off
            self.tracer.set_recorder(self.flight_recorder)
        self.slo = slo_mod.SloEngine(
            service_stats=self.stats,
            device_stats=self.device_stats,
            store_stats=self.store_stats,
            replica_stats=(
                self.replica_set.stats
                if self.replica_set is not None else None
            ),
            rules=slo_rules,
            # guardrails off means no breach-triggered dumps either —
            # a /v1/alerts poll on a --no-slo server must stay passive
            recorder=self.flight_recorder if self.slo_enabled else None,
            fsck_unclean=not self._recovery_ok,
        )
        if self.slo_enabled:
            self.slo.start(
                slo_mod.DEFAULT_TICK_INTERVAL if slo_tick is None
                else slo_tick
            )
        # the self-tuning controller (--self-tune; default OFF — with
        # control_enabled=False nothing below is constructed and the
        # scheduler runs the static config forever)
        self.control_enabled = bool(control_enabled)
        self.controller = None
        if self.control_enabled:
            probe = ObjectiveProbe(
                service_stats=self.stats,
                device_stats=self.device_stats,
                fault_stats=self.fault_stats,
            )
            self.controller = Controller(
                knobs=self.knobs,
                probe=probe,
                rules=self.slo.rules,
                seed=control_seed,
                window_s=control_window_s,
                interval_s=control_interval_s,
                trials_dir=control_dir,
                recorder=(
                    self.flight_recorder if self.slo_enabled else None
                ),
                tracer=self.tracer,
                stats=self.control_stats,
                breach_fn=self._control_breach_view,
            )
            self.flight_recorder.set_provider(
                "control", self.controller.recent_decisions
            )
            self.controller.start()
        self.suggest_timeout = float(suggest_timeout)
        self.started_at = time.time()
        self._closed = False
        # replica plane goes live LAST: the heartbeat advertises this
        # replica and the failure detector starts adopting dead
        # replicas' studies only once the scheduler can serve them
        if self.replica_set is not None:
            self.replica_set.bind(
                self._adopt_study, self._relinquish_study
            ).start()

    def _install_compile_observer(self):
        from ..algos import tpe_device

        stats = self.stats

        def _on_compile_event(sig, shapes, launch_s):
            bucket, families = tpe_device.compile_key(sig, shapes)
            stats.record_compile(
                bucket, families,
                # warmup replays and containment warm-ups are real
                # events but not request-path cold: a request
                # overlapping one never waited on it
                background=tpe_device.in_background_compiles(),
            )
            tracing.add_event(
                "compile", bucket=int(bucket), families=families,
                launch_s=round(float(launch_s), 6),
            )

        tpe_device._trace_observers.append(_on_compile_event)
        self._compile_observer = _on_compile_event

    def _uninstall_compile_observer(self):
        if self._compile_observer is None:
            return
        from ..algos import tpe_device

        try:
            tpe_device._trace_observers.remove(self._compile_observer)
        except ValueError:
            pass
        self._compile_observer = None

    @contextlib.contextmanager
    def _traced_request(self, name, **attrs):
        """Root-span plumbing for one service request: adopt the ambient
        trace (the HTTP layer began it from the X-Hyperopt-Trace header)
        or begin one here (direct in-process callers), open the root
        span, and — only when begun here — finish/write the trace."""
        trace = tracing.current_trace()
        owned = None
        if trace is None and self.tracer.enabled:
            owned = trace = self.tracer.begin()
        try:
            with tracing.use_trace(trace):
                with tracing.span(name, **attrs) as root:
                    yield trace, root
        finally:
            if owned is not None:
                self.tracer.finish(owned)

    def _run_startup_fsck(self, root):
        from ..resilience.fsck import fsck_path

        try:
            report = fsck_path(root, repair=True)
            self.fsck_report = report.summary()
            if not report.clean:
                self._recovery_ok = False
                logger.error(
                    "startup fsck left %d unrepaired finding(s)",
                    report.n_unrepaired,
                )
            elif report.findings:
                logger.warning(
                    "startup fsck repaired %d finding(s)",
                    len(report.findings),
                )
        except Exception:
            logger.exception("startup fsck failed")
            self._recovery_ok = False
            self.fsck_report = {"error": "fsck crashed; see server log"}

    def _warm_device(self) -> str:
        """One-time device-warm probe ('warm' | 'error'): a zero tensor on
        the service's device and a synchronize, under the recovery.  The
        reference's 'fallback' state (suggests pinned to the CPU) is
        unreachable: the port's recovery has no CPU fallback."""
        import torch

        def probe():
            torch.zeros((), device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        try:
            self.device_recovery.run(probe)
        except Exception:
            logger.exception("device warm probe failed")
            return "error"
        return "warm"

    def _startup(self):
        """The scheduler thread's first task: :meth:`_warm_device`, then
        the warmup replay."""
        try:
            state = self._warm_device()
            with self._ready_lock:
                self._device_state = state
            self.warmup.start()
        finally:
            self._started.set()

    # -- replica plane ---------------------------------------------------
    def _adopt_study(self, study_id, reason) -> bool:
        """Warm takeover of one study: **claim → fsck-clean → recover →
        ledger pre-warm → serve**, in that order.

        The fence bump at claim time makes the old owner's in-flight
        writes stale (dropped at their own verify); the fsck repairs
        whatever its crash tore; the journal replay + seed cursor make
        the trajectory continue byte-identically; and a scoped
        :class:`~hyperopt_tpu_torch.compile_ledger.WarmupDriver` replays
        the shared compile ledger + a dry prepare of the study so its
        FIRST post-failover suggest dispatches an already-warm program.
        The pre-warm is a task on the scheduler thread (the one thread
        that launches on the card); this thread — the reaper's or a
        request handler's, never the scheduler's — waits for it under
        :data:`TAKEOVER_PREWARM_WAIT_S`.  Returns True when the study is
        serving here afterwards."""
        rs = self.replica_set
        if rs is None or self._closed:
            return False
        if threading.current_thread() is self.scheduler._thread:
            # the pre-warm would queue behind this very task and the
            # wait below could only time out
            raise RuntimeError(
                "a takeover cannot run on the scheduler thread"
            )
        with self._adopt_lock:
            study_lock = self._adopt_locks.setdefault(
                str(study_id), threading.Lock()
            )
        with study_lock:
            try:
                self.registry.get(study_id)
                return True  # already serving (raced adoption)
            except StudyNotFound:
                pass
            if not rs.adoption_should_attempt(study_id):
                # a recent takeover of this study failed; don't re-run
                # fsck + recovery + a fence bump for every request that
                # misses the registry — wait out the backoff
                return False
            # the previous owner, for the takeover record (read before
            # the claim overwrites it)
            prior = rs.leases.read(study_id)
            t0 = time.monotonic()
            if rs.mirror is not None:
                # no-shared-root mode: take a final fence-checked pull
                # so the local copy includes every segment the dying
                # owner sealed (the periodic reaper-tick pulls make
                # this a near-noop)
                try:
                    rs.mirror.pull_study(study_id)
                except Exception:
                    logger.exception(
                        "final pre-takeover pull failed for %r; "
                        "serving from the last mirrored cut", study_id,
                    )
            handle = rs.try_claim(study_id)
            if handle is None:
                return False  # a live owner beat us to it
            record = {
                "study_id": str(study_id),
                "reason": str(reason),
                "from_owner": (prior or {}).get("owner"),
                "fence": handle.fence,
                "fsck_clean": None,
                "prewarm": None,
                "ok": False,
                "duration_s": None,
                # seconds of each stage, at the takeover.* spans'
                # boundaries (readable with tracing off)
                "split_s": {},
            }
            split = record["split_s"]
            with self._traced_request(
                "replica.takeover", study=str(study_id),
                failover=True, reason=str(reason),
            ) as (_trace, root):
                try:
                    from ..resilience.fsck import fsck_queue

                    t = time.monotonic()
                    with tracing.span("takeover.fsck"):
                        fsck = fsck_queue(
                            self.registry._study_dir(study_id),
                            repair=True,
                        )
                    split["fsck"] = round(time.monotonic() - t, 4)
                    record["fsck_clean"] = fsck.clean
                    t = time.monotonic()
                    with tracing.span("takeover.recover"):
                        study = self.registry.load_study(study_id)
                    split["recover"] = round(time.monotonic() - t, 4)
                    # pre-warm BEFORE cutover: ledger records + a dry
                    # prepare of this study, replayed through the real
                    # dispatch path on the scheduler thread (compile
                    # events tagged background — never request-path cold)
                    if self.compile_plane:
                        from .. import compile_ledger as ledger_mod

                        t = time.monotonic()
                        with tracing.span("takeover.prewarm"):
                            # the ledger is shared: fold in what the
                            # dead owner recorded since we loaded it
                            self.compile_ledger.refresh()
                            warm = ledger_mod.WarmupDriver(
                                ledger=self.compile_ledger,
                                studies=[study],
                                device_recovery=self.device_recovery,
                                enabled=True,
                                device=self.device,
                                runner=self.scheduler.call_soon,
                                mesh=self.mesh,
                            )
                            warm.start()
                            if not warm.wait(TAKEOVER_PREWARM_WAIT_S):
                                # serve anyway (a cold first suggest
                                # beats an unserved study); the items
                                # not yet run are skipped
                                warm.stop(timeout=0.0)
                                logger.warning(
                                    "takeover pre-warm of %r still "
                                    "queued after %.0fs; serving",
                                    study_id, TAKEOVER_PREWARM_WAIT_S,
                                )
                        split["prewarm"] = round(time.monotonic() - t, 4)
                        record["prewarm"] = warm.counts()
                    study.ownership = handle
                    self.registry.install(study)
                except Exception as e:
                    logger.exception(
                        "takeover of study %r failed", study_id
                    )
                    record["error"] = repr(e)
                    # release so another (healthier) replica may adopt
                    rs.leases.release(
                        study_id, rs.replica_id, handle.fence
                    )
                    rs.drop(study_id)
                    record["duration_s"] = round(
                        time.monotonic() - t0, 4
                    )
                    rs.stats.record_takeover(record)
                    rs.adoption_result(study_id, False)
                    return False
                record["ok"] = True
                record["duration_s"] = round(time.monotonic() - t0, 4)
                root.set_attr("fence", handle.fence)
                root.set_attr("duration_s", record["duration_s"])
        rs.stats.record_takeover(record)
        rs.adoption_result(study_id, True)
        self.stats.set_n_studies(len(self.registry))
        logger.info(
            "adopted study %r from %r in %.3fs (%s; fsck_clean=%s)",
            study_id, record["from_owner"], record["duration_s"],
            reason, record["fsck_clean"],
        )
        return True

    def _relinquish_study(self, study_id):
        """Evict a study whose lease was reclaimed (we were presumed
        dead but are alive): stop serving it immediately.  On-disk
        state is untouched — the new owner already recovered it, and
        any of our queued writes drop at their own fence verify."""
        if self.registry.remove(study_id):
            logger.warning(
                "relinquished study %r (lease reclaimed)", study_id
            )
            self.stats.set_n_studies(len(self.registry))
        if self.replica_set is not None:
            self.replica_set.drop(study_id)

    def _not_owner(self, study_id) -> NotOwner:
        owner, url = self.replica_set.owner_hint(study_id)
        return NotOwner(study_id, owner_id=owner, owner_url=url)

    def _study_for_request(self, study_id) -> Study:
        """Resolve a study for a serving request, enforcing replica
        ownership: a locally-served study whose ownership lapsed is
        relinquished and redirected; a study existing on disk but owned
        elsewhere raises :class:`NotOwner` (307 with the owner hint);
        an unowned on-disk study is adopted on demand (the client beat
        the failure detector to it)."""
        try:
            study = self.registry.get(study_id)
        except StudyNotFound:
            if self.replica_set is None or self.registry.root is None:
                raise
            study = None
        if study is not None:
            if self.replica_set is not None:
                handle = study.ownership
                if handle is None or handle.lost:
                    self._relinquish_study(study_id)
                    raise self._not_owner(study_id)
            return study
        # not serving locally: known on disk?
        qdir = self.registry._study_dir(study_id)
        if not os.path.isdir(qdir):
            raise StudyNotFound(f"no study {study_id!r}")
        owner, url = self.replica_set.owner_hint(study_id)
        if owner is not None:
            raise NotOwner(study_id, owner_id=owner, owner_url=url)
        # unowned (owner dead or released): adopt on demand
        if self._adopt_study(study_id, "on_demand"):
            return self.registry.get(study_id)
        raise BackpressureError(
            f"study {study_id!r} is migrating; retry shortly"
        )

    def replica_status(self) -> dict:
        """The ``GET /v1/replicas`` document: this replica's identity,
        held studies, takeover log, and the directory snapshot."""
        self.stats.record_request("replicas")
        if self.replica_set is None:
            return {"replica_mode": False}
        out = self.replica_set.status()
        out["replica_mode"] = True
        return out

    # -- API -----------------------------------------------------------
    def create_study(self, study_id, space, seed=0, algo="tpe",
                     algo_params=None, exist_ok=False,
                     idempotency_key=None, early_stop=None) -> dict:
        with self._traced_request(
            "service.create_study", study=str(study_id)
        ) as (_trace, root):
            with self.timings.phase("create_study"):
                if self.replica_set is not None:
                    try:
                        self.registry.get(study_id)
                    except StudyNotFound:
                        qdir = self.registry._study_dir(study_id)
                        if os.path.isdir(qdir):
                            # the study exists on disk under another
                            # replica's (or a dead replica's) lease:
                            # adopt or redirect BEFORE the exist_ok
                            # logic — a blind re-create would clobber
                            # the recovered trajectory
                            self._study_for_request(study_id)
                try:
                    study = self.registry.create(
                        study_id, space, seed=seed, algo_name=algo,
                        algo_params=algo_params, exist_ok=exist_ok,
                        early_stop=early_stop,
                    )
                except BackpressureError:
                    # registry-full 429s must show on the same rejection
                    # counter operators watch for suggest over-admission
                    self.stats.record_rejection("create_study")
                    raise
                except StudyExists:
                    if idempotency_key is None:
                        raise
                    # a RETRIED create (same idempotency key) replays the
                    # journaled response byte-for-byte.  A keyed create
                    # hitting an existing study whose journal misses the
                    # key can still be the retry of a create that crashed
                    # BETWEEN persisting the config and journaling the
                    # response — a config match proves it is the same
                    # logical create, so it attaches (a keyed create is
                    # "create exactly this study": idempotent by
                    # content).  Only a config MISMATCH keeps the 409.
                    study = self.registry.get(study_id)
                    with study.lock:
                        replay = study.journal.payload(
                            idempotency_key, kind="create_study"
                        )
                    if replay is not None:
                        root.set_attr("replay", True)
                        self.stats.record_replay("create_study")
                        self.stats.record_request(
                            "create_study", replay=True
                        )
                        return replay
                    if not study.config_matches(
                        space, seed, algo, algo_params,
                        early_stop=early_stop,
                    ):
                        raise
            with study.lock:
                payload = study.status()
                if idempotency_key is not None:
                    study.journal.record(
                        idempotency_key, "create_study",
                        canonical_json(payload),
                    )
        self.stats.record_request("create_study")
        self.stats.set_n_studies(len(self.registry))
        return payload

    def suggest(self, study_id, n=1, timeout=None,
                idempotency_key=None) -> list:
        """Block until the batched scheduler serves this request; returns
        ``[{"tid": int, "vals": {label: value}}, ...]``.

        With an ``idempotency_key``, a replayed request returns the
        journaled response without consuming a seed or inserting a
        second trial, and a retry racing its own original attaches to
        the in-flight request instead of submitting a duplicate."""
        if n < 1:
            raise ValueError("n must be >= 1")
        t0 = time.perf_counter()
        # first-touch attribution snapshot: a request is "cold" when an
        # compile event ran anywhere in its lifetime — its own dispatch
        # (pending.compiled) OR a compile it sat in queue behind.  Only
        # requests untouched by compilation count as steady state.
        compiles_before = self.stats.n_compile_events
        study = self._study_for_request(study_id)
        if study.stopped is not None:
            # SH5xx-stopped: terminal for NEW work (reports for
            # already-issued trials still land); resume_study reverses
            raise StudyStopped(
                f"study {study_id!r} was stopped by its early-stop "
                f"hook ({study.stopped.get('rule')}); resume it to "
                f"continue"
            )
        with self._traced_request(
            "service.suggest", study=str(study_id), n=int(n)
        ) as (trace, root):
            if idempotency_key is not None:
                with study.lock:
                    replay = study.journal.payload(
                        idempotency_key, kind="suggest"
                    )
                    if replay is None:
                        pending = study._inflight.get(idempotency_key)
                        if (
                            pending is not None
                            and pending.cancelled
                            and pending.ids is None
                        ):
                            # its waiter timed out and the scheduler will
                            # abandon it without consuming anything —
                            # attaching would inherit that spurious failure.
                            # Replace it; one with ids drawn still completes
                            # and journals, so THAT one we do attach to.
                            pending = None
                        if pending is None:
                            pending = self.scheduler.submit(
                                study, n, idempotency_key=idempotency_key,
                                trace=trace, parent_span=root,
                            )
                            study._inflight[idempotency_key] = pending
                if replay is not None:
                    # a journal hit is NOT a served suggest: tag it in
                    # the trace and keep it out of the latency
                    # histogram — a burst of retries must not fake a
                    # fast p50 or mask a slow p99
                    root.set_attr("replay", True)
                    self.stats.record_replay("suggest")
                    self.stats.record_request(
                        "suggest", study=study_id, replay=True
                    )
                    return replay
            else:
                pending = self.scheduler.submit(
                    study, n, trace=trace, parent_span=root
                )
            if trace is not None and pending.trace is trace:
                # admission: root entry → enqueue (journal lookup +
                # submit, possibly blocked on a contended study lock).
                # Skipped when this is a retry attached to an EARLIER
                # request's pending — its intervals belong to that trace.
                trace.record_span(
                    "suggest.admit", root.t0, pending.enqueued_at,
                    parent=root,
                )
            try:
                pending.wait(
                    self.suggest_timeout if timeout is None else timeout
                )
            except OwnershipLost:
                # the commit-time fence verify dropped this write: the
                # study was reclaimed; redirect to the new owner
                self._relinquish_study(study_id)
                raise self._not_owner(study_id)
            if trace is not None:
                # the search-health verdict at serve time, on the same
                # span operators already read latency/roofline from
                h = study.search_stats.health()
                root.set_attr("health", h["state"])
                root.set_attr("health_rule", h["rule"])
                # ... and the fleet-level SLO state (a cheap cached
                # read): a trace written during an incident says so
                breaching = self.slo.current_breaching()
                if breaching:
                    root.set_attr("slo_breach", breaching)
            if (
                trace is not None
                and pending.trace is trace
                and pending.completed_at is not None
            ):
                # hand-back: scheduler completion → this thread resumed
                trace.record_span(
                    "suggest.wake", pending.completed_at,
                    time.monotonic(), parent=root,
                )
        dt = time.perf_counter() - t0
        self.stats.record_request(
            "suggest", seconds=dt, study=study_id,
            cold=(
                pending.compiled
                or self.stats.n_compile_events > compiles_before
            ),
        )
        self.timings.record("suggest", dt)
        return pending.payload

    def report(self, study_id, tid, loss=None, status=STATUS_OK,
               result=None, idempotency_key=None) -> dict:
        study = self._study_for_request(study_id)
        with self._traced_request(
            "service.report", study=str(study_id), tid=int(tid)
        ) as (_trace, root):
            with self.timings.phase("report"):
                try:
                    with study.lock:
                        if idempotency_key is not None:
                            replay = study.journal.payload(
                                idempotency_key, kind="report"
                            )
                            if replay is not None:
                                root.set_attr("replay", True)
                                self.stats.record_replay("report")
                                self.stats.record_request(
                                    "report", replay=True
                                )
                                return replay
                        doc = study.report(
                            tid, loss=loss, status=status, result=result,
                            idempotency_key=idempotency_key,
                        )
                        # SH5xx actuation (per-study opt-in): evaluate
                        # the stop criterion on every landed result —
                        # the server-side call the hook never had
                        stop_record = study.check_early_stop()
                except OwnershipLost:
                    # stale-fenced terminal write, dropped before any
                    # journal/store mutation: relinquish + redirect
                    self._relinquish_study(study_id)
                    raise self._not_owner(study_id)
                if stop_record is not None:
                    root.set_attr("early_stopped", stop_record["rule"])
                    self._on_study_stopped(study, stop_record)
        self.stats.record_request("report")
        return {"tid": int(doc["tid"]), "state": doc["state"]}

    def _on_study_stopped(self, study, record):
        """Bookkeeping for one SH5xx admission reclaim: count it,
        flight-record it, and log — the slot itself is already free
        (the registry's capacity check skips stopped studies)."""
        self.control_stats.record_reclaimed()
        logger.info(
            "early-stop actuation: study %r stopped (%s); admission "
            "slot reclaimed", study.study_id, record["rule"],
        )
        if self.slo_enabled:
            try:
                self.flight_recorder.dump("control:study_stopped", {
                    "study": study.study_id, "stop": record,
                })
            except Exception:  # pragma: no cover - defensive
                logger.exception("stop-actuation flight dump failed")

    def resume_study(self, study_id) -> dict:
        """Reverse an SH5xx stop: re-admit the study (subject to the
        same capacity check a create pays) and reset its stop
        criterion.  The ``POST /v1/studies/<id>/resume`` handler."""
        study = self._study_for_request(study_id)
        with study.lock:
            if study.stopped is not None:
                if self.registry.n_active() >= self.registry.max_studies:
                    self.stats.record_rejection("resume_study")
                    raise BackpressureError(
                        f"study registry full "
                        f"({self.registry.max_studies}); cannot resume"
                    )
                study.resume()
                self.control_stats.record_resumed()
            out = study.status()
        self.stats.record_request("resume_study")
        return out

    def study_status(self, study_id) -> dict:
        study = self._study_for_request(study_id)
        with study.lock:
            out = study.status()
        self.stats.record_request("study_status")
        return out

    def list_studies(self) -> list:
        return self.registry.list()

    def service_status(self) -> dict:
        from ..observability import build_info
        from ..ops import fused_kernel, pair_kernel

        return {
            "studies": len(self.registry),
            "uptime_s": round(time.time() - self.started_at, 3),
            "started_at": round(self.started_at, 3),
            "version": build_info(),
            "draining": self._closed,
            "stats": self.stats.summary(),
            "faults": self.fault_stats.summary(),
            "mesh": {
                "label": self.mesh_label,
                "topology": (self.device_mesh.topology()
                             if self.device_mesh is not None else None),
            },
            "device": self.device_stats.summary(),
            # this process's launches of each hand-written kernel (the
            # wrappers' own counts: a CPU-device service reads 0)
            "kernel_launches": {
                fn.__name__: fn.launches for fn in (
                    pair_kernel.pair_score_batched,
                    fused_kernel.fused_suggest,
                    pair_kernel.pair_score_single,
                    pair_kernel.pair_lse_partials,
                )
            },
            "store": self.store_stats.summary(),
            "slo_breaching": self.slo.current_breaching(),
            "recovery": dict(self.registry.recovery_info),
            "fsck": self.fsck_report,
            "tracing": self.tracer.summary(),
            "flight_recorder": self.flight_recorder.summary(),
            "warmup": self.warmup.progress_brief(),
            "compile_ledger": self.compile_ledger.summary(),
            "control": {
                "enabled": self.control_enabled,
                "knobs": self.knobs.values(),
                "is_static": self.knobs.is_static,
                "stats": self.control_stats.summary(),
                "controller": (
                    self.controller.status()
                    if self.controller is not None else None
                ),
            },
            "replica": (
                {
                    "replica_id": self.replica_set.replica_id,
                    "url": self.replica_set.url,
                    "owned_studies": self.replica_set.owned_studies(),
                    "stats": self.replica_set.stats.summary(),
                }
                if self.replica_set is not None else None
            ),
        }

    def alerts(self) -> dict:
        """The ``/v1/alerts`` document: the full SL6xx rule table with
        multi-window burn rates, the breaching subset, and the flight
        recorder's state."""
        self.stats.record_request("alerts")
        return self.slo.alerts_payload()

    # -- control plane ---------------------------------------------------
    def _control_breach_view(self) -> dict:
        """The controller's SL6xx safety view: cumulative breach
        transitions (a delta across an observation window means a
        breach FIRED during it → revert) plus the currently-breaching
        rule ids (non-empty → hold, don't tune into an incident)."""
        rows = self.slo.evaluate(force=True)
        return {
            "transitions": sum(
                r.get("breaches_total", 0) for r in rows
            ),
            "breaching": [r["rule"] for r in rows if not r["ok"]],
        }

    def get_config(self) -> dict:
        """The ``GET /v1/config`` document: knob specs + live/static
        values, recent provenance, and the controller's state."""
        self.stats.record_request("config")
        out = self.knobs.describe()
        out["provenance"] = self.knobs.provenance()[-32:]
        out["control_enabled"] = self.control_enabled
        out["controller"] = (
            self.controller.status()
            if self.controller is not None else None
        )
        out["stats"] = self.control_stats.control_metrics()
        return out

    def set_config(self, changes: dict, source="api") -> dict:
        """Apply validated knob changes (the ``POST /v1/config``
        body's ``knobs`` dict) — all-or-nothing, provenance-journaled.
        ``{"revert": true}`` restores the static config instead."""
        if not isinstance(changes, dict):
            raise ValueError("body must be a JSON object")
        knobs = changes.get("knobs")
        if changes.get("revert"):
            values = self.knobs.revert(source=str(source))
        elif isinstance(knobs, dict) and knobs:
            values = self.knobs.set_many(knobs, source=str(source))
        else:
            raise ValueError(
                "body must carry a non-empty 'knobs' object or "
                "'revert': true"
            )
        self.stats.record_request("config")
        return {"values": values, "is_static": self.knobs.is_static}

    def _recent_chaos(self) -> list:
        monkey = _active_chaos()
        return monkey.recent_injections() if monkey is not None else []

    def _recorder_health_rows(self) -> list:
        """Bounded per-study health rows for the flight recorder (same
        top-N-by-recency bound as /metrics, but without advancing the
        truncation counter — a dump is not an exposition)."""
        studies = self.registry.studies()
        studies.sort(
            key=lambda s: s.search_stats.last_activity, reverse=True
        )
        return [
            s.search_stats.metrics_row()
            for s in studies[: self.metrics_max_studies]
        ]

    def readiness(self) -> dict:
        """The /readyz document: ready iff the registry recovered every
        study, the startup fsck left the store clean, the device
        answered its warm probe ("warm"; "cold" while the probe waits
        for the scheduler thread, "error" when it failed — the
        reference's "fallback" cannot occur, the port's recovery has no
        CPU fallback), and the compile warmup finished (finished, not
        flawless — an errored item is reported in the warmup block, not
        allowed to wedge readiness; see :class:`~hyperopt_tpu_torch
        .compile_ledger.WarmupDriver`).  The 503 body carries warmup
        progress (``warmed/total`` + ETA) so a blocked ``wait_ready``
        log is actionable.  Never touches the card itself: the probe and
        the warmup run on the scheduler thread (first, before any
        batch), and a call waits for them as the reference's synchronous
        probe does, up to ``STARTUP_WAIT_S``; past it the body reports
        the device "cold" or the warmup's progress."""
        self._started.wait(STARTUP_WAIT_S)
        with self._ready_lock:
            device_state = self._device_state
        warmup = self.warmup.progress_brief()
        ready = (
            self._recovery_ok
            and device_state == "warm"
            and warmup["finished"]
            and not self._closed
        )
        if ready:
            # latch for SL607: cold suggests from here on are request-
            # path compiles the warmup should have pre-paid
            self.stats.mark_ready()
        return {
            "ready": ready,
            "draining": self._closed,
            "recovery_ok": self._recovery_ok,
            "device": device_state,
            "warmup": warmup,
            "studies": len(self.registry),
            "recovery": dict(self.registry.recovery_info),
            "fsck": self.fsck_report,
        }

    def warmup_status(self) -> dict:
        """The ``GET /v1/warmup`` document: per-bucket warmup state
        (pending/compiling/warm/skipped/error), ETA from ledger
        durations, and the ledger summary."""
        self.stats.record_request("warmup")
        return self.warmup.status()

    def _study_health_rows(self):
        """The bounded per-study gauge rows: top-N studies by last
        search activity.  Returns ``(rows, truncated_total)`` and
        advances the truncation counter by however many studies this
        render dropped."""
        studies = self.registry.studies()
        studies.sort(
            key=lambda s: s.search_stats.last_activity, reverse=True
        )
        cut = studies[: self.metrics_max_studies]
        dropped = len(studies) - len(cut)
        with self._truncated_lock:
            self._studies_truncated_total += dropped
            total = self._studies_truncated_total
        return [s.search_stats.metrics_row() for s in cut], total

    def metrics_text(self) -> str:
        from .. import compile_ledger as ledger_mod
        from ..observability import build_info, render_prometheus

        rows, truncated = self._study_health_rows()
        # compile-plane gauges: warmup progress + persistent-cache
        # effectiveness + ledger size (flat gauges — the per-bucket
        # detail lives at GET /v1/warmup)
        wu = self.warmup.counts()
        extra = {
            "service_uptime_seconds": time.time() - self.started_at,
            "compile_warmup_total": sum(wu.values()),
            "compile_warmup_warm": wu[ledger_mod.STATE_WARM],
            "compile_warmup_pending": (
                wu[ledger_mod.STATE_PENDING]
                + wu[ledger_mod.STATE_COMPILING]
            ),
            "compile_warmup_skipped": wu[ledger_mod.STATE_SKIPPED],
            "compile_warmup_errors": wu[ledger_mod.STATE_ERROR],
            "compile_warmup_finished": 1 if self.warmup.finished else 0,
            "compile_ledger_entries": len(self.compile_ledger),
            "compile_cache_hits_total": (
                ledger_mod.cache_event_counts()["hits"]
            ),
            "compile_cache_misses_total": (
                ledger_mod.cache_event_counts()["misses"]
            ),
            "service_cold_fallbacks_total": self.stats.n_cold_fallbacks,
        }
        eta = self.warmup.progress_brief()["eta_s"]
        if eta is not None:
            extra["compile_warmup_eta_seconds"] = eta
        if self.replica_set is not None:
            # replica-plane gauges: fleet dashboards sum/compare these
            # across replicas (identity lives in the scrape target)
            rstats = self.replica_set.stats
            extra.update({
                "replica_studies_owned": len(
                    self.replica_set.owned_studies()
                ),
                "replica_directory_size": len(
                    self.replica_set.directory.replicas()
                ),
                "replica_takeovers_total": rstats.get("takeover"),
                "replica_takeovers_slow_total": rstats.get(
                    "takeover_slow"
                ),
                "replica_takeovers_failed_total": rstats.get(
                    "takeover_failed"
                ),
                "replica_stale_writes_dropped_total": rstats.get(
                    "stale_write_dropped"
                ),
                "replica_heartbeats_total": rstats.get("heartbeat"),
                "replica_lease_renew_lost_total": rstats.get(
                    "renew_lost"
                ),
            })
        return render_prometheus(
            timings=self.timings,
            faults=self.fault_stats,
            service=self.stats,
            device=self.device_stats,
            study_health={"rows": rows, "truncated_total": truncated},
            store=self.store_stats,
            slo=self.slo.metrics_rows() if self.slo_enabled else None,
            control=self.control_stats.control_metrics(),
            build=build_info(),
            extra=extra,
        )

    # -- lifecycle -----------------------------------------------------
    def drain(self, timeout=60.0):
        """Graceful shutdown step 1: reject new suggests, finish the
        admitted ones.  Study state is already on disk (write-through),
        so after drain a restart recovers everything."""
        self._closed = True
        self.scheduler.drain(timeout=timeout)

    def close(self, timeout=60.0):
        self._closed = True
        if self.controller is not None:
            # stop the tuner before the scheduler it tunes: a mid-close
            # knob write against a draining queue is pure noise
            self.controller.close()
        self.warmup.stop()
        self.scheduler.close(timeout=timeout)
        if self.replica_set is not None:
            # graceful handover: release every held lease (fence
            # preserved) so a successor claims instantly instead of
            # waiting out the TTL, and withdraw the directory record
            self.replica_set.close(release=True)
        self.slo.close()
        self.warmup.stop()
        self._uninstall_compile_observer()
        self.ledger_recorder.uninstall()
        self.device_profiler.uninstall()
        if self.tracer is not tracing.DISABLED:
            self.tracer.set_recorder(None)
        from ..parallel import file_trials as _file_trials

        if _file_trials.store_stats() is self.store_stats:
            _file_trials.set_store_stats(None)
