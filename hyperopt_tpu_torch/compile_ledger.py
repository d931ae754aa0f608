"""Compile-plane observability: a persistent compile ledger and the
warmup driver that replays it before ``/readyz`` goes green.

Reference parity: ``hyperopt_tpu/compile_ledger.py``, retargeted at the
port.  The port traces nothing, so its counterpart of an XLA compile is
a *compile event*: the first dispatch in the process of a program key
(``tpe_device.program_key``: the static signature of the request list,
in the canonical group order of a batched dispatch, and its arguments'
shapes and dtypes).  That dispatch pays for the caching allocator
growing to the new shapes, the lazy load of the library kernels it
reaches and, at a hand-written kernel's first use, the ``nvcc`` build of
its library (``ops/kernel_build.py``).  The persistent cache is the
kernel-library directory (``build/kernels/`` by default; the server's
``--compile-cache-dir`` moves it), and its hits and misses are library
loads that found their library built, or built it.

- :class:`CompileLedger` — a crash-consistent JSONL ledger
  (``compile_ledger.jsonl``; ``O_APPEND`` single-write records,
  ``\\n<crc32 hex> <json>``) of every compile event, keyed by
  ``tpe_device.compile_key(sig, shapes)`` with its duration, trial-count
  bucket, family composition, a version fingerprint, whether the kernel
  library came from the cache (``cache_hit``), and the full ``(sig,
  shapes)`` pair: zero-filled arguments at the recorded shapes rebuild
  the program key, which is what makes ledger-driven warmup possible
  without study state.  The reference's file format and states.
- :class:`CompileLedgerRecorder` — the ``tpe_device._trace_observers``
  entry that feeds the ledger.
- :class:`WarmupDriver` — at service startup, BEFORE ``/readyz`` goes
  green, replays the ledger's fingerprint-matching records plus a dry
  ``suggest_prepare`` probe per recovered study through the real
  dispatch path (``tpe_device.multi_family_suggest_async``), with
  per-item state (pending/compiling/warm/skipped/error) and an ETA from
  ledger durations — the ``GET /v1/warmup`` document.  The service runs
  it on its scheduler thread, the one thread that launches on the card.
- :func:`enable_persistent_cache` — points the kernel-library build
  directory at ``cache_dir``.

No counterpart (ROADMAP.md, "no counterpart, by design"): the reference's
``jax.monitoring`` listener (``install_cache_listener``; the
kernel-library loads count themselves, ``kernel_build.cache_events``) and
its persistent XLA program cache settings.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import logging
import os
import threading
import time

from . import journal_io, tracing

logger = logging.getLogger(__name__)

LEDGER_FILENAME = "compile_ledger.jsonl"
# compact the ledger file once appends exceed this multiple of the live
# (distinct-key) entry count — the journal's in-place rewrite discipline
COMPACT_APPEND_FACTOR = 8


# ---------------------------------------------------------------------
# fingerprint + persistent-cache wiring
# ---------------------------------------------------------------------


def _kernel_sources_hash() -> str:
    """A short hash of the hand-written kernels' sources and build flags:
    a ledger written against other kernels must not mark programs warm."""
    from .ops import kernel_build

    h = hashlib.sha256(" ".join(kernel_build.NVCC_FLAGS).encode())
    for path in sorted(kernel_build.CSRC.glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def fingerprint() -> dict:
    """The ledger's validity scope: package, torch and kernel-source
    versions and the device topology this process serves on.  A record
    written under a different fingerprint never marks a program warm."""
    import torch

    try:
        from . import __version__ as version
    except ImportError:  # pragma: no cover - defensive
        version = "unknown"
    return {
        "version": str(version),
        "torch": str(torch.__version__),
        "kernels": _kernel_sources_hash(),
        "backend": current_topology()["backend"],
        "topology": current_topology(),
    }


# The serving topology this process dispatches under: the device type,
# the device count and the mesh shape ("off": the single-device dispatch).
# Set once by the service at startup.
_topology_lock = threading.Lock()
_topology = {"backend": "cuda", "mesh": "off", "device_count": None}  # guarded-by: _topology_lock


def set_topology(mesh=None, device=None) -> dict:
    """Register the serving mesh and device in the process fingerprint;
    returns the resulting topology dict.  ``mesh``: a ``DeviceMesh`` (its
    :meth:`~hyperopt_tpu_torch.parallel.sharding.DeviceMesh.topology`:
    backend, slot count, shape), or a label (None/``"off"``: the single
    device, whose count is the local card count)."""
    import torch

    from .parallel.sharding import DeviceMesh

    if isinstance(mesh, DeviceMesh):
        topo = mesh.topology()
    else:
        topo = {"backend": torch.device("cuda" if device is None else device).type,
                "mesh": "off" if mesh is None else str(mesh), "device_count": None}
    with _topology_lock:
        _topology.update(topo)
    return current_topology()


def current_topology() -> dict:
    import torch

    with _topology_lock:
        topo = dict(_topology)
    n = topo["device_count"]
    if n is None:
        # device_count creates no CUDA context
        n = torch.cuda.device_count() if topo["backend"] == "cuda" else 1
    return {"backend": topo["backend"], "device_count": int(n), "mesh": topo["mesh"]}


def cache_hit_count() -> int:
    from .ops import kernel_build

    return kernel_build.cache_events()["hits"]


def cache_event_counts() -> dict:
    from .ops import kernel_build

    return kernel_build.cache_events()


def enable_persistent_cache(cache_dir) -> bool:
    """Build and load the kernel libraries under ``cache_dir`` (created if
    missing), so a restart on it loads what an earlier process built.
    Returns False (and changes nothing) on failure."""
    from .ops import kernel_build

    try:
        import os

        os.makedirs(cache_dir, exist_ok=True)
        kernel_build.set_build_dir(cache_dir)
    except Exception:
        logger.exception(
            "could not use %r as the kernel-library cache", cache_dir
        )
        return False
    logger.info("kernel-library cache: %s", cache_dir)
    return True


# ---------------------------------------------------------------------
# (sig, shapes) codec — the replayable program identity
# ---------------------------------------------------------------------


MESH_TOKEN = "__mesh__"


def _jsonable_default(obj):
    """JSON fallback for the one non-scalar static: a ``DeviceMesh``
    serializes as its shape token (``{"__mesh__": "DPxSP"}``); replay
    substitutes the process's live mesh when, and only when, the shape
    matches."""
    from .parallel.sharding import DeviceMesh, mesh_shape_str

    if isinstance(obj, DeviceMesh):
        return {MESH_TOKEN: mesh_shape_str(obj)}
    raise TypeError(
        f"unserializable static {type(obj).__name__!r} in compile record"
    )


def sig_shapes_jsonable(sig, shapes):
    """The JSON form of one ``(sig, shapes)`` pair.  Tuples become lists;
    every leaf is a scalar (a mesh static becomes its shape token) — the
    round trip back through
    :func:`requests_from_record` rebuilds value-equal statics, and zero
    tensors at the recorded shapes rebuild the program key."""
    return json.loads(json.dumps([sig, shapes], default=_jsonable_default))


def _key_from_jsonable(jsonable) -> str:
    return json.dumps(jsonable, sort_keys=True)


def replay_key(sig, shapes) -> str:
    """Canonical string identity of one program — shared between live
    dispatches and ledger records, whatever side serialized it."""
    return _key_from_jsonable(sig_shapes_jsonable(sig, shapes))


# the Python scalars among a family core's arguments (tpe_device._arg_shape)
_SCALARS = {"py:int": 0, "py:float": 0.0, "py:bool": False}


def requests_from_record(rec, device=None, mesh=None):
    """Rebuild the ``(kind, args, statics)`` request list of a ledger
    record on ``device`` (None: the card) — zero-filled tensors at the
    recorded shapes and dtypes, zero scalars, which reproduce the program
    key the original dispatch had.

    ``mesh``: the process's live serving mesh (any form
    ``sharding.resolve_mesh`` takes).  A sharded program's record carries
    the mesh's shape token; replay substitutes the live mesh when the
    shapes match (the tensors then lie on its lead slot), so warmup warms
    the sharded grid.  Returns None when the record is not replayable (no
    sig/shapes, a mesh token the live topology cannot satisfy, a mesh
    static of another encoding, or an unknown dtype).  Reference:
    ``hyperopt_tpu/compile_ledger.py:239-280``."""
    import torch

    from .device import resolve_device
    from .parallel.sharding import mesh_shape_str, resolve_mesh

    sig = rec.get("sig")
    shapes = rec.get("shapes")
    if not sig or not shapes or len(sig) != len(shapes):
        return None
    live = resolve_mesh(mesh) if mesh is not None else None
    dev = live.lead_device if live is not None else resolve_device(device)
    requests = []
    for (kind, st_items), fam_shapes in zip(sig, shapes):
        statics = {str(k): _static_value(v) for k, v in st_items}
        if "mesh" in statics:
            token = statics["mesh"]
            if not (isinstance(token, dict) and MESH_TOKEN in token):
                return None  # another encoding
            if live is None or mesh_shape_str(live) != token[MESH_TOKEN]:
                return None  # a sharded program, its topology absent
            statics["mesh"] = live
        args = []
        for shape, dtype in fam_shapes:
            if dtype in _SCALARS:
                args.append(_SCALARS[dtype])
                continue
            dt = getattr(torch, str(dtype), None)
            if not isinstance(dt, torch.dtype):
                return None
            args.append(torch.zeros(tuple(int(d) for d in shape),
                                    dtype=dt, device=dev))
        requests.append((str(kind), tuple(args), statics))
    return requests


def _static_value(v):
    """JSON leaves back to the static's original type (tuples in statics
    would arrive as lists)."""
    if isinstance(v, list):
        return tuple(_static_value(x) for x in v)
    return v


# ---------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------


def _fold_records(by_key, order, records) -> int:
    """Fold ledger file records, in file order, into a ``by_key``/``order``
    view (latest per program identity): a later record of a key replaces
    an earlier one.  Returns the highest ``seq`` folded in."""
    seq = 0
    for rec in records:
        key = rec.get("replay_key") or replay_key(
            rec.get("sig") or [], rec.get("shapes") or []
        )
        if key not in by_key:
            order.append(key)
        by_key[key] = rec
        seq = max(seq, int(rec.get("seq", 0)))
    return seq


class CompileLedger:
    """Bounded, crash-consistent compile ledger for one service root.

    On-disk format: append-only JSONL, one ``O_APPEND`` write of
    ``\\n<crc32 hex> <json>`` per record (``tracing.format_record``).
    A torn tail (power loss / ``kill -9`` mid-write) garbles at most
    the record being written; the next append's leading newline
    re-synchronizes the reader (``tracing.parse_trace_log``).  The
    in-memory view keeps the LATEST record per program identity
    (:func:`replay_key`); the file compacts in place (atomic replace)
    once appends exceed ``COMPACT_APPEND_FACTOR``x the live count.

    ``path=None`` keeps the ledger in memory only (an ephemeral server
    still gets warm-key accounting and /v1/warmup, just no restart
    memory).

    Several replicas share one root's ledger: every append and every
    compaction holds ``flock(2)`` on ``<ledger>.lock``, so the file's
    order is the order the records were written in, whichever process
    wrote them.  A record's ``seq`` is numbered by its own process (two
    processes' seqs interleave), so a load folds in file order, and a
    compaction first folds in the file, so no replica's rewrite drops a
    sibling's record or keeps an older one of the same key.
    """

    # lock-order: _lock
    def __init__(self, path=None):
        self.path = path
        self._lock = threading.Lock()
        self._by_key = {}  # guarded-by: _lock  (replay_key -> record)
        self._order = []  # guarded-by: _lock  (replay keys, oldest first)
        self._seq = 0  # guarded-by: _lock
        self._appends_since_compact = 0  # guarded-by: _lock
        self.n_torn_lines = 0  # from the last load; read-only after init
        self._n_recorded = 0  # guarded-by: _lock  (this process's appends)
        if self.path:
            self._load()

    def _read_file(self):
        """(records in file order, n_torn) of the file; empty when absent."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return [], 0
        return tracing.parse_trace_log(raw)

    @contextlib.contextmanager
    def _file_lock(self):
        """flock(2) on ``<ledger>.lock``: one appender or compactor at a
        time across the replicas sharing the root."""
        fd = os.open(self.path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # releases the flock

    def _load(self):
        records, self.n_torn_lines = self._read_file()
        if self.n_torn_lines:
            logger.warning(
                "compile ledger %s: %d torn line(s) skipped (crash-"
                "consistent resync)", self.path, self.n_torn_lines,
            )
        with self._lock:
            self._seq = max(self._seq, _fold_records(
                self._by_key, self._order, records
            ))

    def record_compile(self, sig, shapes, duration_s, cache_hit=False,
                       fp=None, n_requests=None, source="dispatch"):
        """Journal one observed compile event of the fused suggest
        program.  ``sig``/``shapes`` are exactly what a
        ``tpe_device._trace_observers`` entry receives; the record is
        self-sufficient for replay (see :func:`requests_from_record`)."""
        from .algos import tpe_device

        bucket, families = tpe_device.compile_key(sig, shapes)
        jsonable = sig_shapes_jsonable(sig, shapes)
        key = _key_from_jsonable(jsonable)  # == replay_key(sig, shapes)
        with self._lock:
            self._seq += 1
            self._n_recorded += 1
            rec = {
                "seq": self._seq,
                "bucket": int(bucket),
                "families": str(families),
                "duration_s": round(float(duration_s), 6),
                "cache_hit": bool(cache_hit),
                "source": str(source),
                "fingerprint": dict(fp) if fp is not None else fingerprint(),
                "n_requests": (
                    int(n_requests) if n_requests is not None else None
                ),
                "sig": jsonable[0],
                "shapes": jsonable[1],
                "replay_key": key,
            }
            if key not in self._by_key:
                self._order.append(key)
            self._by_key[key] = rec
            if self.path:
                # one crash-atomic O_APPEND write + fsync — a torn
                # tail garbles at most this record, resync'd on load.
                # The ledger lock deliberately serializes journal I/O:
                # appends must land in the order they were made and
                # must not interleave with the compaction rewrite
                # below; the file lock does the same across processes.
                with self._file_lock():
                    journal_io.append_record(  # lint: disable=RL305
                        self.path, rec, fsync_kind="ledger"
                    )
                    self._appends_since_compact += 1
                    if self._appends_since_compact > (
                        COMPACT_APPEND_FACTOR * max(len(self._order), 1)
                    ):
                        # compaction: rewrite with only the live
                        # (latest-per-key) entries, siblings' included
                        # — atomic replace, crash-safe
                        self._seq = max(self._seq, _fold_records(
                            self._by_key, self._order, self._read_file()[0]
                        ))
                        journal_io.compact_records(
                            self.path,
                            [self._by_key[k] for k in self._order],
                            fsync_kind="ledger",
                        )
                        self._appends_since_compact = 0
        return rec

    def refresh(self):
        """Fold in the records sibling replicas appended to the shared
        file since this process loaded it (a takeover replays them)."""
        if not self.path:
            return
        # under both locks: every record this process holds is then in
        # the file before the read, so the file's last record of a key
        # is the newest one
        with self._lock, self._file_lock():
            self._seq = max(self._seq, _fold_records(
                self._by_key, self._order, self._read_file()[0]
            ))

    # -- reads ---------------------------------------------------------
    def entries(self, current_fingerprint=None):
        """Latest record per program identity, oldest first.  With
        ``current_fingerprint``, stale records (written by a different
        torch/kernel/backend) are EXCLUDED — the fingerprint gate that
        keeps an old ledger from marking buckets warm it cannot warm."""
        with self._lock:
            recs = [self._by_key[k] for k in self._order]
        if current_fingerprint is None:
            return recs
        return [
            r for r in recs
            if r.get("fingerprint") == dict(current_fingerprint)
        ]

    def grid(self, current_fingerprint=None) -> dict:
        """{(bucket, families): {"n", "duration_s", "cache_hits"}} over
        the live entries — the bucket×family inventory the warmup
        report and /v1/warmup aggregate by."""
        out = {}
        for rec in self.entries(current_fingerprint=current_fingerprint):
            key = (int(rec.get("bucket", 0)), str(rec.get("families")))
            slot = out.setdefault(
                key, {"n": 0, "duration_s": 0.0, "cache_hits": 0}
            )
            slot["n"] += 1
            slot["duration_s"] = max(
                slot["duration_s"], float(rec.get("duration_s") or 0.0)
            )
            slot["cache_hits"] += 1 if rec.get("cache_hit") else 0
        return out

    def __len__(self):
        with self._lock:
            return len(self._order)

    def summary(self) -> dict:
        with self._lock:
            recs = [self._by_key[k] for k in self._order]
            n_recorded = self._n_recorded
        return {
            "path": self.path,
            "entries": len(recs),
            "recorded_this_process": n_recorded,
            "torn_lines": self.n_torn_lines,
            "cache_hits": sum(1 for r in recs if r.get("cache_hit")),
            "total_compile_s": round(
                sum(float(r.get("duration_s") or 0.0) for r in recs), 3
            ),
            "cache_events": cache_event_counts(),
        }


# ---------------------------------------------------------------------
# the recorder (tpe_device observer pair)
# ---------------------------------------------------------------------


class CompileLedgerRecorder:
    """Feeds the ledger from ``tpe_device._trace_observers``: every
    compile event appends one record with the dispatch's launch time and
    whether the kernel libraries it loaded came from the cache (a
    windowed attribution: a library load by another thread between two
    compile events can mislabel — an effectiveness signal, not an exact
    per-program field)."""

    def __init__(self, ledger: CompileLedger):
        self.ledger = ledger
        self._observer = None
        self._fp = None  # stamped lazily, at the first compile event
        self._cache_seen = None

    def install(self):
        from .algos import tpe_device

        if self._observer is not None:
            return self
        ledger = self.ledger
        recorder = self
        self._cache_seen = cache_event_counts()

        def on_compile(sig, shapes, launch_s):
            try:
                if recorder._fp is None:
                    recorder._fp = fingerprint()
                now = cache_event_counts()
                seen, recorder._cache_seen = recorder._cache_seen, now
                ledger.record_compile(
                    sig, shapes, duration_s=float(launch_s),
                    cache_hit=(now["hits"] > seen["hits"]
                               and now["misses"] == seen["misses"]),
                    fp=recorder._fp, n_requests=len(sig),
                )
            except Exception:  # observers must not fail a dispatch
                logger.exception("compile-ledger record failed")

        tpe_device._trace_observers.append(on_compile)
        self._observer = on_compile
        return self

    def uninstall(self):
        if self._observer is None:
            return
        from .algos import tpe_device

        try:
            tpe_device._trace_observers.remove(self._observer)
        except ValueError:
            pass
        self._observer = None


# ---------------------------------------------------------------------
# the warmup driver
# ---------------------------------------------------------------------

STATE_PENDING = "pending"
STATE_COMPILING = "compiling"
STATE_WARM = "warm"
STATE_SKIPPED = "skipped"
STATE_ERROR = "error"


class _WarmupItem:
    __slots__ = (
        "bucket", "families", "key", "source", "state", "est_s",
        "actual_s", "requests", "detail",
    )

    def __init__(self, bucket, families, key, source, est_s=None,
                 requests=None):
        self.bucket = int(bucket)
        self.families = str(families)
        self.key = key
        self.source = source  # "ledger" | "predicted"
        self.state = STATE_PENDING
        self.est_s = est_s
        self.actual_s = None
        self.requests = requests
        self.detail = None

    def row(self) -> dict:
        return {
            "bucket": self.bucket,
            "families": self.families,
            "source": self.source,
            "state": self.state,
            "est_s": (
                round(self.est_s, 4) if self.est_s is not None else None
            ),
            "actual_s": (
                round(self.actual_s, 4) if self.actual_s is not None
                else None
            ),
            "detail": self.detail,
        }


class WarmupDriver:
    """Replays the predicted compile grid through the real dispatch
    path before the service reports ready.

    Grid sources, deduplicated by program identity and skipping
    programs this process already dispatched (``tpe_device.is_warm``):

    - the ledger's fingerprint-matching records (replayed from their
      recorded shapes — no study state needed);
    - a dry ``Study.prepare`` probe per recovered study (the program
      its NEXT suggest will dispatch at the current trial-count
      bucket).

    ``run()`` executes on a daemon thread (``start()``), or through
    ``runner`` (the service passes its scheduler's ``call_soon``, so the
    replay launches from the one thread that launches on the card);
    ``/readyz``
    gates on :attr:`finished` — *finished*, not *fully warm*: an item
    that errors is reported, never allowed to wedge readiness forever.
    """

    # lock-order: _lock  (never held across a dispatch or a study lock)
    def __init__(self, ledger: CompileLedger = None, studies=(),
                 device_recovery=None, enabled=True, device=None,
                 runner=None, mesh=None):
        self.ledger = ledger
        self._studies = list(studies)
        self.device_recovery = device_recovery
        self.enabled = bool(enabled)
        # the device the replayed programs run on, and the serving mesh a
        # sharded program's record replays onto
        self.device = device
        self.mesh = mesh
        self._runner = runner
        self._lock = threading.Lock()
        self._items = []  # guarded-by: _lock
        self._planned = False  # guarded-by: _lock
        self._started_at = None  # guarded-by: _lock
        self._finished_at = None  # guarded-by: _lock
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._thread = None
        self._plan_error = None  # guarded-by: _lock
        if not self.enabled:
            self._done.set()

    # -- planning ------------------------------------------------------
    def plan(self):
        """Build the item list (idempotent).  Probing runs under each
        study's lock; ledger decoding never touches the device."""
        from .algos import tpe_device

        with self._lock:
            if self._planned:
                return [i.row() for i in self._items]
            self._planned = True
        items, seen = [], set()

        def add(item):
            if item.key in seen:
                return
            seen.add(item.key)
            items.append(item)

        if self.ledger is not None:
            try:
                fp = fingerprint()
            except Exception:  # pragma: no cover - defensive
                fp = None
            n_stale = 0
            if fp is not None:
                n_stale = len(self.ledger.entries()) - len(
                    self.ledger.entries(current_fingerprint=fp)
                )
            if n_stale:
                logger.warning(
                    "compile ledger: %d stale entr%s (fingerprint "
                    "mismatch) excluded from warmup", n_stale,
                    "y" if n_stale == 1 else "ies",
                )
            for rec in self.ledger.entries(current_fingerprint=fp):
                item = _WarmupItem(
                    rec.get("bucket", 0), rec.get("families"),
                    rec.get("replay_key"), "ledger",
                    est_s=float(rec.get("duration_s") or 0.0) or None,
                )
                requests = requests_from_record(rec, device=self.device, mesh=self.mesh)
                if requests is None:
                    item.state = STATE_SKIPPED
                    item.detail = "record not replayable"
                elif tpe_device.is_warm(requests):
                    item.state = STATE_WARM
                    item.detail = "already dispatched this process"
                else:
                    item.requests = requests
                add(item)
        for study in self._studies:
            try:
                with study.lock:
                    # a DRY prepare: ids are placeholders (k=1 is the
                    # static; docs are only built by finish, which never
                    # runs) and the probe consumes no seed or trial id
                    prep = study.prepare([0], 0)
            except Exception as e:
                logger.warning(
                    "warmup probe failed for study %r: %s",
                    getattr(study, "study_id", "?"), e,
                )
                continue
            if prep is None:
                continue  # host-side path (startup) — nothing to warm
            requests = prep[0]
            sig = tpe_device._multi_sig(requests)
            shapes = tpe_device.args_shapes(
                [args for _, args, _ in requests]
            )
            bucket, families = tpe_device.compile_key(sig, shapes)
            key = replay_key(sig, shapes)
            est = None
            if self.ledger is not None:
                prior = self.ledger.grid().get((bucket, families))
                est = prior["duration_s"] if prior else None
            item = _WarmupItem(
                bucket, families, key, "predicted", est_s=est,
                requests=requests,
            )
            if tpe_device.is_warm(requests):
                item.state = STATE_WARM
                item.detail = "already dispatched this process"
                item.requests = None
            add(item)
        with self._lock:
            self._items = items
        return [i.row() for i in items]

    # -- execution -----------------------------------------------------
    def start(self):
        if not self.enabled:
            return self
        with self._lock:
            if self._thread is not None:
                return self
            if self._runner is not None:
                self._thread = self._runner
            else:
                self._thread = threading.Thread(
                    target=self._run, name="hyperopt-compile-warmup",
                    daemon=True,
                )
        if self._runner is not None:
            self._runner(self._run)
        else:
            self._thread.start()
        return self

    def _run(self):
        with self._lock:
            self._started_at = time.monotonic()
        try:
            try:
                self.plan()
            except Exception as e:
                # an aborted plan must not be SILENT: readiness still
                # goes green (finished, by design), but /v1/warmup and
                # the /readyz body carry the error
                logger.exception("warmup planning failed")
                with self._lock:
                    self._plan_error = repr(e)
                return
            with self._lock:
                items = list(self._items)
            for item in items:
                if self._cancel.is_set():
                    # service closing: skip the remaining grid (a
                    # mid-flight compile cannot be aborted, but no NEW
                    # ones start — a dead service's warmup must not
                    # keep the cold-launch lock busy for its successor)
                    with self._lock:
                        if item.state == STATE_PENDING:
                            item.state = STATE_SKIPPED
                            item.detail = "cancelled (service closed)"
                    continue
                if item.state != STATE_PENDING:
                    continue
                self._warm_one(item)
        finally:
            with self._lock:
                self._finished_at = time.monotonic()
            self._done.set()

    def _warm_one(self, item):
        from .algos import tpe_device

        with self._lock:
            item.state = STATE_COMPILING
        t0 = time.perf_counter()

        def dispatch():
            tpe_device.multi_family_suggest_async(item.requests)()

        try:
            # marked background: a request overlapping a warmup compile
            # (nothing blocks pre-ready suggests) is not cold
            with tpe_device.background_compiles():
                if self.device_recovery is not None:
                    self.device_recovery.run(dispatch)
                else:
                    dispatch()
        except Exception as e:
            logger.warning(
                "warmup compile failed for bucket %d (%s): %r",
                item.bucket, item.families, e,
            )
            with self._lock:
                item.state = STATE_ERROR
                item.detail = repr(e)
                item.requests = None
            return
        with self._lock:
            item.state = STATE_WARM
            item.actual_s = time.perf_counter() - t0
            item.requests = None  # drop the dummy buffers

    def stop(self, timeout=10.0):
        """Cancel remaining items and wait for the thread to exit (a
        mid-flight compile finishes; nothing new starts).  Called by
        ``OptimizationService.close``."""
        self._cancel.set()
        thread = self._thread
        if isinstance(thread, threading.Thread) and thread.is_alive():
            thread.join(timeout=timeout)

    # -- surfaces ------------------------------------------------------
    @property
    def finished(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout=None) -> bool:
        return self._done.wait(timeout)

    def counts(self) -> dict:
        with self._lock:
            items = list(self._items)
        c = {
            STATE_PENDING: 0, STATE_COMPILING: 0, STATE_WARM: 0,
            STATE_SKIPPED: 0, STATE_ERROR: 0,
        }
        for item in items:
            c[item.state] += 1
        return c

    def progress_brief(self) -> dict:
        """The ``/readyz`` body's warmup block — enough for a blocked
        ``ServiceClient.wait_ready`` log line to be actionable."""
        c = self.counts()
        total = sum(c.values())
        with self._lock:
            plan_error = self._plan_error
        out = {
            "enabled": self.enabled,
            "finished": self.finished,
            "warmed": c[STATE_WARM],
            "total": total,
            "compiling": c[STATE_COMPILING],
            "eta_s": self._eta_s(),
        }
        if plan_error is not None:
            out["plan_error"] = plan_error
        return out

    def _eta_s(self):
        with self._lock:
            items = list(self._items)
        remaining = [
            i for i in items
            if i.state in (STATE_PENDING, STATE_COMPILING)
        ]
        if not remaining:
            return 0.0
        known = [i.est_s for i in remaining if i.est_s]
        default = (
            sum(known) / len(known) if known else None
        )
        if default is None:
            done = [i.actual_s for i in items if i.actual_s]
            default = sum(done) / len(done) if done else None
        if default is None:
            return None
        return round(
            sum(i.est_s if i.est_s else default for i in remaining), 3
        )

    def status(self) -> dict:
        """The full ``GET /v1/warmup`` document."""
        with self._lock:
            items = [i.row() for i in self._items]
            started = self._started_at
            finished_t = self._finished_at
        brief = self.progress_brief()
        brief.update({
            "items": items,
            "elapsed_s": (
                round((finished_t or time.monotonic()) - started, 3)
                if started is not None else None
            ),
            "ledger": (
                self.ledger.summary() if self.ledger is not None else None
            ),
        })
        return brief
