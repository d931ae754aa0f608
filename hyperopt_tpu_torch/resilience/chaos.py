"""Seeded chaos harness: deterministic, reproducible fault injection.

Testing a fault-tolerance layer against real faults is flaky by
construction; this harness makes the faults themselves reproducible.
Every injection decision is a pure function of
``(seed, site, key, occurrence)`` — SHA-256 hashed to a uniform draw
compared against the site's probability — where ``occurrence`` counts
how many times that exact ``(site, key)`` has rolled.  Re-running a
campaign with the same seed therefore injects the same faults at the
same logical points (trial 7's first execution, the third device
dispatch, ...), regardless of wall-clock timing or which worker thread
got the job, and a trial that retries after an injected fault rolls a
*fresh* occurrence — so transient faults stay transient.

Reference parity: ``hyperopt_tpu/resilience/chaos.py``, the same
schedule at the same seed.

Injected fault classes:

- **worker kill mid-trial** — :class:`WorkerKilled` raised inside
  ``FileWorker.run_one`` outside its error-writing path: the trial
  stays RUNNING with its lock and lease in place, exactly like a
  SIGKILL'd process.  Recovery: lease expiry → reaper reclamation.
- **torn/stale lock files** — garbage bytes written to a fresh trial's
  lock path at insert time (a worker that died inside its lock write).
  Recovery: the reaper's stale-lock GC.
- **delayed / duplicated results** — a full-process stall (heartbeat
  paused with the worker, modelling a VM freeze / stop-the-world pause)
  before, or a second idempotent write after, the worker's final doc
  write.  Recovery: the lease-ownership/expiry re-check drops genuinely
  stale writes (when the stall exceeds the TTL the reaper reclaims and
  re-queues); duplicates are idempotent by construction.
- **objective exceptions / NaNs / hangs** — raised/returned/slept inside
  the objective.  Recovery: retry policy (backoff + watchdog timeout),
  quarantine past ``max_attempts``; NaN losses are NaN-safe in the TPE
  fit.
- **synthetic device errors** — :class:`SyntheticDeviceError` raised
  from a ``tpe_device`` suggest-dispatch observer.  Recovery: the
  driver's ``DeviceRecovery`` re-initializes the device state (at most
  ``max_reinits`` consecutive times, then the error propagates; no CPU
  fallback), and the speculative engine recomputes a failed speculation
  synchronously with its ids and seed.

Service-plane fault classes, aimed at the optimization
server's HTTP edge and its crash-consistent store:

- **server SIGKILL mid-batch** — the chaos-serve campaign's supervisor
  rolls ``should_kill_server`` per completed trial and ``kill -9``s the
  server process at the hits.  Recovery: startup fsck + response-journal
  replay + seed-cursor re-verification; clients retry through the
  outage with idempotency keys.
- **connection reset before/after response commit** — the HTTP handler
  drops the connection without a response, either before any state
  change (client retry is trivially safe) or after the journal+store
  commit (client retry replays the journaled response byte-for-byte).
- **torn doc / torn journal writes** — a trial doc is truncated in
  place after its atomic write (latent disk corruption discovered at
  the next read/restart: the CRC trailer detects it and quarantines),
  or the append-only response journal loses the tail of its last
  record (the per-line CRC detects it; replay of a lost tail entry is
  safe because the entry's effects had not landed either).
- **slow-loris clients** — the campaign parks sockets that trickle a
  request forever; the handler's read timeout bounds the damage to one
  handler thread per socket.

Replica-plane fault classes, aimed at the multi-replica
serving topology's ownership leases and routing:

- **owning-replica SIGKILL** — the failover campaign's supervisor rolls
  ``should_kill_replica`` per progress tick and ``kill -9``s the
  replica owning the watched studies.  Recovery: lease expiry →
  fencing-token claim → fsck-clean takeover → compile-ledger pre-warm
  on a surviving replica; clients ride through on ring failover.
- **lease-renewal stall** — the replica's heartbeat thread freezes past
  the lease TTL (``maybe_lease_stall``), modelling a stop-the-world
  pause: the study is reclaimed while the holder still *thinks* it
  owns it.  Recovery: the resumed holder's writes are stale-fenced and
  dropped; its next heartbeat discovers the bumped fence and
  relinquishes.
- **asymmetric partition** — ``maybe_client_partition`` opens a window
  during which the HTTP layer drops every client connection while the
  replica's store-side heartbeats keep running (client↔replica dead,
  replica↔store alive).  No failover fires — the lease stays warm —
  so redirects + client-side ring failover alone must carry traffic.

Every service-plane injection can be appended to a crash-surviving
``injection_log`` (``O_APPEND``, CRC-framed records via
``tracing.format_record`` — the same journal discipline as the response
journal and trace log) so a campaign can reconcile injected-fault
counts across server kills.

Activate with :func:`active` (a context manager setting the process-wide
monkey); the production code paths cost one ``sys.modules`` lookup when
the harness was never imported.  Every injection is counted in the
monkey's :class:`~hyperopt_tpu_torch.observability.FaultStats` under
``chaos_<site>`` keys, which the campaign report reconciles against the
recovery counters.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import threading
import time
import zlib
from collections import defaultdict
from dataclasses import dataclass

from ..observability import FaultStats
from ..tracing import current_trace_id
from .device import SyntheticDeviceError

logger = logging.getLogger(__name__)


class WorkerKilled(Exception):
    """Chaos-injected worker death: propagate without touching the
    queue (the trial must look exactly like its worker was SIGKILL'd)."""


class ChaosObjectiveError(RuntimeError):
    """Chaos-injected transient objective failure."""


@dataclass(frozen=True)
class ChaosConfig:
    """Per-site injection probabilities (0 disables a site) + the seed.

    ``hang_seconds`` should exceed the run's ``trial_timeout`` for hangs
    to be *observable* faults; ``delay_seconds`` should exceed the lease
    TTL for delays to exercise the stale-result drop (below it they are
    harmless slow writes)."""

    seed: int = 0
    p_worker_kill: float = 0.0
    p_torn_lock: float = 0.0
    p_result_delay: float = 0.0
    p_result_duplicate: float = 0.0
    p_objective_error: float = 0.0
    p_objective_nan: float = 0.0
    p_objective_hang: float = 0.0
    p_device_error: float = 0.0
    hang_seconds: float = 1.0
    delay_seconds: float = 0.5
    # service-plane sites (chaos-serve campaign)
    p_server_kill: float = 0.0
    p_conn_reset_pre: float = 0.0
    p_conn_reset_post: float = 0.0
    p_torn_doc: float = 0.0
    p_torn_journal: float = 0.0
    p_slow_loris: float = 0.0
    # segmented-store sites (segment log campaign)
    p_torn_segment: float = 0.0     # clip the tail off a segment append
    p_compaction_kill: float = 0.0  # SIGKILL inside the compaction window
    # replica-plane sites (failover campaign)
    p_replica_kill: float = 0.0     # supervisor SIGKILLs the owning replica
    p_lease_stall: float = 0.0      # heartbeat frozen past the lease TTL
    lease_stall_seconds: float = 3.0
    p_client_partition: float = 0.0  # client<->replica dead, replica<->store alive
    partition_seconds: float = 2.0
    # crash-consistent tears: a REAL torn write only damages data whose
    # fsync never returned — i.e. it happens AT a crash, and the write
    # was never acknowledged downstream.  With this flag (the default)
    # a torn doc/journal site tears the file and then SIGKILLs its own
    # process mid-write, exactly that semantics.  False gives a plain
    # in-place tear (a lying disk) for unit tests of the detectors —
    # a model under which NO single-copy store can avoid data loss once
    # both the doc and its journal record rot independently.
    tear_kills_process: bool = True
    # crash-surviving injection record (JSONL, appended O_APPEND): lets
    # a campaign count injections made by a process that was later
    # SIGKILL'd.  None disables.
    injection_log: str | None = None

    def to_json(self) -> str:
        return json.dumps(
            {f: getattr(self, f) for f in self.__dataclass_fields__},
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, blob: str) -> "ChaosConfig":
        d = json.loads(blob)
        known = {
            k: v for k, v in d.items() if k in cls.__dataclass_fields__
        }
        return cls(**known)


def parse_injection_log(raw: bytes) -> list:
    """Records from raw injection-log bytes.

    Records are CRC-framed (``tracing.format_record``: ``\\n<crc32 hex>
    <json>``); bare-JSON lines written by pre-framing versions of this
    module are still accepted, so an upgraded server replays its old
    log.  Torn lines (a SIGKILL mid-append) are skipped — the frame
    makes them detectable rather than silently half-parsed."""
    records = []
    for line in raw.split(b"\n"):
        line = line.strip()
        if not line:
            continue
        rec = None
        try:
            crc_hex, body = line.split(b" ", 1)
            if (zlib.crc32(body) & 0xFFFFFFFF) == int(crc_hex, 16):
                rec = json.loads(body.decode())
        except (ValueError, json.JSONDecodeError, UnicodeDecodeError):
            rec = None
        if rec is None:
            try:
                rec = json.loads(line.decode())  # legacy unframed line
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue  # the torn tail of a mid-append SIGKILL
        if isinstance(rec, dict):
            records.append(rec)
    return records


def stable_key(cfg) -> str:
    """Deterministic key for an objective's config dict (the same
    suggested point maps to the same key in every run)."""
    if isinstance(cfg, dict):
        return repr(sorted((str(k), repr(v)) for k, v in cfg.items()))
    return repr(cfg)


class ChaosMonkey:
    """One seeded fault-injection schedule + its accounting."""

    # lock-order: _roll_lock
    def __init__(self, config: ChaosConfig, stats: FaultStats | None = None):
        self.config = config
        self.stats = stats if stats is not None else FaultStats()
        self._roll_lock = threading.Lock()
        self._occurrence = defaultdict(int)  # guarded-by: _roll_lock
        # open client-partition windows (replica_id -> deadline epoch)
        self._partition_lock = threading.Lock()
        self._partition_until = {}  # guarded-by: _partition_lock
        # replicas whose ONE window already opened (see
        # maybe_client_partition: at most one window per replica per
        # monkey, or a p=1.0 campaign would re-open the window on every
        # request and blackhole the fleet forever)
        self._partition_opened = set()  # guarded-by: _partition_lock
        self._installed_observer = None
        # bounded ring of the most recent injections (log path or not)
        # — the flight recorder's chaos-correlation evidence; deque
        # appends are GIL-atomic, snapshots copy via list()
        from collections import deque

        self._recent = deque(maxlen=256)
        self._replay_injection_log()

    def recent_injections(self) -> list:
        """The last injections as record dicts, oldest first (a
        snapshot) — pulled by the flight recorder at dump time."""
        return [dict(r) for r in list(self._recent)]

    def _replay_injection_log(self):
        """Restore occurrence counters from the crash-surviving log.

        "Transient faults stay transient" must hold across process
        death too: a tear site that SIGKILLs its own process would
        otherwise re-roll the retried write at occurrence 0 in the
        restarted server — same hash, same hit, a deterministic crash
        loop.  Replaying the log advances each ``(site, key)`` past its
        already-injected occurrences, so the retry rolls fresh."""
        if not self.config.injection_log:
            return
        try:
            with open(self.config.injection_log, "rb") as f:
                raw = f.read()
        except OSError:
            return
        with self._roll_lock:
            for rec in parse_injection_log(raw):
                try:
                    site, key = rec["site"], rec["key"]
                    occ = int(rec["occurrence"])
                except (KeyError, TypeError, ValueError):
                    continue
                if self._occurrence[(site, key)] <= occ:
                    self._occurrence[(site, key)] = occ + 1

    # -- the deterministic roll ----------------------------------------
    def _roll(self, site: str, key, p: float) -> bool:
        if p <= 0.0:
            return False
        # occurrence is tracked by the key's STRING form — the hash
        # below already stringifies, and the injection-log replay can
        # then restore counters across a process death
        skey = str(key)
        with self._roll_lock:
            occ = self._occurrence[(site, skey)]
            self._occurrence[(site, skey)] = occ + 1
        h = hashlib.sha256(
            f"{self.config.seed}:{site}:{key}:{occ}".encode()
        ).digest()
        hit = int.from_bytes(h[:8], "big") / 2 ** 64 < p
        if hit:
            self.stats.record(f"chaos_{site}")
            self._log_injection(site, skey, occ)
        return hit

    def _log_injection(self, site, key, occ):
        """Append one injection record to the crash-surviving log.
        One CRC-framed ``O_APPEND`` write (``tracing.format_record``):
        a SIGKILL mid-append tears at most the final record, and the
        frame makes the tear detectable instead of a parse guess.

        The active request-trace id (if the injecting thread is inside
        a traced request) is stamped into the record, so a fault in a
        ``CHAOS_SERVE.json`` campaign can be joined to the exact trace
        it perturbed — "this p99 outlier ate a torn-journal injection"
        becomes a log join instead of a guess."""
        record = {
            "site": site, "key": str(key), "occurrence": occ,
            "trace_id": current_trace_id(),
        }
        self._recent.append(record)
        if not self.config.injection_log:
            return
        from .. import journal_io

        try:
            # advisory log: no fsync — losing the final record at a
            # crash is exactly the torn tail the frame detects
            journal_io.append_record(
                self.config.injection_log, record, fsync=False
            )
        except OSError:
            logger.warning("could not append injection log", exc_info=True)

    # -- worker-plane sites --------------------------------------------
    def maybe_kill_worker(self, tid, where: str = "mid"):
        """Raise :class:`WorkerKilled` per the schedule.  ``where``
        distinguishes kill points (before vs. after the objective) so
        each rolls independently."""
        if self._roll("worker_kill", (int(tid), where),
                      self.config.p_worker_kill):
            logger.info("chaos: killing worker at trial %s (%s)", tid, where)
            raise WorkerKilled(f"chaos kill at trial {tid} ({where})")

    def should_delay_result(self, tid) -> bool:
        """Roll the result_delay site.  The WORKER implements the stall
        (pausing its heartbeat for the sleep) so the fault models a
        frozen process — otherwise the heartbeat thread would keep the
        lease warm and a delay could never exercise the stale-result
        drop, however long."""
        return self._roll("result_delay", int(tid),
                          self.config.p_result_delay)

    def should_duplicate_result(self, tid) -> bool:
        return self._roll(
            "result_duplicate", int(tid), self.config.p_result_duplicate
        )

    # -- queue-plane sites ---------------------------------------------
    def maybe_torn_lock(self, jobs, tid):
        """Write garbage to ``tid``'s lock path (iff currently unlocked):
        a worker that died inside its lock write."""
        if not self._roll("torn_lock", int(tid), self.config.p_torn_lock):
            return
        lock = jobs.lock_path(tid)
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return
        with os.fdopen(fd, "wb") as f:
            f.write(b"\x00torn\x00")  # never a valid owner string
        logger.info("chaos: tore lock file for trial %s", tid)

    # -- objective-plane sites -----------------------------------------
    def objective_fault(self, key):
        """Inject at one objective evaluation.  May sleep (hang), raise
        (:class:`ChaosObjectiveError`), or return ``float('nan')`` to be
        used as the loss; returns None when nothing fired."""
        if self._roll("objective_hang", key, self.config.p_objective_hang):
            logger.info("chaos: hanging objective (%.2fs)",
                        self.config.hang_seconds)
            time.sleep(self.config.hang_seconds)
        if self._roll("objective_error", key, self.config.p_objective_error):
            raise ChaosObjectiveError(f"chaos objective error at {key!r}")
        if self._roll("objective_nan", key, self.config.p_objective_nan):
            return float("nan")
        return None

    def wrap_objective(self, fn):
        """In-process convenience: ``fn`` with faults injected per point.
        (Out-of-process workers can't unpickle a closure — they call
        :func:`objective_fault` from a module-level objective instead.)"""

        def chaotic(cfg):
            fault = self.objective_fault(stable_key(cfg))
            if fault is not None:
                return fault
            return fn(cfg)

        return chaotic

    # -- service-plane sites -------------------------------------------
    @staticmethod
    def _tear_file(path, drop_bytes=None):
        """Truncate ``path`` in place — the on-disk shape of a write the
        kernel never finished.  ``drop_bytes=None`` halves the file (a
        torn doc); a positive value clips just the tail (a torn
        append)."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return False
        keep = size // 2 if drop_bytes is None else max(
            0, size - int(drop_bytes)
        )
        if keep >= size:
            keep = max(0, size - 1)
        try:
            with open(path, "r+b") as f:
                f.truncate(keep)
        except OSError:
            return False
        return True

    def _die_mid_write(self):
        """SIGKILL our own process — the write we just tore is now a
        write the crash interrupted, never one the caller acknowledged."""
        import signal as _signal

        os.kill(os.getpid(), _signal.SIGKILL)

    def maybe_torn_doc(self, path, tid):
        """Tear a just-written trial doc: the CRC trailer detects it at
        the next read and fsck quarantines/restores it.  With
        ``tear_kills_process`` (default) the process dies mid-write —
        the crash-consistent torn write."""
        if not self._roll("torn_doc", int(tid), self.config.p_torn_doc):
            return
        if self._tear_file(path):
            logger.info("chaos: tore doc for trial %s", tid)
            if self.config.tear_kills_process:
                self._die_mid_write()

    def maybe_torn_journal(self, path, key):
        """Clip the tail off the append-only response journal — a torn
        final append.  The per-line CRC detects it; with
        ``tear_kills_process`` (default) the process dies mid-append, so
        the lost record is by construction one no client was answered
        for."""
        if not self._roll("torn_journal", key, self.config.p_torn_journal):
            return
        if self._tear_file(path, drop_bytes=7):
            logger.info("chaos: tore journal tail at %s", path)
            if self.config.tear_kills_process:
                self._die_mid_write()

    def maybe_torn_segment(self, path, key):
        """Clip the tail off a just-appended segment — the torn group
        commit.  The incremental chunk parser leaves the invalid tail
        unconsumed on an active segment and counts it torn once sealed;
        with ``tear_kills_process`` (default) the process dies
        mid-append, so the lost batch was never acknowledged."""
        if not self._roll(
            "torn_segment", int(key), self.config.p_torn_segment
        ):
            return
        if self._tear_file(path, drop_bytes=11):
            logger.info("chaos: tore segment tail at %s", path)
            if self.config.tear_kills_process:
                self._die_mid_write()

    def maybe_compaction_kill(self, segments_dir, epoch):
        """SIGKILL inside compaction's vulnerable window: the new
        manifest (epoch N+1) is published but the retired epoch-N
        segments are not yet unlinked — recovery must replay the folded
        base and fsck FS412 must sweep the orphans."""
        if not self._roll(
            "compaction_kill", int(epoch), self.config.p_compaction_kill
        ):
            return
        logger.info(
            "chaos: killing mid-compaction (epoch %s) in %s",
            epoch, segments_dir,
        )
        self._die_mid_write()

    def should_reset_connection(self, route: str, key, when: str) -> bool:
        """Roll a connection-reset site.  ``when`` is ``"pre"`` (drop
        before any state change) or ``"post"`` (drop after the
        journal+store commit, before the response bytes leave)."""
        p = (
            self.config.p_conn_reset_pre
            if when == "pre"
            else self.config.p_conn_reset_post
        )
        return self._roll(f"conn_reset_{when}", (route, key), p)

    def should_kill_server(self, key) -> bool:
        """One supervisor roll of the server-SIGKILL site (the campaign
        rolls once per completed trial and kills at the hits)."""
        return self._roll("server_kill", key, self.config.p_server_kill)

    def should_slow_loris(self, key) -> bool:
        return self._roll("slow_loris", key, self.config.p_slow_loris)

    # -- replica-plane sites -------------------------------------------
    def should_kill_replica(self, replica_id) -> bool:
        """One supervisor roll of the owning-replica SIGKILL site (the
        failover campaign rolls per progress tick against the replica
        that currently OWNS the watched studies and ``kill -9``s it at
        the hits).  Recovery: lease expiry → fencing claim → fsck-clean
        takeover → ledger pre-warm on the surviving replica."""
        return self._roll(
            "replica_kill", str(replica_id), self.config.p_replica_kill
        )

    def maybe_lease_stall(self, replica_id) -> float:
        """Roll the lease-renewal stall site: a hit returns the stall
        duration (seconds) and the replica's heartbeat thread FREEZES
        for it — renewals stop with the lease left in place, modelling
        a stop-the-world-paused holder.  ``lease_stall_seconds`` should
        exceed the replica lease TTL for the stall to be an observable
        fault (the study is reclaimed; the stalled holder's resumed
        writes are stale-fenced and dropped)."""
        if self._roll(
            "lease_stall", str(replica_id), self.config.p_lease_stall
        ):
            logger.info(
                "chaos: stalling lease heartbeat of %s for %.2fs",
                replica_id, self.config.lease_stall_seconds,
            )
            return float(self.config.lease_stall_seconds)
        return 0.0

    def maybe_client_partition(self, replica_id):
        """Roll the asymmetric-partition site: a hit opens a
        ``partition_seconds`` window during which the HTTP layer drops
        EVERY client connection to this replica while its store-side
        heartbeats keep running (client↔replica dead, replica↔store
        alive).  No failover fires — the lease stays warm — so the
        traffic must ride on client-side ring failover + redirects.

        At most ONE window opens per replica per monkey: the site is
        rolled per request, and a per-request re-roll at p=1.0 would
        otherwise re-open the window forever and model a permanent
        outage instead of a partition EVENT.  Re-arm by constructing a
        fresh monkey (the campaign does, one per scenario)."""
        rid = str(replica_id)
        with self._partition_lock:
            if rid in self._partition_opened:
                return
        if self._roll(
            "client_partition", rid, self.config.p_client_partition,
        ):
            until = time.time() + float(self.config.partition_seconds)
            with self._partition_lock:
                if rid in self._partition_opened:
                    return  # lost the race to a concurrent request
                self._partition_opened.add(rid)
                self._partition_until[rid] = until
            logger.info(
                "chaos: client partition of %s for %.2fs",
                replica_id, self.config.partition_seconds,
            )

    def client_partitioned(self, replica_id) -> bool:
        with self._partition_lock:
            until = self._partition_until.get(str(replica_id), 0.0)
        return time.time() < until

    # -- device-plane site ---------------------------------------------
    def maybe_device_error(self):
        """Roll the device-error site once (one suggest dispatch)."""
        if self._roll("device_error", "dispatch", self.config.p_device_error):
            raise SyntheticDeviceError("chaos device error at dispatch")

    def install_device_faults(self):
        """Register a ``tpe_device`` suggest observer that raises
        :class:`SyntheticDeviceError` per the schedule (undone by
        :func:`active`'s exit or :meth:`uninstall_device_faults`)."""
        if self.config.p_device_error <= 0 or self._installed_observer:
            return
        from ..algos import tpe_device

        def _observer(requests):
            self.maybe_device_error()

        tpe_device._suggest_observers.append(_observer)
        self._installed_observer = _observer

    def uninstall_device_faults(self):
        if self._installed_observer is None:
            return
        from ..algos import tpe_device

        try:
            tpe_device._suggest_observers.remove(self._installed_observer)
        except ValueError:
            pass
        self._installed_observer = None


# -- process-wide activation -------------------------------------------
#
# Production call sites (worker.py, file_trials.py) look the monkey up
# through ``sys.modules`` so a run that never imported the chaos harness
# pays one dict miss, not an import.

_active_lock = threading.Lock()
_active_monkey: ChaosMonkey | None = None


def get_active() -> ChaosMonkey | None:
    return _active_monkey


@contextlib.contextmanager
def active(monkey: ChaosMonkey):
    """Make ``monkey`` the process-wide chaos source for the block (and
    register its device-fault observer when configured).  Nested
    activation is refused — overlapping schedules would not be
    reproducible."""
    global _active_monkey
    with _active_lock:
        if _active_monkey is not None:
            raise RuntimeError("a chaos monkey is already active")
        _active_monkey = monkey
    monkey.install_device_faults()
    try:
        yield monkey
    finally:
        monkey.uninstall_device_faults()
        with _active_lock:
            _active_monkey = None
