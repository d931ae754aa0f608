"""The replica plane: leased study ownership across server processes.

Reference parity: ``hyperopt_tpu/service/replicas.py`` — the same class
names, on-disk layout (``<root>/replicas/leases/<study>.lease``,
``<study>.fence``, ``<study>.claimlock``, and
``<root>/replicas/registry/<replica_id>.json``; each file readable by
either package), fencing rules and takeover protocol.  N server
processes share ONE store root — on one card, each its own CUDA context
— and split the tenant population between them (the distributed
asynchronous evaluation model of Bergstra, Yamins & Cox, ICML 2013,
taken from "one Mongo, many workers" to "one store, many serving
replicas").  The pieces:

- :class:`StudyLeaseStore` — per-study **fencing-token heartbeat
  leases** under ``<root>/replicas/leases/``.  A study's suggests and
  reports are served only by its lease holder.  Every claim bumps a
  durable monotonic fence counter (its own file, ``<study>.fence`` —
  never deleted by repair, so tokens stay monotonic across lease-file
  reclamation); every durable write re-verifies ``(owner, fence)``
  immediately before committing, so a frozen-then-resumed holder whose
  study was reclaimed has its stale-fenced writes DROPPED (the trial
  lease's owner re-verify, one level up the stack).
- :class:`ReplicaDirectory` — advisory replica records
  (``<root>/replicas/registry/<replica_id>.json``: url + heartbeat)
  used for owner hints (HTTP 307 redirects) and client discovery.
  Advisory only: the lease fence, not the directory, is the safety
  mechanism.
- :class:`HashRing` — the client-side consistent-hash study→replica
  map (SHA-256 points, virtual nodes).  Shared with
  :class:`~hyperopt_tpu_torch.service.client.ServiceClient` so every
  client routes a study to the same first-choice replica without
  coordination; redirect-on-not-owner corrects the misses.
- :class:`SegmentMirror` — pull-based sealed-segment replication for
  replicas that do not share a root.
- :class:`ReplicaSet` — the per-process manager: claims studies,
  renews all held leases on a heartbeat thread (a renewal that finds
  its fence bumped marks the study LOST and the service relinquishes
  it), and runs a failure detector that adopts a dead replica's
  studies: **claim → fsck-clean → recover → ledger pre-warm → serve**,
  in that order, so a migrating study's first post-failover suggest is
  not a compile event (the takeover replays the shared compile ledger
  and a dry prepare of the study through
  :class:`~hyperopt_tpu_torch.compile_ledger.WarmupDriver`, on the
  service's scheduler thread — the one thread that launches on the
  card).

Exactly-once survives migration because everything that makes replay
byte-identical — the response journal, the seed cursor, the
idempotency keys — lives in the study directory both replicas share:
the adopting replica replays the same journal the dead one wrote.
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
from collections import deque

from ..parallel.file_trials import (
    DocCorrupt,
    _atomic_write,
    _decode_doc,
    _write_doc,
)


def _segment_stats():
    """The process-wide StoreStats (None when observability is off)."""
    from ..parallel.file_trials import store_stats

    return store_stats()


logger = logging.getLogger(__name__)

# Study-ownership lease time-to-live.  Longer than the trial-level
# DEFAULT_LEASE_TTL would suggest: a takeover re-reads a whole study and
# replays its compile grid, so false-positive failovers are expensive —
# the TTL must comfortably exceed heartbeat jitter plus a GC pause.
DEFAULT_REPLICA_LEASE_TTL = 10.0
# A takeover (claim + fsck + recover + pre-warm) slower than this is an
# SL608 MTTR violation — classified at record time so the SLO rule can
# evaluate on counter deltas alone.
DEFAULT_MTTR_BOUND_S = 30.0
# A directory record whose heartbeat is older than ttl * this factor is
# treated as a dead replica for OWNER-HINT purposes (advisory only; the
# lease fence stays the safety mechanism).
DIRECTORY_STALE_FACTOR = 3.0


class OwnershipLost(RuntimeError):
    """This replica's fence for a study is no longer current: the study
    was reclaimed (we were presumed dead).  The write that discovered
    it was DROPPED; the service must relinquish the study and redirect
    the client to the new owner."""

    def __init__(self, study_id, detail=""):
        super().__init__(
            f"ownership of study {study_id!r} lost{': ' if detail else ''}"
            f"{detail}"
        )
        self.study_id = str(study_id)


def _validate_replica_id(replica_id) -> str:
    rid = str(replica_id)
    if not rid or not all(
        c.isalnum() or c in "._-" for c in rid
    ) or not rid[0].isalnum() or len(rid) > 128:
        raise ValueError(
            f"invalid replica_id {replica_id!r}: use 1-128 chars of "
            f"[A-Za-z0-9._-], starting alphanumeric"
        )
    return rid


class StudyLeaseStore:
    """Fencing-token ownership leases, one per study, under
    ``<root>/replicas/leases/``.

    Three files per study:

    - ``<study>.lease`` — the current grant (owner, fence, expiry),
      CRC-trailed like a trial doc (a torn lease reads as "no grant",
      never as garbage ownership);
    - ``<study>.fence`` — the monotonic fence counter, bumped by every
      claim and NEVER deleted by reclamation or repair (deleting it
      would reset tokens and let a stale holder's writes through);
    - ``<study>.claimlock`` — the ``O_CREAT|O_EXCL`` cross-process
      critical section every lease MUTATION runs under (claim, renew,
      release), mirroring the id-allocator lock protocol.

    ``verify`` is deliberately lockless (one file read on the write hot
    path): a write is safe iff the lease still carries our (owner,
    fence), because any competing claim MUST have bumped the fence
    first.  The read→write window is the same deliberately-conservative
    race :mod:`hyperopt_tpu_torch.resilience.leases` documents at the trial
    level; the failure mode it exists to stop — a holder frozen PAST
    the TTL resuming after a reclaim — is fully closed, because the
    reclaim's fence bump happened strictly before the resume.
    """

    # lock-order: _claim_mutex
    def __init__(self, root, ttl=DEFAULT_REPLICA_LEASE_TTL):
        self.root = os.path.abspath(root)
        self.ttl = float(ttl)
        self.leases_dir = os.path.join(self.root, "replicas", "leases")
        os.makedirs(self.leases_dir, exist_ok=True)
        # process-local gate in front of the cross-process claim lock,
        # exactly like FileJobs's id-allocator: threads queue on a cheap
        # mutex instead of contending on the O_EXCL spin loop
        self._claim_mutex = threading.Lock()

    # -- paths ---------------------------------------------------------
    def lease_path(self, study_id):
        from .core import validate_study_id

        return os.path.join(
            self.leases_dir, f"{validate_study_id(study_id)}.lease"
        )

    def fence_path(self, study_id):
        from .core import validate_study_id

        return os.path.join(
            self.leases_dir, f"{validate_study_id(study_id)}.fence"
        )

    def _claim_lock_path(self, study_id):
        from .core import validate_study_id

        return os.path.join(
            self.leases_dir, f"{validate_study_id(study_id)}.claimlock"
        )

    # -- raw reads (lockless) ------------------------------------------
    def read(self, study_id):
        """The lease doc (None when absent or torn — a torn lease is
        "no grant": fsck FS409 quarantines the file, and the fence
        counter, not the lease, carries the safety state)."""
        try:
            with open(self.lease_path(study_id), "rb") as f:
                raw = f.read()
        except (FileNotFoundError, OSError):
            return None
        try:
            return _decode_doc(raw)
        except DocCorrupt:
            return None

    def read_fence(self, study_id) -> int:
        try:
            with open(self.fence_path(study_id)) as f:
                return int(f.read().strip() or 0)
        except (FileNotFoundError, ValueError, OSError):
            return 0

    def is_live(self, lease) -> bool:
        """Does this lease doc currently grant ownership?"""
        if lease is None or not lease.get("owner"):
            return False
        try:
            return float(lease["expires_at"]) > time.time()
        except (KeyError, TypeError, ValueError):
            return False

    def owner_of(self, study_id):
        """``(owner, fence, live)`` — owner may be None (released or
        never claimed)."""
        lease = self.read(study_id)
        if lease is None:
            return None, self.read_fence(study_id), False
        return (
            lease.get("owner"),
            int(lease.get("fence", 0)),
            self.is_live(lease),
        )

    def verify(self, study_id, owner, fence) -> bool:
        """Is ``(owner, fence)`` still the current grant?  THE write-
        path re-verify: called immediately before every durable commit
        of a replica-owned study.  Fence equality (not expiry) is the
        test — an expired-but-unreclaimed lease is still safely ours,
        because any reclaim must bump the fence first."""
        lease = self.read(study_id)
        return (
            lease is not None
            and lease.get("owner") == owner
            and int(lease.get("fence", 0)) == int(fence)
        )

    def study_ids(self):
        """Study ids with any lease state on disk (sorted)."""
        out = set()
        try:
            names = os.listdir(self.leases_dir)
        except OSError:
            return []
        for name in names:
            for suffix in (".lease", ".fence"):
                if name.endswith(suffix):
                    out.add(name[: -len(suffix)])
        return sorted(out)

    # -- the cross-process critical section ----------------------------
    @contextlib.contextmanager
    def _claim_locked(self, study_id, timeout=10.0):  # protocol: lock-break
        lock = self._claim_lock_path(study_id)
        with self._claim_mutex:
            deadline = time.monotonic() + float(timeout)
            while True:
                try:
                    fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    os.close(fd)
                    break
                except FileExistsError:
                    if time.monotonic() > deadline:
                        # a claimant SIGKILL'd inside the critical
                        # section: steal the lock if it is older than
                        # the TTL (fsck FS409 also clears these)
                        try:
                            age = time.time() - os.path.getmtime(lock)
                        except OSError:
                            continue
                        if age > self.ttl:
                            # break the stale lock by renaming it to a
                            # private name first: only ONE breaker wins
                            # the rename, so two claimants that both
                            # judged the lock stale cannot end up
                            # inside the critical section concurrently
                            # (unlinking the shared path directly
                            # could remove a fresh lock another
                            # claimant just re-created — the same race
                            # the segment store's seal-lock break
                            # closed)
                            stale = "%s.stale-%d-%d" % (
                                lock, os.getpid(), time.monotonic_ns()
                            )
                            try:
                                os.rename(lock, stale)  # durability: exempt(lock break: the lock file carries no data; the rename IS the mutual exclusion)
                                os.unlink(stale)
                            except OSError:
                                pass
                            continue
                        raise TimeoutError(
                            f"claim lock stuck for study {study_id!r}: "
                            f"{lock}"
                        )
                    time.sleep(0.005)
            try:
                yield
            finally:
                try:
                    os.unlink(lock)
                except FileNotFoundError:
                    pass

    # -- mutations (all under the claim lock) --------------------------
    def claim(self, study_id, owner, ttl=None):  # protocol: replication-write
        """Claim ownership: the new fence token (int), or None when a
        DIFFERENT replica holds a live lease.  Re-claiming a study we
        already hold renews it and returns the existing fence (no
        bump — our own writes must stay current)."""
        owner = _validate_replica_id(owner)
        ttl = self.ttl if ttl is None else float(ttl)
        with self._claim_locked(study_id):
            lease = self.read(study_id)
            now = time.time()
            if self.is_live(lease):
                if lease.get("owner") != owner:
                    return None
                # already ours: renew in place, same fence
                lease["expires_at"] = now + ttl
                _write_doc(
                    self.lease_path(study_id), lease, fsync_kind="lease"
                )
                return int(lease["fence"])
            # expired, released, torn, or never granted: take over with
            # a bumped fence.  The fence counter is the durable floor —
            # a torn/absent lease file can never hand out a stale token.
            fence = max(
                self.read_fence(study_id),
                int(lease.get("fence", 0)) if lease else 0,
            ) + 1
            _atomic_write(
                self.fence_path(study_id), str(fence).encode(),
                fsync_kind="lease",
            )
            _write_doc(
                self.lease_path(study_id),
                {
                    "study_id": str(study_id),
                    "owner": owner,
                    "fence": fence,
                    "granted_at": now,
                    "expires_at": now + ttl,
                },
                fsync_kind="lease",
            )
            return fence

    def renew(self, study_id, owner, fence, ttl=None) -> bool:
        """Extend the lease iff ``(owner, fence)`` still holds it.
        False means the study was reclaimed — the caller must mark the
        study LOST and drop in-flight results."""
        ttl = self.ttl if ttl is None else float(ttl)
        with self._claim_locked(study_id):
            lease = self.read(study_id)
            if (
                lease is None
                or lease.get("owner") != owner
                or int(lease.get("fence", 0)) != int(fence)
            ):
                return False
            lease["expires_at"] = time.time() + ttl
            _write_doc(
                self.lease_path(study_id), lease, fsync_kind="lease"
            )
            return True

    def release(self, study_id, owner, fence) -> bool:
        """Graceful handover: clear the owner (fence preserved) so a
        successor's claim succeeds immediately instead of waiting out
        the TTL.  No-op unless ``(owner, fence)`` still holds it."""
        with self._claim_locked(study_id):
            lease = self.read(study_id)
            if (
                lease is None
                or lease.get("owner") != owner
                or int(lease.get("fence", 0)) != int(fence)
            ):
                return False
            lease["owner"] = None
            lease["expires_at"] = 0.0
            lease["released_at"] = time.time()
            _write_doc(
                self.lease_path(study_id), lease, fsync_kind="lease"
            )
            return True


class ReplicaDirectory:
    """Advisory replica records under ``<root>/replicas/registry/``.

    One JSON doc per replica (CRC-trailed; a torn record reads as
    absent): ``{replica_id, url, heartbeat_at, pid}``.  The heartbeat
    thread re-stamps it each beat; clients and redirect handlers read
    it for owner hints and discovery.  Advisory ONLY — correctness
    never depends on it (the lease fence does that), so a stale record
    costs at worst one redirect hop.
    """

    def __init__(self, root, ttl=DEFAULT_REPLICA_LEASE_TTL):
        self.root = os.path.abspath(root)
        self.ttl = float(ttl)
        self.registry_dir = os.path.join(self.root, "replicas", "registry")
        # the directory is created on first WRITE (advertise), not
        # here: read-side users (client discovery over a service root,
        # possibly a read-only mount) must not mutate the store layout

    def record_path(self, replica_id):
        return os.path.join(
            self.registry_dir, f"{_validate_replica_id(replica_id)}.json"
        )

    def advertise(self, replica_id, url, compile_cache_dir=None):
        os.makedirs(self.registry_dir, exist_ok=True)
        record = {
            "replica_id": _validate_replica_id(replica_id),
            "url": url,
            "heartbeat_at": time.time(),
            "pid": os.getpid(),
        }
        if compile_cache_dir:
            # the reference's record field; siblings may share the
            # directory (kernel libraries land by os.replace)
            record["compile_cache_dir"] = os.path.abspath(
                compile_cache_dir
            )
        _write_doc(
            self.record_path(replica_id), record, fsync_kind="attachment"
        )

    def withdraw(self, replica_id):
        try:
            os.unlink(self.record_path(replica_id))
        except (FileNotFoundError, OSError):
            pass

    def lookup(self, replica_id):
        try:
            with open(self.record_path(replica_id), "rb") as f:
                raw = f.read()
        except (FileNotFoundError, OSError):
            return None
        try:
            return _decode_doc(raw)
        except DocCorrupt:
            return None

    def is_live(self, record) -> bool:
        if record is None:
            return False
        try:
            age = time.time() - float(record["heartbeat_at"])
        except (KeyError, TypeError, ValueError):
            return False
        return age <= self.ttl * DIRECTORY_STALE_FACTOR

    def url_of(self, replica_id):
        """The advertised URL iff the record looks live (else None)."""
        record = self.lookup(replica_id)
        if self.is_live(record):
            return record.get("url")
        return None

    def replicas(self) -> list:
        """Every parseable record, sorted by replica_id."""
        out = []
        try:
            names = sorted(os.listdir(self.registry_dir))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            record = self.lookup(name[: -len(".json")])
            if record is not None:
                record["live"] = self.is_live(record)
                out.append(record)
        return out


class HashRing:
    """Consistent-hash study→replica routing (SHA-256 points,
    ``n_virtual`` virtual nodes per replica).

    Deterministic in the URL set alone, so every client — and the
    campaign's fault-free twin — maps a study to the same first-choice
    replica with zero coordination.  ``ordered`` returns EVERY distinct
    replica in ring order from the study's point: element 0 is the
    primary, element 1 the failover successor, and so on.
    """

    def __init__(self, urls, n_virtual=64):
        self.urls = sorted(set(str(u).rstrip("/") for u in urls))
        if not self.urls:
            raise ValueError("HashRing needs at least one replica URL")
        points = []
        for url in self.urls:
            for i in range(int(n_virtual)):
                points.append((self._hash(f"{url}#{i}"), url))
        points.sort()
        self._points = points

    @staticmethod
    def _hash(key) -> int:
        return int.from_bytes(
            hashlib.sha256(str(key).encode()).digest()[:8], "big"
        )

    def ordered(self, study_id) -> list:
        """All distinct replica URLs in ring order from the study's
        hash point (primary first)."""
        if len(self.urls) == 1:
            return list(self.urls)
        h = self._hash(study_id)
        points = self._points
        # first point at or after h (wrapping)
        lo, hi = 0, len(points)
        while lo < hi:
            mid = (lo + hi) // 2
            if points[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        out, seen = [], set()
        for i in range(len(points)):
            url = points[(lo + i) % len(points)][1]
            if url not in seen:
                seen.add(url)
                out.append(url)
                if len(out) == len(self.urls):
                    break
        return out

    def primary(self, study_id) -> str:
        return self.ordered(study_id)[0]


def read_discovery(path) -> list:
    """Replica URLs from a discovery source: a JSON file
    (``{"replicas": [url, ...]}`` or a bare list), or a service-root /
    registry directory whose live records supply the URLs."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        root = path
        # accept the service root, <root>/replicas, or the registry dir
        for candidate in (
            path,
            os.path.dirname(os.path.dirname(path)),
            os.path.dirname(path),
        ):
            if os.path.isdir(
                os.path.join(candidate, "replicas", "registry")
            ):
                root = candidate
                break
        directory = ReplicaDirectory(root)
        return [
            r["url"] for r in directory.replicas()
            if r.get("url") and r.get("live")
        ]
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        doc = doc.get("replicas", [])
    return [str(u) for u in doc]


class SegmentMirror:
    """Pull-based sealed-segment replication: the warm-failover data
    plane for replicas that do NOT share a filesystem root.

    A failover target pre-warms a study by pulling the owner's sealed
    segments from ``src_root`` into its own ``dst_root``.  Sealed
    segments are immutable and content-addressed by the manifest
    (name + byte count + CRC), so a pull is a plain byte copy that can
    be verified end-to-end and repeated idempotently — a segment
    already present at the manifest's size is never re-read.

    Cut-point contract (fence-checked):

    1. read the study's fence token from the source replica plane
       (``fence_before``);
    2. snapshot the source manifest read-only and copy every sealed
       entry's committed prefix (exactly ``entry["bytes"]`` bytes,
       CRC-verified against the entry) plus the study's sidecar state
       (config / seed cursor / response journal attachments and the id
       counter);
    3. re-read the fence.  If it moved, ownership changed mid-pull:
       the copied segments are KEPT (immutable, identical under any
       owner) but the manifest snapshot is not published — without a
       manifest the dst store ignores them, and the next pull retries
       from the new cut;
    4. publish the manifest snapshot last, by atomic replace.  The dst
       store now replays a consistent committed prefix of the owner's
       log: every state the owner sealed before the cut, none of its
       in-flight active tail.

    The active segment is never pulled — the owner's graceful handover
    (or the takeover fsck) seals it, which rolls those records into the
    next cut.  ``pull_study`` raises nothing; it returns a summary dict
    with ``ok``/``reason`` so callers can poll it from maintenance
    loops.

    Pulling STOPS once the destination takes over: after a failover the
    claim lives in the destination root's lease plane (the source fence
    never moves again — the owner that would bump it is dead), so a
    pull that kept trusting the source snapshot would overwrite the
    now-live local manifest and sidecars every tick, re-issuing trial
    ids and losing post-takeover records.  ``pull_study`` therefore
    refuses any study that is live-owned at ``dst_root``, and
    ``ReplicaSet`` additionally passes its own ownership set to
    ``pull_all``.
    """

    def __init__(self, src_root, dst_root,
                 ttl=DEFAULT_REPLICA_LEASE_TTL):
        self.src_root = os.path.abspath(src_root)
        self.dst_root = os.path.abspath(dst_root)
        if self.src_root == self.dst_root:
            raise ValueError(
                "SegmentMirror needs distinct roots: pulling a root "
                "into itself would republish its own manifest"
            )
        self.leases = StudyLeaseStore(self.src_root, ttl=ttl)
        self.dst_leases = StudyLeaseStore(self.dst_root, ttl=ttl)

    def _study_dirs(self, study_id):
        src = os.path.join(self.src_root, "studies", str(study_id))
        dst = os.path.join(self.dst_root, "studies", str(study_id))
        return src, dst

    def pull_study(self, study_id) -> dict:  # protocol: replication-write
        from ..parallel import segment_store as sstore
        from ..parallel.file_trials import _read_doc, attachment_filename
        from .core import (
            RESPONSE_JOURNAL_ATTACHMENT,
            SEED_CURSOR_ATTACHMENT,
            STUDY_CONFIG_ATTACHMENT,
        )

        study_id = str(study_id)
        out = {"study": study_id, "ok": False, "n_pulled": 0,
               "nbytes": 0}
        dst_owner, _dst_fence, dst_live = self.dst_leases.owner_of(
            study_id
        )
        if dst_live:
            # the study was taken over here (or by a sibling serving
            # this root): the local copy is now the live truth and the
            # source snapshot is history — overwriting the manifest,
            # journal, seed cursor, and id counter would corrupt it
            out["reason"] = (
                f"study is live-owned at the destination by "
                f"{dst_owner!r}; pull skipped"
            )
            return out
        src_q, dst_q = self._study_dirs(study_id)
        manifest_path = os.path.join(
            src_q, "segments", sstore.MANIFEST_NAME
        )
        fence_before = self.leases.read_fence(study_id)
        # read-only snapshot: never instantiate a SegmentStore on the
        # source — its load path publishes a manifest as a side effect
        manifest = _read_doc(manifest_path, quarantine=False)
        if manifest is None:
            out["reason"] = "no readable source manifest (not segmented?)"
            return out
        os.makedirs(os.path.join(dst_q, "segments"), exist_ok=True)
        n_pulled = 0
        nbytes = 0
        for entry in manifest.get("sealed", ()):
            try:
                name = str(entry["name"])
                limit = int(entry["bytes"])
            except (KeyError, TypeError, ValueError):
                out["reason"] = "malformed sealed entry in manifest"
                return out
            if os.path.sep in name or name == sstore.MANIFEST_NAME:
                out["reason"] = f"unsafe segment name {name!r}"
                return out
            dst_path = os.path.join(dst_q, "segments", name)
            try:
                if os.path.getsize(dst_path) == limit:
                    continue  # immutable once sealed: already mirrored
            except OSError:
                pass
            try:
                with open(os.path.join(src_q, "segments", name),
                          "rb") as f:
                    raw = f.read(limit)
            except OSError:
                out["reason"] = f"sealed segment {name} unreadable"
                return out
            want_crc = entry.get("crc32")
            got_crc = "%08x" % (zlib.crc32(raw) & 0xFFFFFFFF)
            if len(raw) != limit or (want_crc and want_crc != got_crc):
                out["reason"] = (
                    f"sealed segment {name} fails its manifest CRC "
                    "(concurrent compaction? retry next tick)"
                )
                return out
            _atomic_write(dst_path, raw, fsync_kind="segment")
            n_pulled += 1
            nbytes += len(raw)
        # sidecar state a takeover needs to resume deterministically:
        # study config, seed cursor, response journal, id counter
        sidecars = [
            os.path.join(
                "attachments", attachment_filename(key)
            )
            for key in (
                STUDY_CONFIG_ATTACHMENT,
                SEED_CURSOR_ATTACHMENT,
                RESPONSE_JOURNAL_ATTACHMENT,
            )
        ]
        sidecars.append("ids.counter")
        for rel in sidecars:
            try:
                with open(os.path.join(src_q, rel), "rb") as f:
                    raw = f.read()
            except OSError:
                continue  # absent sidecars are normal (fresh study)
            dst_path = os.path.join(dst_q, rel)
            try:
                with open(dst_path, "rb") as f:
                    if f.read() == raw:
                        continue  # byte-identical: nothing to publish
            except OSError:
                pass
            os.makedirs(os.path.dirname(dst_path), exist_ok=True)
            _atomic_write(dst_path, raw, fsync_kind="attachment")  # durability: exempt(single-writer: one mirror pulls into its own root; the read is only an identical-bytes skip)
            nbytes += len(raw)
        fence_after = self.leases.read_fence(study_id)
        if fence_after != fence_before:
            out["reason"] = (
                f"fence moved {fence_before}->{fence_after} mid-pull; "
                "segments kept, manifest withheld"
            )
            return out
        dst_manifest_path = os.path.join(
            dst_q, "segments", sstore.MANIFEST_NAME
        )
        if _read_doc(dst_manifest_path, quarantine=False) != manifest:
            _write_doc(dst_manifest_path, manifest, fsync_kind="segment")
        stats = _segment_stats()
        if stats is not None:
            stats.record_segment_pull(n_pulled, nbytes)
        out.update(
            ok=True,
            n_pulled=n_pulled,
            nbytes=nbytes,
            fence=fence_before,
            epoch=int(manifest.get("epoch", 0)),
            n_sealed=len(manifest.get("sealed", ())),
        )
        return out

    def pull_all(self, skip=None) -> list:
        """Pull every study visible at the source; returns the per-study
        summaries (mirroring is advisory — failures surface as
        ``ok=False`` reasons, never exceptions).  ``skip`` is an
        optional ``skip(study_id) -> bool`` predicate — the replica set
        passes its own ownership check so studies it serves are never
        pulled over (``pull_study`` independently refuses any study
        live-owned at the destination root)."""
        studies_dir = os.path.join(self.src_root, "studies")
        try:
            names = sorted(os.listdir(studies_dir))
        except OSError:
            return []
        out = []
        for study_id in names:
            if not os.path.isdir(os.path.join(studies_dir, study_id)):
                continue
            if skip is not None and skip(study_id):
                continue
            try:
                out.append(self.pull_study(study_id))
            except Exception:
                logger.exception(
                    "segment pull failed for study %r", study_id
                )
                out.append(
                    {"study": study_id, "ok": False,
                     "reason": "unexpected error (see log)"}
                )
        return out


class ReplicaStats:
    """Counters + bounded takeover log for the replica plane — the
    ``/metrics`` gauge source and the SL608 failover-MTTR feed."""

    # lock-order: _lock
    def __init__(self, mttr_bound_s=DEFAULT_MTTR_BOUND_S):
        self.mttr_bound_s = float(mttr_bound_s)
        self._lock = threading.Lock()
        self._counts = {}  # guarded-by: _lock
        self._takeovers = deque(maxlen=64)  # guarded-by: _lock

    def record(self, event, n=1):
        with self._lock:
            self._counts[event] = self._counts.get(event, 0) + int(n)

    def get(self, event) -> int:
        with self._lock:
            return self._counts.get(event, 0)

    def record_takeover(self, record: dict):
        """One completed (or failed) takeover.  ``record`` carries
        study_id/from_owner/fence/duration_s/fsck_clean/prewarm/ok;
        slowness is classified HERE against ``mttr_bound_s`` so SL608
        evaluates on counter deltas alone."""
        with self._lock:
            self._takeovers.append(dict(record))
            self._counts["takeover"] = self._counts.get("takeover", 0) + 1
            if not record.get("ok", True):
                self._counts["takeover_failed"] = (
                    self._counts.get("takeover_failed", 0) + 1
                )
            elif record.get("duration_s", 0.0) > self.mttr_bound_s:
                self._counts["takeover_slow"] = (
                    self._counts.get("takeover_slow", 0) + 1
                )

    def takeovers(self) -> list:
        with self._lock:
            return [dict(r) for r in self._takeovers]

    def slo_counters(self) -> dict:
        """The scalar counters the SLO engine snapshots per tick (the
        SL608 numerator/denominator)."""
        with self._lock:
            return {
                "replica_takeovers": self._counts.get("takeover", 0),
                "replica_takeovers_slow": self._counts.get(
                    "takeover_slow", 0
                ),
                "replica_takeovers_failed": self._counts.get(
                    "takeover_failed", 0
                ),
                "replica_stale_writes_dropped": self._counts.get(
                    "stale_write_dropped", 0
                ),
            }

    def summary(self) -> dict:
        with self._lock:
            return {
                "counts": dict(sorted(self._counts.items())),
                "mttr_bound_s": self.mttr_bound_s,
                "recent_takeovers": [dict(r) for r in self._takeovers],
            }


class OwnershipHandle:
    """One study's ownership credential on its serving replica.

    Attached to :class:`~hyperopt_tpu_torch.service.core.Study`; the commit
    paths call :meth:`verify` immediately before every durable write.
    ``lost`` latches when a heartbeat renewal discovers the fence was
    bumped — verifies then fail without a disk read."""

    __slots__ = ("replica_set", "study_id", "fence", "_lost")

    def __init__(self, replica_set: "ReplicaSet", study_id, fence):
        self.replica_set = replica_set
        self.study_id = str(study_id)
        self.fence = int(fence)
        self._lost = threading.Event()

    @property
    def lost(self) -> bool:
        return self._lost.is_set()

    def mark_lost(self):
        self._lost.set()

    def verify(self):
        """Raise :class:`OwnershipLost` unless this replica still holds
        the study at this fence — the stale-fenced-write drop."""
        if self._lost.is_set() or not self.replica_set.leases.verify(
            self.study_id, self.replica_set.replica_id, self.fence
        ):
            self._lost.set()
            self.replica_set.stats.record("stale_write_dropped")
            raise OwnershipLost(
                self.study_id,
                detail=f"fence {self.fence} superseded",
            )


class ReplicaSet:
    """The per-process replica manager: identity, held leases, the
    heartbeat, and the dead-replica failure detector.

    The service binds itself via :meth:`bind` (adopt + relinquish
    callbacks) and then :meth:`start` launches two daemon threads:

    - **heartbeat** (ttl/3 cadence): advertise the directory record,
      renew every held lease; a renewal that finds its fence bumped
      marks the study LOST and relinquishes it from serving (its
      in-flight writes drop at their own verify).  The chaos harness's
      ``lease_stall`` site freezes this thread past the TTL to model a
      stop-the-world-paused holder.
    - **reaper** (ttl/4 cadence): scan the shared root for studies
      whose lease is expired, released, or absent and adopt them
      through the service callback (claim → fsck → recover → pre-warm
      → serve).  Fencing makes double-adoption impossible: the claim
      is the linearization point.
    """

    # lock-order: _lock
    def __init__(self, root, replica_id, url=None,
                 ttl=DEFAULT_REPLICA_LEASE_TTL, stats=None,
                 mttr_bound_s=DEFAULT_MTTR_BOUND_S):
        self.root = os.path.abspath(root)
        self.replica_id = _validate_replica_id(replica_id)
        self.url = url
        self.ttl = float(ttl)
        self.leases = StudyLeaseStore(self.root, ttl=self.ttl)
        self.directory = ReplicaDirectory(self.root, ttl=self.ttl)
        self.compile_cache_dir = None  # advertised when the service sets it
        self.mirror = None  # optional SegmentMirror (pulled each reap tick)
        self.stats = (
            stats if stats is not None
            else ReplicaStats(mttr_bound_s=mttr_bound_s)
        )
        self._lock = threading.Lock()
        self._owned = {}  # guarded-by: _lock  (study_id -> OwnershipHandle)
        self._adopt = None  # service callback: adopt(study_id, reason)
        self._relinquish = None  # service callback: relinquish(study_id)
        self._stop = threading.Event()
        self._hb_thread = None
        self._reap_thread = None
        self._closed = False  # guarded-by: _lock
        # study_id -> (fail_count, earliest-next-attempt monotonic);
        # an unrecoverable study (takeover keeps failing) is retried
        # with capped exponential backoff instead of fence-bumping +
        # re-fscking it on every reaper tick AND every client request
        # that misses the registry
        self._adopt_retry = {}  # guarded-by: _lock

    # -- service binding ------------------------------------------------
    def bind(self, adopt, relinquish):
        """Install the service's adopt/relinquish callbacks (must happen
        before :meth:`start`)."""
        self._adopt = adopt
        self._relinquish = relinquish
        return self

    def set_url(self, url):
        self.url = url

    # -- ownership ------------------------------------------------------
    def try_claim(self, study_id):
        """Claim ``study_id`` and register the handle; None when another
        replica holds it live."""
        fence = self.leases.claim(study_id, self.replica_id)
        if fence is None:
            return None
        handle = OwnershipHandle(self, study_id, fence)
        with self._lock:
            self._owned[str(study_id)] = handle
        self.stats.record("claim")
        return handle

    def owns(self, study_id) -> bool:
        with self._lock:
            handle = self._owned.get(str(study_id))
        return handle is not None and not handle.lost

    def handle_of(self, study_id):
        with self._lock:
            return self._owned.get(str(study_id))

    def owned_studies(self) -> list:
        with self._lock:
            return sorted(
                sid for sid, h in self._owned.items() if not h.lost
            )

    def drop(self, study_id):
        """Forget a study (after relinquish or a failed adopt) without
        touching the lease on disk."""
        with self._lock:
            self._owned.pop(str(study_id), None)

    def release_all(self):
        """Graceful handover on close: release every held lease (fence
        preserved) so a successor claims instantly."""
        with self._lock:
            owned = list(self._owned.items())
            self._owned.clear()
        for study_id, handle in owned:
            if handle.lost:
                continue
            try:
                self.leases.release(
                    study_id, self.replica_id, handle.fence
                )
                self.stats.record("release")
            except OSError:
                logger.warning(
                    "could not release lease for %r", study_id,
                    exc_info=True,
                )

    def owner_hint(self, study_id):
        """``(owner_id, owner_url)`` for a study another replica holds
        (url None when the owner has no live directory record)."""
        owner, _fence, live = self.leases.owner_of(study_id)
        if not owner or not live or owner == self.replica_id:
            return None, None
        return owner, self.directory.url_of(owner)

    # -- heartbeat ------------------------------------------------------
    def _heartbeat_once(self):
        try:
            self.directory.advertise(
                self.replica_id, self.url,
                compile_cache_dir=self.compile_cache_dir,
            )
        except OSError:
            logger.warning("replica advertise failed", exc_info=True)
        self.stats.record("heartbeat")
        with self._lock:
            owned = list(self._owned.items())
        for study_id, handle in owned:
            if handle.lost:
                continue
            try:
                ok = self.leases.renew(
                    study_id, self.replica_id, handle.fence
                )
            except (OSError, TimeoutError):
                logger.warning(
                    "lease renewal errored for %r", study_id,
                    exc_info=True,
                )
                continue  # transient: the TTL absorbs one missed beat
            if not ok:
                # reclaimed out from under us: we were presumed dead.
                # Drop serving immediately; queued writes fall to their
                # own fence verify.
                handle.mark_lost()
                self.stats.record("renew_lost")
                logger.warning(
                    "lease for study %r was reclaimed (fence %d "
                    "superseded); relinquishing", study_id, handle.fence,
                )
                if self._relinquish is not None:
                    try:
                        self._relinquish(study_id)
                    except Exception:
                        logger.exception(
                            "relinquish callback failed for %r", study_id
                        )

    def _heartbeat_loop(self):
        interval = max(self.ttl / 3.0, 0.05)
        while not self._stop.wait(interval):
            monkey = _active_chaos()
            if monkey is not None:
                stall = monkey.maybe_lease_stall(self.replica_id)
                if stall > 0.0:
                    # a frozen holder: NO renewals for the stall (the
                    # stop event still honors close)
                    self._stop.wait(stall)
                    continue
            try:
                self._heartbeat_once()
            except Exception:
                logger.exception("replica heartbeat failed; continuing")

    # -- failure detector -----------------------------------------------
    def reap_once(self) -> int:
        """One adoption scan: claim every study whose lease is expired,
        released, or absent (including studies that have never been
        claimed — a pre-replica root being upgraded in place).  Returns
        the number of studies adopted."""
        if self._adopt is None:
            return 0
        studies_dir = os.path.join(self.root, "studies")
        try:
            names = sorted(os.listdir(studies_dir))
        except OSError:
            return 0
        n = 0
        with self._lock:
            self._adopt_retry = {
                k: v for k, v in self._adopt_retry.items()
                if k in names
            }
        for study_id in names:
            if not os.path.isdir(os.path.join(studies_dir, study_id)):
                continue
            if self.owns(study_id):
                continue
            lease = self.leases.read(study_id)
            if self.leases.is_live(lease):
                continue  # someone (possibly a past us) holds it
            if not self.adoption_should_attempt(study_id):
                continue  # recent takeover failure: still backing off
            reason = (
                "unclaimed" if lease is None or not lease.get("owner")
                else "expired"
            )
            try:
                if self._adopt(study_id, reason):
                    n += 1
            except Exception:
                # the service's adopt callback records its own failures
                # (and never raises); a raising callback still gets the
                # backoff so the reaper can't hot-loop it
                logger.exception("adoption of study %r failed", study_id)
                self.adoption_result(study_id, False)
        return n

    def adoption_should_attempt(self, study_id) -> bool:
        """False while ``study_id`` is inside the failed-takeover
        backoff window — consulted by the reaper AND the on-demand
        (request-path) adoption, so N clients polling one broken study
        cannot re-run fsck + recovery + a fence bump per request."""
        with self._lock:
            _fails, not_before = self._adopt_retry.get(
                str(study_id), (0, 0.0)
            )
        return time.monotonic() >= not_before

    def adoption_result(self, study_id, ok):
        """Record a takeover outcome: success clears the backoff,
        failure doubles it (capped)."""
        with self._lock:
            if ok:
                self._adopt_retry.pop(str(study_id), None)
                return
            fails, _ = self._adopt_retry.get(str(study_id), (0, 0.0))
            fails += 1
            delay = min(self.ttl * (2.0 ** min(fails, 8)), 300.0)
            self._adopt_retry[str(study_id)] = (
                fails, time.monotonic() + delay
            )

    def attach_mirror(self, mirror):
        """Install a :class:`SegmentMirror` pulled on every reaper tick,
        so an eventual takeover starts from an already-warm local copy
        of every sealed segment."""
        self.mirror = mirror
        return self

    def _reap_loop(self):
        interval = max(self.ttl / 4.0, 0.05)
        while not self._stop.wait(interval):
            if self.mirror is not None:
                try:
                    # never pull over a study this replica serves: after
                    # a takeover the source snapshot is stale history
                    self.mirror.pull_all(skip=self.owns)
                except Exception:
                    logger.exception(
                        "segment mirror pull failed; continuing"
                    )
            try:
                self.reap_once()
            except Exception:
                logger.exception("replica reaper scan failed; continuing")

    # -- lifecycle ------------------------------------------------------
    def start(self):
        with self._lock:
            if self._closed or self._hb_thread is not None:
                return self
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name=f"hyperopt-replica-heartbeat-{self.replica_id}",
                daemon=True,
            )
            self._reap_thread = threading.Thread(
                target=self._reap_loop,
                name=f"hyperopt-replica-reaper-{self.replica_id}",
                daemon=True,
            )
        # first advertise + renewals synchronously, so the directory
        # record exists before any client asks for owner hints
        try:
            self._heartbeat_once()
        except Exception:
            logger.exception("initial replica heartbeat failed")
        self._hb_thread.start()
        self._reap_thread.start()
        return self

    def close(self, release=True):
        with self._lock:
            self._closed = True
        self._stop.set()
        for t in (self._hb_thread, self._reap_thread):
            if t is not None and t.is_alive():
                t.join(timeout=5.0)
        if release:
            self.release_all()
            try:
                self.directory.withdraw(self.replica_id)
            except OSError:
                pass

    def status(self) -> dict:
        return {
            "replica_id": self.replica_id,
            "url": self.url,
            "ttl": self.ttl,
            "owned_studies": self.owned_studies(),
            "directory": self.directory.replicas(),
            "stats": self.stats.summary(),
        }


def _active_chaos():
    """The process-wide chaos monkey (None when the harness was never
    loaded) — same zero-cost lookup the store uses."""
    from ..parallel.file_trials import _active_chaos as impl

    return impl()
