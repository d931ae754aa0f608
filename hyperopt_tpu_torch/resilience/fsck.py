"""fsck for the durable trial store: detect and repair crash damage.

Reference parity: ``hyperopt_tpu/resilience/fsck.py``; a queue or a
service root (its replica plane included) either package wrote is
checked and repaired the same way by either.  ``kill -9``, torn disk
writes and writers that died mid-operation leave a queue directory (or
a whole optimization-service root) in states the happy path never
produces; this is the offline checker and repairer::

    python -m hyperopt_tpu_torch.resilience.fsck <queue>            # dry run
    python -m hyperopt_tpu_torch.resilience.fsck <queue> --repair   # fix it

Rule catalog (the reference's stable ids):

========  ==============================================================
FS401     torn/corrupt trial doc (fails its length+CRC32 trailer or does
          not parse).  Repair: quarantine to ``<doc>.corrupt``; if the
          queue's response journal holds the doc, restore it.
FS402     orphan lease (no trial doc, or the doc is not RUNNING).
          Repair: delete the lease file.
FS403     orphan/stale lock (no trial doc, or the doc is in a state that
          cannot legitimately hold a reservation: NEW/DONE/ERROR).
          Repair: delete the lock file.
FS404     duplicate/mismatched tid (the doc's internal ``tid`` does not
          match its filename).  Repair: quarantine the mismatched file.
FS405     stale seed-cursor attachment (the cursor is BEHIND the highest
          draw position evidenced by docs/journal).  Repair: advance it.
FS406     tmp droppings (``*.tmp.*`` files from a writer killed between
          ``open`` and ``os.replace``).  Repair: delete.
FS407     torn response-journal record (a line failing its CRC).
          Repair: rewrite the journal keeping only the valid records.
FS408     broken id allocator: a stuck ``ids.counter.lock``, or an
          empty/regressed ``ids.counter`` at or below the highest tid on
          disk.  Repair: delete the stuck lock / advance the counter.
FS410     torn segment record(s) in the segmented trial store (inside a
          sealed segment's byte range, or a torn final append on the
          active segment).  Repair: rewrite the segment keeping only
          valid records (and update a sealed one's manifest entry).
FS411     manifest/segment mismatch (missing or corrupt manifest, a
          sealed entry naming a missing file, a sealed range longer than
          its file, or a sealed range whose CRC moved).  Repair: rebuild,
          drop, re-pin or recompute.
FS412     orphaned segment file (referenced by neither the manifest's
          sealed list nor its active pointer).  Repair: re-home any acked
          records it alone holds, then delete.
========  ==============================================================

FS409     replica-plane damage under ``<root>/replicas/``: an orphaned
          study-ownership lease (no study directory AND not live — a live
          one is the mid-create window), an expired lease still naming a
          dead owner (past one extra TTL of grace, so a briefly-stalled
          live holder is never fenced by a sibling's startup fsck), a torn
          lease or registry record, a stuck ``.claimlock`` (past an age
          grace no live claimant can reach), or a garbled fence counter.
          Repair: delete orphans and stuck locks, reclaim expired leases
          (owner cleared, **fence preserved**), quarantine torn leases,
          delete torn records, and rewrite a garbled fence counter past
          the highest evidenced token.

FS405 and FS407 read the optimization service's seed-cursor attachment
and response journal, which live in the queue directory (their names and
format are the reference's).  :func:`fsck_service_root` checks every
study queue under a service root's ``studies/`` and the replica plane.

Offline by design: run it on a queue no process is writing.  The FS409
rules are the one exception forced to tolerate liveness: every replica's
STARTUP fsck repairs the shared root while its siblings serve, so those
rules gate on lease liveness and age before touching anything.  Repairs
are individually crash-safe (atomic rename/replace or unlink).
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time
import zlib as _zlib
from dataclasses import dataclass, field

from .. import journal_io, tracing
from ..base import (
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_RUNNING,
    STATUS_FAIL,
)
from ..parallel import segment_store as sstore
from ..parallel.file_trials import (
    DocCorrupt,
    _atomic_write,
    _decode_doc,
    _json_default,
    _json_object_hook,
    _read_doc,
    _write_doc,
    attachment_filename,
    quarantine_path,
)

# states that can legitimately hold a reservation lock
_LOCKABLE_STATES = (JOB_STATE_RUNNING,)

# the optimization service's attachments in a study's queue directory
# (the reference's names, ``hyperopt_tpu/service/core.py:87-91``)
SEED_CURSOR_ATTACHMENT = "ServiceSeedCursor"
RESPONSE_JOURNAL_ATTACHMENT = "ServiceResponseJournal.jsonl"

# a .claimlock younger than this may be a live peer inside the
# O_CREAT|O_EXCL critical section (the claim path itself steals locks
# older than the store TTL; fsck can't know the TTL, so it uses a
# ceiling no live claimant can reach)
FS409_CLAIMLOCK_GRACE_S = 60.0


@dataclass
class Finding:
    rule: str
    path: str
    detail: str
    repaired: bool = False
    action: str = ""

    def format(self) -> str:
        mark = "FIXED" if self.repaired else "FOUND"
        out = f"[{self.rule}] {mark} {self.path}: {self.detail}"
        if self.action:
            out += f" -> {self.action}"
        return out


@dataclass
class FsckReport:
    root: str
    repair: bool
    findings: list = field(default_factory=list)
    n_docs: int = 0
    n_queues: int = 0

    def add(self, rule, path, detail, repaired=False, action=""):
        self.findings.append(
            Finding(rule, path, detail, repaired=repaired, action=action)
        )

    @property
    def n_unrepaired(self) -> int:
        return sum(1 for f in self.findings if not f.repaired)

    @property
    def clean(self) -> bool:
        """True when the store is consistent NOW: either nothing was
        found, or everything found was repaired."""
        return self.n_unrepaired == 0

    def by_rule(self) -> dict:
        out = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))

    def summary(self) -> dict:
        return {
            "root": self.root,
            "repair": self.repair,
            "clean": self.clean,
            "n_queues": self.n_queues,
            "n_docs": self.n_docs,
            "n_findings": len(self.findings),
            "n_unrepaired": self.n_unrepaired,
            "by_rule": self.by_rule(),
            "findings": [
                {
                    "rule": f.rule, "path": f.path, "detail": f.detail,
                    "repaired": f.repaired, "action": f.action,
                }
                for f in self.findings
            ],
        }

    def format(self) -> str:
        lines = [
            f"fsck {self.root}: {self.n_queues} queue(s), "
            f"{self.n_docs} doc(s), {len(self.findings)} finding(s)"
            + ("" if self.clean else f", {self.n_unrepaired} UNREPAIRED")
        ]
        lines.extend(f.format() for f in self.findings)
        lines.append("clean" if self.clean else "NOT CLEAN")
        return "\n".join(lines)


def _tid_from_name(name, suffix):
    stem = os.path.basename(name)
    if not stem.endswith(suffix):
        return None
    try:
        return int(stem[: -len(suffix)])
    except ValueError:
        return None


def _attachment_path(qdir, key):
    return os.path.join(qdir, "attachments", attachment_filename(key))


def _journal_path(qdir):
    return _attachment_path(qdir, RESPONSE_JOURNAL_ATTACHMENT)


def _load_journal(qdir):
    """(entries, n_torn, path) for the study's response journal (empty
    when none exists).  Lines that fail their CRC or do not parse count
    as torn."""
    path = _journal_path(qdir)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return [], 0, path
    entries, torn = journal_io.read_records_bytes(raw, object_hook=_json_object_hook)
    entries.sort(key=lambda e: int(e.get("seq", 0)))
    return entries, torn, path


def _rebuild_manifest(sdir, seg_paths, parse, object_hook):
    """A best-effort manifest from the segment files alone: every
    segment but the last (by sequence) sealed at its valid prefix, the
    last one active.  Epoch 1 so any cached reader does a full replay."""
    names = sorted(os.path.basename(p) for p in seg_paths)
    sealed = []
    for name in names[:-1]:
        try:
            with open(os.path.join(sdir, name), "rb") as f:
                raw = f.read()
        except OSError:
            continue
        records, consumed, _, _ = parse(raw, object_hook=object_hook)
        sealed.append({
            "name": name,
            "bytes": consumed,
            "records": len(records),
            "crc32": "%08x" % (_zlib.crc32(raw[:consumed]) & 0xFFFFFFFF),
        })
    active = names[-1] if names else sstore.segment_name(1)
    try:
        next_seq = int(active[4:12]) + 1
    except ValueError:
        next_seq = len(names) + 1
    return {
        "version": 1,
        "epoch": 1,
        "next_seq": next_seq,
        "active": active,
        "sealed": sealed,
    }


def _fsck_segments(qdir, repair, report: FsckReport) -> dict:  # protocol: orphan-sweep
    """FS410/FS411/FS412 over ``<qdir>/segments``; returns the replayed
    {tid: doc} view so the lease/lock/cursor/counter rules see segment-
    stored trials exactly like per-doc ones.  Empty dict when the queue
    is not segmented."""
    sdir = os.path.join(qdir, "segments")
    manifest_path = os.path.join(sdir, sstore.MANIFEST_NAME)
    seg_paths = sorted(glob.glob(os.path.join(sdir, sstore.SEGMENT_GLOB)))
    have_manifest = os.path.exists(manifest_path)
    if not (have_manifest or seg_paths):
        return {}
    parse = sstore.parse_segment_chunk

    manifest = (
        _read_doc(manifest_path, quarantine=False) if have_manifest else None
    )
    if manifest is None:
        # FS411: segment files with no (readable) manifest — recovery
        # cannot know the replay order or sealed byte ranges
        rebuilt = _rebuild_manifest(sdir, seg_paths, parse, _json_object_hook)
        fixed = False
        action = ""
        if repair:
            try:
                if have_manifest:
                    dest = quarantine_path(manifest_path)
                    os.replace(manifest_path, dest)
                    action = f"quarantined to {os.path.basename(dest)}; "
                # durability: exempt(offline repair: fsck runs single-writer against a stopped queue)
                _write_doc(manifest_path, rebuilt, fsync_kind="segment")
                fixed = True
                action += (
                    f"rebuilt manifest from {len(seg_paths)} segment "
                    f"file(s)"
                )
            except OSError:
                pass
        report.add(
            "FS411", manifest_path,
            "corrupt segment manifest" if have_manifest
            else "segment files without a manifest",
            repaired=fixed, action=action,
        )
        manifest = rebuilt  # replay from the in-memory rebuild either way

    view = {}
    sealed_out = []
    manifest_dirty = False
    for entry in manifest.get("sealed", ()):
        name = entry.get("name", "")
        path = os.path.join(sdir, name)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            # FS411: the manifest promises a sealed segment that is gone
            manifest_dirty = manifest_dirty or repair
            report.add(
                "FS411", path,
                f"manifest references missing sealed segment {name!r}",
                repaired=repair,
                action="dropped manifest entry" if repair else "",
            )
            continue
        limit = int(entry.get("bytes", 0))
        short = len(raw) < limit
        chunk = raw[:limit]
        records, consumed, torn, pending = parse(
            chunk, object_hook=_json_object_hook
        )
        # a sealed segment is immutable: a trailing-invalid line cannot
        # be an in-flight append — it is torn
        n_torn = torn + pending
        entry = dict(entry)
        if short:
            fixed = False
            if repair:
                entry["bytes"] = consumed
                entry["records"] = len(records)
                entry["crc32"] = "%08x" % (
                    _zlib.crc32(raw[:consumed]) & 0xFFFFFFFF
                )
                manifest_dirty = True
                fixed = True
            report.add(
                "FS411", path,
                f"sealed segment shorter than its manifest entry "
                f"({len(raw)} < {limit} bytes)",
                repaired=fixed,
                action=(f"re-pinned entry to valid prefix ({consumed} "
                        f"bytes, {len(records)} records)") if fixed else "",
            )
        elif n_torn:
            # FS410: torn record(s) inside the sealed range
            fixed = False
            action = ""
            if repair:
                blob = b"".join(
                    journal_io.frame_record(r, default=_json_default)
                    for r in records
                )
                try:
                    # durability: exempt(offline repair: fsck runs single-writer against a stopped queue)
                    _atomic_write(path, blob, fsync_kind="segment")
                    entry["bytes"] = len(blob)
                    entry["records"] = len(records)
                    entry["crc32"] = "%08x" % (
                        _zlib.crc32(blob) & 0xFFFFFFFF
                    )
                    manifest_dirty = True
                    fixed = True
                    action = (
                        f"rewrote segment keeping {len(records)} valid "
                        f"record(s)"
                    )
                except OSError:
                    pass
            report.add(
                "FS410", path,
                f"{n_torn} torn record(s) in sealed segment",
                repaired=fixed, action=action,
            )
        elif entry.get("crc32") and entry["crc32"] != (
            "%08x" % (_zlib.crc32(chunk) & 0xFFFFFFFF)
        ):
            # parseable but the sealed-range CRC moved: in-place rot
            fixed = False
            if repair:
                entry["crc32"] = "%08x" % (_zlib.crc32(chunk) & 0xFFFFFFFF)
                manifest_dirty = True
                fixed = True
            report.add(
                "FS411", path,
                "sealed-range CRC does not match its manifest entry",
                repaired=fixed,
                action="recomputed entry CRC" if fixed else "",
            )
        sealed_out.append(entry)
        for rec in records:
            view[int(rec["tid"])] = rec

    active = manifest.get("active")
    if active:
        path = os.path.join(sdir, active)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            raw = None  # an active segment not yet appended to is normal
        if raw is not None:
            records, consumed, torn, pending = parse(
                raw, object_hook=_json_object_hook
            )
            # offline there is no in-flight appender: a pending trailing
            # line is a torn final append
            n_torn = torn + pending
            if n_torn:
                fixed = False
                action = ""
                if repair:
                    blob = b"".join(
                        journal_io.frame_record(r, default=_json_default)
                        for r in records
                    )
                    try:
                        # durability: exempt(offline repair: fsck runs single-writer against a stopped queue)
                        _atomic_write(path, blob, fsync_kind="segment")
                        fixed = True
                        action = (
                            f"rewrote active segment keeping "
                            f"{len(records)} valid record(s)"
                        )
                    except OSError:
                        pass
                report.add(
                    "FS410", path,
                    f"{n_torn} torn record(s) at active segment tail",
                    repaired=fixed, action=action,
                )
            for rec in records:
                view[int(rec["tid"])] = rec

    # FS412: segment files referenced by neither sealed list nor active
    referenced = {e["name"] for e in sealed_out} | {
        e.get("name") for e in manifest.get("sealed", ())
    }
    if active:
        referenced.add(active)
    for path in seg_paths:
        if os.path.basename(path) in referenced:
            continue
        # an orphan can hold ACKED records that exist nowhere else: an
        # appender whose post-append manifest check ran before the
        # compactor's swap left fsync'd records in the old active, and
        # a compactor killed after the swap but before re-homing the
        # stragglers never copied them forward.  Fold the orphan
        # latest-wins per tid and re-home anything the replayed view
        # does not already supersede before deleting the file.
        orphan_latest = {}
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            raw = b""
        if raw:
            records, _consumed, _torn, _pending = parse(
                raw, object_hook=_json_object_hook
            )
            for rec in records:
                orphan_latest[int(rec["tid"])] = rec
        stragglers = []
        for tid in sorted(orphan_latest):
            rec = orphan_latest[tid]
            have = view.get(tid)
            if have is None or (
                rec != have
                and int(rec.get("state", 0)) >= int(have.get("state", 0))
            ):
                stragglers.append(rec)
        fixed = False
        action = ""
        if repair and (active or not stragglers):
            try:
                if stragglers:
                    # durability: exempt(offline repair: fsck runs single-writer against a stopped queue)
                    journal_io.append_records(
                        os.path.join(sdir, active), stragglers,
                        default=_json_default, fsync_kind="segment",
                    )
                    for rec in stragglers:
                        view[int(rec["tid"])] = rec
                os.unlink(path)
                fixed = True
                action = (
                    f"re-homed {len(stragglers)} acked record(s) to "
                    f"{active}; deleted"
                ) if stragglers else "deleted"
            except OSError:
                pass
        msg = "orphaned segment file (compactor killed before retiring it)"
        if stragglers:
            msg += (
                f"; holds {len(stragglers)} acked record(s) absent from "
                "the replayed view"
            )
        report.add("FS412", path, msg, repaired=fixed, action=action)

    if repair and manifest_dirty:
        manifest = dict(manifest)
        manifest["sealed"] = sealed_out
        # bump the epoch: cached readers must full-replay the repaired
        # lineage instead of trusting pinned offsets into rewritten files
        manifest["epoch"] = int(manifest.get("epoch", 0)) + 1
        try:
            # durability: exempt(offline repair: fsck runs single-writer against a stopped queue)
            _write_doc(manifest_path, manifest, fsync_kind="segment")
        except OSError:
            pass
    return view


def fsck_queue(qdir, repair=False, report: FsckReport = None) -> FsckReport:
    """Check (and optionally repair) ONE FileTrials queue directory."""
    qdir = os.path.abspath(qdir)
    if report is None:
        report = FsckReport(root=qdir, repair=repair)
    report.n_queues += 1

    entries, n_torn, journal_file = _load_journal(qdir)
    journal_docs = {}  # tid -> (doc, draw_index) recoverable from journal
    journal_results = {}  # tid -> result from journaled reports
    max_journal_draw = 0
    for entry in entries:
        if entry.get("kind") == "suggest":
            max_journal_draw = max(
                max_journal_draw, int(entry.get("draw_index", 0))
            )
            for doc in entry.get("docs") or []:
                journal_docs[int(doc["tid"])] = (
                    doc, entry.get("draw_index")
                )
        elif entry.get("kind") == "report":
            journal_results[int(entry.get("tid", -1))] = entry.get("result")

    # FS407: torn journal records
    if n_torn:
        fixed = False
        action = ""
        if repair:
            try:
                blob = b"".join(
                    tracing.format_record(e, default=_json_default)
                    for e in entries
                )
                _atomic_write(journal_file, blob)
                fixed = True
                action = (
                    f"rewrote journal keeping {len(entries)} valid "
                    f"record(s)"
                )
            except OSError:
                pass
        report.add(
            "FS407", journal_file,
            f"{n_torn} torn journal record(s)",
            repaired=fixed, action=action,
        )

    # -- scan the docs ---------------------------------------------------
    docs_by_tid = {}
    seen_states = {}
    max_doc_draw = 0
    for path in sorted(glob.glob(os.path.join(qdir, "trials", "*.json"))):
        name_tid = _tid_from_name(path, ".json")
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            continue
        try:
            doc = _decode_doc(raw)
        except DocCorrupt as e:
            # FS401: torn/corrupt doc.  One unrepairable file (EACCES,
            # vanished mid-scan) must degrade to a "found, unrepaired"
            # finding, never abort the whole scan — the other queues
            # still deserve their repairs.
            action = ""
            fixed = False
            if repair:
                try:
                    dest = quarantine_path(path)
                    os.replace(path, dest)
                    fixed = True
                    action = f"quarantined to {os.path.basename(dest)}"
                except OSError:
                    pass
            if fixed:
                restored = journal_docs.get(name_tid)
                if restored is not None:
                    try:
                        doc, draw = restored
                        # durability: exempt(offline repair: fsck runs single-writer against a stopped queue)
                        _write_doc(path, doc)
                        docs_by_tid[int(doc["tid"])] = doc
                        seen_states[int(doc["tid"])] = doc["state"]
                        result = journal_results.get(int(doc["tid"]))
                        if result is not None:
                            doc = dict(doc)
                            doc["result"] = result
                            doc["state"] = (
                                JOB_STATE_ERROR
                                if result.get("status") == STATUS_FAIL
                                else JOB_STATE_DONE
                            )
                            # durability: exempt(offline repair: fsck runs single-writer against a stopped queue)
                            _write_doc(path, doc)
                            seen_states[int(doc["tid"])] = doc["state"]
                        action += "; restored from response journal"
                    except OSError:
                        action += "; journal restore FAILED"
            report.add(
                "FS401", path, f"corrupt trial doc ({e})",
                repaired=fixed, action=action,
            )
            continue
        report.n_docs += 1
        tid = int(doc.get("tid", -1))
        if name_tid is None or tid != name_tid:
            # FS404: the doc claims a tid its filename does not carry —
            # two files can then answer for one tid
            fixed = False
            action = ""
            if repair:
                try:
                    dest = quarantine_path(path)
                    os.replace(path, dest)
                    fixed = True
                    action = f"quarantined to {os.path.basename(dest)}"
                except OSError:
                    pass
            report.add(
                "FS404", path,
                f"doc tid {tid} does not match filename tid {name_tid}",
                repaired=fixed, action=action,
            )
            continue
        if tid in docs_by_tid:
            report.add(
                "FS404", path, f"duplicate tid {tid}", repaired=False
            )
            continue
        docs_by_tid[tid] = doc
        seen_states[tid] = doc["state"]
        max_doc_draw = max(
            max_doc_draw, int(doc.get("misc", {}).get("service_draw", 0))
        )

    # -- segmented store (FS410/FS411/FS412) ------------------------------
    # replayed segment docs join the same tables, so the lease/lock/
    # cursor/counter rules work identically on either backend; a doc
    # file AND a segment record for one tid is the benign mid-migration
    # leftover (migrate appends before unlinking), not FS404
    for tid, doc in sorted(_fsck_segments(qdir, repair, report).items()):
        report.n_docs += 1
        if tid not in docs_by_tid:
            docs_by_tid[tid] = doc
            seen_states[tid] = doc["state"]
        max_doc_draw = max(
            max_doc_draw, int(doc.get("misc", {}).get("service_draw", 0))
        )

    # -- leases (FS402) ---------------------------------------------------
    for path in sorted(glob.glob(os.path.join(qdir, "leases", "*.lease"))):
        tid = _tid_from_name(path, ".lease")
        state = seen_states.get(tid)
        if tid is not None and state == JOB_STATE_RUNNING:
            continue
        detail = (
            "lease without a trial doc" if state is None
            else f"lease for non-RUNNING doc (state {state})"
        )
        fixed = False
        if repair:
            try:
                os.unlink(path)
                fixed = True
            except OSError:
                pass
        report.add("FS402", path, detail, repaired=fixed,
                   action="deleted" if fixed else "")

    # -- locks (FS403) ----------------------------------------------------
    for path in sorted(glob.glob(os.path.join(qdir, "locks", "*.lock"))):
        tid = _tid_from_name(path, ".lock")
        state = seen_states.get(tid)
        if tid is not None and state in _LOCKABLE_STATES:
            continue
        detail = (
            "lock without a trial doc"
            if state is None or tid is None
            else f"lock on a doc that cannot hold one (state {state})"
        )
        fixed = False
        if repair:
            try:
                os.unlink(path)
                fixed = True
            except OSError:
                pass
        report.add("FS403", path, detail, repaired=fixed,
                   action="deleted" if fixed else "")

    # -- tmp droppings (FS406) --------------------------------------------
    for sub in ("trials", "locks", "leases", "attachments", "segments"):
        for path in sorted(glob.glob(os.path.join(qdir, sub, "*.tmp.*"))):
            fixed = False
            if repair:
                try:
                    os.unlink(path)
                    fixed = True
                except OSError:
                    pass
            report.add(
                "FS406", path,
                "tmp dropping from a writer killed mid-atomic-write",
                repaired=fixed, action="deleted" if fixed else "",
            )

    # -- id allocator (FS408) ---------------------------------------------
    counter_lock = os.path.join(qdir, "ids.counter.lock")
    if os.path.exists(counter_lock):
        # offline there is no legitimate holder: an allocator died
        # inside its critical section and every later allocation would
        # spin to its 30s timeout forever
        fixed = False
        if repair:
            try:
                os.unlink(counter_lock)
                fixed = True
            except OSError:
                pass
        report.add(
            "FS408", counter_lock,
            "stuck id-counter lock (allocator killed mid-allocation)",
            repaired=fixed, action="deleted" if fixed else "",
        )
    counter_file = os.path.join(qdir, "ids.counter")
    if docs_by_tid and os.path.exists(counter_file):
        try:
            with open(counter_file) as f:
                counter = int(f.read().strip() or 0)
        except (OSError, ValueError):
            counter = 0
        max_tid = max(docs_by_tid)
        if counter <= max_tid:
            fixed = False
            if repair:
                try:
                    # durability: exempt(offline repair: fsck runs single-writer against a stopped queue)
                    _atomic_write(counter_file, str(max_tid + 1).encode())
                    fixed = True
                except OSError:
                    pass
            report.add(
                "FS408", counter_file,
                f"id counter {counter} at or below highest tid "
                f"{max_tid}: the next allocation would duplicate a tid",
                repaired=fixed,
                action=(f"advanced counter {counter} -> {max_tid + 1}"
                        if fixed else ""),
            )

    # -- seed cursor (FS405) ----------------------------------------------
    cursor_file = _attachment_path(qdir, SEED_CURSOR_ATTACHMENT)
    evidenced = max(max_doc_draw, max_journal_draw)
    if evidenced:
        cursor = 0
        try:
            with open(cursor_file) as f:
                cursor = int(f.read().strip() or 0)
        except (OSError, ValueError):
            cursor = 0
        if cursor < evidenced:
            fixed = False
            if repair:
                try:
                    # durability: exempt(offline repair: fsck runs single-writer against a stopped queue)
                    _atomic_write(cursor_file, str(evidenced).encode())
                    fixed = True
                except OSError:
                    pass
            report.add(
                "FS405", cursor_file,
                f"seed cursor {cursor} behind evidenced draw position "
                f"{evidenced}: a restart would re-issue a used seed",
                repaired=fixed,
                action=(f"advanced cursor {cursor} -> {evidenced}"
                        if fixed else ""),
            )

    return report


def _fsck_replica_plane(root, repair, report: FsckReport):
    """FS409: the replica plane under ``<root>/replicas/`` — ownership
    leases, fence counters, claim locks, and registry records."""
    leases_dir = os.path.join(root, "replicas", "leases")
    registry_dir = os.path.join(root, "replicas", "registry")
    studies_dir = os.path.join(root, "studies")
    if not (os.path.isdir(leases_dir) or os.path.isdir(registry_dir)):
        return
    now = time.time()

    def _has_study(study_id):
        return os.path.isdir(os.path.join(studies_dir, study_id))

    def _read_lease(study_id):
        try:
            with open(
                os.path.join(leases_dir, f"{study_id}.lease"), "rb"
            ) as f:
                return _decode_doc(f.read())
        except (OSError, DocCorrupt):
            return None

    def _lease_live(lease):
        if not lease or not lease.get("owner"):
            return False
        try:
            return float(lease.get("expires_at", 0.0)) > now
        except (TypeError, ValueError):
            return False

    def _remove(path, detail, action="deleted"):
        fixed = False
        if repair:
            try:
                os.unlink(path)
                fixed = True
            except OSError:
                pass
        report.add("FS409", path, detail, repaired=fixed,
                   action=action if fixed else "")

    for path in sorted(glob.glob(os.path.join(leases_dir, "*.lease"))):
        study_id = os.path.basename(path)[: -len(".lease")]
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            continue
        try:
            lease = _decode_doc(raw)
        except DocCorrupt as e:
            # torn lease: quarantine — safe because the FENCE COUNTER,
            # not the lease file, carries token monotonicity
            fixed = False
            action = ""
            if repair:
                try:
                    dest = quarantine_path(path)
                    os.replace(path, dest)
                    fixed = True
                    action = f"quarantined to {os.path.basename(dest)}"
                except OSError:
                    pass
            report.add(
                "FS409", path, f"torn replica-ownership lease ({e})",
                repaired=fixed, action=action,
            )
            continue
        if not _has_study(study_id):
            if _lease_live(lease):
                # a LIVE lease with no study dir is the mid-create
                # window (ownership-before-side-effects claims the
                # lease before the directory exists) — deleting it
                # would steal a live creator's ownership and, via the
                # fence file, reset token monotonicity.  Not damage.
                continue
            _remove(
                path,
                "orphaned replica-ownership lease (no study directory)",
            )
            continue
        owner = lease.get("owner")
        try:
            expires_at = float(lease.get("expires_at", 0.0))
            expired = expires_at <= now
        except (TypeError, ValueError):
            expires_at = 0.0
            expired = True
        try:
            grace = max(
                expires_at - float(lease.get("granted_at", expires_at)),
                0.0,
            )
        except (TypeError, ValueError):
            grace = 0.0
        if owner and expired and now <= expires_at + grace:
            # within one TTL of expiry the holder may be briefly
            # stalled, not dead: verify() deliberately treats an
            # expired-but-unreclaimed lease as still held, and claim()
            # can already take over without fsck's help.  Clearing the
            # owner here (e.g. a sibling replica's STARTUP fsck on the
            # shared root) would spuriously fence a live holder.
            continue
        if owner and expired:
            # expired residue of a dead replica: reclaim — owner
            # cleared, fence PRESERVED (resetting it would let the
            # dead owner's buffered writes pass a later verify)
            fixed = False
            action = ""
            if repair:
                lease = dict(lease)
                lease["owner"] = None
                lease["expires_at"] = 0.0
                lease["reclaimed_by"] = "fsck"
                try:
                    # durability: exempt(offline repair: fsck runs single-writer against a stopped store)
                    _write_doc(path, lease)
                    fixed = True
                    action = (
                        f"reclaimed (owner {owner!r} cleared, fence "
                        f"{lease.get('fence')} preserved)"
                    )
                except OSError:
                    pass
            report.add(
                "FS409", path,
                f"expired replica-ownership lease still naming "
                f"{owner!r}",
                repaired=fixed, action=action,
            )

    # fence counters: garbled → rewrite past the highest evidenced
    # token; orphaned (no study) → delete
    for path in sorted(glob.glob(os.path.join(leases_dir, "*.fence"))):
        study_id = os.path.basename(path)[: -len(".fence")]
        if not _has_study(study_id):
            if _lease_live(_read_lease(study_id)):
                continue  # mid-create window (see the lease pass)
            _remove(path, "orphaned fence counter (no study directory)")
            continue
        try:
            with open(path) as f:
                int(f.read().strip() or 0)
            continue  # parseable: fine at any value
        except ValueError:
            pass
        except OSError:
            continue
        evidenced = 0
        lease_file = os.path.join(leases_dir, f"{study_id}.lease")
        try:
            with open(lease_file, "rb") as f:
                evidenced = int(_decode_doc(f.read()).get("fence", 0))
        except (OSError, DocCorrupt, TypeError, ValueError):
            pass
        fixed = False
        if repair:
            try:
                # durability: exempt(offline repair: fsck runs single-writer against a stopped store)
                _atomic_write(path, str(evidenced + 1).encode())
                fixed = True
            except OSError:
                pass
        report.add(
            "FS409", path,
            "garbled fence counter (token monotonicity at risk)",
            repaired=fixed,
            action=(f"rewrote as {evidenced + 1}" if fixed else ""),
        )

    # stuck claim locks: a FRESH lock is a peer inside the O_CREAT |
    # O_EXCL critical section (this fsck may be a sibling replica's
    # startup pass against a live shared root) — only a lock old
    # enough that no live claimant can hold it is damage.  The store
    # itself steals locks older than its TTL; this grace is the
    # conservative ceiling for roots fsck can't know the TTL of.
    for path in sorted(glob.glob(os.path.join(leases_dir, "*.claimlock"))):
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue
        if age <= FS409_CLAIMLOCK_GRACE_S:
            continue
        _remove(
            path,
            "stuck lease claim lock (claimant killed mid-claim)",
        )

    # registry records: torn → delete (regenerated by the replica's
    # next heartbeat; advisory data, never a safety input)
    for path in sorted(glob.glob(os.path.join(registry_dir, "*.json"))):
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            continue
        try:
            _decode_doc(raw)
        except DocCorrupt as e:
            _remove(path, f"torn replica-registry record ({e})")


def fsck_service_root(root, repair=False) -> FsckReport:
    """fsck every study queue under an optimization-service root
    (``<root>/studies/<study_id>/``), plus the replica plane (FS409)
    when one exists."""
    root = os.path.abspath(root)
    report = FsckReport(root=root, repair=repair)
    studies_dir = os.path.join(root, "studies")
    if os.path.isdir(studies_dir):
        for name in sorted(os.listdir(studies_dir)):
            qdir = os.path.join(studies_dir, name)
            if os.path.isdir(qdir):
                fsck_queue(qdir, repair=repair, report=report)
    _fsck_replica_plane(root, repair, report)
    return report


def fsck_path(path, repair=False) -> FsckReport:
    """fsck a service root (has ``studies/`` or ``replicas/``) or a
    single queue dir (has ``trials/`` or ``segments/``) — detected by
    layout."""
    path = os.path.abspath(path)
    if os.path.isdir(os.path.join(path, "studies")) or os.path.isdir(
        os.path.join(path, "replicas")
    ):
        return fsck_service_root(path, repair=repair)
    return fsck_queue(path, repair=repair)


def main(argv=None) -> int:
    """CLI body of ``python -m hyperopt_tpu_torch.resilience.fsck``: exit
    0 when the queue is clean (or every finding was repaired), 1 when
    not."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m hyperopt_tpu_torch.resilience.fsck",
        description="Check (and repair) a FileTrials queue directory or "
                    "an optimization-service root: torn "
                    "docs, orphan leases/locks, duplicate tids, stale "
                    "seed cursors, tmp droppings, torn journals and "
                    "segments, a broken id allocator.",
    )
    ap.add_argument("root", help="queue directory or service root")
    ap.add_argument(
        "--repair", action="store_true",
        help="apply repairs (default: dry-run report only)",
    )
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the report as JSON")
    args = ap.parse_args(argv)
    report = fsck_path(args.root, repair=args.repair)
    if args.as_json:
        print(json.dumps(report.summary(), indent=1))
    else:
        print(report.format())
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
