"""The replica plane, as far as one replica needs it.

Reference parity: the part of ``hyperopt_tpu/service/replicas.py`` that
the single-replica service and its client import —
:class:`OwnershipLost` (the commit-time fence failure the service
catches), :func:`_validate_replica_id`, the client's consistent-hash
router :class:`HashRing` and :func:`read_discovery` over a JSON file.

Not ported yet (ROADMAP.md, queue A item 5): ``StudyLeaseStore``,
``ReplicaDirectory``, ``SegmentMirror``, ``ReplicaStats``,
``OwnershipHandle`` and ``ReplicaSet`` — the leased study ownership that
lets several server processes share one root.  Until then
``OptimizationService(replica_id=...)``, ``mirror_src_root=`` and the
CLI's ``--replica-id`` raise :class:`NotImplementedError`
(:func:`not_ported`).
"""

from __future__ import annotations

import hashlib
import json
import os

ROADMAP_ITEM = "ROADMAP.md: queue A item 5, the rest of service/replicas.py"


def not_ported(what) -> NotImplementedError:
    """The error every multi-replica entry point raises until the replica
    plane is ported."""
    return NotImplementedError(
        f"{what} needs the replica plane, which is not ported to "
        f"hyperopt_tpu_torch yet ({ROADMAP_ITEM}); run one replica"
    )


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
    """Replica URLs from a discovery file: JSON ``{"replicas": [url,
    ...]}`` or a bare list.  A service-root or registry directory (the
    reference reads its live replica records) raises until the replica
    directory is ported."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        raise not_ported(f"discovery from the replica directory {path}")
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        doc = doc.get("replicas", [])
    return [str(u) for u in doc]
