"""The port's segmented trial log (``hyperopt_tpu_torch.parallel.
segment_store``): the JAX package's ``tests/test_segment_store.py`` run
against the port — an appender never skips an interleaved appender's
bytes, and breaking a stale ``.seal.lock`` never lets two sealers run —
plus the on-disk format against the JAX package's: byte-identical
record framing, and segments either package wrote parsed by the other.
"""

import os
import time

import datetime

import pytest

from hyperopt_tpu import journal_io as jjournal_io
from hyperopt_tpu import tracing as jtracing
from hyperopt_tpu.parallel import segment_store as jsstore
from hyperopt_tpu.parallel.file_trials import _json_default as j_json_default
from hyperopt_tpu_torch import journal_io, tracing
from hyperopt_tpu_torch.parallel import segment_store as sstore
from hyperopt_tpu_torch.parallel.file_trials import _json_default, _json_object_hook


def _doc(tid, state=0):
    return {"tid": tid, "state": state, "misc": {"tid": tid}}


class TestInterleavedAppenders:
    def test_append_does_not_skip_interleaved_appender_bytes(
        self, tmp_path, monkeypatch
    ):
        """Process A refreshes, process B appends, process A appends:
        B's record sits in [A's cursor, A's write start) and A must
        replay it on its next refresh instead of jumping its cursor
        past it forever."""
        a = sstore.SegmentStore(str(tmp_path), auto_compact=False)
        b = sstore.SegmentStore(str(tmp_path), auto_compact=False)
        a.append(_doc(0))
        b.refresh()

        real = sstore.journal_io.append_records
        fired = []

        def interleave(path, payloads, **kw):
            # B's append lands first, below A's — exactly the window
            # between A's in-lock refresh and A's own O_APPEND write
            if not fired:
                fired.append(True)
                b.append(_doc(1))
            return real(path, payloads, **kw)

        monkeypatch.setattr(
            sstore.journal_io, "append_records", interleave
        )
        a.append(_doc(2))
        monkeypatch.setattr(sstore.journal_io, "append_records", real)

        assert sorted(d["tid"] for d in a.all_docs()) == [0, 1, 2]
        assert a.count_states()[0] == 3
        # B (whose own cursor is contiguous) sees everything too
        assert sorted(d["tid"] for d in b.all_docs()) == [0, 1, 2]

    def test_contiguous_append_still_advances_the_cursor(self, tmp_path):
        """The common single-appender case keeps its O(0) refresh: the
        appender's own bytes are not re-read on the next refresh."""
        store = sstore.SegmentStore(str(tmp_path), auto_compact=False)
        store.append(_doc(0))
        active = store._manifest["active"]
        size = os.path.getsize(store.segment_path(active))
        assert store._offsets[active] == size
        assert store.refresh() == []  # nothing unseen


class TestStaleSealLock:
    def test_stale_lock_is_broken_and_seal_proceeds(self, tmp_path):
        store = sstore.SegmentStore(str(tmp_path), auto_compact=False)
        store.append(_doc(0))
        lock = os.path.join(store.dir, ".seal.lock")
        with open(lock, "w"):
            pass
        old = time.time() - 120.0
        os.utime(lock, (old, old))
        store.seal_active()
        assert store.sealed_entries()  # the seal landed
        # no residue: neither the shared lock nor the private rename
        # target survives the break
        leftovers = [
            n for n in os.listdir(store.dir)
            if n == ".seal.lock" or ".stale-" in n
        ]
        assert leftovers == []

    def test_losing_breaker_retries_instead_of_unlinking(
        self, tmp_path, monkeypatch
    ):
        """Two processes judge the lock stale; the rename loser must
        NOT remove the shared path (which the winner may have just
        re-created as its own live lock)."""
        store = sstore.SegmentStore(str(tmp_path), auto_compact=False)
        store.append(_doc(0))
        lock = os.path.join(store.dir, ".seal.lock")
        with open(lock, "w"):
            pass
        old = time.time() - 120.0
        os.utime(lock, (old, old))

        real_rename = os.rename

        def lose_the_race(src, dst, *a, **kw):
            if src == lock and ".stale-" in str(dst):
                # the other breaker renamed the stale lock first and
                # immediately re-acquired: simulate by freshening the
                # shared path (their new live lock)
                os.utime(lock, None)
                raise FileNotFoundError(src)
            return real_rename(src, dst, *a, **kw)

        monkeypatch.setattr(os, "rename", lose_the_race)
        assert store._seal_lock_acquire(timeout=0.2) is None
        # the winner's fresh lock is untouched
        assert os.path.exists(lock)


# -- the on-disk format against the JAX package's ------------------------

PAYLOADS = [
    {"tid": 0, "state": 0, "misc": {"tid": 0, "vals": {"x": [0.5]}}},
    {"b": [1, 2.5, None], "a": "é", "nested": {"z": True, "y": -1e-300}},
    {"when": datetime.datetime(2026, 1, 2, 3, 4, 5, 678901),
     "blob": b"\x00\x01\xff", "pair": (1, 2)},
    {},
]


@pytest.mark.parametrize("payload", PAYLOADS, ids=range(len(PAYLOADS)))
def test_record_framing_is_byte_identical(payload):
    """``tracing.format_record`` and ``journal_io.frame_record`` of both
    packages give the same bytes for the same payload (with the trial-doc
    codec for datetimes, bytes and tuples)."""
    assert (tracing.format_record(payload, default=_json_default)
            == jtracing.format_record(payload, default=j_json_default))
    assert (journal_io.frame_record(payload, default=_json_default)
            == jjournal_io.frame_record(payload, default=j_json_default))


def _docs(n, state=0):
    return [
        {"tid": t, "state": state, "owner": None,
         "book_time": datetime.datetime(2026, 1, 1, 0, 0, t % 60),
         "misc": {"tid": t, "idxs": {"x": [t]}, "vals": {"x": [t / 7.0]}}}
        for t in range(n)
    ]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_segments_parse_in_the_other_package(tmp_path, writer):
    """A segment log (appends, a seal, a torn tail) written by one
    package: ``parse_segment_chunk`` of both packages gives the same
    records, and the other package's ``SegmentStore`` replays the same
    latest docs."""
    mod, other = (sstore, jsstore) if writer == "port" else (jsstore, sstore)
    root = str(tmp_path / "q")
    store = mod.SegmentStore(root, auto_compact=False)
    store.append_many(_docs(6))
    store.seal_active()
    store.append_many(_docs(3, state=2))  # tids 0-2 move to DONE
    with open(store.segment_path(store._manifest["active"]), "ab") as f:
        f.write(b"\n1234abcd {torn")  # a torn tail: an append in flight
    for name in sorted(os.listdir(store.dir)):
        if not name.startswith("seg-"):
            continue
        with open(os.path.join(store.dir, name), "rb") as f:
            chunk = f.read()
        mine = mod.parse_segment_chunk(chunk, object_hook=_json_object_hook)
        theirs = other.parse_segment_chunk(chunk, object_hook=_json_object_hook)
        assert mine == theirs
    reader = other.SegmentStore(root, auto_compact=False)
    assert ({d["tid"]: d for d in reader.all_docs()}
            == {d["tid"]: d for d in store.all_docs()})
    assert reader.count_states() == store.count_states()
    assert {s: n for s, n in store.count_states().items() if n} == {0: 3, 2: 3}
