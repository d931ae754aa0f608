"""The port's native fastqueue loader (``hyperopt_tpu_torch.native``): the
JAX package's ``tests/test_native.py`` run against the port — it builds
the shared ``native/fastqueue.cpp`` with g++ into the port's own
``build/native/``, scans like the exact Python parser, locks exclusively
and falls back on docs it cannot parse — plus the two packages' scans
of one queue."""

import os
import threading

import pytest

from hyperopt_tpu_torch import native
from hyperopt_tpu_torch.base import JOB_STATE_DONE, JOB_STATE_NEW, JOB_STATE_RUNNING
from hyperopt_tpu_torch.parallel.file_trials import FileJobs


@pytest.fixture(autouse=True)
def _toolchain():
    # decided per test, never at import: each test worker builds (or
    # finds) the library itself
    if native.load_fastqueue() is None:
        pytest.skip("g++ toolchain unavailable")


def make_doc(tid, state):
    return {
        "tid": tid, "state": state, "spec": None,
        "result": {"status": "new"},
        "misc": {"tid": tid, "cmd": None, "idxs": {}, "vals": {}},
        "exp_key": None, "owner": None, "book_time": None, "refresh_time": None,
    }


def test_native_lib_builds_and_loads():
    lib = native.load_fastqueue()
    assert lib is not None
    assert hasattr(lib, "fq_count_states")
    # the port's own build directory, never the JAX package's
    # native/_build (written there without an atomic rename)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native._LIB == os.path.join(repo, "build", "native", "libfastqueue.so")
    assert native._SRC == os.path.join(repo, "native", "fastqueue.cpp")
    assert os.path.exists(native._LIB)


def test_count_states_matches_python(tmp_path):
    # the native scanner reads the legacy per-doc layout
    jobs = FileJobs(str(tmp_path), backend="doc")
    for tid, state in enumerate([0, 0, 2, 2, 2, 1, 4]):
        jobs.insert(make_doc(tid, state))
    res = native.count_states(os.path.join(str(tmp_path), "trials"))
    assert res is not None
    counts, n = res
    assert n == 7
    assert counts[JOB_STATE_NEW] == 2
    assert counts[JOB_STATE_DONE] == 3
    assert counts[JOB_STATE_RUNNING] == 1
    assert counts[4] == 1
    # FileJobs.count_states agrees (whichever path it took)
    assert jobs.count_states()[JOB_STATE_DONE] == 3


def test_list_state_sorted(tmp_path):
    jobs = FileJobs(str(tmp_path), backend="doc")
    for tid, state in [(5, 0), (2, 0), (9, 2), (1, 0)]:
        jobs.insert(make_doc(tid, state))
    tids = native.list_state(os.path.join(str(tmp_path), "trials"), JOB_STATE_NEW)
    assert tids == [1, 2, 5]


def test_try_lock_exclusive(tmp_path):
    lock = str(tmp_path / "t.lock")
    assert native.try_lock(lock, "w1") == 1
    assert native.try_lock(lock, "w2") == 0
    with open(lock) as f:
        assert f.read() == "w1"


def test_try_lock_race(tmp_path):
    lock = str(tmp_path / "race.lock")
    wins = []
    barrier = threading.Barrier(8)

    def go(i):
        barrier.wait()
        if native.try_lock(lock, f"w{i}") == 1:
            wins.append(i)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(wins) == 1


def test_reserve_uses_native_and_agrees(tmp_path):
    jobs = FileJobs(str(tmp_path), backend="doc")
    for tid in range(5):
        jobs.insert(make_doc(tid, JOB_STATE_NEW))
    seen = set()
    while True:
        doc = jobs.reserve("worker")
        if doc is None:
            break
        seen.add(doc["tid"])
        assert doc["state"] == JOB_STATE_RUNNING
        assert doc["owner"] == "worker"
    assert seen == {0, 1, 2, 3, 4}


def test_unparsed_doc_falls_back(tmp_path):
    jobs = FileJobs(str(tmp_path), backend="doc")
    jobs.insert(make_doc(0, JOB_STATE_NEW))
    # hand-write a doc the textual scanner cannot parse (no "state": int)
    weird = os.path.join(str(tmp_path), "trials", "000000000099.json")
    with open(weird, "w") as f:
        f.write('{"tid": 99, "state"\n:\n0, "misc": {"tid": 99, "cmd": null, '
                '"idxs": {}, "vals": {}}, "result": {"status": "new"}, '
                '"spec": null, "exp_key": null, "owner": null, '
                '"book_time": null, "refresh_time": null}')
    # native count reports unparsed -> count_states falls back to exact
    counts = jobs.count_states()
    assert counts[JOB_STATE_NEW] == 2


def test_scans_equal_the_jax_packages(tmp_path):
    """One per-doc queue scanned by both packages' native entry points
    gives the same counts, lists and Python fallbacks."""
    from hyperopt_tpu import native as jnative

    jobs = FileJobs(str(tmp_path), backend="doc")
    for tid, state in enumerate([0, 1, 2, 2, 0, 3, 2, 0]):
        jobs.insert(make_doc(tid, state))
    trials_dir = os.path.join(str(tmp_path), "trials")
    assert native.count_states(trials_dir) == jnative.count_states(trials_dir)
    for state in range(4):
        assert (native.list_state(trials_dir, state)
                == jnative.list_state(trials_dir, state))
