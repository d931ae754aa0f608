"""The kernel loader's cold build under concurrency, on the CPU.

``nvcc`` is stubbed by a command that writes its output in two steps
(``HEAD``, a pause, then ``TAIL``) and counts its runs; ``ctypes.CDLL``
by a loader that records the library's bytes.  Two threads make the first
``load`` of one kernel, the second starting while the first builds: the
build runs once, and the published library is whole."""

import os
import sys
import threading
import time

import pytest

from hyperopt_tpu_torch.ops import kernel_build

STUB = (
    "import sys, time\n"
    "out, count = sys.argv[1], sys.argv[2]\n"
    "with open(count, 'a') as f:\n"
    "    f.write('build\\n')\n"
    "with open(out, 'wb') as f:\n"
    "    f.write(b'HEAD')\n"
    "time.sleep(0.5)\n"
    "with open(out, 'ab') as f:\n"
    "    f.write(b'TAIL')\n"
)


@pytest.fixture
def stubbed(tmp_path, monkeypatch):
    count = tmp_path / "builds.txt"
    count.write_text("")
    loaded = []

    def fake_cdll(path):
        with open(path, "rb") as f:
            loaded.append((path, f.read()))
        return object()

    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(kernel_build, "_loaded", {})
    monkeypatch.setattr(kernel_build, "_cache_events", {"hits": 0, "misses": 0})
    monkeypatch.setattr(kernel_build, "nvcc_command",
                        lambda src, out: [sys.executable, "-c", STUB, str(out), str(count)])
    monkeypatch.setattr(kernel_build.ctypes, "CDLL", fake_cdll)
    return count, loaded


def test_two_threads_first_load_build_once_and_publish_a_whole_library(stubbed):
    count, loaded = stubbed
    libs, errors = [], []

    def first_load():
        try:
            libs.append(kernel_build.load("pair_score"))
        except Exception as e:  # surfaced by the asserts below
            errors.append(e)

    a = threading.Thread(target=first_load)
    b = threading.Thread(target=first_load)
    a.start()
    time.sleep(0.2)  # the second load arrives while the first builds
    b.start()
    a.join(timeout=60)
    b.join(timeout=60)
    assert not a.is_alive() and not b.is_alive()
    assert errors == []
    assert count.read_text().splitlines() == ["build"]  # exactly one build
    path = kernel_build.library_path("pair_score")
    assert path.read_bytes() == b"HEADTAIL"
    assert [data for _, data in loaded] == [b"HEADTAIL"]  # one load, of the whole library
    assert len(libs) == 2 and libs[0] is libs[1]
    assert kernel_build.cache_events() == {"hits": 0, "misses": 1}
    assert kernel_build.n_loaded() == 1
    # no temporary left beside the published library
    assert sorted(os.listdir(path.parent)) == [path.name]


def test_builds_use_distinct_temporaries_and_a_failed_build_leaves_none(stubbed, monkeypatch):
    """Each build writes its own temporary (two builds of one library
    never share a file); a failed build removes its temporary and raises."""
    count, _ = stubbed
    outs = []

    def record(src, out):
        outs.append(str(out))
        return [sys.executable, "-c", "import sys; sys.exit(3)"]

    monkeypatch.setattr(kernel_build, "nvcc_command", record)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            kernel_build.build(["pair_score"])
    assert len(set(outs)) == 2
    assert all(os.path.dirname(o) == str(kernel_build.BUILD_DIR) for o in outs)
    assert os.listdir(kernel_build.BUILD_DIR) == []
    assert count.read_text() == ""
