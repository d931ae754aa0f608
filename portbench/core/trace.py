"""The traced slice of a window: device activity from ``torch.profiler``
(CUDA activity only), placed on the host's monotonic clock, beside the
benchmark's own host spans.

The profiler starts at the slice's start and stops at its end, on the
thread that launches the program's kernels; around
each, one short spin kernel goes on a stream of its own right after a
synchronize, so that the device's timestamps can be mapped onto
``time.monotonic()``.  From the events it reads the device's
busy time (the union of kernel, copy and set intervals), the kernels and
their names, and the device's idle time split by what the host was doing
(the host spans the drivers record).
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict

ANCHOR = "spin_kernel"
TOP = 10


class Spans:
    """Host spans ``(name, t0, t1)`` on ``time.monotonic()``; thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    def add(self, name, t0, t1):
        with self._lock:
            self.items.append((name, t0, t1))

    def named(self, name):
        with self._lock:
            return [(a, b) for n, a, b in self.items if n == name]


def _union(intervals):
    """Sorted, disjoint ``[start, end]`` pairs covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covers(union, t):
    i = bisect.bisect_right(union, [t, float("inf")]) - 1
    return i >= 0 and union[i][0] <= t < union[i][1]


def _anchor(torch, stream):
    torch.cuda.synchronize()
    t = time.monotonic()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return t


def _events(prof):
    """``[(name, start_ns, end_ns)]`` of the device events."""
    out = []
    try:
        evs = prof.profiler.kineto_results.events()
    except AttributeError:
        evs = None
    if evs is not None:
        for e in evs:
            if not str(e.device_type()).endswith("CUDA"):
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = e.start_us() * 1000, e.duration_us() * 1000
            out.append((e.name(), int(s), int(s + d)))
        return out
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            out.append((e.name, int(e.time_range.start * 1000), int(e.time_range.end * 1000)))
    return out


class SliceTracer:
    """Profile the device between two monotonic times.

    Every call into the profiler is made on the thread that launches the
    program's kernels: :meth:`warm` pays the profiler's first
    initialization in set-up, and :meth:`tick` starts or stops the slice
    when its time has come (the fmin driver calls it after every trial,
    on the loop's thread).  ``snapshot()``, if
    given, is taken as the slice starts and as it stops, so that readers
    can leave the slice out of what the program counted."""

    def __init__(self, torch, t_start, t_end, snapshot=None):
        self.torch = torch
        self.t_start, self.t_end = t_start, t_end
        self.snapshot = snapshot
        self.raw = None
        self.snaps = []
        self._prof = None
        self._done = None
        self._stream = None
        self._h0 = self._s0 = None

    @staticmethod
    def warm(torch):
        """Pay the profiler's first initialization in set-up."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    def _start(self):
        from torch.profiler import ProfilerActivity, profile

        self._stream = self.torch.cuda.Stream()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._h0 = _anchor(self.torch, self._stream)
        self._s0 = time.monotonic()

    def _stop(self):
        s1 = time.monotonic()
        h1 = _anchor(self.torch, self._stream)
        self._prof.stop()
        return h1, s1

    def tick(self):
        now = time.monotonic()
        if self._prof is None and self._done is None and now >= self.t_start:
            if self.snapshot is not None:
                self.snaps.append(self.snapshot())
            self._start()
        elif self._prof is not None and self._done is None and now >= self.t_end:
            self.stop()

    def stop(self):
        if self._prof is None or self._done is not None:
            return
        self._done = self._stop()
        if self.snapshot is not None:
            self.snaps.append(self.snapshot())

    def collect(self):
        """Read the profiler's events (after the window: it takes time).
        A slice that never started leaves ``raw`` None."""
        if self._done is None:
            return
        events = _events(self._prof)
        h1, s1 = self._done
        self.raw = (events, self._h0, h1, self._s0, s1)
        self._prof = None

    def read(self, spans: Spans, priority):
        """The slice's numbers: ``window_s``, ``busy_s``, ``kernels``
        (count), ``by_name`` (device seconds), ``gaps`` (idle seconds by
        host activity, ``priority`` the order in which covering spans
        name a gap) and ``kernel_intervals`` for readers."""
        events, h0, h1, s0, s1 = self.raw
        anchors = sorted((s, n) for n, s, _ in events if ANCHOR in n)
        if len(anchors) >= 2:
            off = ((h0 - anchors[0][0] / 1e9) + (h1 - anchors[-1][0] / 1e9)) / 2
        else:
            first = min((s for _, s, _ in events), default=0)
            off = s0 - first / 1e9
        ivs = []
        by_name = defaultdict(float)
        kernels = []
        for name, a, b in events:
            if ANCHOR in name:
                continue
            t0, t1 = a / 1e9 + off, b / 1e9 + off
            if t1 <= s0 or t0 >= s1:
                continue
            t0, t1 = max(t0, s0), min(t1, s1)
            ivs.append((t0, t1))
            by_name[name] += t1 - t0
            if not name.startswith(("Memcpy", "Memset")):
                kernels.append((name, t0, t1))
        merged = _union(ivs)
        busy = sum(b - a for a, b in merged)
        idle, last = [], s0
        for a, b in merged:
            if a > last:
                idle.append((last, a))
            last = max(last, b)
        if s1 > last:
            idle.append((last, s1))
        cover = {n: _union(spans.named(n)) for n in priority}
        gaps = defaultdict(float)
        for a, b in idle:
            mid = 0.5 * (a + b)
            name = next((n for n in priority if _covers(cover[n], mid)), "other")
            gaps[name] += b - a
        return {
            "window_s": s1 - s0, "t0": s0, "t1": s1, "busy_s": busy,
            "kernels": len(kernels), "kernel_intervals": kernels,
            "by_name": dict(by_name), "gaps": dict(gaps),
        }


def breakdown(sl):
    """The result line's ``breakdown``: the device operations that took
    most time and the device's idle time by host activity."""
    ops = sorted(sl["by_name"].items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(sl["gaps"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
