"""Split the fmin loop's host time by its tracing spans.

    python scripts/fmin_spans.py report TRACE_LOG

reads the log of a ``Tracer`` given to ``fmin(tracer=...)`` (one trace per
loop iteration, ``docs/torch_fmin_spans.md``) and prints one JSON object.
Times are milliseconds; a span's exclusive time is its time less that of
its children on its own thread.

- ``readings``:

  - ``fmin.refresh_ms``: exclusive time in ``trials.refresh`` per trial;
  - ``fmin.scan_ms``: exclusive time in ``fmin.scan`` and ``fmin.health``
    per trial;
  - ``pipeline.overrun_ms``: per trial, how long ``pipeline.speculate``
    ran on after ``fmin.objective`` had ended (0 where it ended first);
  - ``suggest.prep_ms``: exclusive time in ``suggest.history`` and
    ``suggest.build`` per suggest (one ``suggest.build`` each);
  - ``suggest.launch_ms``: time in ``suggest.launch`` per suggest;
  - ``fmin.suggest_ms``: time in ``fmin.suggest`` per trial;
  - ``refresh.incremental_share``: the share of ``trials.refresh`` spans
    that walked fewer documents than the store holds (``n_walked`` <
    ``n_docs``: the loop's incremental refresh), and
    ``refresh.incremental_walked_max``, the most documents one of those
    walked;
  - ``scan.tally_share``: the share of ``fmin.scan`` spans that walked no
    document (``n_walked`` 0: the counts and the best loss came from the
    refresh's tallies);
  - ``validate.walk_share``: the share of ``pipeline.validate`` spans that
    walked any document (``n_walked`` > 0: a hypothesized trial was not
    at the position its launch recorded).

- ``exclusive_ms``: each span name's exclusive time per trial;
  ``trials.refresh@<parent>`` splits the refreshes by call site.
- ``by_label``: the spans that carry a label (:data:`LABELS`), their calls
  and exclusive time per trial for each of its values: the refreshes by
  what the history cache did, the suggests by path, the saves by kind.
- ``counts``: every numeric attribute as ``<span>.<attr>``, its mean per
  span and its total per trial (speculations launched and invalidated,
  history rows uploaded, the documents a refresh walks, ...).
- ``slowest``: the longest trials, each with the study's size as it began
  (``n_trials``), its objective's ``tid``, and its largest exclusive span.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the spans whose attribute of this name says which kind of call it was
LABELS = {"trials.refresh": "rebuild", "fmin.suggest": "path", "fmin.checkpoint": "kind"}


def spans_of_record(record):
    """A trace log record as span dicts, times from the trace's start."""
    return [{"name": s["name"], "id": s["id"], "parent": s["parent"],
             "thread": s.get("thread"), "t0": s["t0_s"], "t1": s["t0_s"] + s["dur_s"],
             "attrs": s.get("attrs") or {}}
            for s in record["spans"]]


def root_of(spans):
    return next(s for s in spans if s["parent"] is None)


def exclusive(spans):
    """``{span id: seconds}``: each span's time less its children's on
    its own thread."""
    by_id = {s["id"]: s for s in spans}
    out = {s["id"]: s["t1"] - s["t0"] for s in spans}
    for s in spans:
        parent = by_id.get(s["parent"])
        if parent is not None and parent["thread"] == s["thread"]:
            out[parent["id"]] -= s["t1"] - s["t0"]
    return out


def readings(traces):
    """The readings over ``traces`` (lists of span dicts, one per loop
    iteration), and each name's exclusive ms per trial."""
    n = len(traces)
    if not n:
        return {}, {}
    excl, count = defaultdict(float), Counter()
    overrun = suggest = 0.0
    walked = []   # n_walked of the incremental refreshes
    n_walk_counted = 0
    scans = []    # n_walked of the scans
    validates = []  # n_walked of the validity checks
    for spans in traces:
        ex = exclusive(spans)
        names = {s["id"]: s["name"] for s in spans}
        for s in spans:
            excl[s["name"]] += ex[s["id"]]
            count[s["name"]] += 1
            attrs = s.get("attrs") or {}
            if s["name"] == "trials.refresh":
                # which call site: the refresh's parent span
                excl[f"trials.refresh@{names.get(s['parent'])}"] += ex[s["id"]]
                if "n_walked" in attrs:
                    n_walk_counted += 1
                    if attrs["n_walked"] < attrs["n_docs"]:
                        walked.append(attrs["n_walked"])
            elif s["name"] == "fmin.scan" and "n_walked" in attrs:
                scans.append(attrs["n_walked"])
            elif s["name"] == "pipeline.validate" and "n_walked" in attrs:
                validates.append(attrs["n_walked"])
        ends = defaultdict(float)
        for s in spans:
            ends[s["name"]] = max(ends[s["name"]], s["t1"])
            if s["name"] == "fmin.suggest":
                suggest += s["t1"] - s["t0"]
        if "pipeline.speculate" in ends and "fmin.objective" in ends:
            overrun += max(0.0, ends["pipeline.speculate"] - ends["fmin.objective"])
    out = {
        "fmin.refresh_ms": 1e3 * excl["trials.refresh"] / n,
        "fmin.scan_ms": 1e3 * (excl["fmin.scan"] + excl["fmin.health"]) / n,
        "pipeline.overrun_ms": 1e3 * overrun / n,
        "fmin.suggest_ms": 1e3 * suggest / n,
    }
    if n_walk_counted:
        out["refresh.incremental_share"] = len(walked) / n_walk_counted
        out["refresh.incremental_walked_max"] = max(walked, default=None)
    if scans:
        out["scan.tally_share"] = scans.count(0) / len(scans)
    if validates:
        out["validate.walk_share"] = sum(w > 0 for w in validates) / len(validates)
    n_suggests = count["suggest.build"]
    if n_suggests:
        out["suggest.prep_ms"] = 1e3 * (excl["suggest.history"] + excl["suggest.build"]) / n_suggests
        out["suggest.launch_ms"] = 1e3 * excl["suggest.launch"] / n_suggests
    split = {name: 1e3 * excl[name] / n for name in sorted(excl)}
    return out, split


def counters(traces):
    """``(by_label, counts)`` over ``traces``: each span of :data:`LABELS`
    split by its label's value into calls and exclusive ms per trial, and
    each numeric attribute's mean per span and total per trial.  ``tid``
    names a trial and is read by :func:`slowest` alone."""
    n = len(traces)
    if not n:
        return {}, {}
    calls, ms = Counter(), defaultdict(float)
    total, seen = defaultdict(float), Counter()
    for spans in traces:
        ex = exclusive(spans)
        for s in spans:
            attrs = s.get("attrs") or {}
            label = LABELS.get(s["name"])
            if label in attrs:
                key = (f"{s['name']}.{label}", attrs[label])
                calls[key] += 1
                ms[key] += 1e3 * ex[s["id"]]
            for attr, value in attrs.items():
                if attr != "tid" and not isinstance(value, str):
                    total[f"{s['name']}.{attr}"] += value
                    seen[f"{s['name']}.{attr}"] += 1
    by_label = defaultdict(dict)
    for key in sorted(calls):
        by_label[key[0]][key[1]] = {"calls_per_trial": calls[key] / n,
                                    "ms_per_trial": ms[key] / n}
    counts = {k: {"mean": total[k] / seen[k], "per_trial": total[k] / n} for k in sorted(total)}
    return dict(by_label), counts


def slowest(traces, n=5):
    """The ``n`` longest trials: their ms, ``fmin.trial``'s ``n_trials``,
    ``fmin.objective``'s ``tid``, and the span name with the most
    exclusive time in the trial."""
    rows = []
    for spans in traces:
        root, ex = root_of(spans), exclusive(spans)
        top = max(spans, key=lambda s: ex[s["id"]])
        tid = next((s.get("attrs", {}).get("tid") for s in spans
                    if s["name"] == "fmin.objective"), None)
        rows.append({"ms": 1e3 * (root["t1"] - root["t0"]),
                     "n_trials": root.get("attrs", {}).get("n_trials"), "tid": tid,
                     "top": top["name"], "top_ms": 1e3 * ex[top["id"]]})
    return sorted(rows, key=lambda r: -r["ms"])[:n]


def report(path):
    from hyperopt_tpu_torch.tracing import read_trace_log

    records, torn = read_trace_log(path)
    traces = [spans_of_record(r) for r in records if r.get("root") == "fmin.trial"]
    values, split = readings(traces)
    by_label, counts = counters(traces)
    return {"traces": len(traces), "torn": torn, "readings": values, "exclusive_ms": split,
            "by_label": by_label, "counts": counts, "slowest": slowest(traces)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=("report",))
    ap.add_argument("path", help="the log of a Tracer given to fmin(tracer=...)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    print(json.dumps(report(args.path), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
