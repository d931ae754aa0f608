"""The drivers a traffic mix names by ``driver``: ``fmin``.

Each builds the system under test from the program's public entry points,
fills it with the history the benchmark makes from the seed, warms every
shape its window reaches, runs the window, and hands back what the run
collected: window times and counts, the program's own stats, the traced
slice, and the trials the program produced, for the check.
"""

from __future__ import annotations

import time
from functools import partial

from . import history, spaces
from .trace import SliceTracer, Spans

SLICE_MAX_S = 8.0


class Ctx:
    """What a driver needs: the program (``T``), torch, the cell's files,
    the run's arguments and the device."""

    def __init__(self, T, torch, cfg, loss_module, traffic, seed, seconds, trace, device):
        self.T, self.torch = T, torch
        self.cfg, self.traffic = cfg, traffic
        self.labels, self.algo = cfg["labels"], cfg["algo"]
        self.loss = loss_module.loss
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device

    @property
    def on_card(self):
        return self.device != "cpu"

    def sync(self):
        if self.on_card:
            self.torch.cuda.synchronize()


def history_docs(T, labels, vals, losses, start=0):
    """Completed trial documents for a history made by the benchmark."""
    docs = []
    for i in range(len(losses)):
        tid = start + i
        v = {lab["label"]: vals[lab["label"]][i].item() for lab in labels}
        docs.append({
            "tid": tid, "spec": None,
            "result": {"status": T.STATUS_OK, "loss": float(losses[i])},
            "misc": {"tid": tid, "cmd": None, "idxs": {k: [tid] for k in v},
                     "vals": {k: [x] for k, x in v.items()}},
            "state": T.JOB_STATE_DONE, "owner": None, "book_time": None,
            "refresh_time": None, "exp_key": None,
        })
    return docs


HISTORY_TAG = 1   # the stream of the study the window continues


def make_history(cfg, loss, seed, n, tag, device):
    return history.make_history(cfg["labels"], loss, seed, tag, n, device,
                                int(cfg["history_workers"]))


def study_history(cfg, loss, seed, device):
    """The history of the study an ``fmin`` cell's window continues: also
    what the check's control starts from."""
    return make_history(cfg, loss, seed, int(cfg["history"]), HISTORY_TAG, device)


def reset_peak(ctx):
    """Forget the memory the benchmark's own history making took, so that
    ``memory_peak_bytes`` is the program's."""
    if ctx.on_card:
        ctx.torch.cuda.synchronize()
        ctx.torch.cuda.empty_cache()
        ctx.torch.cuda.reset_peak_memory_stats()


def fill(T, trials, docs):
    trials.insert_trial_docs(docs)
    trials.refresh()


def boundaries(n0, reach):
    """The power-of-two history sizes a study crosses from ``n0`` on."""
    out, b = [], 1
    while b <= n0:
        b *= 2
    while b <= n0 + reach:
        out.append(b)
        b *= 2
    return out


def slice_times(t0, seconds):
    """The traced slice: the window's last third, at most SLICE_MAX_S.
    Stopping the profiler takes seconds, so it comes as the window ends,
    and the per-layer readers take the program's own counts from the part
    of the window before the slice."""
    length = min(SLICE_MAX_S, seconds / 3.0)
    return t0 + seconds - length, t0 + seconds


def recorded(trial, labels):
    """A program trial as the check reads it."""
    vals = {lab["label"]: trial["misc"]["vals"][lab["label"]][0] for lab in labels
            if trial["misc"]["vals"].get(lab["label"])}
    res = trial.get("result") or {}
    return {"tid": int(trial["tid"]), "vals": vals,
            "stored_loss": res.get("loss") if res.get("status") == "ok" else None}


# ---------------------------------------------------------------------
# fmin
# ---------------------------------------------------------------------


def run_fmin(ctx, t_mark):
    """``t_mark(name)`` records the harness's own milestones."""
    T, torch = ctx.T, ctx.torch
    obj_s = float(ctx.traffic["objective_s"])
    spans = Spans()
    space = spaces.build_space(T.hp, ctx.labels)
    algo = partial(T.tpe.suggest, device=ctx.device, **ctx.algo)
    k = ctx.traffic.get("max_speculation")

    def objective(point):
        t0 = time.monotonic()
        if obj_s > 0:
            time.sleep(obj_s)
        value = float(ctx.loss(point))
        spans.add("objective", t0, time.monotonic())
        return value

    def driver(trials, rstate, **kw):
        # as fmin builds it (fmin.py: Domain, then FMinIter)
        return T.FMinIter(algo, T.Domain(objective, space), trials, rstate,
                          max_queue_len=1, show_progressbar=False, max_speculation=k, **kw)

    # shapes the window reaches: each power-of-two history bucket crossed,
    # warmed on a throwaway history just below it; every history is made
    # before the program runs
    n0 = int(ctx.cfg["history"])
    reach = int(ctx.traffic["warm_reach"])
    vals, losses = study_history(ctx.cfg, ctx.loss, ctx.seed, ctx.device)
    throwaways = [make_history(ctx.cfg, ctx.loss, ctx.seed, b - 2, 100 + j, ctx.device)
                  for j, b in enumerate(boundaries(n0 + ctx.traffic["warm_trials"], reach))]
    reset_peak(ctx)
    t_mark("history")
    for j, (tv, tl) in enumerate(throwaways):
        throwaway = T.Trials()
        fill(T, throwaway, history_docs(T, ctx.labels, tv, tl))
        driver(throwaway, spaces.rng_for(ctx.seed, 200 + j)).run(4)
        del throwaway
    del throwaways
    t_mark("warm_buckets")

    trials = T.Trials()
    fill(T, trials, history_docs(T, ctx.labels, vals, losses))
    t_mark("fill")
    rstate = spaces.rng_for(ctx.seed, 2)
    driver(trials, rstate).run(int(ctx.traffic["warm_trials"]))
    ctx.sync()
    n_warm = len(trials.trials)
    t_mark("warm")

    if ctx.trace:
        SliceTracer.warm(torch)
    tracer = None

    def tick(_trials, *_args):
        # FMinIter calls this on its own thread, which launches the
        # suggests, after every trial
        if tracer is not None:
            tracer.tick()
        return False, []

    it = driver(trials, rstate, timeout=ctx.seconds, early_stop_fn=tick)

    def snapshot():
        return {"t": time.monotonic(), "n": len(trials.trials),
                "timings": it.timings.summary(),
                "speculation": it.speculation_stats.summary()}

    t0 = time.monotonic()
    if ctx.trace:
        tracer = SliceTracer(torch, *slice_times(t0, ctx.seconds), snapshot=snapshot)
    it.run(10 ** 9)
    ctx.sync()
    t1 = time.monotonic()
    spans.add("fmin", t0, t1)
    window = trials.trials[n_warm:]
    out = {
        "kind": "fmin", "t0": t0, "t1": t1, "window_s": t1 - t0,
        "attempted": len(window),
        "failed": sum(1 for t in window if t["state"] != T.JOB_STATE_DONE
                      or (t.get("result") or {}).get("status") != "ok"),
        "n_trials": len(window),
        "timings": it.timings.summary(),
        "speculation": it.speculation_stats.summary(),
        "spans": spans,
    }
    if tracer is not None:
        tracer.stop()
        tracer.collect()
    if tracer is not None and tracer.raw is not None:
        out["untraced"] = _fmin_untraced(tracer.snaps, t0, n_warm)
        sl = tracer.read(spans, ["objective", "fmin"])
        starts = [a for a, _ in spans.named("objective") if a >= t0]
        sl["suggests"] = sum(1 for a in starts if sl["t0"] <= a < sl["t1"])
        done = sum(1 for a in starts if a < sl["t0"])
        sl["history"] = n_warm + done + sl["suggests"] / 2.0
        out["slice"] = sl
    out["studies"] = [{
        "history_vals": vals, "history_losses": losses,
        "trials": [recorded(t, ctx.labels) for t in trials.trials[n0:]],
        "window_from": n_warm - n0,
    }]
    out["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated())
                                if ctx.on_card else 0)
    del it, trials
    return out


def _fmin_untraced(snaps, t0, n_warm):
    """The window's counts before the traced slice (the profiler slows
    launches while it records)."""
    if not snaps:
        return None
    s0 = snaps[0]
    spec = dict(s0["speculation"])
    total = spec["hidden_s"] + spec["exposed_s"]
    spec["hidden_frac"] = spec["hidden_s"] / total if total > 0 else None
    return {"window_s": s0["t"] - t0, "n_trials": s0["n"] - n_warm,
            "timings": s0["timings"], "speculation": spec}


DRIVERS = {"fmin": run_fmin}
