"""The fmin loop's own host milliseconds per trial: the window less the
time ``FMinIter.timings`` puts in "suggest" and "evaluate", over the
trials (refresh, state counts, the best-loss scan, inserts)."""

from pathlib import Path

from portbench.core.registry import load_module

MOVES = "trial_ms"
_slice = load_module(Path(__file__).with_name("_slice.py"), "portbench_slice")


def read(run):
    c = _slice.fmin_counts(run)
    if run["kind"] != "fmin" or not c["n_trials"]:
        return None
    inner = sum(c["timings"].get(k, {}).get("total_s", 0.0) for k in ("suggest", "evaluate"))
    return (c["window_s"] - inner) * 1e3 / c["n_trials"]
