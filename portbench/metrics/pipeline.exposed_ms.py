"""Milliseconds per trial the fmin loop waits for a suggest:
``FMinIter.timings`` "suggest" (a speculation's readback, or a
synchronous suggest after a miss) over the trials."""

from pathlib import Path

from portbench.core.registry import load_module

MOVES = "trial_ms"
_slice = load_module(Path(__file__).with_name("_slice.py"), "portbench_slice")


def read(run):
    c = _slice.fmin_counts(run)
    if run["kind"] != "fmin" or not c["n_trials"]:
        return None
    return c["timings"].get("suggest", {}).get("total_s", 0.0) * 1e3 / c["n_trials"]
