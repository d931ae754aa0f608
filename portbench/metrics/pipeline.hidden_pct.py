"""Share of suggest time the pipeline hid behind the objective:
``FMinIter.speculation_stats`` ``hidden_frac``, in percent."""

from pathlib import Path

from portbench.core.registry import load_module

MOVES = "trial_ms"
_slice = load_module(Path(__file__).with_name("_slice.py"), "portbench_slice")


def read(run):
    if run["kind"] != "fmin":
        return None
    frac = _slice.fmin_counts(run)["speculation"].get("hidden_frac")
    return None if frac is None else 100.0 * frac
