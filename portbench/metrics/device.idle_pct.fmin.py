"""Percent of the traced slice of the fmin cells in which no operation ran
on the card: 1 - (union of device intervals) / (slice's wall time)."""

from pathlib import Path

from portbench.core.registry import load_module

MOVES = "trial_ms"
_slice = load_module(Path(__file__).with_name("_slice.py"), "portbench_slice")


def read(run):
    return _slice.idle_pct(run, "fmin")
