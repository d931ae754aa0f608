"""CUDA kernels per suggest in the traced slice of the fmin cells: kernel
events in ``torch.profiler``'s trace over the suggests served in it."""

from pathlib import Path

from portbench.core.registry import load_module

MOVES = "trial_ms"
_slice = load_module(Path(__file__).with_name("_slice.py"), "portbench_slice")


def read(run):
    return _slice.kernels_per_suggest(run, "fmin")
