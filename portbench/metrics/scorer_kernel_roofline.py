"""The scoring kernel's share of its roofline in the traced slice, for
whichever kernel the program's scorer probe put on the path: #1
(``csrc/pair_score.cu``) or #2 (``csrc/fused_suggest.cu``, tile and
merge).  Both score the same cells, so the least time the card could take
for the launches the slice holds (``portbench/cost/pair_score.py`` and
``fused_suggest.py``: real mixture components only, 8 f32 operations per
cell at 67 TFLOP/s, or the bytes at 3.35 TB/s) is summed over both
kernels and set against their summed device time in ``torch.profiler``'s
trace.  The run's ``device.scorer_kernel`` names the kernel it stands
for.  Nothing when neither kernel ran."""

from pathlib import Path

from portbench.core.registry import load_module

MOVES = "trial_ms"
_slice = load_module(Path(__file__).with_name("_slice.py"), "portbench_slice")
_cost = Path(__file__).parents[1] / "cost"
COSTS = (load_module(_cost / "pair_score.py", "portbench_cost_pair_score"),
         load_module(_cost / "fused_suggest.py", "portbench_cost_fused_suggest"))


def read(run):
    return _slice.roofline_pct(run, COSTS)
