"""Operations and bytes of kernel #2, the fused suggest kernel
(``hyperopt_tpu_torch/csrc/fused_suggest.cu``: a tile kernel and a merge
kernel per family), for its roofline share.

It scores the same cells as kernel #1 and keeps only each id's winner and
the EI partials, so its operations are #1's (``pair_score.py``: real
components only, 8 float32 operations per cell) and its bytes are the
candidates and the parameter rows read once; what it writes (a winner, an
index and a few partials per label) is left out as negligible.  The
program's fused tier takes this kernel in place of #1 when its timing
probe says so.
"""

from pathlib import Path

from portbench.core.registry import load_module

_pair = load_module(Path(__file__).with_name("pair_score.py"), "portbench_cost_pair")

KERNEL_SYMBOLS = ("fused_tile_kernel", "fused_merge_kernel")
LAUNCHES_PER_FAMILY = 2
bound_s = _pair.bound_s


def launch_cost(L, C, K):
    ops, _ = _pair.launch_cost(L, C, K)
    return ops, 4 * (L * C + 3 * L * K)


def suggest_launches(labels, algo, n_hist):
    return [launch_cost(L, C, K) for L, C, K in _pair.suggest_shapes(labels, algo, n_hist)]
