"""Operations and bytes of kernel #1, the pair-score kernel
(``hyperopt_tpu_torch/csrc/pair_score.cu``), for its roofline share.

One launch scores ``C`` candidates of ``L`` labels against each label's
below and above mixtures.  Its work is counted on the real components
only (the ``n_below`` and ``n_above`` observations and one prior
component in each mixture), never on the padding of the program's
power-of-two buckets: 8 float32 operations per (label, candidate,
component) cell, the count ``chip_smoke.OPS_PER_CELL`` uses.  Its bytes
are each input read once (the candidates, the three parameter rows of
each component) and the output written once, in float32.

Which labels share a launch follows the program's grouping, copied here
so the yardstick does not move with the program: the unquantized
continuous labels, one launch per scale (linear or log) in the order the
space first names them.  The split is hyperopt's:
``n_below = min(ceil(gamma * sqrt(N)), linear_forgetting)``.
"""

import math
from pathlib import Path

from portbench.core.registry import load_module

OPS_PER_CELL = 8
KERNEL_SYMBOLS = ("pair_score_kernel",)
LAUNCHES_PER_FAMILY = 1
PEAKS = load_module(Path(__file__).with_name("peaks.py"), "portbench_peaks").H100_SXM
UNQUANTIZED = {"uniform": False, "normal": False, "loguniform": True, "lognormal": True}


def launch_cost(L, C, K):
    """``(operations, bytes)`` of one launch over ``K`` mixture
    components per label."""
    ops = OPS_PER_CELL * L * C * K
    nbytes = 4 * (L * C + 3 * L * K + L * C)
    return ops, nbytes


def bound_s(ops, nbytes, peaks=PEAKS):
    """The least time the card could take: the larger of the operations
    at the f32 peak and the bytes at the HBM peak."""
    return max(ops / peaks["f32_flops"], nbytes / peaks["hbm_bytes"])


def split(n_hist, gamma, lf):
    n_below = int(math.ceil(gamma * math.sqrt(n_hist)))
    if lf is not None:
        n_below = min(n_below, int(lf))
    return n_below, n_hist - n_below


def suggest_shapes(labels, algo, n_hist):
    """``[(L, C, K)]`` of the launches of one single-id suggest at a
    history of ``n_hist`` completed trials, ``K`` the real components of
    both mixtures."""
    groups = {}
    for lab in labels:
        if lab["dist"] in UNQUANTIZED:
            groups.setdefault(UNQUANTIZED[lab["dist"]], []).append(lab["label"])
    nb, na = split(n_hist, float(algo["gamma"]), algo.get("linear_forgetting"))
    C = int(algo["n_EI_candidates"])
    return [(len(g), C, (nb + 1) + (na + 1)) for g in groups.values()]


def suggest_launches(labels, algo, n_hist):
    """``[(ops, bytes)]`` of those launches."""
    return [launch_cost(*shape) for shape in suggest_shapes(labels, algo, n_hist)]
