"""Space compiler: lowers an ``hp.*`` expression graph to a batched sampler.

Reference parity (SURVEY.md §2 #5): replaces ``hyperopt/vectorize.py`` —
``VectorizeHelper`` (~L220-650), ``vchoice_split``/``vchoice_merge``/
``idxs_map``/``idxs_take`` (~L20-150), ``replace_repeat_stochastic``
(~L150-220).

Design: the reference rewrites the per-trial sampling graph into a batched
sparse "idxs/vals" graph that is still *interpreted* per suggest.  Here the
space is compiled **once**: every labeled hyperparameter is extracted with
its distribution, literal parameters, and activation conditions (a DNF over
choice values, via ``expr_to_config``), and one pass of torch samplers on a
``torch.Generator`` draws *all* labels densely for a whole batch of trials;
branch-activity masks follow from the drawn choice values.  Masked dense sampling
replaces ``vchoice_split`` sparsity: fixed shapes, no per-node Python
interpretation.  The sparse idxs/vals *data model* is preserved at the API
boundary (trial misc docs) by :func:`idxs_vals_from_batch`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device
from .exceptions import BadSearchSpace
from .ops import dists as tdists
from .pyll.base import Apply, Literal, as_apply, clone, rec_eval, scope
from .pyll.stochastic import implicit_stochastic_symbols, recursive_set_rng_kwarg
from .pyll_utils import expr_to_config

logger = logging.getLogger(__name__)


class CompileError(BadSearchSpace):
    """Space cannot be lowered to the jitted sampler (fallback is used)."""


# arguments of each distribution that must be literal for compilation
_DIST_PARAM_NAMES = {
    "uniform": ("low", "high"),
    "quniform": ("low", "high", "q"),
    "loguniform": ("low", "high"),
    "qloguniform": ("low", "high", "q"),
    "uniformint": ("low", "high", "q"),
    "normal": ("mu", "sigma"),
    "qnormal": ("mu", "sigma", "q"),
    "lognormal": ("mu", "sigma"),
    "qlognormal": ("mu", "sigma", "q"),
    "randint": ("low", "high"),
    "categorical": ("p", "upper"),
}


def _literal_value(node: Apply):
    if isinstance(node, Literal):
        return node.obj
    if node.name == "pos_args" and all(
        isinstance(a, Literal) for a in node.pos_args
    ):
        return tuple(a.obj for a in node.pos_args)
    raise CompileError(
        f"distribution parameter is not a literal: {node.pprint()}"
    )


@dataclass
class ParamSpec:
    """One labeled hyperparameter extracted from the space graph."""

    label: str
    dist: str                      # scope symbol name, e.g. "loguniform"
    params: Dict[str, Any]         # literal distribution parameters
    conditions: Tuple[Tuple[Tuple[str, int], ...], ...]  # DNF of (label, val)
    node: Apply                    # the hyperopt_param node (memo key)
    dist_node: Apply               # the wrapped distribution node

    @property
    def is_integer(self) -> bool:
        return self.dist in tdists.INT_DISTS

    @property
    def upper(self) -> Optional[int]:
        """Number of categories for index-valued distributions."""
        if self.dist == "randint":
            return int(self.params["high"] - self.params.get("low", 0))
        if self.dist == "categorical":
            return len(self.params["p"])
        return None


def _extract_spec(label: str, hp_node: Apply, conditions) -> ParamSpec:
    dist_node = hp_node.pos_args[1] if hp_node.name == "hyperopt_param" else hp_node
    name = dist_node.name
    if name not in _DIST_PARAM_NAMES:
        raise CompileError(f"unsupported distribution {name!r} for {label!r}")
    arg_map = dist_node.arg
    params: Dict[str, Any] = {}
    for pname in _DIST_PARAM_NAMES[name]:
        if pname in arg_map:
            params[pname] = _literal_value(arg_map[pname])
    if name == "randint":
        # normalize randint(upper) / randint(low, high) to low/high form
        if "high" not in params:
            params = {"low": 0, "high": params["low"]}
    if name == "uniformint" and "q" not in params:
        params["q"] = 1.0
    # convert Cond DNF (op "=" only) into plain tuples
    dnf = []
    for conj in sorted(conditions, key=lambda c: [(x.name, x.val) for x in c] if c else []):
        terms = []
        for cond in conj:
            if cond.op != "=":
                raise CompileError(f"unsupported condition op {cond.op!r}")
            terms.append((cond.name, int(cond.val)))
        dnf.append(tuple(terms))
    return ParamSpec(
        label=label,
        dist=name,
        params=params,
        conditions=tuple(dnf),
        node=hp_node,
        dist_node=dist_node,
    )


class CompiledSpace:
    """A search space lowered to one batched sampler.

    ``sample_batch(seed, n)`` draws ``n`` independent full configurations:
    a dense value array per label (drawn on the device, read back once)
    plus a boolean activity mask per label (branch membership).  The
    interpreted per-trial fallback (used only for graphs with non-literal
    distribution parameters) mirrors the reference's ``rec_eval`` path.
    """

    def __init__(self, expr):
        self.expr = as_apply(expr)
        hps: Dict[str, dict] = {}
        expr_to_config(self.expr, (), hps)
        self.specs: Dict[str, ParamSpec] = {}
        self.compile_error: Optional[str] = None
        try:
            for label, info in hps.items():
                wrapper = _find_hyperopt_param(self.expr, label, info["node"])
                self.specs[label] = _extract_spec(
                    label, wrapper, info["conditions"]
                )
        except CompileError as e:
            self.compile_error = str(e)
            # still record labels so the fallback path knows them
            self.specs = {}
            for label, info in hps.items():
                wrapper = _find_hyperopt_param(self.expr, label, info["node"])
                self.specs[label] = ParamSpec(
                    label=label,
                    dist=info["node"].name,
                    params={},
                    conditions=(),
                    node=wrapper,
                    dist_node=info["node"],
                )
            logger.info("space not compilable, using interpreted sampler: %s", e)

    # -- public surface ------------------------------------------------
    @property
    def labels(self) -> List[str]:
        return list(self.specs)

    @property
    def compiled(self) -> bool:
        return self.compile_error is None

    def param_node(self, label) -> Apply:
        """The hyperopt_param node for ``label`` (Domain memo key)."""
        return self.specs[label].node

    def sample_batch(self, seed, n: int, device=None):
        """Draw ``n`` configurations → ``(vals, active)`` numpy dicts.

        ``seed`` (an int) seeds one ``torch.Generator`` on ``device``
        (None: the CUDA card) that draws every label in space order."""
        if not self.compiled:
            return self._sample_interpreted(seed, n)
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(seed))
        drawn = [tdists.SAMPLERS[sp.dist](gen, sp.params, n) for sp in self.specs.values()]
        flat = torch.cat([d.to(torch.float64) for d in drawn]).cpu().numpy()  # one readback
        vals = {}
        for i, (lb, sp) in enumerate(self.specs.items()):
            v = flat[i * n:(i + 1) * n]
            vals[lb] = v.astype(np.int32) if sp.is_integer else v.astype(np.float32)
        return vals, branch_activity(self.specs, vals, n)

    # -- interpreted fallback -------------------------------------------
    def _sample_interpreted(self, seed, n: int):
        rng = np.random.default_rng(seed)
        vals = {lb: [] for lb in self.specs}
        active = {lb: [] for lb in self.specs}
        for _ in range(n):
            memo_map: Dict[Apply, Apply] = {}
            cloned = clone(self.expr, memo_map)
            recursive_set_rng_kwarg(cloned, rng)
            _, memo = rec_eval(cloned, return_memo=True)
            for lb, sp in self.specs.items():
                cnode = memo_map[sp.node]
                if cnode in memo:
                    vals[lb].append(memo[cnode])
                    active[lb].append(True)
                else:
                    vals[lb].append(np.nan)
                    active[lb].append(False)
        return (
            {k: np.asarray(v) for k, v in vals.items()},
            {k: np.asarray(v, dtype=bool) for k, v in active.items()},
        )


def _find_hyperopt_param(expr, label, dist_node) -> Apply:
    """Locate the hyperopt_param wrapper whose second input is ``dist_node``."""
    from .pyll.base import dfs

    for node in dfs(expr):
        if (
            node.name == "hyperopt_param"
            and node.pos_args[0].obj == label
            and node.pos_args[1] is dist_node
        ):
            return node
    raise BadSearchSpace(f"hyperopt_param node for {label!r} not found")


def branch_activity(specs, vals, n: int):
    """Per label, the ``[n]`` bool mask of draws in which it is active:
    the DNF of its ``conditions`` over the drawn choice values ``vals``."""
    active = {}
    for lb, sp in specs.items():
        if not sp.conditions or any(len(conj) == 0 for conj in sp.conditions):
            active[lb] = np.ones(n, dtype=bool)
            continue
        disj = np.zeros(n, dtype=bool)
        for conj in sp.conditions:
            acc = np.ones(n, dtype=bool)
            for (name, val) in conj:
                acc &= np.asarray(vals[name]) == val
            disj |= acc
        active[lb] = disj
    return active


def idxs_vals_from_batch(tids, vals, active, specs):
    """Convert dense batch samples to the sparse idxs/vals trial data model.

    ``tids``: sequence of trial ids; ``vals``/``active``: dicts from
    :meth:`CompiledSpace.sample_batch`.  Returns ``(idxs, vals)`` dicts in
    the reference's misc format: per label, the ids of trials where the
    label is active and the corresponding values (python scalars).
    """
    idxs_by_label: Dict[str, list] = {}
    vals_by_label: Dict[str, list] = {}
    for lb, spec in specs.items():
        act = active[lb]
        vv = vals[lb]
        sel_ids = [int(t) for t, a in zip(tids, act) if a]
        if spec.is_integer:
            sel_vals = [int(v) for v, a in zip(vv, act) if a]
        else:
            sel_vals = [float(v) for v, a in zip(vv, act) if a]
        idxs_by_label[lb] = sel_ids
        vals_by_label[lb] = sel_vals
    return idxs_by_label, vals_by_label


