"""Pass 1: static lint of ``hp.*`` search-space graphs.

Walks the pyll stochastic expression graph of any space (dict / nested
``hp.choice`` / raw Apply) tracking the *graph path* and the activation
conditions of every node, and flags the malformations that today fail
deep inside the device suggest — NaNs or shape errors trials after
the fit engages — as structured diagnostics with the offending label's
path.

Rules (catalog in :mod:`.diagnostics`): SP101 duplicate/shadowed labels,
SP102 inverted bounds, SP103/SP104 non-positive q/sigma, SP105/SP106
float32 overflow/underflow of log-scale ranges, SP107 unreachable choice
branches, SP108 int-cast truncation hazards.

Pure analysis: never raises on a malformed space (that is what it is
for), never samples, never touches a device.

Reference parity: ``hyperopt_tpu/analysis/space_lint.py``, over the
port's own ``pyll``; the rules, messages and locations are the
reference's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from ..pyll.base import Apply, Literal, as_apply
from .diagnostics import Diagnostic, apply_suppressions, make

# float32 envelope for device-side fit-space values
_F32_MAX_LOG = math.log(3.4028235e38)   # ~88.72: exp(x) overflows above
_F32_TINY_LOG = math.log(1.1754944e-38)  # ~-87.34: exp(x) underflows below

_BOUNDED = {"uniform", "quniform", "loguniform", "qloguniform", "uniformint"}
_LOG_SCALE = {"loguniform", "qloguniform"}
_QUANTIZED = {"quniform", "qloguniform", "qnormal", "qlognormal", "uniformint"}
_NORMAL = {"normal", "qnormal", "lognormal", "qlognormal"}
_INT_VALUED = {"uniformint", "randint"}

# positional parameter names per distribution (pyll scope signatures)
_POS_PARAMS = {
    "uniform": ("low", "high"),
    "quniform": ("low", "high", "q"),
    "uniformint": ("low", "high", "q"),
    "loguniform": ("low", "high"),
    "qloguniform": ("low", "high", "q"),
    "normal": ("mu", "sigma"),
    "qnormal": ("mu", "sigma", "q"),
    "lognormal": ("mu", "sigma"),
    "qlognormal": ("mu", "sigma", "q"),
    "randint": ("low", "high"),
    "categorical": ("p", "upper"),
}


def _literal(node) -> Optional[Any]:
    """The python value of a literal(ish) node, else None."""
    if isinstance(node, Literal):
        return node.obj
    if isinstance(node, Apply) and node.name == "pos_args" and all(
        isinstance(a, Literal) for a in node.pos_args
    ):
        return tuple(a.obj for a in node.pos_args)
    return None


def _dist_params(dist_node: Apply) -> Dict[str, Any]:
    """Literal parameters of a distribution node (missing ones omitted)."""
    names = _POS_PARAMS.get(dist_node.name, ())
    params: Dict[str, Any] = {}
    for i, arg in enumerate(dist_node.pos_args):
        if i < len(names):
            v = _literal(arg)
            if v is not None:
                params[names[i]] = v
    for key, arg in dist_node.named_args:
        v = _literal(arg)
        if v is not None:
            params[key] = v
    if dist_node.name == "randint" and "high" not in params and "low" in params:
        params = {"low": 0, "high": params["low"]}
    return params


def _num(params, key) -> Optional[float]:
    v = params.get(key)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    if isinstance(v, float) and math.isnan(v):
        return None
    return float(v)


class _Site:
    """One occurrence of a labeled hyperparameter in the graph."""

    __slots__ = ("label", "dist_node", "path", "conditions")

    def __init__(self, label, dist_node, path, conditions):
        self.label = label
        self.dist_node = dist_node
        self.path = path
        self.conditions = conditions  # tuple of (label, branch) conj


def _walk(node, path, conditions, sites, choice_meta, seen):
    """Collect hyperopt_param sites with paths + conditions.

    ``seen`` memoizes on (node id, conditions): a shared subgraph is
    visited once per distinct activation context, which is exactly the
    granularity the duplicate/unreachable rules reason about.
    """
    key = (id(node), conditions)
    if key in seen:
        return
    seen.add(key)
    if not isinstance(node, Apply):
        return
    if node.name == "switch" and node.pos_args:
        idx = node.pos_args[0]
        options = node.pos_args[1:]
        if isinstance(idx, Apply) and idx.name == "hyperopt_param":
            label = idx.pos_args[0].obj
            cpath = (f"{path}." if path else "") + f"choice[{label!r}]"
            choice_meta.append((label, idx.pos_args[1], cpath, len(options)))
            _walk(idx, cpath, conditions, sites, choice_meta, seen)
            for i, opt in enumerate(options):
                _walk(
                    opt, f"{cpath}[{i}]", conditions + ((label, i),),
                    sites, choice_meta, seen,
                )
            return
        # switch over a non-hyperparameter index: not a conditional
        # construct; fall through to the generic traversal
    if node.name == "hyperopt_param":
        label = node.pos_args[0].obj
        dist_node = node.pos_args[1]
        sites.append(_Site(label, dist_node, path or f"<{label}>", conditions))
        return
    if node.name == "dict":
        for key_name, child in node.named_args:
            child_path = f"{path}.{key_name}" if path else str(key_name)
            _walk(child, child_path, conditions, sites, choice_meta, seen)
        return
    if node.name == "pos_args":
        for i, child in enumerate(node.pos_args):
            _walk(child, f"{path}[{i}]", conditions, sites, choice_meta, seen)
        return
    for child in node.inputs():
        _walk(child, path, conditions, sites, choice_meta, seen)


def _lint_site(site: _Site) -> List[Diagnostic]:
    """Per-site numeric rules (SP102-SP106, SP108)."""
    out: List[Diagnostic] = []
    d = site.dist_node.name
    params = _dist_params(site.dist_node)
    loc = f"{site.path} (label {site.label!r})"

    low, high = _num(params, "low"), _num(params, "high")
    q = _num(params, "q")
    sigma = _num(params, "sigma")

    if d in _BOUNDED and low is not None and high is not None and low >= high:
        out.append(make(
            "SP102", loc,
            f"{d} bounds inverted: low={low:g} >= high={high:g}",
            hint="swap the bounds, or widen the range so low < high",
        ))
    if d == "randint" and low is not None and high is not None and low >= high:
        out.append(make(
            "SP102", loc,
            f"randint range empty: low={low:g} >= high={high:g}",
            hint="randint(label, upper) needs upper >= 1; "
                 "randint(label, low, high) needs low < high",
        ))
    if d in _QUANTIZED and q is not None and q <= 0:
        out.append(make(
            "SP103", loc, f"{d} has q={q:g} (must be > 0)",
            hint="q is the lattice step: round(x/q)*q",
        ))
    if d in _NORMAL and sigma is not None and sigma <= 0:
        out.append(make(
            "SP104", loc, f"{d} has sigma={sigma:g} (must be > 0)",
            hint="sigma is the prior width of the Parzen fit",
        ))
    if d in _LOG_SCALE and low is not None and high is not None and low < high:
        if high > _F32_MAX_LOG:
            out.append(make(
                "SP105", loc,
                f"{d} high={high:g} means exp(high)≈{math.exp(min(high, 700)):.3g} "
                f"overflows float32 on device (max ~3.4e38)",
                hint="bounds of log-scale dists are exponents: "
                     "hp.loguniform('x', log(1e-3), log(1e3)) samples "
                     "[1e-3, 1e3]; keep high <= ~88",
            ))
        if low < _F32_TINY_LOG:
            out.append(make(
                "SP106", loc,
                f"{d} low={low:g} means exp(low) underflows float32 to 0 "
                f"on device (tiny ~1.2e-38)",
                hint="keep low >= ~-87, or rescale the parameter",
            ))
    if d in _INT_VALUED:
        for name, v in (("low", low), ("high", high)):
            if v is not None and v != int(v):
                out.append(make(
                    "SP108", loc,
                    f"{d} {name}={v:g} is not an integer; the int() cast "
                    f"truncates the lattice asymmetrically",
                    hint=f"use integer bounds for {d}",
                ))
        q_int = _num(params, "q")
        if q_int is not None and q_int > 0 and q_int != int(q_int):
            out.append(make(
                "SP108", loc,
                f"{d} q={q_int:g} is not an integer; int() truncation "
                f"collapses adjacent lattice points",
                hint="use an integer q (or hp.quniform for float lattices)",
            ))
    if (
        d in ("quniform", "uniformint")
        and low is not None and high is not None and q is not None
        and q > 0 and low < high
    ):
        span = high - low
        frac = span / q - round(span / q)
        if abs(frac) > 1e-9:
            out.append(make(
                "SP108", loc,
                f"{d} span high-low={span:g} is not a multiple of q={q:g}: "
                f"the top lattice point rounds past high and gets clipped, "
                f"doubling its probability mass",
                hint="pick bounds with (high - low) % q == 0",
            ))
    return out


def lint_space(space, suppress=()) -> List[Diagnostic]:
    """Lint one search space; returns structured diagnostics (never raises
    on a malformed space)."""
    try:
        expr = as_apply(space)
    except Exception as e:  # not even expressible as a pyll graph
        return apply_suppressions(
            [make("SP101", "<space>", f"space is not a pyll graph: {e}",
                  severity="error")],
            suppress,
        )
    sites: List[_Site] = []
    choice_meta: List[Tuple[str, Apply, str, int]] = []
    _walk(expr, "", (), sites, choice_meta, set())

    out: List[Diagnostic] = []

    # SP101: one label, >=2 distinct distribution nodes
    by_label: Dict[str, Dict[int, _Site]] = {}
    for site in sites:
        by_label.setdefault(site.label, {}).setdefault(id(site.dist_node), site)
    for label, nodes in by_label.items():
        if len(nodes) > 1:
            paths = sorted(s.path for s in nodes.values())
            out.append(make(
                "SP101", " vs ".join(paths),
                f"label {label!r} names {len(nodes)} distinct "
                f"hyperparameters; their observation histories would "
                f"silently merge",
                hint="give each parameter a unique label (e.g. prefix "
                     "with its branch name), or share one node object "
                     "for intentional cross-branch sharing",
            ))

    # SP107: unreachable branches / contradictory conditions
    for label, dist_node, cpath, n_options in choice_meta:
        if n_options <= 1:
            out.append(make(
                "SP107", cpath,
                f"choice {label!r} has {n_options} option(s); the "
                f"parameter is constant",
                hint="inline the single option, or add alternatives",
            ))
        if dist_node.name == "categorical":
            p = _literal(dist_node.pos_args[0]) if dist_node.pos_args else None
            if isinstance(p, (tuple, list)):
                for i, pi in enumerate(p):
                    if isinstance(pi, (int, float)) and pi == 0:
                        out.append(make(
                            "SP107", f"{cpath}[{i}]",
                            f"pchoice {label!r} branch {i} has probability "
                            f"0: it is never sampled and never fit",
                            hint="drop the branch, or give it mass",
                        ))
    for site in sites:
        counts: Dict[str, set] = {}
        for lbl, val in site.conditions:
            counts.setdefault(lbl, set()).add(val)
        contradicted = [lbl for lbl, vals in counts.items() if len(vals) > 1]
        if contradicted:
            out.append(make(
                "SP107", f"{site.path} (label {site.label!r})",
                f"activation requires {contradicted[0]!r} to equal two "
                f"different branch values at once; the parameter is "
                f"unreachable",
                hint="a nested choice re-uses its ancestor's switch — "
                     "restructure the branches",
            ))

    # numeric per-site rules, deduplicated for shared nodes reached via
    # several paths (one diagnostic per distinct dist node per rule)
    seen_site: set = set()
    for site in sites:
        if id(site.dist_node) in seen_site:
            continue
        seen_site.add(id(site.dist_node))
        out.extend(_lint_site(site))

    return apply_suppressions(out, suppress)
