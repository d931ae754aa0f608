"""Search-space DSL implementations + conditionality extraction.

Reference parity (SURVEY.md §2 #3): ``hyperopt/pyll_utils.py`` —
``validate_label`` (~L10-35), ``hp_choice``/``hp_pchoice`` (~L35-90),
``hp_uniform``…``hp_qlognormal``/``hp_randint``/``hp_uniformint``
(~L90-200), ``Cond``/``EQ``/``expr_to_config`` (~L200-280).

Every ``hp_*`` returns a graph of the canonical shape
``float|int(hyperopt_param(label, <dist>(...)))`` so that both the space
compiler (``hyperopt_tpu_torch.vectorize``) and the conditionality walker below can
pattern-match hyperparameters structurally.
"""

from __future__ import annotations

from functools import partial, wraps

from .exceptions import DuplicateLabel, InvalidSpaceError
from .pyll.base import Apply, Literal, as_apply, dfs, scope


def _scalar(v):
    """The plain numeric value of ``v`` (unwrapping a numeric Literal),
    or None when it is an expression we cannot validate statically."""
    if isinstance(v, Literal):
        v = v.obj
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        try:
            import numpy as _np

            if isinstance(v, (_np.integer, _np.floating)):
                return float(v)
        except ImportError:  # pragma: no cover
            pass
        return None
    return float(v)


def _label_str(label):
    return label.obj if isinstance(label, Literal) else label


def _check_bounds(label, low, high):
    """Construction-time guard: low < high (when both are static).  A
    violation fails on device as NaN many trials later; fail here with
    the offending label instead."""
    lo, hi = _scalar(low), _scalar(high)
    if lo is not None and hi is not None and lo >= hi:
        raise InvalidSpaceError(
            f"hyperparameter {_label_str(label)!r}: low={lo:g} must be "
            f"< high={hi:g}",
            label=_label_str(label),
        )


def _check_positive(label, name, value):
    v = _scalar(value)
    if v is not None and v <= 0:
        raise InvalidSpaceError(
            f"hyperparameter {_label_str(label)!r}: {name}={v:g} must be > 0",
            label=_label_str(label),
        )


def _check_choice_labels(label, options):
    """Construction-time duplicate-label guard for choice branches.

    One label naming two DISTINCT nodes across (or inside) branches
    would silently merge their observation histories; today that only
    surfaces at ``expr_to_config`` time (Domain construction) without
    saying *where*.  Detect it when the branches are assembled and name
    both branch paths.  Sharing one node object across branches remains
    legal (intentional conditional reuse)."""
    seen = {}  # label -> (node id, branch index, node)
    for i, opt in enumerate(options):
        try:
            branch = as_apply(opt)
        except Exception:
            continue  # not a pyll graph: nothing to collide with
        for node in dfs(branch):
            if getattr(node, "name", None) != "hyperopt_param":
                continue
            lb = node.pos_args[0].obj
            prev = seen.get(lb)
            if prev is None:
                seen[lb] = (id(node.pos_args[1]), i, node)
            elif prev[0] != id(node.pos_args[1]):
                where = (
                    f"branch {prev[1]} vs branch {i}" if prev[1] != i
                    else f"twice inside branch {i}"
                )
                raise DuplicateLabel(
                    f"label {lb!r} names two distinct hyperparameters "
                    f"under choice {_label_str(label)!r} ({where}); their "
                    f"observation histories would silently merge — give "
                    f"each a unique label, or share one node object for "
                    f"intentional reuse"
                )


def validate_label(f):
    @wraps(f)
    def wrapper(label, *args, **kwargs):
        is_real_string = isinstance(label, str)
        is_literal_string = isinstance(label, Literal) and isinstance(label.obj, str)
        if not is_real_string and not is_literal_string:
            raise TypeError("require string label", label)
        return f(label, *args, **kwargs)

    return wrapper


# ---------------------------------------------------------------------
# hp_* constructors
# ---------------------------------------------------------------------


@validate_label
def hp_choice(label, options):
    """Categorical choice among ``options`` (each may be a nested space)."""
    if isinstance(options, dict):
        raise TypeError(
            "hp.choice takes a list of options; for weighted choices use "
            "hp.pchoice, for named branches embed dicts in the list"
        )
    options = list(options)
    _check_choice_labels(label, options)
    ch = scope.hyperopt_param(label, scope.randint(len(options)))
    return scope.switch(ch, *options)


@validate_label
def hp_pchoice(label, p_options):
    """Weighted choice: ``p_options`` is a list of ``(prob, option)``."""
    p, options = list(zip(*p_options))
    if abs(sum(p) - 1.0) > 1e-5:
        raise ValueError(f"hp.pchoice probabilities must sum to 1, got {sum(p)}")
    _check_choice_labels(label, options)
    ch = scope.hyperopt_param(label, scope.categorical(list(p), len(options)))
    return scope.switch(ch, *options)


@validate_label
def hp_uniform(label, low, high):
    _check_bounds(label, low, high)
    return scope.float(scope.hyperopt_param(label, scope.uniform(low, high)))


@validate_label
def hp_quniform(label, low, high, q):
    _check_bounds(label, low, high)
    _check_positive(label, "q", q)
    return scope.float(scope.hyperopt_param(label, scope.quniform(low, high, q)))


@validate_label
def hp_uniformint(label, low, high, q=1.0):
    _check_bounds(label, low, high)
    _check_positive(label, "q", q)
    return scope.int(scope.hyperopt_param(label, scope.uniformint(low, high, q=q)))


@validate_label
def hp_loguniform(label, low, high):
    _check_bounds(label, low, high)
    return scope.float(scope.hyperopt_param(label, scope.loguniform(low, high)))


@validate_label
def hp_qloguniform(label, low, high, q):
    _check_bounds(label, low, high)
    _check_positive(label, "q", q)
    return scope.float(scope.hyperopt_param(label, scope.qloguniform(low, high, q)))


@validate_label
def hp_normal(label, mu, sigma):
    _check_positive(label, "sigma", sigma)
    return scope.float(scope.hyperopt_param(label, scope.normal(mu, sigma)))


@validate_label
def hp_qnormal(label, mu, sigma, q):
    _check_positive(label, "sigma", sigma)
    _check_positive(label, "q", q)
    return scope.float(scope.hyperopt_param(label, scope.qnormal(mu, sigma, q)))


@validate_label
def hp_lognormal(label, mu, sigma):
    _check_positive(label, "sigma", sigma)
    return scope.float(scope.hyperopt_param(label, scope.lognormal(mu, sigma)))


@validate_label
def hp_qlognormal(label, mu, sigma, q):
    _check_positive(label, "sigma", sigma)
    _check_positive(label, "q", q)
    return scope.float(scope.hyperopt_param(label, scope.qlognormal(mu, sigma, q)))


@validate_label
def hp_randint(label, *args):
    """``hp.randint(label, upper)`` or ``hp.randint(label, low, high)``."""
    if len(args) not in (1, 2):
        raise ValueError("randint requires 1 or 2 bound arguments")
    if len(args) == 1:
        _check_positive(label, "upper", args[0])
    else:
        _check_bounds(label, *args)
    return scope.hyperopt_param(label, scope.randint(*args))


# ---------------------------------------------------------------------
# Conditionality extraction
# ---------------------------------------------------------------------


class Cond:
    """A single condition ``<name> <op> <val>`` on a hyperparameter."""

    def __init__(self, name, val, op):
        self.op = op
        self.name = name
        self.val = val

    def __str__(self):
        return f"Cond{{{self.name} {self.op} {self.val}}}"

    __repr__ = __str__

    def __eq__(self, other):
        return (
            isinstance(other, Cond)
            and self.op == other.op
            and self.name == other.name
            and self.val == other.val
        )

    def __hash__(self):
        return hash((self.op, self.name, self.val))

    def __call__(self, memo):
        """Evaluate against a {label: value} assignment (None = inactive)."""
        if self.name not in memo:
            raise KeyError(self.name)
        v = memo[self.name]
        if v is None:
            return False
        if self.op == "=":
            return v == self.val
        if self.op == ">":
            return v > self.val
        if self.op == "<":
            return v < self.val
        raise NotImplementedError(f"condition op {self.op!r}")


EQ = partial(Cond, op="=")


def _expr_to_config(expr, conditions, hps):
    if expr.name == "switch":
        idx = expr.pos_args[0]
        options = expr.pos_args[1:]
        assert idx.name == "hyperopt_param", (
            "switch driven by a non-hyperparameter index is not a "
            "conditional search-space construct"
        )
        label = idx.pos_args[0].obj
        _expr_to_config(idx, conditions, hps)
        for ii, opt in enumerate(options):
            _expr_to_config(opt, conditions + (EQ(label, ii),), hps)
    elif expr.name == "hyperopt_param":
        label = expr.pos_args[0].obj
        node = expr.pos_args[1]
        if label in hps:
            if hps[label]["node"] is not node:
                raise DuplicateLabel(label)
            hps[label]["conditions"].add(conditions)
        else:
            hps[label] = {
                "node": node,
                "conditions": {conditions},
                "label": label,
            }
    else:
        for child in expr.inputs():
            _expr_to_config(child, conditions, hps)


def _simplify_conditions(hps):
    """If a label is reachable unconditionally, drop all other paths."""
    for v in hps.values():
        if () in v["conditions"]:
            v["conditions"] = {()}


def expr_to_config(expr, conditions, hps):
    """Populate ``hps`` with ``{label: {node, conditions, label}}``.

    ``conditions`` is the tuple of :class:`Cond` assumed true at ``expr``
    (use ``()`` at the root).  Each label's ``conditions`` is a *set of
    conjunctions* (DNF): the label is active if any conjunction holds.
    Raises :class:`DuplicateLabel` if one label names two distinct nodes.
    """
    if conditions is None:
        conditions = ()
    expr = as_apply(expr)
    _expr_to_config(expr, conditions, hps)
    _simplify_conditions(hps)
