"""Pass 2: the recompile audit of the device suggest programs.

The reference lints jitted programs: their donation contract, host
callbacks and float64 leaks in their jaxprs, and the replicated-pin
contract of a partitioned mesh (``hyperopt_tpu/analysis/program_lint.py``,
PL201–PL204, PL206, PL207, PL209).  Nothing in the port is jitted,
donated or partitioned, so those rules have no counterpart here.  What
carries over is the cache-key discipline, in two checks:

1. **Recompile audit** (:class:`RecompilationAuditor`, PL205).  A
   *compile event* of the port is the first dispatch in the process of a
   ``tpe_device.program_key`` (its static signature and its arguments'
   shapes and dtypes); ``tpe_device._trace_observers`` fire once per
   event.  Buffers grow in power-of-two buckets, so over an N-trial run
   each family signature compiles once per trial-count bucket.  The
   auditor groups the events by ``tpe_device.compile_key(sig, shapes)``
   (the (trial-count bucket, families) pair the service's compile metric
   and the compile ledger use) and flags any group with more than one
   event: a per-call value (a dtype that flaps, a Python scalar whose
   type changes, a container) leaked into the key, and the program pays
   a compile event per call.

2. **Dispatch containers** (:func:`lint_dispatch_callers`, PL208,
   static).  Every ``multi_family_suggest(_async)`` /
   ``multi_study_suggest_async`` call site in the package must hand its
   request args in the tuple form, the one form the program key and the
   reference's contract agree on (``args_shapes`` names a list argument
   ``"py:list"``, so a list that reaches the key changes it).
"""

from __future__ import annotations

import ast
from functools import partial
from typing import Dict, List, Tuple

from .diagnostics import (
    Diagnostic,
    apply_suppressions,
    dotted_chain as _dotted,
    make,
)


# ---------------------------------------------------------------------
# 1. recompile audit (PL205)
# ---------------------------------------------------------------------


class RecompilationAuditor:
    """Records the compile events of the device suggest programs while
    active, grouped by (trial-count bucket, families).

    Use as a context manager around any optimization run::

        with RecompilationAuditor() as aud:
            fmin(...)
        assert not aud.diagnostics()
    """

    def __init__(self):
        # compile_key -> [(sig, shapes), ...] in event order
        self.events: Dict[Tuple, List[Tuple]] = {}
        self._keys_in_order: List[Tuple] = []

    # -- observer wiring ----------------------------------------------
    def _observe(self, sig, shapes, launch_s=None):
        from ..algos import tpe_device

        key = tpe_device.compile_key(sig, shapes)
        if key not in self.events:
            self.events[key] = []
            self._keys_in_order.append(key)
        self.events[key].append((sig, shapes))

    def __enter__(self):
        from ..algos import tpe_device

        tpe_device._trace_observers.append(self._observe)
        return self

    def __exit__(self, *exc):
        from ..algos import tpe_device

        try:
            tpe_device._trace_observers.remove(self._observe)
        except ValueError:
            pass
        return False

    # -- reporting ----------------------------------------------------
    @property
    def n_traces(self) -> int:
        """Compile events observed (the reference's name: traces)."""
        return sum(len(v) for v in self.events.values())

    @property
    def n_programs(self) -> int:
        """Distinct program keys among them."""
        return len({ev for evs in self.events.values() for ev in evs})

    def bucket_summary(self) -> List[Tuple[int, int]]:
        """[(trial_count_bucket, n_compile_events)], by bucket."""
        buckets: Dict[int, int] = {}
        for (capt, _families), evs in self.events.items():
            buckets[capt] = buckets.get(capt, 0) + len(evs)
        return sorted(buckets.items())

    def diagnostics(self, suppress=()) -> List[Diagnostic]:
        out = []
        for key in self._keys_in_order:
            evs = self.events[key]
            if len(evs) <= 1:
                continue
            capt, fams = key
            shapes = [s for _, s in evs]
            out.append(make(
                "PL205",
                f"tpe_device.multi_family_suggest[{fams.replace('+', ', ')}]",
                f"program compiled {len(evs)}x for one (trial-count "
                f"bucket {capt}, family) key; shapes={shapes}",
                hint="a per-call value is leaking into the program key — "
                     "check the request's statics for per-call values and "
                     "its arguments for dtype or Python-type instability",
            ))
        return apply_suppressions(out, suppress)


def _probe_space():
    from .. import hp

    return {
        "u": hp.uniform("u", -2, 2),
        "n": hp.normal("n", 0, 1),
        "c": hp.choice("c", [0, 1, 2]),
    }


def audit_tpe_run(n_trials: int = 200, seed: int = 0, space=None,
                  objective=None, n_EI_candidates: int = 8, device=None):
    """Run an ``n_trials`` serial TPE optimization on ``device`` (None:
    the CUDA card) under the auditor and return it.  Clears the set of
    warm program keys first, so the audit observes the full compile
    schedule from a cold start."""
    import numpy as np

    from .. import Trials, fmin
    from ..algos import tpe, tpe_device

    if space is None:
        space = _probe_space()
    if objective is None:
        def objective(c):
            return float(c["u"] ** 2 + c["n"] ** 2 + 0.1 * c["c"])
    tpe_device._warm_keys.clear()
    aud = RecompilationAuditor()
    with aud:
        fmin(
            objective,
            space,
            algo=partial(tpe.suggest, n_EI_candidates=n_EI_candidates,
                         device=device),
            max_evals=n_trials,
            trials=Trials(),
            rstate=np.random.default_rng(seed),
            show_progressbar=False,
            verbose=False,
            max_speculation=0,
        )
    return aud


# ---------------------------------------------------------------------
# 2. dispatch containers (PL208)
# ---------------------------------------------------------------------

_DISPATCH_FNS = (
    "multi_family_suggest",
    "multi_family_suggest_async",
    "multi_study_suggest_async",
)


def lint_dispatch_callers(paths=None) -> List[Diagnostic]:
    """PL208, static: every dispatch call site in the package passes
    request containers in the tuple form.  A request triple built as
    ``(kind, [a, b], statics)`` — or via ``list(args)`` — is flagged,
    whether or not the list reaches the program key today."""
    from .durability_lint import package_files

    out: List[Diagnostic] = []
    for path in paths or package_files():
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError):
            continue

        # one-level name resolution, per enclosing function; each unit
        # walks only its OWN statements (nested function bodies are
        # their own units — walking them from the parent too would
        # duplicate every diagnostic)
        def unit_nodes(unit):
            out = []
            stack = list(unit.body)
            while stack:
                node = stack.pop()
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue
                if isinstance(node, ast.ClassDef):
                    stack.extend(node.body)
                    continue
                out.append(node)
                stack.extend(ast.iter_child_nodes(node))
            return out

        for fn in [tree] + [
            n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]:
            assigns: Dict[str, ast.AST] = {}
            for stmt in fn.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    assigns.setdefault(stmt.targets[0].id, stmt.value)
            for node in unit_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                chain = _dotted(node.func)
                if not chain or chain[-1] not in _DISPATCH_FNS:
                    continue
                if not node.args:
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Name):
                    arg = assigns.get(arg.id, arg)
                for sub in ast.walk(arg):
                    if isinstance(sub, (ast.Tuple, ast.List)) \
                            and len(sub.elts) == 3:
                        args_elt = sub.elts[1]
                        if isinstance(args_elt, ast.Name):
                            # args built in a local first: resolve one level
                            args_elt = assigns.get(args_elt.id, args_elt)
                        bad = isinstance(args_elt, ast.List) or (
                            isinstance(args_elt, ast.Call)
                            and isinstance(args_elt.func, ast.Name)
                            and args_elt.func.id == "list"
                        )
                        if bad:
                            out.append(make(
                                "PL208", f"{path}:{sub.lineno}",
                                f"request passed to {chain[-1]} carries "
                                f"its args in a list, not the tuple "
                                f"form the program key is defined over",
                                hint="build the args element as a tuple",
                            ))
    return out


# ---------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------


def lint_programs(static_only: bool = True, suppress=(), paths=None,
                  device=None, n_trials: int = 200) -> List[Diagnostic]:
    """All program checks.  The static tier is the dispatch-container
    scan; ``static_only=False`` adds an ``n_trials`` recompile audit on
    ``device`` (None: the CUDA card).  ``paths`` feeds an already-
    discovered package file list to the scan."""
    out = lint_dispatch_callers(paths)
    if not static_only:
        out.extend(audit_tpe_run(n_trials=n_trials, device=device).diagnostics())
    return apply_suppressions(out, suppress)
