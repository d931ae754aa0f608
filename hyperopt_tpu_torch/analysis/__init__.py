"""hyperopt_tpu_torch.analysis — the port's static analyzer and
protocol model.

One structured-diagnostic model (rule id, severity, location, fix hint;
:mod:`.diagnostics`) shared by five passes, each the reference's
(``hyperopt_tpu/analysis/``) with its rule ids and wording, run over
``hyperopt_tpu_torch/``:

- :func:`lint_space` (:mod:`.space_lint`) — walks the pyll graph of any
  ``hp.*`` space: duplicate/shadowed labels, inverted bounds,
  non-positive q/sigma, float32 overflow of log ranges, unreachable
  choice branches, int-cast truncation.  ``fmin(validate_space=True)``'s
  pre-flight.
- :func:`lint_programs` (:mod:`.program_lint`) — the recompile audit
  that replaces the reference's jaxpr audits: a
  :class:`RecompilationAuditor` that bounds compile events to one per
  (trial-count bucket, family) (PL205), and the static dispatch-
  container scan (PL208).
- :func:`lint_races` (:mod:`.race_lint`) — AST guarded-by checker over
  every lock-bearing module of the package (auto-discovered): fields
  annotated ``# guarded-by: <lock>`` must be accessed under ``with
  self.<lock>:``, lock acquisition order is checked against a declared
  ``# lock-order:``, the observed acquisition graph must be acyclic
  (RL304), blocking calls under a lock are flagged (RL305), and a
  module constructing a lock with no annotations at all is an error
  (RL306) unless listed in :data:`RACE_LINT_EXEMPT`.
- :func:`lint_durability` (:mod:`.durability_lint`) — AST dataflow over
  every durable-write site in the package: truncate-then-write of live
  paths, atomic replaces without fsync, unframed or multi-write journal
  appends, dangling tmp files, unlocked read-modify-write.
- :func:`lint_protocol` (:mod:`.protocol_lint`) — the SG7xx segment-
  protocol ordering disciplines over every module declaring a
  ``protocol:`` site annotation (auto-discovered like the race pass).
  Its Tier B companion (:mod:`.protocol_model`) is an explicit-state
  model checker over appender/sealer/compactor/mirror/takeover
  interleavings with crash injection, reporting SG706.

CLI: ``python -m hyperopt_tpu_torch.analysis <target>`` (see
``--help``); ``self`` is the gate (exit code = error count).
Machine-readable: ``python -m hyperopt_tpu_torch.analysis all --json``.
Nothing here imports JAX; the recompile audit imports torch.
"""

from __future__ import annotations

import os

from .diagnostics import (
    RULES,
    Diagnostic,
    Severity,
    format_report,
    has_errors,
    sort_diagnostics,
)
from .durability_lint import lint_durability, package_files
from .program_lint import (
    RecompilationAuditor,
    audit_tpe_run,
    lint_dispatch_callers,
    lint_programs,
)
from .protocol_lint import discover_protocol_files, lint_protocol
from .protocol_model import model_check_diagnostics
from .race_lint import lint_file, lint_source, lock_order_graph
from .space_lint import lint_space

__all__ = [
    "RULES",
    "RACE_LINT_EXEMPT",
    "Diagnostic",
    "Severity",
    "RecompilationAuditor",
    "audit_tpe_run",
    "diagnostics_json",
    "discover_protocol_files",
    "discover_race_files",
    "format_report",
    "has_errors",
    "lint_dispatch_callers",
    "lint_durability",
    "lint_file",
    "lint_programs",
    "lint_protocol",
    "lint_races",
    "lint_repo",
    "lint_source",
    "lint_space",
    "lock_order_graph",
    "model_check_diagnostics",
    "package_files",
    "run_self_lint",
    "sort_diagnostics",
]

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The ONLY surviving hand-maintained registry of the race pass: modules
# allowed to construct a threading lock without guarded-by annotations
# (RL306 exemptions), each with the reason on record.  Everything else
# is auto-discovered — a new lock-bearing module is linted (and RL306-
# flagged if unannotated) the moment it lands.
RACE_LINT_EXEMPT = {}


def discover_race_files(pkg_root: str = _PKG_ROOT, paths=None):
    """Every package module the race pass must see: any file that
    constructs a ``threading.Lock/RLock/Condition`` or carries a
    ``# guarded-by:`` / ``# lock-order:`` annotation.  Auto-discovered
    on every run, so a new concurrent module can never silently dodge
    the pass.  Pass
    ``paths`` to filter an already-discovered file list instead of
    re-walking the package."""
    import re

    marker = re.compile(
        r"threading\.(Lock|RLock|Condition)\s*\("
        # `from threading import Lock` style constructions too — the
        # ctor-site regex alone would let that import style dodge RL306
        r"|from\s+threading\s+import\s[^\n]*\b(Lock|RLock|Condition)\b"
        r"|guarded-by:|lock-order:"
    )
    out = []
    for path in (package_files(pkg_root) if paths is None else paths):
        try:
            with open(path, encoding="utf-8") as f:
                if marker.search(f.read()):
                    out.append(path)
        except OSError:
            continue
    return tuple(out)


def looks_like_space(obj) -> bool:
    """Is ``obj`` a lintable search space?  (A pyll Apply, or a
    non-empty dict whose values are all pyll Apply nodes.)  Single
    definition for the CLI, so every target
    agrees on which module attributes get linted."""
    from ..pyll.base import Apply

    if isinstance(obj, Apply):
        return True
    return (
        isinstance(obj, dict) and bool(obj)
        and all(isinstance(v, Apply) for v in obj.values())
    )


def import_module_target(module: str):
    """Import ``module`` — a dotted import path or a ``.py`` file."""
    import importlib
    import importlib.util

    if module.endswith(".py") or os.path.sep in module:
        name = os.path.splitext(os.path.basename(module))[0]
        spec = importlib.util.spec_from_file_location(name, module)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return importlib.import_module(module)


def _is_exempt(path: str) -> bool:
    return any(
        os.path.normpath(path).endswith(os.path.normpath(rel))
        for rel in RACE_LINT_EXEMPT
    )


def lint_races(paths=None, suppress=()):
    """Race-lint ``paths`` (default: every auto-discovered lock-bearing
    module of the package)."""
    out = []
    for p in paths or discover_race_files():
        out.extend(
            lint_file(p, suppress=suppress, lock_exempt=_is_exempt(p))
        )
    return out


def run_self_lint(suppress=(), static_only: bool = True,
                  deep: bool = False, paths=None, race_paths=None,
                  protocol_paths=None, device=None):
    """THE self-lint of the port — one package walk, one discovery read,
    one pass ordering (``python -m hyperopt_tpu_torch.analysis self`` is
    a thin wrapper over this).  Returns ``[(key, header, diagnostics,
    seconds)]`` sections, in run order:

    1. race pass over every auto-discovered lock-bearing module;
    2. durability pass over every package module;
    3. program pass (static: the dispatch-container scan, PL208;
       ``static_only=False`` adds a 200-trial recompile audit, PL205,
       on ``device``: None is the CUDA card, ``"cpu"`` the CPU);
    4. protocol pass (SG7xx) over every auto-discovered
       ``protocol:``-annotated module;
    5. protocol model check (Tier B, SG706): every scenario with
       crash budget 1; ``deep=True`` runs the full sweep (budget 2).
    """
    import time as _time

    if paths is None:
        paths = package_files()
    if race_paths is None:
        race_paths = discover_race_files(paths=paths)
    if protocol_paths is None:
        protocol_paths = discover_protocol_files(paths=paths)

    sections = []

    def run(key, header, fn):
        t0 = _time.perf_counter()
        ds = fn()
        sections.append((key, header, ds, _time.perf_counter() - t0))

    run("race",
        f"== race pass ({len(race_paths)} lock-bearing modules, "
        f"guarded-by/lock-order/lock-graph)",
        lambda: lint_races(race_paths, suppress=suppress))
    run("durability",
        f"== durability pass ({len(paths)} modules, "
        f"write-site discipline)",
        lambda: lint_durability(paths, suppress=suppress))
    run("program",
        "== program pass (dispatch containers"
        + (", static)" if static_only
           else f" + recompile audit on {device or 'cuda'})"),
        lambda: lint_programs(static_only=static_only,
                              suppress=suppress, paths=paths,
                              device=device))
    run("protocol",
        f"== protocol pass ({len(protocol_paths)} protocol modules, "
        f"SG7xx ordering disciplines)",
        lambda: lint_protocol(protocol_paths, suppress=suppress))
    run("model",
        "== protocol model ("
        + ("full sweep, crash budget 2" if deep
           else "small scope, crash budget 1") + ")",
        lambda: model_check_diagnostics(deep=deep, suppress=suppress))
    return sections


def lint_repo(static_only: bool = True, suppress=(), paths=None,
              race_paths=None, device=None):
    """Self-lint: the flat diagnostic list of every
    :func:`run_self_lint` section — race + durability + program +
    protocol passes plus the small-scope protocol model check.
    ``static_only=False`` additionally runs the recompile audit on
    ``device``.  The package is walked and discovery-filtered ONCE;
    callers that already discovered (for reporting counts) pass
    ``paths`` / ``race_paths`` so nothing is re-read."""
    sections = run_self_lint(
        suppress=suppress, static_only=static_only, paths=paths,
        race_paths=race_paths, device=device,
    )
    return [d for _, _, ds, _ in sections for d in ds]


def diagnostics_json(diags):
    """The stable machine-readable form of a diagnostic list (the
    ``--json`` CLI output): ``[{rule, severity, file, line, message,
    hint}]``, sorted.  ``file``/``line`` split a ``path:lineno``
    location; graph-path locations keep ``line: None``."""
    out = []
    for d in sort_diagnostics(diags):
        file, line = d.location, None
        head, sep, tail = d.location.rpartition(":")
        if sep and tail.isdigit():
            file, line = head, int(tail)
        out.append({
            "rule": d.rule,
            "severity": d.severity,
            "file": file,
            "line": line,
            "message": d.message,
            "hint": d.hint,
        })
    return out
