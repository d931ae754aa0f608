"""CLI: ``python -m hyperopt_tpu_torch.analysis <target> ...``

Targets:

- ``space <module[:attr]>`` — space-lint a search space.  ``module`` is
  a dotted import path or a ``.py`` file; ``attr`` names the space
  object (default: every module-level attribute that looks like a
  space: a dict of pyll nodes or a pyll Apply named ``space``/``SPACE``).
- ``program [--audit [N]]`` — program-lint the device suggest programs:
  the dispatch-container scan (PL208); ``--audit`` additionally runs
  the N-trial (default 200) recompile audit (PL205) on ``--device``.
- ``race [file.py ...]`` — guarded-by / lock-order / lock-graph check
  (default: every auto-discovered lock-bearing module of the package).
- ``durability [file.py ...]`` — crash-consistency check of every
  durable-write site (default: every package module).
- ``protocol [file.py ...]`` — the SG7xx segment-protocol pass over
  every ``protocol:``-annotated module (default: auto-discovered)
  plus the explicit-state protocol model check (``--deep`` runs the
  full interleaving sweep, crash budget 2).
- ``self`` — the gate: race + durability + static program + protocol
  passes over the whole package plus the small-scope protocol model
  check (the run_self_lint sections).  Needs no card and no JAX.
- ``all`` — everything: ``self`` plus the 200-trial recompile audit on
  ``--device`` (default: the CUDA card; ``--device cpu`` on a host
  without one), unless ``--static-only``.
- a bare ``foo.py`` / ``pkg.module`` argument — inferred: ``.py`` file
  → race + durability passes; importable module → space pass.

``--json`` replaces the human report with the stable machine-readable
schema ``[{rule, severity, file, line, message, hint}]`` (sorted), so
gates and control loops can consume results programmatically.

Exit code: number of ERROR-severity diagnostics (capped at 125), so
``&&`` chains and CI steps can gate on it; ``--no-fail`` forces 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import (
    diagnostics_json,
    format_report,
    import_module_target,
    lint_durability,
    lint_programs,
    lint_protocol,
    lint_races,
    lint_space,
    looks_like_space,
    model_check_diagnostics,
    run_self_lint,
    sort_diagnostics,
)
from .diagnostics import Severity
from .program_lint import audit_tpe_run


def _spaces_from(module_spec: str):
    """[(name, space)] from ``module[:attr]``."""
    if ":" in module_spec and not module_spec.endswith(".py"):
        module, attr = module_spec.rsplit(":", 1)
    else:
        module, attr = module_spec, None
    mod = import_module_target(module)
    if attr is not None:
        return [(f"{module}:{attr}", getattr(mod, attr))]
    found = [
        (f"{module}:{name}", obj)
        for name, obj in sorted(vars(mod).items())
        if not name.startswith("_") and looks_like_space(obj)
    ]
    if not found:
        raise SystemExit(
            f"no search-space objects found in {module!r}; name one "
            f"explicitly: {module}:<attr>"
        )
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hyperopt_tpu_torch.analysis",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("target", nargs="*", default=["self"])
    ap.add_argument("--audit", nargs="?", const=200, type=int, default=None,
                    metavar="N",
                    help="run the N-trial recompilation audit (program "
                         "pass; default N=200)")
    ap.add_argument("--static-only", action="store_true",
                    help="all: skip the recompile audit")
    ap.add_argument("--device", default=None,
                    help="device of the recompile audit (default: the "
                         "CUDA card; 'cpu' for the CPU)")
    ap.add_argument("--deep", action="store_true",
                    help="protocol model: full interleaving sweep "
                         "(crash budget 2) instead of the small scope")
    ap.add_argument("--suppress", default="",
                    help="comma-separated rule ids to suppress")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the stable machine-readable schema "
                         "[{rule, severity, file, line, message, hint}] "
                         "instead of the human report")
    ap.add_argument("--no-fail", action="store_true",
                    help="always exit 0 (report-only mode)")
    args = ap.parse_args(argv)
    suppress = tuple(x.strip() for x in args.suppress.split(",") if x.strip())

    def report(ds, header):
        if not args.as_json:
            print(format_report(ds, header=header))

    target = args.target or ["self"]
    cmd, rest = target[0], target[1:]
    diags = []
    if cmd == "space":
        if not rest:
            ap.error("space: give a module[:attr] target")
        for spec in rest:
            for name, space in _spaces_from(spec):
                ds = lint_space(space, suppress=suppress)
                diags.extend(ds)
                report(ds, f"== {name}")
        if not args.as_json:
            print(_summary(diags))
    elif cmd == "program":
        diags = lint_programs(suppress=suppress)
        if args.audit is not None:
            aud = audit_tpe_run(n_trials=args.audit, device=args.device)
            diags.extend(aud.diagnostics(suppress=suppress))
            if not args.as_json:
                print(
                    f"recompile audit: {aud.n_traces} compile event(s) across "
                    f"{aud.n_programs} program key(s); "
                    f"buckets={aud.bucket_summary()}"
                )
        report(diags, "== program_lint")
    elif cmd == "race":
        diags = lint_races(rest or None, suppress=suppress)
        report(diags, "== race_lint")
    elif cmd == "durability":
        diags = lint_durability(rest or None, suppress=suppress)
        report(diags, "== durability_lint")
    elif cmd == "protocol":
        diags = lint_protocol(rest or None, suppress=suppress)
        diags.extend(
            model_check_diagnostics(deep=args.deep, suppress=suppress)
        )
        report(diags, "== protocol_lint (SG7xx + model check)")
    elif cmd in ("self", "all"):
        # `self` = the gate; `all` additionally runs the recompile audit
        # unless --static-only.  Both run the SAME run_self_lint sections.
        static_only = cmd == "self" or args.static_only
        for _key, header, ds, _secs in run_self_lint(
            suppress=suppress, static_only=static_only, deep=args.deep,
            device=args.device,
        ):
            diags.extend(ds)
            report(ds, header)
        if not args.as_json:
            print(_summary(diags))
    else:
        # inference: .py file -> race + durability; module -> space
        if cmd.endswith(".py") and os.path.exists(cmd):
            diags = lint_races(target, suppress=suppress)
            diags.extend(lint_durability(target, suppress=suppress))
            report(diags, "== race + durability")
        else:
            for spec in target:
                for name, space in _spaces_from(spec):
                    ds = lint_space(space, suppress=suppress)
                    diags.extend(ds)
                    report(ds, f"== {name}")
            if not args.as_json:
                print(_summary(diags))
    if args.as_json:
        print(json.dumps(diagnostics_json(diags), indent=1))
    if args.no_fail:
        return 0
    return min(sum(1 for d in diags if d.severity == Severity.ERROR), 125)


def _summary(diags):
    diags = sort_diagnostics(diags)
    n_err = sum(1 for d in diags if d.severity == Severity.ERROR)
    return f"total: {len(diags)} diagnostic(s), {n_err} error(s)"


if __name__ == "__main__":
    sys.exit(main())
