"""Pass 5: segment-protocol lint — the SG7xx ordering disciplines.

A review of the segment store found four protocol bugs by hand (post-takeover mirror
clobber, non-contiguous cursor advance, orphan-sweep record loss,
seal-lock break race).  This pass machine-checks the disciplines those
fixes established, over every module that declares a protocol site
with a ``protocol:`` comment annotation (auto-discovered, mirroring
the ``guarded-by`` idiom of the race pass):

- ``protocol: replication-write`` (on the ``def`` line, comment) — the
  function replicates durable state between roots.  Checked: SG705
  (an ownership check — ``owner_of``/``owns``/``is_live`` — must
  precede the first durable write), SG701 (a fence validation —
  ``read_fence``/``verify`` — must immediately precede the manifest
  publish: no durable write between them), SG702 (no durable write
  after the manifest publish — the manifest is the commit point).
- ``protocol: lock-break`` — the function may break a stale
  cross-process lock file.  Checked: SG704 file-wide (an
  ``os.unlink``/``os.remove`` of a lockish path inside a
  ``FileExistsError`` acquire path must target a private rename
  destination, never the shared path).
- ``protocol: cursor-advance`` — the function advances a replay
  cursor.  Checked: SG703 (the advance must be dominated by a
  contiguity equality check; ``max(cursor, ...)``-style jumps are
  flagged file-wide).
- ``protocol: orphan-sweep`` — the function deletes
  manifest-unreferenced segment files.  Checked: SG701 (every unlink
  must be lexically preceded by a straggler re-home
  ``append_records`` in the same function).

The annotation attaches to the ``def`` it shares a line with, the
``def`` directly below it, or the innermost enclosing function; an
unknown role or an unattached annotation is SG707.  Like the other
AST passes the semantics are lexical and deliberately conservative:
ordering is checked by line number within one function body, and
helper indirection is not credited — keep the protocol-critical
ordering in one function, where the checker (and a reader) can
see it.

Tier B — the explicit-state interleaving/crash checker over the same
protocol — lives in :mod:`.protocol_model` and reports as SG706.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from .diagnostics import (
    Diagnostic,
    LOCKISH_RE as _LOCKISH,
    apply_suppressions,
    dotted_chain as _chain,
    make,
    suppressed_by_comment,
)
from .race_lint import _string_spans

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the annotation marker, spelled without a literal hash-space prefix in
# this docstring so discovery never reads this module as a protocol site
_PROTO_RE = re.compile(r"#\s*protocol:\s*([\w-]+)")

ROLES = frozenset({
    "replication-write", "lock-break", "cursor-advance", "orphan-sweep",
})

# durable-write helpers of the storage layer: callee name -> index of
# the destination-path argument (matches durability_lint's set)
_DURABLE_HELPERS = {
    "_atomic_write": 0,
    "_write_doc": 0,
    "append_records": 0,
    "atomic_pickle_dump": 1,
}
_FENCE_MARKERS = frozenset({"read_fence", "verify"})
_OWNERSHIP_MARKERS = frozenset({"owner_of", "owns", "is_live"})
_CURSORISH = re.compile(r"offset|cursor", re.IGNORECASE)
_MANIFESTISH = re.compile(r"manifest", re.IGNORECASE)


def discover_protocol_files(pkg_root: str = _PKG_ROOT, paths=None):
    """Every package module declaring a protocol site: auto-discovered
    by annotation, like :func:`..discover_race_files` — a new
    replication or lock-break site is linted the moment it declares
    itself, with no hand-maintained file list to rot.  Pass ``paths``
    to filter an already-walked file list instead of re-walking."""
    from .durability_lint import package_files

    out = []
    for path in (package_files(pkg_root) if paths is None else paths):
        try:
            with open(path, encoding="utf-8") as f:
                if _PROTO_RE.search(f.read()):
                    out.append(path)
        except OSError:
            continue
    return tuple(out)


class _Facts:
    """Lexical facts of ONE function body (nested defs excluded)."""

    def __init__(self):
        self.assigns: Dict[str, str] = {}   # name -> value source text
        # (lineno, callee, path_text, resolved_path_text)
        self.durables: List[Tuple[int, str, str, str]] = []
        self.fence_lines: List[int] = []
        self.owner_lines: List[int] = []
        # (lineno, arg_text, resolved_text, in_feh_handler)
        self.unlinks: List[Tuple[int, str, str, bool]] = []
        self.rename_dsts: List[str] = []
        # (lineno, target_text) for cursor-targets assigned from max(...)
        self.max_advances: List[Tuple[int, str]] = []
        # (lineno, target_text, eq_guarded) for subscript cursor assigns
        self.cursor_assigns: List[Tuple[int, str, bool]] = []
        self.rehome_lines: List[int] = []   # append_records call sites


def _src(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse failure
        return ""


def _has_eq_compare(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Compare)
        and any(isinstance(op, ast.Eq) for op in n.ops)
        for n in ast.walk(node)
    )


def _collect_facts(fn: ast.AST) -> _Facts:
    facts = _Facts()

    def resolve(text: str) -> str:
        return facts.assigns.get(text, text)

    def visit(node, in_feh: bool, eq_guard: bool):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            return  # lexical scope: one function at a time
        if isinstance(node, ast.Assign):
            val_text = _src(node.value)
            for tgt in node.targets:
                tgt_text = _src(tgt)
                if isinstance(tgt, ast.Name):
                    facts.assigns[tgt.id] = val_text
                if _CURSORISH.search(tgt_text):
                    has_max = any(
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Name)
                        and n.func.id == "max"
                        for n in ast.walk(node.value)
                    )
                    if has_max:
                        facts.max_advances.append((node.lineno, tgt_text))
                    if isinstance(tgt, ast.Subscript):
                        facts.cursor_assigns.append(
                            (node.lineno, tgt_text, eq_guard)
                        )
        if isinstance(node, ast.Call):
            chain = _chain(node.func)
            callee = chain[-1] if chain else ""
            if chain[:1] == ("os",) and callee in ("replace", "rename") \
                    and len(node.args) >= 2:
                dst = _src(node.args[1])
                facts.rename_dsts.append(dst)
                facts.durables.append(
                    (node.lineno, "os." + callee, dst, resolve(dst))
                )
            elif callee in _DURABLE_HELPERS:
                idx = _DURABLE_HELPERS[callee]
                path_text = (
                    _src(node.args[idx]) if len(node.args) > idx else ""
                )
                facts.durables.append(
                    (node.lineno, callee, path_text, resolve(path_text))
                )
                if callee == "append_records":
                    facts.rehome_lines.append(node.lineno)
            elif chain[:1] == ("os",) and callee in ("unlink", "remove") \
                    and node.args:
                arg = _src(node.args[0])
                facts.unlinks.append(
                    (node.lineno, arg, resolve(arg), in_feh)
                )
            if callee in _FENCE_MARKERS:
                facts.fence_lines.append(node.lineno)
            if callee in _OWNERSHIP_MARKERS:
                facts.owner_lines.append(node.lineno)
        # context updates for children
        if isinstance(node, ast.ExceptHandler):
            names = {
                n.id for n in ast.walk(node.type)
                if isinstance(n, ast.Name)
            } if node.type is not None else set()
            in_feh = in_feh or "FileExistsError" in names
        if isinstance(node, ast.If) and _has_eq_compare(node.test):
            # the guard only dominates the THEN branch
            for child in node.body:
                visit(child, in_feh, True)
            for child in node.orelse:
                visit(child, in_feh, eq_guard)
            visit(node.test, in_feh, eq_guard)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, in_feh, eq_guard)

    for stmt in fn.body:
        visit(stmt, False, False)
    return facts


def _attach_roles(tree, lines, str_full, str_spans):
    """{func node: set(role)} plus [(lineno, bad_role_or_None)] SG707
    sites, from every non-string ``protocol:`` comment."""
    funcs = [
        n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    by_line = {f.lineno: f for f in funcs}

    def enclosing(lineno):
        best = None
        for f in funcs:
            end = getattr(f, "end_lineno", f.lineno)
            if f.lineno <= lineno <= end:
                if best is None or f.lineno > best.lineno:
                    best = f  # innermost
        return best

    roles: Dict[ast.AST, set] = {}
    bad: List[Tuple[int, Optional[str]]] = []
    for i, line in enumerate(lines, 1):
        m = _PROTO_RE.search(line)
        if m is None or i in str_full:
            continue
        if any(lo <= m.start() < hi for lo, hi in str_spans.get(i, ())):
            continue
        role = m.group(1)
        if role not in ROLES:
            bad.append((i, role))
            continue
        target = by_line.get(i) or by_line.get(i + 1) or enclosing(i)
        if target is None:
            bad.append((i, None))
            continue
        roles.setdefault(target, set()).add(role)
    return roles, bad


def lint_source(source: str, path: str = "<string>", suppress=()):
    """Protocol-lint one module's source; returns diagnostics."""
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return apply_suppressions(
            [make("SG707", f"{path}:{e.lineno or 0}",
                  f"cannot parse: {e.msg}")],
            suppress,
        )
    str_full, str_spans = _string_spans(tree)
    roles, bad_sites = _attach_roles(tree, lines, str_full, str_spans)

    diags: List[Diagnostic] = []

    def emit(rule, lineno, message, hint=""):
        line_text = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
        if suppressed_by_comment(rule, line_text):
            return
        diags.append(make(rule, f"{path}:{lineno}", message, hint=hint))

    for lineno, role in bad_sites:
        if role is None:
            emit("SG707", lineno,
                 "protocol annotation attaches to no function",
                 hint="put it on (or directly above) the def it governs")
        else:
            emit("SG707", lineno,
                 f"unknown protocol role {role!r}",
                 hint="known roles: " + ", ".join(sorted(ROLES)))

    funcs = [
        n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for fn in funcs:
        facts = _collect_facts(fn)
        fn_roles = roles.get(fn, set())

        # SG703a (file-wide): max()-style cursor jumps
        for lineno, tgt in facts.max_advances:
            emit("SG703", lineno,
                 f"cursor {tgt!r} advanced with max(...): jumps past "
                 "bytes this view never applied",
                 hint="advance only when the write is contiguous with "
                      "the cursor; leave the cursor put otherwise and "
                      "let the next refresh replay the gap")
        # SG703b: unguarded advance in a declared cursor-advance site
        if "cursor-advance" in fn_roles:
            for lineno, tgt, guarded in facts.cursor_assigns:
                if not guarded and not any(
                    lineno == ml for ml, _ in facts.max_advances
                ):
                    emit("SG703", lineno,
                         f"cursor {tgt!r} advanced without a "
                         "contiguity equality check dominating the "
                         "assignment",
                         hint="guard the advance with `if cursor == "
                              "end - nbytes:` so concurrent O_APPEND "
                              "bytes in the gap are replayed, not "
                              "skipped")

        # SG704 (file-wide): shared-path unlink in the acquire path
        for lineno, arg, resolved, in_feh in facts.unlinks:
            if not in_feh:
                continue
            if arg in facts.rename_dsts:
                continue  # private rename destination: the fixed idiom
            if _LOCKISH.search(arg) or _LOCKISH.search(resolved):
                emit("SG704", lineno,
                     f"stale lock broken by unlinking the shared path "
                     f"{arg!r} directly",
                     hint="os.rename the lock to a private name first; "
                          "only one breaker wins the rename, so a "
                          "fresh lock another breaker re-created can "
                          "never be removed")

        if "replication-write" in fn_roles:
            manifest_pubs = [
                d for d in facts.durables
                if _MANIFESTISH.search(d[2]) or _MANIFESTISH.search(d[3])
            ]
            # SG705: ownership check before the first durable write
            if facts.durables:
                first = min(facts.durables)
                if not any(ln < first[0] for ln in facts.owner_lines):
                    emit("SG705", first[0],
                         "durable write with no destination-ownership "
                         "check preceding it in this replication-write "
                         "site",
                         hint="check owner_of()/is_live() at entry and "
                              "skip the pull when the destination is "
                              "live-owned")
            if manifest_pubs:
                m_line = max(d[0] for d in manifest_pubs)
                fences_before = [
                    ln for ln in facts.fence_lines if ln < m_line
                ]
                if not fences_before:
                    emit("SG701", m_line,
                         "manifest published with no fence validation "
                         "before the commit",
                         hint="read the fence before copying and "
                              "re-check it immediately before "
                              "publishing the manifest")
                else:
                    f_line = max(fences_before)
                    for d in facts.durables:
                        if f_line < d[0] < m_line:
                            emit("SG701", d[0],
                                 f"durable write ({d[1]}) between the "
                                 "fence validation and the manifest "
                                 "commit",
                                 hint="the fence re-check must "
                                      "immediately precede the "
                                      "manifest publish — move this "
                                      "write before the re-check")
                # SG702: the manifest is the commit point
                for d in facts.durables:
                    if d[0] > m_line:
                        emit("SG702", d[0],
                             f"durable write ({d[1]}) after the "
                             "manifest publish",
                             hint="publish the manifest LAST: sidecar "
                                  "writes after it can clobber state "
                                  "the committed manifest now governs")

        if "orphan-sweep" in fn_roles:
            for lineno, arg, _resolved, _in_feh in facts.unlinks:
                if not any(rl < lineno for rl in facts.rehome_lines):
                    emit("SG701", lineno,
                         f"orphan file {arg!r} unlinked with no "
                         "straggler re-home preceding the unlink",
                         hint="append_records() the orphan's "
                              "unsuperseded records to the active "
                              "segment before deleting the file")

    return apply_suppressions(diags, suppress)


def lint_file(path: str, suppress=()):
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return lint_source(source, path=path, suppress=suppress)


def lint_protocol(paths=None, suppress=()):
    """Protocol-lint ``paths`` (default: every auto-discovered module
    declaring a protocol site)."""
    out: List[Diagnostic] = []
    for p in (paths if paths is not None else discover_protocol_files()):
        out.extend(lint_file(p, suppress=suppress))
    return out
