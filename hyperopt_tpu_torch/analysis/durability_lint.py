"""Pass 4: durability lint — crash-consistency of every durable-write
site in the package.

The repo's storage planes (trial docs, response journal, trace log,
flight recorder, compile ledger, chaos injection log, checkpoints) all
follow two write disciplines, proven by the fsck/chaos harnesses:

- **atomic replace** for whole-file state: write to a ``*.tmp.*``
  sibling, ``flush`` + ``os.fsync`` the handle, then ``os.replace``
  onto the live path (``parallel/file_trials._atomic_write`` is THE
  reference implementation).  A crash at any instruction leaves either
  the old file or the new file, never a tear.
- **framed append** for journals: one ``os.open(..., O_APPEND)`` handle,
  one single ``os.write`` per record, each record CRC-framed
  (``tracing.format_record`` / the doc CRC trailer) so a torn tail is
  detected and resync'd on load.

Both have already been violated in shipped code (the truncate-then-write
``ids.counter`` tear of the trial store), so this pass discovers every write
site automatically — every ``open``/``os.open`` for writing, every
``os.replace``/``os.rename``, every ``O_APPEND`` append — and enforces
the discipline statically:

- **DL401** truncating open (``"w"``/``"wb"``/``O_TRUNC``) of a live
  (non-tmp) path — the counter-tear class.
- **DL402** ``os.replace``/``os.rename`` publishing a tmp file written
  in the same function without an ``os.fsync`` in between.
- **DL403** ``O_APPEND`` append that is not CRC-framed, or built from
  more than one ``write()`` call (torn-record hazard).
- **DL404** tmp-file creation never published by ``os.replace`` in the
  same function.
- **DL405** read-modify-write of the same path with no lock and no
  ``O_APPEND``.

Genuinely non-critical writes (plots, reports, scratch sentinels) opt
out explicitly::

    with open(report_path, "w") as f:  # durability: exempt(report output, regenerable)
        ...

The annotation requires a reason and may sit on the flagged line, on a
standalone comment line directly above it, or on the enclosing ``def``
line (exempting the whole function).  Analysis is
per-function and deliberately lexical/conservative, like the race pass:
cross-function idioms should be routed through the blessed helpers
(``_atomic_write``, ``_write_doc``, ``checkpoint.atomic_pickle_dump``,
``tracing.format_record``), which this pass recognizes by name.
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
    dotted_chain as _call_chain,
    make,
)

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_EXEMPT_RE = re.compile(r"#\s*durability:\s*exempt\(([^)]+)\)")

# Writes routed through these helpers are already disciplined — they ARE
# the atomic-replace idiom (and are themselves linted where defined).
# Value = position of the PATH argument (atomic_pickle_dump is
# (obj, path); the others lead with the path).
ATOMIC_WRITE_HELPERS = {
    "_atomic_write": 0, "_write_doc": 0, "atomic_pickle_dump": 1,
}

# A payload expression is considered CRC-framed when its derivation
# calls one of these (the shared framing helpers), or visibly computes
# a crc32 itself.
FRAMING_MARKERS = ("format_record", "_format_record", "encode_doc",
                   "_encode_doc", "crc32")

_TRUNCATING = re.compile(r"w")  # "w", "wb", "w+", "wt" — all truncate
_TMPISH = re.compile(r"tmp", re.IGNORECASE)


def package_files(pkg_root: str = _PKG_ROOT) -> List[str]:
    """Every ``*.py`` file of the package, sorted — the auto-discovery
    surface shared by the durability and race passes (new modules can
    never silently dodge either)."""
    out = []
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def _expr_text(node: Optional[ast.AST]) -> str:
    if node is None:
        return ""
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on parse output
        return ""


def _literal_mode(call: ast.Call) -> Optional[str]:
    """The mode string of an ``open``/``os.fdopen`` call (None when the
    mode is dynamic or defaulted-to-read)."""
    mode_node = None
    if len(call.args) >= 2:
        mode_node = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if mode_node is None:
        return "r"
    if isinstance(mode_node, ast.Constant) and isinstance(mode_node.value, str):
        return mode_node.value
    return None


def _flag_names(node: ast.AST) -> set:
    """Names referenced in an os.open flags expression
    ({'O_CREAT', 'O_EXCL', ...})."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute):
            out.add(sub.attr)
        elif isinstance(sub, ast.Name):
            out.add(sub.id)
    return out


class _Open:
    __slots__ = ("node", "target", "mode", "flags", "handle", "is_os_open")

    def __init__(self, node, target, mode, flags, handle, is_os_open):
        self.node = node            # the Call
        self.target = target        # path expression text
        self.mode = mode            # literal mode string or None
        self.flags = flags          # os.open flag names (set)
        self.handle = handle        # bound variable name, if known
        self.is_os_open = is_os_open


class _FunctionFacts(ast.NodeVisitor):
    """Collect the durable-write facts of ONE function body (nested
    functions are analyzed separately — their writes are their own)."""

    def __init__(self):
        self.opens: List[_Open] = []
        self.writes: List[Tuple[Optional[str], ast.Call]] = []  # (handle, call)
        self.fsyncs: List[Tuple[Optional[str], int]] = []  # (handle, line)
        self.replaces: List[Tuple[str, ast.Call]] = []  # (src text, call)
        self.assigns: Dict[str, ast.AST] = {}           # name -> value expr
        self.fd_handles: Dict[str, _Open] = {}
        self.has_excl = False
        # line spans of lockish `with` bodies — DL405 credits a lock
        # only when the whole read-modify-write sits inside ONE span
        self.lock_ranges: List[Tuple[int, int]] = []

    # nested defs/classes/lambdas: skip at ANY depth — collection always
    # enters through the unit's body statements, and every nested def is
    # its own unit (walking it from the parent too would merge scopes
    # and duplicate its diagnostics)
    def visit_FunctionDef(self, node):
        return

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return

    def visit_Assign(self, node: ast.Assign):
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            self.assigns.setdefault(node.targets[0].id, node.value)
            self._note_call(node.value, handle=node.targets[0].id)
        else:
            self._note_call(node.value)
        self.generic_visit(node.value)

    def visit_With(self, node: ast.With):
        for item in node.items:
            handle = None
            if isinstance(item.optional_vars, ast.Name):
                handle = item.optional_vars.id
            self._note_call(item.context_expr, handle=handle)
            if _LOCKISH.search(_expr_text(item.context_expr) or ""):
                self.lock_ranges.append(
                    (node.lineno, node.end_lineno or node.lineno)
                )
            self.generic_visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)

    def visit_Call(self, node: ast.Call):
        self._note_call(node)
        self.generic_visit(node)

    def _note_call(self, node: ast.AST, handle: Optional[str] = None):
        if not isinstance(node, ast.Call):
            return
        chain = _call_chain(node.func)
        if not chain:
            return
        name = chain[-1]
        if chain == ("open",) and node.args:
            op = _Open(node, _expr_text(node.args[0]), _literal_mode(node),
                       set(), handle, is_os_open=False)
            self.opens.append(op)
            if handle:
                self.fd_handles[handle] = op
        elif chain[-2:] == ("os", "open") or chain == ("os", "open"):
            flags = _flag_names(node.args[1]) if len(node.args) > 1 else set()
            op = _Open(node, _expr_text(node.args[0]) if node.args else "",
                       None, flags, handle, is_os_open=True)
            self.opens.append(op)
            if handle:
                self.fd_handles[handle] = op
            if "O_EXCL" in flags:
                self.has_excl = True
        elif name == "fdopen" and node.args:
            # os.fdopen(fd, mode): bind the new handle to the fd's open
            fd = node.args[0]
            if isinstance(fd, ast.Name) and fd.id in self.fd_handles:
                op = self.fd_handles[fd.id]
                op.mode = _literal_mode(node)
                if handle:
                    self.fd_handles[handle] = op
        elif name == "fsync":
            # resolve WHICH handle is synced — os.fsync(fd) or
            # os.fsync(f.fileno()); None (dynamic) stays permissive
            h = None
            if node.args:
                a = node.args[0]
                if isinstance(a, ast.Name):
                    h = a.id
                elif isinstance(a, ast.Call):
                    ch = _call_chain(a.func)
                    if len(ch) == 2 and ch[1] == "fileno":
                        h = ch[0]
            self.fsyncs.append((h, node.lineno))
        elif name in ("replace", "rename") and chain[0] == "os" \
                and len(node.args) >= 2:
            self.replaces.append((_expr_text(node.args[0]), node))
        elif name == "write":
            if chain[:1] == ("os",) and node.args:
                fd = node.args[0]
                h = fd.id if isinstance(fd, ast.Name) else None
                self.writes.append((h, node))
            elif len(chain) == 2:
                self.writes.append((chain[0], node))
        elif name in ATOMIC_WRITE_HELPERS and node.args:
            # disciplined helper — record as a write of its path arg for
            # the DL405 read-modify-write check
            self.writes.append((None, node))


def _resolve(expr_text: str, facts: _FunctionFacts, depth: int = 3) -> str:
    """Follow a bare-Name expression through its (first) assignment so
    tmp-ness and framing are visible through one level of naming."""
    seen = set()
    while depth > 0 and expr_text.isidentifier() and expr_text not in seen:
        seen.add(expr_text)
        nxt = facts.assigns.get(expr_text)
        if nxt is None:
            break
        expr_text = _expr_text(nxt)
        depth -= 1
    return expr_text


def _is_tmpish(expr_text: str, facts: _FunctionFacts) -> bool:
    resolved = _resolve(expr_text, facts)
    if _TMPISH.search(expr_text) or _TMPISH.search(resolved):
        return True
    # a path later published by os.replace is by definition the tmp side
    return any(src == expr_text for src, _ in facts.replaces)


def _payload_framed(call: ast.Call, facts: _FunctionFacts) -> bool:
    """Does the written payload derive from a recognized CRC framing?"""
    payload = None
    chain = _call_chain(call.func)
    if chain[:1] == ("os",):
        if len(call.args) >= 2:
            payload = call.args[1]
    elif call.args:
        payload = call.args[0]
    if payload is None:
        return False
    text = _expr_text(payload)
    # strip trivial wrappers (line.encode()) down to the name
    m = re.match(r"(\w+)\.encode\(", text)
    if m:
        text = m.group(1)
    resolved = _resolve(text, facts)
    return any(mk in resolved or mk in text for mk in FRAMING_MARKERS)


def _exempt_reason(lines: List[str], *linenos) -> Optional[str]:
    for ln in linenos:
        if ln is None or ln < 1 or ln > len(lines):
            continue
        m = _EXEMPT_RE.search(lines[ln - 1])
        if m and m.group(1).strip():
            return m.group(1).strip()
    return None


def _iter_function_units(tree: ast.Module):
    """(def-lineno, body) for every function plus the module top level."""
    yield None, list(tree.body)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.lineno, node.body


def _collect_facts(body) -> _FunctionFacts:
    facts = _FunctionFacts()
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue  # nested units get their own pass
        facts.visit(stmt)
    return facts


def lint_source(source: str, path: str = "<string>",
                suppress=()) -> List[Diagnostic]:
    """Durability-lint one Python source string."""
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [make("DL401", f"{path}:{e.lineno}",
                     f"cannot parse: {e.msg}", severity="error")]
    diags: List[Diagnostic] = []

    for def_line, body in _iter_function_units(tree):
        facts = _collect_facts(body)
        if not (facts.opens or facts.replaces or facts.writes):
            continue

        def exempt(lineno):
            # the annotation may sit on the flagged line, on a standalone
            # comment line directly above it, or on the enclosing def
            return _exempt_reason(
                lines, lineno, lineno - 1, def_line
            ) is not None

        def emit(rule, lineno, message, hint=""):
            if not exempt(lineno):
                diags.append(make(rule, f"{path}:{lineno}", message,
                                  hint=hint))

        written_targets = {}  # target text -> _Open, for DL402 matching
        for op in facts.opens:
            truncating = (
                (op.mode is not None and _TRUNCATING.search(op.mode)
                 and "r" not in op.mode)
                or "O_TRUNC" in op.flags
            )
            appending = (
                "O_APPEND" in op.flags
                or (op.mode is not None and op.mode.startswith("a"))
            )
            writing = truncating or appending or (
                op.is_os_open and ("O_WRONLY" in op.flags
                                   or "O_RDWR" in op.flags)
            )
            if writing:
                written_targets[op.target] = op
            tmpish = _is_tmpish(op.target, facts)
            # O_CREAT|O_EXCL creates a FRESH file (the lock-file mutual-
            # exclusion idiom): there is no live content to tear
            if truncating and not tmpish and "O_EXCL" not in op.flags:
                emit(
                    "DL401", op.node.lineno,
                    f"truncating open of live path {op.target!r}: a crash "
                    f"between truncate and write leaves it empty (the "
                    f"ids.counter tear class)",
                    hint="write a .tmp sibling, fsync, then os.replace "
                         "(see parallel/file_trials._atomic_write), or "
                         "annotate '# durability: exempt(<reason>)' for "
                         "non-critical output",
                )
            if truncating and tmpish:
                published = any(
                    src == op.target
                    or _resolve(src, facts) == _resolve(op.target, facts)
                    for src, _ in facts.replaces
                )
                if not published:
                    emit(
                        "DL404", op.node.lineno,
                        f"tmp file {op.target!r} is written but never "
                        f"published by os.replace in this function",
                        hint="finish the atomic-replace idiom (fsync + "
                             "os.replace), or exempt scratch files with "
                             "'# durability: exempt(<reason>)'",
                    )
            if appending and "O_EXCL" not in op.flags:
                handle_writes = [
                    (h, c) for h, c in facts.writes
                    if h is not None and facts.fd_handles.get(h) is op
                ]
                if len(handle_writes) > 1:
                    emit(
                        "DL403", handle_writes[1][1].lineno,
                        f"O_APPEND record on {op.target!r} is built from "
                        f"{len(handle_writes)} write() calls: concurrent "
                        f"appenders (and a crash between writes) tear the "
                        f"record",
                        hint="assemble the record in one buffer and issue "
                             "ONE os.write",
                    )
                for _h, wcall in handle_writes[:1]:
                    if not _payload_framed(wcall, facts):
                        emit(
                            "DL403", wcall.lineno,
                            f"O_APPEND journal append on {op.target!r} is "
                            f"not CRC-framed: a torn tail is "
                            f"indistinguishable from a valid record",
                            hint="frame each record with "
                                 "tracing.format_record (leading newline "
                                 "+ crc32), or exempt with a reason",
                        )

        for src, rcall in facts.replaces:
            op = written_targets.get(src)
            if op is None:
                # resolve through one level of naming
                for tgt, cand in written_targets.items():
                    if _resolve(tgt, facts) == _resolve(src, facts):
                        op = cand
                        break
            if op is None:
                continue  # renaming a pre-existing file: no fresh data
            # the fsync must be on the handle that WROTE the tmp file —
            # syncing a different file nearby does not make this
            # replace durable (unresolvable handles stay permissive)
            synced = any(
                (h is None or facts.fd_handles.get(h) is op)
                and op.node.lineno <= ln <= rcall.lineno
                for h, ln in facts.fsyncs
            )
            if not synced:
                emit(
                    "DL402", rcall.lineno,
                    f"os.replace publishes {src!r} without an fsync on "
                    f"the written handle: after power loss the rename "
                    f"can outlive the data",
                    hint="f.flush(); os.fsync(f.fileno()) before the "
                         "replace",
                )

        # DL405: read-modify-write of one path without lock/O_EXCL —
        # the lock counts only when the read AND the write both sit
        # inside one held `with` span (a lock elsewhere in the
        # function does not cover this RMW)
        def under_one_lock(read_line, write_line):
            return any(
                lo <= read_line and write_line <= hi
                for lo, hi in facts.lock_ranges
            )

        if not facts.has_excl:
            read_targets = {
                op.target: op for op in facts.opens
                if op.mode is not None and op.mode.startswith("r")
                and not op.is_os_open
            }
            for h, wcall in facts.writes:
                chain = _call_chain(wcall.func)
                wtarget = None
                if chain and chain[-1] in ATOMIC_WRITE_HELPERS:
                    path_idx = ATOMIC_WRITE_HELPERS[chain[-1]]
                    if len(wcall.args) > path_idx:
                        wtarget = _expr_text(wcall.args[path_idx])
                elif h is not None and h in facts.fd_handles:
                    op = facts.fd_handles[h]
                    if op.mode is None or not op.mode.startswith("r"):
                        wtarget = op.target
                if wtarget is None:
                    continue
                rop = read_targets.get(wtarget)
                if rop is not None and rop.node.lineno < wcall.lineno \
                        and not under_one_lock(rop.node.lineno,
                                               wcall.lineno):
                    emit(
                        "DL405", wcall.lineno,
                        f"read-modify-write of {wtarget!r} without a lock "
                        f"or O_APPEND: concurrent writers lose updates",
                        hint="serialize with a lock (or the O_CREAT|"
                             "O_EXCL lock-file idiom), or restructure as "
                             "an O_APPEND journal",
                    )

    return apply_suppressions(diags, suppress)


def lint_file(path: str, suppress=()) -> List[Diagnostic]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path, suppress=suppress)


def lint_durability(paths=None, suppress=()) -> List[Diagnostic]:
    """Durability-lint ``paths`` (default: every package module,
    auto-discovered — new write sites can never dodge the pass)."""
    out: List[Diagnostic] = []
    for p in paths or package_files():
        out.extend(lint_file(p, suppress=suppress))
    return out
