"""Pass 3: AST-based guarded-by / lock-order / lock-graph checker.

The concurrent layers declare their lock discipline in comments; this
pass statically enforces it over the WHOLE package (files are
auto-discovered — see ``analysis.discover_race_files`` — so a new
module with a lock can never silently dodge the pass):

- ``self.foo = ...  # guarded-by: _lock`` — field ``foo`` of the
  enclosing class may only be read or written inside a
  ``with self._lock:`` block (``__init__`` is exempt: the object is not
  yet shared during construction).
- ``# guarded-by: trials._dynamic_trials: _mutate_lock`` — a standalone
  comment anywhere in a class body guards a *dotted* attribute path
  reached through ``self`` (here ``self.trials._dynamic_trials``).
- **module-level state**: the same two forms outside any class guard a
  module GLOBAL by a module lock (``_lib = None  # guarded-by: _lock``
  or a standalone ``# guarded-by: _lib: _lock``), checked against
  ``with _lock:`` blocks in every function of the module.
- ``# lock-order: _a < _b`` (module or class level) — declares that
  ``_a`` must be acquired before ``_b``; a ``with self._b:`` containing
  a ``with self._a:`` is an inversion (RL302).
- **RL304** needs no declaration: the pass builds a lock-acquisition
  graph per scope from observed ``with`` nestings plus same-scope
  method calls made while a lock is held, and flags any cycle — the
  deadlock shape a declared order would have prevented.
- **RL305** flags blocking calls — ``os.fsync``, HTTP
  (``urlopen``/``getresponse``), device dispatch/readback
  (``block_until_ready``, the ``multi_*_suggest*`` dispatchers), and
  thread ``join`` — made lexically under a held lock.
- **RL306** flags a module that constructs a
  ``threading.Lock/RLock/Condition`` but carries no guarded-by
  annotations at all (and is not explicitly exempted via
  ``analysis.RACE_LINT_EXEMPT``): its discipline is unchecked.
- ``# lint: disable=RL301`` on an access line suppresses the finding
  there.

Lexical semantics, deliberately conservative: a closure defined inside a
``with`` block does NOT inherit the held-locks set (it may run later on
another thread), and helper methods called under a lock are not credited
— annotate the access site or restructure so the access is lexically
under the ``with``.  The RL304 graph is likewise per-scope (one class,
or one module's global locks): cross-object cycles through collaborator
locks are out of static reach and remain the lock-order comments' job.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from .diagnostics import (
    Diagnostic,
    LOCKISH_RE as _LOCKISH,
    apply_suppressions,
    dotted_chain as _dotted_chain,
    make,
    suppressed_by_comment,
)

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([\w.]+)(?:\s*:\s*(\w+))?")
_ORDER_RE = re.compile(r"#\s*lock-order:\s*([\w<> .]+)")
_SELF_ASSIGN_RE = re.compile(r"self\.(\w+)\s*[:=]")
_GLOBAL_ASSIGN_RE = re.compile(r"^\s*(\w+)\s*[:=]")

_LOCK_CTORS = {"Lock", "RLock", "Condition"}

# RL305 marker sets: calls that block on disk, network, or device while
# every contender on the held lock stalls behind them
_BLOCKING_SIMPLE = {
    "fsync": "fsync",
    "urlopen": "HTTP",
    "getresponse": "HTTP",
    "block_until_ready": "device readback",
    "device_get": "device readback",
    "multi_family_suggest": "device dispatch",
    "multi_family_suggest_async": "device dispatch",
    "multi_study_suggest_async": "device dispatch",
}


def _attr_chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """('trials', '_dynamic_trials') for ``self.trials._dynamic_trials``;
    None when the chain does not root at ``self``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self":
        return tuple(reversed(parts))
    return None


class _ClassSpec:
    def __init__(self, name, is_module=False):
        self.name = name
        self.is_module = is_module
        self.guards: Dict[Tuple[str, ...], str] = {}  # attr path -> lock
        self.guard_lines: Dict[Tuple[str, ...], int] = {}
        self.lock_order: List[str] = []
        self.assigned_attrs: set = set()
        self.lock_names: set = set()        # locks constructed in scope
        self.lock_ctor_lines: List[int] = []
        # RL304 graph state
        self.edges: Dict[Tuple[str, str], int] = {}   # (outer, inner) -> line
        self.method_locks: Dict[str, set] = {}        # method -> acquired
        self.calls_under_lock: List[Tuple[Tuple[str, ...], str, int]] = []

    def is_lockish(self, name: str) -> bool:
        return (
            name in self.lock_names
            or name in self.guards.values()
            or bool(_LOCKISH.search(name))
        )


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_CTORS:
        root = fn.value
        return isinstance(root, ast.Name) and root.id == "threading"
    return isinstance(fn, ast.Name) and fn.id in _LOCK_CTORS


def _string_spans(tree: ast.Module):
    """Line/column spans of every string constant, so the annotation
    regexes never read docstring prose (e.g. this module's own grammar
    examples) as real annotations: (lines fully inside a multi-line
    string, {lineno: [(col_lo, col_hi)]} for single-line strings)."""
    full = set()
    spans: Dict[int, List[Tuple[int, int]]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and getattr(node, "lineno", None) is not None:
            end = getattr(node, "end_lineno", None) or node.lineno
            if end > node.lineno:
                full.update(range(node.lineno, end + 1))
            else:
                spans.setdefault(node.lineno, []).append((
                    node.col_offset,
                    getattr(node, "end_col_offset", None) or 1 << 30,
                ))
    return full, spans


def _parse_annotations(tree: ast.Module, lines: List[str], path: str):
    """[(class node or None, spec)] from comments + AST; the final
    entry (node None) is the MODULE spec for module-global state."""
    module_order: List[str] = []
    classes: List[Tuple[Optional[ast.ClassDef], _ClassSpec]] = []
    module_spec = _ClassSpec("<module>", is_module=True)

    class_ranges = []
    class_body_assigns: Dict[int, _ClassSpec] = {}  # id(stmt) -> spec
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            spec = _ClassSpec(node.name)
            classes.append((node, spec))
            end = max(
                (n.end_lineno or n.lineno for n in ast.walk(node)
                 if hasattr(n, "lineno")),
                default=node.lineno,
            )
            class_ranges.append((node.lineno, end, spec))
            # direct class-body assignments (class attributes) — a lock
            # constructed here as a bare-name class attribute belongs
            # to the class spec; method-local names must NOT be swept
            # in, so membership is by statement identity, not line range
            for stmt in node.body:
                if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    class_body_assigns[id(stmt)] = spec

    # statements at true module level (direct body + module-level
    # if/try blocks, NOT function bodies) — only these define module
    # globals; function-local names must not pollute the module spec
    module_level_assigns: set = set()
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            module_level_assigns.add(id(node))
        stack.extend(ast.iter_child_nodes(node))

    def owner(lineno) -> Optional[_ClassSpec]:
        best = None
        for lo, hi, spec in class_ranges:
            if lo <= lineno <= hi:
                # innermost (latest-starting) enclosing class wins
                if best is None or lo > best[0]:
                    best = (lo, spec)
        return best[1] if best else None

    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            spec = owner(node.lineno)
            for t in targets:
                chain = _attr_chain(t)
                if chain and len(chain) == 1 and spec is not None:
                    spec.assigned_attrs.add(chain[0])
                    if _is_lock_ctor(node.value):
                        spec.lock_names.add(chain[0])
                        spec.lock_ctor_lines.append(node.lineno)
                elif isinstance(t, ast.Name) and id(node) in class_body_assigns:
                    cspec = class_body_assigns[id(node)]
                    cspec.assigned_attrs.add(t.id)
                    if _is_lock_ctor(node.value):
                        cspec.lock_names.add(t.id)
                        cspec.lock_ctor_lines.append(node.lineno)
                elif isinstance(t, ast.Name) and spec is None:
                    if id(node) in module_level_assigns:
                        module_spec.assigned_attrs.add(t.id)
                        if _is_lock_ctor(node.value):
                            module_spec.lock_names.add(t.id)
                            module_spec.lock_ctor_lines.append(node.lineno)
                    elif _is_lock_ctor(node.value):
                        # a FUNCTION-LOCAL lock ctor: not a module lock
                        # name (it cannot be guarded-by-annotated and
                        # must not mask RL303), but still visible to
                        # RL306 so a lock-factory module cannot dodge
                        # the pass — the remedy there is the explicit
                        # RACE_LINT_EXEMPT entry
                        module_spec.lock_ctor_lines.append(node.lineno)
                elif isinstance(t, ast.Name) and spec is not None \
                        and _is_lock_ctor(node.value):
                    # METHOD-local lock ctor inside a class: same RL306
                    # visibility, same exclusion from the lock names
                    spec.lock_ctor_lines.append(node.lineno)

    str_full, str_spans = _string_spans(tree)

    def in_string(lineno, match):
        if lineno in str_full:
            return True
        return any(
            lo <= match.start() < hi
            for lo, hi in str_spans.get(lineno, ())
        )

    for i, line in enumerate(lines, start=1):
        m = _GUARD_RE.search(line)
        if m and in_string(i, m):
            m = None
        if m:
            target, lock = m.group(1), m.group(2)
            spec = owner(i)
            if lock is None:
                # inline form: `self.X = ...  # guarded-by: _lock` in a
                # class; `X = ...  # guarded-by: _lock` at module level
                lock = target
                code = line.split("#", 1)[0]
                am = _SELF_ASSIGN_RE.search(code)
                if am is not None and spec is not None:
                    attr_path: Tuple[str, ...] = (am.group(1),)
                else:
                    gm = _GLOBAL_ASSIGN_RE.search(code)
                    if gm is None or spec is not None:
                        continue  # prose mention, not an annotation site
                    spec = module_spec
                    attr_path = (gm.group(1),)
            else:
                attr_path = tuple(target.split("."))
                if spec is None:
                    spec = module_spec
            spec.guards[attr_path] = lock
            spec.guard_lines[attr_path] = i
        m = _ORDER_RE.search(line)
        if m and in_string(i, m):
            m = None
        if m and "<" in m.group(1):
            order = [x.strip() for x in m.group(1).split("<")]
            spec = owner(i)
            if spec is not None:
                spec.lock_order = order
            else:
                module_order[:] = order
                module_spec.lock_order = order

    for _, spec in classes:
        if not spec.lock_order:
            spec.lock_order = module_order
    classes.append((None, module_spec))
    return classes


def _local_bindings(fn) -> set:
    """Names bound locally in a function (parameters, assignment /
    for / with / comprehension targets), minus names declared
    ``global`` — per Python scoping these SHADOW the module globals,
    so module-mode RL301 must not read them as guarded state."""
    a = fn.args
    bound = {
        arg.arg
        for arg in (a.posonlyargs + a.args + a.kwonlyargs
                    + ([a.vararg] if a.vararg else [])
                    + ([a.kwarg] if a.kwarg else []))
    }
    declared_global: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            declared_global.update(node.names)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                               ast.For, ast.AsyncFor)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name):
                        bound.add(sub.id)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    for sub in ast.walk(item.optional_vars):
                        if isinstance(sub, ast.Name):
                            bound.add(sub.id)
        elif isinstance(node, ast.comprehension):
            for sub in ast.walk(node.target):
                if isinstance(sub, ast.Name):
                    bound.add(sub.id)
        elif isinstance(node, ast.NamedExpr) \
                and isinstance(node.target, ast.Name):
            bound.add(node.target.id)
    return bound - declared_global


class _MethodChecker(ast.NodeVisitor):
    def __init__(self, spec: _ClassSpec, lines, path, diags,
                 method_name: str = "?", shadowed: frozenset = frozenset()):
        self.spec = spec
        self.lines = lines
        self.path = path
        self.diags = diags
        self.method_name = method_name
        self.shadowed = shadowed    # local names hiding module globals
        self.held: List[str] = []
        self.acquired_anywhere: set = set()

    def _lock_chain(self, node) -> Optional[Tuple[str, ...]]:
        if self.spec.is_module:
            return (node.id,) if isinstance(node, ast.Name) else None
        return _attr_chain(node)

    # -- lock tracking -------------------------------------------------
    def visit_With(self, node: ast.With):
        # items acquire left-to-right: each lock joins the held set
        # BEFORE the next item's order check, so a single multi-item
        # statement (`with self._b, self._a:`) is checked exactly like
        # the nested form
        acquired = []
        for item in node.items:
            self.visit(item.context_expr)
            chain = self._lock_chain(item.context_expr)
            if chain and len(chain) == 1:
                lock = chain[0]
                self._check_order(lock, node.lineno)
                if self.spec.is_lockish(lock):
                    # RL304 graph edge: `lock` acquired while the held
                    # lockish set is non-empty
                    for h in self.held:
                        if h != lock and self.spec.is_lockish(h):
                            self.spec.edges.setdefault(
                                (h, lock), node.lineno
                            )
                    self.acquired_anywhere.add(lock)
                self.held.append(lock)
                acquired.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            del self.held[-len(acquired):]

    def _check_order(self, lock: str, lineno: int):
        order = self.spec.lock_order
        if lock not in order:
            return
        for h in self.held:
            if h in order and order.index(lock) < order.index(h):
                if suppressed_by_comment("RL302", self.lines[lineno - 1]):
                    continue
                self.diags.append(make(
                    "RL302", f"{self.path}:{lineno}",
                    f"acquires {lock!r} while holding {h!r}, but the "
                    f"declared lock-order is "
                    f"{' < '.join(order)}",
                    hint="release the inner lock first, or fix the "
                         "declared order if it is wrong",
                ))

    # -- closures do not inherit held locks -----------------------------
    def _visit_scoped(self, node):
        saved, self.held = self.held, []
        self.generic_visit(node)
        self.held = saved

    def visit_FunctionDef(self, node):
        self._visit_scoped(node)

    def visit_AsyncFunctionDef(self, node):
        self._visit_scoped(node)

    def visit_Lambda(self, node):
        self._visit_scoped(node)

    # -- calls under a held lock (RL304 expansion + RL305) --------------
    def visit_Call(self, node: ast.Call):
        held_lockish = tuple(
            h for h in self.held if self.spec.is_lockish(h)
        )
        if held_lockish:
            chain = _dotted_chain(node.func)
            callee = None
            if not self.spec.is_module:
                ac = _attr_chain(node.func)
                if ac is not None and len(ac) == 1:
                    callee = ac[0]  # self.method()
            elif isinstance(node.func, ast.Name):
                callee = node.func.id  # module-level helper()
            if callee is not None:
                self.spec.calls_under_lock.append(
                    (held_lockish, callee, node.lineno)
                )
            reason = self._blocking_reason(chain, node)
            if reason is not None and not suppressed_by_comment(
                "RL305", self.lines[node.lineno - 1]
            ):
                self.diags.append(make(
                    "RL305", f"{self.path}:{node.lineno}",
                    f"{self.spec.name}: blocking call "
                    f"'{'.'.join(chain)}' ({reason}) while holding "
                    f"{', '.join(repr(h) for h in held_lockish)}: every "
                    f"contender on the lock stalls behind it",
                    hint="move the blocking call outside the 'with', "
                         "snapshotting state first — or suppress with "
                         "'# lint: disable=RL305' and a justification "
                         "if the lock deliberately serializes the I/O",
                ))
        self.generic_visit(node)

    @staticmethod
    def _blocking_reason(chain: Tuple[str, ...],
                         node: ast.Call) -> Optional[str]:
        if not chain:
            return None
        name = chain[-1]
        simple = _BLOCKING_SIMPLE.get(name)
        if simple is not None:
            return simple
        if name == "join" and "path" not in chain:
            # thread join takes no args or a numeric/keyword timeout;
            # str.join / os.path.join take an iterable / components
            if node.keywords and all(
                kw.arg == "timeout" for kw in node.keywords
            ) and not node.args:
                return "thread join"
            if not node.args and not node.keywords:
                return "thread join"
            if len(node.args) == 1 and not node.keywords and isinstance(
                node.args[0], ast.Constant
            ) and isinstance(node.args[0].value, (int, float)):
                return "thread join"
        return None

    # -- guarded accesses ----------------------------------------------
    def visit_Attribute(self, node: ast.Attribute):
        if not self.spec.is_module:
            chain = _attr_chain(node)
            if chain is not None:
                # exact match only: a longer chain (self._pending.append)
                # contains the exact node (self._pending) as a
                # sub-expression, so prefix matching would double-report
                for attr_path, lock in self.spec.guards.items():
                    if chain == attr_path and lock not in self.held:
                        self._report_unguarded(node, attr_path, lock)
                        break
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        if self.spec.is_module and node.id not in self.shadowed:
            path = (node.id,)
            lock = self.spec.guards.get(path)
            if lock is not None and lock not in self.held:
                self._report_unguarded(node, path, lock)
        self.generic_visit(node)

    def _report_unguarded(self, node, attr_path, lock):
        line = self.lines[node.lineno - 1]
        if suppressed_by_comment("RL301", line):
            return
        prefix = "" if self.spec.is_module else "self."
        self.diags.append(make(
            "RL301", f"{self.path}:{node.lineno}",
            f"{self.spec.name}: access to "
            f"'{prefix}{'.'.join(attr_path)}' (guarded by "
            f"'{lock}', declared at line "
            f"{self.spec.guard_lines.get(attr_path, '?')}) "
            f"outside 'with {prefix}{lock}:'",
            hint=f"wrap the access in 'with {prefix}{lock}:' "
                 f"or add '# lint: disable=RL301' with a "
                 f"justification",
        ))


def _expanded_edges(spec: _ClassSpec) -> Dict[Tuple[str, str], int]:
    """Observed nesting edges + edges induced by same-scope calls made
    under a lock (the callee's own acquisitions happen while the
    caller's lock is held)."""
    edges = dict(spec.edges)
    for held, callee, lineno in spec.calls_under_lock:
        for inner in spec.method_locks.get(callee, ()):
            for outer in held:
                if outer != inner:
                    edges.setdefault((outer, inner), lineno)
    return edges


def _find_cycles(edges: Dict[Tuple[str, str], int]) -> List[List[str]]:
    """Simple DFS cycle enumeration (deduped by node set)."""
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    cycles: List[List[str]] = []
    seen_sets = set()

    def dfs(node, path, on_path):
        for nxt in adj.get(node, ()):
            if nxt in on_path:
                cyc = path[path.index(nxt):] + [nxt]
                key = frozenset(cyc)
                if key not in seen_sets:
                    seen_sets.add(key)
                    cycles.append(cyc)
                continue
            dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(adj):
        dfs(start, [start], {start})
    return cycles


def lint_source(source: str, path: str = "<string>",
                suppress=(), lock_exempt: bool = False) -> List[Diagnostic]:
    """Race-lint one Python source string.  ``lock_exempt`` marks a
    module on the ``analysis.RACE_LINT_EXEMPT`` list: RL306 is skipped
    (every other rule still applies)."""
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [make("RL301", f"{path}:{e.lineno}",
                     f"cannot parse: {e.msg}", severity="error")]
    diags: List[Diagnostic] = []
    specs = _parse_annotations(tree, lines, path)

    # RL306: a lock-constructing module with no annotations anywhere
    n_guards = sum(len(spec.guards) for _, spec in specs)
    ctor_lines = [
        ln for _, spec in specs for ln in spec.lock_ctor_lines
    ]
    if ctor_lines and n_guards == 0 and not lock_exempt:
        first = min(ctor_lines)
        if not suppressed_by_comment("RL306", lines[first - 1]):
            diags.append(make(
                "RL306", f"{path}:{first}",
                f"module constructs {len(ctor_lines)} threading lock(s) "
                f"but carries no '# guarded-by:' annotations: its lock "
                f"discipline is invisible to the race pass",
                hint="annotate the guarded state (see "
                     "docs/static_analysis.md), or add the module to "
                     "analysis.RACE_LINT_EXEMPT with a reason",
            ))

    for cls_node, spec in specs:
        has_locks = bool(spec.lock_names)
        if not spec.guards and not has_locks:
            continue
        # RL303: stale/misspelled guard annotations
        for attr_path, lock in spec.guards.items():
            if lock not in spec.assigned_attrs:
                prefix = "" if spec.is_module else "self."
                diags.append(make(
                    "RL303",
                    f"{path}:"
                    f"{spec.guard_lines.get(attr_path, getattr(cls_node, 'lineno', 1))}",
                    f"{spec.name}: guard lock '{prefix}{lock}' for "
                    f"'{prefix}{'.'.join(attr_path)}' is never assigned "
                    f"in the {'module' if spec.is_module else 'class'}",
                    hint="fix the lock name in the annotation, or create "
                         "the lock in __init__",
                ))
        if spec.is_module:
            units = [
                item for item in tree.body
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
            ]
            # module globals are also touched from methods: check every
            # function in the file against the module guards
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef):
                    units.extend(
                        it for it in node.body
                        if isinstance(
                            it, (ast.FunctionDef, ast.AsyncFunctionDef)
                        )
                    )
        else:
            units = [
                item for item in cls_node.body
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                and item.name != "__init__"
            ]
        for item in units:
            shadowed = (
                frozenset(_local_bindings(item)) if spec.is_module
                else frozenset()
            )
            checker = _MethodChecker(spec, lines, path, diags,
                                     method_name=item.name,
                                     shadowed=shadowed)
            for stmt in item.body:
                checker.visit(stmt)
            spec.method_locks.setdefault(item.name, set()).update(
                checker.acquired_anywhere
            )
        # RL304: cycles in the expanded acquisition graph
        edges = _expanded_edges(spec)
        for cyc in _find_cycles(edges):
            loc_line = min(
                edges.get((a, b), 1)
                for a, b in zip(cyc, cyc[1:])
                if (a, b) in edges
            ) if len(cyc) > 1 else 1
            diags.append(make(
                "RL304", f"{path}:{loc_line}",
                f"{spec.name}: lock-acquisition cycle "
                f"{' -> '.join(cyc)}: two threads entering the cycle at "
                f"different points deadlock",
                hint="impose one global order (declare it with "
                     "'# lock-order:') and restructure the inverted "
                     "acquisition",
            ))

    return apply_suppressions(diags, suppress)


def lint_file(path: str, suppress=(),
              lock_exempt: bool = False) -> List[Diagnostic]:
    """Race-lint one Python file."""
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path, suppress=suppress,
                           lock_exempt=lock_exempt)


def lock_order_graph(paths) -> Dict[str, Dict[str, object]]:
    """The whole-package lock-order graph: ``{scope: {"locks": [...],
    "edges": [[outer, inner], ...], "cycles": [...]}}`` where scope is
    ``<path>:<ClassName>`` (or ``<path>:<module>``).  Scopes with no
    locks are omitted.  The acceptance gate asserts every
    auto-discovered lock-bearing module appears here and every scope is
    acyclic."""
    out: Dict[str, Dict[str, object]] = {}
    for path in paths:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        lines = source.splitlines()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            continue
        sink: List[Diagnostic] = []
        for cls_node, spec in _parse_annotations(tree, lines, path):
            if spec.is_module:
                units = [
                    item for item in tree.body
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                ]
                # module globals are also acquired from methods (same
                # unit set lint_source checks): without them the graph
                # is vacuously acyclic exactly where cycles could hide
                for node in ast.walk(tree):
                    if isinstance(node, ast.ClassDef):
                        units.extend(
                            it for it in node.body
                            if isinstance(
                                it, (ast.FunctionDef, ast.AsyncFunctionDef)
                            )
                        )
            elif cls_node is not None:
                units = [
                    item for item in cls_node.body
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and item.name != "__init__"
                ]
            else:
                units = []
            for item in units:
                checker = _MethodChecker(spec, lines, path, sink,
                                         method_name=item.name)
                for stmt in item.body:
                    checker.visit(stmt)
                spec.method_locks.setdefault(item.name, set()).update(
                    checker.acquired_anywhere
                )
            locks = sorted(
                spec.lock_names | set(spec.guards.values())
            )
            if not locks:
                continue
            edges = _expanded_edges(spec)
            out[f"{path}:{spec.name}"] = {
                "locks": locks,
                "edges": sorted([a, b] for a, b in edges),
                "cycles": _find_cycles(edges),
            }
    return out
