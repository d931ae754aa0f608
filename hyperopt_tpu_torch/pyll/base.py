"""Stochastic expression graph — the ``pyll`` equivalent.

Reference parity (see SURVEY.md §2 #1): ``hyperopt/pyll/base.py`` —
``SymbolTable``/``scope`` (~L60-180), ``Apply`` (~L180-450), ``Literal``
(~L450-520), ``as_apply`` (~L520-560), ``dfs``/``toposort`` (~L560-640),
``rec_eval`` (~L640-830), ``clone``/``clone_merge`` (~L830-900), arithmetic
and container scope functions (~L900-1200).

Design note: in the reference this graph is *interpreted per trial*
(``rec_eval`` runs in the hot loop of every ``Domain.evaluate`` and every
TPE suggest).  Here the graph is only a declarative *frontend*: the search
space it describes is compiled once by ``hyperopt_tpu_torch.vectorize``
into a batched torch sampler, and ``rec_eval`` survives solely for
(a) evaluating the user's objective wiring (``Domain.evaluate``) and
(b) exotic spaces the compiler cannot lower.  Nothing in this module
touches torch; it is host-side Python by design.
"""

from __future__ import annotations

import numbers
from collections import deque

import numpy as np


class PyllImportError(ImportError):
    """Raised when a symbol is not found in the scope symbol table."""


# =====================================================================
# Symbol table
# =====================================================================


class SymbolTable:
    """Registry of named functions usable as graph nodes.

    ``scope.<name>(*args, **kwargs)`` builds an :class:`Apply` node; the
    implementation is looked up at evaluation time by :func:`rec_eval`.
    """

    def __init__(self):
        self._impls = {}
        self._pure = set()

    # -- introspection ------------------------------------------------
    def __contains__(self, name):
        return name in self._impls

    def impl(self, name):
        try:
            return self._impls[name]
        except KeyError:
            raise PyllImportError(f"no scope function named {name!r}")

    # -- registration -------------------------------------------------
    def define(self, f, name=None, pure=False):
        """Register ``f`` under ``name`` (default ``f.__name__``).

        Returns a builder so that ``scope.define``-decorated functions can
        still be called to create graph nodes: ``scope.uniform(0, 1)``.
        """
        name = name or f.__name__
        if hasattr(self, name):
            raise ValueError(f"Cannot override existing symbol: {name}")
        self._impls[name] = f
        if pure:
            self._pure.add(name)

        def apply_builder(*args, **kwargs):
            return Apply(
                name,
                [as_apply(a) for a in args],
                {k: as_apply(v) for k, v in kwargs.items()},
                o_len=None,
                pure=name in self._pure,
            )

        apply_builder.__name__ = name
        apply_builder.fn = f
        setattr(self, name, apply_builder)
        return apply_builder

    def define_pure(self, f):
        return self.define(f, pure=True)

    def define_info(self, o_len=None):
        """Decorator variant that records the output length of the node."""

        def wrapper(f):
            builder = self.define(f)
            orig = builder

            def with_o_len(*args, **kwargs):
                node = orig(*args, **kwargs)
                node.o_len = o_len
                return node

            with_o_len.__name__ = f.__name__
            with_o_len.fn = f
            setattr(self, f.__name__, with_o_len)
            self._impls[f.__name__] = f
            return with_o_len

        return wrapper


scope = SymbolTable()


def undefined(*args, **kwargs):  # pragma: no cover - defensive
    raise NotImplementedError("this scope symbol is evaluated specially")


# =====================================================================
# Graph nodes
# =====================================================================


class Apply:
    """A function application node in the expression graph.

    ``name`` is a key into :data:`scope`; ``pos_args`` and ``named_args``
    hold child nodes.  Identity semantics: nodes hash/compare by object
    identity (the graph is a DAG of shared nodes, not a value tree).
    """

    def __init__(self, name, pos_args, named_args, o_len=None, pure=False):
        self.name = name
        self.pos_args = list(pos_args)
        if isinstance(named_args, dict):
            named_args = sorted(named_args.items())
        # list of [kw, node], kept sorted by kw for deterministic traversal
        self.named_args = [[k, v] for k, v in named_args]
        self.o_len = o_len
        self.pure = pure
        assert all(isinstance(v, Apply) for v in self.pos_args)
        assert all(isinstance(v, Apply) for _, v in self.named_args)

    # -- structure ----------------------------------------------------
    def inputs(self):
        """All child nodes, positional then keyword (deterministic order)."""
        rval = self.pos_args + [v for _, v in self.named_args]
        assert all(isinstance(arg, Apply) for arg in rval)
        return rval

    @property
    def arg(self):
        """Mapping from argument name to node, best-effort for builtins."""
        rval = dict(self.named_args)
        try:
            code = scope.impl(self.name).__code__
            varnames = code.co_varnames[: code.co_argcount]
            for i, a in enumerate(self.pos_args):
                rval[varnames[i]] = a
        except (PyllImportError, AttributeError, IndexError):
            for i, a in enumerate(self.pos_args):
                rval[f"arg:{i}"] = a
        return rval

    def set_kwarg(self, name, value):
        """Set/overwrite a keyword argument (used to inject rng handles)."""
        for kv in self.named_args:
            if kv[0] == name:
                kv[1] = as_apply(value)
                return
        # try to convert a positional arg if the impl signature has `name`
        try:
            code = scope.impl(self.name).__code__
            varnames = code.co_varnames[: code.co_argcount]
            if name in varnames:
                pos = varnames.index(name)
                if pos < len(self.pos_args):
                    self.pos_args[pos] = as_apply(value)
                    return
        except PyllImportError:
            pass
        self.named_args.append([name, as_apply(value)])
        self.named_args.sort(key=lambda kv: kv[0])

    def clone_from_inputs(self, inputs, o_len="same"):
        if len(inputs) != len(self.inputs()):
            raise TypeError("inputs must match", (inputs, self.inputs()))
        L = len(self.pos_args)
        pos_args = list(inputs[:L])
        named_args = [
            [kw, inputs[L + ii]] for ii, (kw, _) in enumerate(self.named_args)
        ]
        if o_len == "same":
            o_len = self.o_len
        return self.__class__(self.name, pos_args, named_args, o_len)

    def replace_input(self, old_node, new_node):
        rval = []
        for ii, aa in enumerate(self.pos_args):
            if aa is old_node:
                self.pos_args[ii] = new_node
                rval.append(ii)
        for ii, (_, aa) in enumerate(self.named_args):
            if aa is old_node:
                self.named_args[ii][1] = new_node
                rval.append(ii + len(self.pos_args))
        return rval

    # -- pretty printing ----------------------------------------------
    def pprint(self, memo=None, depth=0, max_depth=8):
        if memo is None:
            memo = {}
        if self in memo:
            return memo[self]
        if depth > max_depth:
            return f"{self.name}(...)"
        parts = [a.pprint(memo, depth + 1, max_depth) for a in self.pos_args]
        parts += [
            f"{k}={v.pprint(memo, depth + 1, max_depth)}"
            for k, v in self.named_args
        ]
        s = f"{self.name}({', '.join(parts)})"
        memo[self] = s
        return s

    def __str__(self):
        return self.pprint()

    def __repr__(self):
        return f"<Apply {self.name} at {hex(id(self))}>"

    # -- len / indexing ------------------------------------------------
    def __len__(self):
        if self.o_len is None:
            return object.__len__(self)
        return self.o_len

    def __getitem__(self, idx):
        if isinstance(idx, Apply):
            return scope.getitem(self, idx)
        return scope.getitem(self, as_apply(idx))

    # -- arithmetic sugar ----------------------------------------------
    def __add__(self, other):
        return scope.add(self, other)

    def __radd__(self, other):
        return scope.add(other, self)

    def __sub__(self, other):
        return scope.sub(self, other)

    def __rsub__(self, other):
        return scope.sub(other, self)

    def __mul__(self, other):
        return scope.mul(self, other)

    def __rmul__(self, other):
        return scope.mul(other, self)

    def __truediv__(self, other):
        return scope.truediv(self, other)

    def __rtruediv__(self, other):
        return scope.truediv(other, self)

    def __floordiv__(self, other):
        return scope.floordiv(self, other)

    def __rfloordiv__(self, other):
        return scope.floordiv(other, self)

    def __pow__(self, other):
        return scope.pow(self, other)

    def __rpow__(self, other):
        return scope.pow(other, self)

    def __neg__(self):
        return scope.neg(self)

    def __abs__(self):
        return scope.abs_(self)


class Literal(Apply):
    """A constant leaf node wrapping an arbitrary Python object."""

    def __init__(self, obj=None):
        try:
            o_len = len(obj)
        except TypeError:
            o_len = None
        Apply.__init__(self, "literal", [], {}, o_len, pure=True)
        self._obj = obj

    @property
    def obj(self):
        return self._obj

    def pprint(self, memo=None, depth=0, max_depth=8):
        return repr(self._obj)

    def __repr__(self):
        return f"<Literal {self._obj!r}>"

    def replace_input(self, old_node, new_node):
        return []

    def clone_from_inputs(self, inputs, o_len="same"):
        return self.__class__(self._obj)


def as_apply(obj):
    """Smart constructor: lift a Python value into the graph.

    dicts/lists/tuples become container nodes so that nested search spaces
    are themselves graphs; everything else becomes a :class:`Literal`.
    """
    if isinstance(obj, Apply):
        return obj
    if isinstance(obj, tuple):
        return Apply(
            "pos_args", [as_apply(a) for a in obj], {}, o_len=len(obj), pure=True
        )
    if isinstance(obj, list):
        return Apply("pos_args", [as_apply(a) for a in obj], {}, o_len=None, pure=True)
    if isinstance(obj, dict):
        items = sorted(obj.items())
        if all(isinstance(k, str) for k, _ in items):
            named = {k: as_apply(v) for k, v in items}
            return Apply("dict", [], named, o_len=len(named), pure=True)
        # non-string keys: keep as a literal mapping of lifted pairs
        return Apply(
            "dict_pairs",
            [as_apply((k, v)) for k, v in items],
            {},
            o_len=len(items),
            pure=True,
        )
    return Literal(obj)


# =====================================================================
# Traversal
# =====================================================================


def dfs(aa, seq=None, seqset=None):
    """Post-order depth-first traversal: inputs appear before consumers."""
    if seq is None:
        assert seqset is None
        seq = []
        seqset = {}
    if aa in seqset:
        return seq
    assert isinstance(aa, Apply)
    seqset[aa] = True
    for ii in aa.inputs():
        dfs(ii, seq, seqset)
    seq.append(aa)
    return seq


def toposort(expr):
    """Topological ordering of the graph ending at ``expr``.

    Equivalent to the reference's networkx-based toposort; DFS post-order
    is already a valid topological order for a DAG.
    """
    return dfs(expr)


def clone(expr, memo=None):
    """Deep-copy the graph, preserving internal sharing."""
    if memo is None:
        memo = {}
    nodes = dfs(expr)
    for node in nodes:
        if node not in memo:
            new_inputs = [memo[arg] for arg in node.inputs()]
            memo[node] = node.clone_from_inputs(new_inputs)
    return memo[expr]


def clone_merge(expr, memo=None, merge_literals=False):
    """Clone while merging identical pure nodes (CSE)."""
    if memo is None:
        memo = {}
    nodes = dfs(expr)
    keyed = {}
    for node in nodes:
        if node in memo:
            continue
        new_inputs = [memo[arg] for arg in node.inputs()]
        if node.pure and (merge_literals or not isinstance(node, Literal)):
            if isinstance(node, Literal):
                try:
                    key = (node.name, repr(node.obj))
                except Exception:  # unreprable literal
                    key = (node.name, id(node))
            else:
                key = (
                    node.name,
                    tuple(id(a) for a in new_inputs),
                    tuple(k for k, _ in node.named_args),
                )
            if key in keyed:
                memo[node] = keyed[key]
                continue
            new_node = node.clone_from_inputs(new_inputs)
            keyed[key] = new_node
            memo[node] = new_node
        else:
            memo[node] = node.clone_from_inputs(new_inputs)
    return memo[expr]


# =====================================================================
# Evaluation
# =====================================================================


class GarbageCollected:
    """Sentinel for memo entries that must never be used.

    ``Domain.memo_from_config`` maps inactive conditional hyperparameters to
    this class; lazy ``switch`` evaluation guarantees they are never read.
    """


def rec_eval(
    expr,
    deepcopy_inputs=False,
    memo=None,
    max_program_len=100000,
    memo_gc=True,
    print_node_on_error=True,
    return_memo=False,
):
    """Evaluate the graph iteratively (no Python recursion limit).

    ``switch`` is lazy: only the selected branch is evaluated, which is what
    makes conditional search spaces (``hp.choice``) work — inactive branches
    may reference hyperparameters that have no value in ``memo``.
    """
    if memo is None:
        memo = {}
    else:
        memo = dict(memo)
    node = as_apply(expr)
    todo = deque([node])
    steps = 0
    while todo:
        steps += 1
        if steps > max_program_len:
            raise RuntimeError("rec_eval exceeded max program length")
        current = todo[-1]
        if current in memo:
            todo.pop()
            continue
        if isinstance(current, Literal):
            memo[current] = current.obj
            todo.pop()
            continue
        if current.name == "switch":
            # lazy: index first, then only the chosen branch
            idx_node = current.pos_args[0]
            if idx_node not in memo:
                todo.append(idx_node)
                continue
            idx_val = memo[idx_node]
            if idx_val is GarbageCollected:
                raise RuntimeError("switch index was garbage-collected")
            chosen = current.pos_args[int(idx_val) + 1]
            if chosen not in memo:
                todo.append(chosen)
                continue
            memo[current] = memo[chosen]
            todo.pop()
            continue
        waiting = [n for n in current.inputs() if n not in memo]
        if waiting:
            todo.extend(waiting)
            continue
        args = [memo[a] for a in current.pos_args]
        kwargs = {k: memo[v] for k, v in current.named_args}
        if any(a is GarbageCollected for a in args) or any(
            v is GarbageCollected for v in kwargs.values()
        ):
            raise RuntimeError(
                f"node {current.name} consumed a garbage-collected input "
                "(inactive conditional hyperparameter used outside its branch?)"
            )
        try:
            memo[current] = scope.impl(current.name)(*args, **kwargs)
        except Exception:
            if print_node_on_error:
                print("=" * 60)
                print("rec_eval failed at node:")
                print(current.pprint())
                print("=" * 60)
            raise
        todo.pop()
    if return_memo:
        return memo[node], memo
    return memo[node]


# =====================================================================
# Builtin scope functions: containers, arithmetic, comparisons
# =====================================================================


# NOTE: several scope symbols share names with Python builtins (`dict`,
# `len`, `float`, `int`, `pow`).  They are registered with explicit `name=`
# on private impl functions so this module's own code never loses the
# builtins.

import builtins as _bi


@scope.define_pure
def literal(obj=None):  # placeholder; Literal nodes are handled specially
    return obj


@scope.define_pure
def pos_args(*args):
    return args


def _dict_impl(**kwargs):
    return kwargs


scope.define(_dict_impl, name="dict", pure=True)


@scope.define_pure
def dict_pairs(*pairs):
    return {k: v for k, v in pairs}


@scope.define_pure
def getitem(obj, idx):
    return obj[idx]


@scope.define_pure
def identity(obj):
    return obj


@scope.define_pure
def hyperopt_param(label, obj):
    """A named hyperparameter: evaluates to its wrapped distribution draw.

    The label rides along so the compiler / algorithms can address this node;
    at evaluation time it is the identity on ``obj``.
    """
    return obj


# `switch` is evaluated lazily inside rec_eval; the impl exists only so the
# symbol is defined (e.g. for strict evaluation of already-known branches).
@scope.define_pure
def switch(index, *options):
    return options[_bi.int(index)]


scope.define(lambda obj: _bi.len(obj), name="len", pure=True)
scope.define(lambda obj: _bi.float(obj), name="float", pure=True)
scope.define(lambda obj: _bi.int(obj), name="int", pure=True)
scope.define(lambda a, b: a ** b, name="pow", pure=True)
scope.define(lambda a: _bi.abs(a), name="abs_", pure=True)


@scope.define_pure
def add(a, b):
    return a + b


@scope.define_pure
def sub(a, b):
    return a - b


@scope.define_pure
def mul(a, b):
    return a * b


@scope.define_pure
def truediv(a, b):
    return a / b


@scope.define_pure
def floordiv(a, b):
    return a // b


@scope.define_pure
def neg(a):
    return -a


@scope.define_pure
def exp(a):
    return np.exp(a)


@scope.define_pure
def log(a):
    return np.log(a)


@scope.define_pure
def sqrt(a):
    return np.sqrt(a)


@scope.define_pure
def minimum(a, b):
    return np.minimum(a, b)


@scope.define_pure
def maximum(a, b):
    return np.maximum(a, b)


@scope.define_pure
def eq(a, b):
    return a == b


@scope.define_pure
def gt(a, b):
    return a > b


@scope.define_pure
def lt(a, b):
    return a < b


@scope.define_pure
def ge(a, b):
    return a >= b


@scope.define_pure
def le(a, b):
    return a <= b


@scope.define_pure
def array_union(a, b):
    return np.union1d(a, b)


@scope.define_pure
def asarray(a, dtype=None):
    if dtype is None:
        return np.asarray(a)
    return np.asarray(a, dtype=dtype)


@scope.define_pure
def repeat(n_times, obj):
    return [obj] * n_times


@scope.define
def call_method(obj, methodname, *args, **kwargs):
    return getattr(obj, methodname)(*args, **kwargs)


@scope.define_pure
def call_method_pure(obj, methodname, *args, **kwargs):
    return getattr(obj, methodname)(*args, **kwargs)
