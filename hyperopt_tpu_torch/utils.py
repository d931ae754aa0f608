"""General utilities.

Reference parity (SURVEY.md §2 #12): ``hyperopt/utils.py`` —
``import_tokens``/``json_call``/``get_obj``, ``coarse_utcnow``,
``fast_isin``, ``get_most_recent_inds``, ``use_obj_for_literal_in_memo``,
``temp_dir``/``working_dir``/``path_split_all``, plus ``pmin_sampled``
(reference: ``hyperopt/utils.py`` / ``hyperopt/base.py`` helpers).
"""

from __future__ import annotations

import contextlib
import datetime
import importlib
import logging
import os
import shutil

import numpy as np

logger = logging.getLogger(__name__)


def import_tokens(tokens):
    """Progressively import a dotted path, returning the list of objects."""
    rval = []
    for i in range(len(tokens)):
        modsequence = ".".join(tokens[: i + 1])
        try:
            rval.append(importlib.import_module(modsequence))
        except ImportError:
            exec_import = rval[-1] if rval else None
            for token in tokens[i:]:
                exec_import = getattr(exec_import, token)
                rval.append(exec_import)
            break
    return rval


def get_obj(init, args=(), kwargs=None, cmd=None, obj=None):
    """Instantiate/call an object given a dotted-path command spec."""
    kwargs = kwargs or {}
    if cmd is not None:
        results = import_tokens(cmd.split("."))
        return results[-1](*args, **kwargs)
    if obj is not None:
        return obj
    return init(*args, **kwargs)


def json_call(cmd, args=(), kwargs=None):
    """Call a function named by dotted path (worker dispatch primitive)."""
    tokens = cmd.split(".")
    f = import_tokens(tokens)[-1]
    return f(*args, **(kwargs or {}))


def coarse_utcnow():
    """UTC now, rounded down to milliseconds (BSON datetime resolution —
    preserved so trial timestamps serialize identically everywhere)."""
    now = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
    microsec = (now.microsecond // 1000) * 1000
    return datetime.datetime(
        now.year, now.month, now.day, now.hour, now.minute, now.second, microsec
    )


def fast_isin(X, Y):
    """Boolean mask of which elements of X are in (sorted-able) Y."""
    if len(Y) == 0:
        return np.zeros(len(X), dtype=bool)
    T = Y.copy()
    T.sort()
    D = T.searchsorted(X)
    T = np.append(T, np.array([0]))
    W = T[D] == X
    W[D == len(T) - 1] = False  # searchsorted past the end: not a member
    if isinstance(W, bool):
        return np.zeros(len(X), dtype=bool)
    return W


def get_most_recent_inds(obj):
    """Indices of the most recent (highest _attachments version) docs."""
    data = np.rec.array(
        [(x["_id"], int(x["version"])) for x in obj],
        names=["_id", "version"],
    )
    s = data.argsort(order=["_id", "version"])
    data = data[s]
    recent = (data["_id"][1:] != data["_id"][:-1]).nonzero()[0]
    recent = np.append(recent, len(data) - 1)
    return s[recent]


def use_obj_for_literal_in_memo(expr, obj, lit, memo):
    """Set ``memo[node] = obj`` for all Literal nodes whose value is ``lit``.

    This is how ``Ctrl`` handles are injected into search-space graphs that
    reference the sentinel class (reference: ``hyperopt/utils.py``).
    """
    from .pyll.base import Literal, dfs

    for node in dfs(expr):
        if isinstance(node, Literal) and node.obj is lit:
            memo[node] = obj
    return memo


def pmin_sampled(mean, var, n_samples=1000, rng=None):
    """Probability each point is the minimum, under independent normals.

    Monte-Carlo estimate used by ``Trials.average_best_error``.
    """
    if rng is None:
        rng = np.random.default_rng(232)
    mean = np.asarray(mean, dtype=float)
    var = np.asarray(var, dtype=float)
    samples = rng.standard_normal((n_samples, len(mean))) * np.sqrt(var) + mean
    winners = np.argmin(samples, axis=1)
    counts = np.bincount(winners, minlength=len(mean))
    return counts.astype(float) / counts.sum()


@contextlib.contextmanager
def temp_dir(dir_path, erase_after=False, with_sentinel=True):
    """Create a directory (and sentinel) for the duration of a context."""
    created_by_me = False
    if not os.path.exists(dir_path):
        os.makedirs(dir_path, exist_ok=True)
        created_by_me = True
    sentinel = os.path.join(dir_path, ".hyperopt_tpu_tmp")
    if with_sentinel:
        # durability: exempt(ephemeral scratch-dir marker, unlinked on exit)
        with open(sentinel, "w") as f:
            f.write("tmp\n")
    try:
        yield dir_path
    finally:
        if erase_after and created_by_me:
            shutil.rmtree(dir_path, ignore_errors=True)
        elif with_sentinel and os.path.exists(sentinel):
            os.unlink(sentinel)


@contextlib.contextmanager
def working_dir(dir_path):
    """chdir into ``dir_path`` for the duration of a context."""
    cwd = os.getcwd()
    os.chdir(dir_path)
    try:
        yield dir_path
    finally:
        os.chdir(cwd)


def path_split_all(path):
    """Split a path into all of its components."""
    parts = []
    while True:
        path, tail = os.path.split(path)
        if tail:
            parts.append(tail)
        else:
            if path:
                parts.append(path)
            break
    parts.reverse()
    return parts
