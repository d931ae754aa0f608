"""Core runtime: trial documents, the Trials store, Ctrl, and Domain.

Reference parity (SURVEY.md §2 #6): ``hyperopt/base.py`` — ``STATUS_*`` /
``JOB_STATE_*`` (~L40-90), ``SONify`` (~L90-130), ``miscs_update_idxs_vals``/
``miscs_to_idxs_vals``/``spec_from_misc`` (~L130-210), ``validate_timeout``/
``validate_loss_threshold`` (~L210-240), ``Trials`` (~L240-640),
``trials_from_docs`` (~L640-660), ``Ctrl`` (~L660-740), ``Domain``
(~L740-1000).

Design notes:
- ``Domain.__init__`` compiles the space once via
  :class:`hyperopt_tpu_torch.vectorize.CompiledSpace` (replacing the reference's
  ``VectorizeHelper`` graph rewrite); algorithms consume the compiled
  sampler, never re-interpreting the graph per suggest.
- ``Trials`` additionally maintains a **struct-of-arrays history cache**
  (per-label contiguous value/tid arrays + aligned loss arrays) extended
  in O(k) for k new trials, so TPE's device plane consumes history
  without per-suggest Python document walking; the fmin loop's
  incremental refresh (:func:`loop_refresh`) visits only the documents
  that can have changed since the last refresh.
"""

from __future__ import annotations

import bisect
import datetime
import logging
import numbers

import numpy as np

from . import tracing
from .exceptions import (
    AllTrialsFailed,
    InvalidLoss,
    InvalidResultStatus,
    InvalidTrial,
)
from .pyll.base import GarbageCollected, as_apply, rec_eval
from .utils import coarse_utcnow, pmin_sampled, use_obj_for_literal_in_memo
from .vectorize import CompiledSpace

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------
# Status / job-state constants
# ---------------------------------------------------------------------

STATUS_NEW = "new"
STATUS_RUNNING = "running"
STATUS_SUSPENDED = "suspended"
STATUS_OK = "ok"
STATUS_FAIL = "fail"
STATUS_STRINGS = (
    "new",
    "running",
    "suspended",
    "ok",
    "fail",
)

JOB_STATE_NEW = 0
JOB_STATE_RUNNING = 1
JOB_STATE_DONE = 2
JOB_STATE_ERROR = 3
JOB_STATE_CANCEL = 4
JOB_STATES = (
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_CANCEL,
)
JOB_VALID_STATES = frozenset(JOB_STATES)

TRIAL_KEYS = frozenset(
    [
        "tid",
        "spec",
        "result",
        "misc",
        "state",
        "owner",
        "book_time",
        "refresh_time",
        "exp_key",
    ]
)

TRIAL_MISC_KEYS = frozenset(["tid", "cmd", "idxs", "vals"])


# ---------------------------------------------------------------------
# Serialization helpers
# ---------------------------------------------------------------------


def SONify(arg, memo=None):
    """Recursively convert numpy scalars/arrays to plain Python values so
    trial documents are JSON/BSON-serializable."""
    if memo is None:
        memo = {}
    if id(arg) in memo:
        return memo[id(arg)]
    if isinstance(arg, datetime.datetime):
        rval = arg
    elif isinstance(arg, np.floating):
        rval = float(arg)
    elif isinstance(arg, np.integer):
        rval = int(arg)
    elif isinstance(arg, np.bool_):
        rval = bool(arg)
    elif isinstance(arg, np.ndarray):
        if arg.ndim == 0:
            rval = SONify(arg.item())
        else:
            rval = [SONify(a, memo) for a in arg]
    elif isinstance(arg, (list, tuple)):
        rval = type(arg)(SONify(a, memo) for a in arg)
    elif isinstance(arg, dict):
        rval = {SONify(k, memo): SONify(v, memo) for k, v in arg.items()}
    elif isinstance(arg, (str, float, int, bool, type(None))):
        rval = arg
    else:
        raise TypeError("SONify", arg)
    memo[id(arg)] = rval
    return rval


def miscs_update_idxs_vals(miscs, idxs, vals, assert_all_vals_used=True, idxs_map=None):
    """Unpack aggregated (idxs, vals) into the per-trial misc documents."""
    if idxs_map is None:
        idxs_map = {}
    assert set(idxs.keys()) == set(vals.keys())
    misc_by_id = {m["tid"]: m for m in miscs}
    for m in miscs:
        m["idxs"] = {key: [] for key in idxs}
        m["vals"] = {key: [] for key in idxs}
    for key in idxs:
        assert len(idxs[key]) == len(vals[key])
        for tid, val in zip(idxs[key], vals[key]):
            tid = idxs_map.get(tid, tid)
            if assert_all_vals_used or tid in misc_by_id:
                misc_by_id[tid]["idxs"][key] = [tid]
                misc_by_id[tid]["vals"][key] = [val]
    return miscs


def miscs_to_idxs_vals(miscs, keys=None):
    """Aggregate per-trial misc docs into {label: [tids]} / {label: [vals]}."""
    if keys is None:
        if len(miscs) == 0:
            raise ValueError("cannot infer keys from empty miscs")
        keys = list(miscs[0]["idxs"].keys())
    idxs = {k: [] for k in keys}
    vals = {k: [] for k in keys}
    for misc in miscs:
        for node_id in keys:
            t_idxs = misc["idxs"].get(node_id, [])
            t_vals = misc["vals"].get(node_id, [])
            assert len(t_idxs) == len(t_vals)
            assert t_idxs == [] or t_idxs == [misc["tid"]]
            idxs[node_id].extend(t_idxs)
            vals[node_id].extend(t_vals)
    return idxs, vals


def spec_from_misc(misc):
    """The {label: value} assignment of one trial (active labels only)."""
    spec = {}
    for k, v in misc["vals"].items():
        if len(v) == 0:
            pass
        elif len(v) == 1:
            spec[k] = v[0]
        else:
            raise NotImplementedError("multiple values for one label", (k, v))
    return spec


def validate_timeout(timeout):
    if timeout is not None and (
        not isinstance(timeout, numbers.Number)
        or timeout <= 0
        or isinstance(timeout, bool)
    ):
        raise Exception(
            f"The timeout argument should be None or a positive value. Given value: {timeout}"
        )


def validate_loss_threshold(loss_threshold):
    if loss_threshold is not None and (
        not isinstance(loss_threshold, numbers.Number)
        or isinstance(loss_threshold, bool)
    ):
        raise Exception(
            "The loss_threshold argument should be None or a numeric value. "
            f"Given value: {loss_threshold}"
        )


# ---------------------------------------------------------------------
# Trials
# ---------------------------------------------------------------------


def _scan(docs):
    """One read of each document's state: the history's rows (DONE, ok,
    with a loss) with their tids and losses, and the positions of the
    documents that may still change (neither DONE nor CANCEL: NEW,
    RUNNING, or an ERROR the caller's filter has not dropped yet)."""
    rows, tids, losses, open_pos = [], [], [], []
    i = -1
    for t in docs:  # a counter, not enumerate: the walk is the hot path
        i += 1
        state = t["state"]
        if state == JOB_STATE_DONE:
            result = t["result"]
            if result.get("status") != STATUS_OK:
                continue
            loss = result.get("loss")
            if loss is None:
                continue
            rows.append(t)
            tids.append(t["tid"])
            losses.append(float(loss))
        elif state != JOB_STATE_CANCEL:
            open_pos.append(i)
    return rows, tids, losses, open_pos


# a loss ``min`` cannot order against the others (a numeric string
# injected beside floats), or a document without a result to read (a
# partial one, as a torn queue record leaves): the tallies hold no best
# loss from there on, and the read walks and raises as the walk does
_UNORDERED = object()


def _ok_loss(t):
    """The loss that fmin's best-loss read takes from document ``t``
    (``losses()`` where ``statuses()`` is OK; None where it takes none,
    ``_UNORDERED`` where that read raises)."""
    try:
        result = t["result"]
        return result.get("loss") if result.get("status") == STATUS_OK else None
    except (KeyError, AttributeError):
        return _UNORDERED


class _Tallies:
    """What the fmin loop reads of a store, kept by its refreshes so that
    the loop reads it in O(1) (:meth:`Trials._tallies`): ``states``, the
    documents per state as ``count_by_state_unsynced`` counts them (the
    store's ``exp_key``, ERROR included); ``best``, Python's ``min`` over
    the OK losses of ``_trials`` in store order (NaN where the first is
    NaN, None where there is none); and ``last_ok``, the position in
    ``_trials`` of the last of those losses."""

    __slots__ = ("states", "best", "last_ok")

    def __init__(self, states, best=None, last_ok=-1):
        self.states = states
        self.best = best
        self.last_ok = last_ok

    def count(self, arg):
        """``count_by_state_synced(arg)`` over the tallied documents."""
        if arg in JOB_STATES:
            return self.states.get(arg, 0)
        if hasattr(arg, "__iter__"):
            states = set(arg)
            assert states.issubset(JOB_VALID_STATES)
            return sum(self.states.get(s, 0) for s in states)
        raise TypeError(arg)

    def add_states(self, docs, exp_key):
        states = self.states
        for t in docs:
            if exp_key is None or t["exp_key"] == exp_key:
                state = t["state"]
                states[state] = states.get(state, 0) + 1

    def add_loss(self, loss, pos):
        """Fold the next OK loss, at ``pos`` in ``_trials``, as ``min``
        does: it replaces ``best`` only where it compares below it."""
        self.last_ok = pos
        best = self.best
        if best is _UNORDERED:
            return
        try:
            if loss is _UNORDERED or best is None or loss < best:
                self.best = loss
        except (TypeError, ValueError):
            self.best = _UNORDERED

    def add_losses(self, docs, start):
        """Fold the OK losses of ``docs``, at ``start``, ``start + 1``, ...
        in ``_trials``."""
        for pos, t in enumerate(docs, start):
            loss = _ok_loss(t)
            if loss is not None:
                self.add_loss(loss, pos)


# the value dtypes a column grows in place; others are re-materialised
# from the column's Python list, as np.asarray would type them
_GROWABLE = frozenset(np.dtype(d) for d in (np.bool_, np.int64, np.float64))


def _grow(buf, n, new):
    """``buf`` with ``new`` written at ``[n, n + len(new))``; reallocated
    by doubling (widened to ``new``'s dtype) when it does not fit.  The
    prefix ``[0, n)`` is never written, so views of it stay as they were."""
    if buf is None:
        return new
    need = n + len(new)
    dtype = np.result_type(buf.dtype, new.dtype)
    if need > len(buf) or dtype != buf.dtype:
        grown = np.empty(max(need, 2 * len(buf)), dtype)
        grown[:n] = buf[:n]
        buf = grown
    buf[n:need] = new
    return buf


class _TrialsHistory:
    """Struct-of-arrays cache of completed-trial history.

    Per label: contiguous ``idxs``/``vals`` numpy arrays (active trials
    only); plus the aligned ok-trial ``loss_tids``/``losses`` arrays.  This
    is what the TPE/anneal kernels consume — rebuilt only when the set of
    completed trials changes, never per suggest.  Each array is the filled
    prefix of a buffer grown by doubling, so appending k trials costs O(k);
    an array handed out is never written again.
    """

    def __init__(self):
        self._seen_revision = None
        self._bufs = {}        # column key -> buffer; the arrays are prefixes
        self._vals_lists = {}  # label -> values as stored, for odd dtypes
        self._loss_join_view = None
        self.idxs = {}
        self.vals = {}
        self.loss_tids = np.zeros(0, dtype=np.int64)
        self.losses = np.zeros(0, dtype=np.float64)
        # Monotonic content version: bumped each time the arrays are
        # actually replaced.  ``last_nonappend_version`` marks the last
        # bump that was NOT append-only growth — downstream device
        # mirrors (tpe_device.DeviceHistory) use the pair to take their
        # append fast path without re-comparing the full synced prefix
        # (O(N) per suggest otherwise).
        self.content_version = 0
        self.last_nonappend_version = 0

    def __getstate__(self):
        # pickle the arrays, not their buffers' spare capacity
        state = dict(self.__dict__)
        del state["_bufs"]
        return state

    def __setstate__(self, state):
        # defaults first, then the pickled attrs: caches pickled by older
        # versions (inside trials_save_file checkpoints) lack newer
        # attributes like _seen_revision/_loss_join_view and carry retired
        # ones; each array becomes its own column's buffer
        self.__init__()
        self.__dict__.update(state)
        for old in ("_fingerprint", "_idxs_lists"):
            self.__dict__.pop(old, None)
        self._bufs = {"tids": self.loss_tids, "losses": self.losses}
        self._bufs.update({("idxs", k): v for k, v in self.idxs.items()})
        self._bufs.update({("vals", k): v for k, v in self.vals.items()})

    def join_losses(self, tids):
        """Vectorized tid→loss join against the aligned (loss_tids,
        losses) arrays: returns ``(ok_mask, losses_of_ok)`` where
        ``ok_mask`` marks tids present with a non-NaN loss.  The sorted
        view is memoized per rebuild (shared by anneal's incumbent build
        and ATPE's correlation featurizer — both per-suggest)."""
        tids = np.asarray(tids, dtype=np.int64)
        if self._loss_join_view is None:
            order = np.argsort(self.loss_tids, kind="stable")
            self._loss_join_view = (self.loss_tids[order], self.losses[order])
        lt_sorted, ls_sorted = self._loss_join_view
        if not len(lt_sorted) or not len(tids):
            return np.zeros(len(tids), dtype=bool), np.zeros(0)
        pos = np.clip(np.searchsorted(lt_sorted, tids), 0, len(lt_sorted) - 1)
        ok = (lt_sorted[pos] == tids) & ~np.isnan(ls_sorted[pos])
        return ok, ls_sorted[pos[ok]]

    def maybe_rebuild(self, trials_obj):
        """Bring the cache up to ``trials_obj``; returns what it did:
        "skipped", "unchanged", "appended" or "rebuilt" (the ``rebuild``
        attribute of a ``trials.refresh`` span)."""
        # Revision fast path: ``Trials`` bumps ``_revision`` in its
        # refreshes — the sole points where ``_trials`` (what this cache
        # reads) changes — so an unchanged revision means the store
        # content is unchanged and the O(N) walk below is skipped
        # entirely — this is what keeps per-suggest host work O(1) at
        # 10k-trial histories.  In-place doc mutation WITHOUT a refresh()
        # is invisible to this cache; refresh-before-read is the store's
        # documented contract (the fmin loop, workers, and
        # serial_evaluate all end mutations with a refresh).
        rev = getattr(trials_obj, "_revision", None)
        if rev is not None and rev == self._seen_revision:
            return "skipped"
        rows, tids, losses, _ = _scan(trials_obj._trials)
        return self.fold(rows, tids, losses, rev)

    def fold(self, rows, tids, losses, rev):
        """Bring the cache up to a full walk's rows (``_scan``'s, in store
        order): "unchanged", "appended" when the rows extend the cached
        ones, else "rebuilt".  ``rev`` is the store's revision they were
        read at.  (_seen_revision is committed only on SUCCESS, so an
        exception, e.g. a malformed loss, leaves the cache marked stale and
        re-raises on the next access instead of silently serving
        pre-mutation arrays.)"""
        fp_tids = np.asarray(tids, dtype=np.int64)
        fp_losses = np.asarray(losses, dtype=np.float64)
        # the (tid, loss) pairs double as the change fingerprint: bytes,
        # so a NaN or a signed zero that changes is a change
        if (
            self.content_version
            and fp_tids.tobytes() == self.loss_tids.tobytes()
            and fp_losses.tobytes() == self.losses.tobytes()
        ):
            self._seen_revision = rev
            return "unchanged"
        n_prev = len(self.loss_tids)
        append_only = (
            len(rows) >= n_prev
            and np.array_equal(fp_tids[:n_prev], self.loss_tids)
            # equal_nan: NaN losses (diverged trials) are stable content,
            # not changes — without it every append degrades to a full
            # O(N) rebuild once any NaN enters the history
            and np.array_equal(fp_losses[:n_prev], self.losses, equal_nan=True)
        )
        # In the steady state (history grew by k trials) the columns are
        # extended by the k new rows only — the reference re-walks every
        # document per suggest (``miscs_to_idxs_vals``)
        if append_only:
            self._commit(rows[n_prev:], fp_tids[n_prev:], fp_losses[n_prev:], fresh=False)
        else:
            self._commit(rows, fp_tids, fp_losses, fresh=True)
        if not append_only:
            self.last_nonappend_version = self.content_version
        self._seen_revision = rev
        return "appended" if append_only else "rebuilt"

    def append_rows(self, rows, rev):
        """Append newly completed rows (``_scan``'s kind, in store order,
        all after the cached ones) without a walk over the others: what
        :meth:`fold` does for them, in O(len(rows))."""
        if not rows:
            self._seen_revision = rev
            return "unchanged"
        tids = np.asarray([t["tid"] for t in rows], dtype=np.int64)
        losses = np.asarray([float(t["result"]["loss"]) for t in rows], dtype=np.float64)
        self._commit(rows, tids, losses, fresh=False)
        self._seen_revision = rev
        return "appended"

    def _commit(self, rows, tids, losses, fresh):
        """Append ``rows`` (all of them when ``fresh``: the columns start
        empty) and bump ``content_version``.  Everything that can raise on
        a malformed doc (missing vals, a non-int tid) runs before the
        first attribute changes, so the previous cache stays whole."""
        idx_new, val_new = {}, {}
        for t in rows:
            misc = t["misc"]
            for k, tt in misc["idxs"].items():
                if tt:
                    idx_new.setdefault(k, []).append(tt[0])
                    val_new.setdefault(k, []).append(misc["vals"][k][0])
        idx_arrays = {k: np.asarray(v, dtype=np.int64) for k, v in idx_new.items()}
        old_vals = {} if fresh else self.vals
        old_lists = {} if fresh else self._vals_lists
        val_arrays, whole = {}, {}
        for k, v in val_new.items():
            batch = np.asarray(v)
            old = old_vals.get(k)
            if batch.dtype in _GROWABLE and (old is None or old.dtype in _GROWABLE):
                val_arrays[k] = batch
            else:
                whole[k] = np.asarray(old_lists.get(k, []) + v)
        if fresh:
            self._bufs, self._vals_lists, self.idxs, self.vals = {}, {}, {}, {}
        bufs = self._bufs
        n = len(self.loss_tids) if not fresh else 0
        bufs["tids"] = _grow(bufs.get("tids"), n, tids)
        bufs["losses"] = _grow(bufs.get("losses"), n, losses)
        self.loss_tids = bufs["tids"][: n + len(tids)]
        self.losses = bufs["losses"][: n + len(losses)]
        for k, new in idx_arrays.items():
            m = len(self.idxs.get(k, ()))
            bufs["idxs", k] = _grow(bufs.get(("idxs", k)), m, new)
            self.idxs[k] = bufs["idxs", k][: m + len(new)]
        for k, v in val_new.items():
            self._vals_lists.setdefault(k, []).extend(v)
            if k in whole:
                bufs["vals", k] = self.vals[k] = whole[k]
                continue
            m = len(self.vals.get(k, ()))
            bufs["vals", k] = _grow(bufs.get(("vals", k)), m, val_arrays[k])
            self.vals[k] = bufs["vals", k][: m + len(v)]
        self._loss_join_view = None  # re-memoized on next join_losses
        self.content_version += 1


class Trials:
    """In-memory store of trial documents (the serial backend).

    Document format is the reference's: ``tid``, ``spec``, ``result``,
    ``misc`` (with sparse per-label ``idxs``/``vals``), ``state``, ``owner``,
    ``book_time``, ``refresh_time``, ``exp_key``.

    **Mutation contract (refresh-before-read):** every mutation of trial
    documents must be followed by :meth:`refresh` before ``history`` /
    ``best_trial`` / the suggest algorithms read the store.  ``refresh``
    is the sole revision-bump point; the SoA history cache and the
    device-resident mirrors key their O(1) fast paths off that revision,
    so in-place doc edits without a refresh are invisible to them.
    Subclasses overriding ``refresh`` must call ``super().refresh()``
    (or otherwise reach the bump) — pinned by
    ``tests/test_device_history.py::TestRevisionContract``.

    ``refresh()`` walks every document.  The fmin loop's own refresh
    points (:func:`loop_refresh`) fold only the documents appended since
    the last refresh and those that were NEW or RUNNING then, which is all
    the loop itself changes; a run's first refresh and its closing ones
    walk everything.  So an in-place edit of a COMPLETED trial mid-run
    (say, by an ``early_stop_fn``) reaches ``history`` at the run's
    closing refresh, or at the next ``refresh()`` call, not before.

    Each refresh also keeps the documents per state and the best OK loss
    (``_Tallies``), so the loop reads :meth:`count_by_state_tallied` and
    :meth:`min_ok_loss` in O(1) instead of walking every document.  They
    serve the tallies only where the store keeps :meth:`refresh`, is not
    ``asynchronous``, and has had nothing appended since its last refresh;
    elsewhere they walk as ``count_by_state_unsynced`` and ``losses()`` do.
    The contract is the same: between a refresh and the read, a state
    changed or a loss edited in place is not seen, and an edit of a
    COMPLETED trial mid-run reaches them at the next full refresh, as it
    reaches ``history``.
    """

    asynchronous = False

    def __init__(self, exp_key=None, refresh=True):
        self._ids = set()
        self._dynamic_trials = []
        self._exp_key = exp_key
        self.attachments = {}
        self._history = _TrialsHistory()
        self._revision = 0
        self._refresh_mark = None
        if refresh:
            self.refresh()

    # -- container protocol -------------------------------------------
    def view(self, exp_key=None, refresh=True):
        rval = object.__new__(self.__class__)
        rval._exp_key = exp_key
        rval._ids = self._ids
        rval._dynamic_trials = self._dynamic_trials
        rval.attachments = self.attachments
        rval._history = _TrialsHistory()
        rval._revision = 0
        rval._refresh_mark = None
        if refresh:
            rval.refresh()
        return rval

    def aname(self, trial, name):
        return f"ATTACH::{trial['tid']}::{name}"

    def trial_attachments(self, trial):
        """Dict-like accessor to a single trial's attachments."""

        class Attachments:
            def __contains__(_self, name):
                return self.aname(trial, name) in self.attachments

            def __getitem__(_self, name):
                return self.attachments[self.aname(trial, name)]

            def __setitem__(_self, name, value):
                self.attachments[self.aname(trial, name)] = value

            def __delitem__(_self, name):
                del self.attachments[self.aname(trial, name)]

        return Attachments()

    def __iter__(self):
        return iter(self._trials)

    def __len__(self):
        return len(self._trials)

    def __getitem__(self, item):
        return self._trials[item]

    # -- views over documents -----------------------------------------
    @property
    def trials(self):
        return self._trials

    @property
    def tids(self):
        return [tt["tid"] for tt in self._trials]

    @property
    def specs(self):
        return [tt["spec"] for tt in self._trials]

    @property
    def results(self):
        return [tt["result"] for tt in self._trials]

    @property
    def miscs(self):
        return [tt["misc"] for tt in self._trials]

    @property
    def idxs_vals(self):
        return miscs_to_idxs_vals(self.miscs)

    @property
    def idxs(self):
        return self.idxs_vals[0]

    @property
    def vals(self):
        return self.idxs_vals[1]

    # -- store maintenance --------------------------------------------
    def refresh(self):
        """Rebuild ``_trials``, ``_ids`` and the history cache from every
        document, in-place edits of completed trials included.  Records
        where the walk left off for the fmin loop's incremental refresh
        (:func:`loop_refresh`)."""
        self._refresh(incremental=False)

    def _refresh_incremental(self):
        """The fmin loop's refresh (see :func:`loop_refresh`): folds only
        the documents appended since the last refresh and those that were
        NEW or RUNNING then, and gives the state :meth:`refresh` would.
        Walks every document instead where it cannot prove that."""
        self._refresh(incremental=True)

    def _refresh(self, incremental):
        # a refresh is the SOLE revision-bump point: every documented
        # mutation path ends in one, and _trials (what the cache reads)
        # only changes here.  The bump lets _TrialsHistory skip its O(N)
        # change scan between refreshes.  (getattr: Trials unpickled from
        # pre-revision checkpoints lack the attribute — trials_save_file
        # resume must keep working)
        self._revision = getattr(self, "_revision", 0) + 1
        with tracing.span("trials.refresh", n_docs=len(self._dynamic_trials)) as sp:
            walked = self._fold_changed(sp) if incremental else None
            if walked is None:
                walked = self._fold_all(sp)
            sp.set_attr("n_walked", walked)

    def _kept(self, docs):
        """``docs`` less the ERROR ones and, in an ``exp_key`` view, those
        of other experiments: what ``_trials`` holds."""
        if self._exp_key is None:
            return [tt for tt in docs if tt["state"] != JOB_STATE_ERROR]
        return [
            tt
            for tt in docs
            if tt["state"] != JOB_STATE_ERROR and tt["exp_key"] == self._exp_key
        ]

    def _fold_all(self, sp):
        """The full walk; returns the documents it visited."""
        self._refresh_mark = None
        dyn = self._dynamic_trials
        n_dyn = len(dyn)
        trials = self._kept(dyn)
        self._trials = trials
        self._ids.update([tt["tid"] for tt in trials])
        rows, tids, losses, open_pos = _scan(trials)
        sp.set_attr("rebuild", self._history.fold(rows, tids, losses, self._revision))
        tallies = _Tallies({})
        tallies.add_states(dyn, self._exp_key)
        tallies.add_losses(trials, 0)
        self._refresh_mark = _RefreshMark(self, n_dyn, open_pos, tallies)
        return n_dyn

    def _fold_changed(self, sp):
        """The incremental fold; returns the documents it visited, or None
        (nothing changed yet) where only the full walk is exact: another
        list or history, a list that shrank, no refresh recorded (a new or
        unpickled store), or an open trial that takes an OK loss behind
        one the last refresh held (the full walk's history rows and
        best-loss order would differ)."""
        mark = getattr(self, "_refresh_mark", None)
        dyn = self._dynamic_trials
        n_dyn = len(dyn)
        tallies = getattr(mark, "tallies", None)   # marks pickled before tallies
        if tallies is None or mark.open_ok or not mark.holds(self, n_dyn):
            return None
        prev = self._trials
        states = dict(tallies.states)
        # one read of each open document's state and result decides its fate
        ok_at, rows_at, still_open, errored = [], [], [], []
        for i, was in zip(mark.open, mark.open_states):
            t = prev[i]
            state = t["state"]
            if state != was:
                states[was] = states.get(was, 0) - 1
                states[state] = states.get(state, 0) + 1
            if state == JOB_STATE_ERROR:
                errored.append(i)
                continue
            if _ok_loss(t) is not None:
                ok_at.append(i)
                if state == JOB_STATE_DONE:
                    rows_at.append(i)
            if state != JOB_STATE_DONE and state != JOB_STATE_CANCEL:
                still_open.append(i)
        if ok_at and ok_at[0] < tallies.last_ok:
            return None
        self._refresh_mark = None
        fresh = dyn[mark.n_dyn:n_dyn]
        added = self._kept(fresh)
        trials = list(prev)
        for i in reversed(errored):
            del trials[i]
        base = len(trials)
        trials.extend(added)

        def moved(i):
            return i - bisect.bisect_left(errored, i)

        new = _Tallies(states, tallies.best, moved(tallies.last_ok))
        for i in ok_at:
            new.add_loss(_ok_loss(prev[i]), moved(i))
        new.add_states(fresh, self._exp_key)
        new.add_losses(added, base)
        add_rows, _, _, add_open = _scan(added)
        self._trials = trials
        self._ids.update([tt["tid"] for tt in added])
        rows = [prev[i] for i in rows_at] + add_rows
        sp.set_attr("rebuild", self._history.append_rows(rows, self._revision))
        open_pos = [moved(i) for i in still_open] + [base + j for j in add_open]
        self._refresh_mark = _RefreshMark(self, n_dyn, open_pos, new)
        return len(fresh) + len(mark.open)

    def _tallies(self):
        """The tallies of the last refresh where they are what the walks
        would read now, else None: the store keeps :meth:`refresh`, is not
        asynchronous (workers move states between refreshes), and is as
        that refresh left it, with nothing appended since."""
        if type(self).refresh is not Trials.refresh or self.asynchronous:
            return None
        mark = getattr(self, "_refresh_mark", None)
        tallies = getattr(mark, "tallies", None)
        n_dyn = len(self._dynamic_trials)
        if tallies is None or n_dyn != mark.n_dyn or not mark.holds(self, n_dyn):
            return None
        return tallies

    @property
    def history(self):
        """The SoA history cache consumed by the jitted algorithms."""
        self._history.maybe_rebuild(self)
        return self._history

    def assert_valid_trial(self, trial):
        if not (hasattr(trial, "keys") and hasattr(trial, "values")):
            raise InvalidTrial("trial should be dict-like", trial)
        for key in TRIAL_KEYS:
            if key not in trial:
                raise InvalidTrial(f"trial missing key {key}", trial)
        for key in TRIAL_MISC_KEYS:
            if key not in trial["misc"]:
                raise InvalidTrial(f'trial["misc"] missing key {key}', trial)
        if trial["tid"] != trial["misc"]["tid"]:
            raise InvalidTrial("tid mismatch between root and misc", trial)
        if self._exp_key is not None and trial["exp_key"] != self._exp_key:
            raise InvalidTrial(f"wrong exp_key {trial['exp_key']}", trial)
        if trial["state"] not in JOB_VALID_STATES:
            raise InvalidTrial(f"invalid state {trial['state']}", trial)
        return trial

    def _insert_trial_docs(self, docs):
        rval = [doc["tid"] for doc in docs]
        self._dynamic_trials.extend(docs)
        return rval

    def insert_trial_doc(self, doc):
        doc = SONify(self.assert_valid_trial(doc))
        return self._insert_trial_docs([doc])[0]

    def insert_trial_docs(self, docs):
        docs = [SONify(self.assert_valid_trial(doc)) for doc in docs]
        return self._insert_trial_docs(docs)

    def new_trial_ids(self, n):
        aa = len(self._ids)
        if aa:
            aa = max(self._ids) + 1
        rval = list(range(aa, aa + n))
        self._ids.update(rval)
        return rval

    def new_trial_docs(self, tids, specs, results, miscs):
        rval = []
        for tid, spec, result, misc in zip(tids, specs, results, miscs):
            doc = {
                "state": JOB_STATE_NEW,
                "tid": tid,
                "spec": spec,
                "result": result,
                "misc": misc,
                "exp_key": self._exp_key,
                "owner": None,
                "version": 0,
                "book_time": None,
                "refresh_time": None,
            }
            rval.append(doc)
        return rval

    def source_trial_docs(self, tids, specs, results, miscs, sources):
        rval = []
        for tid, spec, result, misc, source in zip(tids, specs, results, miscs, sources):
            doc = {
                "version": 0,
                "tid": tid,
                "spec": spec,
                "result": result,
                "misc": misc,
                "book_time": coarse_utcnow(),
                "refresh_time": None,
                "exp_key": source["exp_key"],
                "owner": source["owner"],
                "state": source["state"],
            }
            rval.append(doc)
        return rval

    def delete_all(self):
        self._dynamic_trials = []
        self.attachments = {}
        self._history = _TrialsHistory()
        self.refresh()

    def count_by_state_synced(self, arg, trials=None):
        """Count trials in state ``arg`` (int or sequence) among ``trials``."""
        if trials is None:
            trials = self._trials
        if arg in JOB_STATES:
            queue = [doc for doc in trials if doc["state"] == arg]
        elif hasattr(arg, "__iter__"):
            states = set(arg)
            assert states.issubset(JOB_VALID_STATES)
            queue = [doc for doc in trials if doc["state"] in states]
        else:
            raise TypeError(arg)
        return len(queue)

    def count_by_state_unsynced(self, arg):
        if self._exp_key is not None:
            exp_trials = [
                tt for tt in self._dynamic_trials if tt["exp_key"] == self._exp_key
            ]
        else:
            exp_trials = self._dynamic_trials
        return self.count_by_state_synced(arg, trials=exp_trials)

    def count_by_state_tallied(self, arg):
        """``count_by_state_unsynced(arg)`` as of the last refresh: in O(1)
        from the refresh's tallies where they hold (see the class's
        refresh-before-read contract), else by the walk."""
        tallies = self._tallies()
        if tallies is None:
            return self.count_by_state_unsynced(arg)
        return tallies.count(arg)

    def min_ok_loss(self):
        """``min`` over the OK losses (``losses()`` where ``statuses()`` is
        OK and the loss is not None) in store order, or None where there
        is none: what fmin's progress reads as the best loss.  NaN where
        the first is NaN, as ``min`` gives.  In O(1) from the last
        refresh's tallies where they hold, else by the walk."""
        tallies = self._tallies()
        if tallies is not None and tallies.best is not _UNORDERED:
            return tallies.best
        losses = [
            loss
            for loss, status in zip(self.losses(), self.statuses())
            if status == STATUS_OK and loss is not None
        ]
        return min(losses) if losses else None

    # -- results ------------------------------------------------------
    def losses(self, bandit=None):
        if bandit is None:
            return [r.get("loss") for r in self.results]
        return [bandit.loss(r, s) for r, s in zip(self.results, self.specs)]

    def statuses(self, bandit=None):
        if bandit is None:
            return [r.get("status") for r in self.results]
        return [bandit.status(r, s) for r, s in zip(self.results, self.specs)]

    def to_dataframe(self):
        """Trial history as a pandas DataFrame: one row per trial with
        tid/state/status/loss/book+refresh times plus one ``vals.<label>``
        column per hyperparameter (NaN where the label's branch was
        inactive). Beyond the reference (which leaves users to flatten
        ``trials.trials`` by hand); import is deferred so pandas stays an
        optional dependency."""
        import pandas as pd

        rows = []
        for t in self.trials:
            row = {
                "tid": t["tid"],
                "state": t["state"],
                "status": t["result"].get("status"),
                "loss": t["result"].get("loss"),
                "book_time": t.get("book_time"),
                "refresh_time": t.get("refresh_time"),
            }
            for label, vals in t["misc"]["vals"].items():
                row[f"vals.{label}"] = vals[0] if vals else np.nan
            rows.append(row)
        return pd.DataFrame(rows)

    @property
    def best_trial(self):
        """The completed trial with the lowest loss (AllTrialsFailed if none).

        Rides the SoA history cache (DONE + ok + loss-not-None, aligned
        tid/loss arrays) instead of re-walking every document — this is
        called per suggest by ATPE's featurizer."""
        self._history.maybe_rebuild(self)
        ls = self._history.losses
        usable = np.flatnonzero(~np.isnan(ls))  # -inf is a valid winner
        if not len(usable):
            raise AllTrialsFailed
        # argmin over the usable subset, mapped back — an inf sentinel
        # would tie with real +inf losses and could land on a NaN trial
        best_tid = int(
            self._history.loss_tids[usable[int(np.argmin(ls[usable]))]]
        )
        for t in self._trials:
            # tid match alone could pick a shadowing non-completed doc if
            # tids are ever duplicated — re-check the candidate filter
            if (
                t["tid"] == best_tid
                and t["state"] == JOB_STATE_DONE
                and t["result"].get("status") == STATUS_OK
                and t["result"].get("loss") is not None
            ):
                return t
        raise AllTrialsFailed  # cache/tid drift — should be unreachable

    @property
    def argmin(self):
        return spec_from_misc(self.best_trial["misc"])

    def average_best_error(self, bandit=None):
        """Mean true_loss among the statistically-best trials."""
        if bandit is None:
            results = self.results
            loss = [r["loss"] for r in results if r["status"] == STATUS_OK]
            loss_v = [
                r.get("loss_variance", 0) for r in results if r["status"] == STATUS_OK
            ]
            true_loss = [
                r.get("true_loss", r["loss"])
                for r in results
                if r["status"] == STATUS_OK
            ]
        else:
            def fmap(f):
                rval = np.asarray(
                    [
                        f(r, s)
                        for (r, s) in zip(self.results, self.specs)
                        if bandit.status(r) == STATUS_OK
                    ]
                ).astype("float")
                if not np.all(np.isfinite(rval)):
                    raise ValueError()
                return rval

            loss = fmap(bandit.loss)
            loss_v = fmap(bandit.loss_variance)
            true_loss = fmap(bandit.true_loss)
        loss3 = sorted(zip(loss, loss_v, true_loss))
        if not loss3:
            raise ValueError("empty loss vector")
        loss3 = np.asarray(loss3, dtype=float)
        if np.all(loss3[:, 1] == 0):
            best_idx = int(np.argmin(loss3[:, 0]))
            return loss3[best_idx, 2]
        cutoff = 0
        sigma = np.sqrt(loss3[0][1])
        while cutoff < len(loss3) and loss3[cutoff][0] < loss3[0][0] + sigma:
            cutoff += 1
        pmin = pmin_sampled(loss3[:cutoff, 0], loss3[:cutoff, 1])
        avg_true_loss = (pmin * loss3[:cutoff, 2]).sum()
        return avg_true_loss

    # -- driver entry -------------------------------------------------
    def fmin(
        self,
        fn,
        space,
        algo=None,
        max_evals=None,
        timeout=None,
        loss_threshold=None,
        max_queue_len=1,
        rstate=None,
        verbose=False,
        pass_expr_memo_ctrl=None,
        catch_eval_exceptions=False,
        return_argmin=True,
        show_progressbar=True,
        early_stop_fn=None,
        trials_save_file="",
        points_to_evaluate=None,
        max_speculation=None,
        retry_policy=None,
        fault_stats=None,
        search_stats=None,
        tracer=None,
    ):
        """Minimize ``fn`` over ``space`` using this store (see ``fmin``)."""
        from .fmin import fmin as _fmin  # local import: avoid circularity

        return _fmin(
            fn,
            space,
            algo=algo,
            max_evals=max_evals,
            timeout=timeout,
            loss_threshold=loss_threshold,
            trials=self,
            rstate=rstate,
            verbose=verbose,
            max_queue_len=max_queue_len,
            allow_trials_fmin=False,
            points_to_evaluate=points_to_evaluate,
            pass_expr_memo_ctrl=pass_expr_memo_ctrl,
            catch_eval_exceptions=catch_eval_exceptions,
            return_argmin=return_argmin,
            show_progressbar=show_progressbar,
            early_stop_fn=early_stop_fn,
            trials_save_file=trials_save_file,
            max_speculation=max_speculation,
            retry_policy=retry_policy,
            fault_stats=fault_stats,
            search_stats=search_stats,
            tracer=tracer,
        )


class _RefreshMark:
    """Where a store's last refresh left off: its document list and that
    list's length then (with the last document, so a list emptied and
    refilled is not taken for the same), the ``_trials`` list and history
    it made, the positions in ``_trials`` of the documents that could
    still change (:func:`_scan`'s open ones) with their states then and
    whether one holds an OK loss, the refresh's revision, and its
    :class:`_Tallies`."""

    def __init__(self, store, n_dyn, open_pos, tallies):
        self.dyn = store._dynamic_trials
        self.n_dyn = n_dyn
        self.tail = self.dyn[n_dyn - 1] if n_dyn else None
        self.trials = store._trials
        self.history = store._history
        self.open = open_pos
        self.open_states = [self.trials[i]["state"] for i in open_pos]
        # an open document holding an OK loss (``Ctrl.checkpoint``): the
        # next refresh cannot tell whether that loss changed
        self.open_ok = any(_ok_loss(self.trials[i]) is not None for i in open_pos)
        self.tallies = tallies
        self.revision = store._revision

    def holds(self, store, n_dyn):
        """Is the store still as this mark's refresh left it, but for
        documents appended and the open ones changed?"""
        return (
            store._dynamic_trials is self.dyn
            and n_dyn >= self.n_dyn
            and (not self.n_dyn or self.dyn[self.n_dyn - 1] is self.tail)
            and store._trials is self.trials
            and store._history is self.history
            and store._history._seen_revision == self.revision
        )


def loop_refresh(trials):
    """The refresh at the fmin loop's own refresh points (``FMinIter``,
    the speculative engine).  Between two of them the loop only appends
    documents and moves NEW and RUNNING ones on, so a store that keeps
    :meth:`Trials.refresh` folds just those
    (:meth:`Trials._refresh_incremental`); one that overrides it
    (``FileTrials`` replaces documents in place) runs its own."""
    if type(trials).refresh is Trials.refresh:
        trials._refresh_incremental()
    else:
        trials.refresh()


def trials_from_docs(docs, validate=True, **kwargs):
    """Construct a Trials base class instance from a list of trials documents."""
    rval = Trials(**kwargs)
    if validate:
        rval.insert_trial_docs(docs)
    else:
        rval._insert_trial_docs(docs)
    rval.refresh()
    return rval


# ---------------------------------------------------------------------
# Ctrl
# ---------------------------------------------------------------------


class Ctrl:
    """Control object passed to objectives that want runtime access."""

    info = logger.info
    warn = logger.warning
    error = logger.error
    debug = logger.debug

    def __init__(self, trials, current_trial=None):
        self.trials = trials
        self.current_trial = current_trial

    @property
    def attachments(self):
        """Attachments of the current trial."""
        return self.trials.trial_attachments(trial=self.current_trial)

    def checkpoint(self, result=None):
        """Persist a partial result mid-trial (durable backends override)."""
        assert self.current_trial in self.trials._dynamic_trials
        if result is not None:
            self.current_trial["result"] = result

    def inject_results(self, specs, results, miscs, new_tids=None):
        """Inject pre-computed trials as if they had been executed."""
        trial_count = len(specs)
        assert len(specs) == len(results) == len(miscs)
        if new_tids is None:
            new_tids = self.trials.new_trial_ids(trial_count)
        assert len(new_tids) == trial_count
        current = self.current_trial
        new_trials = self.trials.source_trial_docs(
            tids=new_tids,
            specs=specs,
            results=results,
            miscs=miscs,
            sources=[
                {
                    "exp_key": current["exp_key"],
                    "owner": current["owner"],
                    "state": JOB_STATE_DONE,
                }
            ]
            * trial_count,
        )
        return self.trials.insert_trial_docs(new_trials)


# ---------------------------------------------------------------------
# Domain
# ---------------------------------------------------------------------


class Domain:
    """Binds an objective ``fn`` to a compiled search space."""

    rec_eval_print_node_on_error = False

    def __init__(
        self,
        fn,
        expr,
        workdir=None,
        pass_expr_memo_ctrl=None,
        name=None,
        loss_target=None,
    ):
        self.fn = fn
        if pass_expr_memo_ctrl is None:
            self.pass_expr_memo_ctrl = getattr(fn, "fmin_pass_expr_memo_ctrl", False)
        else:
            self.pass_expr_memo_ctrl = pass_expr_memo_ctrl
        self.expr = as_apply(expr)
        self.space = CompiledSpace(self.expr)  # one-time space lowering
        self.params = {lb: sp.node for lb, sp in self.space.specs.items()}
        self.loss_target = loss_target
        self.name = name
        self.workdir = workdir
        self.s_new_ids = None  # reference-compat attribute
        self.cmd = ("domain_attachment", "FMinIter_Domain")

    # -- config <-> memo ----------------------------------------------
    def memo_from_config(self, config):
        memo = {}
        for label, node in self.params.items():
            if label in config:
                memo[node] = config[label]
            else:
                memo[node] = GarbageCollected
        return memo

    def evaluate(self, config, ctrl, attach_attachments=True):
        memo = self.memo_from_config(config)
        use_obj_for_literal_in_memo(self.expr, ctrl, Ctrl, memo)
        if self.pass_expr_memo_ctrl:
            rval = self.fn(expr=self.expr, memo=memo, ctrl=ctrl)
        else:
            pyll_rval = rec_eval(
                self.expr,
                memo=memo,
                print_node_on_error=self.rec_eval_print_node_on_error,
            )
            rval = self.fn(pyll_rval)

        if isinstance(rval, (float, int, np.number)):
            dict_rval = {"loss": float(rval), "status": STATUS_OK}
        else:
            dict_rval = dict(rval)
            status = dict_rval["status"]
            if status not in STATUS_STRINGS:
                raise InvalidResultStatus(dict_rval)
            if status == STATUS_OK:
                try:
                    dict_rval["loss"] = float(dict_rval["loss"])
                except (TypeError, KeyError):
                    raise InvalidLoss(dict_rval)

        if attach_attachments:
            attachments = dict_rval.pop("attachments", {})
            for key, val in attachments.items():
                ctrl.attachments[key] = val
        return dict_rval

    def evaluate_async(self, config, ctrl, attach_attachments=True):
        """Synchronous part of an async evaluation: returns (run, done)."""
        memo = self.memo_from_config(config)
        use_obj_for_literal_in_memo(self.expr, ctrl, Ctrl, memo)
        pyll_rval = rec_eval(
            self.expr,
            memo=memo,
            print_node_on_error=self.rec_eval_print_node_on_error,
        )
        return pyll_rval

    def short_str(self):
        return f"Domain{{{self.name or self.fn!r}}}"

    # -- result accessors ---------------------------------------------
    def loss(self, result, config=None):
        return result.get("loss")

    def loss_variance(self, result, config=None):
        return result.get("loss_variance", 0.0)

    def true_loss(self, result, config=None):
        try:
            return result["true_loss"]
        except KeyError:
            return self.loss(result, config=config)

    def true_loss_variance(self, config=None):
        raise NotImplementedError()

    def status(self, result, config=None):
        return result["status"]

    def new_result(self):
        return {"status": STATUS_NEW}
