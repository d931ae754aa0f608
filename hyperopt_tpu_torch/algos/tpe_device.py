"""Device-resident TPE suggest plane: the trials history lives on the card.

Reference parity: ``hyperopt_tpu/algos/tpe_device.py`` (the synchronous
single-device path).  The reference re-walks the trial documents and refits
with numpy per label per suggest; here:

- :class:`DeviceHistory` keeps, per distribution family, label-stacked
  ``[L, CAP]`` observation buffers (fit-space values), the aligned
  ``[L, CAP]`` global-row indices, and the ``[CAPT]`` loss vector as
  **device tensors**, updated in place: an append of ``k`` completed trials
  uploads O(k) scalars, never the history.  Capacities grow in power-of-two
  buckets, so full re-uploads happen O(log N) times over a run's life.
- :func:`multi_family_suggest_async` launches every distribution family
  of one suggest — γ-split (loss ranks), below/above packing,
  adaptive-Parzen fits, truncated-GMM candidate draw, O(candidates ×
  components) scoring (the CUDA pair-score kernel for continuous labels),
  per-id argmax — on the device, copies one flat array of winners and
  diagnostics towards the host without waiting, and returns a resolver
  that waits for it.  :func:`multi_study_suggest_async` does the same for
  several suggests at once, with one readback.
- :meth:`DeviceHistory.hypothetical_append` is the speculative engine's
  view of the history with the in-flight trials appended (worst-case
  loss), made without touching the live buffers.

Everything here runs on the card's suggest stream
(:func:`~hyperopt_tpu_torch.device.suggest_stream`): appends are made in
place, and stream order keeps an in-flight suggest reading the buffers as
they were when it was launched.

The γ-split semantics match ``tpe.ap_split_trials`` exactly: ranks come
from a stable sort of the (float32) loss vector, the below set is the
first ``n_below`` ranks, and chronological observation order is preserved
through the packing (stable mask sorts), which the linear-forgetting ramp
relies on.

Random draws enter the family cores as uniform streams ``[L, 2, C]``
(component pick, value draw), drawn by the caller from per-label
generators; a test can hand in the reference's own streams instead.

Under a :class:`~hyperopt_tpu_torch.parallel.sharding.DeviceMesh` (the
``mesh`` static of a continuous family) the history lives on the mesh's
lead slot and every stage runs there but the scoring: the pair score fans
out over the mesh's slots (``sharding.make_sharded_pair_score_batched``:
candidates over ``dp``, each region's components over ``sp``), quantized
labels without a bucket grid split their candidates over ``dp``, and the
argmax and the search-health reductions read the gathered scores on the
lead slot.  Reference: ``hyperopt_tpu/algos/tpe_device.py:870-910``.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
import weakref
from functools import wraps

import numpy as np
import torch

from ..device import drop_suggest_streams, on_suggest_stream, resolve_device, upload
from ..diagnostics import D_EI_TOP_K, DIAG_COLS
from ..ops import fused_kernel, kernel_build
from ..ops import gmm as gmm_ops
from ..ops import parzen as parzen_ops
from ..ops.pair_kernel import pair_score_batched
from ..ops.score import pair_params, pair_score
from ..parallel import sharding
from ..resilience.device import mark_device_error

EPS = 1e-12
_BIG = np.float32(np.finfo(np.float32).max)


# ---------------------------------------------------------------------
# Family grouping
# ---------------------------------------------------------------------

# dist name -> (log_scale, quantized); index dists handled separately
CONTINUOUS = {
    "uniform": (False, False),
    "quniform": (False, True),
    "uniformint": (False, True),
    "loguniform": (True, False),
    "qloguniform": (True, True),
    "normal": (False, False),
    "qnormal": (False, True),
    "lognormal": (True, False),
    "qlognormal": (True, True),
}


def prior_for(spec):
    """(prior_mu, prior_sigma, low, high, q) in FIT space for a continuous
    spec — mirrors the reference's per-dist posterior builders
    (``adaptive_parzen_sampler('uniform')`` etc., hyperopt/tpe.py ~L570-720).
    """
    p = spec.params
    d = spec.dist
    q = float(p.get("q", 0.0) or 0.0)
    if d in ("uniform", "quniform", "uniformint", "loguniform", "qloguniform"):
        low, high = float(p["low"]), float(p["high"])  # log-space for log dists
        return 0.5 * (low + high), high - low, low, high, q
    if d in ("normal", "qnormal", "lognormal", "qlognormal"):
        return float(p["mu"]), float(p["sigma"]), -np.inf, np.inf, q
    raise ValueError(d)


class _Family:
    """One label-stacked distribution family and its device buffers."""

    def __init__(self, key, members):
        # members: list of (label, spec, ki) in space order
        self.key = key
        self.labels = [m[0] for m in members]
        self.specs = [m[1] for m in members]
        self.kis = [m[2] for m in members]
        self.L = len(members)
        self.cap = 0
        self.obs = None  # [L, cap] f32 device, fit-space values
        self.pos = None  # [L, cap] i64 device, global history row
        self.counts_host = [0] * self.L
        self.counts = None  # [L] i64 device

        if key[0] == "cont":
            self.log_scale, self.quantized = key[1], key[2]
            pri = np.array([prior_for(s) for s in self.specs], np.float32)
            self.default_priors = pri  # [L, 5]: mu, sigma, low, high, q
            self.offsets = None
            self.upper = None
        else:
            self.log_scale = self.quantized = False
            self.offsets = np.array(
                [
                    int(s.params.get("low", 0)) if s.dist == "randint" else 0
                    for s in self.specs
                ],
                np.int64,
            )
            uppers = [int(s.upper) for s in self.specs]
            self.upper = max(uppers)
            pp = np.zeros((self.L, self.upper), np.float32)
            for i, s in enumerate(self.specs):
                if s.dist == "categorical":
                    p = np.asarray(s.params["p"], np.float32)
                    pp[i, : len(p)] = p / p.sum()
                else:
                    pp[i, : uppers[i]] = 1.0 / uppers[i]
            self.prior_p = pp  # [L, U] (zero-padded rows for smaller uppers)

    def to_fit_space(self, label_i, raw_vals):
        v = np.asarray(raw_vals, np.float64)
        if self.key[0] == "cont":
            if self.log_scale:
                return np.log(np.maximum(v, EPS)).astype(np.float32)
            return v.astype(np.float32)
        return (v - self.offsets[label_i]).astype(np.float32)

    def from_fit_space(self, label_i, best):
        spec = self.specs[label_i]
        if self.key[0] == "cont":
            v = np.asarray(best, np.float64)
            return v.astype(np.int64) if spec.is_integer else v
        return np.asarray(best, np.int64) + self.offsets[label_i]


def _scatter_drop(buf, index, vals):
    """``buf[index] = vals`` in place, dropping entries whose index lies
    outside ``buf`` (JAX's ``mode="drop"``).  ``index``: one host integer
    array per dimension of ``buf``; ``vals``: host array."""
    keep = np.ones(len(vals), bool)
    for d, ix in enumerate(index):
        keep &= (ix >= 0) & (ix < buf.shape[d])
    idx = tuple(upload(np.asarray(ix, np.int64)[keep], buf.device) for ix in index)
    v = upload(np.asarray(vals)[keep], buf.device).to(buf.dtype)
    buf.index_put_(idx, v)


def _on_stream(method):
    """Run a ``DeviceHistory`` method on its card's suggest stream."""
    @wraps(method)
    def run(self, *args, **kwargs):
        with on_suggest_stream(self.device):
            return method(self, *args, **kwargs)

    return run


class DeviceHistory:
    """Device-resident struct-of-arrays mirror of one Trials history.

    Cached per (trials, space, device, mesh) via :func:`device_history_for`;
    ``sync`` detects append-only growth (the steady state) by prefix
    comparison and uploads only the delta.  Under a ``mesh`` the buffers
    live on its lead slot (``DeviceMesh.lead_device``), where every stage
    but the sharded scoring runs.
    """

    def __init__(self, specs, device=None, mesh=None):
        self.mesh = mesh
        self.device = mesh.lead_device if mesh is not None else resolve_device(device)
        fams = {}
        for ki, (label, spec) in enumerate(specs.items()):
            if spec.dist in CONTINUOUS:
                fkey = ("cont",) + CONTINUOUS[spec.dist]
                if fkey[2]:
                    # quantized families split by boundedness so the
                    # bucket-grid scorer (bounded only) isn't disabled
                    # for quniform labels by a qnormal sharing the family
                    pm, ps, lo, hi, qq = prior_for(spec)
                    fkey = fkey + (bool(np.isfinite(lo) and np.isfinite(hi)),)
            else:
                fkey = ("idx",)
            fams.setdefault(fkey, []).append((label, spec, ki))
        self.families = {k: _Family(k, v) for k, v in fams.items()}
        self.n_labels = len(specs)

        self.capt = 0
        self.losses = None  # [CAPT] f32 device, padded +BIG
        self._n_synced = 0
        self._loss_tids = np.zeros(0, np.int64)  # synced snapshot for append check
        self._losses_synced = np.zeros(0, np.float64)
        self._seen_content_version = None
        self._synced_hist = lambda: None  # weakref to the last-synced hist
        self._tid_row = {}
        self.full_rebuilds = 0  # O(history) re-uploads, O(log N) over a run
        self._ones = None

    @_on_stream
    def keep_mask(self, mask):
        """[CAPT] bool device mask for trial_filter (all-true cached)."""
        if mask is None:
            if self._ones is None or self._ones.shape[0] != self.capt:
                self._ones = torch.ones(self.capt, dtype=torch.bool, device=self.device)
            return self._ones
        buf = np.zeros(self.capt, bool)
        buf[: len(mask)] = mask
        return self._upload(buf)

    # -- sync ----------------------------------------------------------
    @_on_stream
    def sync(self, hist):
        n = len(hist.losses)
        # O(1) steady state: _TrialsHistory bumps ``content_version`` on
        # every array commit and records the last NON-append-only commit
        # in ``last_nonappend_version``.  Version counters are only
        # comparable within ONE hist object (Trials can swap in a fresh
        # _TrialsHistory whose counter restarts at 0), so both fast paths
        # require identity; the O(N) prefix comparison is the fallback.
        same_hist = self._synced_hist() is hist
        ver = getattr(hist, "content_version", None)
        if ver is not None and same_hist and ver == self._seen_content_version:
            return
        if (
            ver is not None
            and same_hist
            and self._seen_content_version is not None
            and hist.last_nonappend_version <= self._seen_content_version
            and n >= self._n_synced
        ):
            appended = True
        else:
            appended = (
                n >= self._n_synced
                and np.array_equal(hist.loss_tids[: self._n_synced], self._loss_tids)
                # losses too: an in-place result mutation keeps the tid
                # prefix but must invalidate the device copy (equal_nan:
                # NaN losses are legitimate diverged trials, not changes)
                and np.array_equal(
                    hist.losses[: self._n_synced], self._losses_synced, equal_nan=True
                )
            )
        if not appended:
            self._rebuild(hist)
        elif n > self._n_synced:
            self._append(hist)
        self._seen_content_version = ver
        self._synced_hist = weakref.ref(hist)

    def _upload(self, arr):
        return upload(arr, self.device)

    def _rebuild(self, hist):
        self.full_rebuilds += 1
        n = len(hist.losses)
        self.capt = parzen_ops.bucket(max(n, 1))
        buf = np.full(self.capt, _BIG, np.float32)
        buf[:n] = hist.losses
        self.losses = self._upload(buf)
        # references, not copies: _TrialsHistory commits fresh arrays on
        # every content change and never mutates them in place
        self._loss_tids = hist.loss_tids
        self._losses_synced = hist.losses
        self._tid_row = {int(t): i for i, t in enumerate(self._loss_tids)}
        self._n_synced = n

        for fam in self.families.values():
            counts = [len(hist.idxs.get(label, ())) for label in fam.labels]
            fam.cap = parzen_ops.bucket(max(max(counts, default=0), 1))
            obs, pos, counts = self._host_family_arrays(fam, hist, fam.cap)
            fam.counts_host = counts
            fam.obs = self._upload(obs)
            fam.pos = self._upload(pos)
            fam.counts = self._upload(np.asarray(counts, np.int64))

    def _host_family_arrays(self, fam, hist, cap):
        """One family's (obs, pos, counts) host arrays rebuilt from ``hist``
        at capacity ``cap``: the layout of a full rebuild, shared by
        ``_rebuild`` and the hypothetical view at a bucket boundary (which
        must equal the later real rebuild, or k=1 speculation stops
        reproducing the serial trajectory exactly at power-of-two history
        sizes).  Needs ``self._tid_row`` current for ``hist``."""
        obs = np.zeros((fam.L, cap), np.float32)
        pos = np.zeros((fam.L, cap), np.int64)
        counts = []
        for i, label in enumerate(fam.labels):
            tids = hist.idxs.get(label, ())
            c = len(tids)
            if c:
                obs[i, :c] = fam.to_fit_space(i, hist.vals[label])
                pos[i, :c] = [self._tid_row[int(t)] for t in tids]
            counts.append(c)
        return obs, pos, counts

    def _append(self, hist):
        n = len(hist.losses)
        if n > self.capt:
            return self._rebuild(hist)
        # capacity growth check first (before mutating host state)
        for fam in self.families.values():
            for label in fam.labels:
                if len(hist.idxs.get(label, ())) > fam.cap:
                    return self._rebuild(hist)

        old_n = self._n_synced
        lvals = np.asarray(hist.losses[old_n:], np.float32)
        _scatter_drop(self.losses, (np.arange(old_n, n),), lvals)
        for i, t in enumerate(hist.loss_tids[old_n:]):
            self._tid_row[int(t)] = old_n + i
        self._loss_tids = hist.loss_tids  # fresh array per commit; see _rebuild
        self._losses_synced = hist.losses
        self._n_synced = n

        # in place: the old buffers are dead after an append (the
        # reference donates them to its scatter program)
        for fam in self.families.values():
            rows, cols, vals, poss = [], [], [], []
            for i, label in enumerate(fam.labels):
                tids = hist.idxs.get(label, ())
                c0, c1 = fam.counts_host[i], len(tids)
                if c1 > c0:
                    fit = fam.to_fit_space(i, np.asarray(hist.vals[label][c0:c1]))
                    rows.extend([i] * (c1 - c0))
                    cols.extend(range(c0, c1))
                    vals.extend(fit)
                    poss.extend(self._tid_row[int(t)] for t in tids[c0:c1])
                fam.counts_host[i] = c1
            if rows:
                r, c = np.asarray(rows), np.asarray(cols)
                _scatter_drop(fam.obs, (r, c), np.asarray(vals, np.float32))
                _scatter_drop(fam.pos, (r, c), np.asarray(poss, np.int64))
                fam.counts = self._upload(np.asarray(fam.counts_host, np.int64))

    @_on_stream
    def hypothetical_append(self, hist, pending_vals):
        """A one-trial-ahead VIEW of the history: the synced buffers plus
        the pending trials' observations, each with a worst-case ``+BIG``
        loss: the "lands in the above set" branch prediction of the
        speculative engine (:mod:`hyperopt_tpu_torch.pipeline`).

        A pending trial's parameters are known while its objective runs;
        only its loss is not, and the loss enters the fit only through
        γ-split membership.  ``+BIG`` ranks after every real loss (stable
        sort), so a suggest against this view with ``n_below`` for the
        grown count is exactly the suggest the serial loop makes after a
        completion that lands above.  ``pending_vals``: the trials'
        ``misc["vals"]`` dicts, in completion-row order.

        Non-destructive: the live buffers are cloned before anything is
        scattered, and this object's host state is untouched (the next
        real ``sync`` proceeds as if this was never called).  Returns
        ``(losses, fam_views, keep_mask)``; ``fam_views`` maps a family
        key to ``(obs, pos, counts)`` for the families that gained
        observations; the others read their live buffers.  Must be
        called with ``self`` synced to ``hist``.  Reference:
        ``hyperopt_tpu/algos/tpe_device.py:381-487``."""
        n0 = self._n_synced
        n1 = n0 + len(pending_vals)

        fam_extra = {}  # fam -> (rows, cols, vals, poss, new_counts)
        overflow = n1 > self.capt
        for fam in self.families.values():
            rows, cols, vals, poss = [], [], [], []
            counts = list(fam.counts_host)
            for j, pv in enumerate(pending_vals):
                for i, label in enumerate(fam.labels):
                    v = pv.get(label, ())
                    if len(v):
                        rows.append(i)
                        cols.append(counts[i])
                        vals.append(float(fam.to_fit_space(i, np.asarray(v))[0]))
                        poss.append(n0 + j)
                        counts[i] += 1
            if rows:
                fam_extra[fam] = (rows, cols, vals, poss, counts)
                if max(counts) > fam.cap:
                    overflow = True

        if overflow:
            return self._hypothetical_rebuild(hist, pending_vals, fam_extra)

        losses = self.losses.clone()
        _scatter_drop(losses, (np.arange(n0, n1),), np.full(n1 - n0, _BIG, np.float32))
        views = {}
        for fam, (rows, cols, vals, poss, counts) in fam_extra.items():
            obs, pos = fam.obs.clone(), fam.pos.clone()
            r, c = np.asarray(rows), np.asarray(cols)
            _scatter_drop(obs, (r, c), np.asarray(vals, np.float32))
            _scatter_drop(pos, (r, c), np.asarray(poss, np.int64))
            views[fam.key] = (obs, pos, self._upload(np.asarray(counts, np.int64)))
        return losses, views, self.keep_mask(None)

    def _hypothetical_rebuild(self, hist, pending_vals, fam_extra):
        """The view of :meth:`hypothetical_append` when the grown history
        would not fit the live buffers: built on the host at the grown
        bucket sizes (the shapes the later real ``_rebuild`` will use) and
        uploaded, O(history) once per power-of-two boundary."""
        n0 = self._n_synced
        n1 = n0 + len(pending_vals)
        capt = parzen_ops.bucket(max(n1, 1))
        buf = np.full(capt, _BIG, np.float32)
        buf[:n0] = hist.losses
        losses = self._upload(buf)
        views = {}
        for fam, (rows, cols, vals, poss, counts) in fam_extra.items():
            cap = parzen_ops.bucket(max(max(counts, default=0), 1))
            obs, pos, _ = self._host_family_arrays(fam, hist, cap)
            obs[rows, cols] = vals
            pos[rows, cols] = poss
            views[fam.key] = (self._upload(obs), self._upload(pos),
                              self._upload(np.asarray(counts, np.int64)))
        return losses, views, self._upload(np.ones(capt, bool))

    @_on_stream
    def load_numpy(self, families, losses):
        """Replace the device state with host arrays: ``families`` maps a
        family key to ``(obs, pos, counts)`` (``[L, CAP]``, ``[L, CAP]``,
        ``[L]``) and ``losses`` is the ``[CAPT]`` padded loss vector — the
        layout of ``hyperopt_tpu``'s ``DeviceHistory``, so two
        implementations can score one state.  The next ``sync`` rebuilds
        from its history."""
        losses = np.asarray(losses, np.float32)
        self.capt = losses.shape[0]
        self.losses = self._upload(losses)
        for key, (obs, pos, counts) in families.items():
            fam = self.families[key]
            fam.obs = self._upload(np.asarray(obs, np.float32))
            fam.pos = self._upload(np.asarray(pos, np.int64))
            fam.counts = self._upload(np.asarray(counts, np.int64))
            fam.cap = fam.obs.shape[1]
            fam.counts_host = [int(c) for c in np.asarray(counts)]
        self._synced_hist = lambda: None
        self._seen_content_version = None
        self._n_synced = -1  # no prefix matches: the next sync rebuilds


_cache = weakref.WeakKeyDictionary()


def device_history_for(trials, space, device, mesh=None):
    """The (trials, space, device, mesh)-scoped DeviceHistory, weak-keyed
    on the trials/space sides (no id()-reuse hazards, no unbounded
    growth).  ``mesh=None`` and each distinct mesh get their own mirror;
    under a mesh ``device`` is its lead slot's."""
    device = mesh.lead_device if mesh is not None else resolve_device(device)
    per_trials = _cache.get(trials)
    if per_trials is None:
        per_trials = weakref.WeakKeyDictionary()
        _cache[trials] = per_trials
    per_space = per_trials.get(space)
    if per_space is None:
        per_space = {}
        per_trials[space] = per_space
    dh = per_space.get((device, mesh))
    if dh is None:
        dh = DeviceHistory(space.specs, device=device, mesh=mesh)
        per_space[(device, mesh)] = dh
    return dh


def reset_device_state():
    """Drop every piece of device-resident suggest state this plane
    holds: the ``DeviceHistory`` mirrors (per trials/space/device/mesh),
    the per-card suggest streams and the mesh slots' streams, and the
    caching allocator's free blocks.

    Called by :class:`hyperopt_tpu_torch.resilience.device.DeviceRecovery`
    after a CUDA error.  The host-side ``_TrialsHistory`` remains the
    source of truth: the next suggest makes a new ``DeviceHistory`` and
    re-uploads from it (one full rebuild, the cost of a bucket-boundary
    rebuild).  The readback buffers are pinned per dispatch, never
    cached, so there is none to drop.  Reference:
    ``hyperopt_tpu/algos/tpe_device.py:546-563``."""
    _cache.clear()
    _warm_keys.clear()
    drop_suggest_streams()
    sharding.drop_slot_streams()
    if torch.cuda.is_initialized():
        # raises under a sticky CUDA error; the recovery logs it and
        # counts the retry's failure against its budget
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------
# Family programs
# ---------------------------------------------------------------------


def _split_pack(obs, pos, count, ranks, keep_mask, n_below, lock_center,
                lock_radius, cap_b: int, lock_fallback: bool):
    """Per-label γ-split + packing over ``[L, CAP]`` buffers.

    Returns (below[L, cap_b], nb[L], above[L, CAP], na[L]) with
    chronological order preserved inside each side (stable mask sorts)."""
    cap = obs.shape[1]
    i = torch.arange(cap, device=obs.device)
    valid = i < count[:, None]
    row = pos.clamp(0, ranks.shape[0] - 1)
    # trial_filter exclusion: filtered trials feed neither l nor g
    valid = valid & keep_mask[row]
    # soft-lock neighborhood filter (radius=inf disables).  Index labels
    # fall back to the unfiltered set when nothing matches; continuous
    # labels keep the emptied set (prior-only fit confined to the
    # narrowed bounds).
    m_lock = (obs - lock_center[:, None]).abs() <= lock_radius[:, None]
    if lock_fallback:
        m_lock = torch.where((valid & m_lock).any(dim=1, keepdim=True), m_lock, True)
    valid = valid & m_lock
    obs_rank = ranks[row]
    below_mask = valid & (obs_rank < n_below)
    above_mask = valid & ~below_mask
    perm_b = torch.sort((~below_mask).to(torch.int8), dim=1, stable=True).indices
    below = obs.gather(1, perm_b)[:, :cap_b]
    nb = below_mask.sum(dim=1)
    perm_a = torch.sort((~above_mask).to(torch.int8), dim=1, stable=True).indices
    above = obs.gather(1, perm_a)
    na = above_mask.sum(dim=1)
    return below, nb.clamp(max=cap_b), above, na


def _loss_ranks(losses, keep_mask):
    """Stable rank of every history row by loss (filtered rows rank last)."""
    masked = torch.where(keep_mask, losses, float(_BIG))
    order = torch.sort(masked, stable=True).indices
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.shape[0], device=order.device)
    return ranks


def _ei_diag(score2):
    """Per-label EI-landscape reductions over the full candidate set:
    ``(max, log-mean-exp, top-k softmax mass)`` each ``[L]``.

    Scores are sanitized first: an out-of-support candidate's
    ``log l − log g`` can be ±inf and their difference NaN, which must
    not poison the reductions (the winner argmax reads the RAW scores)."""
    C = score2.shape[1]
    s = fused_kernel.sanitize_scores(score2)
    smax = s.amax(dim=1)
    lse = torch.logsumexp(s, dim=1)
    lme = lse - math.log(C)
    topk = torch.topk(s, min(D_EI_TOP_K, C), dim=1).values
    mass = torch.exp(topk - lse[:, None]).sum(dim=1)
    return smax, lme, mass


def _sigma_diag(wb, sb, nbs, prior_sigma):
    """Below-mixture sigma-spread reductions ``[L]`` over REAL components
    (weight > 0): min and mean sigma relative to the prior sigma, and the
    fraction of real components clipped at the adaptive-Parzen floor
    ``prior_sigma / min(100, nb + 2)`` — the SIGMA_COLLAPSE signal."""
    ps = prior_sigma.clamp(min=EPS)
    mask = wb > 0
    n_comp = mask.sum(dim=1).clamp(min=1).to(torch.float32)
    floor = ps / (2.0 + nbs.to(torch.float32)).clamp(max=100.0)
    sig_min = torch.where(mask, sb, float("inf")).amin(dim=1) / ps
    sig_mean = torch.where(mask, sb, 0.0).sum(dim=1) / n_comp / ps
    floor_frac = (mask & (sb <= floor[:, None] * 1.001)).sum(dim=1) / n_comp
    return sig_min, sig_mean, floor_frac


def _argmax_winners(cands, score, k, n_cand):
    L = cands.shape[0]
    idx = torch.argmax(score.reshape(L, k, n_cand), dim=2)
    return cands.reshape(L, k, n_cand).gather(2, idx[:, :, None])[:, :, 0]


def _family_suggest_core(
    u,             # [L, 2, k*n_cand] f32 uniforms: component pick, value draw
    obs,           # [L, CAP] f32 fit-space
    pos,           # [L, CAP] i64
    counts,        # [L] i64
    losses,        # [CAPT] f32
    keep_mask,     # [CAPT] bool (trial_filter; all-true when unset)
    n_below,       # int
    prior_weight,  # float
    priors,        # [L, 5] f32: mu, sigma, low, high, q
    lock_center,   # [L] f32 (fit space; 0 when unset)
    lock_radius,   # [L] f32 (+inf when unset)
    *,
    cap_b: int,
    k: int,
    n_cand: int,
    lf: int,
    log_scale: bool,
    quantized: bool,
    n_buckets: int = 0,
    scorer: str = "pallas",
    fused_draw: bool = False,
    mesh=None,
):
    """γ-split → pack → Parzen fits → truncated-GMM draw → log l − log g →
    per-id argmax, stacked over the family's L labels.  Returns winning
    values ``[L, k]`` (fit space) and the ``[L, DIAG_COLS]`` row.

    ``mesh`` (a non-degenerate ``DeviceMesh``, whose lead slot holds the
    inputs): the unquantized pair score fans out over it
    (:func:`_sharded_pair_apply`) and quantized labels without a bucket
    grid score their candidates split over ``dp``; everything else runs
    on the lead slot as without a mesh.

    ``scorer`` (``ops.score.resolve_scorer``) picks how unquantized labels
    score: ``pallas`` through the pair-score kernel (``pair_score_batched``:
    the CUDA kernel on the card), ``xla`` through the plain ``pair_score``,
    ``exact`` through the normalized ``gmm_lpdf``, and ``fused`` through
    the fused suggest kernel (:func:`_fused_winners`), which returns only
    the winners and the EI partials.  ``fused_draw`` (fused only) moves the
    candidate draw into that kernel too: no candidate tensor is made.
    Quantized labels score by the exact CDF-bucket lpdf: ``n_buckets > 0``
    (BOUNDED families) evaluates it once per grid value ([L, B, K],
    B ≈ dozens) and gathers per candidate; unbounded ones evaluate it per
    candidate."""
    ranks = _loss_ranks(losses, keep_mask)
    below, nbs, above, nas = _split_pack(
        obs, pos, counts, ranks, keep_mask, n_below, lock_center, lock_radius,
        cap_b, lock_fallback=False,
    )
    pm, ps, lo, hi, qq = priors.unbind(dim=1)
    wb, mb, sb = parzen_ops.adaptive_parzen_normal_padded(below, nbs, prior_weight,
                                                          pm, ps, lf)
    wa, ma, sa = parzen_ops.adaptive_parzen_normal_padded(above, nas, prior_weight,
                                                          pm, ps, lf)
    if not quantized and scorer == "fused":
        params = pair_params(wb, mb, sb, wa, ma, sa)  # [L, 3, Kb+Ka]
        if fused_draw:
            u1, u2, rows = u[:, 0], u[:, 1], gmm_ops.draw_param_rows(wb, mb, sb, lo, hi)
        else:
            u1 = gmm_ops.gmm_sample(u[:, 0], u[:, 1], wb, mb, sb, lo, hi, qq, log_scale)
            u2 = rows = None
        win, (ei_max, ei_lme, ei_mass) = _fused_winners(
            u1, u2, rows, params, wb.shape[1], k=k, n_cand=n_cand, log_scale=log_scale)
    else:
        cands = gmm_ops.gmm_sample(u[:, 0], u[:, 1], wb, mb, sb, lo, hi, qq, log_scale)
        if quantized and n_buckets > 0:
            # bucket-grid scoring: the exact quantized lpdf on each label's
            # [B] value grid, gathered per candidate
            raw_lo = torch.exp(lo) if log_scale else lo  # bounds are fit-space
            qe = qq.clamp(min=EPS)
            j0 = torch.floor(raw_lo / qe) - 1.0
            grid = qe[:, None] * (j0[:, None] + torch.arange(n_buckets, device=obs.device))
            s = gmm_ops.gmm_lpdf(grid, wb, mb, sb, lo, hi, qq, log_scale, True) \
                - gmm_ops.gmm_lpdf(grid, wa, ma, sa, lo, hi, qq, log_scale, True)
            idx = (torch.round(cands / qe[:, None]) - j0[:, None]).clamp(0, n_buckets - 1)
            score = s.gather(1, idx.to(torch.int64))
        elif quantized or scorer == "exact":
            def lpdf_diff(x, wb, mb, sb, wa, ma, sa, lo, hi, qq):
                return gmm_ops.gmm_lpdf(x, wb, mb, sb, lo, hi, qq, log_scale, quantized) \
                    - gmm_ops.gmm_lpdf(x, wa, ma, sa, lo, hi, qq, log_scale, quantized)

            mix = (wb, mb, sb, wa, ma, sa, lo, hi, qq)
            if mesh is not None:
                # per-candidate work: the dp split changes no value
                score = sharding.dp_apply(mesh, lpdf_diff, cands, cands.device, mix)
            else:
                score = lpdf_diff(cands, *mix)
        else:
            # p_accept constants and the lognormal Jacobian are constant or
            # cancel in l−g, so the pair score keeps the argmax
            z = torch.log(cands.clamp(min=EPS)) if log_scale else cands
            params = pair_params(wb, mb, sb, wa, ma, sa)  # [L, 3, Kb+Ka]
            if mesh is not None:
                score = _sharded_pair_apply(mesh, z, params, wb.shape[1])
            else:
                scorer_fn = pair_score if scorer == "xla" else pair_score_batched
                score = scorer_fn(z.contiguous(), params.contiguous(), wb.shape[1])
        ei_max, ei_lme, ei_mass = _ei_diag(score)
        win = _argmax_winners(cands, score, k, n_cand)
    sig_min, sig_mean, sig_floor = _sigma_diag(wb, sb, nbs, ps)
    diag = torch.stack(
        [nbs.to(torch.float32), nas.to(torch.float32), ei_max, ei_lme, ei_mass,
         sig_min, sig_mean, sig_floor],
        dim=1,
    )  # [L, DIAG_COLS]
    return win, diag


def _sharded_pair_apply(mesh, z, params, k_below):
    """The pair score ``[L, C]`` over ``mesh``: each slot's partials launch
    (``ops.pair_kernel.pair_lse_partials``) on its ``dp`` block of
    candidates and ``sp`` block of each region, combined on the lead slot
    (``sharding.make_sharded_pair_score_batched``, which pads C and both
    regions itself).  The fit and the draw upstream ran once, on the lead
    slot, so every slot scores the single-device program's own candidates
    against its own mixtures.  Reference: ``tpe_device.py:870-910``."""
    return sharding.make_sharded_pair_score_batched(mesh)(z, params, k_below)


def _fused_winners(u1, u2, rows, params, k_below, *, k, n_cand, log_scale):
    """The fused suggest kernel (``ops.fused_kernel.fused_suggest``) and its
    EI partials combined into the ``_ei_diag`` reductions.

    ``rows`` None: ``u1`` holds ``gmm_sample``'s candidates.  Else ``u1``/
    ``u2`` are the raw uniforms and ``rows`` the below mixture's draw
    table, and the kernel draws.  Reference: ``tpe_device.py:913-955``."""
    n_top = min(D_EI_TOP_K, k * n_cand)
    draw = rows is not None
    win, _idx, seg_m, seg_s, seg_top = fused_kernel.fused_suggest(
        u1.contiguous(), u2.contiguous() if draw else None,
        rows.contiguous() if draw else None, params.contiguous(), k_below,
        k=k, n_top=n_top, log_scale=log_scale, draw_in_kernel=draw)
    return win, fused_kernel.ei_from_partials(seg_m, seg_s, seg_top, k * n_cand, n_top)


def _index_family_suggest_core(
    u,             # [L, 2, k*n_cand] f32 (row 0 is the category pick)
    obs,           # [L, CAP] f32 (category indices)
    pos,           # [L, CAP] i64
    counts,        # [L] i64
    losses,        # [CAPT] f32
    keep_mask,     # [CAPT] bool
    n_below,       # int
    prior_weight,  # float
    prior_p,       # [L, U] f32 (zero-padded rows)
    lock_center,   # [L] f32
    lock_radius,   # [L] f32
    *,
    cap_b: int,
    upper: int,
    k: int,
    n_cand: int,
    lf: int,
):
    """Index-label (randint/categorical) family."""
    ranks = _loss_ranks(losses, keep_mask)
    below, nbs, above, nas = _split_pack(
        obs, pos, counts, ranks, keep_mask, n_below, lock_center, lock_radius,
        cap_b, lock_fallback=True,
    )
    pb = gmm_ops.categorical_posterior(below, nbs, prior_p, prior_weight, upper, lf)
    pa = gmm_ops.categorical_posterior(above, nas, prior_p, prior_weight, upper, lf)
    # zero-prior padding slots must stay zero-probability
    pb = torch.where(prior_p > 0, pb, 0.0)
    pa = torch.where(prior_p > 0, pa, 0.0)
    cands = gmm_ops.categorical_sample(u[:, 0], pb)
    score = gmm_ops.categorical_lpdf(cands, pb) - gmm_ops.categorical_lpdf(cands, pa)
    # discrete-exhaustion signals: which categories the VALID observation
    # set covers (invalid slots scatter weight 0)
    iv = torch.arange(obs.shape[1], device=obs.device)
    cat = obs.to(torch.int64).clamp(0, upper - 1)
    present = torch.zeros(obs.shape[0], upper, device=obs.device).scatter_add_(
        1, cat, (iv < counts[:, None]).to(torch.float32)
    ) > 0
    ei_max, ei_lme, ei_mass = _ei_diag(score)
    win = _argmax_winners(cands, score, k, n_cand)
    # duplicate-argmax fraction: how many of the k winners re-draw an
    # already-observed category
    dup_frac = present.to(torch.float32).gather(1, win.clamp(0, upper - 1)).mean(dim=1)
    diag = torch.stack(
        [nbs.to(torch.float32), nas.to(torch.float32), ei_max, ei_lme, ei_mass,
         present.sum(dim=1).to(torch.float32), dup_frac,
         (prior_p > 0).sum(dim=1).to(torch.float32)],
        dim=1,
    )  # [L, DIAG_COLS]
    return win, diag


def _multi_sig(requests):
    """The static signature of one request list (kinds and statics)."""
    return tuple((kind, tuple(sorted(st.items()))) for kind, _, st in requests)


def _arg_shape(a):
    """``(shape, dtype)`` of one family-core argument: a tensor's shape and
    dtype name (``float32``, ``int64``, ``bool``), or ``((), "py:int")``
    / ``((), "py:float")`` for the Python scalars (``n_below``, the prior
    weight)."""
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), str(a.dtype).replace("torch.", "")
    return (), "py:" + type(a).__name__


def args_shapes(args_list):
    """((shape, dtype) per arg) per family — how the compile observers,
    the compile ledger (:mod:`hyperopt_tpu_torch.compile_ledger`) and the
    warm-program set name a program's inputs."""
    return tuple(tuple(_arg_shape(a) for a in args) for args in args_list)


def program_key(requests):
    """The warm-set identity of one request list: its static signature
    and its arguments' shapes and dtypes."""
    return _multi_sig(requests), args_shapes([args for _, args, _ in requests])


# The compile plane.  The port traces nothing, so its counterpart of the
# reference's XLA retrace is a *compile event*: the first dispatch in the
# process of a program key (:func:`program_key`).  That dispatch pays what
# a new program costs here: the caching allocator growing to the new
# shapes, the lazy load of the library kernels it reaches, and, the first
# time a hand-written kernel is used, the nvcc build of its library
# (``ops/kernel_build.py``).  ``_warm_keys`` holds the keys this process
# has dispatched; ``reset_device_state`` clears it with the allocator's
# cache.  ``_trace_observers`` fire on the launching thread after each
# compile event's launches, with ``(sig, shapes, launch_s)``.  Reference:
# ``hyperopt_tpu/algos/tpe_device.py:1054-1126``.
_trace_observers = []
_warm_keys = set()

# Marks this thread's dispatches as off the request path (the warmup
# replay, the cold-containment dispatch): the service's compile observer
# keeps them out of the request-cold attribution.
_bg_tls = threading.local()


@contextlib.contextmanager
def background_compiles():
    """Mark this thread's dispatches as background (off the request path)
    for the compile observers."""
    prev = getattr(_bg_tls, "active", False)
    _bg_tls.active = True
    try:
        yield
    finally:
        _bg_tls.active = prev


def in_background_compiles() -> bool:
    return bool(getattr(_bg_tls, "active", False))


def is_warm(requests) -> bool:
    """Has this process already dispatched the program ``requests`` would
    launch?  False means the next dispatch is a compile event."""
    return program_key(requests) in _warm_keys


def fused_is_warm(groups) -> bool:
    """:func:`is_warm` for the batch of ``groups`` that
    :func:`multi_study_suggest_async` would launch (canonical order
    first)."""
    order = canonical_group_order(groups)
    return is_warm([r for i in order for r in groups[i]])


def compile_key(sig, shapes):
    """``(trial_count_bucket, families)`` of one compile event: the
    ``[CAPT]`` losses buffer's power-of-two capacity (argument 4 of every
    family core) and the ``+``-joined family kinds.  The shared
    attribution key of the service's compile metric and the compile
    ledger.  Reference: ``hyperopt_tpu/algos/tpe_device.py:1163``."""
    capt = 0
    if shapes and len(shapes[0]) > 4 and len(shapes[0][4][0]) == 1:
        capt = int(shapes[0][4][0][0])
    families = "+".join(kind for kind, _ in sig) or "none"
    return capt, families


# Observer hook (the chaos harness's device-error site, ``resilience.
# chaos``, and the roofline profiler, ``hyperopt_tpu_torch.profiling``).
# Empty by default: the only overhead is a truthiness check.  Each
# observer fires on the launching thread once per dispatch with the raw
# request list, before any launch; an exception it raises fails the
# dispatch.  An observer that RETURNS a callable gets it invoked when that
# dispatch's readback resolves, with a timing event ``{n_requests,
# compiled, launch_s, wait_s, readback_s, device_s, out_bytes}`` (or
# ``{error: True, n_requests, compiled}`` when the readback fails).  A
# dispatch whose resolver is never called (a discarded speculation) fires
# no completion.  Reference: ``hyperopt_tpu/algos/tpe_device.py:1038-1053``
# (fired at ``:1289-1296``, completed at ``:1325-1370``).
_suggest_observers = []


def _start_readback(flat_dev):
    """The flat result on its way to the host: ``(host tensor, event)``.
    On the card a copy into pinned memory that does not wait, and an event
    recorded after it on the current stream (the one wait is the
    resolver's); on the CPU the tensor itself and no event."""
    if not flat_dev.is_cuda:
        return flat_dev, None
    host = torch.empty(flat_dev.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(flat_dev, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def multi_family_suggest_async(requests):
    """Launch every family of one suggest on the card's suggest stream and
    start the one flat readback, without waiting for either.

    ``requests``: list of ``(kind, args, statics)`` with kind "cont" or
    "idx".  Returns a zero-argument resolver: it waits for the readback
    (an event recorded after the copy into pinned host memory), splits
    the flat array and returns the per-family ``[L, k]`` fit-space
    winners as numpy; the ``[L, DIAG_COLS]`` search-health rows ride as
    its ``.diag``.  (Index winners ride the f32 concat exactly: category
    indices are tiny integers, far inside f32's 2^24 exact-integer
    range.)  Safe against later history appends: they go on the same
    stream, after this suggest's reads.

    A failure of a launch, or of the readback's wait (where the card
    reports a kernel's fault), raises tagged by
    :func:`~hyperopt_tpu_torch.resilience.device.mark_device_error`, so
    the device recovery sees it whatever its type.

    The completion event's timings (see ``_suggest_observers``):
    ``launch_s`` is the host time of the launches, ``wait_s`` the host
    time between the last launch and the resolver's call, ``readback_s``
    the resolver's wait and copy.  ``device_s`` on the card is the time
    between two CUDA events on the suggest stream, recorded before the
    first launch and after the last one: the card's span of the dispatch,
    which also counts the gaps where the card waits for the host's next
    launch.  On the CPU it is the reference's host-observed figure
    (launch to readback when the resolver follows at once, else launch
    plus readback), so CPU runs of both packages compare like with like.
    Reference: ``hyperopt_tpu/algos/tpe_device.py:1271-1386``."""
    done_cbs = None
    if _suggest_observers:
        for obs in list(_suggest_observers):
            cb = obs(requests)
            if callable(cb):
                if done_cbs is None:
                    done_cbs = []
                done_cbs.append(cb)
    # one dispatch has one mesh: studies prepared under different meshes
    # are batched per mesh (the service refuses such a study at create)
    meshes = []
    for _, _, st in requests:
        m = st.get("mesh")
        if m is not None and m not in meshes:
            meshes.append(m)
    if len(meshes) > 1:
        raise ValueError(
            f"cannot fuse requests with {len(meshes)} different device meshes "
            f"into one dispatch; batch per mesh instead")
    dev = requests[0][1][1].device  # every request's obs lies on one device
    timed = done_cbs is not None and dev.type == "cuda"
    n_loaded = kernel_build.n_loaded()
    key = program_key(requests)
    cold = key not in _warm_keys
    t_launch0 = time.perf_counter()
    try:
        with on_suggest_stream(dev):
            if timed:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            outs = [
                (_family_suggest_core if kind == "cont" else _index_family_suggest_core)(
                    *args, **st
                )
                for kind, args, st in requests
            ]
            flat_dev = torch.cat(
                [part.to(torch.float32).reshape(-1) for win, diag in outs
                 for part in (win, diag)]
            )
            if timed:
                ev1.record()
            host, done = _start_readback(flat_dev)
    except Exception as e:
        raise mark_device_error(e)
    t_launch1 = time.perf_counter()
    if cold:
        _warm_keys.add(key)
        for obs in list(_trace_observers):
            obs(key[0], key[1], t_launch1 - t_launch0)
    # a dispatch that loaded (at first use, built) a kernel library timed
    # that too: the profiler keeps it out of its steady-state means
    compiled = kernel_build.n_loaded() != n_loaded
    shapes = [(win.shape[0], st["k"]) for (win, _), (_, _, st) in zip(outs, requests)]

    def resolve():
        t_read0 = time.perf_counter()
        try:
            if done is not None:
                done.synchronize()  # the one wait for the card
            flat = host.numpy()
        except Exception as e:
            if done_cbs is not None:
                # bounded consumers (the profiler capture's dispatch
                # budget) must see the failed dispatch too
                event = {"error": True, "n_requests": len(requests), "compiled": compiled}
                for cb in done_cbs:
                    try:
                        cb(event)
                    except Exception:
                        pass
            raise mark_device_error(e)
        if done_cbs is not None:
            t_read1 = time.perf_counter()
            wait_s = max(t_read0 - t_launch1, 0.0)
            if timed:
                device_s = ev0.elapsed_time(ev1) * 1e-3
            else:
                device_s = ((t_read1 - t_launch0) if wait_s < 0.005
                            else (t_launch1 - t_launch0) + (t_read1 - t_read0))
            event = {
                "n_requests": len(requests),
                "compiled": compiled,
                "launch_s": t_launch1 - t_launch0,
                "wait_s": wait_s,
                "readback_s": t_read1 - t_read0,
                "device_s": device_s,
                "out_bytes": int(flat.nbytes),
            }
            for cb in done_cbs:
                cb(event)  # observer callbacks must not raise
        wins, diags, off = [], [], 0
        for L, k in shapes:
            wins.append(flat[off: off + L * k].reshape(L, k))
            off += L * k
            diags.append(flat[off: off + L * DIAG_COLS].reshape(L, DIAG_COLS))
            off += L * DIAG_COLS
        resolve.diag = diags
        return wins

    return resolve


def multi_family_suggest(requests):
    """:func:`multi_family_suggest_async`, resolved: ``(winners, diags)``,
    per family ``[L, k]`` fit-space winners and ``[L, DIAG_COLS]`` rows."""
    resolve = multi_family_suggest_async(requests)
    wins = resolve()
    return wins, resolve.diag


def canonical_group_order(groups):
    """The order :func:`multi_study_suggest_async` concatenates groups in:
    sorted by the repr of each group's signature and argument shapes, as
    the reference orders them (``tpe_device.py:1139-1154``) so that one
    composition of studies always gives one request order."""
    def canon_key(g):
        return repr((
            _multi_sig(g),
            tuple(tuple(tuple(np.shape(a)) for a in args) for _, args, _ in g),
        ))

    return sorted(range(len(groups)), key=lambda i: canon_key(groups[i]))


def multi_study_suggest_async(groups):
    """Several suggests' request lists (each what one
    :func:`multi_family_suggest_async` call takes, from any studies on
    one card) launched back to back, in :func:`canonical_group_order`,
    with ONE flat readback.  Returns one zero-argument resolver per group,
    in the order of ``groups``; each yields that group's winners and
    carries its diag rows as ``.diag``.  The wait happens once, on
    whichever resolver is called first.  Reference:
    ``hyperopt_tpu/algos/tpe_device.py:1389-1441``."""
    order = canonical_group_order(groups)
    resolve_all = multi_family_suggest_async([r for i in order for r in groups[i]])
    cell = {}

    def outs():
        if "outs" not in cell:
            cell["outs"] = resolve_all()
        return cell["outs"]

    spans, off = [None] * len(groups), 0
    for i in order:
        spans[i] = (off, off + len(groups[i]))
        off += len(groups[i])

    def group_resolver(lo, hi):
        def resolve_group():
            wins = outs()[lo:hi]
            resolve_group.diag = resolve_all.diag[lo:hi]
            return wins

        return resolve_group

    return [group_resolver(lo, hi) for lo, hi in spans]
