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
"""

from __future__ import annotations

import math
import weakref
from functools import wraps

import numpy as np
import torch

from ..device import on_suggest_stream, resolve_device, upload
from ..diagnostics import D_EI_TOP_K, DIAG_COLS
from ..ops import fused_kernel
from ..ops import gmm as gmm_ops
from ..ops import parzen as parzen_ops
from ..ops.pair_kernel import pair_score_batched
from ..ops.score import pair_params, pair_score

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

    Cached per (trials, space, device) via :func:`device_history_for`;
    ``sync`` detects append-only growth (the steady state) by prefix
    comparison and uploads only the delta.
    """

    def __init__(self, specs, device=None):
        self.device = resolve_device(device)
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


def device_history_for(trials, space, device):
    """The (trials, space, device)-scoped DeviceHistory, weak-keyed on the
    trials/space sides (no id()-reuse hazards, no unbounded growth)."""
    device = resolve_device(device)
    per_trials = _cache.get(trials)
    if per_trials is None:
        per_trials = weakref.WeakKeyDictionary()
        _cache[trials] = per_trials
    per_space = per_trials.get(space)
    if per_space is None:
        per_space = {}
        per_trials[space] = per_space
    dh = per_space.get(device)
    if dh is None:
        dh = DeviceHistory(space.specs, device=device)
        per_space[device] = dh
    return dh


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
):
    """γ-split → pack → Parzen fits → truncated-GMM draw → log l − log g →
    per-id argmax, stacked over the family's L labels.  Returns winning
    values ``[L, k]`` (fit space) and the ``[L, DIAG_COLS]`` row.

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
            score = gmm_ops.gmm_lpdf(cands, wb, mb, sb, lo, hi, qq, log_scale, quantized) \
                - gmm_ops.gmm_lpdf(cands, wa, ma, sa, lo, hi, qq, log_scale, quantized)
        else:
            # p_accept constants and the lognormal Jacobian are constant or
            # cancel in l−g, so the pair score keeps the argmax
            z = torch.log(cands.clamp(min=EPS)) if log_scale else cands
            params = pair_params(wb, mb, sb, wa, ma, sa)  # [L, 3, Kb+Ka]
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
    stream, after this suggest's reads.  Reference:
    ``hyperopt_tpu/algos/tpe_device.py:1271-1386``."""
    dev = requests[0][1][1].device  # every request's obs lies on one device
    with on_suggest_stream(dev):
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
        if flat_dev.is_cuda:
            host = torch.empty(flat_dev.shape, dtype=torch.float32, pin_memory=True)
            host.copy_(flat_dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = flat_dev, None
    shapes = [(win.shape[0], st["k"]) for (win, _), (_, _, st) in zip(outs, requests)]

    def resolve():
        if done is not None:
            done.synchronize()  # the one wait for the card
        flat = host.numpy()
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
