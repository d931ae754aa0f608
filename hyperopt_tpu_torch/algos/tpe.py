"""Tree-structured Parzen Estimator.

Reference parity (SURVEY.md §2 #11): ``hyperopt/tpe.py`` —
``adaptive_parzen_normal`` (~L40-200), ``GMM1``/``GMM1_lpdf``/``LGMM1``/
``LGMM1_lpdf`` + q-variants (~L200-520), categorical posterior (~L520-570),
per-dist posterior builders (~L570-720), ``ap_split_trials`` γ-quantile
split (~L720-770), ``suggest(new_ids, domain, trials, seed, prior_weight,
n_startup_jobs, n_EI_candidates, gamma, linear_forgetting, verbose)``
(~L890-1000).

Each label's posterior step — Parzen fit of l(x) and g(x), candidate draw
from l(x), log l − log g scoring, argmax — runs on the device over the
device-resident history (``tpe_device``), one label-stacked pass per
distribution family, with the O(candidates × history) pair score in a
hand-written CUDA kernel.  The scorer tier (``ops.score.resolve_scorer``:
``pallas`` unless ``HYPEROPT_TPU_SCORER`` pins another;
``HYPEROPT_TPU_FUSED_DRAW`` for the fused tier's in-kernel draw) is
resolved once per suggest, and each suggest publishes its search-health
snapshot (``diagnostics.last_suggest_diag``).

:func:`suggest_async` launches the same suggest on the card's suggest
stream and returns a resolver (the speculative engine's dispatch,
optionally fit with in-flight trials assumed to land above the
γ-quantile); :func:`suggest_prepare` builds the request list for a
batched dispatch of several studies
(``tpe_device.multi_study_suggest_async``).

``mesh=`` (a :class:`~hyperopt_tpu_torch.parallel.sharding.DeviceMesh`
or ``"auto"``/``"off"``/``"DPxSP"``) shards the O(candidates × history)
scoring over several devices (:mod:`..parallel.sharding`): candidates
over ``dp``, mixture components over ``sp``, each shard's step the
pair-score kernel's partials launch; the suggestions are those of the
single-device program at the same seeds, up to near-ties.  A degenerate
mesh (one device, ``"off"``) is the single-device program bit for bit.

Config is the reference's *partial-as-config* pattern:
``functools.partial(tpe.suggest, gamma=0.3, n_EI_candidates=1000)``.
Every entry point here runs on the CUDA card unless ``device="cpu"`` is
passed (or a mesh whose devices are the CPU).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import diagnostics as sdiag
from .. import tracing
from ..base import miscs_update_idxs_vals
from ..device import on_suggest_stream, resolve_device, upload
from ..ops import gmm as gmm_ops
from ..ops import parzen as parzen_ops
from ..ops.pair_kernel import pair_score_single
from ..ops.score import (PAIR_CHUNK, pair_params, pair_score, resolve_fused_draw,
                         resolve_scorer)
from ..parallel.sharding import resolve_mesh_device
from ..vectorize import branch_activity, idxs_vals_from_batch
from . import rand

logger = logging.getLogger(__name__)

# -- defaults: module-level, overridable via functools.partial (the
#    reference's public config surface)
_default_prior_weight = 1.0
_default_n_startup_jobs = 20
_default_n_EI_candidates = 24
_default_gamma = 0.25
_default_linear_forgetting = 25

EPS = 1e-12


# ---------------------------------------------------------------------
# Reference-compatible numpy-facing wrappers (public API + test surface)
# ---------------------------------------------------------------------


def linear_forgetting_weights(N, LF):
    """Chronological ramp weights (oldest N−LF ramp from 1/N to 1)."""
    assert N >= 0
    assert LF > 0
    if N == 0:
        return np.asarray([])
    if N < LF:
        return np.ones(N)
    ramp = np.linspace(1.0 / N, 1.0, num=N - LF)
    return np.concatenate([ramp, np.ones(LF)])


def _row(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)[None]


def adaptive_parzen_normal(
    mus, prior_weight, prior_mu, prior_sigma, LF=_default_linear_forgetting,
    device=None,
):
    """Fit the adaptive Parzen mixture (numpy in/out).

    Returns (weights, mus, sigmas) sorted by mu with the prior inserted —
    the reference's contract."""
    dev = resolve_device(device)
    obs = np.asarray(mus, dtype=np.float64)
    if obs.ndim != 1:
        raise TypeError("mus must be a vector", mus)
    n = len(obs)
    buf = np.zeros(parzen_ops.bucket(n), dtype=np.float32)
    buf[:n] = obs
    w, m, s = parzen_ops.adaptive_parzen_normal_padded(
        _row(buf, dev),
        torch.tensor([n], device=dev),
        float(np.float32(prior_weight)),
        _row([prior_mu], dev)[0],
        _row([prior_sigma], dev)[0],
        int(LF) if LF else 0,
    )
    k = n + 1
    return tuple(t[0, :k].cpu().numpy() for t in (w, m, s))


def _generator(rng, device):
    """A ``torch.Generator`` on ``device`` from a seed, a numpy Generator
    (one draw from it) or None (fresh entropy)."""
    if rng is None:
        rng = np.random.default_rng()
    if isinstance(rng, np.random.Generator):
        rng = int(rng.integers(2 ** 31 - 1))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng))
    return gen


def _bounds(low, high, device):
    lo = -np.inf if low is None else float(low)
    hi = np.inf if high is None else float(high)
    return _row([lo], device)[0], _row([hi], device)[0]


def _gmm1_sample(weights, mus, sigmas, low, high, q, rng, size, log_scale, device):
    dev = resolve_device(device)
    w, m, s = (_row(a, dev) for a in (weights, mus, sigmas))
    n = int(np.prod(size)) if size != () else 1
    lo, hi = _bounds(low, high, dev)
    gen = _generator(rng, dev)
    u = torch.rand((2, 1, n), generator=gen, device=dev)
    x = gmm_ops.gmm_sample(u[0], u[1], w, m, s, lo, hi, _row([q or 0.0], dev)[0],
                           log_scale)
    x = x[0].cpu().numpy().astype(np.float64)
    return x.reshape(size) if size != () else float(x[0])


def _gmm1_lpdf(samples, weights, mus, sigmas, low, high, q, log_scale, device):
    dev = resolve_device(device)
    x = np.atleast_1d(np.asarray(samples, dtype=np.float32)).ravel()
    w, m, s = (_row(a, dev) for a in (weights, mus, sigmas))
    lo, hi = _bounds(low, high, dev)
    ll = gmm_ops.gmm_lpdf(_row(x, dev), w, m, s, lo, hi, _row([q or 0.0], dev)[0],
                          log_scale, q is not None)
    return ll[0].cpu().numpy().astype(np.float64).reshape(np.shape(samples))


def GMM1(weights, mus, sigmas, low=None, high=None, q=None, rng=None, size=(),
         device=None):
    """Sample from the truncated 1-D GMM (reference signature)."""
    return _gmm1_sample(weights, mus, sigmas, low, high, q, rng, size, False, device)


def GMM1_lpdf(samples, weights, mus, sigmas, low=None, high=None, q=None,
              device=None):
    """Log-density under the truncated GMM (reference signature)."""
    return _gmm1_lpdf(samples, weights, mus, sigmas, low, high, q, False, device)


def LGMM1(weights, mus, sigmas, low=None, high=None, q=None, rng=None, size=(),
          device=None):
    """Sample from the truncated 1-D log-GMM (bounds in log space)."""
    return _gmm1_sample(weights, mus, sigmas, low, high, q, rng, size, True, device)


def LGMM1_lpdf(samples, weights, mus, sigmas, low=None, high=None, q=None,
               device=None):
    """Log-density under the truncated log-GMM (reference signature)."""
    return _gmm1_lpdf(samples, weights, mus, sigmas, low, high, q, True, device)


# ---------------------------------------------------------------------
# γ-quantile split
# ---------------------------------------------------------------------


def ap_split_trials(loss_tids, losses, gamma, gamma_cap=_default_linear_forgetting):
    """Split completed-trial ids into (below, above) the γ-quantile.

    ``n_below = min(ceil(γ·√N), gamma_cap)`` — the reference's rule
    (``hyperopt/tpe.py — ap_split_trials`` ~L720-770).
    """
    losses = np.asarray(losses, dtype=np.float64)
    n = len(losses)
    n_below = int(np.ceil(gamma * np.sqrt(n)))
    if gamma_cap is not None:
        n_below = min(n_below, int(gamma_cap))
    order = np.argsort(losses, kind="stable")
    below = frozenset(int(t) for t in np.asarray(loss_tids)[order[:n_below]])
    return below


# ---------------------------------------------------------------------
# suggest
# ---------------------------------------------------------------------


def _label_uniforms(seed, n_labels, n, device):
    """``[n_labels, 2, n]`` f32 uniforms: per label, the component-pick and
    value-draw streams, from that label's own ``torch.Generator`` on
    ``device``.  Label ``i``'s generator is seeded from child ``i`` of
    ``np.random.SeedSequence(seed)``, so a label's stream depends on
    ``(seed, label index)`` alone."""
    out = torch.empty((n_labels, 2, n), dtype=torch.float32, device=device)
    for i, child in enumerate(np.random.SeedSequence(int(seed)).spawn(n_labels)):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(child.generate_state(1, np.uint32)[0]))
        out[i] = torch.rand((2, n), generator=gen, device=device)
    return out


def _continuous_best_core(
    u_comp,        # [k*n_cand] f32 uniforms: component pick
    u_val,         # [k*n_cand] f32 uniforms: value draw
    below,         # [CAP_B] f32 fit-space observations (padded)
    n_below,       # int
    above,         # [CAP_A] f32
    n_above,       # int
    prior_weight,
    prior_mu,
    prior_sigma,
    low,
    high,
    q,
    k: int,
    n_cand: int,
    lf: int,
    log_scale: bool,
    quantized: bool,
):
    """One label's fit, draw, score and argmax: the ``[k]`` best values.

    Reference: ``hyperopt_tpu/algos/tpe.py`` ``_continuous_best_core``,
    which takes a PRNG key; here the two uniform streams come in, as for
    ``gmm_sample``.  Unquantized labels score through the single-label
    pair-score kernel (``pair_score_single``) unless the tier is ``xla``
    (the plain ``pair_score``) or ``exact`` (the normalized lpdf).  The
    device is the one ``below`` lies on."""
    dev = below.device

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1)

    pm, ps = vec(prior_mu), vec(prior_sigma)
    lo, hi, qq = vec(low), vec(high), vec(q)
    wb, mb, sb = parzen_ops.adaptive_parzen_normal_padded(
        below[None], torch.as_tensor([int(n_below)], device=dev), float(prior_weight),
        pm, ps, lf)
    wa, ma, sa = parzen_ops.adaptive_parzen_normal_padded(
        above[None], torch.as_tensor([int(n_above)], device=dev), float(prior_weight),
        pm, ps, lf)
    cand = gmm_ops.gmm_sample(u_comp[None], u_val[None], wb, mb, sb, lo, hi, qq, log_scale)
    scorer = resolve_scorer()
    if quantized or scorer == "exact":
        score = (gmm_ops.gmm_lpdf(cand, wb, mb, sb, lo, hi, qq, log_scale, quantized)
                 - gmm_ops.gmm_lpdf(cand, wa, ma, sa, lo, hi, qq, log_scale, quantized))[0]
    else:
        z = torch.log(cand.clamp(min=EPS)) if log_scale else cand
        params = pair_params(wb, mb, sb, wa, ma, sa)
        if scorer == "xla":
            score = pair_score(z, params, wb.shape[1])[0]
        else:
            score = pair_score_single(z[0].contiguous(), params[0].contiguous(), wb.shape[1])
    idx = torch.argmax(score.reshape(k, n_cand), dim=1)
    return cand[0].reshape(k, n_cand).gather(1, idx[:, None])[:, 0]


# bounded-quantized families with at most this many grid values score on
# the bucket grid (one exact lpdf per DISTINCT value, gathered per
# candidate) instead of per candidate — see tpe_device n_buckets
_MAX_GRID_BUCKETS = 4096


def _family_bucket_count(fam, n_candidates):
    """Distinct-value count for a bounded quantized family (the max over
    its labels, +3 margin for grid-edge rounding), or 0 when any label is
    unbounded, the grid exceeds _MAX_GRID_BUCKETS, or it is not smaller
    than the candidate count (no saving).

    Computed from the family's DEFAULT priors, never lock-narrowed ones,
    so it stays fixed across suggests.  An over-wide grid is always safe —
    ``j0``/bounds place and mask it."""
    priors = fam.default_priors
    n_max = 0
    for i in range(fam.L):
        lo, hi, q = float(priors[i, 2]), float(priors[i, 3]), float(priors[i, 4])
        if not (np.isfinite(lo) and np.isfinite(hi)) or q <= 0:
            return 0
        if fam.log_scale:
            lo, hi = np.exp(lo), np.exp(hi)
        n = int(np.ceil((hi - lo) / q)) + 3
        if n > _MAX_GRID_BUCKETS:
            return 0
        n_max = max(n_max, n)
    if n_max >= n_candidates:
        return 0  # grid would cost more than per-candidate scoring
    return n_max


def _emit_docs(new_ids, domain, trials, chosen_vals, k):
    """Branch activity (DNF over chosen choice values) + trial docs."""
    specs = domain.space.specs
    active = branch_activity(specs, chosen_vals, k)
    idxs, vals = idxs_vals_from_batch(new_ids, chosen_vals, active, specs)
    miscs = [
        {"tid": tid, "cmd": domain.cmd, "workdir": domain.workdir, "idxs": {}, "vals": {}}
        for tid in new_ids
    ]
    miscs_update_idxs_vals(miscs, idxs, vals)
    results = [domain.new_result() for _ in new_ids]
    return trials.new_trial_docs(new_ids, [None] * k, results, miscs)


def _suggest_device(
    new_ids,
    domain,
    trials,
    hist,
    seed,
    prior_weight,
    n_EI_candidates,
    gamma,
    linear_forgetting,
    param_locks,
    trial_filter,
    device,
    defer=False,
    pending=None,
    prepare=False,
    mesh=None,
):
    """The production suggest path: device-resident history, one
    label-stacked pass per distribution family, O(k) host↔device traffic
    per call and one readback (see :mod:`.tpe_device`).  Everything it
    launches goes on the card's suggest stream.

    ``prepare=True`` builds the request list without launching it and
    returns ``(requests, finish)``: ``finish(outs, diag=None)`` turns the
    per-family winners into trial docs (the hook of
    ``tpe_device.multi_study_suggest_async``).  ``defer=True`` launches
    the families and returns a zero-argument resolver of the docs instead
    of waiting for the readback.

    ``pending`` (in-flight trials' ``misc["vals"]`` dicts, in completion
    order) fits against the hypothetical history in which each of them
    completed with a worst-case loss (``DeviceHistory
    .hypothetical_append``): their parameters join g(x), ``n_below`` is
    computed for the grown count, and when a pending result does land in
    the above set the suggestion equals the post-completion serial one
    exactly.  Incompatible with ``trial_filter``, which indexes the real
    history.

    ``mesh`` (a resolved, non-degenerate ``DeviceMesh``; ``device`` is its
    lead slot): the same path, the history on the lead slot and the
    scoring sharded over the mesh; the tier is the sharded pair scorer,
    so ``HYPEROPT_TPU_SCORER`` does not apply.
    Reference: ``hyperopt_tpu/algos/tpe.py:619-846``."""
    from . import tpe_device as td

    new_ids = list(new_ids)
    k = len(new_ids)
    lf = int(linear_forgetting) if linear_forgetting else 0
    n_cand = int(n_EI_candidates)

    if pending and trial_filter is not None:
        raise ValueError("pending speculation is incompatible with trial_filter")
    dh = td.device_history_for(trials, domain.space, device, mesh=mesh)
    dev = dh.device
    with on_suggest_stream(dev):
        with tracing.span("suggest.history") as sp:
            sp.set_attr("n_new_rows", dh.sync(hist))
        with tracing.span("suggest.build", n_families=len(dh.families), k=k, n_cand=n_cand):
            mask = None
            if trial_filter is not None:
                mask = trial_filter(hist) if callable(trial_filter) else trial_filter
                mask = np.asarray(mask, dtype=bool)
                if mask.shape != hist.loss_tids.shape:
                    raise ValueError(
                        f"trial_filter mask shape {mask.shape} != history "
                        f"{hist.loss_tids.shape}"
                    )
                if not mask.any():
                    mask = None
            n_pending = len(pending) if pending else 0
            n_eff = int(mask.sum()) if mask is not None else len(hist.losses) + n_pending
            n_below = int(np.ceil(gamma * np.sqrt(n_eff)))
            if linear_forgetting is not None:  # ap_split_trials gamma_cap semantics
                n_below = min(n_below, int(linear_forgetting))
            cap_b = parzen_ops.bucket(max(n_below, 1))
            if pending:
                losses_buf, hyp_views, keep_mask = dh.hypothetical_append(hist, list(pending))
            else:
                losses_buf, hyp_views, keep_mask = dh.losses, {}, dh.keep_mask(mask)

            uniforms = _label_uniforms(seed, dh.n_labels, k * n_cand, dev)
            # the tier is resolved once per suggest; only fused programs carry
            # the in-kernel-draw switch, only sharded ones the mesh
            if mesh is not None:
                tier = {"scorer": "pallas", "mesh": mesh}
            else:
                scorer = resolve_scorer()
                tier = {"scorer": scorer}
                if scorer == "fused":
                    tier["fused_draw"] = resolve_fused_draw()
            specs = domain.space.specs

            # hard locks: value pinned, posterior skipped (activity still derived)
            hard = {}
            if param_locks:
                for lb, (center, radius) in param_locks.items():
                    if radius <= 0:
                        spec = specs[lb]
                        if spec.is_integer or spec.dist in ("randint", "categorical"):
                            hard[lb] = np.full(k, int(round(center)), np.int64)
                        else:
                            hard[lb] = np.full(k, float(center), np.float64)

            requests, req_fams = [], []
            for fam in dh.families.values():
                f_obs, f_pos, f_counts = hyp_views.get(fam.key, (fam.obs, fam.pos, fam.counts))
                # basic indexing and one stack: a list index would be a blocking upload
                u = torch.stack([uniforms[i] for i in fam.kis])
                lock_c = np.zeros(fam.L, np.float32)
                lock_r = np.full(fam.L, np.inf, np.float32)
                if fam.key[0] == "cont":
                    priors = fam.default_priors
                    if param_locks:
                        priors = priors.copy()
                        for i, lb in enumerate(fam.labels):
                            lock = param_locks.get(lb)
                            if lock is None or lock[1] <= 0:
                                continue
                            center, radius = lock
                            c_fit = (
                                float(np.log(max(center, EPS)))
                                if fam.log_scale
                                else float(center)
                            )
                            lo = max(float(priors[i, 2]), c_fit - radius)
                            hi = min(float(priors[i, 3]), c_fit + radius)
                            if lo < hi:  # neighborhood inside support: narrow
                                priors[i, 0] = np.clip(c_fit, lo, hi)
                                priors[i, 1] = min(float(priors[i, 1]), 2.0 * radius)
                                priors[i, 2], priors[i, 3] = lo, hi
                                lock_c[i], lock_r[i] = c_fit, radius
                    st = dict(
                        cap_b=cap_b, k=k, n_cand=n_cand, lf=lf,
                        log_scale=fam.log_scale, quantized=fam.quantized,
                        n_buckets=(_family_bucket_count(fam, k * n_cand)
                                   if fam.quantized else 0),
                        **tier,
                    )
                    requests.append((
                        "cont",
                        (u, f_obs, f_pos, f_counts, losses_buf, keep_mask, n_below,
                         float(np.float32(prior_weight)), upload(priors, dev),
                         upload(lock_c, dev), upload(lock_r, dev)),
                        st,
                    ))
                else:
                    if param_locks:
                        for i, lb in enumerate(fam.labels):
                            lock = param_locks.get(lb)
                            if lock is not None and lock[1] > 0:
                                lock_c[i] = float(lock[0] - fam.offsets[i])
                                lock_r[i] = float(lock[1])
                    requests.append((
                        "idx",
                        (u, f_obs, f_pos, f_counts, losses_buf, keep_mask, n_below,
                         float(np.float32(prior_weight)), upload(fam.prior_p, dev),
                         upload(lock_c, dev), upload(lock_r, dev)),
                        dict(cap_b=cap_b, upper=fam.upper, k=k, n_cand=n_cand, lf=lf),
                    ))
                req_fams.append(fam)

    def finish_outs(outs, diag=None):
        chosen_vals = {}
        for fam, best in zip(req_fams, outs):
            best = np.asarray(best)  # [L, k]
            for i, lb in enumerate(fam.labels):
                if lb not in hard:
                    chosen_vals[lb] = fam.from_fit_space(i, best[i])
        chosen_vals.update(hard)
        with tracing.span("suggest.emit", k=k):
            docs = _emit_docs(new_ids, domain, trials, chosen_vals, k)
        if diag is not None and sdiag.enabled():
            # published after the docs are built: a finish that raises
            # leaves nothing for a later suggest to claim
            sdiag.publish_suggest_diag(sdiag.snapshot_from_fused(
                req_fams, diag, n_below=n_below, gamma=float(gamma), n_eff=n_eff,
                k=k, n_cand=n_cand,
            ))
        return docs

    # callers that batch several suggests check this before passing the
    # batched readback's diag rows to a finish
    finish_outs.accepts_diag = True

    if prepare:
        return requests, finish_outs

    with tracing.span("suggest.launch", n_families=len(requests)):
        resolve_fetch = td.multi_family_suggest_async(requests)

    def finish():
        with tracing.span("suggest.readback"):
            outs = resolve_fetch()
        return finish_outs(outs, diag=resolve_fetch.diag)

    return finish if defer else finish()


def suggest(
    new_ids,
    domain,
    trials,
    seed,
    prior_weight=_default_prior_weight,
    n_startup_jobs=_default_n_startup_jobs,
    n_EI_candidates=_default_n_EI_candidates,
    gamma=_default_gamma,
    linear_forgetting=_default_linear_forgetting,
    verbose=True,
    param_locks=None,
    trial_filter=None,
    device=None,
    mesh=None,
):
    """TPE suggest: draw candidates from l(x), rank by log l(x) − log g(x).

    ``device``: where the history lives and the suggest runs (None: the
    CUDA card; ``"cpu"`` runs the plain PyTorch versions of the kernels).

    ``mesh``: a ``parallel.sharding.DeviceMesh`` or a spec (``"auto"``,
    ``"off"``, ``"DPxSP"`` over the local cards), e.g.
    ``partial(tpe.suggest, mesh="auto", n_EI_candidates=65536)``: the
    unquantized labels' scoring shards over it (candidates over ``dp``,
    mixture components over ``sp``) and quantized labels without a bucket
    grid split their candidates over ``dp``; index labels stay on the lead
    slot (their component axis is the category count).  The history and
    every other stage live on the mesh's lead slot, so ``device`` must be
    None or that device.  A degenerate mesh is the single-device program.

    ``param_locks``: optional ``{label: (center, radius)}`` — the ATPE
    "cascade" (reference ``hyperopt/atpe.py`` ~L300-700):

    - ``radius <= 0``: HARD lock — the label's value is pinned to
      ``center``; the posterior is skipped for it, but branch activity is
      still derived from the final values.
    - ``radius > 0``: SOFT lock — the candidate-sampling bounds are
      narrowed to ``center ± radius``, the prior recentered there, and the
      observation sets filtered to the neighborhood before the Parzen
      fits.  ``center`` is a raw-space value; for log-scale labels the
      radius is in log space.

    ``trial_filter``: optional boolean mask aligned with
    ``trials.history.loss_tids`` (or a callable ``hist -> mask``) —
    restricts which completed trials feed the posterior.
    """
    return _suggest_impl(
        new_ids, domain, trials, seed, prior_weight, n_startup_jobs,
        n_EI_candidates, gamma, linear_forgetting, param_locks, trial_filter,
        device, defer=False, mesh=mesh,
    )


def suggest_async(
    new_ids,
    domain,
    trials,
    seed,
    prior_weight=_default_prior_weight,
    n_startup_jobs=_default_n_startup_jobs,
    n_EI_candidates=_default_n_EI_candidates,
    gamma=_default_gamma,
    linear_forgetting=_default_linear_forgetting,
    verbose=True,
    param_locks=None,
    trial_filter=None,
    device=None,
    pending=None,
    mesh=None,
):
    """:func:`suggest` launched without waiting: returns a zero-argument
    resolver that yields exactly the docs ``suggest`` would have returned
    for the same inputs, while the card computes in between.  The
    random-search startup and the uncompilable-space fallback do not
    depend on the history and are computed at once (their resolver is a
    constant).

    ``pending``: in-flight trials' ``misc["vals"]`` dicts, in completion
    order; the fit then assumes each completed with a worst-case loss
    (see :func:`_suggest_device`).  This is the dispatch the speculative
    engine (:mod:`hyperopt_tpu_torch.pipeline`) overlaps with the
    objective.  Reference: ``hyperopt_tpu/algos/tpe.py:902``."""
    return _suggest_impl(
        new_ids, domain, trials, seed, prior_weight, n_startup_jobs,
        n_EI_candidates, gamma, linear_forgetting, param_locks, trial_filter,
        device, defer=True, pending=pending, mesh=mesh,
    )


def suggest_prepare(
    new_ids,
    domain,
    trials,
    seed,
    prior_weight=_default_prior_weight,
    n_startup_jobs=_default_n_startup_jobs,
    n_EI_candidates=_default_n_EI_candidates,
    gamma=_default_gamma,
    linear_forgetting=_default_linear_forgetting,
    verbose=True,
    param_locks=None,
    trial_filter=None,
    device=None,
    mesh=None,
):
    """One TPE suggest's request list, built but not launched.

    Returns ``(requests, finish)``: ``requests`` is what
    :func:`tpe_device.multi_family_suggest_async` takes, and
    ``finish(outs, diag=None)`` turns the resolved per-family winners into
    the docs :func:`suggest` would have returned.  Returns None when the
    suggest does not reach the card (random-search startup, empty OK
    history, uncompilable space): call :func:`suggest` then.  Several
    studies' requests can go to the card as one batch through
    :func:`tpe_device.multi_study_suggest_async`; each study's docs equal
    its unbatched suggest.  Reference: ``hyperopt_tpu/algos/tpe.py:944``."""
    return _suggest_impl(
        new_ids, domain, trials, seed, prior_weight, n_startup_jobs,
        n_EI_candidates, gamma, linear_forgetting, param_locks, trial_filter,
        device, defer=False, prepare=True, mesh=mesh,
    )


def plain_label_scores(new_ids, domain, trials, seed, label,
                       dtype=torch.float32, at=None, device="cpu", **kw):
    """The CPU suggest's own candidates for ``label`` and their plain
    scores (log l − log g): ``(cands, scores)``, each ``[k, n_cand]`` for
    the ``k = len(new_ids)`` ids, ``cands`` as raw values.

    ``at`` (flat indices into ``[k * n_cand]``) scores only the chunks of
    the plain pair score (``ops.score.PAIR_CHUNK`` candidates, the same
    ``[L, chunk, K]`` products the suggest made) that hold them; the other
    scores are NaN.  Quantized and categorical labels are scored whole.

    Everything is what ``suggest(new_ids, domain, trials, seed,
    device="cpu", **kw)`` computes: its keep mask, γ-split, lock vectors,
    narrowed priors, Parzen fits and candidate draw, then the plain score
    in the fit space (the log-space ``z`` of a log-scale label) through
    the scorer call the suggest makes, at the suggest's ``[L, C]`` batch
    shape; the quantized and categorical lpdf differences where the
    family has one.  In ``float32`` the scores are the suggest's own, so
    each id's CPU winner is the first argmax of its row; ``dtype=
    torch.float64`` evaluates the same candidates in f64.  What tells a
    near-tie between two scorers' winners from a wrong winner; no suggest
    path calls it.  ``device="cuda"`` does all of it on the card instead:
    the card's own candidates, scored by the plain version there."""
    from . import tpe_device as td

    requests, _ = suggest_prepare(new_ids, domain, trials, seed, device=device, **kw)
    fams = td.device_history_for(trials, domain.space, device).families.values()
    for (kind, args, st), fam in zip(requests, fams):
        if label not in fam.labels:
            continue
        i = fam.labels.index(label)
        u, obs, pos, counts, losses, keep, n_below, pw, prior, lock_c, lock_r = args
        ranks = td._loss_ranks(losses, keep)
        below, nb, above, na = td._split_pack(obs, pos, counts, ranks, keep, n_below,
                                              lock_c, lock_r, st["cap_b"],
                                              lock_fallback=kind == "idx")
        if kind == "idx":
            pb, pa = (torch.where(prior > 0, gmm_ops.categorical_posterior(
                obs_, n_, prior, pw, st["upper"], st["lf"]), 0.0)
                for obs_, n_ in ((below, nb), (above, na)))
            cands = gmm_ops.categorical_sample(u[:, 0], pb)
            pb, pa = pb.to(dtype), pa.to(dtype)
            s = gmm_ops.categorical_lpdf(cands, pb) - gmm_ops.categorical_lpdf(cands, pa)
            raw = fam.from_fit_space(i, cands[i].cpu().numpy())
        else:
            pm, ps, lo, hi, qq = prior.unbind(dim=1)
            B = parzen_ops.adaptive_parzen_normal_padded(below, nb, pw, pm, ps, st["lf"])
            A = parzen_ops.adaptive_parzen_normal_padded(above, na, pw, pm, ps, st["lf"])
            cands = gmm_ops.gmm_sample(u[:, 0], u[:, 1], *B, lo, hi, qq, st["log_scale"])
            # the suggest's own scoring of its candidates, in dtype
            # (td._family_suggest_core)
            Bd, Ad = [t.to(dtype) for t in B], [t.to(dtype) for t in A]
            lo_d, hi_d, q_d = (t.to(dtype) for t in (lo, hi, qq))
            if st["quantized"] and st["n_buckets"] > 0:
                raw_lo = torch.exp(lo_d) if st["log_scale"] else lo_d
                qe = q_d.clamp(min=td.EPS)
                j0 = torch.floor(raw_lo / qe) - 1.0
                grid = qe[:, None] * (j0[:, None] + torch.arange(st["n_buckets"], device=qe.device))
                g = (gmm_ops.gmm_lpdf(grid, *Bd, lo_d, hi_d, q_d, st["log_scale"], True)
                     - gmm_ops.gmm_lpdf(grid, *Ad, lo_d, hi_d, q_d, st["log_scale"], True))
                idx = (torch.round(cands.to(dtype) / qe[:, None])
                       - j0[:, None]).clamp(0, st["n_buckets"] - 1)
                s = g.gather(1, idx.to(torch.int64))
            elif st["quantized"] or st["scorer"] == "exact":
                x = cands.to(dtype)
                s = (gmm_ops.gmm_lpdf(x, *Bd, lo_d, hi_d, q_d, st["log_scale"], st["quantized"])
                     - gmm_ops.gmm_lpdf(x, *Ad, lo_d, hi_d, q_d, st["log_scale"], st["quantized"]))
            else:
                z = torch.log(cands.clamp(min=td.EPS)) if st["log_scale"] else cands
                z, params = z.to(dtype).contiguous(), pair_params(*Bd, *Ad).contiguous()
                if at is None:
                    s = pair_score(z, params, B[0].shape[1])
                else:
                    s = torch.full(z.shape, float("nan"), dtype=dtype, device=z.device)
                    for c0 in sorted({int(a) // PAIR_CHUNK * PAIR_CHUNK for a in at}):
                        zc = z[:, c0:c0 + PAIR_CHUNK].contiguous()
                        s[:, c0:c0 + PAIR_CHUNK] = pair_score(zc, params, B[0].shape[1])
            raw = fam.from_fit_space(i, cands[i].cpu().numpy())
        k, n_cand = st["k"], st["n_cand"]
        return (np.asarray(raw).reshape(k, n_cand),
                s[i].cpu().numpy().reshape(k, n_cand))
    raise KeyError(label)


def _suggest_impl(
    new_ids, domain, trials, seed, prior_weight, n_startup_jobs,
    n_EI_candidates, gamma, linear_forgetting, param_locks, trial_filter,
    device, defer, pending=None, prepare=False, mesh=None,
):
    # a degenerate mesh resolves to None here, before anything is keyed
    mesh, dev = resolve_mesh_device(mesh, device)
    with tracing.span("suggest.history") as sp:
        hist = trials.history
        sp.set_attr("n_hist", len(hist.losses))
    # Startup gate on ALL inserted non-error trials (reference semantics:
    # ``len(trials.trials)``), not completed-OK count; random suggest also
    # while the OK history is empty (nothing to fit a posterior on).
    if len(trials.trials) < n_startup_jobs or len(hist.losses) == 0:
        if prepare:
            return None  # host-side path: nothing to batch
        docs = rand.suggest(new_ids, domain, trials, seed, device=dev)
        return (lambda: docs) if defer else docs

    if not domain.space.compiled:
        if prepare:
            return None
        logger.warning(
            "space not compilable (%s): tpe falling back to random suggest",
            domain.space.compile_error,
        )
        docs = rand.suggest(new_ids, domain, trials, seed, device=dev)
        return (lambda: docs) if defer else docs

    return _suggest_device(
        new_ids, domain, trials, hist, seed, prior_weight, n_EI_candidates,
        gamma, linear_forgetting, param_locks, trial_filter, dev,
        defer=defer, pending=pending, prepare=prepare, mesh=mesh,
    )


# the speculative engine finds the asynchronous variant and its validity
# policy through these attributes, and a batching caller the prepare/finish
# split (see hyperopt_tpu_torch.pipeline)
suggest.async_variant = suggest_async
suggest.speculation_policy = "tpe_quantile"
suggest.prepare_variant = suggest_prepare
