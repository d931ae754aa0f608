"""Adaptive TPE: meta-learned TPE configuration + parameter locking.

Reference parity (SURVEY.md §2 #15): ``hyperopt/atpe.py`` +
``hyperopt/atpe_models/`` — ``Hyperparameter`` space featurization from
``expr_to_config`` (~L50-300), parameter-lock/cascade logic (~L300-700),
``ATPEOptimizer`` (~20 space/history features → pretrained LightGBM
regressors/classifiers → TPE meta-params ``gamma``, ``n_EI_candidates``,
``resultFilteringMode``, ``secondaryCutoff`` → delegation to TPE with
per-parameter filtering) (~L700-1800), ``suggest`` (~L1800-1850).

Port of ``hyperopt_tpu/algos/atpe.py``: the featurizer, the meta layer and
the cascade are host numpy, carried over unchanged; the TPE step they
configure is the port's ``tpe.suggest`` on the card (``device=``), which
takes the lock-narrowed priors and the filtered keep mask.

Artifact policy: the reference ships pretrained LightGBM model files
(``scaling_model.json``, ``model-<target>.txt``).  LightGBM is absent from
this image and the training corpus is not retrievable offline, so this
implementation preserves the *architecture* — featurizer → meta-model →
TPE delegation with per-parameter locking — with two meta-model sources:

1. ``ATPEOptimizer(model_dir=...)`` loads sklearn estimators (pickled,
   one per target, plus ``scaling_model.json`` feature-normalization
   stats — the same artifact shape as the reference); and
2. a deterministic heuristic fallback (documented per-rule below) used
   when no artifacts are present, tuned to reproduce ATPE's qualitative
   behavior: exploit harder as evidence accumulates, spend more
   candidates in higher dimensions, and lock low-influence parameters to
   their incumbent values (the "cascade").
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from functools import partial

import numpy as np

from ..pyll_utils import expr_to_config
from . import rand, tpe

logger = logging.getLogger(__name__)

_default_n_startup_jobs = 20


class Hyperparameter:
    """Featurized view of one search-space parameter."""

    CONTINUOUS_DISTS = {
        "uniform", "quniform", "loguniform", "qloguniform",
        "normal", "qnormal", "lognormal", "qlognormal", "uniformint",
    }

    def __init__(self, label, spec):
        self.label = label
        self.spec = spec

    @property
    def is_categorical(self):
        return self.spec.dist in ("randint", "categorical")

    @property
    def is_log_scale(self):
        return self.spec.dist in ("loguniform", "qloguniform", "lognormal", "qlognormal")

    @property
    def is_conditional(self):
        conds = self.spec.conditions
        return bool(conds) and not any(len(c) == 0 for c in conds)

    @property
    def cardinality(self):
        """log2 of the (approximate) number of distinct values."""
        p = self.spec.params
        if self.is_categorical:
            return float(np.log2(max(self.spec.upper or 2, 2)))
        q = p.get("q")
        if q:
            if self.spec.dist in ("quniform", "uniformint"):
                return float(np.log2(max((p["high"] - p["low"]) / q, 2)))
            return 6.0  # quantized unbounded: moderate
        return 20.0  # continuous

    def feature_vector(self):
        return np.array(
            [
                1.0 if self.is_categorical else 0.0,
                1.0 if self.is_log_scale else 0.0,
                1.0 if self.is_conditional else 0.0,
                self.cardinality,
            ]
        )


# targets the meta-model predicts (reference: gamma, nEICandidates,
# resultFilteringMode, secondaryCutoff, ...).  result_filtering_mode is a
# classifier target; the rest are regressors.  n_EI_candidates is trained
# and predicted in log2 (see scaling_model.json "transforms").
META_TARGETS = (
    "gamma",
    "n_EI_candidates",
    "prior_weight",
    "secondary_cutoff",
    "result_filtering_mode",
    "result_filtering_multiplier",
)

FILTER_MODES = ("none", "age", "loss_rank", "random")

# shipped artifacts (hyperopt_tpu_torch/models/atpe_models/, a
# byte-identical copy of hyperopt_tpu/models/atpe_models/) — the reference
# ships hyperopt/atpe_models/{scaling_model.json, model-<target>.txt};
# ours are sklearn pickles trained by hyperopt_tpu.models.train_atpe.
# Where sklearn is absent every pickle fails to load and each target keeps
# its heuristic rule (load_models)
DEFAULT_MODEL_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "models",
    "atpe_models",
)


def build_trial_filter(mode, multiplier):
    """The reference's ``resultFilteringMode`` as a ``trial_filter`` mask
    builder for ``tpe.suggest`` — restricts which completed trials feed
    the Parzen posterior:

    - ``age``: keep the most recent ``ceil(multiplier · n)`` trials;
    - ``loss_rank``: keep the best ``ceil(multiplier · n)`` by loss;
    - ``random``: keep a deterministic (size-seeded) random fraction;
    - ``none``: no filtering (returns None).
    """
    if mode is None or mode == "none":
        return None
    mult = float(np.clip(multiplier, 0.2, 1.0))

    def filt(hist):
        n = len(hist.losses)
        keep = min(n, max(int(np.ceil(mult * n)), 10))
        mask = np.zeros(n, dtype=bool)
        if keep >= n:
            mask[:] = True
            return mask
        if mode == "age":
            order = np.argsort(hist.loss_tids, kind="stable")  # oldest→newest
            mask[order[-keep:]] = True
        elif mode == "loss_rank":
            order = np.argsort(hist.losses, kind="stable")
            mask[order[:keep]] = True
        elif mode == "random":
            # deterministic for a given history size → reproducible runs
            ridx = np.random.default_rng(n).permutation(n)[:keep]
            mask[ridx] = True
        else:
            raise ValueError(f"unknown result_filtering_mode {mode!r}")
        return mask

    return filt

FEATURE_NAMES = (
    "n_parameters",
    "frac_categorical",
    "frac_conditional",
    "frac_log_scale",
    "frac_integer",
    "mean_log2_cardinality",
    "n_trials",
    "log_n_trials",
    "history_per_param",
    "best_loss",
    "loss_std",
    "loss_iqr",
    "loss_skew",
    "loss_kurtosis",
    "recent_improvement",
    "frac_failed",
    "top_frac_spread",
    "mean_abs_param_loss_corr",
    "max_abs_param_loss_corr",
    "min_abs_param_loss_corr",
)


class ATPEOptimizer:
    def __init__(self, model_dir=None):
        self.models = {}
        self.scaling = None
        if model_dir:
            self.load_models(model_dir)

    # -- artifact loading (reference artifact shape) --------------------
    def load_models(self, model_dir):
        scaling_path = os.path.join(model_dir, "scaling_model.json")
        if os.path.exists(scaling_path):
            with open(scaling_path) as f:
                self.scaling = json.load(f)
        for target in META_TARGETS:
            p = os.path.join(model_dir, f"model-{target}.pkl")
            if os.path.exists(p):
                try:
                    with open(p, "rb") as f:
                        self.models[target] = pickle.load(f)
                except Exception as e:
                    # sklearn absent (optional extra) or version-skewed
                    # pickle: this target stays on the heuristic rules
                    logger.warning(
                        "atpe: could not load %s (%s); using heuristic "
                        "for %r", p, e, target,
                    )
        logger.info(
            "atpe: loaded %d meta-models from %s", len(self.models), model_dir
        )

    # -- featurization ---------------------------------------------------
    @staticmethod
    def hyperparameters(domain):
        return {
            lb: Hyperparameter(lb, sp) for lb, sp in domain.space.specs.items()
        }

    def compute_features(self, domain, trials):
        hps = self.hyperparameters(domain)
        hist = trials.history
        losses = np.asarray(hist.losses, dtype=float)
        # NaN losses are legitimate diverged trials; they must not poison
        # the loss statistics (a single NaN would NaN every feature and
        # silently disable all meta-models' predict())
        losses = losses[np.isfinite(losses)]
        n = len(losses)

        hp_feats = np.array([h.feature_vector() for h in hps.values()])
        n_params = len(hps)

        # per-parameter |spearman-ish| correlation of value vs loss via
        # the cache's vectorized tid→loss join (the old per-pair python
        # dict build cost ~100 ms/suggest at a 10k-trial history, AND
        # misaligned every pair after the first NaN loss by zipping
        # loss_tids against the NaN-filtered losses). Rank transforms
        # make ±inf losses harmless, so only NaN pairs are dropped.
        corrs = []
        for lb in hps:
            tids = np.asarray(hist.idxs.get(lb, ()), dtype=np.int64)
            vals = np.asarray(hist.vals.get(lb, ()), dtype=float)
            ok, l = hist.join_losses(tids)
            v = vals[ok]
            if len(v) < 5:
                corrs.append(np.nan)  # sentinel: no evidence (≠ corr 0)
                continue
            vr = np.argsort(np.argsort(v)).astype(float)
            lr = np.argsort(np.argsort(l)).astype(float)
            denom = v.std() and (vr.std() * lr.std())
            c = 0.0 if not denom else float(np.corrcoef(vr, lr)[0, 1])
            corrs.append(abs(c) if np.isfinite(c) else 0.0)
        corrs = np.asarray(corrs) if corrs else np.zeros(1)
        # feature aggregates over MEASURED params only (NaN = no evidence)
        measured = corrs[np.isfinite(corrs)]
        if measured.size == 0:
            measured = np.zeros(1)

        if n:
            srt = np.sort(losses)
            k = max(1, int(np.ceil(0.25 * np.sqrt(n))))
            top_spread = float(srt[: max(2, k)].std())
            q25, q75 = np.percentile(losses, [25, 75])
            med = np.median(losses)
            mean = losses.mean()
            std = losses.std() or 1.0
            skew = float((mean - med) / std)
            zs = (losses - mean) / std
            kurt = float(np.mean(zs**4) - 3.0) if n >= 4 else 0.0
            half = n // 2 or 1
            recent = float(
                np.min(losses[:half]) - np.min(losses[half:]) if n >= 4 else 0.0
            )
        else:
            top_spread, q25, q75, skew, recent = 0.0, 0.0, 0.0, 0.0, 0.0
            kurt = 0.0

        n_total = len(trials.trials) or 1
        frac_integer = (
            float(
                np.mean(
                    [
                        1.0
                        if (h.spec.is_integer or h.spec.params.get("q"))
                        else 0.0
                        for h in hps.values()
                    ]
                )
            )
            if n_params
            else 0.0
        )
        feats = {
            "n_parameters": float(n_params),
            "frac_categorical": float(hp_feats[:, 0].mean()) if n_params else 0.0,
            "frac_conditional": float(hp_feats[:, 2].mean()) if n_params else 0.0,
            "frac_log_scale": float(hp_feats[:, 1].mean()) if n_params else 0.0,
            "frac_integer": frac_integer,
            "mean_log2_cardinality": float(hp_feats[:, 3].mean()) if n_params else 0.0,
            "n_trials": float(n),
            "log_n_trials": float(np.log1p(n)),
            "history_per_param": float(n / max(n_params, 1)),
            "best_loss": float(losses.min()) if n else 0.0,
            "loss_std": float(losses.std()) if n else 0.0,
            "loss_iqr": float(q75 - q25),
            "loss_skew": skew,
            "loss_kurtosis": kurt,
            "recent_improvement": recent,
            "frac_failed": float(1.0 - n / n_total),
            "top_frac_spread": top_spread,
            "mean_abs_param_loss_corr": float(measured.mean()),
            "max_abs_param_loss_corr": float(measured.max()),
            "min_abs_param_loss_corr": float(measured.min()),
        }
        # NaN entries mean "too few observations to measure" — consumers
        # (choose_locks) must treat them as no-evidence, never as corr 0
        per_param_corr = dict(zip(hps.keys(), corrs)) if n_params else {}
        return feats, per_param_corr

    # -- meta prediction -------------------------------------------------
    def _vectorize(self, feats):
        x = np.array([[feats[k] for k in FEATURE_NAMES]])
        if self.scaling:
            mu = np.array([self.scaling["mean"][k] for k in FEATURE_NAMES])
            sd = np.array([self.scaling["std"][k] for k in FEATURE_NAMES])
            x = (x - mu) / np.where(sd > 0, sd, 1.0)
        return x

    def predict_meta(self, feats):
        """Meta-parameters for this suggest step (models else heuristics).

        A shipped model only OVERRIDES the heuristic rule for targets in
        the artifact's ``active_targets`` — the set that showed genuine
        cross-domain skill in the trainer's grouped CV
        (``train_atpe.fit_models``).  Artifacts predating the field
        activate everything (back-compat)."""
        meta = self._heuristic_meta(feats)
        transforms = (self.scaling or {}).get("transforms", {})
        active = (self.scaling or {}).get("active_targets")
        if self.models:
            x = self._vectorize(feats)
            for target, model in self.models.items():
                if active is not None and target not in active:
                    continue  # no CV-proven skill: heuristic rules
                try:
                    pred = model.predict(x)[0]
                except Exception as e:  # corrupt artifact: keep heuristic
                    logger.warning("atpe model %s failed: %s", target, e)
                    continue
                if target == "result_filtering_mode":
                    meta[target] = str(pred)
                elif transforms.get(target) == "log2":
                    meta[target] = float(2.0 ** float(pred))
                else:
                    meta[target] = float(pred)
        meta["gamma"] = float(np.clip(meta["gamma"], 0.1, 0.5))
        meta["n_EI_candidates"] = int(np.clip(meta["n_EI_candidates"], 8, 4096))
        meta["prior_weight"] = float(np.clip(meta["prior_weight"], 0.25, 2.0))
        meta["secondary_cutoff"] = float(np.clip(meta["secondary_cutoff"], 0.0, 1.0))
        if meta.get("result_filtering_mode") not in FILTER_MODES:
            meta["result_filtering_mode"] = "none"
        meta["result_filtering_multiplier"] = float(
            np.clip(meta.get("result_filtering_multiplier", 1.0), 0.2, 1.0)
        )
        return meta

    @staticmethod
    def _heuristic_meta(feats):
        """Deterministic fallback rules (documented):
        - γ shrinks as evidence accumulates (exploit harder late);
        - candidate count grows ~ sqrt(dimensionality) — cheap on TPU;
        - prior weight decays once the history dwarfs the prior;
        - secondary cutoff (lock threshold) rises with dimensionality so
          high-dim spaces get more aggressive cascading."""
        n = feats["n_trials"]
        gamma = 0.30 - 0.05 * np.tanh((n - 50.0) / 100.0) - 0.1 * np.tanh(
            feats["mean_abs_param_loss_corr"]
        )
        n_ei = 24 * max(1.0, np.sqrt(feats["n_parameters"]))
        if n > 200:
            n_ei *= 2
        prior_weight = 1.0 if n < 100 else 0.5
        secondary_cutoff = float(
            np.clip(0.05 + 0.01 * feats["n_parameters"], 0.05, 0.3)
        )
        # long histories: age-filter the posterior (recent trials reflect
        # the exploited region); short ones keep everything
        if n > 300:
            filtering_mode, filtering_mult = "age", 0.5
        else:
            filtering_mode, filtering_mult = "none", 1.0
        return {
            "gamma": float(gamma),
            "n_EI_candidates": float(n_ei),
            "prior_weight": prior_weight,
            "secondary_cutoff": secondary_cutoff,
            "result_filtering_mode": filtering_mode,
            "result_filtering_multiplier": filtering_mult,
        }

    # -- parameter locking (the cascade) ---------------------------------
    @staticmethod
    def choose_locks(per_param_corr, cutoff, rng, exclude=frozenset()):
        """Lock params whose loss-rank correlation is below ``cutoff``,
        with probability proportional to how far below: a parameter with
        zero measured influence locks with p≈0.75, one just under the
        cutoff almost never does.  Randomness (vs locking all of them)
        keeps exploration alive, like the reference's filtered-parameter
        resampling; the influence-proportional p replaces round-2's
        uniform coin flip so the cascade actually grades by evidence.

        ``exclude``: labels that must never be locked — in particular
        labels that drive conditional branches (a lock there would have to
        reconcile every dependent child's activity)."""
        locked = []
        for lb, corr in per_param_corr.items():
            if lb in exclude:
                continue
            # NaN = unmeasured (too few observations): never lock on no
            # evidence — those are exactly the params that need more data
            if not np.isfinite(corr):
                continue
            if cutoff <= 0 or corr >= cutoff:
                continue
            p_lock = 0.75 * (1.0 - corr / cutoff)
            if rng.uniform() < p_lock:
                locked.append(lb)
        return locked

    @staticmethod
    def condition_driver_labels(domain):
        """Labels referenced on the left-hand side of any spec's activity
        conditions (i.e. hp.choice/randint switches with dependents)."""
        drivers = set()
        for spec in domain.space.specs.values():
            for conj in spec.conditions:
                for name, _val in conj:
                    drivers.add(name)
        return frozenset(drivers)


def locks_from_labels(domain, trials, locked):
    """Locked labels → ``{label: (center, radius)}`` for
    ``tpe.suggest(param_locks=...)``.

    Locks are OBSERVATION FILTERS, not value overwrites: each locked
    label's history is narrowed to the incumbent's neighborhood before
    the Parzen fits, so the suggestion is still sampled through the real
    posterior and conditional-branch activity stays consistent by
    construction (the reference's per-parameter filtering/resampling
    semantics, ``hyperopt/atpe.py`` ~L300-700, rebuilt as posterior
    shaping).  Also used by the offline meta-model trainer
    (``hyperopt_tpu.models.train_atpe``) so training and inference share
    one lock semantics."""
    if not locked:
        return {}
    try:
        best_misc = trials.best_trial["misc"]
    except Exception:
        return {}
    hist = trials.history
    param_locks = {}
    for lb in locked:
        best_vals = best_misc["vals"].get(lb)
        if not best_vals:
            continue  # label inactive in the incumbent: no lock
        center = float(best_vals[0])
        spec = domain.space.specs[lb]
        if spec.dist in ("randint", "categorical") or spec.is_integer:
            radius = 0.0  # hard pin to the incumbent category
        else:
            obs = np.asarray(hist.vals.get(lb, []), dtype=float)
            hp_view = Hyperparameter(lb, spec)
            if hp_view.is_log_scale:
                # soft-lock radii are log-space for log dists
                obs = np.log(np.maximum(obs, 1e-12))
            spread = float(obs.std()) if len(obs) > 1 else 0.0
            if spread <= 0:
                continue
            radius = 0.25 * spread
        param_locks[lb] = (center, radius)
    return param_locks


_optimizer_cache = {}


def _optimizer_for(model_dir):
    """Per-directory cached optimizer (artifact unpickling is not free
    and suggest runs every iteration).  ``model_dir=None`` resolves to
    the shipped artifacts when present, else the heuristic fallback."""
    if model_dir is None:
        has_artifacts = os.path.exists(
            os.path.join(DEFAULT_MODEL_DIR, "scaling_model.json")
        )
        model_dir = DEFAULT_MODEL_DIR if has_artifacts else ""
    opt = _optimizer_cache.get(model_dir)
    if opt is None:
        opt = ATPEOptimizer(model_dir=model_dir or None)
        _optimizer_cache[model_dir] = opt
    return opt


def suggest(
    new_ids,
    domain,
    trials,
    seed,
    n_startup_jobs=_default_n_startup_jobs,
    model_dir=None,
    verbose=True,
    device=None,
    mesh=None,
):
    """ATPE suggest: featurize → meta-params → TPE with parameter locks.

    ``device``: where the random-search startup and the TPE step run
    (None: the CUDA card).  ``mesh`` other than None raises
    ``NotImplementedError``: the sharded path is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "atpe.suggest(mesh=...) is not ported to hyperopt_tpu_torch yet "
            "(ROADMAP.md: queue A item 7, parallel/sharding.py); use "
            "hyperopt_tpu for it"
        )
    hist = trials.history
    # same startup gate as tpe.suggest: all inserted non-error trials
    # (reference semantics), plus an empty-OK-history guard
    if len(trials.trials) < n_startup_jobs or len(hist.losses) == 0:
        return rand.suggest(new_ids, domain, trials, seed, device=device)

    optimizer = _optimizer_for(model_dir)
    feats, per_param_corr = optimizer.compute_features(domain, trials)
    meta = optimizer.predict_meta(feats)
    rng = np.random.default_rng(seed)
    locked = optimizer.choose_locks(
        per_param_corr,
        meta["secondary_cutoff"],
        rng,
        # never auto-lock a branch-driving label: pinning it would freeze
        # branch exploration whenever its correlation dips below cutoff
        exclude=ATPEOptimizer.condition_driver_labels(domain),
    )

    param_locks = locks_from_labels(domain, trials, locked)
    if verbose and param_locks:
        logger.debug("atpe locked params: %s (meta=%s)", sorted(param_locks), meta)

    # the resultFilteringMode analog: the meta layer picks which slice of
    # history feeds the Parzen posterior (age / loss-rank / random)
    trial_filter = build_trial_filter(
        meta["result_filtering_mode"], meta["result_filtering_multiplier"]
    )

    return tpe.suggest(
        new_ids,
        domain,
        trials,
        seed,
        prior_weight=meta["prior_weight"],
        n_startup_jobs=n_startup_jobs,
        n_EI_candidates=meta["n_EI_candidates"],
        gamma=meta["gamma"],
        param_locks=param_locks or None,
        trial_filter=trial_filter,
        device=device,
    )
