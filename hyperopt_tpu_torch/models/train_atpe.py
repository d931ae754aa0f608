"""Offline ATPE meta-model training (the reference's atpe_models pipeline).

Port of ``hyperopt_tpu/models/train_atpe.py``.  The reference ships
pretrained LightGBM artifacts (``hyperopt/atpe_models/scaling_model.json``,
``model-<target>.txt``) produced by an offline sweep over benchmark
optimization problems.  That corpus is unobtainable offline and LightGBM
is absent, so this trainer regenerates the same artifact *shape* from
the repo's own domain zoo with sklearn gradient boosting:

1. For each (domain, seed): run a base TPE optimization and snapshot the
   trials at checkpoints — each snapshot is one "optimization state".
2. For each state: continue the run under many sampled TPE meta-configs
   (γ, n_EI_candidates, prior_weight, secondary-cutoff locks,
   result-filtering mode/multiplier) for a fixed budget and record the
   final best loss.
3. Label each state with the meta-config statistics of its continuations,
   featurize the state with ``ATPEOptimizer.compute_features``, and fit
   one model per ``META_TARGETS`` entry (classifier for the mode,
   regressors else; n_EI_candidates in log2).
4. Write ``scaling_model.json`` (feature normalization + transforms +
   provenance) and ``model-<target>.pkl`` artifacts.

Every TPE suggest of the corpus build, and every ATPE suggest of the
held-out check, runs on ``device`` (the CUDA card unless ``--device cpu``
is passed), where it launches the pair-score kernel.  A corpus row is a
``(features, labels)`` pair of Python and numpy scalars and strings,
never a tensor, so a shard written by either package loads in the
other's ``load_rows`` and ``--fit-from``.  The streams are
``torch.Generator``'s, so a corpus built here is not the JAX package's
row for row.

Fitting needs scikit-learn.  Where it does not import, every mode that
fits fails before it builds anything, naming it; ``--rows-out`` needs no
sklearn, so shards can be built on one machine and fitted on another.

Run:  python -m hyperopt_tpu_torch.models.train_atpe [--quick] [--out DIR]
      [--device cpu]
(``--quick`` shrinks everything for a smoke run.  The default ``--out``
is the shipped artifact directory: pass another one unless you mean to
replace the shipped models.)
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import pickle
import sys
import time
from functools import partial

import numpy as np

# Training domains: the zoo minus HELD_OUT.  The held-out pair is never
# seen by the trainer — one low-dim continuous domain and one conditional
# domain — so the held-out check measures whether the artifacts
# GENERALIZE instead of scoring them on their own training data.
HELD_OUT = ("branin", "q1_choice")
DEFAULT_DOMAINS = (
    "quadratic1",
    "q1_lognormal",
    "n1",
    "gauss_wave",
    "gauss_wave2",
    "distractor",
    "hartmann6",
    "many_dists",
    "nested_arch",
    "rosen10",
)

GRID = {
    "gamma": (0.15, 0.25, 0.40),
    "n_EI_candidates": (24, 256),
    "prior_weight": (0.5, 1.0),
    "secondary_cutoff": (0.0, 0.25),
    "result_filtering": (
        ("none", 1.0),
        ("age", 0.5),
        ("loss_rank", 0.6),
        ("random", 0.7),
    ),
}


def sample_configs(n, rng):
    """n distinct meta-configs sampled uniformly from the grid product."""
    seen, out = set(), []
    while len(out) < n:
        cfg = {
            "gamma": rng.choice(GRID["gamma"]),
            "n_EI_candidates": int(rng.choice(GRID["n_EI_candidates"])),
            "prior_weight": rng.choice(GRID["prior_weight"]),
            "secondary_cutoff": rng.choice(GRID["secondary_cutoff"]),
        }
        mode, mult = GRID["result_filtering"][rng.integers(len(GRID["result_filtering"]))]
        cfg["result_filtering_mode"] = mode
        cfg["result_filtering_multiplier"] = mult
        key = tuple(sorted((k, str(v)) for k, v in cfg.items()))
        if key in seen:
            if len(seen) >= 3 * 2 * 2 * 2 * 4:  # grid exhausted
                break
            continue
        seen.add(key)
        out.append(cfg)
    return out


def _run_base(domain, seed, n_trials, device=None):
    from ..algos import tpe
    from ..base import Trials
    from ..fmin import fmin

    trials = Trials()
    fmin(
        domain.fn,
        domain.space,
        algo=partial(tpe.suggest, device=device),
        max_evals=n_trials,
        trials=trials,
        rstate=np.random.default_rng(seed),
        show_progressbar=False,
        verbose=False,
    )
    return trials


def _continue_with(domain, snapshot_docs, cfg, extra_evals, seed, device=None):
    """Continue a snapshotted run under one meta-config; return final best."""
    from ..algos import atpe as atpe_mod
    from ..algos import tpe
    from ..base import Domain, trials_from_docs
    from ..fmin import fmin

    trials = trials_from_docs(copy.deepcopy(snapshot_docs))
    dom = Domain(domain.fn, domain.space)

    # secondary-cutoff locks chosen once at the checkpoint (the per-call
    # re-choice in atpe.suggest averages to the same behavior)
    param_locks = None
    if cfg["secondary_cutoff"] > 0:
        opt = atpe_mod.ATPEOptimizer()
        _, per_param_corr = opt.compute_features(dom, trials)
        rng = np.random.default_rng(seed + 10_000)
        locked = opt.choose_locks(
            per_param_corr,
            cfg["secondary_cutoff"],
            rng,
            exclude=atpe_mod.ATPEOptimizer.condition_driver_labels(dom),
        )
        param_locks = atpe_mod.locks_from_labels(dom, trials, locked) or None

    trial_filter = atpe_mod.build_trial_filter(
        cfg["result_filtering_mode"], cfg["result_filtering_multiplier"]
    )
    algo = partial(
        tpe.suggest,
        gamma=cfg["gamma"],
        n_EI_candidates=cfg["n_EI_candidates"],
        prior_weight=cfg["prior_weight"],
        param_locks=param_locks,
        trial_filter=trial_filter,
        device=device,
    )
    n0 = len(trials.trials)
    fmin(
        domain.fn,
        domain.space,
        algo=algo,
        max_evals=n0 + extra_evals,
        trials=trials,
        rstate=np.random.default_rng(seed + 20_000),
        show_progressbar=False,
        verbose=False,
    )
    losses = [l for l in trials.losses() if l is not None]
    return float(np.min(losses)) if losses else float("inf")


def label_results(results):
    """State labels from (final_best, cfg) continuation results.

    Top-quartile majority voting was measurably noisy: with ~20 configs
    per state the filtering-mode majority was close to uniform chance,
    and the models learned to predict ``random`` filtering — i.e. throw
    away a third of the history — which LOST to the heuristic on held-out
    domains.  Instead:

    - continuous targets: rank-weighted mean over ALL configs
      (``w ∝ exp(−rank/(n/4))`` — smooth, emphasizes winners, uses every
      observation instead of the top 5);
    - filtering mode: the mode whose configs' MEDIAN final best is
      lowest (an entire-group comparison, robust to one lucky draw);
    - multiplier: rank-weighted mean within the winning mode (1.0 for
      ``none``, where it is meaningless).

    The raw results ride along under ``_results`` so future re-labelings
    can rerun from pickled shards without re-sweeping.
    """
    if not results:
        raise ValueError("label_results: empty continuation results")
    results = sorted(results, key=lambda r: r[0])
    n = len(results)
    w = np.exp(-np.arange(n) / max(1.0, n / 4.0))
    w = w / w.sum()

    def wmean(key, transform=lambda v: v):
        return float(sum(
            wi * transform(cfg[key]) for wi, (_, cfg) in zip(w, results)
        ))

    by_mode = {}
    for best, cfg in results:
        by_mode.setdefault(cfg["result_filtering_mode"], []).append(best)
    mode = min(by_mode, key=lambda m: float(np.median(by_mode[m])))
    if mode == "none":
        mult = 1.0
    else:
        mw = np.array(
            [wi for wi, (_, c) in zip(w, results)
             if c["result_filtering_mode"] == mode]
        )
        mv = [c["result_filtering_multiplier"] for _, c in results
              if c["result_filtering_mode"] == mode]
        mult = float(np.average(mv, weights=mw)) if mw.sum() > 0 else 1.0
    return {
        "gamma": wmean("gamma"),
        "n_EI_candidates": wmean("n_EI_candidates", np.log2),
        "prior_weight": wmean("prior_weight"),
        "secondary_cutoff": wmean("secondary_cutoff"),
        "result_filtering_mode": mode,
        "result_filtering_multiplier": mult,
        "_results": [(b, dict(c)) for b, c in results],
    }


def relabel_rows(rows):
    """Recompute labels from the raw ``_results`` stored in each row
    (no-op for legacy rows without them)."""
    out = []
    for feats, labels in rows:
        raw = labels.get("_results")
        out.append((feats, label_results(raw)) if raw else (feats, labels))
    return out


def build_corpus(domains, seeds, checkpoints, n_configs, cont_evals, log=print,
                 device=None):
    """Corpus rows ``(features, labels)`` for every (domain, seed,
    checkpoint) state; every TPE suggest runs on ``device`` (None: the
    CUDA card)."""
    from ..algos import atpe as atpe_mod
    from ..base import Domain, trials_from_docs
    from . import domains as zoo

    rng = np.random.default_rng(0)
    configs = sample_configs(n_configs, rng)
    rows = []  # (features dict, labels dict)
    t0 = time.time()
    for dname in domains:
        domain = zoo.get(dname)
        for seed in seeds:
            base = _run_base(domain, seed, max(checkpoints), device=device)
            docs = base.trials
            for ckpt in checkpoints:
                snapshot = [d for d in docs if d["tid"] < ckpt]
                if len(snapshot) < 10:
                    continue
                dom = Domain(domain.fn, domain.space)
                snap_trials = trials_from_docs(copy.deepcopy(snapshot))
                opt = atpe_mod.ATPEOptimizer()
                feats, _ = opt.compute_features(dom, snap_trials)
                feats["_domain"] = dname  # provenance only (not a feature)

                results = []
                for ci, cfg in enumerate(configs):
                    best = _continue_with(
                        domain, snapshot, cfg, cont_evals, seed * 1000 + ci,
                        device=device,
                    )
                    results.append((best, cfg))
                labels = label_results(results)
                rows.append((feats, labels))
                log(
                    f"  state {dname}/s{seed}/n{ckpt}: "
                    f"{len(results)} configs, best={results[0][0]:.4g}, "
                    f"labels γ={labels['gamma']:.2f} "
                    f"mode={labels['result_filtering_mode']} "
                    f"[{time.time()-t0:.0f}s]"
                )
    return rows


def _tensor_path(obj, path="row"):
    """The path of the first ``torch.Tensor`` inside ``obj``, else None."""
    if type(obj).__module__.startswith("torch"):
        return path
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    else:
        return None
    for k, v in items:
        found = _tensor_path(v, f"{path}[{k!r}]")
        if found:
            return found
    return None


def save_rows(rows, path):
    """Pickle one corpus shard (list of (features, labels) rows) — lets
    the hours-long sweep run as independent per-domain processes and
    survive interruptions; merge with ``--fit-from``.  Atomic replace:
    an interruption mid-save keeps the previous shard intact instead of
    tearing hours of sweep output.  A row holding a torch object is
    refused: the JAX package's ``load_rows`` reads these shards too."""
    from ..checkpoint import atomic_pickle_dump

    found = _tensor_path(rows, "rows")
    if found:
        raise TypeError(f"save_rows: {found} is a torch object; rows hold plain scalars")
    atomic_pickle_dump(rows, path)


def load_rows(paths):
    rows = []
    for p in paths:
        with open(p, "rb") as f:
            rows.extend(pickle.load(f))
    return rows


# A meta-model must PAY RENT to override the heuristic: it ships only if
# grouped-by-domain cross-validation shows genuine cross-domain skill.
# With a small corpus most targets have none (their labels are dominated
# by continuation noise + a global mean, and a global-mean policy loses
# to the tuned heuristic) — those targets stay on the heuristic rules.
# As the corpus grows, targets clear the bar one by one.  R² is measured
# against the grouped-CV mean predictor; the classifier bar is majority
# accuracy + margin.
CV_R2_MIN = 0.05
CV_ACC_MARGIN = 0.03


def require_sklearn():
    """Raise, naming scikit-learn, where it does not import: the fitting
    modes call this before they build or load anything."""
    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "train_atpe: fitting the meta-models needs scikit-learn (sklearn), "
            f"which does not import here ({e}); build shards with --rows-out "
            "and fit them with --fit-from where sklearn is installed"
        ) from e


def fit_models(rows, log=print):
    from sklearn.ensemble import (
        GradientBoostingClassifier,
        GradientBoostingRegressor,
    )
    from sklearn.model_selection import GroupKFold

    from ..algos.atpe import FEATURE_NAMES, META_TARGETS

    X = np.array([[f[k] for k in FEATURE_NAMES] for f, _ in rows])
    mu, sd = X.mean(axis=0), X.std(axis=0)
    Xn = (X - mu) / np.where(sd > 0, sd, 1.0)
    missing = sum(1 for f, _ in rows if "_domain" not in f)
    if missing:
        # without domain provenance, GroupKFold degenerates to per-row
        # KFold and the skill gate measures in-distribution recall — the
        # exact failure it exists to prevent.  Legacy shards must be
        # re-swept, not silently accepted.
        raise ValueError(
            f"fit_models: {missing}/{len(rows)} rows lack '_domain' "
            "provenance; rebuild those shards (grouped CV gating needs it)"
        )
    groups = np.array([f["_domain"] for f, _ in rows])
    n_groups = len(set(groups))

    def make(target):
        if target == "result_filtering_mode":
            return GradientBoostingClassifier(
                n_estimators=60, max_depth=2, random_state=0
            )
        return GradientBoostingRegressor(
            n_estimators=60, max_depth=2, random_state=0
        )

    models = {}
    cv_scores = {}
    active = []
    for target in META_TARGETS:
        y = [lab[target] for _, lab in rows]
        is_clf = target == "result_filtering_mode"
        if is_clf:
            y = np.asarray(y)
            if len(set(y.tolist())) < 2:
                cv_scores[target] = None  # constant class: nothing to learn
                continue
        else:
            y = np.asarray(y, dtype=float)

        # grouped CV: every fold predicts DOMAINS it never saw — the same
        # generalization the held-out gate demands
        if n_groups >= 3:
            cv = GroupKFold(n_splits=min(5, n_groups))
            err = base_err = 0.0
            hits = base_hits = 0
            for tr, te in cv.split(Xn, y, groups):
                if is_clf and len(np.unique(y[tr])) < 2:
                    # a fold whose train split is single-class (labels
                    # correlate with domain): that class IS the fold's
                    # prediction — same as the majority baseline
                    pred = np.full(len(te), y[tr][0])
                else:
                    m = make(target)
                    m.fit(Xn[tr], y[tr])
                    pred = m.predict(Xn[te])
                if is_clf:
                    vals, counts = np.unique(y[tr], return_counts=True)
                    majority = vals[np.argmax(counts)]
                    hits += int(np.sum(pred == y[te]))
                    base_hits += int(np.sum(y[te] == majority))
                else:
                    err += float(np.sum((pred - y[te]) ** 2))
                    base_err += float(np.sum((y[te] - y[tr].mean()) ** 2))
            if is_clf:
                score = (hits - base_hits) / len(y)
                keep = score > CV_ACC_MARGIN
            else:
                score = 1.0 - err / max(base_err, 1e-12)
                keep = score > CV_R2_MIN
        else:
            score, keep = None, True  # tiny/smoke corpora: no gating basis
        cv_scores[target] = None if score is None else round(float(score), 4)
        log(f"  fit {target}: cv_skill={cv_scores[target]} -> "
            f"{'ACTIVE' if keep else 'heuristic (model shipped, inactive)'}")
        # the model is always fitted and shipped (reference artifact
        # shape: one file per target); whether it OVERRIDES the heuristic
        # at suggest time is the evidence-gated active_targets list below
        m = make(target)
        m.fit(Xn, y)
        models[target] = m
        if keep:
            active.append(target)

    scaling = {
        "mean": {k: float(m_) for k, m_ in zip(FEATURE_NAMES, mu)},
        "std": {k: float(s) for k, s in zip(FEATURE_NAMES, sd)},
        "transforms": {"n_EI_candidates": "log2"},
        "corpus_rows": len(rows),
        "cv_skill": cv_scores,
        "active_targets": active,
    }
    return models, scaling


def _held_out_regret(models, scaling, seeds=(0, 1, 2), max_evals=40, log=print,
                     device=None):
    """Validation on the HELD_OUT domains (never in the corpus): run
    artifact-driven ATPE vs the heuristic and report the mean normalized
    regret difference (negative = artifacts better).  Returned in the
    scaling provenance so a regression is visible in the committed
    artifact itself.

    The artifact arm must run on the models just written: where a
    written model does not load (sklearn absent or version-skewed), the
    optimizer would keep the heuristic for it and both arms would run the
    same rules, a difference of 0 that is no validation.  So that raises.
    ``seeds`` must cover the seeds of the repo's held-out artifact test."""
    import tempfile

    from ..algos import atpe as atpe_mod
    from ..base import Trials
    from ..fmin import fmin
    from . import domains as zoo

    with tempfile.TemporaryDirectory() as td:
        write_artifacts(models, dict(scaling), td)
        try:
            opt = atpe_mod._optimizer_for(td)
            if sorted(opt.models) != sorted(models) or opt.scaling is None:
                raise RuntimeError(
                    f"train_atpe: the held-out check loaded {sorted(opt.models)} of the "
                    f"written models {sorted(models)} (scaling "
                    f"{'loaded' if opt.scaling is not None else 'missing'}); "
                    "a model that does not load leaves the heuristic in both arms"
                )
            diffs = []
            for dname in HELD_OUT:
                d = zoo.get(dname)
                for seed in seeds:
                    finals = {}
                    for kind, mdir in (("artifact", td), ("heuristic", "")):
                        trials = Trials()
                        fmin(
                            d.fn, d.space,
                            algo=partial(atpe_mod.suggest, model_dir=mdir, device=device),
                            max_evals=max_evals, trials=trials,
                            rstate=np.random.default_rng(seed),
                            show_progressbar=False, verbose=False,
                        )
                        finals[kind] = min(
                            l for l in trials.losses() if l is not None
                        )
                    scale = abs(finals["heuristic"]) + 0.1
                    diff = (finals["artifact"] - finals["heuristic"]) / scale
                    diffs.append(diff)
                    log(f"  held-out {dname}/s{seed}: artifact={finals['artifact']:.4g} "
                        f"heuristic={finals['heuristic']:.4g} diff={diff:+.3f}")
            return float(np.mean(diffs))
        finally:
            # the directory goes away; a later one may reuse its name
            atpe_mod._optimizer_cache.pop(td, None)


def write_artifacts(models, scaling, out_dir):
    # atomic replaces: a sweep interrupted mid-write must never leave a
    # torn artifact that the ATPE suggest path would then unpickle
    from ..parallel.file_trials import _atomic_write

    os.makedirs(out_dir, exist_ok=True)
    _atomic_write(
        os.path.join(out_dir, "scaling_model.json"),
        json.dumps(scaling, indent=1, sort_keys=True).encode(),
    )
    for target, model in models.items():
        _atomic_write(
            os.path.join(out_dir, f"model-{target}.pkl"),
            pickle.dumps(model),
        )


def _fit_validate_write(rows, out, device=None):
    """Fit → held-out validation → write, with provenance — the ONE
    artifact-writing sequence (both the direct path and --fit-from go
    through it, so written artifacts always carry provenance and a
    held-out score)."""
    if not rows:
        print("train_atpe: empty corpus, nothing written", file=sys.stderr)
        return 1
    rows = relabel_rows(rows)  # idempotent; upgrades shards on scheme changes
    models, scaling = fit_models(rows)
    held = _held_out_regret(models, scaling, device=device)
    scaling["provenance"] = {
        "train_domains": sorted(
            {f.get("_domain", "?") for f, _ in rows}
        ),
        "held_out_domains": list(HELD_OUT),
        "held_out_mean_regret_diff": held,
    }
    write_artifacts(models, scaling, out)
    print(
        f"train_atpe: wrote {len(models)} models + scaling to {out} "
        f"(corpus_rows={scaling['corpus_rows']}, "
        f"held_out_mean_regret_diff={held:+.3f})"
    )
    return 0


def main(argv=None):
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="artifact directory")
    ap.add_argument("--quick", action="store_true", help="tiny CI-smoke corpus")
    ap.add_argument("--domains", nargs="*", default=None)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument(
        "--seed-offset", type=int, default=0,
        help="first seed (shards of one corpus use disjoint seed ranges)",
    )
    ap.add_argument("--configs", type=int, default=32)
    ap.add_argument("--cont-evals", type=int, default=15)
    ap.add_argument(
        "--checkpoints", type=int, nargs="*", default=None,
        help="snapshot sizes (default 20 45)",
    )
    ap.add_argument(
        "--rows-out", default=None,
        help="build the corpus shard, pickle the rows here, and exit "
        "(no model fitting, no sklearn needed)",
    )
    ap.add_argument(
        "--fit-from", nargs="*", default=None,
        help="skip corpus building; load row pickles, fit, validate on "
        "the held-out domains, and write artifacts",
    )
    ap.add_argument(
        "--device", default=None,
        help="where the suggests run (default: the CUDA card; 'cpu' for "
        "the CPU, never chosen on its own)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from ..algos.atpe import DEFAULT_MODEL_DIR

    out = args.out or DEFAULT_MODEL_DIR
    if args.quick:
        domains = args.domains or ["quadratic1", "gauss_wave2"]
        seeds, checkpoints = [0], (20,)
        n_configs, cont = 6, 6
    else:
        domains = args.domains or list(DEFAULT_DOMAINS)
        seeds = list(range(args.seed_offset, args.seed_offset + args.seeds))
        checkpoints = tuple(args.checkpoints or (20, 45))
        n_configs, cont = args.configs, args.cont_evals

    if args.fit_from or not args.rows_out:
        require_sklearn()  # before hours of corpus building, not after
    if args.fit_from:
        rows = load_rows(args.fit_from)
        print(f"train_atpe: fitting from {len(args.fit_from)} shards, "
              f"{len(rows)} rows")
        return _fit_validate_write(rows, out, device=device)

    print(
        f"train_atpe: {len(domains)} domains x seeds {seeds[0]}..{seeds[-1]} x "
        f"{len(checkpoints)} checkpoints x {n_configs} configs "
        f"x {cont} continuation evals on {device} -> {args.rows_out or out}"
    )
    rows = build_corpus(domains, seeds, checkpoints, n_configs, cont, device=device)
    if not rows:
        print("train_atpe: empty corpus, nothing written", file=sys.stderr)
        return 1
    if args.rows_out:
        save_rows(rows, args.rows_out)
        print(f"train_atpe: saved {len(rows)} rows to {args.rows_out}")
        return 0
    return _fit_validate_write(rows, out, device=device)


if __name__ == "__main__":
    sys.exit(main())
