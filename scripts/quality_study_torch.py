"""Whole-run regret check of the PyTorch/CUDA port against QUALITY.json.

Torch's Philox streams cannot reproduce JAX's threefry draws, so the
port's sampling is checked over whole runs: seeded ``fmin`` runs of the
port's TPE on the zoo domains ``quadratic1``, ``branin``, ``gauss_wave2``
and ``hartmann6`` (60 trials, seeds 0-3) at ``n_EI_candidates`` in
{24, 1024, 65536}.  For each (domain, c) the port's mean regret (best loss
minus the domain's optimum; the best loss where the optimum is unknown)
is held against the reference's seeds in ``QUALITY.json``
(``results["device/<domain>/c<N>"]["per_seed"]``, written by
``scripts/quality_study.py``): it may not lie above the reference's worst
seed.  ``QUALITY.json`` is only read.

Run (on the card by default):

    python scripts/quality_study_torch.py [--cands 24,1024,65536]
        [--device cuda|cpu] [--out-json QUALITY_TORCH.json]

Prints one JSON line per (domain, c) and writes every row, with the
reference's range and the verdict, to ``--out-json``.  Exits 1 when a
mean regret lies above the reference's worst seed.
"""

import argparse
import json
import os
import sys
import time
from functools import partial

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DOMAINS = ("quadratic1", "branin", "gauss_wave2", "hartmann6")
CAND_SIZES = (24, 1024, 65536)
SEEDS = (0, 1, 2, 3)
MAX_EVALS = 60
REFERENCE = os.path.join(REPO, "QUALITY.json")


def run_one(dname, n_cand, seed, device=None):
    """One seeded 60-trial ``fmin`` of the port's TPE on a zoo domain:
    ``(regret, seconds)``."""
    from hyperopt_tpu_torch import Trials, fmin
    from hyperopt_tpu_torch.algos import tpe
    from hyperopt_tpu_torch.models import domains as zoo

    d = zoo.get(dname)
    trials = Trials()
    t0 = time.perf_counter()
    fmin(
        d.fn, d.space,
        algo=partial(tpe.suggest, n_EI_candidates=n_cand, device=device),
        max_evals=MAX_EVALS, trials=trials,
        rstate=np.random.default_rng(seed), show_progressbar=False,
        verbose=False,
    )
    # NaN losses are diverged trials (gauss_wave2 emits them); they must
    # not poison the min
    best = min(v for v in trials.losses() if v is not None and not np.isnan(v))
    known = d.fmin is not None and np.isfinite(d.fmin)
    return float(best - d.fmin if known else best), time.perf_counter() - t0


def reference_rows(path=REFERENCE):
    with open(path) as f:
        return json.load(f)["results"]


def check_row(key, per_seed, ref):
    """The row of one (domain, c): the port's mean regret beside the
    reference's per-seed range; ``ok`` when it is at or below the
    reference's worst seed."""
    mean = float(np.mean(per_seed))
    worst = float(max(ref[key]["per_seed"]))
    return {
        "key": key,
        "mean_regret": mean,
        "per_seed": [float(r) for r in per_seed],
        "reference_per_seed": [float(r) for r in ref[key]["per_seed"]],
        "reference_mean": float(ref[key]["mean_regret"]),
        "reference_worst": worst,
        "ok": mean <= worst,
    }


def study(cands=CAND_SIZES, domains=DOMAINS, seeds=SEEDS, device=None, emit=None):
    """Every (domain, c) row of the check, in order."""
    ref = reference_rows()
    rows = []
    for dname in domains:
        for c in cands:
            regrets, secs = [], 0.0
            for seed in seeds:
                r, s = run_one(dname, c, seed, device)
                regrets.append(r)
                secs += s
            row = check_row(f"device/{dname}/c{c}", regrets, ref)
            row["wall_s"] = secs
            rows.append(row)
            if emit is not None:
                emit(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cands", default=",".join(map(str, CAND_SIZES)))
    ap.add_argument("--device", default=None,
                    help="device of the runs (default: the CUDA card)")
    ap.add_argument("--out-json", default="QUALITY_TORCH.json")
    args = ap.parse_args(argv)
    cands = tuple(int(c) for c in args.cands.split(","))

    import torch

    device = args.device or "cuda"
    kind = torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu"
    rows = study(cands, device=device,
                 emit=lambda row: print(json.dumps(row), flush=True))
    with open(args.out_json, "w") as f:
        json.dump({"meta": {"max_evals": MAX_EVALS, "seeds": list(SEEDS),
                            "domains": list(DOMAINS), "cand_sizes": list(cands),
                            "device": device, "device_kind": kind},
                   "rows": rows}, f, indent=1)
    faults = [r["key"] for r in rows if not r["ok"]]
    print(json.dumps({"ok": not faults, "faults": faults}), flush=True)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
