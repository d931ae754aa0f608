"""Seed spread of the regret check on the CPU, both packages side by side.

``scripts/quality_study_torch.py`` holds the port's mean regret over
seeds 0-3 to the reference's worst seed in ``QUALITY.json``.  Where a
(domain, c) misses that band, this script tells sampling noise from a
difference in the search: it runs the same 60-trial TPE ``fmin`` in the
JAX package and in the port (``device="cpu"``) over a wider range of
seeds and compares the two regret distributions (Mann-Whitney U and
two-sample KS), and the share of 4-seed means above the band.

    python scripts/regret_spread.py hartmann6 --cand 24 --seeds 0:192

Prints one JSON line.  Imports both packages (a comparison, like the
parity tests); the port itself never imports JAX.
"""

import argparse
import json
import os
import sys
import time
from functools import partial

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
from scipy import stats


def regrets(pkg, dname, n_cand, seeds):
    if pkg == "jax":
        from hyperopt_tpu import Trials, fmin
        from hyperopt_tpu.algos import tpe
        from hyperopt_tpu.models import domains as zoo
        algo = partial(tpe.suggest, n_EI_candidates=n_cand)
    else:
        from hyperopt_tpu_torch import Trials, fmin
        from hyperopt_tpu_torch.algos import tpe
        from hyperopt_tpu_torch.models import domains as zoo
        algo = partial(tpe.suggest, n_EI_candidates=n_cand, device="cpu")
    d = zoo.get(dname)
    out = []
    for seed in seeds:
        trials = Trials()
        fmin(d.fn, d.space, algo=algo, max_evals=60, trials=trials,
             rstate=np.random.default_rng(seed), show_progressbar=False, verbose=False)
        best = min(v for v in trials.losses() if v is not None and not np.isnan(v))
        out.append(float(best - d.fmin) if np.isfinite(d.fmin) else float(best))
    return np.array(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("domain")
    ap.add_argument("--cand", type=int, default=24)
    ap.add_argument("--seeds", default="0:192", help="start:stop, a multiple of 4 seeds")
    args = ap.parse_args(argv)
    lo, hi = (int(x) for x in args.seeds.split(":"))
    seeds = range(lo, hi)
    with open(os.path.join(REPO, "QUALITY.json")) as f:
        band = max(json.load(f)["results"][f"device/{args.domain}/c{args.cand}"]["per_seed"])
    t0 = time.perf_counter()
    jax, port = regrets("jax", args.domain, args.cand, seeds), regrets("torch", args.domain,
                                                                        args.cand, seeds)

    def above(r):
        return float((r[: len(r) // 4 * 4].reshape(-1, 4).mean(1) > band).mean())

    print(json.dumps({
        "domain": args.domain, "cand": args.cand, "seeds": [lo, hi],
        "jax_mean": float(jax.mean()), "jax_sd": float(jax.std()),
        "port_mean": float(port.mean()), "port_sd": float(port.std()),
        "mannwhitney_p": float(stats.mannwhitneyu(jax, port).pvalue),
        "ks_p": float(stats.ks_2samp(jax, port).pvalue),
        "band_reference_worst_seed": band,
        "share_of_4_seed_means_above_band": {"jax": above(jax), "port": above(port)},
        "seconds": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
