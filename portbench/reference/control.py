"""The control of the check: the plain reference put in the program's
place, computing its scores one precision below the configuration's.

The port scores in float32, so the control scores in bfloat16: it makes
a cell's history as a run does, then ``--suggests`` suggests of its own
(``tpe_reference.reference_suggest``: draws from l, each scored in
bfloat16, the argmax), appending each trial with the objective's loss,
and hands them to the same comparison as a run (``check.judge``).  The
history is the one the cell's driver makes (``drivers.study_history``).
The numbers it prints are the control's readings; ``--dtype float64``
gives the reference's own.

    python3 portbench/reference/control.py --cell xgb-h10k.fmin50 --seed 3 [--device cuda]

The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.core import drivers, spaces  # noqa: E402
from portbench.core.registry import Bench  # noqa: E402
from portbench.reference import check  # noqa: E402
from portbench.reference import tpe_reference as ref  # noqa: E402


def run_control(cfg, loss, seed, n_suggests, device, dtype):
    labels, algo = cfg["labels"], cfg["algo"]
    n_cand = int(algo["n_EI_candidates"])
    vals, losses = drivers.study_history(cfg, loss, seed, device)
    st = {"history_vals": vals, "history_losses": losses, "trials": [], "window_from": 0}
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    for _ in range(n_suggests):
        hv = {lab["label"]: np.concatenate([st["history_vals"][lab["label"]],
                                            [t["vals"][lab["label"]] for t in st["trials"]]])
              for lab in labels}
        hl = np.concatenate([st["history_losses"], [t["stored_loss"] for t in st["trials"]]])
        vals = ref.reference_suggest(labels, hv, hl, algo, n_cand, gen, device, dtype)
        value = float(loss(spaces.point_from_vals(labels, vals)))
        st["trials"].append({"vals": vals, "stored_loss": value})
    return check.judge(cfg, loss, [st], 0, seed, device, sample=n_suggests)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--suggests", type=int, default=check.SAMPLE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32", "float64"))
    args = ap.parse_args()
    bench = Bench(ROOT)
    cell = bench.cell(args.cell)
    cfg, loss_module = bench.config(cell["config"])
    loss = loss_module.loss
    t0 = time.monotonic()
    numbers, info = run_control(cfg, loss, args.seed, args.suggests, args.device,
                                getattr(torch, args.dtype))
    print(json.dumps({"cell": args.cell, "seed": args.seed, "dtype": args.dtype,
                      "numbers": numbers, "info": info,
                      "seconds": round(time.monotonic() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
