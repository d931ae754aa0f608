"""Time builds of the port's score kernels against each other on one card.

    python3 torch_kernel_variants.py NAME=DIR [NAME=DIR ...] [--rounds 5]

Each DIR holds ``pair_score.cu`` and ``fused_suggest.cu`` with their
headers: ``hyperopt_tpu_torch/csrc`` itself, an earlier commit's unpacked
into the git-ignored ``build/``, or an experiment kept out of the
repository.  Every source is built with ``ops/kernel_build.py``'s command
(one ``nvcc`` each, all started together), bound and launched through the
wrappers' own ``bind`` and ``_launch`` (so the C interface and the scratch
are the wrappers'), checked once against the plain version, then timed in
``--rounds`` turns (every build and shape once per round, in order), so
builds are compared only within one run on one card.

Shapes: the pair-score kernel at the main path's widths at L=2 (the
default tier's launch) and L=1 (the single-label launch), at
``__graft_entry__``'s single-label size (C=256, K=82) and with many small
labels (L=8, C=1024, K=514); the fused kernel at the main family shape
with k=1 and k=4, and at C=256, K=88.

Prints the card's ``nvidia-smi`` line, then one JSON line per build and
shape: the ``-Xptxas -v`` summary, the largest error against the plain
version with its allowance (``chip_smoke.TOLERANCE``), for the fused
kernel whether its winners equal the argmax over the same build's
pair-score kernel's scores, and the medians and every round of the event
ms per call (``chip_smoke.cuda_ms``, which spans the wrapper's host work)
and of the profiler's device ms per launch
(``chip_smoke.device_ms_per_launch``, the kernels alone).  With ``--clock
NAME``, the SM clock and power that ``nvidia-smi`` reads while that
build's L=2 launch loops.  Needs one card.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

import chip_smoke as cs
from hyperopt_tpu_torch.ops import fused_kernel, kernel_build, pair_kernel
from hyperopt_tpu_torch.ops.score import pair_score

OUT = Path(__file__).resolve().parent / "build" / "variants"
KERNELS = ("pair_score", "fused_suggest")
PAIR_SHAPES = {
    "pair_L2": dict(cs.MAIN_SHAPE),
    "pair_L1": dict(cs.MAIN_SHAPE, L=1),
    "pair_L1_C256_K82": dict(L=1, C=256, kb=17, ka=65),
    "pair_L8_C1024_K514": dict(L=8, C=1024, kb=33, ka=481),
}
FUSED_SHAPES = {  # chip_smoke.fused_inputs arguments
    "fused_k1": cs.FUSED_SHAPES[0][1:],
    "fused_k4": cs.FUSED_SHAPES[2][1:],
    "fused_C256_K88": (15, 63, 1, 256, False, -2.0, 2.0),
}


def build_all(dirs):
    """``{(name, kernel): (CDLL, ptxas summary)}``, one nvcc per source, all
    started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, d in dirs.items():
        for kernel in KERNELS:
            lib = OUT / f"lib{kernel}-{name}.so"
            cmd = kernel_build.nvcc_command(Path(d) / f"{kernel}.cu", lib)
            jobs[name, kernel] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for key, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        built[key] = (ctypes.CDLL(str(lib)), cs.ptxas_summary(log))
    return built


def pair_runner(lib, shape):
    """A call of the build's pair-score launch, checked against the plain
    version."""
    fn = pair_kernel.bind(lib)
    z, params = cs.pair_case(seed=4, **shape)
    kb = shape["kb"]
    out = pair_kernel._launch(z, params, kb, fn=fn)
    torch.cuda.synchronize()
    ref = pair_score(z, params, kb)
    allow, _ = cs.allowance(ref, pair_score(z.double(), params.double(), kb))
    err = (out - ref).abs()
    return (lambda: pair_kernel._launch(z, params, kb, fn=fn), ["pair_score_kernel"],
            {"max_abs_err": float(err.max()), "ok": bool((err <= allow).all())})


def fused_runner(lib, pair_lib, spec):
    """A call of the build's fused launch with the candidates passed in,
    checked against the plain version, its winners against the argmax over
    the same build's pair-score kernel (``pair_lib``)."""
    fn = fused_kernel.bind(lib)
    inp = cs.fused_inputs(*spec, seed=4)
    x, params, kb, k, n_top = inp["cands"], inp["params"], inp["kb"], inp["k"], 16
    log_scale = inp["log_scale"]

    def run():
        return fused_kernel._launch(x, None, None, params, kb, k, n_top, log_scale, False,
                                    fn=fn)

    got = run()
    z = torch.log(x.clamp(min=fused_kernel.EPS)) if log_scale else x
    scores = pair_kernel._launch(z, params, kb, fn=pair_kernel.bind(pair_lib))
    torch.cuda.synchronize()
    plain = fused_kernel.fused_suggest_plain(x, None, None, params, kb, k, n_top, log_scale)
    ref = pair_score(z, params, kb)
    allow, _ = cs.allowance(ref, pair_score(z.double(), params.double(), kb))
    err = max(float((got[2] - plain[2]).abs().max()), float((got[4] - plain[4]).abs().max()))
    winners = torch.argmax(scores.reshape(x.shape[0], k, -1), dim=2)
    same_idx = bool(torch.equal(got[1].long(), winners))
    return run, ["fused_tile_kernel", "fused_merge_kernel"], {
        "max_abs_err": err, "idx_equal_kernel_argmax": same_idx,
        "ok": err <= float(allow.max()) and same_idx}


def sm_clock_under(run, seconds=2.0):
    """``nvidia-smi`` samples of the SM clock (MHz) and power draw (W) while
    ``run`` loops on the card for ``seconds``."""
    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout.strip()
            samples.append([float(x) for x in out.split(",")])
            time.sleep(0.1)

    th = threading.Thread(target=poll)
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(100):
            run()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    return samples


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--clock", metavar="NAME",
                    help="also sample the SM clock while build NAME's L=2 launch loops")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dirs = dict(b.split("=", 1) for b in args.builds)
    print(cs.nvidia_smi("name,power.limit,clocks.max.sm"), flush=True)
    t0 = time.perf_counter()
    built = build_all(dirs)
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)
    runs = []  # (name, shape, run, kernel names, row)
    for name in dirs:
        cases = [(s, lambda s=s: pair_runner(built[name, "pair_score"][0], PAIR_SHAPES[s]),
                  built[name, "pair_score"][1]) for s in PAIR_SHAPES]
        cases += [(s, lambda s=s: fused_runner(built[name, "fused_suggest"][0],
                                                built[name, "pair_score"][0], FUSED_SHAPES[s]),
                   built[name, "fused_suggest"][1]) for s in FUSED_SHAPES]
        for shape, make, ptx in cases:
            run, names, row = make()
            runs.append((name, shape, run, names, {"build": name, "shape": shape, **ptx, **row,
                                                   "ms_rounds": [], "device_ms_rounds": []}))
    for _ in range(args.rounds):
        for _, _, run, names, row in runs:
            row["ms_rounds"].append(cs.cuda_ms(run, iters=args.iters))
            row["device_ms_rounds"].append(cs.device_ms_per_launch(run, names)[0])
    for _, _, _, _, row in runs:
        print(json.dumps({**row, "ms": median(row["ms_rounds"]),
                          "device_ms": median(row["device_ms_rounds"])}), flush=True)
    for name, shape, run, _, _ in runs:
        if name == args.clock and shape == "pair_L2":
            samples = sm_clock_under(run)
            print(json.dumps({"build": name, "shape": shape,
                              "sm_mhz_median": median(x[0] for x in samples),
                              "samples_mhz_w": samples}), flush=True)
    return 0 if all(r[4]["ok"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
