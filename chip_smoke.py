"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each (a failed phase raises and the script exits
non-zero without the final line):

1. ``card``: the card's name and power limit (``nvidia-smi``), versions.
2. ``build``: every CUDA kernel of the main path built from ``csrc/`` in
   this checkout, one ``nvcc`` per source started together; seconds and
   the ``-Xptxas -v`` registers, shared memory and spills.
3. ``kernel_vs_plain``: each kernel against its plain PyTorch version on
   the card, at the main-path shape and at edge shapes.
4. ``suggest_vs_cpu``: ``tpe.suggest`` on the card against the same call
   on the CPU (plain versions), both fed one set of uniform streams.
5. ``main_path``: ``fmin(..., algo=partial(tpe.suggest,
   n_EI_candidates=8192))`` over bench.py's 5-label space with a
   10,000-trial prefilled history, a few suggests past it; the kernels'
   launch counts are set to 0 just before and read just after.
6. ``profile``: device time by kernel of a few more suggests at that
   history (``torch.profiler``) and the device's busy share.
7. ``quickstart``: the README quick-start space (index families,
   startup then TPE) for 40 evals.
8. ``timing``: each kernel, its plain version and one PyTorch library call
   computing the same function, by CUDA events at the main-path shape.

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of
``hyperopt_tpu``; needs one card.
"""

import json
import math
import os
import re
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NEG_BIG = -1e30
# the main path at bench.py's size: 10,000-trial history, 8192 candidates,
# gamma 0.25, linear forgetting 25 -> Kb = bucket(25)+1, Ka = bucket(10000)+1
N_HISTORY = 10_000
N_SUGGESTS = 8
N_CAND = 8192
MAIN_SHAPE = dict(L=2, C=8192, kb=33, ka=16385)
# kernel vs plain, per score: atol 1e-4 + rtol 1e-5 for the summation order
# of a long logsumexp, plus twice the plain f32 version's own largest
# error against its f64 evaluation on the same inputs: the quadratic form
# z²·p0 + z·p1 + p2 cancels terms of ~1e5 at narrow sigmas, so two f32
# evaluations (the kernel's FMAs, the plain matmul) differ by ~1e-3 there
TOLERANCE = "|kernel - plain| <= 1e-4 + 1e-5*|plain| + 2*max|plain_f32 - plain_f64|"


def allowance(ref, ref64):
    """Per-score tolerance of TOLERANCE and the plain f32 version's largest
    error against f64 over scores of regions with real mass."""
    live = ref64.abs() < 1e20
    plain_err = float((ref.double() - ref64).abs()[live].max())
    return 1e-4 + 1e-5 * ref.abs() + 2 * plain_err, plain_err


# H100 SXM, NVIDIA data sheet: f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# operations per (candidate, component) cell: 2 FMA (4 flops) for the
# quadratic, then subtract, exp, multiply-add/add of the online logsumexp
OPS_PER_CELL = 8


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bench_space(hp):
    return {
        "lr": hp.loguniform("lr", np.log(1e-5), np.log(1.0)),
        "momentum": hp.uniform("momentum", 0.0, 1.0),
        "width": hp.quniform("width", 32, 1024, 32),
        "sigma": hp.lognormal("sigma", 0.0, 1.0),
        "z": hp.normal("z", 0.0, 3.0),
    }


def quickstart_space(hp):
    return {
        "lr": hp.loguniform("lr", np.log(1e-5), np.log(1e-1)),
        "layers": hp.uniformint("layers", 1, 8),
        "arch": hp.choice("arch", [
            {"kind": "mlp", "width": hp.quniform("width", 64, 1024, 64)},
            {"kind": "cnn", "kernel": hp.choice("kernel", [3, 5, 7])},
        ]),
    }


def bench_objective(c):
    return ((np.log(c["lr"]) + 7.0) ** 2 + (c["momentum"] - 0.9) ** 2
            + (c["width"] - 256.0) ** 2 / 1e5 + np.log(c["sigma"]) ** 2
            + 0.1 * c["z"] ** 2)


def check_bench_values(vals):
    assert 1e-5 <= vals["lr"] <= 1.0 and 0.0 <= vals["momentum"] <= 1.0, vals
    assert vals["width"] % 32 == 0 and 32 <= vals["width"] <= 1024, vals
    assert vals["sigma"] > 0 and math.isfinite(vals["z"]), vals


def prefilled_trials(T, n, seed=0):
    """``n`` completed trials over the bench space, drawn by the port's
    own sampler on the card."""
    domain = T.Domain(bench_objective, bench_space(T.hp))
    vals, _ = domain.space.sample_batch(seed, n)
    losses = np.random.default_rng(seed).standard_normal(n)
    docs = []
    for i in range(n):
        cfg = {k: float(vals[k][i]) for k in vals}
        docs.append({
            "tid": i, "spec": None,
            "result": {"status": T.STATUS_OK, "loss": float(losses[i])},
            "misc": {"tid": i, "cmd": None, "idxs": {k: [i] for k in cfg},
                     "vals": {k: [v] for k, v in cfg.items()}},
            "state": T.JOB_STATE_DONE, "owner": None, "book_time": None,
            "refresh_time": None, "exp_key": None,
        })
    trials = T.Trials()
    trials._insert_trial_docs(docs)
    trials.refresh()
    return trials


def pair_case(L, C, kb, ka, seed, real_b=None, real_a=None, dead_below=False):
    """Scores' inputs ``(z [L, C], params [L, 3, kb+ka])`` on the card:
    Parzen-like mixtures whose first ``real_*`` components are real and
    the rest padding (weight 0, NEG_BIG logcoef), candidates over the
    mixtures' range.  ``dead_below``: label 0's below region is all
    padding."""
    from hyperopt_tpu_torch.ops.score import pair_params

    g = torch.Generator().manual_seed(seed)

    def mixture(k, real):
        w = torch.rand(L, k, generator=g) + 0.05
        w[:, real:] = 0.0
        w = w / w.sum(dim=1, keepdim=True).clamp(min=1e-12)
        mu = torch.randn(L, k, generator=g) * 2.0
        sigma = torch.rand(L, k, generator=g) * 0.5 + 0.01
        return w, mu, sigma

    wb, mb, sb = mixture(kb, kb if real_b is None else real_b)
    if dead_below:
        wb[0] = 0.0
    wa, ma, sa = mixture(ka, ka if real_a is None else real_a)
    z = torch.rand(L, C, generator=g) * 10.0 - 5.0
    return z.cuda(), pair_params(wb, mb, sb, wa, ma, sa).contiguous().cuda()


EDGE_SHAPES = {
    "kb1": dict(L=2, C=70, kb=1, ka=40),
    "ragged": dict(L=2, C=8191, kb=33, ka=1025, real_a=1000),
    "padded_regions": dict(L=2, C=300, kb=33, ka=4097, real_b=26, real_a=3001),
    "dead_below": dict(L=2, C=257, kb=9, ka=300, dead_below=True),
    "l3": dict(L=3, C=1000, kb=17, ka=2049, real_a=2000),
}


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def ptxas_summary(log):
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    smem = [int(x) for x in re.findall(r"(\d+) bytes smem", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    return {"registers": max(regs, default=None), "smem_bytes": max(smem, default=None),
            "spill_bytes": sum(spills)}


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_build():
    from hyperopt_tpu_torch.ops import kernel_build

    names = ["pair_score"]
    for name in names:  # build from the sources, never from an old library
        kernel_build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    report = kernel_build.build(names)
    emit("build", seconds=time.perf_counter() - t0,
         kernels={n: {"seconds": r["seconds"], **ptxas_summary(r["ptxas"])}
                  for n, r in report.items()})


def phase_kernel_vs_plain():
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched
    from hyperopt_tpu_torch.ops.score import pair_score

    main_err = None
    for name, shape in {"main": MAIN_SHAPE, **EDGE_SHAPES}.items():
        z, params = pair_case(seed=len(name), **shape)
        got = pair_score_batched(z, params, shape["kb"])
        ref = pair_score(z, params, shape["kb"])
        ref64 = pair_score(z.double(), params.double(), shape["kb"])
        torch.cuda.synchronize()
        assert got.shape == ref.shape and bool(torch.isfinite(got).all()), name
        err = (got - ref).abs()
        allow, plain_f32_err = allowance(ref, ref64)
        live = ref64.abs() < 1e20  # scores of regions with real mass
        row = {
            "max_abs_err": float(err.max()),
            "max_rel_err": float((err / ref.abs().clamp(min=1e-30)).max()),
            "kernel_vs_f64_err": float((got.double() - ref64).abs()[live].max()),
            "plain_vs_f64_err": plain_f32_err,
            "ok": bool((err <= allow).all()),
        }
        if name == "main":
            main_err = row["max_abs_err"]
        emit("kernel_vs_plain", shape=name, **shape, **row, tolerance=TOLERANCE)
        assert row["ok"], (name, row)
    return main_err


def phase_suggest_vs_cpu(T):
    """The port's suggest on the card (CUDA kernel) and on the CPU (plain
    versions) from one set of uniform streams: winners agree."""
    from hyperopt_tpu_torch.algos import tpe as ttpe

    draw = ttpe._label_uniforms

    def cpu_streams(seed, n_labels, n, device):
        return draw(seed, n_labels, n, "cpu").to(device)

    trials = prefilled_trials(T, 300, seed=1)
    domain = T.Domain(bench_objective, bench_space(T.hp))
    ttpe._label_uniforms = cpu_streams
    try:
        pairs, close = 0, 0
        for seed in range(5):
            out = {}
            for dev in ("cuda", "cpu"):
                docs = T.tpe.suggest([300], domain, trials, seed, n_EI_candidates=512,
                                     device=dev)
                out[dev] = {k: v[0] for k, v in docs[0]["misc"]["vals"].items()}
            for lb in out["cpu"]:
                pairs += 1
                close += bool(np.isclose(out["cuda"][lb], out["cpu"][lb], rtol=1e-5))
    finally:
        ttpe._label_uniforms = draw
    emit("suggest_vs_cpu", pairs=pairs, equal_to_rtol_1e_5=close)
    assert close >= 0.9 * pairs, (close, pairs)


def phase_main_path(T, counters):
    trials = prefilled_trials(T, N_HISTORY)
    times = []

    def timed_suggest(new_ids, domain, trials_, seed):
        t0 = time.perf_counter()
        docs = T.tpe.suggest(new_ids, domain, trials_, seed, n_EI_candidates=N_CAND)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return docs

    for c in counters:
        c.launches = 0
    T.fmin(bench_objective, bench_space(T.hp), algo=timed_suggest,
           max_evals=N_HISTORY + N_SUGGESTS, trials=trials,
           rstate=np.random.default_rng(0), show_progressbar=False)
    launches = {c.__name__: c.launches for c in counters}
    assert len(trials.trials) == N_HISTORY + N_SUGGESTS
    for doc in trials.trials[N_HISTORY:]:
        check_bench_values({k: v[0] for k, v in doc["misc"]["vals"].items()})
        assert math.isfinite(doc["result"]["loss"])
    assert launches["pair_score_batched"] == 2 * N_SUGGESTS, launches
    steady = float(np.median(times[1:]))
    emit("main_path", n_history=N_HISTORY, n_suggests=N_SUGGESTS, n_EI_candidates=N_CAND,
         launches=launches, launches_per_suggest=launches["pair_score_batched"] / N_SUGGESTS,
         suggest_ms_first=times[0], suggest_ms_steady=steady, suggest_ms_all=times)
    return launches, trials, steady


def phase_profile(T, trials, steady_ms, n=3):
    """Where a steady-state suggest's time goes at the main path's history:
    device time by kernel (``torch.profiler``) against the unprofiled
    host-clock time of ``main_path``."""
    from torch.profiler import ProfilerActivity, profile

    domain = T.Domain(bench_objective, bench_space(T.hp))
    base = len(trials.trials)

    def suggest(i):
        T.tpe.suggest([base + i], domain, trials, 1000 + i, n_EI_candidates=N_CAND)

    suggest(n)  # this domain's first suggest uploads the history
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            suggest(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [
        (a.key, getattr(a, "self_device_time_total", 0.0) / 1e3 / n, a.count / n)
        for a in prof.key_averages() if str(a.device_type).endswith("CUDA")
    ]
    device_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    emit("profile", n_suggests=n, profiled_wall_ms_per_suggest=wall_ms,
         device_ms_per_suggest=device_ms if device_ms else "not measured",
         device_busy_share=device_ms / steady_ms if device_ms else "not measured",
         device_kernels_per_suggest=sum(c for _, _, c in kernels),
         top=[{"kernel": k[:80], "ms": ms, "per_suggest": c} for k, ms, c in top])


def phase_quickstart(T, counters):
    for c in counters:
        c.launches = 0
    trials = T.Trials()
    T.fmin(bench_like_quickstart_objective, quickstart_space(T.hp),
           algo=partial(T.tpe.suggest, n_startup_jobs=10), max_evals=40, trials=trials,
           rstate=np.random.default_rng(0), show_progressbar=False)
    assert len(trials.trials) == 40
    for doc in trials.trials:
        v = {k: x[0] for k, x in doc["misc"]["vals"].items() if x}
        assert 1e-5 <= v["lr"] <= 1e-1 and 1 <= v["layers"] <= 8, v
        assert (v["arch"] == 0 and v["width"] % 64 == 0 and "kernel" not in v) or (
            v["arch"] == 1 and v["kernel"] in (0, 1, 2) and "width" not in v), v
    launches = {c.__name__: c.launches for c in counters}
    assert launches["pair_score_batched"] == 30, launches  # one lr label, 30 TPE suggests
    emit("quickstart", evals=40, launches=launches)


def bench_like_quickstart_objective(c):
    return (np.log(c["lr"]) + 7.0) ** 2 + c["layers"] + c["arch"].get("width", 0) / 1024.0


def phase_timing(main_err, launches):
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched
    from hyperopt_tpu_torch.ops.score import pair_score

    s = MAIN_SHAPE
    z, params = pair_case(seed=4, **s)
    L, C, K, kb = s["L"], s["C"], s["kb"] + s["ka"], s["kb"]
    kernel_ms = cuda_ms(lambda: pair_score_batched(z, params, kb), iters=200)
    plain_ms = cuda_ms(lambda: pair_score(z, params, kb), iters=10)

    def library():
        # one f32 product materializing [L, C, K], then two logsumexps;
        # timed as a yardstick only, the port never calls it
        feats = torch.stack([z * z, z, torch.ones_like(z)], dim=-1)
        comp = torch.matmul(feats, params)
        return torch.logsumexp(comp[..., :kb], -1) - torch.logsumexp(comp[..., kb:], -1)

    library_ms = cuda_ms(library, iters=10)
    cells = L * C * K
    ops_ms = OPS_PER_CELL * cells / PEAK_F32_FLOPS * 1e3
    bytes_ms = 4 * (2 * L * C + 3 * L * K) / PEAK_BYTES * 1e3
    row = {
        "name": "pair_score_batched", "route": "cuda",
        "source": "hyperopt_tpu_torch/csrc/pair_score.cu",
        "replaces": "hyperopt_tpu/ops/pallas_gmm.py:127",
        "launches": launches["pair_score_batched"], "max_abs_err": main_err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
        "cells": cells, "ops_per_cell": OPS_PER_CELL,
    }
    emit("timing", shape=s, **{k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                                   "bound_ms", "bound_by")})
    return [row]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the plain versions and the library yardstick run IEEE f32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import hyperopt_tpu_torch as T
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched

    assert "jax" not in sys.modules and not any(
        m == "hyperopt_tpu" or m.startswith("hyperopt_tpu.") for m in sys.modules)
    counters = [pair_score_batched]
    smi = phase_card()
    phase_build()
    main_err = phase_kernel_vs_plain()
    phase_suggest_vs_cpu(T)
    launches, trials, steady_ms = phase_main_path(T, counters)
    phase_profile(T, trials, steady_ms)
    phase_quickstart(T, counters)
    kernels = phase_timing(main_err, launches)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
