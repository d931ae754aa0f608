"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each (a failed phase raises and the script exits
non-zero without the final line):

1. ``card``: the card's name and power limit (``nvidia-smi``), versions.
2. ``build``: every CUDA kernel of the main paths built from ``csrc/`` in
   this checkout, one ``nvcc`` per source started together; seconds and
   the ``-Xptxas -v`` registers, shared memory and spills.
3. ``kernel_vs_plain``: the pair-score kernel against its plain PyTorch
   version on the card, at the main-path shape and at edge shapes (among
   them ATPE's floor, 8 candidates, and an 8-id suggest's 65,536).
4. ``fused_vs_plain``: the fused suggest kernel, in both draw modes, at the
   main-path shape, with k=4 segments, on the reference's shape grid and on
   ties: its winners equal the argmax over the pair-score kernel's scores
   bit for bit, its EI partials agree with its plain version, and its
   in-kernel draw with ``gmm_sample``.
5. ``suggest_vs_cpu``: ``tpe.suggest`` on the card against the same call
   on the CPU (plain versions), both fed one set of uniform streams.
6. ``main_path``: ``fmin(..., algo=partial(tpe.suggest,
   n_EI_candidates=8192))`` over bench.py's 5-label space with a
   10,000-trial prefilled history, a few suggests past it; the kernels'
   launch counts are set to 0 just before and read just after.
7. ``fused_main_path``: the same run under ``HYPEROPT_TPU_SCORER=fused``,
   then also with ``HYPEROPT_TPU_FUSED_DRAW=1``: its own launch counts,
   and the same trials as ``main_path``.
8. ``search_health``: the ``SearchStats`` of the default and fused runs
   agree label for label.
9. ``profile``: device time by kernel of a few more suggests at that
   history (``torch.profiler``) and the device's busy share, on the
   default and on the fused tier.
10. ``single_label``: ``tpe._continuous_best_core`` (one label's fit, draw,
    score, argmax) through the single-label pair-score launch, against the
    plain scorer.
11. ``quickstart``: the README quick-start space (index families,
    startup then TPE) for 40 evals, on the serial loop.
12. ``pipelined_main_path``: fmin's default pipelined path at the main
    path's size with ``partial(tpe.suggest, n_EI_candidates=8192)`` and
    the bench objective plus a 50 ms sleep, at ``max_speculation`` 0, 1
    and 2 from one ``rstate``: k=1 gives k=0's trials value for value,
    2 kernel launches per dispatched suggest, no failed speculation; wall
    ms per trial and the engine's ``SpeculationStats``.
13. ``multi_study``: four 10,000-trial studies prepared with
    ``tpe.suggest_prepare`` and dispatched by one
    ``multi_study_suggest_async``: each study's docs equal its unbatched
    suggest, 8 pair-score launches; ms of the batched dispatch against
    four sequential suggests.
14. ``fused_probe``: the fused kernel's timing probe through
    ``resolve_scorer`` on the card (unfused and fused ms, the verdict),
    then an unpinned suggest at the main path's history launches the
    kernel the verdict names.
15. ``multi_id_suggest``: ``tpe.suggest`` with 8 ids at the main path's
    history: one pair-score launch per unquantized family (2, not 16),
    the card's values against the CPU's from one set of uniform streams
    over 8 seeds (>= 80% equal to rtol 1e-5, every other value a near-tie
    under the CPU's own scorer), ms of the 8-id call against 8 single-id
    calls, in turns.
16. ``atpe_path``: serial ``fmin(algo=atpe.suggest)`` from the
    10,000-trial history, 8 suggests: per suggest the meta-parameters,
    locked labels, launches, ms and featurization ms; the meta-models
    loaded and the load warnings; then ``tpe.suggest`` with ATPE's locks
    and a result filter, card against CPU by the same rule.
17. ``anneal_mix``: ``anneal.suggest`` and ``mix.suggest`` over
    (0.5 tpe, 0.25 anneal, 0.25 rand), 16 evals each from a 1,000-trial
    history: values inside their supports, pair-score launches in a mix
    suggest exactly when it picked TPE.
18. ``parallel_backend``: ``TorchTrials(parallelism=8)``'s host plane at
    the main path's history (``tpe.suggest`` with 8192 candidates, the
    bench objective plus a 50 ms sleep, 32 evals): no error, 32 host
    trials, suggest calls with more than one id, 2 launches per call,
    wall ms per trial beside the serial loop's; then its device plane
    (``device_fn`` on the zoo's Branin, 64 evals): device batches only,
    each loss equal to the host objective to rel 1e-4.
19. ``timing``: each kernel, its plain version and one PyTorch library call
    computing the same function, by CUDA events at the main-path shape;
    the kernel's device ms per launch (``torch.profiler``); its bound, the
    larger of the f32 operations at the f32 peak, the issue slots and SFU
    time with the exps split at best between the SFU and the FMA pipe, and
    the bytes at the memory rate, and its share of that bound; beside it
    the SFU-only time and its share.

Every phase but ``fused_probe`` runs with ``HYPEROPT_TPU_FUSED_PROBE=0``,
so the probe does not change the tier the others measure.  Then the
``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of
``hyperopt_tpu``; needs one card.
"""

import contextlib
import json
import logging
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
DEV = "cuda"  # every tensor of the checks lies on the card
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
# quadratic, then subtract, scale, exp and add of the logsumexp
OPS_PER_CELL = 8
# the exp of every cell on the SFU: MUFU.EX2 returns 16 results per SM per
# clock on sm_90 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), at the card's top SM clock (nvidia-smi clocks.max.sm)
EX2_PER_SM_CLOCK = 16
# The schedulers issue 4 warp instructions per SM per clock (128 lanes).
# Besides its exp, a cell needs 6 issue slots under the precision contract
# (ROADMAP "Precision": d = c - m rounded in natural-log units, then scaled):
# 2 FFMA for the quadratic, FMNMX toward the max, FADD c - m, FMUL by
# log2 e, FADD into the sum.  An exp costs 1 slot and 8 lane-clocks of the
# SFU, or POLY_EXP_SLOTS slots on the FMA pipe as an f32 polynomial:
# clamp, round by 1.5 * 2^23 (2 FADD), the fraction (FADD), 5 FFMA of a
# degree-5 fit of 2^f on [-1/2, 1/2] (2.3e-7 relative, as ex2.approx's
# 2 ulp), one integer add of the exponent.
LANE_SLOTS_PER_SM_CLOCK = 128
SLOTS_PER_CELL = 6
POLY_EXP_SLOTS = 10


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


def prefilled_trials(T, n, seed=0, trials=None):
    """``n`` completed trials over the bench space, drawn by the port's
    own sampler on the card, inserted into ``trials`` (a new ``Trials``
    when None)."""
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
    trials = T.Trials() if trials is None else trials
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
    return z.to(DEV), pair_params(wb, mb, sb, wa, ma, sa).contiguous().to(DEV)


EDGE_SHAPES = {
    "kb1": dict(L=2, C=70, kb=1, ka=40),
    "ragged": dict(L=2, C=8191, kb=33, ka=1025, real_a=1000),
    "padded_regions": dict(L=2, C=300, kb=33, ka=4097, real_b=26, real_a=3001),
    "dead_below": dict(L=2, C=257, kb=9, ka=300, dead_below=True),
    "l3": dict(L=3, C=1000, kb=17, ka=2049, real_a=2000),
    # ATPE's floor: n_EI_candidates clipped to 8, a short history
    "atpe_floor": dict(L=2, C=8, kb=3, ka=257),
    # an 8-id suggest at the main path's history: 8 x 8192 candidates
    "eight_ids": dict(L=2, C=65536, kb=33, ka=16385),
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


def nvidia_smi(query, *fmt):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=" + ",".join(("csv", "noheader", *fmt))],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def phase_card():
    """The card's name and power limit, and its SM count and top SM clock
    (MHz) for the SFU bound."""
    smi = nvidia_smi("name,power.limit")
    card = {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "max_sm_mhz": float(nvidia_smi("clocks.max.sm", "nounits"))}
    emit("card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), **card,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi, card


def phase_build():
    from hyperopt_tpu_torch.ops import kernel_build

    names = ["pair_score", "fused_suggest"]
    for name in names:  # build from the sources, never from an old library
        kernel_build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    report = kernel_build.build(names)
    emit("build", seconds=time.perf_counter() - t0,
         kernels={n: {"seconds": r["seconds"], **ptxas_summary(r["ptxas"])}
                  for n, r in report.items()})


def phase_kernel_vs_plain():
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched, pair_score_single
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
            # the single-label launch (another candidates-per-warp instance)
            # gives row 0's bits
            one = pair_score_single(z[0].contiguous(), params[0].contiguous(), shape["kb"])
            row["single_launch_row0_bitwise"] = bool(torch.equal(one.view(torch.int32),
                                                                 got[0].view(torch.int32)))
            row["ok"] = row["ok"] and row["single_launch_row0_bitwise"]
        emit("kernel_vs_plain", shape=name, **shape, **row, tolerance=TOLERANCE)
        assert row["ok"], (name, row)
    return main_err


# the fused kernel's shapes: (name, kb_real, ka_real, k, n_cand, log_scale,
# lo, hi) with the below/above mixtures of kb_real + 1 + 3 and
# ka_real + 1 + 5 components (3 and 5 of them padding).  "main" and "k4"
# are the main path's (Kb = 33, Ka = 16385 at a 10,000-trial history);
# the rest is the reference's shape grid, scripts/fused_report.py:51-59
FUSED_SHAPES = [
    ("main", 29, 16379, 1, 8192, False, -2.0, 2.0),
    ("main_log", 29, 16379, 1, 8192, True, -3.0, 1.0),
    ("k4", 29, 16379, 4, 2048, False, -np.inf, np.inf),
    ("kb_edge_prior_only", 0, 40, 1, 24, False, -2.0, 2.0),
    ("kb_edge_one_obs", 1, 7, 2, 100, False, -2.0, 2.0),
    ("single_component_above", 6, 1, 1, 64, False, -2.0, 2.0),
    ("unbounded_normal", 5, 40, 2, 50, False, -np.inf, np.inf),
    ("log_scale_bounded", 25, 300, 4, 33, True, -3.0, 1.0),
    ("padding_heavy", 3, 17, 1, 24, False, -4.0, 4.0),
    ("tiled_100k", 25, 2 ** 17, 1, 256, False, -2.0, 2.0),
]
FUSED_TOLERANCE = ("per score (seg_m, seg_top, ei_max): the pair-score TOLERANCE; "
                   "ei_lme, log seg_s and log ei_mass: twice that")


def mixture_np(rng, k_real, pad):
    """scripts/fused_report.py's _mk_mixture: k_real observation
    components, the prior, and ``pad`` zero-weight padding slots."""
    n = k_real + 1 + pad
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    if pad:
        w[-pad:] = 0.0
    w = w / w.sum()
    return (w, rng.normal(0, 2, n).astype(np.float32),
            rng.uniform(0.3, 2.0, n).astype(np.float32))


def fused_inputs(kb_real, ka_real, k, n_cand, log_scale, lo, hi, seed, L=2):
    """The fused kernel's inputs on the card, made from ``seed``."""
    from hyperopt_tpu_torch.ops import gmm
    from hyperopt_tpu_torch.ops.score import pair_params

    rng = np.random.default_rng(seed)
    mix = [(mixture_np(rng, kb_real, 3), mixture_np(rng, ka_real, 5)) for _ in range(L)]

    def stack(side, i):
        return torch.tensor(np.stack([m[side][i] for m in mix])).to(DEV)

    B = [stack(0, i) for i in range(3)]
    A = [stack(1, i) for i in range(3)]
    low = torch.full((L,), lo, dtype=torch.float32, device=DEV)
    high = torch.full((L,), hi, dtype=torch.float32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    u = torch.rand((2, L, k * n_cand), generator=gen, device=DEV)
    cands = gmm.gmm_sample(u[0], u[1], *B, low, high, torch.zeros(L, device=DEV),
                           log_scale)
    return dict(
        u1=u[0].contiguous(), u2=u[1].contiguous(), cands=cands.contiguous(),
        rows=gmm.draw_param_rows(*B, low, high).contiguous(),
        params=pair_params(*B, *A).contiguous(), kb=B[0].shape[1], k=k, n_cand=n_cand,
        log_scale=log_scale)


def kernel_draws(inp):
    """Every candidate the fused kernel draws: with k = C segments of one
    candidate each, the winners are the draws."""
    from hyperopt_tpu_torch.ops.fused_kernel import fused_suggest

    C = inp["u1"].shape[1]
    return fused_suggest(inp["u1"], inp["u2"], inp["rows"], inp["params"], inp["kb"], k=C,
                         n_top=1, log_scale=inp["log_scale"], draw_in_kernel=True)[0]


def ulp_dist(a, b):
    """Distance in units in the last place between f32 tensors."""
    def key(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (key(a) - key(b)).abs()


def argmax_reference(x, inp):
    """``(win, idx)`` by the pair-score kernel and torch.argmax on
    candidates ``x``: the unfused chain the fused kernel replaces."""
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched

    L = x.shape[0]
    z = torch.log(x.clamp(min=1e-12)) if inp["log_scale"] else x
    s = pair_score_batched(z.contiguous(), inp["params"], inp["kb"])
    idx = torch.argmax(s.reshape(L, inp["k"], inp["n_cand"]), dim=2)
    win = x.reshape(L, inp["k"], inp["n_cand"]).gather(2, idx[:, :, None])[:, :, 0]
    return win, idx, s


def check_fused(name, inp, draw, n_top=16):
    """One shape and draw mode: bitwise winners against the pair-score
    kernel's argmax, and the EI partials (top ``n_top``) against the plain
    version."""
    from hyperopt_tpu_torch.ops.fused_kernel import (
        ei_from_partials,
        fused_suggest,
        fused_suggest_plain,
    )
    from hyperopt_tpu_torch.ops.score import pair_score

    kb, k, n_cand, ls = inp["kb"], inp["k"], inp["n_cand"], inp["log_scale"]
    args = ((inp["u1"], inp["u2"], inp["rows"]) if draw else (inp["cands"], None, None))
    got = fused_suggest(*args, inp["params"], kb, k, n_top, log_scale=ls, draw_in_kernel=draw)
    plain = fused_suggest_plain(*args, inp["params"], kb, k, n_top, log_scale=ls,
                                draw_in_kernel=draw)
    row = {}
    x = inp["cands"]
    if draw:
        x = kernel_draws(inp)
        d = ulp_dist(x, inp["cands"])
        row.update(draw_bit_equal_share=float((d == 0).double().mean()),
                   draw_max_ulp=int(d.max()))
    win_ref, idx_ref, _ = argmax_reference(x, inp)
    torch.cuda.synchronize()
    row["win_bitwise"] = bool(torch.equal(got[0].view(torch.int32), win_ref.view(torch.int32)))
    row["idx_bitwise"] = bool(torch.equal(got[1].long(), idx_ref))
    # the plain version's scores in f32 and f64 give the tolerance
    z = torch.log(x.clamp(min=1e-12)) if ls else x
    ref = pair_score(z, inp["params"], kb)
    ref64 = pair_score(z.double(), inp["params"].double(), kb)
    live = ref64.abs() < 1e20
    plain_err = float((ref.double() - ref64).abs()[live].max()) if bool(live.any()) else 0.0
    allow = 1e-4 + 1e-5 * float(ref.abs()[live].max()) + 2 * plain_err

    def err(a, b):
        a, b = a.double(), b.double()
        same = (a == b)  # equal infinities
        return float(torch.where(same, 0.0, (a - b).abs()).max())

    C, n_top = k * n_cand, min(n_top, k * n_cand)
    ei_got = ei_from_partials(*got[2:], C, n_top)
    ei_ref = ei_from_partials(*plain[2:], C, n_top)
    errs = {
        "seg_m": err(got[2], plain[2]), "seg_top": err(got[4], plain[4]),
        "log_seg_s": err(got[3].log(), plain[3].log()),
        "ei_max": err(ei_got[0], ei_ref[0]), "ei_lme": err(ei_got[1], ei_ref[1]),
        "log_ei_mass": err(ei_got[2].log(), ei_ref[2].log()),
    }
    limits = {"seg_m": allow, "seg_top": allow, "ei_max": allow, "ei_lme": 2 * allow,
              "log_seg_s": 2 * allow, "log_ei_mass": 2 * allow}
    row.update(allow=allow, errors=errs,
               partials_ok=all(errs[n] <= limits[n] for n in errs))
    ok = row["win_bitwise"] and row["idx_bitwise"] and row["partials_ok"]
    if draw:
        ok = ok and row["draw_bit_equal_share"] >= 0.99 and row["draw_max_ulp"] <= 2
    emit("fused_vs_plain", shape=name, draw_in_kernel=draw, kb=kb,
         ka=inp["params"].shape[2] - kb, k=k, n_cand=n_cand, n_top=n_top, log_scale=ls, ok=ok,
         **row,
         tolerance=FUSED_TOLERANCE)
    assert ok, (name, draw, row)
    return errs


def phase_fused_vs_plain():
    from hyperopt_tpu_torch.ops.fused_kernel import fused_suggest

    main_err = None
    for seed, (name, *spec) in enumerate(FUSED_SHAPES):
        inp = fused_inputs(*spec, seed=seed)
        for draw in (False, True):
            errs = check_fused(name, inp, draw)
            if name == "main" and not draw:
                main_err = max(errs.values())
    # n_top = 128 at L=1: the largest top set the merge kernel ranks (the
    # tiles' partials are 67 KB a segment)
    check_fused("main_l1_top128", fused_inputs(*FUSED_SHAPES[0][1:], seed=98, L=1), False,
                n_top=128)
    # ties: equal scores keep the first index, within a tile and across tiles
    inp = fused_inputs(*FUSED_SHAPES[0][1:], seed=99, L=1)
    _, idx, _ = argmax_reference(inp["cands"], inp)
    i_best = int(idx[0, 0])
    ties = inp["cands"].clone()
    for i in (i_best ^ 1, (i_best + 197) % inp["n_cand"]):  # same tile, another tile
        ties[0, i] = ties[0, i_best]
    expect = int((ties[0] == ties[0, i_best]).nonzero()[0])
    got = fused_suggest(ties.contiguous(), None, None, inp["params"], inp["kb"], 1)
    same = torch.full((1, 200), 0.25, device=DEV)  # every score ties
    got_same = fused_suggest(same, None, None, inp["params"], inp["kb"], 1)
    torch.cuda.synchronize()
    row = {"tie_expect": expect, "tie_got": int(got[1][0, 0]),
           "all_equal_got": int(got_same[1][0, 0])}
    emit("fused_vs_plain", shape="ties", **row)
    assert row["tie_got"] == expect and row["all_equal_got"] == 0, row
    return main_err


def phase_suggest_vs_cpu(T):
    """The port's suggest on the card (CUDA kernel) and on the CPU (plain
    versions) from one set of uniform streams: winners agree."""
    trials = prefilled_trials(T, 300, seed=1)
    domain = T.Domain(bench_objective, bench_space(T.hp))
    pairs, close, _ = card_agrees_with_cpu(T, domain, trials, [300], range(5),
                                           n_EI_candidates=512)
    emit("suggest_vs_cpu", pairs=pairs, equal_to_rtol_1e_5=close)
    assert close >= 0.9 * pairs, (close, pairs)


@contextlib.contextmanager
def scorer_env(**env):
    """Set the scorer switches (``HYPEROPT_TPU_*``) for one run."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def recording_stats(T):
    """A ``SearchStats`` that also keeps every suggest's snapshot."""
    from hyperopt_tpu_torch.diagnostics import SearchStats

    class Recording(SearchStats):
        def record_suggest(self, snapshot=None):
            super().record_suggest(snapshot)
            if snapshot is not None:
                self.snapshots.append(snapshot)

    stats = Recording()
    stats.snapshots = []
    return stats


def drive_main_path(T, counters, stats):
    """fmin at the 10,000-trial history for N_SUGGESTS suggests, the launch
    counts set to 0 just before and read just after; host-clock ms per
    suggest."""
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
           rstate=np.random.default_rng(0), show_progressbar=False, search_stats=stats)
    launches = {c.__name__: c.launches for c in counters}
    assert len(trials.trials) == N_HISTORY + N_SUGGESTS
    for doc in trials.trials[N_HISTORY:]:
        check_bench_values({k: v[0] for k, v in doc["misc"]["vals"].items()})
        assert math.isfinite(doc["result"]["loss"])
    assert len(stats.snapshots) == N_SUGGESTS, len(stats.snapshots)
    return launches, trials, times


def suggested(trials):
    return [doc["misc"]["vals"] for doc in trials.trials[N_HISTORY:]]


def phase_main_path(T, counters):
    stats = recording_stats(T)
    launches, trials, times = drive_main_path(T, counters, stats)
    assert launches["pair_score_batched"] == 2 * N_SUGGESTS, launches
    assert launches["fused_suggest"] == 0, launches
    steady = float(np.median(times[1:]))
    emit("main_path", n_history=N_HISTORY, n_suggests=N_SUGGESTS, n_EI_candidates=N_CAND,
         launches=launches, launches_per_suggest=launches["pair_score_batched"] / N_SUGGESTS,
         suggest_ms_first=times[0], suggest_ms_steady=steady, suggest_ms_all=times)
    return launches, trials, steady, stats


def phase_fused_main_path(T, counters, ref_trials):
    """The main path on the fused tier, with the candidates drawn by
    gmm_sample and then in the kernel: 2 fused launches per suggest (one per
    unquantized family), none of the pair-score kernel, and the same
    suggestions as the default tier."""
    runs = {}
    for draw in ("0", "1"):
        stats = recording_stats(T)
        with scorer_env(HYPEROPT_TPU_SCORER="fused", HYPEROPT_TPU_FUSED_DRAW=draw):
            launches, trials, times = drive_main_path(T, counters, stats)
        same = [a == b for a, b in zip(suggested(trials), suggested(ref_trials))]
        steady = float(np.median(times[1:]))
        emit("fused_main_path", fused_draw=draw == "1", n_history=N_HISTORY,
             n_suggests=N_SUGGESTS, launches=launches,
             launches_per_suggest=launches["fused_suggest"] / N_SUGGESTS,
             trials_equal_to_main_path=sum(same), suggest_ms_first=times[0],
             suggest_ms_steady=steady, suggest_ms_all=times)
        assert launches["fused_suggest"] == 2 * N_SUGGESTS, launches
        assert launches["pair_score_batched"] == 0, launches
        assert all(same), same
        runs[draw] = (launches, trials, steady, stats)
    return runs


def phase_search_health(ref_stats, fused_runs):
    """The default and fused runs' SearchStats: the same labels and split
    counts, and EI columns within rtol 1e-4, atol 1e-5 (the reference's bar,
    tests/test_fused_kernel.py:191), suggest for suggest."""
    worst = 0.0
    for draw, (_, _, _, stats) in fused_runs.items():
        for ref, got in zip(ref_stats.snapshots, stats.snapshots):
            assert ref["labels"].keys() == got["labels"].keys()
            for lb, r in ref["labels"].items():
                g = got["labels"][lb]
                assert (r["nb"], r["na"]) == (g["nb"], g["na"]), (lb, r, g)
                for col in (
                    lambda d: d["ei_max"], lambda d: d["ei_max"] - d["ei_flatness"],
                    lambda d: d["ei_top_mass"],
                ):
                    a, b = col(r), col(g)
                    assert abs(a - b) <= 1e-5 + 1e-4 * abs(a), (draw, lb, a, b)
                    worst = max(worst, abs(a - b) / (1e-5 + 1e-4 * abs(a)))
        health = (ref_stats.health()["state"], stats.health()["state"])
        emit("search_health", fused_draw=draw == "1", n_suggests=len(stats.snapshots),
             labels=sorted(ref_stats.snapshots[-1]["labels"]), health=health,
             worst_share_of_tolerance=worst, tolerance="rtol 1e-4, atol 1e-5")


def phase_profile(T, trials, steady_ms, tier, n=3):
    """Where a steady-state suggest's time goes at the main path's history:
    device time by kernel (``torch.profiler``) against the unprofiled
    host-clock time of the run that made ``trials``."""
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
    emit("profile", tier=tier, n_suggests=n, profiled_wall_ms_per_suggest=wall_ms,
         device_ms_per_suggest=device_ms if device_ms else "not measured",
         device_busy_share=device_ms / steady_ms if device_ms else "not measured",
         device_kernels_per_suggest=sum(c for _, _, c in kernels),
         top=[{"kernel": k[:80], "ms": ms, "per_suggest": c} for k, ms, c in top])


def single_label_case(PB, nb, PA, na, n_cand, seed):
    """``_continuous_best_core``'s arguments on the card: observations in
    [-4, 4], prior N(0, 10) truncated to [-5, 5], k=1."""
    rng = np.random.default_rng(seed)
    below = np.zeros(PB, np.float32)
    below[:nb] = rng.uniform(-1.0, 1.0, nb)
    above = np.zeros(PA, np.float32)
    above[:na] = rng.uniform(-4.0, 4.0, na)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    u = torch.rand((2, n_cand), generator=gen, device=DEV)
    return (u[0], u[1], torch.tensor(below).to(DEV), nb, torch.tensor(above).to(DEV), na,
            1.0, 0.0, 10.0, -5.0, 5.0, 0.0)


def single_label_scores(args, values):
    """The plain scores of ``values`` under the core's fitted mixtures, in
    f32 and in f64."""
    from hyperopt_tpu_torch.ops import parzen
    from hyperopt_tpu_torch.ops.score import pair_params, pair_score

    _, _, below, nb, above, na, pw, pm, ps = args[:9]
    dev = below.device
    one = torch.ones(1, device=dev)
    B = parzen.adaptive_parzen_normal_padded(below[None], torch.tensor([nb], device=dev),
                                             pw, pm * one, ps * one, 25)
    A = parzen.adaptive_parzen_normal_padded(above[None], torch.tensor([na], device=dev),
                                             pw, pm * one, ps * one, 25)
    z, params, kb = values.reshape(1, -1), pair_params(*B, *A), B[0].shape[1]
    return pair_score(z, params, kb)[0], pair_score(z.double(), params.double(), kb)[0]


def phase_single_label(counters):
    """``_continuous_best_core`` at __graft_entry__.entry's shapes and at
    the main path's widths: one single-label kernel launch each, and the
    winner of the plain scorer (``HYPEROPT_TPU_SCORER=xla``) or, at a
    near-tie, one whose plain score is within the pair-score TOLERANCE of
    that winner's."""
    from hyperopt_tpu_torch.algos.tpe import _continuous_best_core
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_single

    for c in counters:
        c.launches = 0
    for name, shape in {"graft_entry": (16, 10, 64, 40, 256),
                        "main": (32, 25, 16384, 10000, N_CAND)}.items():
        args = single_label_case(*shape, seed=len(name))
        kw = dict(k=1, n_cand=shape[4], lf=25, log_scale=False, quantized=False)
        before = pair_score_single.launches
        best = _continuous_best_core(*args, **kw)
        with scorer_env(HYPEROPT_TPU_SCORER="xla"):
            best_plain = _continuous_best_core(*args, **kw)
        torch.cuda.synchronize()
        s, s64 = single_label_scores(args, torch.cat([best, best_plain]))
        allow, _ = allowance(s, s64)
        gap = float((s[0] - s[1]).abs())
        row = {"launches": pair_score_single.launches - before,
               "winner": float(best[0]), "winner_plain": float(best_plain[0]),
               "equal": bool(torch.equal(best, best_plain)), "score_gap": gap,
               "allow": float(allow.max())}
        emit("single_label", shape=name, PB=shape[0], PA=shape[2], n_cand=shape[4],
             kb=shape[0] + 1, ka=shape[2] + 1, **row, tolerance=TOLERANCE)
        assert row["launches"] == 1 and (row["equal"] or gap <= float(allow.min())), row
        assert bool(torch.isfinite(best).all()) and -5.0 <= float(best[0]) <= 5.0, row
    return {c.__name__: c.launches for c in counters}


def phase_quickstart(T, counters):
    for c in counters:
        c.launches = 0
    trials = T.Trials()
    T.fmin(bench_like_quickstart_objective, quickstart_space(T.hp),
           algo=partial(T.tpe.suggest, n_startup_jobs=10), max_evals=40, trials=trials,
           rstate=np.random.default_rng(0), show_progressbar=False, max_speculation=0)
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


OBJECTIVE_SLEEP_S = 0.05  # a stand-in for a training run


def training_objective(c):
    time.sleep(OBJECTIVE_SLEEP_S)
    return bench_objective(c)


class MatchingLog(logging.Handler):
    """Keeps every warning or error of the port's loggers whose message
    holds ``text``."""

    def __init__(self, text):
        super().__init__(logging.WARNING)
        self.text, self.lines = text, []

    def emit(self, record):
        msg = record.getMessage()
        if self.text in msg:
            self.lines.append(f"{record.name}: {msg}")


@contextlib.contextmanager
def matching_log(text):
    log = MatchingLog(text)
    root = logging.getLogger("hyperopt_tpu_torch")
    root.addHandler(log)
    try:
        yield log
    finally:
        root.removeHandler(log)


def failure_log():
    """Every record that reports a failure (the engine's "speculative
    dispatch failed" and its kin)."""
    return matching_log("failed")


def phase_pipelined_main_path(T, counters):
    """fmin's default pipelined path (the algorithm a partial, so the
    engine finds its asynchronous variant) at the main path's size and a
    50 ms objective, at max_speculation 0, 1 and 2 from one rstate."""
    algo = partial(T.tpe.suggest, n_EI_candidates=N_CAND)
    serial_ms = []

    def timed_algo(*args):
        # k=0 only: the serial loop's suggests, each ended by the readback
        t0 = time.perf_counter()
        docs = algo(*args)
        serial_ms.append((time.perf_counter() - t0) * 1e3)
        return docs

    runs = {}
    for k in (0, 1, 2):
        trials = prefilled_trials(T, N_HISTORY)
        it = T.FMinIter(timed_algo if k == 0 else algo,
                        T.Domain(training_objective, bench_space(T.hp)), trials,
                        rstate=np.random.default_rng(0),
                        max_evals=N_HISTORY + N_SUGGESTS, show_progressbar=False,
                        max_speculation=k)
        for c in counters:
            c.launches = 0
        with failure_log() as failed:
            t0 = time.perf_counter()
            it.exhaust()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {c.__name__: c.launches for c in counters}
        st = it.speculation_stats
        assert len(trials.trials) == N_HISTORY + N_SUGGESTS
        for doc in trials.trials[N_HISTORY:]:
            check_bench_values({kk: v[0] for kk, v in doc["misc"]["vals"].items()})
            assert math.isfinite(doc["result"]["loss"])
        dispatched = N_SUGGESTS if k == 0 else st.n_dispatched + st.n_sync
        row = {"k": k, "wall_ms": wall_ms, "wall_ms_per_trial": wall_ms / N_SUGGESTS,
               "objective_ms": OBJECTIVE_SLEEP_S * 1e3, "launches": launches,
               "suggests_dispatched": dispatched,
               "hidden_s": st.hidden_s, "exposed_s": st.exposed_s,
               "resolve_s": st.resolve_s, "sync_s": st.sync_s,
               "reissue_exposed_s": st.reissue_exposed_s,
               "hidden_share": (st.hidden_s / (st.hidden_s + st.exposed_s)
                                if k else None),
               "speculation": st.summary(), "failed_log_lines": failed.lines}
        if k:
            row.update(exposed_ms_per_trial=st.exposed_s * 1e3 / N_SUGGESTS,
                       launch_ms_per_dispatch=st.hidden_s * 1e3 / max(st.n_dispatched, 1),
                       resolve_ms_per_use=st.resolve_s * 1e3 / max(st.n_used, 1))
            assert st.n_used + st.n_sync == N_SUGGESTS, st.summary()
        else:
            row.update(exposed_ms_per_trial=sum(serial_ms) / N_SUGGESTS,
                       suggest_ms_all=list(serial_ms))
        # what is left of a trial besides the objective and the suggest
        # time it waited for: the fmin loop's own host work
        row["loop_ms_per_trial"] = (row["wall_ms_per_trial"] - row["objective_ms"]
                                      - row["exposed_ms_per_trial"])
        runs[k] = (row, suggested(trials))
        emit("pipelined_main_path", n_history=N_HISTORY, n_suggests=N_SUGGESTS,
             n_EI_candidates=N_CAND, **row)
        assert launches["pair_score_batched"] == 2 * dispatched, (k, launches, st.summary())
        assert launches["fused_suggest"] == 0, launches
        assert not failed.lines, failed.lines
    same = [a == b for a, b in zip(runs[1][1], runs[0][1])]
    emit("pipelined_main_path", k1_trials_equal_to_k0=sum(same), n_suggests=N_SUGGESTS)
    assert len(same) == N_SUGGESTS and all(same), same
    return {k: row for k, (row, _) in runs.items()}


def phase_multi_study(T, counters, rounds=3):
    """Four studies at the main path's history, prepared apart and
    dispatched as one batch; timed against four sequential suggests in
    turns (sequential, batched, batched, sequential, ...)."""
    from hyperopt_tpu_torch.algos import tpe_device as td

    studies = [(T.Domain(bench_objective, bench_space(T.hp)), prefilled_trials(T, N_HISTORY, seed=s),
                100 + s) for s in range(4)]
    kw = dict(n_EI_candidates=N_CAND)

    def sequential():
        return [T.tpe.suggest([N_HISTORY], dom, trials, seed, **kw)
                for dom, trials, seed in studies]

    def batched():
        preps = [T.tpe.suggest_prepare([N_HISTORY], dom, trials, seed, **kw)
                 for dom, trials, seed in studies]
        resolvers = td.multi_study_suggest_async([req for req, _ in preps])
        return [finish(r(), diag=r.diag) for r, (_, finish) in zip(resolvers, preps)]

    ref = [[d["misc"]["vals"] for d in docs] for docs in sequential()]  # uploads too
    times = {"sequential": [], "batched": []}
    launches = None
    for i in range(rounds):
        for name in (("sequential", "batched") if i % 2 == 0 else ("batched", "sequential")):
            for c in counters:
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            docs = (sequential if name == "sequential" else batched)()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            got = [[d["misc"]["vals"] for d in dd] for dd in docs]
            assert got == ref, (name, got, ref)
            if name == "batched" and launches is None:
                launches = {c.__name__: c.launches for c in counters}
    emit("multi_study", n_studies=len(studies), n_history=N_HISTORY, n_EI_candidates=N_CAND,
         launches_batched=launches, docs_equal_unbatched=True,
         batched_ms=times["batched"], sequential_ms=times["sequential"],
         batched_ms_median=float(np.median(times["batched"])),
         sequential_ms_median=float(np.median(times["sequential"])))
    assert launches["pair_score_batched"] == 2 * len(studies), launches
    return studies


def phase_fused_probe(T, counters, study):
    """The probe through resolve_scorer on the card with no pin, then one
    unpinned suggest at the main path's history: it launches the kernel
    the verdict names, 2 times."""
    from hyperopt_tpu_torch.ops import fused_kernel
    from hyperopt_tpu_torch.ops.score import resolve_scorer

    pinned = os.environ.pop("HYPEROPT_TPU_FUSED_PROBE")
    try:
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        tier = resolve_scorer(torch.device(DEV))
        probe_s = time.perf_counter() - t0
        probe = fused_kernel.probe_result()
        assert probe is not None and tier == ("fused" if probe["fused"] else "pallas"), probe
        probe_launches = {c.__name__: c.launches for c in counters}
        dom, trials, seed = study
        for c in counters:
            c.launches = 0
        docs = T.tpe.suggest([N_HISTORY], dom, trials, seed, n_EI_candidates=N_CAND)
        torch.cuda.synchronize()
        check_bench_values({k: v[0] for k, v in docs[0]["misc"]["vals"].items()})
        launches = {c.__name__: c.launches for c in counters}
        emit("fused_probe", unfused_ms=probe["unfused_ms"], fused_ms=probe["fused_ms"],
             verdict=tier, probe_seconds=probe_s, probe_launches=probe_launches,
             shape=dict(k_total=8224, n_cand=2048, n_labels=4, iters=8),
             suggest_launches=launches)
        chosen = "fused_suggest" if tier == "fused" else "pair_score_batched"
        other = "pair_score_batched" if tier == "fused" else "fused_suggest"
        assert launches[chosen] == 2 and launches[other] == 0, (tier, launches)
    finally:
        os.environ["HYPEROPT_TPU_FUSED_PROBE"] = pinned
        fused_kernel.set_default_fused(None)
    return probe


@contextlib.contextmanager
def cpu_drawn_streams():
    """The port's uniform streams drawn on the CPU and moved to the device
    the suggest runs on: the card and the CPU then draw from the same
    uniforms (``phase_suggest_vs_cpu``'s injection)."""
    from hyperopt_tpu_torch.algos import tpe as ttpe

    draw = ttpe._label_uniforms

    def cpu_streams(seed, n_labels, n, device):
        return draw(seed, n_labels, n, "cpu").to(device)

    ttpe._label_uniforms = cpu_streams
    try:
        yield
    finally:
        ttpe._label_uniforms = draw


def card_agrees_with_cpu(T, domain, trials, ids, seeds, **kw):
    """``tpe.suggest`` on the card and on the CPU from the same streams:
    (pairs, pairs equal to rtol 1e-5, mismatches) over every (id, label)
    value; a mismatch is ``(seed, id index, label, card value, CPU
    value)``."""
    pairs, close, mismatches = 0, 0, []
    with cpu_drawn_streams():
        for seed in seeds:
            card = T.tpe.suggest(ids, domain, trials, seed, **kw)
            cpu = T.tpe.suggest(ids, domain, trials, seed, device="cpu", **kw)
            for j, (a, b) in enumerate(zip(card, cpu)):
                assert a["misc"]["idxs"] == b["misc"]["idxs"], (a["misc"], b["misc"])
                check_bench_values({k: v[0] for k, v in a["misc"]["vals"].items()})
                for lb, v in b["misc"]["vals"].items():
                    pairs += 1
                    if np.isclose(a["misc"]["vals"][lb][0], v[0], rtol=1e-5):
                        close += 1
                    else:
                        mismatches.append((seed, j, lb, a["misc"]["vals"][lb][0], v[0]))
    return pairs, close, mismatches


def near_ties(T, domain, trials, ids, mismatches, **kw):
    """Each mismatch's gap under the CPU's own plain scorer: how much
    higher the CPU's winner scores than the card's.  The card's argmax
    can differ from the CPU's only where that gap is at most twice the
    per-score TOLERANCE between the kernel and the plain version (each of
    the two scores may be off by one TOLERANCE), so a larger gap fails."""
    rows = []
    for seed, j, lb, card_v, cpu_v in mismatches:
        s, s64 = (torch.from_numpy(T.tpe.plain_label_scores(
            ids, domain, trials, seed, lb, [card_v, cpu_v], dtype=dt, **kw))
            for dt in (torch.float32, torch.float64))
        allow, _ = allowance(s, s64)
        rows.append({"seed": seed, "id": j, "label": lb, "card": card_v, "cpu": cpu_v,
                     "gap": float(s[1] - s[0]), "allow": 2 * float(allow.min())})
    return rows


MULTI_IDS = 8
# The 8-id suggest's card-vs-CPU rule.  At 8 x 8192 candidates per label
# the log-scale `lr` winners sit among near-ties that two f32 scorers
# order differently: over these seeds an H100 agreed on 277 of 320 (id,
# label) values, 33-36 of 40 per seed (PERF.md §6), hence the share floor
# of 0.8; every other value must be a near-tie (``near_ties``).
AGREEMENT_SEEDS = range(8)
AGREEMENT_SHARE = 0.8


def assert_agreement(pairs, close, ties):
    """At least AGREEMENT_SHARE of the values equal to rtol 1e-5, and each
    mismatch a near-tie within the allowance TOLERANCE implies."""
    assert close >= AGREEMENT_SHARE * pairs, (close, pairs)
    assert all(0.0 <= t["gap"] <= t["allow"] for t in ties), ties


def phase_multi_id_suggest(T, counters, card, rounds=3):
    """``tpe.suggest`` with 8 ids at the main path's history: one pair-score
    launch per unquantized family (C = 8 x 8192 per label), the card's
    values against the CPU's from one set of streams, ms of the 8-id call
    against 8 single-id calls, in turns, and the pair-score kernel's event
    ms at that shape beside its bound."""
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched

    trials = prefilled_trials(T, N_HISTORY)
    domain = T.Domain(bench_objective, bench_space(T.hp))
    ids = list(range(N_HISTORY, N_HISTORY + MULTI_IDS))
    kw = dict(n_EI_candidates=N_CAND)
    T.tpe.suggest(ids[:1], domain, trials, 0, **kw)  # this domain's history upload
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    docs = T.tpe.suggest(ids, domain, trials, 1, **kw)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    assert len(docs) == MULTI_IDS
    for doc in docs:
        check_bench_values({k: v[0] for k, v in doc["misc"]["vals"].items()})
    t0 = time.perf_counter()
    per_seed, ties = [], []
    for seed in AGREEMENT_SEEDS:
        n, c, mismatches = card_agrees_with_cpu(T, domain, trials, ids, [seed], **kw)
        per_seed.append({"seed": seed, "pairs": n, "equal_to_rtol_1e_5": c})
        ties += near_ties(T, domain, trials, ids, mismatches, **kw)
    pairs = sum(r["pairs"] for r in per_seed)
    close = sum(r["equal_to_rtol_1e_5"] for r in per_seed)
    compare_s = time.perf_counter() - t0

    def multi():
        T.tpe.suggest(ids, domain, trials, 3, **kw)

    def singles():
        for i, tid in enumerate(ids):
            T.tpe.suggest([tid], domain, trials, 3 + i, **kw)

    times = {"multi": [], "singles": []}
    for r in range(rounds):
        for name in (("multi", "singles") if r % 2 == 0 else ("singles", "multi")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (multi if name == "multi" else singles)()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    shape = EDGE_SHAPES["eight_ids"]
    z, params = pair_case(seed=8, **shape)
    L, C, K = shape["L"], shape["C"], shape["kb"] + shape["ka"]
    kernel = {"ms": cuda_ms(lambda: pair_score_batched(z, params, shape["kb"]), iters=50),
              **bound(L * C * K, 4 * (2 * L * C + 3 * L * K), card)}
    row = {"n_ids": MULTI_IDS, "n_history": N_HISTORY, "n_EI_candidates": N_CAND,
           "kernel_at_shape": {"shape": shape, "ms": kernel["ms"],
                               "bound_ms": kernel["bound_ms"],
                               "share_of_bound": kernel["bound_ms"] / kernel["ms"]},
           "candidates_per_label": MULTI_IDS * N_CAND, "launches": launches,
           "pairs": pairs, "equal_to_rtol_1e_5": close, "share": close / pairs,
           "per_seed": per_seed, "near_ties": ties,
           "worst_gap_over_allow": max([t["gap"] / t["allow"] for t in ties], default=0.0),
           "card_vs_cpu_seconds": compare_s,
           "multi_ms": times["multi"], "singles_ms": times["singles"],
           "multi_ms_median": float(np.median(times["multi"])),
           "singles_ms_median": float(np.median(times["singles"])),
           "ms_per_suggested_trial": {
               "multi": float(np.median(times["multi"])) / MULTI_IDS,
               "singles": float(np.median(times["singles"])) / MULTI_IDS}}
    emit("multi_id_suggest", **row)
    assert launches["pair_score_batched"] == 2 and launches["fused_suggest"] == 0, launches
    assert_agreement(pairs, close, ties)
    return row


def phase_atpe_path(T, counters, n_suggests=8):
    """Serial ``fmin(algo=atpe.suggest)`` over the bench space from the
    10,000-trial history: per suggest its meta-parameters, locked labels,
    pair-score launches, ms, and the host ms of featurization; then
    ``tpe.suggest`` with ATPE's locks and a result filter, card against CPU
    from one set of streams."""
    from hyperopt_tpu_torch.algos import atpe as tatpe
    from hyperopt_tpu_torch.algos import tpe as ttpe

    tpe_calls = []
    real = ttpe.suggest

    def recording(new_ids, domain, trials, seed, **kw):
        tpe_calls.append(kw)
        return real(new_ids, domain, trials, seed, **kw)

    rows = []

    def timed_atpe(new_ids, domain, trials, seed):
        opt = tatpe._optimizer_for(None)
        t0 = time.perf_counter()
        feats, _ = opt.compute_features(domain, trials)
        feat_ms = (time.perf_counter() - t0) * 1e3
        meta = opt.predict_meta(feats)
        for c in counters:
            c.launches = 0
        n_calls = len(tpe_calls)
        t0 = time.perf_counter()
        docs = T.atpe.suggest(new_ids, domain, trials, seed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        kw = tpe_calls[-1] if len(tpe_calls) > n_calls else {}
        rows.append({
            "ms": ms, "featurize_ms": feat_ms,
            "gamma": meta["gamma"], "n_EI_candidates": meta["n_EI_candidates"],
            "prior_weight": meta["prior_weight"],
            "filter_mode": meta["result_filtering_mode"],
            "filter_multiplier": meta["result_filtering_multiplier"],
            "secondary_cutoff": meta["secondary_cutoff"],
            "locked": sorted(kw.get("param_locks") or {}),
            "launches": {c.__name__: c.launches for c in counters}})
        return docs

    trials = prefilled_trials(T, N_HISTORY)
    domain = T.Domain(bench_objective, bench_space(T.hp))
    ttpe.suggest = recording
    try:
        with matching_log("could not load") as warned:
            T.fmin(bench_objective, bench_space(T.hp), algo=timed_atpe,
                   max_evals=N_HISTORY + n_suggests, trials=trials,
                   rstate=np.random.default_rng(0), show_progressbar=False)
    finally:
        ttpe.suggest = real
    assert len(trials.trials) == N_HISTORY + n_suggests and len(rows) == n_suggests
    for doc in trials.trials[N_HISTORY:]:
        check_bench_values({k: v[0] for k, v in doc["misc"]["vals"].items()})
        assert math.isfinite(doc["result"]["loss"])
    models = len(tatpe._optimizer_for(None).models)
    # the last suggest's locks that locked any label, and a result filter
    # that is not "none"
    locks = next((c["param_locks"] for c in reversed(tpe_calls) if c.get("param_locks")), None)
    mode = rows[-1]["filter_mode"] if rows[-1]["filter_mode"] != "none" else "age"
    filt = tatpe.build_trial_filter(mode, rows[-1]["filter_multiplier"])
    kw = dict(n_EI_candidates=rows[-1]["n_EI_candidates"], gamma=rows[-1]["gamma"],
              prior_weight=rows[-1]["prior_weight"], param_locks=locks, trial_filter=filt)
    pairs, close, _ = card_agrees_with_cpu(T, domain, trials, [len(trials.trials)], range(5),
                                           **kw)
    emit("atpe_path", n_history=N_HISTORY, n_suggests=n_suggests, suggests=rows,
         meta_models_loaded=models, load_warnings=len(warned.lines),
         locked_check={"locks": {k: list(v) for k, v in (locks or {}).items()},
                       "filter": mode, "kept": int(filt(trials.history).sum()),
                       "pairs": pairs, "equal_to_rtol_1e_5": close})
    for r in rows:
        assert r["launches"]["pair_score_batched"] == 2, r
    assert locks and close >= 0.9 * pairs, (locks, close, pairs)
    return rows


def counted_tpe(T, calls, **kw):
    """``partial(tpe.suggest, **kw)`` that records the ids of every call and
    keeps the speculative engine's view of TPE (its validity policy and
    asynchronous variant, each counted too)."""
    def counted(fn):
        def call(new_ids, *args, **kwargs):
            calls.append(len(new_ids))
            return fn(new_ids, *args, **kwargs)
        return call

    algo = counted(partial(T.tpe.suggest, **kw))
    algo.speculation_policy = T.tpe.suggest.speculation_policy
    algo.async_variant = counted(partial(T.tpe.suggest_async, **kw))
    return algo


def phase_anneal_mix(T, counters, n_history=1000, n_evals=16):
    """anneal and then mix over (0.5 tpe, 0.25 anneal, 0.25 rand), 16
    evals each from a 1,000-trial history: every value inside its support,
    and pair-score launches in a mix suggest exactly when it picked TPE."""
    rows = {}
    trials = prefilled_trials(T, n_history)
    for c in counters:
        c.launches = 0
    T.fmin(bench_objective, bench_space(T.hp), algo=T.anneal.suggest,
           max_evals=n_history + n_evals, trials=trials, rstate=np.random.default_rng(0),
           show_progressbar=False)
    rows["anneal"] = {"launches": {c.__name__: c.launches for c in counters}}
    assert rows["anneal"]["launches"]["pair_score_batched"] == 0
    for doc in trials.trials[n_history:]:
        check_bench_values({k: v[0] for k, v in doc["misc"]["vals"].items()})

    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched

    picks = []

    def tagged(name, fn):
        def call(*args, **kw):
            before = pair_score_batched.launches
            docs = fn(*args, **kw)
            torch.cuda.synchronize()
            picks.append((name, pair_score_batched.launches - before))
            return docs
        return call

    algo = partial(T.mix.suggest, p_suggest=[
        (0.5, tagged("tpe", T.tpe.suggest)), (0.25, tagged("anneal", T.anneal.suggest)),
        (0.25, tagged("rand", T.rand.suggest))])
    trials = prefilled_trials(T, n_history)
    for c in counters:
        c.launches = 0
    T.fmin(bench_objective, bench_space(T.hp), algo=algo, max_evals=n_history + n_evals,
           trials=trials, rstate=np.random.default_rng(1), show_progressbar=False)
    rows["mix"] = {"launches": {c.__name__: c.launches for c in counters},
                   "picks": {n: sum(p == n for p, _ in picks) for n in ("tpe", "anneal", "rand")},
                   "launches_by_pick": picks}
    for doc in trials.trials[n_history:]:
        check_bench_values({k: v[0] for k, v in doc["misc"]["vals"].items()})
    emit("anneal_mix", n_history=n_history, n_evals=n_evals, **rows)
    assert len(picks) == n_evals
    assert all((n == "tpe") == (launched > 0) for n, launched in picks), picks


def branin_torch(c):
    x, y = c["x"], c["y"]
    a, b, cc = 1.0, 5.1 / (4 * math.pi ** 2), 5.0 / math.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * math.pi)
    return a * (y - b * x ** 2 + cc * x - r) ** 2 + s * (1 - t) * torch.cos(x) + s


def phase_parallel_backend(T, counters, serial_rows, n_evals=32, parallelism=8):
    """TorchTrials' host plane at the main path's history (tpe.suggest with
    8192 candidates, the bench objective plus a 50 ms sleep, 8 threads),
    then its device plane on the zoo's 2-label Branin."""
    from hyperopt_tpu_torch.models import domains

    calls = []
    trials = prefilled_trials(T, N_HISTORY, trials=T.TorchTrials(parallelism=parallelism))
    for c in counters:
        c.launches = 0
    with failure_log() as failed:
        t0 = time.perf_counter()
        T.fmin(training_objective, bench_space(T.hp),
               algo=counted_tpe(T, calls, n_EI_candidates=N_CAND),
               max_evals=N_HISTORY + n_evals, trials=trials,
               rstate=np.random.default_rng(0), show_progressbar=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {c.__name__: c.launches for c in counters}
    new = trials.trials[N_HISTORY:]
    states = [d["state"] for d in new]
    for doc in new:
        check_bench_values({k: v[0] for k, v in doc["misc"]["vals"].items()})
    emit("parallel_backend", plane="host", parallelism=parallelism, n_history=N_HISTORY,
         n_evals=n_evals, n_EI_candidates=N_CAND, objective_ms=OBJECTIVE_SLEEP_S * 1e3,
         host_trials=trials.host_trials, device_batches=trials.device_batches,
         errored=states.count(T.JOB_STATE_ERROR), suggest_calls=len(calls),
         ids_per_call=calls, max_ids_per_call=max(calls), launches=launches,
         launches_per_suggest_call=launches["pair_score_batched"] / len(calls),
         wall_ms=wall_ms, wall_ms_per_trial=wall_ms / n_evals,
         serial_wall_ms_per_trial={k: r["wall_ms_per_trial"] for k, r in serial_rows.items()},
         failed_log_lines=failed.lines)
    assert len(new) == n_evals and states == [T.JOB_STATE_DONE] * n_evals, states
    assert trials.host_trials == n_evals and trials.device_batches == 0
    assert max(calls) > 1 and launches["pair_score_batched"] == 2 * len(calls), (calls, launches)
    assert not failed.lines, failed.lines

    d = domains.get("branin")
    trials = T.TorchTrials(parallelism=parallelism, device_fn=branin_torch)
    for c in counters:
        c.launches = 0
    T.fmin(d.fn, d.space, algo=T.tpe.suggest, max_evals=64, trials=trials,
           rstate=np.random.default_rng(0), show_progressbar=False)
    launches = {c.__name__: c.launches for c in counters}
    worst = 0.0
    for t in trials.trials:
        assert t["state"] == T.JOB_STATE_DONE, t["misc"].get("error")
        host = d.fn({k: v[0] for k, v in t["misc"]["vals"].items()})
        worst = max(worst, abs(t["result"]["loss"] - host) / abs(host))
    emit("parallel_backend", plane="device", domain="branin", parallelism=parallelism,
         n_evals=len(trials.trials), device_batches=trials.device_batches,
         host_trials=trials.host_trials, launches=launches, worst_rel_err_vs_host=worst,
         tolerance="rel 1e-4 (f32 on the card, TF32 off)")
    assert len(trials.trials) == 64 and trials.device_batches > 0 and trials.host_trials == 0
    assert worst <= 1e-4, worst


def exp_split():
    """The share of exps on the FMA pipe that balances the issue slots
    against the SFU, and the lane-clocks per cell there: issue slots
    SLOTS_PER_CELL + (1 - f) + f * POLY_EXP_SLOTS against SFU lane-clocks
    R * (1 - f), R = LANE_SLOTS_PER_SM_CLOCK / EX2_PER_SM_CLOCK."""
    r = LANE_SLOTS_PER_SM_CLOCK / EX2_PER_SM_CLOCK
    f = max(0.0, (r - SLOTS_PER_CELL - 1) / (r + POLY_EXP_SLOTS - 1))
    return f, max(SLOTS_PER_CELL + 1 - f + f * POLY_EXP_SLOTS, r * (1 - f))


def bound(cells, n_bytes, card):
    """The least time for ``cells`` score cells and ``n_bytes`` of input and
    output: the larger of the f32 operations at the f32 peak, the issue
    slots and SFU time with the exps split at best between the SFU and the
    FMA pipe (``exp_split``), and the bytes at the memory rate.  Beside it,
    the SFU-only time (every exp on MUFU.EX2), which assumes no exp on the
    FMA pipe and so is no floor."""
    sm_hz = card["sms"] * card["max_sm_mhz"] * 1e6
    f, lane_clocks = exp_split()
    b = {"f32_bound_ms": OPS_PER_CELL * cells / PEAK_F32_FLOPS * 1e3,
         "issue_sfu_bound_ms": cells * lane_clocks / (LANE_SLOTS_PER_SM_CLOCK * sm_hz) * 1e3,
         "bytes_bound_ms": n_bytes / PEAK_BYTES * 1e3}
    unit = max(b, key=b.get)
    return {"bound_ms": b[unit], "bound_by": "bytes" if unit == "bytes_bound_ms" else "operations",
            "bound_unit": {"f32_bound_ms": "f32",
                           "issue_sfu_bound_ms": f"issue slots and SFU, {f:.4f} of exps on FMA",
                           "bytes_bound_ms": "bytes"}[unit],
            "sfu_bound_ms": cells / (EX2_PER_SM_CLOCK * sm_hz) * 1e3, **b}


def device_ms_per_launch(fn, names, iters=50):
    """Device time per call of ``fn`` of the kernels whose names hold one of
    ``names``, by ``torch.profiler``: the kernels alone, without the
    wrapper's host work that the event timing of ``cuda_ms`` also spans.
    Returns the total and ``{name: ms}``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by = {}
    for a in prof.key_averages():
        for n in names:
            if n in a.key:
                by[n] = by.get(n, 0.0) + getattr(a, "self_device_time_total", 0.0) / 1e3 / iters
    return (sum(by.values()), by) if by else ("not measured", {})


def phase_timing(errs, launches, card):
    """Each kernel, its plain version and a library yardstick at the main
    path's shapes: event ms per call (``cuda_ms``), the kernel's profiler
    device ms per launch, and its bound.  The library calls are timed as
    yardsticks only; the port never calls them."""
    from hyperopt_tpu_torch.algos.tpe_device import _ei_diag
    from hyperopt_tpu_torch.ops.fused_kernel import fused_suggest, fused_suggest_plain
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched, pair_score_single
    from hyperopt_tpu_torch.ops.score import pair_score

    def library_scores(z, params, kb):
        # one f32 product materializing [L, C, K], then two logsumexps
        feats = torch.stack([z * z, z, torch.ones_like(z)], dim=-1)
        comp = torch.matmul(feats, params)
        return torch.logsumexp(comp[..., :kb], -1) - torch.logsumexp(comp[..., kb:], -1)

    def row(name, fn, names, cells, n_bytes, **fields):
        device_ms, by_kernel = device_ms_per_launch(fn, names)
        r = {"name": name, "route": "cuda", **fields, "ms": cuda_ms(fn, iters=200),
             "device_ms": device_ms, "device_ms_by_kernel": by_kernel,
             **bound(cells, n_bytes, card), "cells": cells, "ops_per_cell": OPS_PER_CELL,
             "exps_per_cell": 1}
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["share_of_sfu_bound"] = r["sfu_bound_ms"] / r["ms"]
        return r

    rows = []
    s = MAIN_SHAPE
    z, params = pair_case(seed=4, **s)
    L, C, K, kb = s["L"], s["C"], s["kb"] + s["ka"], s["kb"]
    rows.append(row(
        "pair_score_batched", lambda: pair_score_batched(z, params, kb), ["pair_score_kernel"],
        L * C * K, 4 * (2 * L * C + 3 * L * K),
        source="hyperopt_tpu_torch/csrc/pair_score.cu",
        replaces="hyperopt_tpu/ops/pallas_gmm.py:127",
        launches=launches["pair_score_batched"], max_abs_err=errs["pair_score_batched"],
        plain_ms=cuda_ms(lambda: pair_score(z, params, kb), 10),
        library_ms=cuda_ms(lambda: library_scores(z, params, kb), 10)))

    # the fused kernel on the main path's family shape, both draw modes
    inp = fused_inputs(*FUSED_SHAPES[0][1:], seed=4)
    x, p, kb, n_top = inp["cands"], inp["params"], inp["kb"], 16
    L, C, K = x.shape[0], x.shape[1], p.shape[2]

    def unfused():
        sc = pair_score_batched(x, p, kb)
        torch.argmax(sc, dim=1)
        _ei_diag(sc)

    def library():
        sc = library_scores(x, p, kb)
        torch.argmax(sc, dim=1)
        torch.topk(sc, n_top, dim=1)

    def draw():
        fused_suggest(inp["u1"], inp["u2"], inp["rows"], p, kb, 1, draw_in_kernel=True)

    fused_names = ["fused_tile_kernel", "fused_merge_kernel"]
    rows.append(row(
        "fused_suggest", lambda: fused_suggest(x, None, None, p, kb, 1), fused_names,
        L * C * K, 4 * (L * C + 3 * L * K + L * (4 + n_top)),
        source="hyperopt_tpu_torch/csrc/fused_suggest.cu",
        replaces="hyperopt_tpu/ops/pallas_fused.py:126",
        launches=launches["fused_suggest"], launches_draw=launches["fused_suggest_draw"],
        max_abs_err=errs["fused_suggest"], ms_draw=cuda_ms(draw, iters=200),
        device_ms_draw=device_ms_per_launch(draw, fused_names)[0],
        plain_ms=cuda_ms(lambda: fused_suggest_plain(x, None, None, p, kb, 1), 10),
        unfused_ms=cuda_ms(unfused, 100), library_ms=cuda_ms(library, 10)))

    # the single-label launch at the main path's widths, L = 1
    s1 = dict(MAIN_SHAPE, L=1)
    z, params = pair_case(seed=5, **s1)
    C, K, kb = s1["C"], s1["kb"] + s1["ka"], s1["kb"]
    z1, p1 = z[0].contiguous(), params[0].contiguous()
    rows.append(row(
        "pair_score_single", lambda: pair_score_single(z1, p1, kb), ["pair_score_kernel"],
        C * K, 4 * (2 * C + 3 * K),
        source="hyperopt_tpu_torch/csrc/pair_score.cu (L=1 launch)",
        replaces="hyperopt_tpu/ops/pallas_gmm.py:119",
        launches=launches["pair_score_single"], max_abs_err=errs["pair_score_single"],
        plain_ms=cuda_ms(lambda: pair_score(z, params, kb), 10),
        library_ms=cuda_ms(lambda: library_scores(z, params, kb), 10)))
    for r in rows:
        emit("timing", kernel=r["name"], **{k: r[k] for k in (
            "ms", "device_ms", "device_ms_by_kernel", "ms_draw", "device_ms_draw", "plain_ms",
            "unfused_ms",
            "library_ms", "bound_ms", "bound_by", "bound_unit", "f32_bound_ms",
            "issue_sfu_bound_ms", "sfu_bound_ms", "share_of_bound", "share_of_sfu_bound")
            if k in r})
    return rows


def single_label_err():
    """The single-label launch against the plain version at L=1 and the
    main path's widths: its largest |difference|, held to TOLERANCE."""
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_single
    from hyperopt_tpu_torch.ops.score import pair_score

    s1 = dict(MAIN_SHAPE, L=1)
    z, params = pair_case(seed=5, **s1)
    got = pair_score_single(z[0].contiguous(), params[0].contiguous(), s1["kb"])
    ref = pair_score(z, params, s1["kb"])
    ref64 = pair_score(z.double(), params.double(), s1["kb"])
    allow, _ = allowance(ref, ref64)
    err = (got[None] - ref).abs()
    emit("kernel_vs_plain", shape="single_main", kernel="pair_score_single", **s1,
         max_abs_err=float(err.max()), ok=bool((err <= allow).all()), tolerance=TOLERANCE)
    assert bool((err <= allow).all())
    return float(err.max())


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the plain versions and the library yardstick run IEEE f32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k in ("HYPEROPT_TPU_SCORER", "HYPEROPT_TPU_FUSED", "HYPEROPT_TPU_FUSED_DRAW",
              "HYPEROPT_MAX_SPECULATION"):
        os.environ.pop(k, None)  # the default tier unless a phase sets one
    # the fused probe runs in its own phase only: the others keep the tier
    # they measured before it existed
    os.environ["HYPEROPT_TPU_FUSED_PROBE"] = "0"
    import hyperopt_tpu_torch as T
    from hyperopt_tpu_torch.ops.fused_kernel import fused_suggest
    from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched, pair_score_single

    assert "jax" not in sys.modules and not any(
        m == "hyperopt_tpu" or m.startswith("hyperopt_tpu.") for m in sys.modules)
    counters = [pair_score_batched, fused_suggest, pair_score_single]
    smi, card = phase_card()
    phase_build()
    errs = {"pair_score_batched": phase_kernel_vs_plain(),
            "fused_suggest": phase_fused_vs_plain(),
            "pair_score_single": single_label_err()}
    phase_suggest_vs_cpu(T)
    launches, trials, steady_ms, stats = phase_main_path(T, counters)
    fused_runs = phase_fused_main_path(T, counters, trials)
    phase_search_health(stats, fused_runs)
    phase_profile(T, trials, steady_ms, "pallas")
    with scorer_env(HYPEROPT_TPU_SCORER="fused"):
        phase_profile(T, fused_runs["0"][1], fused_runs["0"][2], "fused")
    single = phase_single_label(counters)
    phase_quickstart(T, counters)
    pipelined = phase_pipelined_main_path(T, counters)
    studies = phase_multi_study(T, counters)
    phase_fused_probe(T, counters, studies[0])
    phase_multi_id_suggest(T, counters, card)
    phase_atpe_path(T, counters)
    phase_anneal_mix(T, counters)
    phase_parallel_backend(T, counters, pipelined)
    launches = {**launches, "fused_suggest": fused_runs["0"][0]["fused_suggest"],
                "fused_suggest_draw": fused_runs["1"][0]["fused_suggest"],
                "pair_score_single": single["pair_score_single"]}
    kernels = phase_timing(errs, launches, card)
    assert "jax" not in sys.modules and not any(
        m == "hyperopt_tpu" or m.startswith("hyperopt_tpu.") for m in sys.modules)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
